// CountSketch of a padded sparse batch for Hopper.
//
// Replaces the TPU kernel repro/kernels/countsketch.py::_cs_sparse_kernel
// (launcher countsketch_sparse_pallas).
// keys [B, N] i32, vals [B, N] f32 -> T [B, R, W] f32, with
//   T[b, r, w] = sum_n [bucket_r(key_n) == w] * sign_r(key_n) * val_n.
//
// The TPU kernel turns the scatter into a one-hot [1, BN] @ [BN, BW] MXU
// product; here a block owns one (row b, rep r) and a run of buckets, one
// per thread.  Per chunk of non-zeros the block hashes each key once
// (bucket and sign) into shared memory, coalesced, then every thread scans
// the chunk in n order and adds the terms that land in its bucket.  The
// per-bucket sum therefore runs over ascending n, one f32 add at a time,
// whatever B or the padded N: batched and single-row sketches, and the
// plain version's one-scatter-per-n loop, give the same bits.  No atomics
// (their order is not fixed).
//
// Bound: operations.  The hashing is 2 keyed hashes per (b, r, n); the
// scan is O(N * W) compares per (b, r), the work the TPU's one-hot does,
// and is what this simple kernel spends its time on.
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "u32.cuh"

namespace repro {

constexpr int kCsMaxThreads = 256;  // buckets per block, at most
constexpr int kCsChunk = 1024;      // non-zeros staged per step

__global__ void __launch_bounds__(kCsMaxThreads)
countsketch_sparse_kernel(const int* __restrict__ keys, const float* __restrict__ vals,
                          int N, int W, int R, uint32_t seed, float* __restrict__ out) {
  __shared__ int s_bucket[kCsChunk];
  __shared__ float s_term[kCsChunk];

  const int br = blockIdx.x;  // b * R + r
  const int b = br / R;
  const uint32_t r = (uint32_t)(br % R);
  const int w = blockIdx.y * blockDim.x + threadIdx.x;
  const uint32_t salt_bucket = salt_for(seed, CS_STREAM_BUCKET, r);
  const uint32_t salt_sign = salt_for(seed, CS_STREAM_SIGN, r);
  const int* kr = keys + (long long)b * N;
  const float* vr = vals + (long long)b * N;

  float acc = 0.f;
  for (int n0 = 0; n0 < N; n0 += kCsChunk) {
    const int nc = min(kCsChunk, N - n0);
    __syncthreads();
    for (int i = threadIdx.x; i < nc; i += blockDim.x) {
      const uint32_t k = (uint32_t)kr[n0 + i];
      s_bucket[i] = (int)(hash_u32(k, salt_bucket) % (uint32_t)W);
      const float sign = (hash_u32(k, salt_sign) & 1u) == 0u ? 1.f : -1.f;
      s_term[i] = __fmul_rn(sign, vr[n0 + i]);  // exact: +-val
    }
    __syncthreads();
#pragma unroll 8
    for (int i = 0; i < nc; ++i) {
      if (s_bucket[i] == w) acc = __fadd_rn(acc, s_term[i]);
    }
  }
  if (w < W) out[(long long)br * W + w] = acc;
}

cudaError_t launch_countsketch_sparse(const int* keys, const float* vals, int B, int N,
                                      int W, int R, uint32_t seed, float* out,
                                      cudaStream_t stream) {
  if (B < 1 || N < 0 || W < 1 || R < 1) return cudaErrorInvalidValue;
  const long long rows = (long long)B * R;
  if (rows > INT_MAX) return cudaErrorInvalidValue;
  // one thread per bucket, a whole number of warps, at most kCsMaxThreads
  const int threads = min(kCsMaxThreads, (W + 31) / 32 * 32);
  const dim3 grid((unsigned)rows, (W + threads - 1) / threads);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  countsketch_sparse_kernel<<<grid, threads, 0, stream>>>(keys, vals, N, W, R, seed, out);
  return cudaGetLastError();
}

}  // namespace repro

// JL (AMS) projection of a padded sparse batch for Hopper.
//
// Replaces the TPU kernel repro/kernels/jl_sketch.py::_jl_kernel (launcher
// jl_sketch_pallas).  keys [B, N] i32, vals [B, N] f32 -> proj [B, m] f32,
//   proj[b, t] = (sum_n sign(t, key_n) * val_n) / sqrt(m),
// sign(t, key) = +1 where hash_u32(key, salt_for(seed, JL_STREAM_SIGN, t))
// is even, -1 where it is odd.
//
// The TPU kernel contracts a [BN, BM] sign tile with the values on the MXU;
// here one thread owns one (b, t) and walks the row's non-zeros in n order,
// one f32 add at a time, so the sum's order depends on neither B nor the
// padded N (pad lanes add +-0 and change no bit) and the plain version's
// loop gives the same bits.  A block of threads shares one row b: it stages
// a chunk of the row's keys and values in shared memory with coalesced
// loads, and every thread reads them by broadcast.  The division by
// sqrtf((float)m) comes last, an IEEE divide, as jl_sketch.py divides.
//
// Bound: operations (one keyed hash, a select, a multiply and an add per
// (b, t, n)).  At the ingest shape (B = 3, m = 769) only 2,307 threads run,
// each a long chain over N: latency-bound, left for a later change.
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "u32.cuh"

namespace repro {

constexpr int kJlThreads = 256;  // samples t per block
constexpr int kJlChunk = 1024;   // non-zeros staged per step

__global__ void __launch_bounds__(kJlThreads)
jl_sketch_kernel(const int* __restrict__ keys, const float* __restrict__ vals, int N,
                 int m, uint32_t seed, float* __restrict__ out) {
  __shared__ uint32_t s_key[kJlChunk];
  __shared__ float s_val[kJlChunk];

  const int t_blocks = (m + kJlThreads - 1) / kJlThreads;
  const int b = blockIdx.x / t_blocks;
  const int t = (blockIdx.x % t_blocks) * kJlThreads + threadIdx.x;
  const uint32_t salt = salt_for(seed, JL_STREAM_SIGN, (uint32_t)t);
  const int* kr = keys + (long long)b * N;
  const float* vr = vals + (long long)b * N;

  float acc = 0.f;
  for (int n0 = 0; n0 < N; n0 += kJlChunk) {
    const int nc = min(kJlChunk, N - n0);
    __syncthreads();
    for (int i = threadIdx.x; i < nc; i += kJlThreads) {
      s_key[i] = (uint32_t)kr[n0 + i];
      s_val[i] = vr[n0 + i];
    }
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < nc; ++i) {
      const float sign = (hash_u32(s_key[i], salt) & 1u) == 0u ? 1.f : -1.f;
      acc = __fadd_rn(acc, __fmul_rn(sign, s_val[i]));
    }
  }
  if (t < m) out[(long long)b * m + t] = __fdiv_rn(acc, __fsqrt_rn((float)m));
}

cudaError_t launch_jl_sketch(const int* keys, const float* vals, int B, int N, int m,
                             uint32_t seed, float* out, cudaStream_t stream) {
  if (B < 1 || N < 0 || m < 1) return cudaErrorInvalidValue;
  const long long blocks = (long long)B * ((m + kJlThreads - 1) / kJlThreads);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  jl_sketch_kernel<<<(unsigned)blocks, kJlThreads, 0, stream>>>(keys, vals, N, m, seed, out);
  return cudaGetLastError();
}

}  // namespace repro

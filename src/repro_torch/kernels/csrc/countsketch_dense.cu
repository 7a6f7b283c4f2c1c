// CountSketch of a dense vector for Hopper (gradient compression).
//
// Replaces the TPU kernel repro/kernels/countsketch.py::_cs_kernel
// (launcher countsketch_pallas).
// x [T] f32 -> table [R, W] f32, element i hashed as the u32 offset + i:
//   table[r, w] = sum_i [bucket_r(i) == w] * sign_r(i) * x_i.
//
// The TPU kernel scatters through a one-hot [1, BT] @ [BT, BW] MXU product
// and carries the table across its sequential t grid axis.  Here blocks run
// in no order, and the port has no float atomics, so the summation order is
// fixed by T alone: positions are cut into chunks of `chunk` elements.
//   Pass 1: one warp per (rep, chunk, bucket tile) keeps the tile's sums in
//   shared memory and walks the chunk in groups of 32 consecutive elements,
//   one per lane.  Lanes whose buckets differ add at once; lanes that share
//   a bucket add in lane (= t) order, one rank per step (__match_any_sync
//   names each lane's peers).  Each bucket's partial is a sum in t order
//   from +0, as B6 (countsketch_sparse.cu) takes it.
//   Pass 2: one thread per (rep, bucket) adds the chunk partials in chunk
//   order from +0 (skipped when there is one chunk: the partial is the sum).
// The plain version (kernels/countsketch.py) takes the same order, so the
// two agree bit for bit.
//
// Bound: operations.  Two keyed hashes per (element, rep) against 4 bytes
// read per element: the reps of one chunk are neighbouring blocks, so L2
// serves all reads of x but the first.
#include <cuda_runtime.h>
#include <cstdint>

#include "u32.cuh"

namespace repro {

constexpr int kCsdTileMax = 8192;  // buckets in one block's shared table (32 KB)
constexpr int kCsdBatch = 8;       // groups of 32 elements hashed before their adds
constexpr unsigned kCsdNone = 0xFFFFFFFFu;  // a lane with no bucket in this tile

__global__ void __launch_bounds__(32)
countsketch_dense_partial_kernel(const float* __restrict__ x, long long T, int W,
                                 uint32_t seed, uint32_t offset, int chunk, int tile,
                                 float* __restrict__ partial) {
  extern __shared__ float s_tab[];
  const uint32_t r = blockIdx.x;
  const long long c = blockIdx.y;
  const int w0 = blockIdx.z * tile;
  const int tw = min(tile, W - w0);
  const int lane = threadIdx.x;
  const unsigned below = (1u << lane) - 1u;
  const uint32_t salt_bucket = salt_for(seed, CS_STREAM_BUCKET, r);
  const uint32_t salt_sign = salt_for(seed, CS_STREAM_SIGN, r);

  for (int w = lane; w < tw; w += 32) s_tab[w] = 0.f;
  __syncwarp();
  const long long t0 = c * chunk;
  const long long t1 = min(T, t0 + chunk);
  for (long long g0 = t0; g0 < t1; g0 += 32LL * kCsdBatch) {
    float xv[kCsdBatch];
#pragma unroll
    for (int j = 0; j < kCsdBatch; ++j) {
      const long long t = g0 + 32LL * j + lane;
      xv[j] = t < t1 ? x[t] : 0.f;
    }
    unsigned key[kCsdBatch];  // bucket within the tile, or kCsdNone
    float term[kCsdBatch];
#pragma unroll
    for (int j = 0; j < kCsdBatch; ++j) {
      const long long t = g0 + 32LL * j + lane;
      const uint32_t idx = offset + (uint32_t)t;
      const uint32_t local = hash_u32(idx, salt_bucket) % (uint32_t)W - (uint32_t)w0;
      const float sign = (hash_u32(idx, salt_sign) & 1u) == 0u ? 1.f : -1.f;
      key[j] = (t < t1 && local < (uint32_t)tw) ? local : kCsdNone;
      term[j] = __fmul_rn(sign, xv[j]);  // exact: +-x
    }
#pragma unroll
    for (int j = 0; j < kCsdBatch; ++j) {
      const bool live = key[j] != kCsdNone;
      const int rank = __popc(__match_any_sync(0xFFFFFFFFu, key[j]) & below);
      bool more = __any_sync(0xFFFFFFFFu, live);
      for (int k = 0; more; ++k) {
        if (live && rank == k) s_tab[key[j]] = __fadd_rn(s_tab[key[j]], term[j]);
        __syncwarp();
        more = __any_sync(0xFFFFFFFFu, live && rank > k);
      }
    }
  }
  __syncwarp();
  float* out = partial + ((long long)r * gridDim.y + c) * W + w0;
  for (int w = lane; w < tw; w += 32) out[w] = s_tab[w];
}

__global__ void countsketch_dense_reduce_kernel(const float* __restrict__ partial,
                                                int n_chunks, int W, int R,
                                                float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;  // r * W + w
  if (i >= (long long)R * W) return;
  const long long r = i / W, w = i % W;
  const float* p = partial + r * n_chunks * (long long)W + w;
  float acc = 0.f;
  for (int c = 0; c < n_chunks; ++c) acc = __fadd_rn(acc, p[(long long)c * W]);
  out[i] = acc;
}

cudaError_t launch_countsketch_dense(const float* x, long long T, int W, int R,
                                     uint32_t seed, uint32_t offset, int chunk,
                                     float* scratch, float* out, cudaStream_t stream) {
  if (T < 1 || W < 1 || R < 1 || chunk < 1) return cudaErrorInvalidValue;
  const long long n_chunks = (T + chunk - 1) / chunk;
  const int tile = min(W, kCsdTileMax);
  const int n_tiles = (W + tile - 1) / tile;
  if (n_chunks > 65535 || n_tiles > 65535) return cudaErrorInvalidValue;
  float* partial = n_chunks == 1 ? out : scratch;
  const dim3 grid((unsigned)R, (unsigned)n_chunks, (unsigned)n_tiles);
  countsketch_dense_partial_kernel<<<grid, 32, tile * sizeof(float), stream>>>(
      x, T, W, seed, offset, chunk, tile, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks == 1) return err;
  const long long cells = (long long)R * W;
  countsketch_dense_reduce_kernel<<<(unsigned)((cells + 255) / 256), 256, 0, stream>>>(
      scratch, (int)n_chunks, W, R, out);
  return cudaGetLastError();
}

}  // namespace repro

// CountSketch of a padded sparse batch for Hopper.
//
// Replaces the TPU kernel repro/kernels/countsketch.py::_cs_sparse_kernel
// (launcher countsketch_sparse_pallas).
// keys [B, N] i32, vals [B, N] f32 -> T [B, R, W] f32, with
//   T[b, r, w] = sum_n [bucket_r(key_n) == w] * sign_r(key_n) * val_n.
//
// The TPU kernel turns the scatter into a one-hot [1, BN] @ [BN, BW] MXU
// product.  Here a block owns one (row b, rep r) and a run of up to 256
// buckets, one a thread (grid.y covers W past 256).  Each bucket's sum runs
// over ascending n, one f32 add at a time from +0, whatever B or the padded
// N: batched and single-row sketches, and the plain version's
// one-scatter-per-n loop, give the same bits.  No atomics (their order is
// not fixed).
//
// Bound: operations (2 keyed hashes, the bucket's modulo, the sign's select,
// its product and the add per (b, r, n)).  Instead of every bucket scanning
// every non-zero (O(N * W) compares), the block groups the terms by bucket,
// stably, with integer counting alone.  Per chunk of 1,024 non-zeros:
//  1. each warp takes four slabs of 32 consecutive n, in n order; a lane
//     hashes its key (bucket and signed term), __match_any_sync finds the
//     lanes of its bucket, and its rank is the warp's earlier count for that
//     bucket plus the popcount of those lanes below it; the lowest lane of
//     each group adds the group to the (warp, bucket) count in shared memory;
//  2. thread w turns bucket w's counts into offsets over the warps, and a
//     block scan over the buckets gives each bucket's start: the order is
//     (bucket, warp, slab, lane), which within a bucket is ascending n;
//  3. every term goes to its bucket's start + its warp's offset + its rank;
//  4. thread w adds its bucket's run, in n order, to its accumulator.
// A bucket then does its own terms' adds (about N / W) instead of N
// compares.  Keys and values of chunk c + 1 are fetched into registers while
// chunk c is grouped; lanes past N take no bucket.  A chunk's steps are
// serial and a block has 8 warps, so a chunk costs its latency (about 5,000
// clocks); hashing a chunk before ranking it, or nine ballots in place of
// __match_any_sync, moved that by under 8%.
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "u32.cuh"

namespace repro {

constexpr int kCsWarps = 8;
constexpr int kCsThreads = 32 * kCsWarps;                 // buckets a block, one a thread
constexpr int kCsSlabsPerWarp = 4;                        // a warp's slabs of 32 a chunk
constexpr int kCsChunk = kCsThreads * kCsSlabsPerWarp;    // non-zeros a chunk
constexpr int kCsNone = -1;                               // no bucket of this block

__global__ void __launch_bounds__(kCsThreads)
countsketch_sparse_kernel(const int* __restrict__ keys, const float* __restrict__ vals,
                          int N, int W, int R, uint32_t seed, float* __restrict__ out) {
  __shared__ int s_info[kCsChunk];    // the key, then (rank << 8 | bucket) or kCsNone
  __shared__ float s_term[kCsChunk];  // the value, then the signed term
  __shared__ float s_run[kCsChunk];   // the chunk's terms, grouped by bucket
  __shared__ int s_cnt[kCsWarps][kCsThreads];  // (warp, bucket) count, then offset
  __shared__ int s_start[kCsThreads];
  __shared__ int s_wsum[kCsWarps];

  const int br = blockIdx.x;  // b * R + r
  const int b = br / R;
  const uint32_t r = (uint32_t)(br % R);
  const int w0 = blockIdx.y * kCsThreads;
  const int nb = min(kCsThreads, W - w0);  // this block's buckets
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t below = (1u << lane) - 1u;
  const SaltPre salt_bucket = salt_pre(salt_for(seed, CS_STREAM_BUCKET, r));
  const SaltPre salt_sign = salt_pre(salt_for(seed, CS_STREAM_SIGN, r));
  const int* kr = keys + (long long)b * N;
  const float* vr = vals + (long long)b * N;

#pragma unroll
  for (int w = 0; w < kCsWarps; ++w) s_cnt[w][tid] = 0;
  int key[kCsSlabsPerWarp];
  float val[kCsSlabsPerWarp];
  auto fetch = [&](int n0) {
#pragma unroll
    for (int i = 0; i < kCsSlabsPerWarp; ++i) {
      const int n = n0 + i * kCsThreads + tid;
      key[i] = n < N ? kr[n] : 0;
      val[i] = n < N ? vr[n] : 0.f;
    }
  };
  fetch(0);

  float acc = 0.f;
  for (int n0 = 0; n0 < N; n0 += kCsChunk) {
#pragma unroll
    for (int i = 0; i < kCsSlabsPerWarp; ++i) {
      s_info[i * kCsThreads + tid] = key[i];
      s_term[i * kCsThreads + tid] = val[i];
    }
    fetch(n0 + kCsChunk);
    __syncthreads();

    // 1. hash, and rank each term among the warp's earlier terms of its bucket
#pragma unroll 1
    for (int s = 0; s < kCsSlabsPerWarp; ++s) {
      const int j = (warp * kCsSlabsPerWarp + s) * 32 + lane;
      const uint32_t k = (uint32_t)s_info[j];
      const int w = (int)(hash_pre(k, salt_bucket) % (uint32_t)W) - w0;
      const float sign = (hash_pre(k, salt_sign) & 1u) == 0u ? 1.f : -1.f;
      s_term[j] = __fmul_rn(sign, s_term[j]);  // exact: +-val
      const int mine = n0 + j < N && (unsigned)w < (unsigned)nb ? w : kCsNone;
      const uint32_t peers = __match_any_sync(0xFFFFFFFFu, mine);
      const int before = mine != kCsNone ? s_cnt[warp][mine] : 0;
      __syncwarp();
      if (mine != kCsNone && (peers & below) == 0u)
        s_cnt[warp][mine] = before + __popc(peers);
      s_info[j] = mine != kCsNone ? (before + __popc(peers & below)) << 8 | mine : kCsNone;
      __syncwarp();
    }
    __syncthreads();

    // 2. bucket tid's offsets over the warps, then the buckets' starts
    int total = 0;
#pragma unroll
    for (int w = 0; w < kCsWarps; ++w) {
      const int c = s_cnt[w][tid];
      s_cnt[w][tid] = total;
      total += c;
    }
    int incl = total;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int x = __shfl_up_sync(0xFFFFFFFFu, incl, o);
      if (lane >= o) incl += x;
    }
    if (lane == 31) s_wsum[warp] = incl;
    __syncthreads();
    int start = incl - total;
    for (int w = 0; w < warp; ++w) start += s_wsum[w];
    s_start[tid] = start;
    __syncthreads();

    // 3. each term to its slot: bucket start + warp offset + rank
#pragma unroll
    for (int i = 0; i < kCsSlabsPerWarp; ++i) {
      const int j = i * kCsThreads + tid;
      const int info = s_info[j];
      if (info != kCsNone) {
        const int w = info & 0xFF;
        s_run[s_start[w] + s_cnt[j / (32 * kCsSlabsPerWarp)][w] + (info >> 8)] = s_term[j];
      }
    }
    __syncthreads();

    // 4. bucket tid's run in n order; its counts cleared for the next chunk
#pragma unroll 4
    for (int p = start; p < start + total; ++p) acc = __fadd_rn(acc, s_run[p]);
#pragma unroll
    for (int w = 0; w < kCsWarps; ++w) s_cnt[w][tid] = 0;
  }
  if (tid < nb) out[(long long)br * W + w0 + tid] = acc;
}

cudaError_t launch_countsketch_sparse(const int* keys, const float* vals, int B, int N,
                                      int W, int R, uint32_t seed, float* out,
                                      cudaStream_t stream) {
  if (B < 1 || N < 0 || W < 1 || R < 1) return cudaErrorInvalidValue;
  const long long rows = (long long)B * R;
  if (rows > INT_MAX) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)rows, (W + kCsThreads - 1) / kCsThreads);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  countsketch_sparse_kernel<<<grid, kCsThreads, 0, stream>>>(keys, vals, N, W, R, seed, out);
  return cudaGetLastError();
}

}  // namespace repro

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
//   Pass 1: one warp per (rep, chunk, tile of up to 4,096 buckets) keeps the
//   tile's sums in shared memory, from +0, and walks the chunk in batches of
//   8 groups of 32 consecutive elements, one a lane.  The groups are added
//   in order.  Before its add a group finds whether two of its lanes share a
//   bucket: each lane stamps its lane number into its bucket's byte of a tag
//   table and reads it back (two lanes of one bucket cannot both read their
//   own), one __any_sync for the group.  A group without a shared bucket
//   (most of them: 32 lanes in 4,096 buckets collide in about one group of
//   nine) adds in one shared-memory read-add-write; one with a shared bucket
//   adds in rank rounds, lanes of rank k (__match_any_sync; lane = t order)
//   in round k, as many rounds as its largest rank (__reduce_max_sync).
//   While group j's reads land, element j of the next batch is hashed (salts
//   hoisted, % W by a reciprocal and one correction, 32-bit positions inside
//   the chunk) and its x fetched a batch ahead.  Each bucket's partial is so
//   a sum in t order from +0, one __fadd_rn of __fmul_rn(sign, x) a term, as
//   B6 (countsketch_sparse.cu) takes it; no float atomics.
//   Pass 2: one thread per (rep, bucket) adds the chunk partials in chunk
//   order from +0 (skipped when there is one chunk: the partial is the sum).
// The plain version (kernels/countsketch.py) takes the same order, so the
// two agree bit for bit at every T, W, R and offset.
//
// Bound: operations.  Two keyed hashes per (element, rep) against 4 bytes
// read per element: the reps of one chunk are neighbouring blocks, so L2
// serves all reads of x but the first.  Times below are the H100's at T =
// 44 M, W = 4,096, R = 5.  The design before this one ran each group's
// match, its rank votes and its adds as one serial chain (about 585 clocks
// a group of 32 at one warp an SM; 2.0 ms), and at full load
// __match_any_sync alone, one a group, held it there: issuing a batch's
// eight matches ahead of its adds also ran 2.0 ms, 13 ballots in place of
// the match 2.2.  The tag table costs 4 KB a warp (10 warps an SM instead
// of 13) and takes the match off all but the colliding groups: 1.19 ms,
// and 1.09 with the next batch hashed between a group's reads.  Dropped:
// blocks of two warps splitting the tile, each hashing half of a batch for
// both (18 warps an SM, 1.27 ms); blocks of 16 warps per (rep, chunk)
// grouping every sub-chunk by bucket (integer counts; a block scan, a
// scatter and a rank pass, or four slots a bucket and a spill list; then
// each bucket's owner thread adding its terms in order: 2.1-3.3 ms, from
// shared-memory traffic a term, barriers and divergent owners).
#include <cuda_runtime.h>
#include <cstdint>

#include "u32.cuh"

namespace repro {
namespace {

constexpr int kCsdTileMax = 4096;   // buckets in one warp's shared table (16 KB + tags)
constexpr int kCsdBatch = 8;        // groups of 32 elements a batch (hashed a batch ahead)
constexpr uint32_t kCsdNone = 0xFFFFFFFFu;   // a lane with no bucket in this tile
constexpr uint32_t kFull = 0xFFFFFFFFu;

// u % W, with inv = floor(2^32 / W) (2^32 - 1 at W = 1): the quotient
// estimate is short by at most one, so one correction is exact
__device__ __forceinline__ uint32_t mod_by(uint32_t u, uint32_t W, uint32_t inv) {
  uint32_t r = u - __umulhi(u, inv) * W;
  return r >= W ? r - W : r;
}

__global__ void __launch_bounds__(32)
countsketch_dense_partial_kernel(const float* __restrict__ x, long long T, int W,
                                 uint32_t seed, uint32_t offset, int chunk, int tile,
                                 uint32_t w_inv, float* __restrict__ partial) {
  extern __shared__ float s_tab[];   // the tile's sums, then a tag a bucket
  unsigned char* s_tag = reinterpret_cast<unsigned char*>(s_tab + tile);
  const uint32_t r = blockIdx.x;
  const long long c = blockIdx.y;
  const int w0 = blockIdx.z * tile;
  const uint32_t tw = (uint32_t)min(tile, W - w0);
  const int lane = threadIdx.x;
  const uint32_t below = (1u << lane) - 1u;
  const SaltPre salt_bucket = salt_pre(salt_for(seed, CS_STREAM_BUCKET, r));
  const SaltPre salt_sign = salt_pre(salt_for(seed, CS_STREAM_SIGN, r));
  const long long t0 = c * chunk;
  const int len = (int)min((long long)chunk, T - t0);
  const float* xc = x + t0;
  const uint32_t base = offset + (uint32_t)t0;   // u32 wrap, as the plain version

  // element t's bucket within the tile (or kCsdNone) and sign bit
  auto hash = [&](int t, uint32_t& key, uint32_t& sign) {
    const uint32_t idx = base + (uint32_t)t;
    const uint32_t local =
        mod_by(hash_pre(idx, salt_bucket), (uint32_t)W, w_inv) - (uint32_t)w0;
    key = t < len && local < tw ? local : kCsdNone;
    sign = hash_pre(idx, salt_sign) & 1u;
  };
  auto fetch = [&](int g0, float* xv) {
#pragma unroll
    for (int j = 0; j < kCsdBatch; ++j) {
      const int t = g0 + 32 * j + lane;
      xv[j] = t < len ? xc[t] : 0.f;
    }
  };

  for (uint32_t w = lane; w < tw; w += 32) s_tab[w] = 0.f;
  // the batch being added (key, sign bit j of signs, x) and the next one
  uint32_t key[kCsdBatch], signs = 0u;
  float xv[kCsdBatch];
  fetch(0, xv);
#pragma unroll
  for (int j = 0; j < kCsdBatch; ++j) {
    uint32_t sign;
    hash(32 * j + lane, key[j], sign);
    signs |= sign << j;
  }
  for (int g0 = 0; g0 < len; g0 += 32 * kCsdBatch) {
    const int g1 = g0 + 32 * kCsdBatch;
    uint32_t key_next[kCsdBatch], signs_next = 0u;
    float xv_next[kCsdBatch];
    fetch(g1, xv_next);
#pragma unroll
    for (int j = 0; j < kCsdBatch; ++j) {
      // a shared bucket in group j: each lane stamps its bucket's tag and
      // reads it back; two lanes of one bucket cannot both read their own
      const bool live = key[j] != kCsdNone;
      __syncwarp();   // the previous group's adds and tag reads are done
      if (live) s_tag[key[j]] = (unsigned char)lane;
      __syncwarp();
      const bool lost = live && s_tag[key[j]] != lane;
      const float cur = live ? s_tab[key[j]] : 0.f;
      // the next batch's element j hashes while those reads land
      uint32_t sign;
      hash(g1 + 32 * j + lane, key_next[j], sign);
      signs_next |= sign << j;
      const float term = __fmul_rn((signs >> j & 1u) ? -1.f : 1.f, xv[j]);  // exact: +-x
      if (!__any_sync(kFull, lost)) {
        if (live) s_tab[key[j]] = __fadd_rn(cur, term);
      } else {
        // lanes of rank k (lane = t order) among their bucket's add in round k
        const uint32_t rank = __popc(__match_any_sync(kFull, key[j]) & below);
        const uint32_t top = __reduce_max_sync(kFull, live ? rank : 0u);
        for (uint32_t k = 0; k <= top; ++k) {
          if (live && rank == k) s_tab[key[j]] = __fadd_rn(s_tab[key[j]], term);
          __syncwarp();
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kCsdBatch; ++j) {
      key[j] = key_next[j];
      xv[j] = xv_next[j];
    }
    signs = signs_next;
  }
  __syncwarp();
  float* out = partial + ((long long)r * gridDim.y + c) * W + w0;
  for (uint32_t w = lane; w < tw; w += 32) out[w] = s_tab[w];
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

}  // namespace

cudaError_t launch_countsketch_dense(const float* x, long long T, int W, int R,
                                     uint32_t seed, uint32_t offset, int chunk,
                                     float* scratch, float* out, cudaStream_t stream) {
  if (T < 1 || W < 1 || R < 1 || chunk < 1) return cudaErrorInvalidValue;
  const long long n_chunks = (T + chunk - 1) / chunk;
  const int tile = min(W, kCsdTileMax);
  const int n_tiles = (W + tile - 1) / tile;
  if (n_chunks > 65535 || n_tiles > 65535) return cudaErrorInvalidValue;
  const uint32_t w_inv =
      W == 1 ? 0xFFFFFFFFu : (uint32_t)((1ull << 32) / (unsigned long long)W);
  float* partial = n_chunks == 1 ? out : scratch;
  const dim3 grid((unsigned)R, (unsigned)n_chunks, (unsigned)n_tiles);
  countsketch_dense_partial_kernel<<<grid, 32, tile * (sizeof(float) + 1), stream>>>(
      x, T, W, seed, offset, chunk, tile, w_inv, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks == 1) return err;
  const long long cells = (long long)R * W;
  countsketch_dense_reduce_kernel<<<(unsigned)((cells + 255) / 256), 256, 0, stream>>>(
      scratch, (int)n_chunks, W, R, out);
  return cudaGetLastError();
}

}  // namespace repro

// Batched ICWS (weighted MinHash) sketch for Hopper.
//
// Replaces the TPU kernel repro/kernels/icws_sketch.py::_icws_kernel.
// [B, N] (w f32, keys i32, vals f32) -> (fp i32, val f32, amin f32, argkey i32) [B, m].
//
// Bound: operations, not bytes.  Each (row, t, non-zero) draw costs ten
// murmur rounds, two logf, two expf and two IEEE divides; the [B, N] inputs
// are read once per block from L2.  Design: a block serves one row and 256 /
// S samples t of it, a group of S consecutive threads (S a power of two up
// to 256, a whole block) owning one (row, t) pair.  The block stages its
// row's non-zeros a chunk at a time in shared memory, with logw = logf(max(w,
// 1e-37)) computed once per (row, non-zero) there (NaN marks a pad lane, w
// <= 0: logf of a positive float is never NaN), so the draws of every t of
// the block read it; that is the same operation on the same value, and one
// logf a draw fewer.  The group's threads stride over the chunk, so they read
// neighbouring words and the groups of a warp the same ones.  Within a thread
// the strict `<` keeps the first index; the group then merges (a, index)
// lexicographically, first within each warp by shuffles, then across its
// warps through shared memory.  That order is associative and commutative, so
// every S gives the whole row's first-index argmin -- the TPU kernel's
// jnp.argmin + strict-`<` tile merge -- and a row's bits do not depend on the
// launch shape.  S grows where B m is too small to fill the card
// (single-table ingest sketches three rows), up to half a block: at a whole
// block every draw pays for its staged logf again.  40 registers, six blocks
// a SM; capping them at 32 (eight blocks) spilled nothing but added four
// instructions a draw and gained no time.  The TPU grid's sequential N axis
// becomes the loop over chunks; no [B, m, N] tensor exists anywhere.  Compiled
// with -fmad=false and IEEE divides: a contraction of logw / r + beta could
// flip a floor.
//
// With Pack (the TPU kernel's pack_vals epilogue, _icws_kernel_packed) the
// kernel also writes the bf16-halfword plane [B, me / 2] i32 (me = m rounded
// up to even).  A row's samples are spread over groups and blocks, so the
// thread that finishes (row, t) ORs its halfword into the word the wrapper
// zeroed: OR is order-free, so the word's bits do not depend on which thread
// gets there first.  Empty rows write value 0 (halfword 0), and the odd-m
// pad slot is never written, so both stay zero as pack_rows pads them.
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "packed.cuh"
#include "u32.cuh"

namespace repro {

constexpr int kSketchThreads = 256;
constexpr int kSketchWarps = kSketchThreads / 32;
constexpr int kSketchStage = 2048;  // non-zeros of the row staged at a time

// (a, i) lexicographically below (best, best_i): the first index of the minimum
__device__ __forceinline__ void icws_take(float a, int i, float lvl, float& best,
                                          int& best_i, float& best_lvl) {
  if (a < best || (a == best && i < best_i)) {
    best = a;
    best_i = i;
    best_lvl = lvl;
  }
}

template <bool Pack>
__global__ void __launch_bounds__(kSketchThreads)
icws_sketch_kernel(const float* __restrict__ w, const int* __restrict__ keys,
                   const float* __restrict__ vals, int N, int m, uint32_t seed, int S,
                   int* __restrict__ fp_out, float* __restrict__ val_out,
                   float* __restrict__ amin_out, int* __restrict__ key_out,
                   int* __restrict__ packed) {
  __shared__ float s_logw[kSketchStage];
  __shared__ int s_key[kSketchStage];
  __shared__ float s_best[kSketchWarps], s_lvl[kSketchWarps];
  __shared__ int s_idx[kSketchWarps];

  const int b = blockIdx.x;  // the block's row
  const int s = threadIdx.x & (S - 1);
  const int tt = blockIdx.y * (kSketchThreads / S) + threadIdx.x / S;
  const bool live = tt < m;
  const uint32_t t = live ? (uint32_t)tt : 0u;

  const uint32_t s_r1 = salt_for(seed, ICWS_STREAM_R1, t);
  const uint32_t s_r2 = salt_for(seed, ICWS_STREAM_R2, t);
  const uint32_t s_c1 = salt_for(seed, ICWS_STREAM_C1, t);
  const uint32_t s_c2 = salt_for(seed, ICWS_STREAM_C2, t);
  const uint32_t s_beta = salt_for(seed, ICWS_STREAM_BETA, t);

  const float* wr = w + (long long)b * N;
  const int* kr = keys + (long long)b * N;

  float best = __int_as_float(0x7f800000);  // +inf: any thread's value beats it
  int best_i = INT_MAX;
  float best_lvl = 0.f;
  for (int c0 = 0; c0 < N; c0 += kSketchStage) {
    const int cn = min(kSketchStage, N - c0);
    if (c0 > 0) __syncthreads();  // every group is done with the last chunk
    for (int j = threadIdx.x; j < cn; j += kSketchThreads) {
      const float wi = wr[c0 + j];
      s_logw[j] = wi > 0.f ? logf(fmaxf(wi, 1e-37f)) : __int_as_float(0x7fffffff);
      s_key[j] = kr[c0 + j];
    }
    __syncthreads();
    if (live) {
      for (int j = s; j < cn; j += S) {
        const float logw = s_logw[j];
        float a = BIG;
        float lvl = 0.f;
        if (!isnan(logw)) {
          const uint32_t k = (uint32_t)s_key[j];
          const float r = -logf(__fmul_rn(uniform01(k, s_r1), uniform01(k, s_r2)));
          const float c = -logf(__fmul_rn(uniform01(k, s_c1), uniform01(k, s_c2)));
          const float beta = uniform01(k, s_beta);
          lvl = floorf(__fadd_rn(__fdiv_rn(logw, r), beta));
          const float y = expf(__fmul_rn(r, __fsub_rn(lvl, beta)));
          a = __fdiv_rn(c, __fmul_rn(y, expf(r)));
        }
        if (a < best) {  // strict: the thread's first index wins ties
          best = a;
          best_i = c0 + j;
          best_lvl = lvl;
        }
      }
    }
  }
  // lexicographic (a, index) min over the group's threads in this warp ...
  for (int off = (S < 32 ? S : 32) >> 1; off > 0; off >>= 1)
    icws_take(__shfl_xor_sync(0xffffffffu, best, off),
              __shfl_xor_sync(0xffffffffu, best_i, off),
              __shfl_xor_sync(0xffffffffu, best_lvl, off), best, best_i, best_lvl);
  // ... then over its warps (S > 32), by the group's first thread
  if (S > 32) {
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
      s_best[warp] = best;
      s_idx[warp] = best_i;
      s_lvl[warp] = best_lvl;
    }
    __syncthreads();
    if (s == 0)
      for (int v = 1; v < S / 32; ++v)
        icws_take(s_best[warp + v], s_idx[warp + v], s_lvl[warp + v], best, best_i, best_lvl);
  }
  if (!live || s != 0) return;
  const long long o = (long long)b * m + t;
  amin_out[o] = best;
  if (!(best < BIG)) {  // empty row (only masked lanes)
    fp_out[o] = -1;
    val_out[o] = 0.f;
    key_out[o] = 0;
    return;
  }
  const int key = kr[best_i];
  const uint32_t lv = (uint32_t)(int)best_lvl;
  const uint32_t bits = hash_u32((uint32_t)key ^ (lv * 0x9E3779B9u),
                                 salt_for(seed, ICWS_STREAM_FP, t));
  const float v = vals[(long long)b * N + best_i];
  fp_out[o] = (int)(bits & 0x7FFFFFFFu);
  val_out[o] = v;
  key_out[o] = key;
  if (Pack) {
    const long long word = (long long)b * ((m + 1) / 2) + (t >> 1);
    atomicOr(reinterpret_cast<unsigned int*>(packed) + word, pack_half(v, t & 1));
  }
}

cudaError_t launch_icws_sketch(const float* w, const int* keys, const float* vals,
                               int B, int N, int m, uint32_t seed, int S, int* fp,
                               float* val, float* amin, int* argkey, int* packed,
                               cudaStream_t stream) {
  if (S < 1 || S > kSketchThreads || (S & (S - 1)) != 0 || B < 0 || N < 0 || m < 1)
    return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  // a block: one row, 256 / S samples of it
  const int per_block = kSketchThreads / S;
  const int tiles = (m + per_block - 1) / per_block;
  if (tiles > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)B, (unsigned)tiles);
  if (packed)
    icws_sketch_kernel<true><<<grid, kSketchThreads, 0, stream>>>(
        w, keys, vals, N, m, seed, S, fp, val, amin, argkey, packed);
  else
    icws_sketch_kernel<false><<<grid, kSketchThreads, 0, stream>>>(
        w, keys, vals, N, m, seed, S, fp, val, amin, argkey, packed);
  return cudaGetLastError();
}

}  // namespace repro

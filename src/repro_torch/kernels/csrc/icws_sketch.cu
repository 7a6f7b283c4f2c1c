// Batched ICWS (weighted MinHash) sketch for Hopper.
//
// Replaces the TPU kernel repro/kernels/icws_sketch.py::_icws_kernel.
// [B, N] (w f32, keys i32, vals f32) -> (fp i32, val f32, amin f32, argkey i32) [B, m].
//
// Bound: operations, not bytes.  Each (row, t, non-zero) costs ten murmur
// rounds, three logf, two expf and two IEEE divides; the [B, N] inputs are
// read once per row from L2.  Design: a group of S consecutive lanes (S a
// power of two <= 32) owns one (row, t) pair and strides over the row's
// non-zeros, so lanes of a group read neighbouring addresses and the groups
// of a warp (same row, other t) read the same ones.  Within a lane the
// strict `<` keeps the first index; the group then merges (a, index)
// lexicographically with shuffles, which is the first-index argmin of the
// whole row for every S -- the TPU kernel's jnp.argmin + strict-`<` tile
// merge.  The TPU grid's sequential N axis becomes the in-lane loop; no
// [B, m, N] tensor exists anywhere.  Compiled with -fmad=false and IEEE
// divides: a contraction of logw / r + beta could flip a floor.
//
// With Pack (the TPU kernel's pack_vals epilogue, _icws_kernel_packed) the
// kernel also writes the bf16-halfword plane [B, me / 2] i32 (me = m rounded
// up to even).  A row's samples are spread over groups and blocks, so the
// lane that finishes (row, t) ORs its halfword into the word the wrapper
// zeroed: OR is order-free, so the word's bits do not depend on which lane
// gets there first.  Empty rows write value 0 (halfword 0), and the odd-m
// pad slot is never written, so both stay zero as pack_rows pads them.
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "packed.cuh"
#include "u32.cuh"

namespace repro {

constexpr int kSketchThreads = 256;

template <bool Pack>
__global__ void __launch_bounds__(kSketchThreads)
icws_sketch_kernel(const float* __restrict__ w, const int* __restrict__ keys,
                   const float* __restrict__ vals, int B, int N, int m,
                   uint32_t seed, int S, int* __restrict__ fp_out,
                   float* __restrict__ val_out, float* __restrict__ amin_out,
                   int* __restrict__ key_out, int* __restrict__ packed) {
  const int groups_per_block = kSketchThreads / S;
  const long long gid = (long long)blockIdx.x * groups_per_block + threadIdx.x / S;
  const int s = threadIdx.x % S;
  const bool live = gid < (long long)B * m;
  const int b = live ? (int)(gid / m) : 0;
  const uint32_t t = live ? (uint32_t)(gid % m) : 0u;

  const uint32_t s_r1 = salt_for(seed, ICWS_STREAM_R1, t);
  const uint32_t s_r2 = salt_for(seed, ICWS_STREAM_R2, t);
  const uint32_t s_c1 = salt_for(seed, ICWS_STREAM_C1, t);
  const uint32_t s_c2 = salt_for(seed, ICWS_STREAM_C2, t);
  const uint32_t s_beta = salt_for(seed, ICWS_STREAM_BETA, t);

  const float* wr = w + (long long)b * N;
  const int* kr = keys + (long long)b * N;

  float best = __int_as_float(0x7f800000);  // +inf: any lane value beats it
  int best_i = INT_MAX;
  float best_lvl = 0.f;
  if (live) {
    for (int i = s; i < N; i += S) {
      const float wi = wr[i];
      float a = BIG;
      float lvl = 0.f;
      if (wi > 0.f) {
        const uint32_t k = (uint32_t)kr[i];
        const float r = -logf(__fmul_rn(uniform01(k, s_r1), uniform01(k, s_r2)));
        const float c = -logf(__fmul_rn(uniform01(k, s_c1), uniform01(k, s_c2)));
        const float beta = uniform01(k, s_beta);
        const float logw = logf(fmaxf(wi, 1e-37f));
        lvl = floorf(__fadd_rn(__fdiv_rn(logw, r), beta));
        const float y = expf(__fmul_rn(r, __fsub_rn(lvl, beta)));
        a = __fdiv_rn(c, __fmul_rn(y, expf(r)));
      }
      if (a < best) {  // strict: the lane's first index wins ties
        best = a;
        best_i = i;
        best_lvl = lvl;
      }
    }
  }
  // lexicographic (a, index) min across the group: first-index argmin
  for (int off = S >> 1; off > 0; off >>= 1) {
    const float oa = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, best_i, off);
    const float ol = __shfl_xor_sync(0xffffffffu, best_lvl, off);
    if (oa < best || (oa == best && oi < best_i)) {
      best = oa;
      best_i = oi;
      best_lvl = ol;
    }
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
  if (S < 1 || S > 32 || (S & (S - 1)) != 0) return cudaErrorInvalidValue;
  const long long groups = (long long)B * m;
  const long long per_block = kSketchThreads / S;
  const long long blocks = (groups + per_block - 1) / per_block;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  if (packed)
    icws_sketch_kernel<true><<<(unsigned)blocks, kSketchThreads, 0, stream>>>(
        w, keys, vals, B, N, m, seed, S, fp, val, amin, argkey, packed);
  else
    icws_sketch_kernel<false><<<(unsigned)blocks, kSketchThreads, 0, stream>>>(
        w, keys, vals, B, N, m, seed, S, fp, val, amin, argkey, packed);
  return cudaGetLastError();
}

}  // namespace repro

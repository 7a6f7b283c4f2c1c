// JL (AMS) projection of a padded sparse batch for Hopper.
//
// Replaces the TPU kernel repro/kernels/jl_sketch.py::_jl_kernel (launcher
// jl_sketch_pallas).  keys [B, N] i32, vals [B, N] f32 -> proj [B, m] f32,
//   proj[b, t] = (sum_n sign(t, key_n) * val_n) / sqrt(m),
// sign(t, key) = +1 where hash_u32(key, salt_for(seed, JL_STREAM_SIGN, t))
// is even, -1 where it is odd.
//
// The TPU kernel contracts a [BN, BM] sign tile with the values on the MXU.
// Here each (b, t) sum is one serial chain: one lane adds the row's terms
// over ascending n, one f32 add at a time from +0, so the sum's order
// depends on neither B nor the padded N and the plain version's loop gives
// the same bits.  The division by sqrtf((float)m) comes last, an IEEE
// divide, as jl_sketch.py divides.
//
// Bound: operations (one keyed hash, a select, a multiply and an add per
// (b, t, n)), and two floors beside it: the hashing's instructions, and the
// chain's N dependent adds.  The design keeps the hashing off the chain and
// spreads it over the card.  A block owns one row b and a tile of TT samples
// t (8 or 16, picked on the host so that a launch gives at least two blocks
// an SM where it can).  Eight hash warps cut the row into slabs of 32
// consecutive n: lane l hashes key n = 32 * slab + l under each t's salt
// (the salt's two products hoisted per t) and stores the signed term (the
// hash's low bit on the value's sign bit: exact, and -0 for -1 * 0 as
// __fmul_rn gives) in the tile's row of t.  The ninth warp runs the chains,
// lane tt for t0 + tt: four staged terms a 16-byte load, one f32 add each,
// and nothing else.  The row goes in chunks of 512, double-buffered: the
// hash warps sign chunk c + 1 (their keys and values fetched into registers
// one chunk ahead) while the chain warp adds chunk c.  Pad lanes carry value
// 0: an accumulator that starts at +0 never becomes -0 (a sum rounds to -0
// only when both addends are -0), so a +-0 term leaves it unchanged.
//
// The hashing is integer work, two shift-xor-multiply rounds a term, most
// of it for the SM's 16-lane integer pipe, the likely limit at B = 48.
// Keeping 32-bit ballot masks of the sign bits instead, and
// flipping each value's sign on the chain, put two integer operations per
// (t, n) on the chain warp, whose 8 or 16 lanes pay for them as if they
// were 32: 1.2-1.6x slower at every shape.
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "u32.cuh"

namespace repro {

constexpr int kJlHashWarps = 8;
constexpr int kJlThreads = 32 * (kJlHashWarps + 1);  // the hash warps, the chain warp
constexpr int kJlSlabsPerWarp = 2;                    // a hash warp's slabs a chunk
constexpr int kJlChunk = 32 * kJlHashWarps * kJlSlabsPerWarp;  // non-zeros a chunk
constexpr int kJlRow = kJlChunk + 4;  // a t's terms, padded: no bank conflicts

// shared memory of a TT tile: staged keys and values, and the terms, two
// buffers each
template <int TT>
constexpr int jl_smem() {
  return (2 * 2 * kJlChunk + 2 * TT * kJlRow) * 4;
}

template <int TT>
__global__ void __launch_bounds__(kJlThreads)
jl_sketch_kernel(const int* __restrict__ keys, const float* __restrict__ vals, int N,
                 int m, uint32_t seed, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  uint32_t* s_key = reinterpret_cast<uint32_t*>(smem);  // [2][chunk]
  float* s_val = smem + 2 * kJlChunk;                    // [2][chunk]
  float* s_term = smem + 4 * kJlChunk;                   // [2][TT][row]

  const int t_blocks = (m + TT - 1) / TT;
  const int b = blockIdx.x / t_blocks;
  const int t0 = (blockIdx.x % t_blocks) * TT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int* kr = keys + (long long)b * N;
  const float* vr = vals + (long long)b * N;
  const int chunks = (N + kJlChunk - 1) / kJlChunk;

  SaltPre pre[TT];
#pragma unroll
  for (int tt = 0; tt < TT; ++tt)
    pre[tt] = salt_pre(salt_for(seed, JL_STREAM_SIGN, (uint32_t)(t0 + tt)));

  // a hash warp's slabs of one chunk: fetched into registers a chunk ahead,
  // staged, then signed into that chunk's buffer of terms
  uint32_t key[kJlSlabsPerWarp];
  float val[kJlSlabsPerWarp];
  auto fetch = [&](int c) {
#pragma unroll
    for (int i = 0; i < kJlSlabsPerWarp; ++i) {
      const int n = c * kJlChunk + (warp * kJlSlabsPerWarp + i) * 32 + lane;
      key[i] = n < N ? (uint32_t)kr[n] : 0u;
      val[i] = n < N ? vr[n] : 0.f;
    }
  };
  auto sign = [&](int c) {
    const int buf = c & 1;
#pragma unroll
    for (int i = 0; i < kJlSlabsPerWarp; ++i) {
      const int j = buf * kJlChunk + (warp * kJlSlabsPerWarp + i) * 32 + lane;
      s_key[j] = key[i];
      s_val[j] = val[i];
    }
    fetch(c + 1);
    float* term = s_term + buf * TT * kJlRow;
#pragma unroll 1
    for (int i = 0; i < kJlSlabsPerWarp; ++i) {
      const int n = (warp * kJlSlabsPerWarp + i) * 32 + lane;
      const uint32_t k = s_key[buf * kJlChunk + n];  // this lane's own stores
      const float v = s_val[buf * kJlChunk + n];
#pragma unroll
      for (int tt = 0; tt < TT; ++tt)
        term[tt * kJlRow + n] =
            __uint_as_float(__float_as_uint(v) ^ (hash_pre(k, pre[tt]) << 31));
    }
  };

  const bool chain = warp == kJlHashWarps;
  if (!chain && chunks > 0) {
    fetch(0);
    sign(0);
  }
  __syncthreads();
  float acc = 0.f;
  const int tt = lane < TT ? lane : TT - 1;
  for (int c = 0; c < chunks; ++c) {
    if (chain) {
      const float4* t4 =
          reinterpret_cast<const float4*>(s_term + ((c & 1) * TT + tt) * kJlRow);
      const int quads = min(kJlChunk, N - c * kJlChunk + 3) >> 2;
#pragma unroll 8
      for (int q = 0; q < quads; ++q) {
        const float4 v = t4[q];
        acc = __fadd_rn(acc, v.x);
        acc = __fadd_rn(acc, v.y);
        acc = __fadd_rn(acc, v.z);
        acc = __fadd_rn(acc, v.w);
      }
    } else if (c + 1 < chunks) {
      sign(c + 1);
    }
    __syncthreads();
  }
  if (chain && lane < TT && t0 + lane < m)
    out[(long long)b * m + t0 + lane] = __fdiv_rn(acc, __fsqrt_rn((float)m));
}

template <int TT>
cudaError_t launch_jl_tile(const int* keys, const float* vals, int B, int N, int m,
                           uint32_t seed, float* out, cudaStream_t stream) {
  const long long blocks = (long long)B * ((m + TT - 1) / TT);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const cudaError_t err = cudaFuncSetAttribute(
      jl_sketch_kernel<TT>, cudaFuncAttributeMaxDynamicSharedMemorySize, jl_smem<TT>());
  if (err != cudaSuccess) return err;
  jl_sketch_kernel<TT><<<(unsigned)blocks, kJlThreads, jl_smem<TT>(), stream>>>(
      keys, vals, N, m, seed, out);
  return cudaGetLastError();
}

cudaError_t launch_jl_sketch(const int* keys, const float* vals, int B, int N, int m,
                             int tile, uint32_t seed, float* out, cudaStream_t stream) {
  if (B < 1 || N < 0 || m < 1) return cudaErrorInvalidValue;
  switch (tile) {
    case 8: return launch_jl_tile<8>(keys, vals, B, N, m, seed, out, stream);
    case 16: return launch_jl_tile<16>(keys, vals, B, N, m, seed, out, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace repro

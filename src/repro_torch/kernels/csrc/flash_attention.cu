// Forward flash attention for Hopper, all math in f32.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_flash_kernel
// (launcher flash_attention_pallas).
// q [BH, T, D], k/v [BH / group, S, D], f32 or bf16 -> o [BH, T, D] in the
// input type; q head bh reads kv head bh / group (no kv copy).  Per row: q
// scaled by 1/sqrt(D) in f32 before the product, scores s = q k^T, masked
// scores -1e30 (causal: k_pos <= q_pos; window: k_pos > q_pos - window), an
// online softmax over key tiles from m = -inf (corr = exp(m - m_new)), and
// o = acc / max(l, 1e-30).  A row that sees no key at all gets the mean of
// v, as on the TPU: its masked scores tie at -1e30, p = 1 on every key.
//
// Design: one block of 256 threads per (bh, 64 query rows).  The block keeps
// its scaled q tile in shared memory and stages each k/v tile beside it,
// converted to f32.  Per key tile: the [64, BK] score tile (each thread a
// 4-row by BK/16-key patch, a dot over d in order with explicit fmaf), the
// row max, exp and sum (four threads per row, combined in a fixed order),
// then acc = acc * corr + p v into registers (4 rows by D/16 dims a thread).
// Every sum runs in an order fixed by the tile sizes, so a head gives the
// same bits alone or in a batch, and every run the same bits.  A key tile
// masked for every row of the block is skipped when every row of the block
// sees some key: for such a row the tile adds p = 0 and multiplies by
// corr = 1.  Otherwise (a row with no visible key) every tile is taken.
// The CUDA cores do the products in f32 (no TF32, no tensor cores): the
// TPU kernel's f32 math, not a bf16 product.
//
// Bound: operations.  4 * T * S * D per head (a multiply and an add per
// q k^T and per p v term), halved for causal; the bytes are q, k, v read
// once and o written once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstdint>

namespace repro {

constexpr int kFaRows = 64;       // query rows per block
constexpr int kFaThreads = 256;
constexpr float kFaNeg = -1e30f;  // the TPU kernel's masked score

__device__ __forceinline__ float fa_load(const float* p) { return *p; }
__device__ __forceinline__ float fa_load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void fa_store(float* p, float v) { *p = v; }
__device__ __forceinline__ void fa_store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <int DMAX, int BK>
constexpr size_t fa_smem_floats() {
  return (size_t)kFaRows * (DMAX + 1) + (size_t)BK * (DMAX + 1) + (size_t)BK * DMAX +
         (size_t)kFaRows * (BK + 1) + 2 * kFaRows;
}

template <typename E, int DMAX, int BK>
__global__ void __launch_bounds__(kFaThreads)
flash_attention_kernel(const E* __restrict__ q, const E* __restrict__ k,
                       const E* __restrict__ v, E* __restrict__ o, int T, int S, int D,
                       int group, int causal, int window, long long q_offset,
                       long long k_offset, float scale) {
  constexpr int DP = DMAX + 1;   // padded row of the q and k tiles
  constexpr int PP = BK + 1;     // padded row of the score tile
  constexpr int KPT = BK / 16;   // keys per thread in the score tile
  constexpr int DPT = DMAX / 16; // dims per thread in the output tile
  extern __shared__ float smem[];
  float* sQ = smem;                  // [kFaRows][DP]
  float* sK = sQ + kFaRows * DP;     // [BK][DP]
  float* sV = sK + BK * DP;          // [BK][DMAX]
  float* sP = sV + BK * DMAX;        // [kFaRows][PP]
  float* sCorr = sP + kFaRows * PP;  // [kFaRows]
  float* sL = sCorr + kFaRows;       // [kFaRows]

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kFaRows;
  const int rows = min(kFaRows, T - q0);
  const E* qh = q + ((long long)bh * T + q0) * D;
  const E* kh = k + (long long)(bh / group) * S * D;
  const E* vh = v + (long long)(bh / group) * S * D;

  for (int e = tid; e < kFaRows * D; e += kFaThreads) {
    const int r = e / D, d = e % D;
    sQ[r * DP + d] = r < rows ? __fmul_rn(fa_load(qh + (long long)r * D + d), scale) : 0.f;
  }

  // Tiles masked for the whole block may be skipped only if every row of
  // the block sees some key in [k_offset, k_offset + S).
  int sees = 1;
  if (tid < rows) {
    const long long qp = q_offset + q0 + tid;
    long long lo = k_offset, hi = k_offset + S - 1;
    if (causal) hi = min(hi, qp);
    if (window) lo = max(lo, qp - window + 1);
    sees = lo <= hi;
  }
  const bool may_skip = __syncthreads_and(sees) && window >= 0;
  const long long qa = q_offset + q0, qb = qa + rows - 1;

  const int rg = tid >> 4, lane16 = tid & 15;  // score and output tiles
  const int srow = tid >> 2, sub = tid & 3;    // softmax: four threads a row
  float m_run = -CUDART_INF_F, l_run = 0.f;    // of row srow
  float acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < S; k0 += BK) {
    const int keys = min(BK, S - k0);
    if (may_skip) {
      const long long ka = k_offset + k0, kb = ka + keys - 1;
      // some (row, key) pair of the tile is visible
      const bool any = (!causal || ka <= qb) && (!window || kb > qa - window);
      if (!any) continue;
    }
    __syncthreads();  // the previous tile's p v is done with sK, sV and sP
    for (int e = tid; e < BK * D; e += kFaThreads) {
      const int j = e / D, d = e % D;
      const long long at = (long long)(k0 + j) * D + d;
      sK[j * DP + d] = j < keys ? fa_load(kh + at) : 0.f;
      sV[j * DMAX + d] = j < keys ? fa_load(vh + at) : 0.f;
    }
    __syncthreads();

    float s[4][KPT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[KPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(rg + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < KPT; ++j) kv[j] = sK[(lane16 + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j) s[i][j] = __fmaf_rn(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg + 16 * i;
      const long long qp = q_offset + q0 + r;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int c = lane16 + 16 * j;
        const long long kp = k_offset + k0 + c;
        const bool visible = (!causal || kp <= qp) && (!window || kp > qp - window);
        // a key past S is no key at all: exp(-inf - m) adds nothing
        sP[r * PP + c] = c >= keys ? -CUDART_INF_F : (visible ? s[i][j] : kFaNeg);
      }
    }
    __syncthreads();

    {
      float* row = sP + srow * PP;
      float mx = -CUDART_INF_F;
      for (int c = sub; c < BK; c += 4) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xFFFFFFFFu, mx, 2));
      const float m_new = fmaxf(m_run, mx);
      float sum = 0.f;
      for (int c = sub; c < BK; c += 4) {
        const float p = expf(__fsub_rn(row[c], m_new));
        row[c] = p;
        sum = __fadd_rn(sum, p);
      }
      // (s0 + s1) + (s2 + s3) on all four lanes: additions commute exactly
      sum = __fadd_rn(sum, __shfl_xor_sync(0xFFFFFFFFu, sum, 1));
      sum = __fadd_rn(sum, __shfl_xor_sync(0xFFFFFFFFu, sum, 2));
      const float corr = expf(__fsub_rn(m_run, m_new));
      l_run = __fadd_rn(__fmul_rn(l_run, corr), sum);
      m_run = m_new;
      if (sub == 0) sCorr[srow] = corr;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = sCorr[rg + 16 * i];
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] = __fmul_rn(acc[i][j], corr);
    }
    for (int c = 0; c < keys; ++c) {
      float pv[4], vv[DPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(rg + 16 * i) * PP + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) vv[j] = sV[c * DMAX + lane16 + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = __fmaf_rn(pv[i], vv[j], acc[i][j]);
    }
  }

  if (sub == 0) sL[srow] = l_run;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg + 16 * i;
    if (r >= rows) continue;
    const float den = fmaxf(sL[r], 1e-30f);
    E* orow = o + ((long long)bh * T + q0 + r) * D;
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = lane16 + 16 * j;
      if (d < D) fa_store(orow + d, __fdiv_rn(acc[i][j], den));
    }
  }
}

template <typename E, int DMAX, int BK>
cudaError_t launch_flash_tile(const void* q, const void* k, const void* v, void* o,
                              int BH, int T, int S, int D, int group, int causal,
                              int window, long long q_offset, long long k_offset,
                              float scale, cudaStream_t stream) {
  const size_t smem = fa_smem_floats<DMAX, BK>() * sizeof(float);
  auto kernel = flash_attention_kernel<E, DMAX, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((T + kFaRows - 1) / kFaRows), (unsigned)BH);
  kernel<<<grid, kFaThreads, smem, stream>>>(
      (const E*)q, (const E*)k, (const E*)v, (E*)o, T, S, D, group, causal, window,
      q_offset, k_offset, scale);
  return cudaGetLastError();
}

template <typename E>
cudaError_t launch_flash_typed(const void* q, const void* k, const void* v, void* o,
                               int BH, int T, int S, int D, int group, int causal,
                               int window, long long q_offset, long long k_offset,
                               float scale, cudaStream_t stream) {
  // the smallest head-dim tile that holds D; wide heads take narrower key
  // tiles so that a block's shared memory stays at 67-141 KB
  if (D <= 32)
    return launch_flash_tile<E, 32, 64>(q, k, v, o, BH, T, S, D, group, causal, window,
                                        q_offset, k_offset, scale, stream);
  if (D <= 64)
    return launch_flash_tile<E, 64, 64>(q, k, v, o, BH, T, S, D, group, causal, window,
                                        q_offset, k_offset, scale, stream);
  if (D <= 128)
    return launch_flash_tile<E, 128, 32>(q, k, v, o, BH, T, S, D, group, causal, window,
                                         q_offset, k_offset, scale, stream);
  return launch_flash_tile<E, 256, 32>(q, k, v, o, BH, T, S, D, group, causal, window,
                                       q_offset, k_offset, scale, stream);
}

cudaError_t launch_flash_attention(const void* q, const void* k, const void* v, void* o,
                                   int bf16, int BH, int T, int S, int D, int group,
                                   int causal, int window, long long q_offset,
                                   long long k_offset, float scale, cudaStream_t stream) {
  if (BH < 1 || BH > 65535 || T < 1 || S < 1 || D < 1 || D > 256 || group < 1 ||
      BH % group != 0)
    return cudaErrorInvalidValue;
  if (bf16)
    return launch_flash_typed<__nv_bfloat16>(q, k, v, o, BH, T, S, D, group, causal,
                                             window, q_offset, k_offset, scale, stream);
  return launch_flash_typed<float>(q, k, v, o, BH, T, S, D, group, causal, window,
                                   q_offset, k_offset, scale, stream);
}

}  // namespace repro

// Fused multi-field linear-sketch dots over packed corpus tables, for Hopper.
//
// Replaces the TPU kernel repro/kernels/estimate.py::_linear_fields_packed_kernel
// (launcher linear_estimate_fields_packed_pallas): linear_estimate_fields.cu
// with the corpus tables arriving as bf16-halfword words wc [C, P, R, We / 2]
// i32 (We = W rounded up to even; the query tables tq [F, Q, R, We] carry a
// zero column there).  The thread map, the tiles and the in-order sum over
// w are linear_estimate_fields.cu's; the corpus words are decoded as the
// tile is staged (16 words per row and step), so each (q, p) sum still adds
// an f32 product per w in order, no FMA and no TF32.  The pad column adds
// 0 * 0 = +0, which leaves every sum's bits as they were: a sum that starts
// at +0 never becomes -0 in round-to-nearest (x + -x and +0 + -0 are +0).
//
// Bound: bytes.  The corpus reads 2 B per cell instead of 4.
#include <cuda_runtime.h>
#include <cstdint>

#include "packed.cuh"

namespace repro {
namespace {

constexpr int kMaxPairs = 16;
constexpr int kRows = 128;   // corpus rows per block (one per thread)
constexpr int kTile = 32;    // w staged per step (16 words)
constexpr int kQTile = 16;   // query rows per block

struct PairMap {
  int q[kMaxPairs];
  int c[kMaxPairs];
};

__global__ void __launch_bounds__(kRows)
linear_estimate_fields_packed_kernel(const float* __restrict__ tq,
                                     const int* __restrict__ wc, long long wc_fs,
                                     long long wc_ps, PairMap maps, int Q, int P, int R,
                                     int W, float* __restrict__ out) {
  __shared__ float s_c[kRows][kTile + 1];
  __shared__ __align__(16) float s_q[kTile][kQTile];

  const int gr = blockIdx.z;  // g * R + r
  const int g = gr / R;
  const int r = gr % R;
  const int q0 = blockIdx.y * kQTile;
  const int p0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int Ww = W / 2;
  const int* wcf = wc + (long long)maps.c[g] * wc_fs + (long long)r * Ww;
  const float* tqf = tq + ((long long)maps.q[g] * Q * R + r) * W;
  const long long tq_qs = (long long)R * W;

  float acc[kQTile];
#pragma unroll
  for (int j = 0; j < kQTile; ++j) acc[j] = 0.f;

  for (int w0 = 0; w0 < W; w0 += kTile) {
    const int wn = min(kTile, W - w0);   // even: W and w0 are
    __syncthreads();
    // corpus tile: 16 words per row, each decoded into two columns
    for (int i = tid; i < kRows * kTile / 2; i += kRows) {
      const int row = i / (kTile / 2), k = i % (kTile / 2);
      const int p = p0 + row;
      const int word = (p < P && 2 * k < wn) ? wcf[(long long)p * wc_ps + w0 / 2 + k] : 0;
      s_c[row][2 * k] = unpack_even(word);
      s_c[row][2 * k + 1] = unpack_odd(word);
    }
    for (int i = tid; i < kQTile * kTile; i += kRows) {
      const int j = i / kTile, tt = i % kTile;
      const int q = q0 + j;
      s_q[tt][j] = (q < Q && tt < wn) ? tqf[(long long)q * tq_qs + w0 + tt] : 0.f;
    }
    __syncthreads();
    for (int tt = 0; tt < wn; ++tt) {
      const float c = s_c[tid][tt];
#pragma unroll
      for (int j = 0; j < kQTile; ++j) {
        acc[j] = __fadd_rn(acc[j], __fmul_rn(s_q[tt][j], c));
      }
    }
  }

  const int p = p0 + tid;
  if (p >= P) return;
#pragma unroll
  for (int j = 0; j < kQTile; ++j) {
    const int q = q0 + j;
    if (q < Q) out[((long long)gr * Q + q) * P + p] = acc[j];
  }
}

}  // namespace

cudaError_t launch_linear_estimate_fields_packed(const float* tq, const int* wc,
                                                 long long wc_fs, long long wc_ps,
                                                 const int* qmap, const int* cmap,
                                                 int G, int Q, int P, int R, int W,
                                                 float* out, cudaStream_t stream) {
  if (G < 1 || G > kMaxPairs || Q < 1 || P < 1 || R < 1 || W < 2 || W % 2)
    return cudaErrorInvalidValue;
  PairMap maps;
  for (int g = 0; g < kMaxPairs; ++g) {
    maps.q[g] = g < G ? qmap[g] : 0;
    maps.c[g] = g < G ? cmap[g] : 0;
  }
  const long long gr = (long long)G * R;
  const dim3 grid((P + kRows - 1) / kRows, (Q + kQTile - 1) / kQTile, (unsigned)gr);
  if (grid.y > 65535 || gr > 65535) return cudaErrorInvalidValue;
  linear_estimate_fields_packed_kernel<<<grid, kRows, 0, stream>>>(
      tq, wc, wc_fs, wc_ps, maps, Q, P, R, W, out);
  return cudaGetLastError();
}

}  // namespace repro

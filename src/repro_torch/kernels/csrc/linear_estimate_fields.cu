// Fused multi-field linear-sketch dots (CountSketch, JL) for Hopper.
//
// Replaces the TPU kernel repro/kernels/estimate.py::_linear_fields_kernel
// (launcher linear_estimate_fields_pallas).  For each field pair g =
// (qmap[g], cmap[g]), rep r and (q, p):
//   out[g, r, q, p] = sum_w tq[qmap[g], q, r, w] * tc[cmap[g], p, r, w]
// tq [F, Q, R, W] contiguous; tc [C, P, R, W] with any field and row stride
// and each row's [R, W] table contiguous (a tenant slice of the store's
// [3, cap, R, W] buffer needs no copy).  out [G, R, Q, P].
//
// The TPU kernel runs [BQ, BW] @ [BW, BP] MXU tiles.  Here (g, r) fold into
// grid z as the TPU grid folds them; a block of 128 threads owns 128 corpus
// rows and a tile of 16 queries.  Per step it stages a [128 x 32] corpus
// tile in shared memory with coalesced reads (a row is 765 or 769 floats,
// so rows are not 16-B aligned and no vector loads are used; rows padded to
// 33 words keep the per-thread reads conflict-free) and the [32 x 16] query
// tile w-major, so a thread reads the 16 query values of one w by
// broadcast.  Each thread then walks its row's w in order: per (q, p) an
// f32 product and an f32 add per w (-fmad=false: no fused multiply-add, and
// no tensor cores, so no TF32), whatever Q, P or the tiling -- batched and
// sequential queries, and the plain version, give the same bits.
//
// Bound: bytes (each corpus table read once per field pair and query tile).
#include <cuda_runtime.h>
#include <cstdint>

namespace repro {
namespace {

constexpr int kMaxPairs = 16;
constexpr int kRows = 128;   // corpus rows per block (one per thread)
constexpr int kTile = 32;    // w staged per step
constexpr int kQTile = 16;   // query rows per block

struct PairMap {
  int q[kMaxPairs];
  int c[kMaxPairs];
};

__global__ void __launch_bounds__(kRows)
linear_estimate_fields_kernel(const float* __restrict__ tq, const float* __restrict__ tc,
                              long long tc_fs, long long tc_ps, PairMap maps, int Q,
                              int P, int R, int W, float* __restrict__ out) {
  __shared__ float s_c[kRows][kTile + 1];
  __shared__ __align__(16) float s_q[kTile][kQTile];

  const int gr = blockIdx.z;  // g * R + r
  const int g = gr / R;
  const int r = gr % R;
  const int q0 = blockIdx.y * kQTile;
  const int p0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const float* tcf = tc + (long long)maps.c[g] * tc_fs + (long long)r * W;
  const float* tqf = tq + ((long long)maps.q[g] * Q * R + r) * W;
  const long long tq_qs = (long long)R * W;

  float acc[kQTile];
#pragma unroll
  for (int j = 0; j < kQTile; ++j) acc[j] = 0.f;

  for (int w0 = 0; w0 < W; w0 += kTile) {
    const int wc = min(kTile, W - w0);
    __syncthreads();
    // corpus tile: warp k reads rows 4k..4k+3, 32 consecutive floats each
    for (int i = tid; i < kRows * kTile; i += kRows) {
      const int row = i / kTile, tt = i % kTile;
      const int p = p0 + row;
      s_c[row][tt] = (p < P && tt < wc) ? tcf[(long long)p * tc_ps + w0 + tt] : 0.f;
    }
    for (int i = tid; i < kQTile * kTile; i += kRows) {
      const int j = i / kTile, tt = i % kTile;
      const int q = q0 + j;
      s_q[tt][j] = (q < Q && tt < wc) ? tqf[(long long)q * tq_qs + w0 + tt] : 0.f;
    }
    __syncthreads();
    for (int tt = 0; tt < wc; ++tt) {
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

cudaError_t launch_linear_estimate_fields(const float* tq, const float* tc,
                                          long long tc_fs, long long tc_ps,
                                          const int* qmap, const int* cmap, int G,
                                          int Q, int P, int R, int W, float* out,
                                          cudaStream_t stream) {
  if (G < 1 || G > kMaxPairs || Q < 1 || P < 1 || R < 1 || W < 1)
    return cudaErrorInvalidValue;
  PairMap maps;
  for (int g = 0; g < kMaxPairs; ++g) {
    maps.q[g] = g < G ? qmap[g] : 0;
    maps.c[g] = g < G ? cmap[g] : 0;
  }
  const long long gr = (long long)G * R;
  const dim3 grid((P + kRows - 1) / kRows, (Q + kQTile - 1) / kQTile, (unsigned)gr);
  if (grid.y > 65535 || gr > 65535) return cudaErrorInvalidValue;
  linear_estimate_fields_kernel<<<grid, kRows, 0, stream>>>(tq, tc, tc_fs, tc_ps, maps, Q,
                                                            P, R, W, out);
  return cudaGetLastError();
}

}  // namespace repro

// Fused multi-field ICWS estimate partials over a packed corpus, for Hopper.
//
// Replaces the TPU kernel repro/kernels/estimate.py::_fields_packed_kernel
// (launcher estimate_fields_packed_pallas): estimate_fields.cu with the
// corpus values arriving as bf16-halfword words wc [C, P, me / 2] i32 (me =
// m rounded up to even) in place of vc [C, P, me] f32.  The thread map, the
// tiles and the in-order sum over t are estimate_fields.cu's; the block
// stages the tile's packed words (16 per row, rows padded to 17 words so
// the per-thread reads are conflict-free) and decodes each value where the
// unpacked kernel loads its f32.  The decode is exact, so on (fc, wc) this
// kernel gives the unpacked kernel's bits on (fc, unpack(wc)); the f32 value
// plane never exists in device memory.
//
// Bound: bytes.  The corpus reads 6 B per slot instead of 8.
#include <cuda_runtime.h>
#include <cstdint>

#include "packed.cuh"

namespace repro {
namespace {

constexpr int kMaxPairs = 16;
constexpr int kRows = 128;   // corpus rows per block (one per thread)
constexpr int kTile = 32;    // samples staged per step (16 words)
constexpr int kQTile = 16;   // query rows per block

struct FieldMap {
  int q[kMaxPairs];
  int c[kMaxPairs];
};

__global__ void __launch_bounds__(kRows)
estimate_fields_packed_kernel(const int* __restrict__ fq, const float* __restrict__ vq,
                              const int* __restrict__ fc, const int* __restrict__ wc,
                              long long fc_fs, long long fc_rs, long long wc_fs,
                              long long wc_rs, FieldMap maps, int Q, int P, int m,
                              float* __restrict__ cnt, float* __restrict__ sw) {
  __shared__ int s_fc[kRows][kTile + 1];
  __shared__ int s_wc[kRows][kTile / 2 + 1];
  __shared__ int s_fq[kQTile][kTile];
  __shared__ float s_vq[kQTile][kTile];

  const int g = blockIdx.z;
  const int q0 = blockIdx.y * kQTile;
  const int p0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int* fcf = fc + (long long)maps.c[g] * fc_fs;
  const int* wcf = wc + (long long)maps.c[g] * wc_fs;
  const int* fqf = fq + (long long)maps.q[g] * Q * m;
  const float* vqf = vq + (long long)maps.q[g] * Q * m;

  float acc_n[kQTile];
  float acc_w[kQTile];
#pragma unroll
  for (int j = 0; j < kQTile; ++j) {
    acc_n[j] = 0.f;
    acc_w[j] = 0.f;
  }

  for (int t0 = 0; t0 < m; t0 += kTile) {
    const int tc = min(kTile, m - t0);   // even: m and t0 are
    __syncthreads();
    for (int i = tid; i < kRows * kTile; i += kRows) {
      const int r = i / kTile, tt = i % kTile;
      const int p = p0 + r;
      s_fc[r][tt] = p < P && tt < tc ? fcf[(long long)p * fc_rs + t0 + tt] : -2;
    }
    for (int i = tid; i < kRows * kTile / 2; i += kRows) {
      const int r = i / (kTile / 2), k = i % (kTile / 2);
      const int p = p0 + r;
      s_wc[r][k] = p < P && 2 * k < tc ? wcf[(long long)p * wc_rs + t0 / 2 + k] : 0;
    }
    for (int i = tid; i < kQTile * kTile; i += kRows) {
      const int j = i / kTile, tt = i % kTile;
      const int q = q0 + j;
      const bool ok = q < Q && tt < tc;
      s_fq[j][tt] = ok ? fqf[(long long)q * m + t0 + tt] : -1;
      s_vq[j][tt] = ok ? vqf[(long long)q * m + t0 + tt] : 0.f;
    }
    __syncthreads();
    for (int tt = 0; tt < tc; ++tt) {
      const int f = s_fc[tid][tt];
      const int word = s_wc[tid][tt >> 1];
      const float v = (tt & 1) ? unpack_odd(word) : unpack_even(word);
#pragma unroll
      for (int j = 0; j < kQTile; ++j) {
        const int a = s_fq[j][tt];
        if (a == f && a >= 0) {
          const float x = s_vq[j][tt];
          const float qq = fminf(__fmul_rn(x, x), __fmul_rn(v, v));
          const float safe = qq > 0.f ? qq : 1.f;
          acc_n[j] = __fadd_rn(acc_n[j], 1.f);
          acc_w[j] = __fadd_rn(acc_w[j], __fdiv_rn(__fmul_rn(x, v), safe));
        }
      }
    }
  }

  const int p = p0 + tid;
  if (p >= P) return;
#pragma unroll
  for (int j = 0; j < kQTile; ++j) {
    const int q = q0 + j;
    if (q < Q) {
      const long long o = ((long long)g * Q + q) * P + p;
      cnt[o] = acc_n[j];
      sw[o] = acc_w[j];
    }
  }
}

}  // namespace

cudaError_t launch_estimate_fields_packed(const int* fq, const float* vq, const int* fc,
                                          const int* wc, long long fc_fs,
                                          long long fc_rs, long long wc_fs,
                                          long long wc_rs, const int* qmap,
                                          const int* cmap, int G, int Q, int P, int m,
                                          float* cnt, float* sw, cudaStream_t stream) {
  if (G < 1 || G > kMaxPairs || Q < 1 || P < 1 || m < 2 || m % 2)
    return cudaErrorInvalidValue;
  FieldMap maps;
  for (int g = 0; g < kMaxPairs; ++g) {
    maps.q[g] = g < G ? qmap[g] : 0;
    maps.c[g] = g < G ? cmap[g] : 0;
  }
  const dim3 grid((P + kRows - 1) / kRows, (Q + kQTile - 1) / kQTile, G);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  estimate_fields_packed_kernel<<<grid, kRows, 0, stream>>>(
      fq, vq, fc, wc, fc_fs, fc_rs, wc_fs, wc_rs, maps, Q, P, m, cnt, sw);
  return cudaGetLastError();
}

}  // namespace repro

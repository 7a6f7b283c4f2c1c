// Fused multi-field ICWS estimate partials for Hopper.
//
// Replaces the TPU kernel repro/kernels/estimate.py::_fields_kernel
// (launcher estimate_fields_pallas).  For each field pair g = (qmap[g],
// cmap[g]) and each (q, p):
//   cnt[g, q, p] = sum_t 1[fq == fc and fq >= 0]
//   sw[g, q, p]  = sum_t 1[...] * vq * vc / min(vq^2, vc^2)   (safe denominator)
// fq/vq [F, Q, m] contiguous; fc/vc [C, P, m] with any field and row stride
// (a tenant slice of the store's [3, cap, m] buffers needs no copy).
//
// Bound: bytes.  Every corpus fingerprint and value is read once per
// (field pair, query tile), compared against QT query rows held in shared
// memory, and dropped.  A block of 128 threads owns 128 corpus rows: it
// stages a [128 x 32] tile of fc/vc into shared memory with coalesced
// 128-byte row reads (rows padded to 33 words, so the per-thread row reads
// are conflict-free), then each thread walks its row's 32 samples against
// the QT query rows.  Each (q, p) sum runs over t = 0 .. m-1 in order in
// one thread, whatever Q, P or the tiling: that fixed order is what makes
// batched and sequential queries bitwise equal.  No atomics, and no
// [Q, P, m] tensor anywhere; the field pair is read through qmap/cmap.
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace repro {

constexpr int kMaxPairs = 16;
constexpr int kRows = 128;   // corpus rows per block (one per thread)
constexpr int kTile = 32;    // samples staged per step
constexpr int kQTile = 16;   // query rows per block

struct FieldMap {
  int q[kMaxPairs];
  int c[kMaxPairs];
};

__global__ void __launch_bounds__(kRows)
estimate_fields_kernel(const int* __restrict__ fq, const float* __restrict__ vq,
                       const int* __restrict__ fc, const float* __restrict__ vc,
                       long long fc_fs, long long fc_rs, long long vc_fs,
                       long long vc_rs, FieldMap maps, int Q, int P, int m,
                       float* __restrict__ cnt, float* __restrict__ sw) {
  __shared__ int s_fc[kRows][kTile + 1];
  __shared__ float s_vc[kRows][kTile + 1];
  __shared__ int s_fq[kQTile][kTile];
  __shared__ float s_vq[kQTile][kTile];

  const int g = blockIdx.z;
  const int q0 = blockIdx.y * kQTile;
  const int p0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int qf = maps.q[g];
  const int cf = maps.c[g];
  const int* fcf = fc + (long long)cf * fc_fs;
  const float* vcf = vc + (long long)cf * vc_fs;
  const int* fqf = fq + (long long)qf * Q * m;
  const float* vqf = vq + (long long)qf * Q * m;

  float acc_n[kQTile];
  float acc_w[kQTile];
#pragma unroll
  for (int j = 0; j < kQTile; ++j) {
    acc_n[j] = 0.f;
    acc_w[j] = 0.f;
  }

  for (int t0 = 0; t0 < m; t0 += kTile) {
    const int tc = min(kTile, m - t0);
    __syncthreads();
    // corpus tile: warp k reads rows 4k..4k+3, 32 samples (128 B) each
    for (int i = tid; i < kRows * kTile; i += kRows) {
      const int r = i / kTile, tt = i % kTile;
      const int p = p0 + r;
      const bool ok = p < P && tt < tc;
      s_fc[r][tt] = ok ? fcf[(long long)p * fc_rs + t0 + tt] : -2;
      s_vc[r][tt] = ok ? vcf[(long long)p * vc_rs + t0 + tt] : 0.f;
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
      const float v = s_vc[tid][tt];
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

cudaError_t launch_estimate_fields(const int* fq, const float* vq, const int* fc,
                                   const float* vc, long long fc_fs, long long fc_rs,
                                   long long vc_fs, long long vc_rs, const int* qmap,
                                   const int* cmap, int G, int Q, int P, int m,
                                   float* cnt, float* sw, cudaStream_t stream) {
  if (G < 1 || G > kMaxPairs || Q < 1 || P < 1 || m < 1) return cudaErrorInvalidValue;
  FieldMap maps;
  for (int g = 0; g < kMaxPairs; ++g) {
    maps.q[g] = g < G ? qmap[g] : 0;
    maps.c[g] = g < G ? cmap[g] : 0;
  }
  const dim3 grid((P + kRows - 1) / kRows, (Q + kQTile - 1) / kQTile, G);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  estimate_fields_kernel<<<grid, kRows, 0, stream>>>(
      fq, vq, fc, vc, fc_fs, fc_rs, vc_fs, vc_rs, maps, Q, P, m, cnt, sw);
  return cudaGetLastError();
}

}  // namespace repro

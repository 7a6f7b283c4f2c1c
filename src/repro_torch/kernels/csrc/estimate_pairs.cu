// ICWS collision partials of sketch pairs, for Hopper (B3).
//
// Replaces the TPU kernel repro/kernels/estimate.py::_est_kernel, both of its
// launchers: estimate_partials_pallas (pairwise: row p of A against row p of
// B) and estimate_one_vs_many_pallas (one query against every corpus row,
// the query broadcast by the index map lambda p, mi: (0, mi)).  One kernel
// serves both: side A is read through a row stride, which is the row pitch
// for the pairwise route and 0 for the one-vs-many route.  For each row p:
//   cnt[p] = sum_t 1[fa[p, t] == fb[p, t] and fa[p, t] >= 0]
//   sw[p]  = sum_t 1[...] * va * vb / min(va^2, vb^2)   (safe denominator)
// with the guard on side A (the query side) only, as in the TPU kernel.  Both
// sides may be strided views whose last dimension is contiguous (field 0 of
// the corpus store's [1, cap, m] buffers needs no copy).
//
// Bound: bytes.  Each sample of B (and of A, pairwise) is read once.  A block
// of 64 threads owns 64 rows, one thread per row, so each sum runs over
// t = 0 .. m-1 in order in one thread, the order of the plain version and of
// the many-vs-many kernels: a row of B4, the one-vs-many route and the
// pairwise route on the tiled query give the same bits.  Per step the block
// stages coalesced [64 x 32] tiles of B's fingerprints and values (and of
// A's, pairwise; rows padded to 33 words so the per-thread row reads are
// conflict-free): four int/float tiles take 33.8 KB, inside the 48 KB of
// static shared memory.  With stride 0 the block stages the query's 32
// samples once, and every thread reads them by broadcast.
#include <cuda_runtime.h>
#include <cstdint>

namespace repro {
namespace {

constexpr int kRows = 64;   // rows per block (one per thread)
constexpr int kTile = 32;   // samples staged per step

__global__ void __launch_bounds__(kRows)
estimate_pairs_kernel(const int* __restrict__ fa, const float* __restrict__ va,
                      const int* __restrict__ fb, const float* __restrict__ vb,
                      long long fa_rs, long long va_rs, long long fb_rs,
                      long long vb_rs, int P, int m, float* __restrict__ cnt,
                      float* __restrict__ sw) {
  __shared__ int s_fa[kRows][kTile + 1];
  __shared__ float s_va[kRows][kTile + 1];
  __shared__ int s_fb[kRows][kTile + 1];
  __shared__ float s_vb[kRows][kTile + 1];

  const int p0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  // one-vs-many: A is one row, staged once and read by every thread
  const bool broadcast = fa_rs == 0 && va_rs == 0;
  const int a_rows = broadcast ? 1 : kRows;
  const int ra = broadcast ? 0 : tid;

  float acc_n = 0.f;
  float acc_w = 0.f;
  for (int t0 = 0; t0 < m; t0 += kTile) {
    const int tc = min(kTile, m - t0);
    __syncthreads();
    // warp k reads rows 2k, 2k+1: 32 samples (128 B) each
    for (int i = tid; i < kRows * kTile; i += kRows) {
      const int r = i / kTile, tt = i % kTile;
      const int p = p0 + r;
      const bool ok = p < P && tt < tc;
      s_fb[r][tt] = ok ? fb[(long long)p * fb_rs + t0 + tt] : -2;
      s_vb[r][tt] = ok ? vb[(long long)p * vb_rs + t0 + tt] : 0.f;
    }
    for (int i = tid; i < a_rows * kTile; i += kRows) {
      const int r = i / kTile, tt = i % kTile;
      const int p = p0 + r;
      const bool ok = (broadcast || p < P) && tt < tc;
      s_fa[r][tt] = ok ? fa[(long long)p * fa_rs + t0 + tt] : -1;
      s_va[r][tt] = ok ? va[(long long)p * va_rs + t0 + tt] : 0.f;
    }
    __syncthreads();
    for (int tt = 0; tt < tc; ++tt) {
      const int a = s_fa[ra][tt];
      if (a == s_fb[tid][tt] && a >= 0) {
        const float x = s_va[ra][tt];
        const float v = s_vb[tid][tt];
        const float qq = fminf(__fmul_rn(x, x), __fmul_rn(v, v));
        const float safe = qq > 0.f ? qq : 1.f;
        acc_n = __fadd_rn(acc_n, 1.f);
        acc_w = __fadd_rn(acc_w, __fdiv_rn(__fmul_rn(x, v), safe));
      }
    }
  }
  const int p = p0 + tid;
  if (p < P) {
    cnt[p] = acc_n;
    sw[p] = acc_w;
  }
}

}  // namespace

cudaError_t launch_estimate_pairs(const int* fa, const float* va, const int* fb,
                                  const float* vb, long long fa_rs, long long va_rs,
                                  long long fb_rs, long long vb_rs, int P, int m,
                                  float* cnt, float* sw, cudaStream_t stream) {
  if (P < 1 || m < 1) return cudaErrorInvalidValue;
  const dim3 grid((P + kRows - 1) / kRows);
  estimate_pairs_kernel<<<grid, kRows, 0, stream>>>(fa, va, fb, vb, fa_rs, va_rs, fb_rs,
                                                    vb_rs, P, m, cnt, sw);
  return cudaGetLastError();
}

}  // namespace repro

// ICWS collision partials of many queries against a corpus, for Hopper:
// three kernels.
//
//   estimate_fields_kernel         B2, repro/kernels/estimate.py::_fields_kernel
//                                  (launcher estimate_fields_pallas)
//   estimate_fields_packed_kernel  B11, ::_fields_packed_kernel
//                                  (launcher estimate_fields_packed_pallas)
//   estimate_many_kernel           B4, ::_mvm_kernel
//                                  (launcher estimate_many_vs_many_pallas)
//
// For each field pair g = (qmap[g], cmap[g]) and each (q, p):
//   cnt[g, q, p] = sum_t 1[fq == fc and fq >= 0]
//   sw[g, q, p]  = sum_t 1[...] * vq * vc / min(vq^2, vc^2)   (safe denominator)
// fq/vq [F, Q, m] contiguous; fc [C, P, m] and the values with any field and
// row stride (a tenant slice of the store's [3, cap, m] buffers, or field 0
// of a [1, cap, m] buffer, needs no copy).  Each (q, p) sum runs over t = 0 ..
// m-1 in order in one thread, one f32 add a collision, whatever Q, P, the
// tiling or the kernel: that fixed order is what makes batched and
// sequential queries bitwise equal, and B2, B3, B4 and B11 equal where their
// functions meet.  No atomics, and no [Q, P, m] tensor anywhere.
//
// Bound: bytes.  B2 and B11 are fields_body (fields_body.cuh) over the
// launcher's PairGroups: a block owns 128 rows of one corpus field and
// every pair that reads it (up to 16 pairs at one query, 3 at 16), so each
// corpus plane is read once a launch at the service's map (three planes for
// six pairs); the query tile QT is 1 for a single query, else 16 with four
// threads a row; swizzled tiles come a tile ahead by cp.async.  B2 loads f32
// values (F32Values); B11 bf16-halfword words wc [C, P, m / 2] i32
// (PackedValues, m even), a [128 x 16]-word stage decoded where the compare
// loads it, so B11 on (fc, wc) gives B2's bits on (fc, unpack(wc)).  The
// packed stage is smaller (24 KB of corpus words against 32 KB), so one
// more B11 block fits an SM at one query (GroupShape).
//
// B4 (collision_tile): a block owns 128 rows of the one corpus plane and 16
// query rows, grid (P / 128, Q / 16), with synchronous padded tiles; its
// [Q, m] x [P, m] -> [Q, P] is B2's function at G = 1.
#include <cuda_runtime.h>
#include <cstdint>

#include "fields_body.cuh"

namespace repro {
namespace {

constexpr int kRows = 128;   // B4: corpus rows a block (one a thread)
constexpr int kTile = 32;    // B4: samples staged a step
constexpr int kQTile = 16;   // B4: query rows a block

// B2's and B11's shape at query tile QT: 16 pairs a group at QT = 1, where
// shared memory sets the blocks an SM (three of B2's 72 KB, four of B11's
// 56 KB), and 3 pairs at QT = 16 with registers capped for two blocks (B11
// at three, 40 registers, ran slower on the H100)
template <int QT>
using GroupShape = FieldsShape<QT, QT == 1 ? kMaxPairs : 3, QT == 1 ? 3 : 2>;

template <int QT, bool Vec16>
__global__ void
__launch_bounds__(GroupShape<QT>::kThreads, GroupShape<QT>::kBlocksPerSM)
estimate_fields_kernel(const int* __restrict__ fq, const float* __restrict__ vq,
                       const int* __restrict__ fc, const float* __restrict__ vc,
                       long long fc_fs, long long fc_rs, long long vc_fs,
                       long long vc_rs, const __grid_constant__ PairGroups plan,
                       int Q, int P, int m,
                       float* __restrict__ cnt, float* __restrict__ sw) {
  fields_body<GroupShape<QT>, Vec16, F32Values>(fq, vq, fc, vc, fc_fs, fc_rs, vc_fs, vc_rs,
                                             plan, Q, P, m, cnt, sw);
}

template <int QT, bool Vec16>
__global__ void
__launch_bounds__(GroupShape<QT>::kThreads, GroupShape<QT>::kBlocksPerSM)
estimate_fields_packed_kernel(const int* __restrict__ fq, const float* __restrict__ vq,
                              const int* __restrict__ fc, const int* __restrict__ wc,
                              long long fc_fs, long long fc_rs, long long wc_fs,
                              long long wc_rs, const __grid_constant__ PairGroups plan,
                              int Q, int P, int m,
                              float* __restrict__ cnt, float* __restrict__ sw) {
  fields_body<GroupShape<QT>, Vec16, PackedValues>(fq, vq, fc, wc, fc_fs, fc_rs, wc_fs,
                                                    wc_rs, plan, Q, P, m, cnt, sw);
}

// B4: the one query plane against the one corpus plane, f32 values
__device__ __forceinline__ void collision_tile(
    const int* __restrict__ fq, const float* __restrict__ vq,
    const int* __restrict__ fc, const float* __restrict__ vc, long long fc_rs,
    long long vc_rs, int Q, int P, int m, float* __restrict__ cnt,
    float* __restrict__ sw) {
  __shared__ int s_fc[kRows][kTile + 1];
  __shared__ float s_vc[kRows][kTile + 1];
  __shared__ int s_fq[kQTile][kTile];
  __shared__ float s_vq[kQTile][kTile];

  const int q0 = blockIdx.y * kQTile;
  const int p0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;

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
      s_fc[r][tt] = p < P && tt < tc ? fc[(long long)p * fc_rs + t0 + tt] : -2;
    }
    for (int i = tid; i < kRows * kTile; i += kRows) {
      const int r = i / kTile, tt = i % kTile;
      const int p = p0 + r;
      s_vc[r][tt] = p < P && tt < tc ? vc[(long long)p * vc_rs + t0 + tt] : 0.f;
    }
    for (int i = tid; i < kQTile * kTile; i += kRows) {
      const int j = i / kTile, tt = i % kTile;
      const int q = q0 + j;
      const bool ok = q < Q && tt < tc;
      s_fq[j][tt] = ok ? fq[(long long)q * m + t0 + tt] : -1;
      s_vq[j][tt] = ok ? vq[(long long)q * m + t0 + tt] : 0.f;
    }
    __syncthreads();
    for (int tt = 0; tt < tc; ++tt) {
      const int f = s_fc[tid][tt];
      const float v = s_vc[tid][tt];
#pragma unroll
      for (int j = 0; j < kQTile; ++j)
        collide(s_fq[j][tt], f, &s_vq[j][tt], v, acc_n[j], acc_w[j]);
    }
  }

  const int p = p0 + tid;
  if (p >= P) return;
#pragma unroll
  for (int j = 0; j < kQTile; ++j) {
    const int q = q0 + j;
    if (q < Q) {
      const long long o = (long long)q * P + p;
      cnt[o] = acc_n[j];
      sw[o] = acc_w[j];
    }
  }
}

__global__ void __launch_bounds__(kRows)
estimate_many_kernel(const int* __restrict__ fq, const float* __restrict__ vq,
                     const int* __restrict__ fc, const float* __restrict__ vc,
                     long long fc_rs, long long vc_rs, int Q, int P, int m,
                     float* __restrict__ cnt, float* __restrict__ sw) {
  collision_tile(fq, vq, fc, vc, fc_rs, vc_rs, Q, P, m, cnt, sw);
}

// the pairs grouped by corpus field: each field's pairs in g order, in
// chunks of at most `per`, heaviest chunk first (a stable sort, so ties
// keep field order)
bool make_groups(const int* qmap, const int* cmap, int G, int per, PairGroups* plan) {
  if (G < 1 || G > kMaxPairs) return false;
  bool taken[kMaxPairs] = {};
  int next = 0;
  plan->n = 0;
  for (int g0 = 0; g0 < G; ++g0) {
    if (taken[g0]) continue;
    for (int g = g0; g < G; ++g) {
      if (taken[g] || cmap[g] != cmap[g0]) continue;
      if (g == g0 || plan->count[plan->n - 1] == per) {
        plan->cf[plan->n] = cmap[g0];
        plan->first[plan->n] = next;
        plan->count[plan->n] = 0;
        ++plan->n;
      }
      plan->g[next] = g;
      plan->qf[next] = qmap[g];
      ++next;
      ++plan->count[plan->n - 1];
      taken[g] = true;
    }
  }
  for (int a = 1; a < plan->n; ++a)
    for (int b = a; b > 0 && plan->count[b] > plan->count[b - 1]; --b) {
      int* cols[3] = {plan->cf, plan->first, plan->count};
      for (int* col : cols) {
        const int x = col[b];
        col[b] = col[b - 1];
        col[b - 1] = x;
      }
    }
  return true;
}

// one launch of B2 (V = F32Values) or B11 (PackedValues) at query tile QT
template <int QT, bool Vec16, class V>
cudaError_t launch_fields_as(const int* fq, const float* vq, const int* fc,
                             const typename V::Word* vc, long long fc_fs,
                             long long fc_rs, long long vc_fs, long long vc_rs,
                             const PairGroups& plan, int Q, int P, int m, float* cnt,
                             float* sw, cudaStream_t stream) {
  using Shape = GroupShape<QT>;
  const auto kernel = [] {
    if constexpr (V::kPer != 1) return estimate_fields_packed_kernel<QT, Vec16>;
    else return estimate_fields_kernel<QT, Vec16>;
  }();
  constexpr int smem = fields_smem_bytes<Shape, V>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  kernel<<<fields_grid<Shape>(plan, Q, P), Shape::kThreads, smem, stream>>>(
      fq, vq, fc, vc, fc_fs, fc_rs, vc_fs, vc_rs, plan, Q, P, m, cnt, sw);
  return cudaGetLastError();
}

template <int QT, class V>
cudaError_t launch_fields(const int* fq, const float* vq, const int* fc,
                          const typename V::Word* vc, long long fc_fs, long long fc_rs,
                          long long vc_fs, long long vc_rs, const int* qmap,
                          const int* cmap, int G, int Q, int P, int m, float* cnt,
                          float* sw, cudaStream_t stream) {
  PairGroups plan;
  if (!make_groups(qmap, cmap, G, QT == 1 ? kMaxPairs : 3, &plan) || Q < 1 || P < 1 ||
      m < V::kPer || m % V::kPer || (Q + QT - 1) / QT > 65535)
    return cudaErrorInvalidValue;
  if (aligned16(fc, fc_fs, fc_rs, m) && aligned16(vc, vc_fs, vc_rs, m / V::kPer))
    return launch_fields_as<QT, true, V>(fq, vq, fc, vc, fc_fs, fc_rs, vc_fs, vc_rs,
                                         plan, Q, P, m, cnt, sw, stream);
  return launch_fields_as<QT, false, V>(fq, vq, fc, vc, fc_fs, fc_rs, vc_fs, vc_rs, plan,
                                        Q, P, m, cnt, sw, stream);
}

}  // namespace

cudaError_t launch_estimate_fields(const int* fq, const float* vq, const int* fc,
                                   const float* vc, long long fc_fs, long long fc_rs,
                                   long long vc_fs, long long vc_rs, const int* qmap,
                                   const int* cmap, int G, int Q, int P, int m,
                                   float* cnt, float* sw, cudaStream_t stream) {
  if (Q == 1)
    return launch_fields<1, F32Values>(fq, vq, fc, vc, fc_fs, fc_rs, vc_fs, vc_rs, qmap,
                                       cmap, G, Q, P, m, cnt, sw, stream);
  return launch_fields<16, F32Values>(fq, vq, fc, vc, fc_fs, fc_rs, vc_fs, vc_rs, qmap,
                                      cmap, G, Q, P, m, cnt, sw, stream);
}

cudaError_t launch_estimate_fields_packed(const int* fq, const float* vq, const int* fc,
                                          const int* wc, long long fc_fs,
                                          long long fc_rs, long long wc_fs,
                                          long long wc_rs, const int* qmap,
                                          const int* cmap, int G, int Q, int P, int m,
                                          float* cnt, float* sw, cudaStream_t stream) {
  if (Q == 1)
    return launch_fields<1, PackedValues>(fq, vq, fc, wc, fc_fs, fc_rs, wc_fs, wc_rs,
                                          qmap, cmap, G, Q, P, m, cnt, sw, stream);
  return launch_fields<16, PackedValues>(fq, vq, fc, wc, fc_fs, fc_rs, wc_fs, wc_rs, qmap,
                                         cmap, G, Q, P, m, cnt, sw, stream);
}

cudaError_t launch_estimate_many(const int* fq, const float* vq, const int* fc,
                                 const float* vc, long long fc_rs, long long vc_rs,
                                 int Q, int P, int m, float* cnt, float* sw,
                                 cudaStream_t stream) {
  const dim3 grid((P + kRows - 1) / kRows, (Q + kQTile - 1) / kQTile);
  if (Q < 1 || P < 1 || m < 1 || grid.y > 65535) return cudaErrorInvalidValue;
  estimate_many_kernel<<<grid, kRows, 0, stream>>>(fq, vq, fc, vc, fc_rs, vc_rs, Q,
                                                   P, m, cnt, sw);
  return cudaGetLastError();
}

}  // namespace repro

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
// Bound: bytes.  All three are fields_body (fields_body.cuh) over a
// PairGroups plan: a block owns 128 rows of one corpus field and every pair
// that reads it, so each corpus plane is read once a launch.  B2 and B11
// take the launcher's groups (up to 16 pairs at one query, 3 at 16; three
// planes for the service's six pairs); the query tile QT is 1 for a single
// query, else 16 with four threads a row; swizzled tiles come a tile ahead
// by cp.async.  B2 loads f32 values (F32Values); B11 bf16-halfword words wc
// [C, P, m / 2] i32 (PackedValues, m even), a [128 x 16]-word stage decoded
// where the compare loads it, so B11 on (fc, wc) gives B2's bits on (fc,
// unpack(wc)).  The packed stage is smaller (24 KB of corpus words against
// 32 KB), so one more B11 block fits an SM at one query (GroupShape).
//
// B4 is B2's function at G = 1 ([Q, m] x [P, m] -> [Q, P]): the body with a
// one-pair plan (query field 0 against corpus field 0, field strides 0),
// at one query in B3 one-vs-many's shape (QT = 1, three blocks an SM), else
// at QT = 16 with four threads a row (ManyShape); 16-byte copies where the
// corpus rows are 16-byte aligned, else 4-byte ones, so any row stride and
// any m work.  Its row q is B3 one-vs-many on query q, bit for bit.
#include <cuda_runtime.h>
#include <cstdint>

#include "fields_body.cuh"

namespace repro {
namespace {

// B2's and B11's shape at query tile QT: 16 pairs a group at QT = 1, where
// shared memory sets the blocks an SM (three of B2's 72 KB, four of B11's
// 56 KB), and 3 pairs at QT = 16 with registers capped for two blocks (B11
// at three, 40 registers, ran slower on the H100)
template <int QT>
using GroupShape = FieldsShape<QT, QT == 1 ? kMaxPairs : 3, QT == 1 ? 3 : 2>;

// B4's shape: one pair, at one query B3 one-vs-many's (three blocks an
// SM), else QT = 16, four threads a row, kManyBlocks blocks an SM (three,
// 40 registers with a few spilled, ran 8% faster than two on the H100)
constexpr int kManyBlocks = 3;
template <int QT>
using ManyShape = FieldsShape<QT, 1, QT == 1 ? 3 : kManyBlocks>;

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

// B4: the one query plane against the one corpus plane, f32 values, one
// pair; at one query B3 one-vs-many's shape
template <int QT, bool Vec16>
__global__ void
__launch_bounds__(ManyShape<QT>::kThreads, ManyShape<QT>::kBlocksPerSM)
estimate_many_kernel(const int* __restrict__ fq, const float* __restrict__ vq,
                     const int* __restrict__ fc, const float* __restrict__ vc,
                     long long fc_rs, long long vc_rs,
                     const __grid_constant__ PairGroups plan, int Q, int P, int m,
                     float* __restrict__ cnt, float* __restrict__ sw) {
  fields_body<ManyShape<QT>, Vec16, F32Values>(fq, vq, fc, vc, 0, fc_rs, 0, vc_rs, plan,
                                               Q, P, m, cnt, sw);
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

// one launch of B4 at query tile QT: pair 0, query field 0 against corpus
// field 0 (field strides 0)
template <int QT, bool Vec16>
cudaError_t launch_many_as(const int* fq, const float* vq, const int* fc,
                           const float* vc, long long fc_rs, long long vc_rs, int Q,
                           int P, int m, float* cnt, float* sw, cudaStream_t stream) {
  using Shape = ManyShape<QT>;
  const auto kernel = estimate_many_kernel<QT, Vec16>;
  constexpr int smem = fields_smem_bytes<Shape, F32Values>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  PairGroups plan = {};
  plan.n = 1;
  plan.count[0] = 1;
  kernel<<<fields_grid<Shape>(plan, Q, P), Shape::kThreads, smem, stream>>>(
      fq, vq, fc, vc, fc_rs, vc_rs, plan, Q, P, m, cnt, sw);
  return cudaGetLastError();
}

template <int QT>
cudaError_t launch_many(const int* fq, const float* vq, const int* fc, const float* vc,
                        long long fc_rs, long long vc_rs, int Q, int P, int m,
                        float* cnt, float* sw, cudaStream_t stream) {
  if (aligned16(fc, 0, fc_rs, m) && aligned16(vc, 0, vc_rs, m))
    return launch_many_as<QT, true>(fq, vq, fc, vc, fc_rs, vc_rs, Q, P, m, cnt, sw,
                                    stream);
  return launch_many_as<QT, false>(fq, vq, fc, vc, fc_rs, vc_rs, Q, P, m, cnt, sw,
                                   stream);
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
  if (Q < 1 || P < 1 || m < 1 || (Q + 15) / 16 > 65535) return cudaErrorInvalidValue;
  if (Q == 1) return launch_many<1>(fq, vq, fc, vc, fc_rs, vc_rs, Q, P, m, cnt, sw, stream);
  return launch_many<16>(fq, vq, fc, vc, fc_rs, vc_rs, Q, P, m, cnt, sw, stream);
}

}  // namespace repro

// Fused multi-field linear-sketch dots (CountSketch, JL) for Hopper: one
// body, two kernels.
//
//   linear_estimate_fields_kernel<QT>         B8, repro/kernels/estimate.py::
//                                             _linear_fields_kernel (launcher
//                                             linear_estimate_fields_pallas)
//   linear_estimate_fields_packed_kernel<QT>  B12, ::_linear_fields_packed_kernel
//                                             (launcher
//                                             linear_estimate_fields_packed_pallas)
//
// For each field pair g = (qmap[g], cmap[g]), rep r and (q, p):
//   out[g, r, q, p] = sum_w tq[qmap[g], q, r, w] * tc[cmap[g], p, r, w]
// tq [F, Q, R, W] contiguous; tc [C, P, R, W] with any field and row stride
// and each row's [R, W] table contiguous (a tenant slice of the store's
// [3, cap, R, W] buffer needs no copy); out [G, R, Q, P].  B12 takes the
// corpus as bf16-halfword words wc [C, P, R, W / 2] i32 (W even; the query
// tables carry a zero column there) and decodes each word exactly where
// the tile is read, so B12 on wc gives B8's bits on unpack(wc).  The pad
// column adds 0 * 0 = +0, which leaves every sum's bits as they were: a sum
// that starts at +0 never becomes -0 in round-to-nearest (x + -x and +0 +
// -0 are +0).  Every (g, r, q, p) sum is an f32 product then an f32 add per
// w, w = 0 .. W-1 in order, in one thread (-fmad=false and no tensor cores:
// no FMA, no TF32), whatever Q, P, the map or the tiling: kernel == plain
// version, batched == sequential queries.
//
// Bound.  At Q = 1, bytes: the corpus tables read once (150 MB for the CS
// tables of 16,384 rows, 0.045 ms at 3.35 TB/s).  At Q = 16, the no-FMA
// contract: two FP32 instructions per (g, r, q, p, w), 128 lanes per SM and
// clock, 0.575 ms at CS Q = 16, P = 131,072 (132 SMs at 1.98 GHz), above the
// 0.434 ms of its bytes.
//
// Design.  The launcher groups the pairs by corpus field (largest group
// first; a group of more than kSlots pairs takes several entries), and a
// block of 128 threads owns one (group, rep, 128-row tile, query tile): it
// streams the field's tables through shared memory once, 32 w per tile, and
// accumulates every pair of the group against each tile, so a field is
// read once per query tile, not once per pair.  The group's size is a
// template parameter: a slot it lacks costs no instruction.  The query
// tile QT is 1, 4 or 16 as Q is 1, 2-4 or more, so a single query
// multiplies no padded ones.  Each lane accumulates QV <= 4 queries x PR rows x the group's
// pairs in registers (QT = 16: 4 x 4 x 3 = 48), so per w it reads PR + 3 QV
// words from shared memory for 6 QV PR FP32 instructions: one row per lane
// would read 49 words per 96 instructions, more than the shared-memory pipe
// (32 words per SM and clock) feeds the FP32 pipes (128 lanes).  The next
// tile is copied by cp.async while this one is summed (two shared tiles,
// one wait and one barrier per tile); staging through registers measured
// no faster and takes 32 more registers a lane.  Corpus rows are 4-byte
// aligned only
// (3,060, 3,076 or 1,540 B), so no TMA and no 16-byte copies: a warp copies
// 128 B of one row (f32) or 64 B of two rows (packed) at a time, unrolled
// with no per-row test in every row tile but the last; rows padded by a
// word keep the per-lane row reads conflict-free.  The query tile is
// w-major, read by broadcast 16 bytes at a time; at QT = 16 its rows are
// shifted so the staging copies are conflict-free too.  PERF.md has the
// measured breakdown (staging about a fifth of the time at Q = 16).
#include <cuda_runtime.h>
#include <cstdint>

#include "packed.cuh"

namespace repro {
namespace {

constexpr int kMaxPairs = 16;
constexpr int kSlots = 3;      // pairs of one corpus field per block
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 128;     // corpus rows per block
constexpr int kTile = 32;      // w per staged tile

// The field pairs grouped by corpus field, largest group first.
struct Groups {
  int c[kMaxPairs];            // the group's corpus field
  int n[kMaxPairs];            // its pairs, 1 .. kSlots
  int g[kMaxPairs][kSlots];    // their pair indices (out's first axis)
  int q[kMaxPairs][kSlots];    // their query fields
};

// 4-byte copy from global to shared memory that the copy engine finishes
// on its own, while the lane goes on
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void copy_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// corpus tables as f32, one w per word
struct F32Tables {
  using Word = float;
  static constexpr int kPer = 1;
  __device__ static float at(float v, int) { return v; }
};

// corpus tables as bf16-halfword pairs, two w per i32 word: w 2k + h of a
// row is half h of its word k
struct PackedTables {
  using Word = int;
  static constexpr int kPer = 2;
  __device__ static float at(int v, int h) { return h ? unpack_odd(v) : unpack_even(v); }
};

// The lanes' share of a query tile of QT rows.  A lane sums QV queries
// against PR corpus rows (rows rl + kRowLanes i).  The tile is staged by
// warps of 32 / QV w x QV queries: warp k copies w 8k .. 8k + 7 (QT >= 4)
// or all 32 w of pair k (QT = 1).  In shared memory it is w-major, QT
// values per w, the row of w tt at off(tt): at QT = 16 every second row
// moves on by 4 more words, so the 8 w of one staging warp fall in distinct
// banks.
template <int QT>
struct QueryTile {
  static constexpr int kQV = QT < 4 ? QT : 4;
  static constexpr int kGroups = QT / kQV;               // lane groups over queries
  static constexpr int kRowLanes = kThreads / kGroups;   // lanes over rows
  static constexpr int kPR = kRows / kRowLanes;
  static constexpr int kLaneW = 32 / kQV;                // w per staging warp
  static_assert(QT == 1 || kLaneW * kWarps == kTile, "one staging warp per 8 w");
  __device__ static constexpr int off(int tt) {
    return tt * QT + (QT >= 16 ? 4 * (tt >> 1) : 0);
  }
  static constexpr int kPairWords = kTile * QT + (QT >= 16 ? 2 * kTile : 0);
};

template <class V, int N>
__device__ __forceinline__ V pick(const V (&a)[N], int i) {
  V v = a[0];
#pragma unroll
  for (int k = 1; k < N; ++k) v = i == k ? a[k] : v;
  return v;
}

// One block: the NS pairs of group `job` at rep r against 128 corpus rows
// and QT queries.  The corpus tile holds the tables' words as they are
// (rows padded by a word); a packed word is decoded where it is read.
template <class T, int QT, int NS>
__device__ __forceinline__ void dot_group(
    const float* __restrict__ tq, const typename T::Word* __restrict__ tc,
    long long fs, long long ps, const Groups& grp, int job, int r, int Q, int P,
    int R, int W, float* __restrict__ out,
    typename T::Word (*s_c)[kRows][kTile / T::kPer + 1],
    float (*s_q)[kSlots * QueryTile<QT>::kPairWords]) {
  using L = QueryTile<QT>;
  using Word = typename T::Word;
  constexpr int QV = L::kQV, PR = L::kPR, kPer = T::kPer;
  constexpr int kWords = kTile / kPer;            // corpus words per row and tile
  constexpr int kStride = kWords + 1;             // a tile row in shared memory
  constexpr int kRowStep = kThreads / kWords;     // rows between a lane's words
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int p0 = blockIdx.x * kRows, q0 = blockIdx.y * QT;
  const int tiles = (W + kTile - 1) / kTile;
  const int Ww = W / kPer;

  // staging: this lane copies word k of rows row0 + kRowStep j of each
  // tile, and query values of the pairs' query tables.  Rows past P and
  // queries past Q are not copied: their sums are never stored.
  const int k = tid % kWords, row0 = tid / kWords;
  const int rows_left = P - p0 - row0;
  const Word* src = tc + (long long)grp.c[job] * fs + (long long)(p0 + row0) * ps +
                    (long long)r * Ww + k;
  const float* qsrc[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s)
    qsrc[s] = tq + ((long long)(grp.q[job][s] * Q + q0) * R + r) * W;
  const int q_stride = R * W;
  const bool all_rows = p0 + kRows <= P;   // every block but the last row tile
  auto stage = [&](int t, int b) {   // tile t into buffer b
    if (t * kWords + k < Ww) {
      const Word* at = src + t * kWords;
      Word* dst = &s_c[b][row0][k];
      if (all_rows) {
#pragma unroll
        for (int j = 0; j < kWords; ++j) {
          copy_async(dst + j * kRowStep * kStride, at);
          at += kRowStep * ps;
        }
      } else {
#pragma unroll 4
        for (int j = 0; j < kWords && j * kRowStep < rows_left; ++j) {
          copy_async(dst + j * kRowStep * kStride, at);
          at += kRowStep * ps;
        }
      }
    }
    if constexpr (QT == 1) {
      const int w = t * kTile + lane;
      if (warp < NS && w < W)
        copy_async(&s_q[b][warp * L::kPairWords + lane], pick(qsrc, warp) + w);
    } else {
      const int tt = warp * L::kLaneW + lane % L::kLaneW, w = t * kTile + tt;
      if (w < W) {
#pragma unroll
        for (int s = 0; s < NS; ++s)
#pragma unroll
          for (int m = 0; m < L::kGroups; ++m) {
            const int jq = m * QV + lane / L::kLaneW;
            if (q0 + jq < Q)
              copy_async(&s_q[b][s * L::kPairWords + L::off(tt) + jq],
                         qsrc[s] + (long long)jq * q_stride + w);
          }
      }
    }
    copy_async_commit();
  };

  // summing: this lane's queries qg QV + j and rows rl + kRowLanes i
  const int qg = tid / L::kRowLanes, rl = tid % L::kRowLanes;
  float acc[NS][QV][PR];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int j = 0; j < QV; ++j)
#pragma unroll
      for (int i = 0; i < PR; ++i) acc[s][j][i] = 0.f;

  stage(0, 0);
  for (int t = 0; t < tiles; ++t) {
    const int b = t & 1;
    copy_async_wait();
    __syncthreads();   // tile t is staged; every lane is done with tile t - 1
    if (t + 1 < tiles) stage(t + 1, b ^ 1);
    const int words = min(kTile, W - t * kTile) / kPer;
    const Word* cs = &s_c[b][rl][0];
    const float* qs = &s_q[b][qg * QV];
#pragma unroll(4 / kPer)
    for (int kk = 0; kk < words; ++kk) {
      Word cw[PR];
#pragma unroll
      for (int i = 0; i < PR; ++i) cw[i] = cs[i * L::kRowLanes * kStride + kk];
#pragma unroll
      for (int h = 0; h < kPer; ++h) {
        float c[PR];
#pragma unroll
        for (int i = 0; i < PR; ++i) c[i] = T::at(cw[i], h);
        const float* qrow = qs + L::off(kk * kPer + h);
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          float v[QV];
          if constexpr (QV == 4) {
            const float4 x = *reinterpret_cast<const float4*>(qrow + s * L::kPairWords);
            v[0] = x.x;
            v[1] = x.y;
            v[2] = x.z;
            v[3] = x.w;
          } else {
#pragma unroll
            for (int j = 0; j < QV; ++j) v[j] = qrow[s * L::kPairWords + j];
          }
#pragma unroll
          for (int j = 0; j < QV; ++j)
#pragma unroll
            for (int i = 0; i < PR; ++i)
              acc[s][j][i] = __fadd_rn(acc[s][j][i], __fmul_rn(v[j], c[i]));
        }
      }
    }
  }

#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const long long base = ((long long)grp.g[job][s] * R + r) * Q;
#pragma unroll
    for (int j = 0; j < QV; ++j) {
      const int q = q0 + qg * QV + j;
      if (q >= Q) continue;
#pragma unroll
      for (int i = 0; i < PR; ++i) {
        const int p = p0 + rl + i * L::kRowLanes;
        if (p < P) out[(base + q) * P + p] = acc[s][j][i];
      }
    }
  }
}

template <class T, int QT>
__device__ __forceinline__ void linear_tile(const float* __restrict__ tq,
                                            const typename T::Word* __restrict__ tc,
                                            long long fs, long long ps, const Groups& grp,
                                            int Q, int P, int R, int W,
                                            float* __restrict__ out) {
  __shared__ typename T::Word s_c[2][kRows][kTile / T::kPer + 1];
  __shared__ __align__(16) float s_q[2][kSlots * QueryTile<QT>::kPairWords];
  const int job = blockIdx.z / R, r = blockIdx.z % R;
  switch (grp.n[job]) {   // uniform across the block
    case 1:
      dot_group<T, QT, 1>(tq, tc, fs, ps, grp, job, r, Q, P, R, W, out, s_c, s_q);
      break;
    case 2:
      dot_group<T, QT, 2>(tq, tc, fs, ps, grp, job, r, Q, P, R, W, out, s_c, s_q);
      break;
    default:
      dot_group<T, QT, 3>(tq, tc, fs, ps, grp, job, r, Q, P, R, W, out, s_c, s_q);
  }
}

template <int QT>
__global__ void __launch_bounds__(kThreads, 4)
linear_estimate_fields_kernel(const float* __restrict__ tq, const float* __restrict__ tc,
                              long long tc_fs, long long tc_ps, Groups grp, int Q, int P,
                              int R, int W, float* __restrict__ out) {
  linear_tile<F32Tables, QT>(tq, tc, tc_fs, tc_ps, grp, Q, P, R, W, out);
}

template <int QT>
__global__ void __launch_bounds__(kThreads, 4)
linear_estimate_fields_packed_kernel(const float* __restrict__ tq,
                                     const int* __restrict__ wc, long long wc_fs,
                                     long long wc_ps, Groups grp, int Q, int P, int R,
                                     int W, float* __restrict__ out) {
  linear_tile<PackedTables, QT>(tq, wc, wc_fs, wc_ps, grp, Q, P, R, W, out);
}

// The pairs grouped by corpus field into grp; returns the number of groups
// (0 for a bad G).
int make_groups(const int* qmap, const int* cmap, int G, Groups* grp) {
  if (G < 1 || G > kMaxPairs) return 0;
  int field[kMaxPairs], size[kMaxPairs], order[kMaxPairs], nf = 0;
  for (int g = 0; g < G; ++g) {
    int f = 0;
    while (f < nf && field[f] != cmap[g]) ++f;
    if (f == nf) {
      field[nf] = cmap[g];
      size[nf++] = 0;
    }
    ++size[f];
  }
  for (int f = 0; f < nf; ++f) {   // largest first, stable
    int o = f;
    for (; o > 0 && size[order[o - 1]] < size[f]; --o) order[o] = order[o - 1];
    order[o] = f;
  }
  *grp = Groups{};
  int jobs = 0;
  for (int o = 0; o < nf; ++o) {
    int* n = nullptr;
    for (int g = 0; g < G; ++g) {
      if (cmap[g] != field[order[o]]) continue;
      if (n == nullptr || *n == kSlots) {
        grp->c[jobs] = cmap[g];
        n = &grp->n[jobs++];
      }
      const int j = jobs - 1;
      grp->g[j][*n] = g;
      grp->q[j][*n] = qmap[g];
      ++*n;
    }
  }
  return jobs;
}

template <class Word>
using LinearKernel = void (*)(const float*, const Word*, long long, long long, Groups, int,
                              int, int, int, float*);

// One launch: the query tile sized to Q (1; 2-4; more), one block per
// (group, rep, query tile, 128-row tile).
template <class Word>
cudaError_t launch_linear(LinearKernel<Word> k1, LinearKernel<Word> k4,
                          LinearKernel<Word> k16, const float* tq, const Word* tc,
                          long long fs, long long ps, const int* qmap, const int* cmap,
                          int G, int Q, int P, int R, int W, float* out,
                          cudaStream_t stream) {
  Groups grp;
  const int jobs = make_groups(qmap, cmap, G, &grp);
  if (jobs == 0 || Q < 1 || P < 1 || R < 1 || W < 1) return cudaErrorInvalidValue;
  const int qt = Q == 1 ? 1 : Q <= 4 ? 4 : 16;
  const long long z = (long long)jobs * R;
  const dim3 grid((P + kRows - 1) / kRows, (Q + qt - 1) / qt, (unsigned)z);
  if (grid.y > 65535 || z > 65535) return cudaErrorInvalidValue;
  const LinearKernel<Word> kernel = qt == 1 ? k1 : qt == 4 ? k4 : k16;
  kernel<<<grid, kThreads, 0, stream>>>(tq, tc, fs, ps, grp, Q, P, R, W, out);
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_linear_estimate_fields(const float* tq, const float* tc,
                                          long long tc_fs, long long tc_ps,
                                          const int* qmap, const int* cmap, int G,
                                          int Q, int P, int R, int W, float* out,
                                          cudaStream_t stream) {
  return launch_linear<float>(linear_estimate_fields_kernel<1>,
                              linear_estimate_fields_kernel<4>,
                              linear_estimate_fields_kernel<16>, tq, tc, tc_fs, tc_ps,
                              qmap, cmap, G, Q, P, R, W, out, stream);
}

cudaError_t launch_linear_estimate_fields_packed(const float* tq, const int* wc,
                                                 long long wc_fs, long long wc_ps,
                                                 const int* qmap, const int* cmap,
                                                 int G, int Q, int P, int R, int W,
                                                 float* out, cudaStream_t stream) {
  if (W < 2 || W % 2) return cudaErrorInvalidValue;
  return launch_linear<int>(linear_estimate_fields_packed_kernel<1>,
                            linear_estimate_fields_packed_kernel<4>,
                            linear_estimate_fields_packed_kernel<16>, tq, wc, wc_fs,
                            wc_ps, qmap, cmap, G, Q, P, R, W, out, stream);
}

}  // namespace repro

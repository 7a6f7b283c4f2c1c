// ICWS collision partials of many queries against a corpus, for Hopper: two
// bodies, three kernels.
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
// m-1 in order in one thread, one f32 add a collision (collide), whatever Q,
// P, the tiling or the kernel: that fixed order is what makes batched and
// sequential queries bitwise equal, and B2, B4 and B11 equal where their
// functions meet.  No atomics, and no [Q, P, m] tensor anywhere.
//
// Bound: bytes.  The corpus planes are read in [128 x 32] tiles (128 rows,
// one a thread, 32 samples) into shared memory, each thread then walks its
// row's samples against query rows held in shared memory.
//
// B2 (estimate_fields_kernel): a block owns one corpus field's 128 rows and
// evaluates every pair that reads that field (a group of the launcher's
// PairGroups: up to 16 pairs at one query, 3 at 16), so each corpus plane is
// read once a launch at the service's map (three planes for six pairs), not
// once a pair.  The query tile QT is a template parameter (1 for a single
// query, 16), and at QT = 16 four threads share a row, four queries each,
// so that 16 warps a block hide the shared-memory latency of the compares.
// The tiles come a tile ahead through cp.async (16-byte copies where rows
// are 16-byte aligned), double-buffered, so bytes stay in flight while the
// compares run; a tile's rows are swizzled, not padded, so that three
// blocks (QT = 1) or two (QT = 16) fit an SM and the launch at the
// service's P = 16,384 is one wave.
//
// B11 and B4 (collision_tile): a block owns 128 rows of one pair's corpus
// field and QT = 16 query rows, grid (P / 128, Q / 16, G).  The body is a
// template on the field map (FieldMap for B11; OnePair, the one plane pair of
// B4, whose [Q, m] x [P, m] -> [Q, P] is B2's function at G = 1) and the
// corpus value loader (F32Values for B4; PackedValues for B11: bf16-halfword
// words wc [C, P, me / 2] i32 decoded where the f32 is loaded; the decode is
// exact, so B11 on (fc, wc) gives B2's bits on (fc, unpack(wc)), and B4 gives
// B2's bits at G = 1, by construction).
#include <cuda_runtime.h>
#include <cstdint>

#include "packed.cuh"

namespace repro {
namespace {

constexpr int kMaxPairs = 16;
constexpr int kRows = 128;   // corpus rows per block (one per thread)
constexpr int kTile = 32;    // samples staged per step
constexpr int kQTile = 16;   // query rows per block (collision_tile)
constexpr int kStages = 2;   // B2's tiles in shared memory

// one collision test of a query sample (a, *x) against a corpus sample
// (f, v): on a hit, one count and one weight added to the (q, p) sums
__device__ __forceinline__ void collide(int a, int f, const float* x, float v,
                                        float& n, float& s) {
  if (a == f && a >= 0) {
    const float xq = *x;
    const float qq = fminf(__fmul_rn(xq, xq), __fmul_rn(v, v));
    const float safe = qq > 0.f ? qq : 1.f;
    n = __fadd_rn(n, 1.f);
    s = __fadd_rn(s, __fdiv_rn(__fmul_rn(xq, v), safe));
  }
}

struct FieldMap {
  int q[kMaxPairs];
  int c[kMaxPairs];
  __device__ int query(int g) const { return q[g]; }
  __device__ int corpus(int g) const { return c[g]; }
};

// B4's one query plane against one corpus plane
struct OnePair {
  __device__ int query(int) const { return 0; }
  __device__ int corpus(int) const { return 0; }
};

// corpus values as f32, one word per sample
struct F32Values {
  using Word = float;
  static constexpr int kPer = 1;   // samples per word
  __device__ static float at(const Word* row, int tt) { return row[tt]; }
};

// corpus values as bf16-halfword pairs, two samples per i32 word
struct PackedValues {
  using Word = int;
  static constexpr int kPer = 2;
  __device__ static float at(const Word* row, int tt) {
    const int word = row[tt >> 1];
    return (tt & 1) ? unpack_odd(word) : unpack_even(word);
  }
};

template <class Map, class V>
__device__ __forceinline__ void collision_tile(
    const int* __restrict__ fq, const float* __restrict__ vq,
    const int* __restrict__ fc, const typename V::Word* __restrict__ vc,
    long long fc_fs, long long fc_rs, long long vc_fs, long long vc_rs,
    Map maps, int Q, int P, int m, float* __restrict__ cnt,
    float* __restrict__ sw) {
  using Word = typename V::Word;
  constexpr int kWords = kTile / V::kPer;   // value words staged per row
  __shared__ int s_fc[kRows][kTile + 1];
  __shared__ Word s_vc[kRows][kWords + 1];
  __shared__ int s_fq[kQTile][kTile];
  __shared__ float s_vq[kQTile][kTile];

  const int g = blockIdx.z;
  const int q0 = blockIdx.y * kQTile;
  const int p0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int qf = maps.query(g);
  const int cf = maps.corpus(g);
  const int* fcf = fc + (long long)cf * fc_fs;
  const Word* vcf = vc + (long long)cf * vc_fs;
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
    const int tc = min(kTile, m - t0);   // packed: even, as m and t0 are
    __syncthreads();
    // corpus tile: warp k reads rows 4k..4k+3, 32 samples (128 B) each
    for (int i = tid; i < kRows * kTile; i += kRows) {
      const int r = i / kTile, tt = i % kTile;
      const int p = p0 + r;
      s_fc[r][tt] = p < P && tt < tc ? fcf[(long long)p * fc_rs + t0 + tt] : -2;
    }
    for (int i = tid; i < kRows * kWords; i += kRows) {
      const int r = i / kWords, k = i % kWords;
      const int p = p0 + r;
      s_vc[r][k] = p < P && k * V::kPer < tc
                       ? vcf[(long long)p * vc_rs + t0 / V::kPer + k]
                       : Word(0);
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
      const float v = V::at(s_vc[tid], tt);
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
      const long long o = ((long long)g * Q + q) * P + p;
      cnt[o] = acc_n[j];
      sw[o] = acc_w[j];
    }
  }
}

// B2's pairs grouped by corpus field: group z reads corpus field cf[z] and
// evaluates the count[z] pairs g[first[z] ..] (query fields qf[..]); groups
// run heaviest first (blockIdx.z)
struct PairGroups {
  int n;
  int cf[kMaxPairs];
  int first[kMaxPairs];
  int count[kMaxPairs];
  int g[kMaxPairs];
  int qf[kMaxPairs];
};

// B2's shape at query tile QT: corpus rows a block and samples a stage (a
// [kRows x kTile] tile per plane), threads a corpus row (the row's queries
// split between them: more warps for the same shared memory), queries a
// thread, and pairs a block (the group size, at most 16)
template <int QT>
struct FieldsShape {
  static constexpr int kRows = 128;
  static constexpr int kTile = 32;
  static constexpr int kSlices = QT >= 4 ? 4 : 1;
  static constexpr int kQV = QT / kSlices;
  static constexpr int kPairs = QT == 1 ? kMaxPairs : 3;
  static constexpr int kThreads = kRows * kSlices;
  static constexpr int kBlocksPerSM = QT == 1 ? 3 : 2;
};

// one stage of B2's shared memory: the corpus tile, 16-byte chunks of a row
// swizzled (chunk c of row r at c ^ (r & 7)) so that the copies stay 16-byte
// aligned and each thread's 16-byte row reads are conflict-free, and the
// query tiles of the block's pairs
template <int QT>
struct FieldsStage {
  using Shape = FieldsShape<QT>;
  int fc[Shape::kRows * Shape::kTile];
  float vc[Shape::kRows * Shape::kTile];
  int fq[Shape::kPairs][QT][Shape::kTile];
  float vq[Shape::kPairs][QT][Shape::kTile];

  // the word of sample tt of row r in the corpus tile
  __device__ static int at(int r, int tt) {
    return r * Shape::kTile + (((tt >> 2) ^ (r & 7)) << 2) + (tt & 3);
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int QT, bool Vec16>
__global__ void
__launch_bounds__(FieldsShape<QT>::kThreads, FieldsShape<QT>::kBlocksPerSM)
estimate_fields_kernel(const int* __restrict__ fq, const float* __restrict__ vq,
                       const int* __restrict__ fc, const float* __restrict__ vc,
                       long long fc_fs, long long fc_rs, long long vc_fs,
                       long long vc_rs, PairGroups plan, int Q, int P, int m,
                       float* __restrict__ cnt, float* __restrict__ sw) {
  using Shape = FieldsShape<QT>;
  using Stage = FieldsStage<QT>;
  constexpr int KP = Shape::kPairs, QV = Shape::kQV, NT = Shape::kThreads;
  constexpr int R = Shape::kRows, T = Shape::kTile;
  extern __shared__ __align__(16) unsigned char fields_smem[];
  Stage* st = reinterpret_cast<Stage*>(fields_smem);

  const int z = blockIdx.z;
  const int np = plan.count[z];
  const int first = plan.first[z];
  const int q0 = blockIdx.y * QT;
  const int nq = min(QT, Q - q0);
  const int p0 = blockIdx.x * R;
  const int tid = threadIdx.x;
  const int row = tid % R;            // this thread's corpus row in the tile
  const int j0 = tid / R * QV;        // and its first query in the tile
  const int* fcf = fc + (long long)plan.cf[z] * fc_fs;
  const float* vcf = vc + (long long)plan.cf[z] * vc_fs;

  // stage s <- samples t0 .. t0 + T - 1 of the block's corpus rows and of its
  // pairs' query rows (query samples past m read as the pad -1, so that a
  // tile's last 4-sample step compares nothing past m); corpus rows past P
  // are not read: their sums are never written
  auto stage = [&](int s, int t0) {
    Stage& S = st[s];
    const int tc = min(T, m - t0);
    if (Vec16) {
      for (int x = tid; x < R * (T / 4); x += NT) {
        const int r = x / (T / 4), tt = (x % (T / 4)) * 4;
        const int p = p0 + r;
        if (p < P && tt < tc) {
          cp_async16(&S.fc[Stage::at(r, tt)], fcf + p * fc_rs + t0 + tt);
          cp_async16(&S.vc[Stage::at(r, tt)], vcf + p * vc_rs + t0 + tt);
        }
      }
    } else {
      for (int x = tid; x < R * T; x += NT) {
        const int r = x / T, tt = x % T;
        const int p = p0 + r;
        if (p < P && tt < tc) {
          cp_async4(&S.fc[Stage::at(r, tt)], fcf + p * fc_rs + t0 + tt);
          cp_async4(&S.vc[Stage::at(r, tt)], vcf + p * vc_rs + t0 + tt);
        }
      }
    }
    for (int x = tid; x < KP * QT * T; x += NT) {
      const int k = x / (QT * T), j = (x / T) % QT, tt = x % T;
      if (k < np && j < nq) {
        if (tt < tc) {
          const long long o = ((long long)plan.qf[first + k] * Q + q0 + j) * m + t0 + tt;
          cp_async4(&S.fq[k][j][tt], fq + o);
          cp_async4(&S.vq[k][j][tt], vq + o);
        } else {
          S.fq[k][j][tt] = -1;
        }
      }
    }
  };

  float acc_n[KP * QV];
  float acc_w[KP * QV];
#pragma unroll
  for (int j = 0; j < KP * QV; ++j) {
    acc_n[j] = 0.f;
    acc_w[j] = 0.f;
  }

  // a ring of kStages tiles: kStages - 1 in flight while one is compared
  const int tiles = (m + T - 1) / T;
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < tiles) stage(s, s * T);
    cp_async_commit();
  }
  for (int it = 0; it < tiles; ++it) {
    cp_async_wait<kStages - 2>();   // tile it has landed
    __syncthreads();                // ... for every thread; tile it - 1 is done
    const int next = it + kStages - 1;
    if (next < tiles) stage(next % kStages, next * T);
    cp_async_commit();
    const Stage& S = st[it % kStages];
    const int tc = min(T, m - it * T);
    for (int tt = 0; tt < tc; tt += 4) {
      const int4 f = *reinterpret_cast<const int4*>(&S.fc[Stage::at(row, tt)]);
      const float4 v = *reinterpret_cast<const float4*>(&S.vc[Stage::at(row, tt)]);
#pragma unroll
      for (int k = 0; k < KP; ++k) {
        if (k < np) {
#pragma unroll
          for (int jj = 0; jj < QV; ++jj) {
            if (j0 + jj < nq) {
              const int4 a = *reinterpret_cast<const int4*>(&S.fq[k][j0 + jj][tt]);
              const float* x = &S.vq[k][j0 + jj][tt];
              float& n = acc_n[k * QV + jj];
              float& w = acc_w[k * QV + jj];
              collide(a.x, f.x, x, v.x, n, w);
              collide(a.y, f.y, x + 1, v.y, n, w);
              collide(a.z, f.z, x + 2, v.z, n, w);
              collide(a.w, f.w, x + 3, v.w, n, w);
            }
          }
        }
      }
    }
  }

  const int p = p0 + row;
  if (p >= P) return;
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    if (k < np) {
      const int g = plan.g[first + k];
#pragma unroll
      for (int jj = 0; jj < QV; ++jj) {
        if (j0 + jj < nq) {
          const long long o = ((long long)g * Q + q0 + j0 + jj) * P + p;
          cnt[o] = acc_n[k * QV + jj];
          sw[o] = acc_w[k * QV + jj];
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kRows)
estimate_fields_packed_kernel(const int* __restrict__ fq, const float* __restrict__ vq,
                              const int* __restrict__ fc, const int* __restrict__ wc,
                              long long fc_fs, long long fc_rs, long long wc_fs,
                              long long wc_rs, FieldMap maps, int Q, int P, int m,
                              float* __restrict__ cnt, float* __restrict__ sw) {
  collision_tile<FieldMap, PackedValues>(fq, vq, fc, wc, fc_fs, fc_rs, wc_fs,
                                         wc_rs, maps, Q, P, m, cnt, sw);
}

__global__ void __launch_bounds__(kRows)
estimate_many_kernel(const int* __restrict__ fq, const float* __restrict__ vq,
                     const int* __restrict__ fc, const float* __restrict__ vc,
                     long long fc_rs, long long vc_rs, int Q, int P, int m,
                     float* __restrict__ cnt, float* __restrict__ sw) {
  collision_tile<OnePair, F32Values>(fq, vq, fc, vc, 0, fc_rs, 0, vc_rs,
                                     OnePair(), Q, P, m, cnt, sw);
}

bool make_map(const int* qmap, const int* cmap, int G, FieldMap* maps) {
  if (G < 1 || G > kMaxPairs) return false;
  for (int g = 0; g < kMaxPairs; ++g) {
    maps->q[g] = g < G ? qmap[g] : 0;
    maps->c[g] = g < G ? cmap[g] : 0;
  }
  return true;
}

dim3 grid_of(int G, int Q, int P) {
  return dim3((P + kRows - 1) / kRows, (Q + kQTile - 1) / kQTile, G);
}

// B2's groups: each corpus field's pairs in g order, in chunks of at most
// `per`, heaviest chunk first (a stable sort, so ties keep field order)
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

bool aligned16(const void* ptr, long long fs, long long rs, int m) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && fs % 4 == 0 && rs % 4 == 0 &&
         m % 4 == 0;
}

template <int QT, bool Vec16>
cudaError_t launch_fields_as(const int* fq, const float* vq, const int* fc,
                             const float* vc, long long fc_fs, long long fc_rs,
                             long long vc_fs, long long vc_rs, const PairGroups& plan,
                             int Q, int P, int m, float* cnt, float* sw,
                             cudaStream_t stream) {
  const auto kernel = estimate_fields_kernel<QT, Vec16>;
  const int smem = kStages * (int)sizeof(FieldsStage<QT>);
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((P + FieldsShape<QT>::kRows - 1) / FieldsShape<QT>::kRows,
                  (Q + QT - 1) / QT, plan.n);
  kernel<<<grid, FieldsShape<QT>::kThreads, smem, stream>>>(
      fq, vq, fc, vc, fc_fs, fc_rs, vc_fs, vc_rs, plan, Q, P, m, cnt, sw);
  return cudaGetLastError();
}

template <int QT>
cudaError_t launch_fields(const int* fq, const float* vq, const int* fc, const float* vc,
                          long long fc_fs, long long fc_rs, long long vc_fs,
                          long long vc_rs, const int* qmap, const int* cmap, int G,
                          int Q, int P, int m, float* cnt, float* sw,
                          cudaStream_t stream) {
  PairGroups plan;
  if (!make_groups(qmap, cmap, G, FieldsShape<QT>::kPairs, &plan) || Q < 1 || P < 1 ||
      m < 1 || (Q + QT - 1) / QT > 65535)
    return cudaErrorInvalidValue;
  if (aligned16(fc, fc_fs, fc_rs, m) && aligned16(vc, vc_fs, vc_rs, m))
    return launch_fields_as<QT, true>(fq, vq, fc, vc, fc_fs, fc_rs, vc_fs, vc_rs, plan,
                                      Q, P, m, cnt, sw, stream);
  return launch_fields_as<QT, false>(fq, vq, fc, vc, fc_fs, fc_rs, vc_fs, vc_rs, plan, Q,
                                     P, m, cnt, sw, stream);
}

}  // namespace

cudaError_t launch_estimate_fields(const int* fq, const float* vq, const int* fc,
                                   const float* vc, long long fc_fs, long long fc_rs,
                                   long long vc_fs, long long vc_rs, const int* qmap,
                                   const int* cmap, int G, int Q, int P, int m,
                                   float* cnt, float* sw, cudaStream_t stream) {
  if (Q == 1)
    return launch_fields<1>(fq, vq, fc, vc, fc_fs, fc_rs, vc_fs, vc_rs, qmap, cmap, G,
                            Q, P, m, cnt, sw, stream);
  return launch_fields<16>(fq, vq, fc, vc, fc_fs, fc_rs, vc_fs, vc_rs, qmap, cmap, G, Q,
                           P, m, cnt, sw, stream);
}

cudaError_t launch_estimate_fields_packed(const int* fq, const float* vq, const int* fc,
                                          const int* wc, long long fc_fs,
                                          long long fc_rs, long long wc_fs,
                                          long long wc_rs, const int* qmap,
                                          const int* cmap, int G, int Q, int P, int m,
                                          float* cnt, float* sw, cudaStream_t stream) {
  FieldMap maps;
  const dim3 grid = grid_of(G, Q, P);
  if (!make_map(qmap, cmap, G, &maps) || Q < 1 || P < 1 || m < 2 || m % 2 ||
      grid.y > 65535)
    return cudaErrorInvalidValue;
  estimate_fields_packed_kernel<<<grid, kRows, 0, stream>>>(
      fq, vq, fc, wc, fc_fs, fc_rs, wc_fs, wc_rs, maps, Q, P, m, cnt, sw);
  return cudaGetLastError();
}

cudaError_t launch_estimate_many(const int* fq, const float* vq, const int* fc,
                                 const float* vc, long long fc_rs, long long vc_rs,
                                 int Q, int P, int m, float* cnt, float* sw,
                                 cudaStream_t stream) {
  const dim3 grid = grid_of(1, Q, P);
  if (Q < 1 || P < 1 || m < 1 || grid.y > 65535) return cudaErrorInvalidValue;
  estimate_many_kernel<<<grid, kRows, 0, stream>>>(fq, vq, fc, vc, fc_rs, vc_rs, Q,
                                                   P, m, cnt, sw);
  return cudaGetLastError();
}

}  // namespace repro

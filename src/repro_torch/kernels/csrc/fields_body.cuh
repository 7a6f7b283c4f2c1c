// The pipelined ICWS collision body, for Hopper, shared by three kernels:
// B2 and B11 (estimate_fields_kernel, estimate_fields_packed_kernel in
// estimate_fields.cu) and B3's one-vs-many route
// (estimate_one_vs_many_kernel in estimate_pairs.cu), each a thin
// __global__ around fields_body<Shape, Vec16, V>.
//
// For each field pair g of the launch's PairGroups and each (q, p):
//   cnt[g, q, p] = sum_t 1[fq == fc and fq >= 0]
//   sw[g, q, p]  = sum_t 1[...] * vq * vc / min(vq^2, vc^2)   (safe denominator)
// Each (q, p) sum runs over t = 0 .. m-1 in order in one thread, one f32
// add a collision (collide), whatever the shape: the order that makes B2,
// B3, B4 and B11 equal bit for bit where their functions meet.
//
// A block owns 128 rows of one corpus field and every pair of its group
// (the pairs that read that field), for QT queries.  The corpus tiles
// ([128 rows x 32 samples] of fingerprints and of value words) and the
// group's query tiles come a tile ahead through cp.async (16-byte copies
// where every row is 16-byte aligned, else 4-byte ones), two stages deep,
// so bytes stay in flight while the compares run.  A tile row's 16-byte
// chunks are swizzled (swizzled<Words>), not padded, so that each thread's
// 16-byte reads of its own row are free of bank conflicts.  At QT >= 4 four
// threads share a row, QT / 4 queries each.  The value loader V decodes
// the corpus values where the compare loads them: F32Values (one f32 word a
// sample) or PackedValues (bf16-halfword pairs, packed.cuh; the decode is
// exact, so B11 on (fc, wc) gives B2's bits on (fc, unpack(wc))).
#pragma once
#include <cuda_runtime.h>
#include <cstdint>

#include "packed.cuh"

namespace repro {
namespace {

constexpr int kMaxPairs = 16;
constexpr int kStages = 2;   // tiles in shared memory: one in flight

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

// word w of row r in a shared tile of Words words a row (16 or 32: four or
// eight 16-byte chunks).  The chunk index is XORed with bits of the row so
// that a quarter-warp's 16-byte reads of one chunk of eight consecutive rows
// fall on distinct banks: c ^ (r & 7) where a row fills a 128-byte bank
// line, c ^ ((r >> 1) & 3) where two rows share one
template <int Words>
__device__ __forceinline__ int swizzled(int r, int w) {
  static_assert(Words == 16 || Words == 32, "four or eight chunks a row");
  const int x = Words == 32 ? (r & 7) : ((r >> 1) & 3);
  return r * Words + (((w >> 2) ^ x) << 2) + (w & 3);
}

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

// 16-byte copies need the base, both strides and the row's words to be
// multiples of 16 bytes
inline bool aligned16(const void* ptr, long long fs, long long rs, long long words) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && fs % 4 == 0 && rs % 4 == 0 &&
         words % 4 == 0;
}

// corpus values as f32, one word a sample: a compare step's 4 values are
// one 16-byte read of row r of a stage's tile (W words a row)
struct F32Values {
  using Word = float;
  static constexpr int kPer = 1;   // samples a word
  template <int W>
  __device__ static float4 four(const float* tile, int r, int tt) {
    return *reinterpret_cast<const float4*>(&tile[swizzled<W>(r, tt)]);
  }
};

// corpus values as bf16-halfword pairs, two samples an i32 word: a compare
// step's 4 values are one 8-byte read (two-way bank conflicts: a swizzle of
// 16-byte chunks cannot spread 8-byte reads), decoded in registers; a
// 16-byte read of 8 samples a step ran slower on the H100 (more registers)
struct PackedValues {
  using Word = int;
  static constexpr int kPer = 2;
  template <int W>
  __device__ static float4 four(const int* tile, int r, int tt) {
    const int2 w = *reinterpret_cast<const int2*>(&tile[swizzled<W>(r, tt / 2)]);
    return make_float4(unpack_even(w.x), unpack_odd(w.x), unpack_even(w.y),
                       unpack_odd(w.y));
  }
};

// pairs grouped by corpus field: group z reads corpus field cf[z] and
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

// a body's shape: QT query rows a block, at most Pairs pairs a group, corpus
// rows a block and samples a stage (a [kRows x kTile] tile a plane),
// threads a corpus row (the row's queries split between them: more warps
// for the same shared memory), queries a thread, and the blocks an SM the
// registers are capped for (__launch_bounds__)
template <int QT_, int Pairs, int BlocksPerSM>
struct FieldsShape {
  static constexpr int QT = QT_;
  static constexpr int kRows = 128;
  static constexpr int kTile = 32;
  static constexpr int kSlices = QT >= 4 ? 4 : 1;
  static constexpr int kQV = QT / kSlices;
  static constexpr int kPairs = Pairs;
  static constexpr int kThreads = kRows * kSlices;
  static constexpr int kBlocksPerSM = BlocksPerSM;
};

// one stage of shared memory: the corpus tiles (fingerprints, value words;
// rows swizzled) and the query tiles of the block's pairs
template <class Shape, class V>
struct FieldsStage {
  static constexpr int kWords = Shape::kTile / V::kPer;   // value words a row
  int fc[Shape::kRows * Shape::kTile];
  typename V::Word vc[Shape::kRows * kWords];
  int fq[Shape::kPairs][Shape::QT][Shape::kTile];
  float vq[Shape::kPairs][Shape::QT][Shape::kTile];
};

template <class Shape, class V>
constexpr int fields_smem_bytes() {
  return kStages * (int)sizeof(FieldsStage<Shape, V>);
}

template <class Shape>
dim3 fields_grid(const PairGroups& plan, int Q, int P) {
  return dim3((P + Shape::kRows - 1) / Shape::kRows, (Q + Shape::QT - 1) / Shape::QT,
              plan.n);
}

template <class Shape, bool Vec16, class V>
__device__ __forceinline__ void fields_body(
    const int* __restrict__ fq, const float* __restrict__ vq,
    const int* __restrict__ fc, const typename V::Word* __restrict__ vc,
    long long fc_fs, long long fc_rs, long long vc_fs, long long vc_rs,
    const PairGroups& plan, int Q, int P, int m, float* __restrict__ cnt,
    float* __restrict__ sw) {
  using Stage = FieldsStage<Shape, V>;
  using Word = typename V::Word;
  constexpr int KP = Shape::kPairs, QT = Shape::QT, QV = Shape::kQV;
  constexpr int NT = Shape::kThreads, R = Shape::kRows, T = Shape::kTile;
  constexpr int W = Stage::kWords;
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
  const Word* vcf = vc + (long long)plan.cf[z] * vc_fs;

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
          cp_async16(&S.fc[swizzled<T>(r, tt)], fcf + p * fc_rs + t0 + tt);
          if constexpr (V::kPer == 1)
            cp_async16(&S.vc[swizzled<W>(r, tt)], vcf + p * vc_rs + t0 + tt);
        }
      }
      if constexpr (V::kPer != 1) {
        for (int x = tid; x < R * (W / 4); x += NT) {
          const int r = x / (W / 4), k = (x % (W / 4)) * 4;
          const int p = p0 + r;
          if (p < P && k * V::kPer < tc)
            cp_async16(&S.vc[swizzled<W>(r, k)], vcf + p * vc_rs + t0 / V::kPer + k);
        }
      }
    } else {
      for (int x = tid; x < R * T; x += NT) {
        const int r = x / T, tt = x % T;
        const int p = p0 + r;
        if (p < P && tt < tc) {
          cp_async4(&S.fc[swizzled<T>(r, tt)], fcf + p * fc_rs + t0 + tt);
          if constexpr (V::kPer == 1)
            cp_async4(&S.vc[swizzled<W>(r, tt)], vcf + p * vc_rs + t0 + tt);
        }
      }
      if constexpr (V::kPer != 1) {
        for (int x = tid; x < R * W; x += NT) {
          const int r = x / W, k = x % W;
          const int p = p0 + r;
          if (p < P && k * V::kPer < tc)
            cp_async4(&S.vc[swizzled<W>(r, k)], vcf + p * vc_rs + t0 / V::kPer + k);
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
      const int4 f = *reinterpret_cast<const int4*>(&S.fc[swizzled<T>(row, tt)]);
      const float4 v = V::template four<W>(S.vc, row, tt);
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

}  // namespace
}  // namespace repro

// ICWS collision partials of many queries against a corpus, for Hopper: one
// body, three kernels.
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
// of a [1, cap, m] buffer, needs no copy).  The body (collision_tile) is a
// template on two things only: the field map (FieldMap for B2 and B11;
// OnePair, the one plane pair of B4, whose [Q, m] x [P, m] -> [Q, P] is B2's
// function at G = 1) and the corpus value loader (F32Values for B2 and B4;
// PackedValues for B11: bf16-halfword words wc [C, P, me / 2] i32 decoded
// where the f32 is loaded; the decode is exact, so B11 on (fc, wc) gives B2's
// bits on (fc, unpack(wc)), and B4 gives B2's bits at G = 1, by construction).
//
// Bound: bytes.  Every corpus fingerprint and value is read once per
// (field pair, query tile), compared against QT query rows held in shared
// memory, and dropped.  A block of 128 threads owns 128 corpus rows: it
// stages a [128 x 32] tile of fc and the values into shared memory with
// coalesced 128-byte row reads (rows padded by a word, so the per-thread row
// reads are conflict-free), then each thread walks its row's 32 samples
// against the QT query rows.  Each (q, p) sum runs over t = 0 .. m-1 in
// order in one thread, whatever Q, P or the tiling: that fixed order is what
// makes batched and sequential queries bitwise equal.  No atomics, and no
// [Q, P, m] tensor anywhere.
#include <cuda_runtime.h>
#include <cstdint>

#include "packed.cuh"

namespace repro {
namespace {

constexpr int kMaxPairs = 16;
constexpr int kRows = 128;   // corpus rows per block (one per thread)
constexpr int kTile = 32;    // samples staged per step
constexpr int kQTile = 16;   // query rows per block

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

__global__ void __launch_bounds__(kRows)
estimate_fields_kernel(const int* __restrict__ fq, const float* __restrict__ vq,
                       const int* __restrict__ fc, const float* __restrict__ vc,
                       long long fc_fs, long long fc_rs, long long vc_fs,
                       long long vc_rs, FieldMap maps, int Q, int P, int m,
                       float* __restrict__ cnt, float* __restrict__ sw) {
  collision_tile<FieldMap, F32Values>(fq, vq, fc, vc, fc_fs, fc_rs, vc_fs, vc_rs,
                                      maps, Q, P, m, cnt, sw);
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

}  // namespace

cudaError_t launch_estimate_fields(const int* fq, const float* vq, const int* fc,
                                   const float* vc, long long fc_fs, long long fc_rs,
                                   long long vc_fs, long long vc_rs, const int* qmap,
                                   const int* cmap, int G, int Q, int P, int m,
                                   float* cnt, float* sw, cudaStream_t stream) {
  FieldMap maps;
  const dim3 grid = grid_of(G, Q, P);
  if (!make_map(qmap, cmap, G, &maps) || Q < 1 || P < 1 || m < 1 || grid.y > 65535)
    return cudaErrorInvalidValue;
  estimate_fields_kernel<<<grid, kRows, 0, stream>>>(
      fq, vq, fc, vc, fc_fs, fc_rs, vc_fs, vc_rs, maps, Q, P, m, cnt, sw);
  return cudaGetLastError();
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

// ICWS collision partials of sketch pairs, for Hopper (B3): two kernels.
//
// Replaces the TPU kernel repro/kernels/estimate.py::_est_kernel, both of its
// launchers:
//   estimate_pairs_kernel        estimate_partials_pallas (pairwise: row p of
//                                A against row p of B)
//   estimate_one_vs_many_kernel  estimate_one_vs_many_pallas (one query
//                                against every corpus row, the query
//                                broadcast by the index map lambda p, mi:
//                                (0, mi))
// For each row p:
//   cnt[p] = sum_t 1[fa[p, t] == fb[p, t] and fa[p, t] >= 0]
//   sw[p]  = sum_t 1[...] * va * vb / min(va^2, vb^2)   (safe denominator)
// with the guard on side A (the query side) only, as in the TPU kernel.  Both
// sides may be strided views whose last dimension is contiguous (field 0 of
// the corpus store's [1, cap, m] buffers needs no copy).  Each sum runs over
// t = 0 .. m-1 in order in one thread, the order of the plain version and of
// B2 and B4: a row of B4, the one-vs-many route, the pairwise route on the
// tiled query and B2 at G = 1 give the same bits.
//
// Bound: bytes.  Each sample of B (and of A, pairwise) is read once.
//
// One-vs-many: B2's pipelined body (fields_body.cuh) with one pair and one
// query (the query as [1, 1, m], the corpus as field 0 through its row
// stride), under its own name: 128 rows a block, swizzled [128 x 32] tiles
// by cp.async a tile ahead, the query's tile staged once a block and read
// by broadcast.
//
// Pairwise: the same pipeline for two row planes: a block owns 128 rows, one
// a thread; both sides' fingerprint and value tiles ([128 x 32] each, 64 KB
// a stage) come two tiles ahead by cp.async (16-byte copies where every row
// is 16-byte aligned), three stages, swizzled, one block an SM (two stages,
// or [128 x 16] tiles at two or three blocks an SM, ran slower on the
// H100).  Side A's samples past m in a tile's last 4-sample step read as
// the pad -1, so the guard compares nothing past m.
#include <cuda_runtime.h>
#include <cstdint>

#include "fields_body.cuh"

namespace repro {
namespace {

// the one-vs-many route's shape: one query, one pair
using OneShape = FieldsShape<1, 1, 3>;

constexpr int kPairRows = 128;   // pairwise: rows a block (one a thread)
constexpr int kPairTile = 32;    // pairwise: samples a stage
constexpr int kPairStages = 3;   // pairwise: stages in shared memory
constexpr int kPairBlocks = 1;   // pairwise: blocks an SM (shared memory)

// one pairwise stage: both sides' tiles, rows swizzled
struct PairStage {
  int fa[kPairRows * kPairTile];
  float va[kPairRows * kPairTile];
  int fb[kPairRows * kPairTile];
  float vb[kPairRows * kPairTile];
};

template <bool Vec16>
__global__ void __launch_bounds__(OneShape::kThreads, OneShape::kBlocksPerSM)
estimate_one_vs_many_kernel(const int* __restrict__ fq, const float* __restrict__ vq,
                            const int* __restrict__ fc, const float* __restrict__ vc,
                            long long fc_rs, long long vc_rs,
                            const __grid_constant__ PairGroups plan, int P,
                            int m, float* __restrict__ cnt, float* __restrict__ sw) {
  fields_body<OneShape, Vec16, F32Values>(fq, vq, fc, vc, 0, fc_rs, 0, vc_rs, plan, 1, P,
                                          m, cnt, sw);
}

template <bool Vec16>
__global__ void __launch_bounds__(kPairRows, kPairBlocks)
estimate_pairs_kernel(const int* __restrict__ fa, const float* __restrict__ va,
                      const int* __restrict__ fb, const float* __restrict__ vb,
                      long long fa_rs, long long va_rs, long long fb_rs,
                      long long vb_rs, int P, int m, float* __restrict__ cnt,
                      float* __restrict__ sw) {
  constexpr int R = kPairRows, T = kPairTile;
  extern __shared__ __align__(16) unsigned char pairs_smem[];
  PairStage* st = reinterpret_cast<PairStage*>(pairs_smem);
  const int p0 = blockIdx.x * R;
  const int tid = threadIdx.x;

  // stage s <- samples t0 .. t0 + T - 1 of the block's rows of both sides;
  // rows past P are not read: their sums are never written
  auto stage = [&](int s, int t0) {
    PairStage& S = st[s];
    const int tc = min(T, m - t0);
    constexpr int step = Vec16 ? 4 : 1;
    for (int x = tid; x < R * (T / step); x += R) {
      const int r = x / (T / step), tt = (x % (T / step)) * step;
      const long long p = p0 + r;
      if (p < P && tt < tc) {
        const int o = swizzled<T>(r, tt);
        const long long t = t0 + tt;
        if (Vec16) {
          cp_async16(&S.fa[o], fa + p * fa_rs + t);
          cp_async16(&S.va[o], va + p * va_rs + t);
          cp_async16(&S.fb[o], fb + p * fb_rs + t);
          cp_async16(&S.vb[o], vb + p * vb_rs + t);
        } else {
          cp_async4(&S.fa[o], fa + p * fa_rs + t);
          cp_async4(&S.va[o], va + p * va_rs + t);
          cp_async4(&S.fb[o], fb + p * fb_rs + t);
          cp_async4(&S.vb[o], vb + p * vb_rs + t);
        }
      }
    }
    // m % 4 != 0: the last step of the last tile reaches past m
    for (int x = tid; x < R * ((4 - tc % 4) % 4); x += R) {
      const int r = x / (4 - tc % 4), tt = tc + x % (4 - tc % 4);
      S.fa[swizzled<T>(r, tt)] = -1;
    }
  };

  float n = 0.f;
  float w = 0.f;
  const int tiles = (m + T - 1) / T;
  for (int s = 0; s < kPairStages - 1; ++s) {
    if (s < tiles) stage(s, s * T);
    cp_async_commit();
  }
  for (int it = 0; it < tiles; ++it) {
    cp_async_wait<kPairStages - 2>();   // tile it has landed
    __syncthreads();                    // ... for every thread; tile it - 1 is done
    const int next = it + kPairStages - 1;
    if (next < tiles) stage(next % kPairStages, next * T);
    cp_async_commit();
    const PairStage& S = st[it % kPairStages];
    const int tc = min(T, m - it * T);
    for (int tt = 0; tt < tc; tt += 4) {
      const int o = swizzled<T>(tid, tt);
      const int4 a = *reinterpret_cast<const int4*>(&S.fa[o]);
      const int4 f = *reinterpret_cast<const int4*>(&S.fb[o]);
      const float4 v = *reinterpret_cast<const float4*>(&S.vb[o]);
      const float* x = &S.va[o];
      collide(a.x, f.x, x, v.x, n, w);
      collide(a.y, f.y, x + 1, v.y, n, w);
      collide(a.z, f.z, x + 2, v.z, n, w);
      collide(a.w, f.w, x + 3, v.w, n, w);
    }
  }
  const int p = p0 + tid;
  if (p < P) {
    cnt[p] = n;
    sw[p] = w;
  }
}

template <bool Vec16>
cudaError_t launch_pairs_as(const int* fa, const float* va, const int* fb,
                            const float* vb, long long fa_rs, long long va_rs,
                            long long fb_rs, long long vb_rs, int P, int m, float* cnt,
                            float* sw, cudaStream_t stream) {
  const auto kernel = estimate_pairs_kernel<Vec16>;
  constexpr int smem = kPairStages * (int)sizeof(PairStage);
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  kernel<<<(P + kPairRows - 1) / kPairRows, kPairRows, smem, stream>>>(
      fa, va, fb, vb, fa_rs, va_rs, fb_rs, vb_rs, P, m, cnt, sw);
  return cudaGetLastError();
}

template <bool Vec16>
cudaError_t launch_one_vs_many_as(const int* fq, const float* vq, const int* fc,
                                  const float* vc, long long fc_rs, long long vc_rs,
                                  int P, int m, float* cnt, float* sw,
                                  cudaStream_t stream) {
  const auto kernel = estimate_one_vs_many_kernel<Vec16>;
  constexpr int smem = fields_smem_bytes<OneShape, F32Values>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  PairGroups plan = {};
  plan.n = 1;
  plan.count[0] = 1;   // pair 0: query field 0 against corpus field 0
  kernel<<<fields_grid<OneShape>(plan, 1, P), OneShape::kThreads, smem, stream>>>(
      fq, vq, fc, vc, fc_rs, vc_rs, plan, P, m, cnt, sw);
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_estimate_pairs(const int* fa, const float* va, const int* fb,
                                  const float* vb, long long fa_rs, long long va_rs,
                                  long long fb_rs, long long vb_rs, int P, int m,
                                  float* cnt, float* sw, cudaStream_t stream) {
  if (P < 1 || m < 1) return cudaErrorInvalidValue;
  if (aligned16(fa, 0, fa_rs, m) && aligned16(va, 0, va_rs, m) &&
      aligned16(fb, 0, fb_rs, m) && aligned16(vb, 0, vb_rs, m))
    return launch_pairs_as<true>(fa, va, fb, vb, fa_rs, va_rs, fb_rs, vb_rs, P, m, cnt,
                                 sw, stream);
  return launch_pairs_as<false>(fa, va, fb, vb, fa_rs, va_rs, fb_rs, vb_rs, P, m, cnt,
                                sw, stream);
}

// fq/vq: the one query's m samples, contiguous
cudaError_t launch_estimate_one_vs_many(const int* fq, const float* vq, const int* fc,
                                        const float* vc, long long fc_rs,
                                        long long vc_rs, int P, int m, float* cnt,
                                        float* sw, cudaStream_t stream) {
  if (P < 1 || m < 1) return cudaErrorInvalidValue;
  if (aligned16(fc, 0, fc_rs, m) && aligned16(vc, 0, vc_rs, m))
    return launch_one_vs_many_as<true>(fq, vq, fc, vc, fc_rs, vc_rs, P, m, cnt, sw,
                                       stream);
  return launch_one_vs_many_as<false>(fq, vq, fc, vc, fc_rs, vc_rs, P, m, cnt, sw,
                                      stream);
}

}  // namespace repro

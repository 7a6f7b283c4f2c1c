// Fused multi-field key-match estimates of the sampling sketches (TS/PS) for
// Hopper.
//
// Replaces the TPU kernel repro/kernels/sample_estimate.py::_sample_fields_kernel
// (launcher sample_estimate_fields_pallas).  For each field pair g = (qmap[g],
// cmap[g]) and each (q, p):
//   est[g, q, p] = sum_{t,u} 1[kq == kc and kq >= 0 and min(aq, ac) > 0]
//                  * vq * vc / min(aq, ac)
// kq/vq/aq [F, Q, S] contiguous; kc/vc/ac [C, P, S] with any field and row
// stride (a tenant slice of the store's buffers needs no copy).
//
// The TPU kernel evaluates the whole [t, u] key-equality cross, S^2 tests
// per pair: 9.3e14 at the serving shape, over 14 s of lane operations.  This
// kernel relies on the row layout instead: the live keys (>= 0) of a row
// are unique and strictly ascending in its leading slots and every later
// slot is negative.  So a two-pointer merge finds every match in O(S) per
// pair: for the query's live slots in ascending t, a pointer u advances
// through the corpus row while kc[u] < kq[t] (stopping at the first
// negative key), and an equal key is the one match of slot t.
//
// Bound: the merge's serial steps, about live_q + live_c per pair.  A block
// owns 32 corpus rows, one per lane: it stages their keys for one corpus
// field into shared memory (rows padded to S + 1 words so the lanes' reads
// spread over the banks), then each warp takes (pair, query) items of that
// field and every lane merges the query's keys (read through L1: all lanes
// of a warp walk the same 3 KB query row) against its own row, each lane
// at its own pace -- no shuffles and no warp-wide step per query slot.  The
// values and probabilities of a match are loaded when it is found and
// consumed at the next match (or after the loop), so their latency
// overlaps the merge instead of stalling it.  Pairs are taken in
// corpus-field order, so each field is staged once per block.  Each
// (g, q, p) sum adds one term per matched t, in ascending t, with a
// separate multiply and an IEEE divide: the plain version (the full cross,
// summed over u, then over t in order) gets the same bits, since with
// unique keys each t has at most one non-zero term.  No atomics.
#include <cuda_runtime.h>
#include <cstdint>

namespace repro {

constexpr int kSampleMaxPairs = 16;
constexpr int kSampleRows = 32;     // corpus rows per block (one per lane)
constexpr int kSampleWarps = 16;    // warps per block

struct SampleMap {
  int q[kSampleMaxPairs];
  int c[kSampleMaxPairs];
  int order[kSampleMaxPairs];       // pairs sorted by corpus field
};

// acc + x * v / min(a, c) where min(a, c) > 0: the kernel's one term
__device__ __forceinline__ float add_term(float acc, float x, float a, float v,
                                          float c) {
  const float p = fminf(a, c);
  return p > 0.f ? __fadd_rn(acc, __fdiv_rn(__fmul_rn(x, v), p)) : acc;
}

__global__ void __launch_bounds__(kSampleWarps * 32)
sample_estimate_fields_kernel(const int* __restrict__ kq, const float* __restrict__ vq,
                              const float* __restrict__ aq, const int* __restrict__ kc,
                              const float* __restrict__ vc, const float* __restrict__ ac,
                              long long kc_fs, long long kc_rs, long long vc_fs,
                              long long vc_rs, long long ac_fs, long long ac_rs,
                              SampleMap maps, int G, int Q, int P, int S,
                              float* __restrict__ out) {
  extern __shared__ int s_kc[];                    // [kSampleRows][S + 1]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int p0 = blockIdx.x * kSampleRows;
  const int p = p0 + lane;
  const int stride = S + 1;
  const int* my_keys = s_kc + lane * stride;

  int gi = 0;
  while (gi < G) {
    // the run of pairs [gi, ge) that reads corpus field cf
    const int cf = maps.c[maps.order[gi]];
    int ge = gi + 1;
    while (ge < G && maps.c[maps.order[ge]] == cf) ++ge;

    __syncthreads();   // the previous field's readers are done
    const int* kcf = kc + (long long)cf * kc_fs;
    for (int r = warp; r < kSampleRows; r += kSampleWarps) {
      const int pr = p0 + r;
      for (int u = lane; u < S; u += 32)
        s_kc[r * stride + u] = pr < P ? kcf[(long long)pr * kc_rs + u] : -2;
    }
    __syncthreads();

    const float* vrow = vc + (long long)cf * vc_fs + (long long)p * vc_rs;
    const float* arow = ac + (long long)cf * ac_fs + (long long)p * ac_rs;
    const int items = (ge - gi) * Q;
    for (int it = warp; it < items; it += kSampleWarps) {
      const int g = maps.order[gi + it / Q];
      const int q = it % Q;
      const long long qo = ((long long)maps.q[g] * Q + q) * S;
      const int* qk = kq + qo;
      float acc = 0.f;
      if (p < P) {
        // two-pointer merge of two ascending live prefixes; a negative key
        // ends either prefix
        int t = 0, u = 0;
        int a = __ldg(qk);
        int b = my_keys[0];
        bool pend = false;
        float px = 0.f, pa = 0.f, pv = 0.f, pc = 0.f;
        while (a >= 0 && b >= 0) {
          if (a == b) {
            if (pend) acc = add_term(acc, px, pa, pv, pc);
            px = __ldg(vq + qo + t);
            pa = __ldg(aq + qo + t);
            pv = vrow[u];
            pc = arow[u];
            pend = true;
          }
          const bool step_t = a <= b, step_u = b <= a;
          t += step_t;
          u += step_u;
          if (step_t) a = t < S ? __ldg(qk + t) : -1;
          if (step_u) b = u < S ? my_keys[u] : -1;
        }
        if (pend) acc = add_term(acc, px, pa, pv, pc);
        out[((long long)g * Q + q) * P + p] = acc;
      }
    }
    gi = ge;
  }
}

cudaError_t launch_sample_estimate_fields(
    const int* kq, const float* vq, const float* aq, const int* kc, const float* vc,
    const float* ac, long long kc_fs, long long kc_rs, long long vc_fs,
    long long vc_rs, long long ac_fs, long long ac_rs, const int* qmap,
    const int* cmap, int G, int Q, int P, int S, float* out, cudaStream_t stream) {
  if (G < 1 || G > kSampleMaxPairs || Q < 1 || P < 1 || S < 1)
    return cudaErrorInvalidValue;
  SampleMap maps;
  for (int g = 0; g < kSampleMaxPairs; ++g) {
    maps.q[g] = g < G ? qmap[g] : 0;
    maps.c[g] = g < G ? cmap[g] : 0;
    maps.order[g] = g;
  }
  // stable insertion sort of the pairs by corpus field
  for (int i = 1; i < G; ++i) {
    for (int j = i; j > 0 && maps.c[maps.order[j - 1]] > maps.c[maps.order[j]]; --j) {
      const int tmp = maps.order[j];
      maps.order[j] = maps.order[j - 1];
      maps.order[j - 1] = tmp;
    }
  }
  const size_t smem = (size_t)kSampleRows * (S + 1) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sample_estimate_fields_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = (unsigned)((P + kSampleRows - 1) / kSampleRows);
  sample_estimate_fields_kernel<<<blocks, kSampleWarps * 32, smem, stream>>>(
      kq, vq, aq, kc, vc, ac, kc_fs, kc_rs, vc_fs, vc_rs, ac_fs, ac_rs, maps, G, Q,
      P, S, out);
  return cudaGetLastError();
}

}  // namespace repro

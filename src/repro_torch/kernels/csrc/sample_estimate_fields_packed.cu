// Fused multi-field key-match estimates of the sampling sketches (TS/PS) over a
// packed corpus, for Hopper.
//
// Replaces the TPU kernel
// repro/kernels/sample_estimate.py::_sample_fields_packed_kernel (launcher
// sample_estimate_fields_packed_pallas): sample_estimate_fields.cu with the
// corpus side as the packed store holds it -- keys kc [C, P, Se] i32 (Se =
// slots rounded up to even, the pad slot holding -2), values as
// bf16-halfword words wc [C, P, Se / 2] i32 and one tau per row tc [C, P]
// f32 -- and no corpus probability plane.  The block staging, the
// lane-private two-pointer merge and the term order are the unpacked
// kernel's.  A match at corpus slot u decodes its value (word u >> 1,
// halfword u & 1) and computes the slot's inclusion probability there, in
// the operation order of sample_estimate.py::_inclusion_probs:
// p = min(1, (s_total * v) * v / tau), 1 where tau <= 0, 0 where v == 0,
// with s_total the scheme's slot count (the query's Sq), not Se.  So on
// (kc, wc, tc) this kernel gives the unpacked kernel's bits on
// (kc, unpack(wc), probs(unpack(wc), tc)).
//
// Bound: the merge's serial steps, as the unpacked kernel; the [C, P, S]
// probability prologue of the unpacked path is gone.
#include <cuda_runtime.h>
#include <cstdint>

#include "packed.cuh"

namespace repro {
namespace {

constexpr int kMaxPairs = 16;
constexpr int kRows = 32;      // corpus rows per block (one per lane)
constexpr int kWarps = 16;     // warps per block

struct SampleMap {
  int q[kMaxPairs];
  int c[kMaxPairs];
  int order[kMaxPairs];        // pairs sorted by corpus field
};

// acc + x * v / min(a, c) where min(a, c) > 0: the kernel's one term
__device__ __forceinline__ float add_term(float acc, float x, float a, float v,
                                          float c) {
  const float p = fminf(a, c);
  return p > 0.f ? __fadd_rn(acc, __fdiv_rn(__fmul_rn(x, v), p)) : acc;
}

// inclusion probability of a stored value v under its row's tau
__device__ __forceinline__ float inclusion_prob(float v, float tau, float s_total) {
  if (v == 0.f) return 0.f;
  if (!(tau > 0.f)) return 1.f;
  const float p = __fdiv_rn(__fmul_rn(__fmul_rn(s_total, v), v), tau);
  return p > 1.f ? 1.f : p;
}

__global__ void __launch_bounds__(kWarps * 32)
sample_estimate_fields_packed_kernel(
    const int* __restrict__ kq, const float* __restrict__ vq,
    const float* __restrict__ aq, const int* __restrict__ kc,
    const int* __restrict__ wc, const float* __restrict__ tc, long long kc_fs,
    long long kc_rs, long long wc_fs, long long wc_rs, long long tc_fs,
    long long tc_rs, SampleMap maps, int G, int Q, int P, int Sq, int Sc,
    float* __restrict__ out) {
  extern __shared__ int s_kc[];                    // [kRows][Sc + 1]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int p0 = blockIdx.x * kRows;
  const int p = p0 + lane;
  const int stride = Sc + 1;
  const int* my_keys = s_kc + lane * stride;
  const float s_total = (float)Sq;

  int gi = 0;
  while (gi < G) {
    // the run of pairs [gi, ge) that reads corpus field cf
    const int cf = maps.c[maps.order[gi]];
    int ge = gi + 1;
    while (ge < G && maps.c[maps.order[ge]] == cf) ++ge;

    __syncthreads();   // the previous field's readers are done
    const int* kcf = kc + (long long)cf * kc_fs;
    for (int r = warp; r < kRows; r += kWarps) {
      const int pr = p0 + r;
      for (int u = lane; u < Sc; u += 32)
        s_kc[r * stride + u] = pr < P ? kcf[(long long)pr * kc_rs + u] : -2;
    }
    __syncthreads();

    const int* wrow = wc + (long long)cf * wc_fs + (long long)p * wc_rs;
    const float tau = p < P ? tc[(long long)cf * tc_fs + (long long)p * tc_rs] : 0.f;
    const int items = (ge - gi) * Q;
    for (int it = warp; it < items; it += kWarps) {
      const int g = maps.order[gi + it / Q];
      const int q = it % Q;
      const long long qo = ((long long)maps.q[g] * Q + q) * Sq;
      const int* qk = kq + qo;
      float acc = 0.f;
      if (p < P) {
        // two-pointer merge of two ascending live prefixes; a negative key
        // ends either prefix
        int t = 0, u = 0;
        int a = __ldg(qk);
        int b = my_keys[0];
        bool pend = false;
        int pu = 0;
        float px = 0.f, pa = 0.f;
        int pw = 0;
        while (a >= 0 && b >= 0) {
          if (a == b) {
            if (pend) {
              const float v = (pu & 1) ? unpack_odd(pw) : unpack_even(pw);
              acc = add_term(acc, px, pa, v, inclusion_prob(v, tau, s_total));
            }
            px = __ldg(vq + qo + t);
            pa = __ldg(aq + qo + t);
            pw = wrow[u >> 1];
            pu = u;
            pend = true;
          }
          const bool step_t = a <= b, step_u = b <= a;
          t += step_t;
          u += step_u;
          if (step_t) a = t < Sq ? __ldg(qk + t) : -1;
          if (step_u) b = u < Sc ? my_keys[u] : -1;
        }
        if (pend) {
          const float v = (pu & 1) ? unpack_odd(pw) : unpack_even(pw);
          acc = add_term(acc, px, pa, v, inclusion_prob(v, tau, s_total));
        }
        out[((long long)g * Q + q) * P + p] = acc;
      }
    }
    gi = ge;
  }
}

}  // namespace

cudaError_t launch_sample_estimate_fields_packed(
    const int* kq, const float* vq, const float* aq, const int* kc, const int* wc,
    const float* tc, long long kc_fs, long long kc_rs, long long wc_fs,
    long long wc_rs, long long tc_fs, long long tc_rs, const int* qmap,
    const int* cmap, int G, int Q, int P, int Sq, int Sc, float* out,
    cudaStream_t stream) {
  if (G < 1 || G > kMaxPairs || Q < 1 || P < 1 || Sq < 1 || Sc < 2 || Sc % 2)
    return cudaErrorInvalidValue;
  SampleMap maps;
  for (int g = 0; g < kMaxPairs; ++g) {
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
  const size_t smem = (size_t)kRows * (Sc + 1) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sample_estimate_fields_packed_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = (unsigned)((P + kRows - 1) / kRows);
  sample_estimate_fields_packed_kernel<<<blocks, kWarps * 32, smem, stream>>>(
      kq, vq, aq, kc, wc, tc, kc_fs, kc_rs, wc_fs, wc_rs, tc_fs, tc_rs, maps, G, Q, P,
      Sq, Sc, out);
  return cudaGetLastError();
}

}  // namespace repro

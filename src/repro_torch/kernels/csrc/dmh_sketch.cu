// Batched DMH (densified one-permutation weighted MinHash) sketch for Hopper.
//
// Replaces the TPU kernel repro/kernels/dmh_sketch.py::_dmh_kernel and its
// _densify epilogue (launcher dmh_sketch_pallas).
// [B, N] (w f32, keys i32, vals f32) -> (fp i32, val f32, amin f32, argkey i32) [B, m],
// N counting the replicated lanes (replica-major, lane = r * n + i).
//
// Bound: latency.  The work is O(N + m) per row -- one bin hash and one set
// of ICWS variates per lane, one gather and a few densify probes per bin --
// where the ICWS sketch does O(N * m).  The TPU kernel keeps the m-bin state
// resident in VMEM across sequential N tiles and realizes the per-bin
// argmin as a [BR, BM, BN] bin-equality cross (Pallas has no scatter).  On
// Hopper the bin state lives in shared memory and the argmin is a scatter:
// each lane does one 64-bit atomicMin on (float bits of a) << 32 | lane.
// a > 0 (or BIG on pad lanes), so its bits order as unsigned integers and
// the packed minimum is the smallest a with ties to the lowest lane -- the
// TPU kernel's strict-< tile merge plus argmin -- whatever order the lanes
// arrive in: bitwise deterministic.  One block per row; after a barrier a
// thread per bin recomputes its winner's level (the same arithmetic, so the
// same bits), hashes the fingerprint, and after a second barrier runs the
// densify probes against the shared occupancy.  Compiled with -fmad=false
// and IEEE divides, as the ICWS sketch: a contraction could flip a floor.
//
// With Pack (the TPU kernel's pack_vals epilogue, _dmh_kernel_packed) the
// block then writes the row's bf16-halfword plane [me / 2] i32 (me = m
// rounded up to even): after the densify loop and a barrier, one thread per
// pair of slots reads the two densified values back and writes one word,
// the odd-m pad slot as zero; empty rows hold value 0 and pack to zero.
#include <cuda_runtime.h>
#include <cstdint>

#include "packed.cuh"
#include "u32.cuh"

namespace repro {

constexpr int kDmhThreads = 1024;

// ICWS hash value a of one live lane, its variates drawn at sample t = bin;
// the level goes to *lvl
__device__ __forceinline__ float dmh_rank(uint32_t k, float wi, uint32_t seed,
                                          uint32_t bin, float* lvl) {
  const float r = -logf(__fmul_rn(uniform01(k, salt_for(seed, DMH_STREAM_R1, bin)),
                                  uniform01(k, salt_for(seed, DMH_STREAM_R2, bin))));
  const float c = -logf(__fmul_rn(uniform01(k, salt_for(seed, DMH_STREAM_C1, bin)),
                                  uniform01(k, salt_for(seed, DMH_STREAM_C2, bin))));
  const float beta = uniform01(k, salt_for(seed, DMH_STREAM_BETA, bin));
  const float logw = logf(fmaxf(wi, 1e-37f));
  *lvl = floorf(__fadd_rn(__fdiv_rn(logw, r), beta));
  const float y = expf(__fmul_rn(r, __fsub_rn(*lvl, beta)));
  return __fdiv_rn(c, __fmul_rn(y, expf(r)));
}

template <bool Pack>
__global__ void __launch_bounds__(kDmhThreads)
dmh_sketch_kernel(const float* __restrict__ w, const int* __restrict__ keys,
                  const float* __restrict__ vals, int N, int m, uint32_t seed,
                  int J, int* __restrict__ fp_out, float* __restrict__ val_out,
                  float* __restrict__ amin_out, int* __restrict__ key_out,
                  int* __restrict__ packed) {
  extern __shared__ unsigned long long s_best[];           // [m] packed (a, lane)
  float* s_amin = reinterpret_cast<float*>(s_best + m);    // [m]
  int* s_fp = reinterpret_cast<int*>(s_amin + m);          // [m]
  float* s_val = reinterpret_cast<float*>(s_fp + m);       // [m]
  int* s_key = reinterpret_cast<int*>(s_val + m);          // [m]
  __shared__ int s_first;                                  // first occupied bin

  const long long row = (long long)blockIdx.x * N;
  const float* wr = w + row;
  const int* kr = keys + row;
  const float* vr = vals + row;
  const int tid = threadIdx.x;
  const unsigned long long none =
      ((unsigned long long)__float_as_uint(BIG) << 32) | 0xFFFFFFFFull;

  for (int t = tid; t < m; t += blockDim.x) s_best[t] = none;
  if (tid == 0) s_first = m;
  __syncthreads();

  const uint32_t bin_salt = salt_for(seed, DMH_STREAM_BIN, 0u);
  for (int i = tid; i < N; i += blockDim.x) {
    const uint32_t k = (uint32_t)kr[i];
    const uint32_t bin = hash_u32(k, bin_salt) % (uint32_t)m;
    const float wi = wr[i];
    float a = BIG;
    if (wi > 0.f) {
      float lvl;
      a = dmh_rank(k, wi, seed, bin, &lvl);
    }
    atomicMin(&s_best[bin],
              ((unsigned long long)__float_as_uint(a) << 32) | (uint32_t)i);
  }
  __syncthreads();

  // each occupied bin's winner: its level again (same bits), fingerprint,
  // value and key
  int live = 0;
  for (int t = tid; t < m; t += blockDim.x) {
    const unsigned long long best = s_best[t];
    const float a = __uint_as_float((uint32_t)(best >> 32));
    s_amin[t] = a;
    if (a < BIG) {
      const int i = (int)(uint32_t)(best & 0xFFFFFFFFull);
      const uint32_t k = (uint32_t)kr[i];
      float lvl;
      dmh_rank(k, wr[i], seed, (uint32_t)t, &lvl);
      const uint32_t lv = (uint32_t)(int)lvl;
      const uint32_t bits = hash_u32(k ^ (lv * 0x9E3779B9u),
                                     salt_for(seed, DMH_STREAM_FP, (uint32_t)t));
      s_fp[t] = (int)(bits & 0x7FFFFFFFu);
      s_val[t] = vr[i];
      s_key[t] = (int)k;
      atomicMin(&s_first, t);
      live = 1;
    }
  }
  const int row_live = __syncthreads_or(live);

  // densify: an empty bin of a live row borrows every plane from the first
  // probe that lands on an occupied bin, else from the first occupied bin
  const long long o = (long long)blockIdx.x * m;
  for (int t = tid; t < m; t += blockDim.x) {
    int src = t;
    if (!(s_amin[t] < BIG)) {
      if (!row_live) {
        fp_out[o + t] = -1;
        val_out[o + t] = 0.f;
        amin_out[o + t] = s_amin[t];
        key_out[o + t] = 0;
        continue;
      }
      src = s_first;
      for (int j = 0; j < J; ++j) {
        const int p = (int)(hash_u32((uint32_t)t,
                                     salt_for(seed, DMH_STREAM_DENSIFY, (uint32_t)j))
                            % (uint32_t)m);
        if (s_amin[p] < BIG) {
          src = p;
          break;
        }
      }
    }
    fp_out[o + t] = s_fp[src];
    val_out[o + t] = s_val[src];
    amin_out[o + t] = s_amin[src];
    key_out[o + t] = s_key[src];
  }
  if (Pack) {
    __syncthreads();   // the row's densified values are written
    const int mw = (m + 1) / 2;
    for (int k = tid; k < mw; k += blockDim.x) {
      const float v0 = val_out[o + 2 * k];
      const float v1 = 2 * k + 1 < m ? val_out[o + 2 * k + 1] : 0.f;
      packed[(long long)blockIdx.x * mw + k] = (int)(pack_half(v0, 0) | pack_half(v1, 1));
    }
  }
}

cudaError_t launch_dmh_sketch(const float* w, const int* keys, const float* vals,
                              int B, int N, int m, uint32_t seed, int J, int* fp,
                              float* val, float* amin, int* argkey, int* packed,
                              cudaStream_t stream) {
  if (B < 1 || N < 1 || m < 1 || J < 1) return cudaErrorInvalidValue;
  const size_t smem = (size_t)m * (sizeof(unsigned long long) + 4 * sizeof(int));
  auto kernel = packed ? dmh_sketch_kernel<true> : dmh_sketch_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<B, kDmhThreads, smem, stream>>>(w, keys, vals, N, m, seed, J, fp, val, amin,
                                           argkey, packed);
  return cudaGetLastError();
}

}  // namespace repro

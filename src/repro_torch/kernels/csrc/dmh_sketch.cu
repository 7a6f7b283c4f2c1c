// Batched DMH (densified one-permutation weighted MinHash) sketch for Hopper.
//
// Replaces the TPU kernel repro/kernels/dmh_sketch.py::_dmh_kernel and its
// _densify epilogue (launcher dmh_sketch_pallas).
// [B, n] (w f32, keys i32, vals f32), c replicas -> (fp i32, val f32, amin f32,
// argkey i32) [B, m].  The row's lanes are l = r * n + i for r < c: lane l
// reads w[i] and vals[i] and takes the pseudo-key keys[i] ^ (r * REPLICA_SALT)
// (u32 wrap), so a launch on the unreplicated rows gives, bit for bit, what
// one on host-replicated [B, c * n] rows (replica-major) gives at c = 1.
//
// Bound: latency.  The work is O(c * n + m) per row -- one bin hash and one
// set of ICWS variates per live lane, one gather and a few densify probes per
// bin -- where the ICWS sketch does O(n * m).  The TPU kernel keeps the m-bin
// state resident in VMEM across sequential N tiles and realizes the per-bin
// argmin as a [BR, BM, BN] bin-equality cross (Pallas has no scatter).  On
// Hopper the bin state lives in shared memory and the argmin is a scatter:
// each live lane does one 64-bit atomicMin on (float bits of a) << 32 | lane.
// a > 0, so its bits order as unsigned integers and the packed minimum is the
// smallest a with ties to the lowest lane -- the TPU kernel's strict-< tile
// merge plus argmin -- whatever order the lanes arrive in: bitwise
// deterministic.  A bin no live lane reaches keeps (BIG, ~0): empty.
//
// One row is a thread-block cluster of `cluster` blocks (Hopper distributed
// shared memory), so that a few rows still fill the card.  The blocks split
// the row's lanes, and each keeps the minima of its own lanes for all m bins
// in its shared memory (a 64-bit min is a CAS loop on shared memory, and has
// no form on another block's: the blocks share loads, not atomics).  Block k
// owns bins [k * bpb, (k + 1) * bpb) (bpb even, so a packed word never
// straddles two blocks).  After a cluster barrier each block takes, for each
// own bin, the minimum of the cluster's partial minima (loads through
// map_shared_rank; a min of mins, so the same bits), resolves its winner
// (the level again, with the same arithmetic, so the same bits; fingerprint,
// value, key) and publishes its occupancy bits and its first occupied bin;
// after a second barrier each block gathers the row's whole occupancy mask,
// runs the densify probes of its empty bins against it, reads each borrowed
// bin's planes from the owner's shared memory, and writes its range of the
// four planes.  A last barrier keeps every block's shared memory alive until
// the others' reads are done.  Compiled with -fmad=false and IEEE divides, as
// the ICWS sketch: a contraction could flip a floor.
//
// With Pack (the TPU kernel's pack_vals epilogue, _dmh_kernel_packed) each
// block also writes its bins' words of the row's bf16-halfword plane
// [me / 2] i32 (me = m rounded up to even), the odd-m pad slot as zero;
// empty rows hold value 0 and pack to zero.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "packed.cuh"
#include "u32.cuh"

namespace cg = cooperative_groups;

namespace repro {

constexpr int kDmhMaxThreads = 1024;
constexpr int kDmhMaxCluster = 16;
constexpr int kDmhPortableCluster = 8;

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

// the pseudo-key of replica r of a key
__device__ __forceinline__ uint32_t replica_key(int key, int r) {
  return (uint32_t)key ^ ((uint32_t)r * REPLICA_SALT);
}

template <bool Pack>
__global__ void __launch_bounds__(kDmhMaxThreads)
dmh_sketch_kernel(const float* __restrict__ w, const int* __restrict__ keys,
                  const float* __restrict__ vals, int n, int c, int m, int bpb,
                  uint32_t seed, int J, int* __restrict__ fp_out,
                  float* __restrict__ val_out, float* __restrict__ amin_out,
                  int* __restrict__ key_out, int* __restrict__ packed) {
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int wpb = (bpb + 31) / 32;                          // occupancy words a block
  extern __shared__ unsigned long long s_best[];            // [m] its lanes' (a, lane) minima
  float* s_amin = reinterpret_cast<float*>(s_best + m);     // [bpb] own bins
  int* s_fp = reinterpret_cast<int*>(s_amin + bpb);         // [bpb]
  float* s_val = reinterpret_cast<float*>(s_fp + bpb);      // [bpb]
  int* s_key = reinterpret_cast<int*>(s_val + bpb);         // [bpb]
  unsigned* s_occ = reinterpret_cast<unsigned*>(s_key + bpb);   // [wpb] own bins
  unsigned* s_all = s_occ + wpb;                            // [cs * wpb] the row's
  // [bpb] densified values, over s_best once no block reads it (Pack)
  float* s_dval = reinterpret_cast<float*>(s_best);
  __shared__ int s_first;       // this block's first occupied bin
  __shared__ int s_row_first;   // the row's

  const long long row = blockIdx.x / cs;
  const float* wr = w + row * n;
  const int* kr = keys + row * n;
  const float* vr = vals + row * n;
  const int tid = threadIdx.x;
  const int lo = rank * bpb;                   // this block's first bin
  const int nb = max(0, min(bpb, m - lo));     // bins it owns
  const unsigned long long none =
      ((unsigned long long)__float_as_uint(BIG) << 32) | 0xFFFFFFFFull;

  for (int t = tid; t < m; t += blockDim.x) s_best[t] = none;
  for (int x = tid; x < wpb; x += blockDim.x) s_occ[x] = 0u;
  if (tid == 0) {
    s_first = m;
    s_row_first = m;
  }
  __syncthreads();

  // this block's lanes: a contiguous share of the row's c * n, walked with
  // (r, i) kept beside the lane index
  const int N = n * c;
  const int per = (N + cs - 1) / cs;
  const int l1 = min(N, (rank + 1) * per);
  const uint32_t bin_salt = salt_for(seed, DMH_STREAM_BIN, 0u);
  int l = rank * per + tid;
  int r = l / n, i = l - r * n;
  for (; l < l1; l += blockDim.x) {
    const float wi = wr[i];
    const int ki = kr[i];
    if (wi > 0.f) {
      const uint32_t k = replica_key(ki, r);
      const uint32_t bin = hash_u32(k, bin_salt) % (uint32_t)m;
      float lvl;
      const float a = dmh_rank(k, wi, seed, bin, &lvl);
      atomicMin(&s_best[bin],
                ((unsigned long long)__float_as_uint(a) << 32) | (uint32_t)l);
    }
    for (i += blockDim.x; i >= n; i -= n) ++r;
  }
  cluster.sync();   // every block's minima are in

  // each own bin's minimum over the cluster; an occupied one's winner: its
  // level again (same bits), fingerprint, value and key; its occupancy bit
  // and this block's first occupied bin
  for (int t = tid; t < nb; t += blockDim.x) {
    const int bin = lo + t;
    unsigned long long best = none;
    for (int b0 = 0; b0 < cs; b0 += 4) {   // four blocks' loads in flight at once
      unsigned long long part[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        part[u] = b0 + u < cs ? *cluster.map_shared_rank(s_best + bin, b0 + u) : none;
#pragma unroll
      for (int u = 0; u < 4; ++u) best = part[u] < best ? part[u] : best;
    }
    const float a = __uint_as_float((uint32_t)(best >> 32));
    s_amin[t] = a;
    if (a < BIG) {
      const int lw = (int)(uint32_t)(best & 0xFFFFFFFFull);
      const int rw = lw / n, iw = lw - rw * n;
      const uint32_t k = replica_key(kr[iw], rw);
      float lvl;
      dmh_rank(k, wr[iw], seed, (uint32_t)bin, &lvl);
      const uint32_t lv = (uint32_t)(int)lvl;
      const uint32_t bits = hash_u32(k ^ (lv * 0x9E3779B9u),
                                     salt_for(seed, DMH_STREAM_FP, (uint32_t)bin));
      s_fp[t] = (int)(bits & 0x7FFFFFFFu);
      s_val[t] = vr[iw];
      s_key[t] = (int)k;
      atomicOr(&s_occ[t >> 5], 1u << (t & 31));
      atomicMin(&s_first, bin);
    }
  }
  cluster.sync();

  // the row's occupancy mask and first occupied bin, from every block
  for (int x = tid; x < cs * wpb; x += blockDim.x) {
    const int b = x / wpb;
    s_all[x] = *cluster.map_shared_rank(s_occ + (x - b * wpb), b);
  }
  if (tid < cs) atomicMin(&s_row_first, *cluster.map_shared_rank(&s_first, tid));
  __syncthreads();
  const int first = s_row_first;

  // densify: an empty bin of a live row borrows every plane from the first
  // probe that lands on an occupied bin, else from the first occupied bin
  const long long o = row * m;
  for (int t = tid; t < nb; t += blockDim.x) {
    const int bin = lo + t;
    int src = bin;
    if (!(s_amin[t] < BIG)) {
      if (first >= m) {   // an empty row
        fp_out[o + bin] = -1;
        val_out[o + bin] = 0.f;
        amin_out[o + bin] = s_amin[t];
        key_out[o + bin] = 0;
        s_dval[t] = 0.f;
        continue;
      }
      src = first;
      for (int j = 0; j < J; ++j) {
        const int p = (int)(hash_u32((uint32_t)bin,
                                     salt_for(seed, DMH_STREAM_DENSIFY, (uint32_t)j))
                            % (uint32_t)m);
        const int b = p / bpb, x = p - b * bpb;
        if ((s_all[b * wpb + (x >> 5)] >> (x & 31)) & 1u) {
          src = p;
          break;
        }
      }
    }
    const int b = src / bpb, x = src - b * bpb;
    const float v = *cluster.map_shared_rank(s_val + x, b);
    fp_out[o + bin] = *cluster.map_shared_rank(s_fp + x, b);
    val_out[o + bin] = v;
    amin_out[o + bin] = *cluster.map_shared_rank(s_amin + x, b);
    key_out[o + bin] = *cluster.map_shared_rank(s_key + x, b);
    s_dval[t] = v;
  }
  if (Pack) {
    __syncthreads();   // this block's densified values are in s_dval
    const long long mw = (m + 1) / 2;
    for (int k = tid; 2 * k < nb; k += blockDim.x) {
      const float v0 = s_dval[2 * k];
      const float v1 = 2 * k + 1 < nb ? s_dval[2 * k + 1] : 0.f;
      packed[row * mw + lo / 2 + k] = (int)(pack_half(v0, 0) | pack_half(v1, 1));
    }
  }
  cluster.sync();   // no block leaves while another reads its shared memory
}

// bins each block of a cluster owns: m over the cluster, rounded up to even
static int bins_per_block(int m, int cluster) {
  const int bpb = (m + cluster - 1) / cluster;
  return bpb + (bpb & 1);
}

static size_t dmh_smem(int m, int cluster) {
  const int bpb = bins_per_block(m, cluster), wpb = (bpb + 31) / 32;
  return (size_t)m * sizeof(unsigned long long) + (size_t)bpb * 4 * sizeof(int) +
         (size_t)(cluster + 1) * wpb * sizeof(unsigned);
}

cudaError_t launch_dmh_sketch(const float* w, const int* keys, const float* vals,
                              int B, int n, int c, int m, uint32_t seed, int J,
                              int cluster, int threads, int* fp, float* val,
                              float* amin, int* argkey, int* packed,
                              cudaStream_t stream) {
  if (B < 1 || n < 1 || c < 1 || m < 1 || J < 1 || cluster < 1 ||
      cluster > kDmhMaxCluster || threads < 32 || threads > kDmhMaxThreads ||
      threads % 32 || (long long)n * c > INT_MAX || (long long)B * cluster > INT_MAX)
    return cudaErrorInvalidValue;
  auto kernel = packed ? dmh_sketch_kernel<true> : dmh_sketch_kernel<false>;
  cudaError_t err = cudaSuccess;
  if (dmh_smem(m, 1) > 48 * 1024) {   // the most any cluster size takes
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)dmh_smem(m, 1));
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3((unsigned)threads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  auto shape = [&](int size) {
    attr[0].val.clusterDim.x = (unsigned)size;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3((unsigned)(B * size));
    cfg.dynamicSmemBytes = dmh_smem(m, size);
  };
  shape(cluster);
  if (cluster > kDmhPortableCluster) {
    // a non-portable cluster size: allowed explicitly, and taken only where
    // the card can hold such a cluster of these blocks; else the portable
    // size (the bits do not depend on the cluster)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    int fit = 0;
    err = cudaOccupancyMaxActiveClusters(&fit, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (fit < 1) shape(cluster = kDmhPortableCluster);
  }
  err = cudaLaunchKernelEx(&cfg, kernel, w, keys, vals, n, c, m,
                           bins_per_block(m, cluster), seed, J, fp, val, amin, argkey,
                           packed);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace repro

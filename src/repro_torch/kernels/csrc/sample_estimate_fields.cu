// Fused multi-field key-match estimates of the sampling sketches (TS/PS) for
// Hopper: one body, two kernels.
//
//   sample_estimate_fields_kernel         B9, repro/kernels/sample_estimate.py::
//                                         _sample_fields_kernel (launcher
//                                         sample_estimate_fields_pallas)
//   sample_estimate_fields_packed_kernel  B13, ::_sample_fields_packed_kernel
//                                         (launcher
//                                         sample_estimate_fields_packed_pallas)
//
// For each field pair g = (qmap[g], cmap[g]) and each (q, p):
//   est[g, q, p] = sum_{t,u} 1[kq == kc and kq >= 0 and min(aq, ac) > 0]
//                  * vq * vc / min(aq, ac)
// kq/vq/aq [F, Q, Sq] contiguous; the corpus keys kc [C, P, Sc] and taus
// tc [C, P] with any field and row stride (a tenant slice of the store's
// buffers needs no copy).  B9 takes the corpus values as f32 vc [C, P, Sc]
// (Sc = Sq), B13 as bf16-halfword words wc [C, P, Sc / 2] (Sc = Sq rounded
// up to even, the pad slot's key -2), decoded where a match reads them
// (word u >> 1, halfword u & 1).  Neither takes a corpus probability plane:
// a matched slot's probability ac is computed where it is found, from the
// slot's value and its row's tau, in the operation order of
// sample_estimate.py::_inclusion_probs: min(1, (s_total * v) * v / tau), 1
// where tau <= 0, 0 where v == 0, s_total the query's slot count Sq.  So
// B9 on (kc, vc, tc) gives the bits of the plain version on (kc, vc,
// sample_inclusion_probs(vc, tc)), and B13 on (kc, wc, tc) B9's bits on
// (kc, unpack(wc), tc).
//
// Row layout (ingest's pad_sample_batch): the live keys (>= 0) of a row are
// unique and strictly ascending in its leading slots, every later slot
// negative.  So a key that matches at query slot t and corpus slot u orders
// all matches of a (q, p) pair alike in t and in u, and adding a pair's
// terms in ascending u adds them in ascending t: the plain version's order
// (the full cross summed over u, then over t), with one __fadd_rn per
// match from +0 (an unmatched t adds +0 there, which changes no bit).
//
// Design: a probe of each live corpus key against the query's keys.  The
// (query, pair) items, numbered n = q * G + g, are split into groups of
// `per` consecutive ones (at most 32, as many as GROUP_BYTES of shared
// memory hold: sample_estimate.py::items_per_block).  A block of 32 warps,
// one an SM, builds for its group one hash table per corpus field holding
// the live keys of every item that reads the field -- each entry a key
// with the item and query slot t it came from; a thread loads eight query
// keys at once before it inserts them -- then walks a tile of corpus rows:
// a warp takes one (row, corpus field) at a time (the next one from a
// block counter, so that warps that drew rows with many matches take
// fewer) and reads its keys coalesced, 32 slots a step, four steps (a
// chunk) asked for at once, the next chunk once this one is known to be
// live to its end; it stops after the chunk that holds the row's first
// negative key (pads and spare rows past that chunk are never read).  Each lane looks
// its four keys up at once, in the field's table, for all of the field's
// items together (1-3 items at Q = 1 for the service's six pairs), and
// notes which items hold each.  Only a chunk where some lane found a key
// goes on: per step, the corpus value and its probability once a lane,
// then item by item vq[t], aq[t] and the term x * v / min(aq, ac) (a
// separate multiply and an IEEE divide); a ballot of the lanes with a live
// term and a loop over its set bits in ascending lane (= ascending u)
// order hands each term by shuffle to the lane that holds the item's sum,
// one add a match.  No atomics on floats; one store per (g, q, p).
//
// The tables: open addressing over buckets of four slots (one 16-byte
// shared load a bucket), one bucket a query slot of each item (at most a
// quarter full: a bucket that is full, and sends the lookup on to the
// next, is rare), the first bucket from a Fibonacci hash, linear probing
// from bucket to bucket; built with an integer CAS slot by slot, so a
// lookup that meets an empty slot has seen every entry of its key, and
// what it returns does not depend on the order of insertion.  A key that
// several items hold has an entry for each.
//
// Bound: the corpus keys read once (bytes) at Q = 1; past one group (Q =
// 16) each group reads the rows again and looks each key up again.
// PERF.md has the measured times: about seven times the byte bound at
// Q = 1, where the lookups' latency and the block's table build, which one
// wave of blocks overlaps with nothing, take the time.
#include <cuda_runtime.h>
#include <cstdint>

#include "packed.cuh"

namespace repro {
namespace {

constexpr int kMaxPairs = 16;
constexpr int kWarps = 32;
constexpr int kThreads = kWarps * 32;
// The geometry that sample_estimate.py mirrors (MAX_ITEMS, SLOT_BYTES,
// CHUNK_STEPS) for its launch plan and the lookup count of the issue floor.
constexpr int kMaxItems = 32;          // items a block serves (a lane each)
constexpr int kSlotBytes = 32;         // table bytes a query slot of an item:
                                       // a bucket of four keys, four entries
constexpr int kSteps = 4;              // 32-slot steps of a row asked for at once
constexpr int kBatch = 8;              // query slots a thread inserts at once
constexpr unsigned kFull = 0xffffffffu;
constexpr int kEmpty = -1;             // a free slot (live keys are >= 0)

struct SampleMap {
  int q[kMaxPairs];
  int c[kMaxPairs];
  int order[kMaxPairs];                // pairs sorted by corpus field
};

// One corpus field's items in a block: items [first, end) of the block's
// list and their table, nb buckets at int offset tab: nb int4 of keys, then
// nb int4 of entries (item - first) << 16 | t.
struct Segment {
  int cf, first, end, tab, nb;
};

// the probability of a stored value v under its row's tau
__device__ __forceinline__ float inclusion_prob(float v, float tau, float s_total) {
  if (v == 0.f) return 0.f;
  if (!(tau > 0.f)) return 1.f;
  const float p = __fdiv_rn(__fmul_rn(__fmul_rn(s_total, v), v), tau);
  return p > 1.f ? 1.f : p;
}

__device__ __forceinline__ float slot_value(const float* row, int u) { return row[u]; }
__device__ __forceinline__ float slot_value(const int* row, int u) {
  return unpack_at(row, u);
}

__device__ __forceinline__ int first_bucket(int k, int nb) {
  return (int)__umulhi((unsigned)k * 0x9E3779B1u, (unsigned)nb);
}

// The items whose entries in bucket `e` (its entries at `en`) hold key k,
// as a bit mask; `open` whether the bucket has a free slot (then no later
// bucket holds an entry of k).
__device__ __forceinline__ unsigned scan(const int4& e, const int* en, int k,
                                         bool& open) {
  unsigned items = 0;
  if (e.x == k) items |= 1u << (en[0] >> 16);
  if (e.y == k) items |= 1u << (en[1] >> 16);
  if (e.z == k) items |= 1u << (en[2] >> 16);
  if (e.w == k) items |= 1u << (en[3] >> 16);
  open = e.x == kEmpty || e.y == kEmpty || e.z == kEmpty || e.w == kEmpty;
  return items;
}

__device__ __forceinline__ int next_bucket(int b, int nb) { return b + 1 == nb ? 0 : b + 1; }

// bucket b's four keys in one 16-byte shared load (nvcc splits a plain int4
// load from this table into four)
__device__ __forceinline__ int4 bucket_keys(const int* tab, int b) {
  int4 e;
  const unsigned addr = (unsigned)__cvta_generic_to_shared(tab + 4 * b);
  asm volatile("ld.shared.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(e.x), "=r"(e.y), "=r"(e.z), "=r"(e.w)
               : "r"(addr));
  return e;
}

// the query slot t of item i's entry of key k >= 0 (the caller knows it has one)
__device__ __forceinline__ int slot_of(const int* tab, int nb, int k, int i) {
  const int* keys = tab;
  const int* en = tab + 4 * nb;
  for (int b = first_bucket(k, nb);; b = next_bucket(b, nb)) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (keys[4 * b + j] == k && (en[4 * b + j] >> 16) == i)
        return en[4 * b + j] & 0xffff;
  }
}

// The terms of one step: 32 consecutive corpus slots, one a lane, whose
// keys were found among the entries of the items in `hits`.  Item by item,
// the lanes that hold one add their terms, in ascending lane (= ascending
// u) order, into the sum that lane i holds for item i.
template <class V>
__device__ __forceinline__ void add_terms(
    unsigned hits, int k, int u, int lane, const int* tab, int nb, const long long* qos,
    const float* __restrict__ vq, const float* __restrict__ aq,
    const V* __restrict__ vrow, float tau, float s_total, float& acc) {
  float v = 0.f, c = 0.f;
  if (hits) {
    v = slot_value(vrow, u);
    c = inclusion_prob(v, tau, s_total);
  }
  for (unsigned any = __reduce_or_sync(kFull, hits); any; any &= any - 1) {
    const int i = __ffs(any) - 1;
    float term = 0.f;
    bool ok = false;
    if ((hits >> i) & 1) {
      const int t = slot_of(tab, nb, k, i);
      const long long qo = qos[i];
      const float pr = fminf(__ldg(aq + qo + t), c);
      ok = pr > 0.f;
      term = __fdiv_rn(__fmul_rn(__ldg(vq + qo + t), v), pr);
    }
    for (unsigned m = __ballot_sync(kFull, ok); m; m &= m - 1) {
      const float y = __shfl_sync(kFull, term, __ffs(m) - 1);
      if (lane == i) acc = __fadd_rn(acc, y);
    }
  }
}

template <class V>
__device__ __forceinline__ void estimate_body(
    const int* __restrict__ kq, const float* __restrict__ vq,
    const float* __restrict__ aq, const int* __restrict__ kc, const V* __restrict__ vc,
    const float* __restrict__ tc, long long kc_fs, long long kc_rs, long long vc_fs,
    long long vc_rs, long long tc_fs, long long tc_rs, const SampleMap& maps, int G,
    int Q, int P, int Sq, int Sc, int per, int groups, int tile,
    float* __restrict__ out) {
  extern __shared__ __align__(16) int tabs[];
  __shared__ Segment seg[kMaxPairs];
  __shared__ long long item_qo[kMaxItems];     // the item's query row in kq/vq/aq
  __shared__ int item_g[kMaxItems], item_q[kMaxItems], item_seg[kMaxItems];
  __shared__ int n_seg, n_items, tab_ints, next_unit;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = (blockIdx.x % groups) * per;
  const int n1 = min(n0 + per, G * Q);
  const int p0 = (blockIdx.x / groups) * tile;
  const int rows = min(tile, P - p0);

  // the group's items, grouped by corpus field, and the fields' tables
  if (tid == 0) {
    int n = 0, ns = 0, ints = 0;
    for (int gi = 0; gi < G;) {
      const int cf = maps.c[maps.order[gi]];
      const int first = n;
      int ge = gi;
      for (; ge < G && maps.c[maps.order[ge]] == cf; ++ge) {
        const int g = maps.order[ge];
        for (int q = n0 / G; q <= (n1 - 1) / G; ++q) {
          if (q * G + g < n0 || q * G + g >= n1) continue;
          item_g[n] = g;
          item_q[n] = q;
          item_seg[n] = ns;
          item_qo[n] = ((long long)maps.q[g] * Q + q) * Sq;
          ++n;
        }
      }
      if (n > first) {
        const int nb = (n - first) * Sq;   // a bucket of four a query slot
        seg[ns] = Segment{cf, first, n, ints, nb};
        ints += kSlotBytes / 4 * nb;
        ++ns;
      }
      gi = ge;
    }
    n_seg = ns;
    n_items = n;
    tab_ints = ints;
    next_unit = kWarps;
  }
  __syncthreads();
  for (int i = tid; i < tab_ints; i += kThreads) tabs[i] = kEmpty;
  __syncthreads();
  // the entries, kBatch query slots a thread at a time, their keys loaded
  // together
  for (int i0 = tid; i0 < n_items * Sq; i0 += kBatch * kThreads) {
    int key[kBatch];
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      const int i = i0 + r * kThreads;
      key[r] = i < n_items * Sq ? kq[item_qo[i / Sq] + i % Sq] : -1;
    }
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      const int i = i0 + r * kThreads, k = key[r];
      if (k < 0) continue;
      const int n = i / Sq, t = i - n * Sq;
      const Segment s = seg[item_seg[n]];
      int* keys = tabs + s.tab;
      int b = first_bucket(k, s.nb);
      for (int j = 0;; ++j) {
        if (j == 4) {
          j = 0;
          b = next_bucket(b, s.nb);
        }
        if (atomicCAS(keys + 4 * b + j, kEmpty, k) == kEmpty) {
          keys[4 * s.nb + 4 * b + j] = (n - s.first) << 16 | t;
          break;
        }
      }
    }
  }
  __syncthreads();

  const float s_total = (float)Sq;
  const int units = n_seg * rows;
  for (int w = warp; w < units;) {
    const int si = w / rows;
    const int p = p0 + (w - si * rows);
    const Segment s = seg[si];
    const int* tab = tabs + s.tab;
    const int* en = tab + 4 * s.nb;
    const int* krow = kc + s.cf * kc_fs + p * kc_rs;
    const V* vrow = vc + s.cf * vc_fs + p * vc_rs;
    const float tau = __ldg(tc + s.cf * tc_fs + p * tc_rs);
    float acc = 0.f;
    // the row's keys kSteps steps (a chunk) at a time, one load a step in
    // flight for each; the next chunk is asked for once this one is known
    // to be live to its end.  Past the live prefix a key is negative: it
    // finds nothing and adds nothing.
    int k[kSteps], kn[kSteps];
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const int u = 32 * j + lane;
      k[j] = u < Sc ? __ldg(krow + u) : -1;
    }
    for (int c0 = 0;; c0 += 32 * kSteps) {
      const bool full = __all_sync(kFull, k[kSteps - 1] >= 0);
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        const int u = c0 + 32 * (kSteps + j) + lane;
        kn[j] = full && u < Sc ? __ldg(krow + u) : -1;
      }
      // the chunk's lookups: each key's first bucket, all four at once
      int b[kSteps];
      int4 e[kSteps];
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        b[j] = first_bucket(k[j], s.nb);
        e[j] = bucket_keys(tab, b[j]);
      }
      unsigned hits[kSteps];
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        bool open = true;
        hits[j] = k[j] >= 0 ? scan(e[j], en + 4 * b[j], k[j], open) : 0u;
        for (int bb = b[j]; !open;) {
          bb = next_bucket(bb, s.nb);
          hits[j] |= scan(bucket_keys(tab, bb), en + 4 * bb, k[j], open);
        }
      }
      unsigned any = 0;
#pragma unroll
      for (int j = 0; j < kSteps; ++j) any |= hits[j];
      if (__any_sync(kFull, any != 0)) {
#pragma unroll
        for (int j = 0; j < kSteps; ++j)
          add_terms(hits[j], k[j], c0 + 32 * j + lane, lane, tab, s.nb, item_qo + s.first,
                    vq, aq, vrow, tau, s_total, acc);
      }
      if (!full) break;
#pragma unroll
      for (int j = 0; j < kSteps; ++j) k[j] = kn[j];
    }
    if (lane < s.end - s.first)
      out[((long long)item_g[s.first + lane] * Q + item_q[s.first + lane]) * P + p] =
          acc;
    // the block's next unit: warps that drew rows with many matches take
    // fewer units
    if (lane == 0) w = atomicAdd(&next_unit, 1);
    w = __shfl_sync(kFull, w, 0);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
sample_estimate_fields_kernel(const int* __restrict__ kq, const float* __restrict__ vq,
                              const float* __restrict__ aq, const int* __restrict__ kc,
                              const float* __restrict__ vc, const float* __restrict__ tc,
                              long long kc_fs, long long kc_rs, long long vc_fs,
                              long long vc_rs, long long tc_fs, long long tc_rs,
                              SampleMap maps, int G, int Q, int P, int Sq, int Sc,
                              int per, int groups, int tile, float* __restrict__ out) {
  estimate_body(kq, vq, aq, kc, vc, tc, kc_fs, kc_rs, vc_fs, vc_rs, tc_fs, tc_rs, maps,
                G, Q, P, Sq, Sc, per, groups, tile, out);
}

__global__ void __launch_bounds__(kThreads, 1)
sample_estimate_fields_packed_kernel(
    const int* __restrict__ kq, const float* __restrict__ vq,
    const float* __restrict__ aq, const int* __restrict__ kc,
    const int* __restrict__ wc, const float* __restrict__ tc, long long kc_fs,
    long long kc_rs, long long wc_fs, long long wc_rs, long long tc_fs,
    long long tc_rs, SampleMap maps, int G, int Q, int P, int Sq, int Sc, int per,
    int groups, int tile, float* __restrict__ out) {
  estimate_body(kq, vq, aq, kc, wc, tc, kc_fs, kc_rs, wc_fs, wc_rs, tc_fs, tc_rs, maps,
                G, Q, P, Sq, Sc, per, groups, tile, out);
}

template <class V>
using SampleKernel = void (*)(const int*, const float*, const float*, const int*,
                              const V*, const float*, long long, long long, long long,
                              long long, long long, long long, SampleMap, int, int, int,
                              int, int, int, int, int, float*);

// One launch: blocks of `per` items (sample_estimate.py::items_per_block),
// whose tables take kSlotBytes per Sq bytes (a field of n items takes n Sq
// buckets of four keys and four entries), and row tiles sized so that the grid
// fills the card once.
template <class V>
cudaError_t launch(SampleKernel<V> kernel, const int* kq, const float* vq,
                   const float* aq, const int* kc, const V* vc, const float* tc,
                   long long kc_fs, long long kc_rs, long long vc_fs, long long vc_rs,
                   long long tc_fs, long long tc_rs, const int* qmap, const int* cmap,
                   int G, int Q, int P, int Sq, int Sc, int per, float* out,
                   cudaStream_t stream) {
  if (G < 1 || G > kMaxPairs || Q < 1 || P < 1 || Sq < 1 || Sq > 0xffff || per < 1 ||
      per > kMaxItems)
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
  const long long groups = ((long long)G * Q + per - 1) / per;
  const size_t smem = (size_t)kSlotBytes * per * Sq;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidValue;
  long long tiles = ((long long)sms * per_sm + groups - 1) / groups;
  tiles = tiles < P ? tiles : P;
  const int tile = (int)((P + tiles - 1) / tiles);
  tiles = (P + tile - 1) / tile;
  if (tiles * groups > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)(tiles * groups), kThreads, smem, stream>>>(
      kq, vq, aq, kc, vc, tc, kc_fs, kc_rs, vc_fs, vc_rs, tc_fs, tc_rs, maps, G, Q, P,
      Sq, Sc, per, (int)groups, tile, out);
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_sample_estimate_fields(
    const int* kq, const float* vq, const float* aq, const int* kc, const float* vc,
    const float* tc, long long kc_fs, long long kc_rs, long long vc_fs,
    long long vc_rs, long long tc_fs, long long tc_rs, const int* qmap,
    const int* cmap, int G, int Q, int P, int S, int per, float* out,
    cudaStream_t stream) {
  return launch<float>(sample_estimate_fields_kernel, kq, vq, aq, kc, vc, tc, kc_fs,
                       kc_rs, vc_fs, vc_rs, tc_fs, tc_rs, qmap, cmap, G, Q, P, S, S, per,
                       out, stream);
}

cudaError_t launch_sample_estimate_fields_packed(
    const int* kq, const float* vq, const float* aq, const int* kc, const int* wc,
    const float* tc, long long kc_fs, long long kc_rs, long long wc_fs,
    long long wc_rs, long long tc_fs, long long tc_rs, const int* qmap,
    const int* cmap, int G, int Q, int P, int Sq, int Sc, int per, float* out,
    cudaStream_t stream) {
  if (Sc < 2 || Sc % 2) return cudaErrorInvalidValue;
  return launch<int>(sample_estimate_fields_packed_kernel, kq, vq, aq, kc, wc, tc,
                     kc_fs, kc_rs, wc_fs, wc_rs, tc_fs, tc_rs, qmap, cmap, G, Q, P, Sq,
                     Sc, per, out, stream);
}

}  // namespace repro

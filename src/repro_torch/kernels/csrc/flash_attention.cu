// Forward flash attention for Hopper: two kernels behind one launcher.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_flash_kernel
// (launcher flash_attention_pallas).
// q [BH, T, D], k/v [BH / group, S, D], f32 or bf16 -> o [BH, T, D] in the
// input type; q head bh reads kv head bh / group (no kv copy).  Per row:
// scores s, masked scores -1e30 (causal: k_pos <= q_pos; window: k_pos >
// q_pos - window), an online softmax over key tiles from m = -inf (corr =
// exp(m - m_new), p = exp(s - m_new), l = l corr + sum p, all in f32), and
// o = acc / max(l, 1e-30).  A key past S adds nothing; a row that sees no key
// at all gets the mean of v, as on the TPU: its masked scores tie at -1e30,
// p = 1 on every key.
//
// Route, static, by type alone (launch_flash_attention): f32 inputs run
// flash_attention_f32tc_kernel and bf16 inputs flash_attention_tc_kernel,
// both on the tensor cores, at every D up to 256.  A refused launch returns
// its error; nothing falls back.
//
// flash_attention_tc_kernel (bf16, tensor cores): s = (q k^T) * (1/sqrt(D)),
// the bf16 products exact in f32 and summed in f32 by wgmma, then scaled (for
// D = 16, 64 and 256 the scale is a power of two, so this is the TPU kernel's
// (q scale) k^T up to the order of the sum).  The mask and softmax are the f32
// steps above, in registers.  Then acc = acc corr + p_hi v + p_lo v, with
// p_hi = bf16(p) and p_lo = bf16(p - p_hi): two bf16 wgmmas into one f32
// accumulator.  The pair carries p to about 16 bits (a single bf16 cast: 8),
// so the output stays within one bf16 rounding step of the f32 function; l
// sums the f32 p.  One block of two warpgroups (256 threads) per (bh, 128
// query rows), heaviest causal rows first (at DP = 256 head by head within
// each band of rows, about 10% faster at Gemma-7B's shape); each warpgroup
// owns 64 rows.  The unscaled q tile stays in shared memory; k and v tiles
// of 64 keys, shared by both warpgroups, are double-buffered by TMA (one
// thread issues a 4-d box a tile, an mbarrier a stage counts its bytes; rows
// past S and dims past D land as zeros).  Shared tiles use wgmma's
// unswizzled layout: 8-row by 16-byte core matrices, a tile [D / 8][rows] of
// 16-byte chunks, which the tensor map writes directly (its chunk dim
// strides 16 bytes, its row dim 2 D).
// S = Q K^T is an SS wgmma m64n64k16 (K-major, D contiguous); p_hi and p_lo
// are packed from the S accumulators straight into A-operand registers (the
// accumulator and A fragments share their layout), and O += P V is an RS
// wgmma m64nDPk16 with v read MN-major (the transpose flag), DP the head dim
// rounded up to 16, 32, 64, 128 or 256 (zero-filled dims add exact zeros; at
// DP = 256, two m64n128k16 on the two halves of v, and a block's q tile and
// two k/v stages take 196,624 bytes of shared memory, one block a SM).  What
// bounds it on the card is the CUDA cores: per (query, key) pair about 20
// instructions (scale, max, an IEEE expf, sum, the split), against 6
// tensor-core operations per dim.
//
// Loads of flash_attention_tc_kernel.  Where D % 8 == 0 a row is D / 8 whole
// 16-byte chunks and TMA lands the tiles as above (dims past D up to DP as
// zero chunks).  Where D % 8 != 0 (D = 28: rows of 56 bytes) no tensor map
// describes the rows (a row's stride, 2 D bytes, is not a multiple of 16), so
// the BYVAL instance reads them by value: the block's threads load q, k and v
// rows (zeros past D and past S; a 4-byte word a load where D is even and the
// bases 4-byte aligned, else a bf16 value a load, any 2-byte aligned base)
// and store them as 16-byte chunks into the same unswizzled layout, chunk (g,
// i) = row i's dims 8g .. 8g + 7, each eight neighbouring threads taking
// eight neighbouring rows so that their stores do not collide.  The q tile
// and the first k/v tile are stored before the loop.  Each later k/v tile is
// loaded into registers while the P V of the tile two before it runs, held
// across that tile's barrier, and stored into its stage after the next S
// (the stage freed by the barrier before, published by the barrier after,
// behind a proxy fence: wgmma reads shared memory through the async proxy).
// The loads so have P V, a barrier and S to land, and no register of them is
// live in the softmax, where the kernel's registers peak.  No mbarrier, no
// padded copy of q, k or v.  The function does not change: dims past D add
// exact zeros to q k^T and give output columns that are never stored, and
// the scale stays 1/sqrt(D) of the true D.
//
// flash_attention_f32tc_kernel (f32, tensor cores): the TPU kernel's f32
// function within f32 rounding.  q (1/sqrt(D)) in f32; q scale, k and v each
// split into three bf16 parts (b0 = bf16(x), b1 = bf16(x - b0), b2 = bf16(x -
// b0 - b1): for a normal x they sum to x exactly); s = the six part-products
// b0c0, b0c1, b1c0, b0c2, b1c1, b2c0 summed in f32 wgmma accumulators (the
// dropped ones are 2^-24 of s and below); the f32 mask and softmax as
// above; p split the same way and acc = acc corr + its six part-products
// with v; l sums the f32 p.  One TF32 pass, or two bf16 parts of q and k,
// would break the 5e-5 gate against the f32 function.  Up to DP = 128 one
// block of G warpgroups per (bh, 64 G query rows): G = 4 up to DP = 64, 2 at
// DP = 128 (147 and 196 KB of shared memory, one block a SM).  The block
// splits its scaled q tile once into three unswizzled part tiles (the layout
// above); each k/v tile of 64 keys is read into registers with 16-byte loads
// (D % 4 == 0, else by value; rows past S and dims past D as zeros) while
// the previous tile's products run, then split by the block's threads into
// six part tiles shared by the warpgroups: the split is the only place f32
// becomes bf16.  Per tile: six SS wgmma m64n64k16 per 16 dims for S; the
// softmax; six RS m64nDPk16 per 16 keys for O (p's parts packed from the S
// accumulators, v MN-major).  The warpgroups run in step (a barrier a tile),
// so four (or two) chains of dependent products share the tensor cores;
// handing the tensor cores from one warpgroup to another (a producer
// warpgroup doing the split) left one chain in flight and ran slower.
// 128 < D <= 256 (DP = 256, dims past D as zeros): the whole row's 256 f32
// output accumulators do not fit one thread's registers beside the
// prefetched k and v, nor do three q, k and v part tiles of 64 keys fit
// shared memory, so one block of two warpgroups per (bh, 64 query rows)
// splits the head dim: warpgroup w owns output dims [128 w, 128 w + 128)
// (64 accumulators a thread), stages and splits its own dims of q, k and v
// (a named barrier of its 128 threads), and over key tiles of 32 computes
// the partial s over its dims (six SS m64n32k16 per 16 dims).  The two
// partials meet in shared memory (double-buffered by the tile's parity, one
// __syncthreads a tile); both warpgroups form s_0 + s_1, so both hold the
// same bits and run the same softmax, and each takes p v on its half of v
// (six RS m64n128k16 per 16 keys).  The loop is pipelined: v's parts are
// split while S runs and the next tile's k parts while P V runs (3% faster
// than splitting both before S).  The tensor work stays 24 operations a
// pair and dim (each warpgroup taking the whole s, 36, ran 14% slower);
// shared memory is 229,376 bytes, one block a SM.  The grid
// goes out head by head within each band of rows, the longest causal rows
// first, so the last blocks to run are the shortest.  What bounds it: 24
// tensor-core operations per visible pair and dim (0.42 ms at TinyLlama's
// shape, under the CUDA cores' 4-op floor of 1.03 ms).
//
// All kernels: every sum runs in an order fixed by the tile sizes (no float
// atomics, no TF32, no fast math), so a head gives the same bits alone or in
// a batch, and every run the same bits.  A key tile masked for every row of
// the block is skipped when every row of the block sees some key: for such
// a row the tile adds p = 0 and multiplies by corr = 1.  Otherwise (a row
// with no visible key) every tile is taken, and the row's p = 1 on every
// key (a bf16 1 exactly), the mean of v.
//
// Bound: operations at the bf16 tensor-core rate, per head and visible (query,
// key) pair and dim: the bf16 kernel 6 (q k^T once, p v twice), the f32 one
// 24 (six part-products each).  The bytes are q, k, v read once and o written
// once.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstdint>

namespace repro {

constexpr float kFaNeg = -1e30f;  // the TPU kernel's masked score

// ---------------------------------------------------------------------------
// flash_attention_tc_kernel: bf16 on the tensor cores (see the note above).
// ---------------------------------------------------------------------------
constexpr int kTcKeys = 64;  // keys per tile
constexpr int kTcGroups = 2;  // warpgroups per block, each 64 query rows

// wgmma shared-memory descriptor, no swizzle: start, LBO and SBO in bytes
__device__ __forceinline__ uint64_t tc_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// mbarrier and TMA (cp.async.bulk.tensor) helpers
__device__ __forceinline__ void tc_mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void tc_mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void tc_mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}
__device__ __forceinline__ void tc_tma(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                       int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tc_wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void tc_wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void tc_wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator reads or writes across a wgmma
template <int N>
__device__ __forceinline__ void tc_fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64, N] (+)= A[64, 16] B[16, N], bf16 in, f32 accumulators.  SS: A and B
// K-major in shared memory.  RS: A from registers, B MN-major (transposed).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// SS over a key tile of N = 64 or 32
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b,
                                         int accumulate) {
  static_assert(N == 64 || N == 32, "key tile of 64 or 32");
  if constexpr (N == 64) wgmma_ss_n64(d, a, b, accumulate);
  else wgmma_ss_n32(d, a, b, accumulate);
}

__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// DP = 256: two m64n128k16 on the two halves of the output dims; the second
// half's B starts 16 SBO strides (16 groups of 8 dims, MN-major) further on
template <int DP>
__device__ __forceinline__ void wgmma_rs(float (&d)[DP / 2], const uint32_t* a,
                                         uint64_t b) {
  if constexpr (DP == 16) wgmma_rs_n16(d, a, b);
  else if constexpr (DP == 32) wgmma_rs_n32(d, a, b);
  else if constexpr (DP == 64) wgmma_rs_n64(d, a, b);
  else if constexpr (DP == 128) wgmma_rs_n128(d, a, b);
  else {
    static_assert(DP == 256, "head-dim tile of 16, 32, 64, 128 or 256");
    wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(d), a, b);
    const uint64_t sbo = (b >> 32) & 0x3FFF;  // in 16-byte units, as the start
    wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(d + 64), a, b + 16 * sbo);
  }
}

__device__ __forceinline__ uint32_t tc_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}


// The pair (a, b) split into PARTS bf16 pairs, packed as wgmma operands (a in
// the low half): part 0 = bf16(x), each next part the bf16 rounding of what
// the earlier ones leave (the residuals are exact in f32), so three parts sum
// to a normal x exactly.
template <int PARTS>
__device__ __forceinline__ void tc_split_pair(float a, float b, uint32_t (&w)[PARTS]) {
#pragma unroll
  for (int j = 0; j < PARTS; ++j) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    w[j] = tc_bits(h);
    if (j + 1 < PARTS) {
      const float2 f = __bfloat1622float2(h);
      a = __fsub_rn(a, f.x);
      b = __fsub_rn(b, f.y);
    }
  }
}

// The f32 softmax step of one key tile on a warp's S fragment (rows r0 and
// r0 + 8): scale (SCALED; the f32 kernel's q comes scaled), mask, row max over
// the quad, corr, p = exp(s - m_new), this thread's share of the row sums, and
// p split into PARTS bf16 parts packed as wgmma A operands (pp[j][i] holds
// part j of the pair s[2i], s[2i + 1], row r0 for even i).  The maxima and
// sums run in four interleaved parts for the instruction-level parallelism,
// combined in a fixed order.
template <int NS, int PARTS, bool SCALED>
__device__ __forceinline__ void tc_softmax(float (&s)[NS], uint32_t (&pp)[PARTS][NS / 2],
                                           float& m0, float& m1, float& l0, float& l1,
                                           float& corr0, float& corr1, bool full,
                                           long long d0, int c0, int causal, int window,
                                           int keys, float scale) {
  float mx[2][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) mx[0][j] = mx[1][j] = -CUDART_INF_F;
  if (full) {  // every row sees every key of the tile
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      if constexpr (SCALED) s[i] = __fmul_rn(s[i], scale);
      mx[(i >> 1) & 1][(i >> 2) & 3] = fmaxf(mx[(i >> 1) & 1][(i >> 2) & 3], s[i]);
    }
  } else {
    // column col (less this thread's first column c0) of row r is visible
    // iff lo_r < col <= hi_r, and a key at all iff col < kc; d0 is row r0's
    // position less the tile's first key
    auto bound = [&](long long x) { return (int)max(-2LL, min(x, 70LL)) - c0; };
    const int hi0 = causal ? bound(d0) : 70, hi1 = causal ? bound(d0 + 8) : 70;
    const int lo0 = window ? bound(d0 - window) : -70;
    const int lo1 = window ? bound(d0 + 8 - window) : -70;
    const int kc = keys - c0;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int col = 8 * (i / 4) + (i & 1);
      const bool row1 = i & 2;
      const bool visible = (row1 ? lo1 : lo0) < col && col <= (row1 ? hi1 : hi0);
      const float si = SCALED ? __fmul_rn(s[i], scale) : s[i];
      // a key past S is no key at all: exp(-inf - m) adds nothing
      s[i] = col >= kc ? -CUDART_INF_F : (visible ? si : kFaNeg);
      mx[(i >> 1) & 1][(i >> 2) & 3] = fmaxf(mx[(i >> 1) & 1][(i >> 2) & 3], s[i]);
    }
  }
  float mx0 = fmaxf(fmaxf(mx[0][0], mx[0][1]), fmaxf(mx[0][2], mx[0][3]));
  float mx1 = fmaxf(fmaxf(mx[1][0], mx[1][1]), fmaxf(mx[1][2], mx[1][3]));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xFFFFFFFFu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xFFFFFFFFu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xFFFFFFFFu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xFFFFFFFFu, mx1, 2));
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  corr0 = expf(__fsub_rn(m0, mn0));
  corr1 = expf(__fsub_rn(m1, mn1));
  m0 = mn0;
  m1 = mn1;
  float sm[2][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) sm[0][j] = sm[1][j] = 0.f;
#pragma unroll
  for (int i = 0; i < NS / 2; ++i) {
    const float mn = (i & 1) ? mn1 : mn0;
    const float pa = expf(__fsub_rn(s[2 * i], mn));
    const float pb = expf(__fsub_rn(s[2 * i + 1], mn));
    float& part = sm[i & 1][(i >> 1) & 3];
    part = __fadd_rn(__fadd_rn(part, pa), pb);
    uint32_t w[PARTS];
    tc_split_pair<PARTS>(pa, pb, w);
#pragma unroll
    for (int j = 0; j < PARTS; ++j) pp[j][i] = w[j];
  }
  l0 = __fadd_rn(__fmul_rn(l0, corr0),
                 __fadd_rn(__fadd_rn(sm[0][0], sm[0][1]), __fadd_rn(sm[0][2], sm[0][3])));
  l1 = __fadd_rn(__fmul_rn(l1, corr1),
                 __fadd_rn(__fadd_rn(sm[1][0], sm[1][1]), __fadd_rn(sm[1][2], sm[1][3])));
}

// A thread's chunks of an R-row tile that a block of NT threads stages in the
// unswizzled wgmma layout: chunk e is row i, dims 8g .. 8g + 7, at (g R + i)
// 16 bytes in shared memory.  Each eight neighbouring threads take eight
// neighbouring rows (their 16-byte shared stores do not collide) and four
// such groups four neighbouring chunks of those rows (a warp's load touches
// 8 rows, not 32).
template <int R, int DP, int NT>
__host__ __device__ constexpr int tc_chunks() {
  return (R * DP / 8 + NT - 1) / NT;
}

template <int R, int DP>
__device__ __forceinline__ int2 tc_chunk(int e) {
  constexpr int GQ = DP / 8 < 4 ? DP / 8 : 4;  // chunks of a row a warp takes
  const int rest = e / (8 * GQ);
  return make_int2((rest % (R / 8)) * 8 + e % 8, (rest / (R / 8)) * GQ + (e / 8) % GQ);
}

// By-value loads of the bf16 kernel: this thread's chunks of R rows of a bf16
// array (row i at src + i D), rows from `live` on and dims from D on as
// zeros, each chunk as four words of two bf16 (the lower dim in the low half,
// as they lie in memory).  `pairs` (D even, 4-byte aligned bases): a word a
// load, nothing computed on the loaded value before its store; else value by
// value (2-byte aligned bases, odd D), each word packed from two loads.
template <int R, int DP, int NT>
__device__ __forceinline__ void tc_load_bf16(uint32_t (&x)[tc_chunks<R, DP, NT>()][4],
                                             const __nv_bfloat16* src, int live, int D,
                                             bool pairs, int tid) {
  constexpr int CHUNKS = R * DP / 8;
#pragma unroll
  for (int it = 0; it < tc_chunks<R, DP, NT>(); ++it) {
    const int e = tid + it * NT;
    const int2 c = tc_chunk<R, DP>(e);
    const bool live_row = c.x < live && (CHUNKS % NT == 0 || e < CHUNKS);
    const long long at = (long long)c.x * D + 8 * c.y;
    if (pairs) {
      const uint32_t* row = reinterpret_cast<const uint32_t*>(src + at);
#pragma unroll
      for (int j = 0; j < 4; ++j) x[it][j] = live_row && 8 * c.y + 2 * j < D ? __ldg(row + j) : 0u;
    } else {
      const unsigned short* row = reinterpret_cast<const unsigned short*>(src + at);
      uint32_t h[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) h[j] = live_row && 8 * c.y + j < D ? __ldg(row + j) : 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) x[it][j] = h[2 * j] | (h[2 * j + 1] << 16);
    }
  }
}

// Those chunks into the tile at dst, chunk (g, i) at (g R + i) 16 bytes.
template <int R, int DP, int NT>
__device__ __forceinline__ void tc_store_bf16(unsigned char* dst,
                                              const uint32_t (&x)[tc_chunks<R, DP, NT>()][4],
                                              int tid) {
  constexpr int CHUNKS = R * DP / 8;
#pragma unroll
  for (int it = 0; it < tc_chunks<R, DP, NT>(); ++it) {
    const int e = tid + it * NT;
    if (CHUNKS % NT && e >= CHUNKS) break;
    const int2 c = tc_chunk<R, DP>(e);
    *reinterpret_cast<uint4*>(dst + (c.y * R + c.x) * 16) =
        make_uint4(x[it][0], x[it][1], x[it][2], x[it][3]);
  }
}

// Registers: at most 128 a thread (two blocks a SM) up to DP = 64, no spill;
// DP = 128 takes about 170 (one block), where 128 would spill; DP = 256 holds
// 128 output accumulators a thread beside s or p's parts (one block).  BYVAL:
// the tiles arrive by value (q, k, v read; the tensor maps unused), else by
// TMA (the tensor maps read; q, k, v unused).
template <int DP, bool BYVAL>
__global__ void __launch_bounds__(128 * kTcGroups, DP >= 128 ? 1 : 2)
flash_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                          int T, int S, int D, int group, int causal, int window,
                          long long q_offset, long long k_offset, float scale,
                          const __grid_constant__ CUtensorMap mq,
                          const __grid_constant__ CUtensorMap mk,
                          const __grid_constant__ CUtensorMap mv) {
  constexpr int ROWS = 64 * kTcGroups;
  constexpr int TILE = kTcKeys * DP * 2;  // bytes of a k or v tile
  constexpr int NS = kTcKeys / 2;         // score accumulators a thread
  constexpr int NO = DP / 2;              // output accumulators a thread
  constexpr int NT = 128 * kTcGroups;
  // shared: the q tile, two stages of a k and a v tile, an mbarrier a stage
  // (TMA only)
  extern __shared__ __align__(128) unsigned char tc_buf[];
  const uint32_t sq = static_cast<uint32_t>(__cvta_generic_to_shared(tc_buf));
  const uint32_t skv = sq + ROWS * DP * 2;
  const uint32_t sbar = skv + 4 * TILE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (!BYVAL && tid == 0) {
    tc_mbar_init(sbar);
    tc_mbar_init(sbar + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // DP = 256 sends its grid out head by head within each band of rows (x
  // the head), the others band by band within each head; either way the
  // longest causal rows go first
  constexpr bool kHeadMajor = DP == 256;
  const int bh = kHeadMajor ? blockIdx.x : blockIdx.y, kvh = bh / group;
  const int band = kHeadMajor ? blockIdx.y : blockIdx.x;
  const int q0 = ((kHeadMajor ? gridDim.y : gridDim.x) - 1 - band) * ROWS;
  const int rows = min(ROWS, T - q0);

  // Tiles masked for the whole block may be skipped only if every row of
  // the block sees some key in [k_offset, k_offset + S).
  int sees = 1;
  if (tid < rows) {
    const long long qp = q_offset + q0 + tid;
    long long lo = k_offset, hi = k_offset + S - 1;
    if (causal) hi = min(hi, qp);
    if (window) lo = max(lo, qp - window + 1);
    sees = lo <= hi;
  }
  const bool may_skip = __syncthreads_and(sees) && window >= 0;
  const long long qa = q_offset + q0, qb = qa + rows - 1;
  // the tiles with a visible (row, key) pair form one run [t_lo, t_hi]
  const int nt = (S + kTcKeys - 1) / kTcKeys;
  auto any = [&](int t) {
    const long long ka = k_offset + (long long)t * kTcKeys;
    const long long kb = ka + min(kTcKeys, S - t * kTcKeys) - 1;
    return (!causal || ka <= qb) && (!window || kb > qa - window);
  };
  int t_lo = 0, t_hi = nt - 1;
  if (may_skip) {
    while (t_lo < t_hi && !any(t_lo)) ++t_lo;
    while (t_hi > t_lo && !any(t_hi)) --t_hi;
  }
  // tile t lands in stage (t - t_lo) & 1, its bytes counted by that stage's
  // mbarrier; thread 0 issues every copy, each one TMA box
  auto load_kv = [&](int t, uint32_t extra) {
    const int st = (t - t_lo) & 1;
    const uint32_t dst = skv + 2 * TILE * st, bar = sbar + 8 * st;
    tc_mbar_expect(bar, 2 * TILE + extra);
    tc_tma(dst, &mk, 0, t * kTcKeys, 0, kvh, bar);
    tc_tma(dst + TILE, &mv, 0, t * kTcKeys, 0, kvh, bar);
  };
  // BYVAL: k/v tile t + 1 in registers from the P V of tile t - 1 to the S of
  // tile t; stage_at(t): the stage tile t lands in
  constexpr int NKV = tc_chunks<kTcKeys, DP, NT>();
  uint32_t xk[NKV][4], xv[NKV][4];
  const __nv_bfloat16* kh = k + (long long)kvh * S * D;
  const __nv_bfloat16* vh = v + (long long)kvh * S * D;
  const bool pairs = !(D & 1) && (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) & 3) == 0;
  auto fetch = [&](int t) {
    const int f0 = t * kTcKeys, fk = min(kTcKeys, S - f0);
    tc_load_bf16<kTcKeys, DP, NT>(xk, kh + (long long)f0 * D, fk, D, pairs, tid);
    tc_load_bf16<kTcKeys, DP, NT>(xv, vh + (long long)f0 * D, fk, D, pairs, tid);
  };
  auto stage_at = [&](int t) { return tc_buf + ROWS * DP * 2 + 2 * TILE * ((t - t_lo) & 1); };
  if constexpr (BYVAL) {  // the q tile and tile t_lo, a barrier, tile t_lo + 1 fetched
    {
      uint32_t xq[tc_chunks<ROWS, DP, NT>()][4];
      tc_load_bf16<ROWS, DP, NT>(xq, q + ((long long)bh * T + q0) * D, rows, D, pairs, tid);
      tc_store_bf16<ROWS, DP, NT>(tc_buf, xq, tid);
    }
    fetch(t_lo);
    tc_store_bf16<kTcKeys, DP, NT>(stage_at(t_lo), xk, tid);
    tc_store_bf16<kTcKeys, DP, NT>(stage_at(t_lo) + TILE, xv, tid);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (t_lo < t_hi) fetch(t_lo + 1);
  } else if (tid == 0) {  // the q tile joins the first tile's stage
    load_kv(t_lo, ROWS * DP * 2);
    tc_tma(sq, &mq, 0, q0, 0, bh, sbar);
  }

  // accumulator fragment: rows r0 and r0 + 8 of the block (warpgroup
  // warp / 4 takes rows 64 (warp / 4) ..), in each 8-column chunk c the
  // columns 8c + c0 and 8c + c0 + 1 (registers 4c .. 4c + 3)
  const int wg = warp >> 2;
  const int r0 = 64 * wg + (warp & 3) * 16 + (lane >> 2), c0 = 2 * (lane & 3);
  const long long qp0 = qa + r0;  // row r0's position; r0 + 8's is qp0 + 8
  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;  // l: this thread's keys
  // wgmma descriptors, no swizzle: LBO steps along K, SBO along M or N; a
  // step of b bytes adds b / 16 to the start field (shared addresses stay
  // under 256 KB, so the 14-bit field never carries)
  const uint64_t dq = tc_desc(sq + 64 * 16 * wg, ROWS * 16, 128);
  const uint64_t dk = tc_desc(skv, kTcKeys * 16, 128);
  const uint64_t dv = tc_desc(skv + TILE, 128, kTcKeys * 16);

  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * kTcKeys, keys = min(kTcKeys, S - k0);
    const uint64_t stage = (uint64_t)(2 * TILE / 16) * ((t - t_lo) & 1);
    // tile t + 1 lands in the other stage while tile t is used
    if constexpr (!BYVAL) {
      if (tid == 0 && t < t_hi) load_kv(t + 1, 0);
      tc_mbar_wait(sbar + 8 * ((t - t_lo) & 1), ((t - t_lo) >> 1) & 1);
    }

    // S = Q K^T: this warpgroup's q rows and k, both K-major, 16 dims a step
    float s[NS];
    tc_wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss_n64(s, dq + kk * 2 * ROWS, dk + stage + kk * 2 * kTcKeys, kk > 0);
    tc_wgmma_commit();
    tc_wgmma_wait();
    tc_fence_regs(s);
    // BYVAL: tile t + 1 into the other stage, freed by the barrier that ended
    // tile t - 1 and published by the one that ends tile t
    if constexpr (BYVAL) {
      if (t < t_hi) {
        tc_store_bf16<kTcKeys, DP, NT>(stage_at(t + 1), xk, tid);
        tc_store_bf16<kTcKeys, DP, NT>(stage_at(t + 1) + TILE, xv, tid);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      }
    }

    // a tile every row sees whole takes no mask
    const long long ka = k_offset + k0, kb = ka + keys - 1;
    const bool full =
        keys == kTcKeys && (!causal || kb <= qa) && (!window || ka > qb - window);
    uint32_t pp[2][NS / 2];  // p_hi, p_lo
    float corr0, corr1;
    tc_softmax<NS, 2, true>(s, pp, m0, m1, l0, l1, corr0, corr1, full, qp0 - ka, c0, causal,
                            window, keys, scale);
    // acc * 1 is acc: a warp whose rows all keep their max skips the rescale
    if (__any_sync(0xFFFFFFFFu, corr0 != 1.f || corr1 != 1.f)) {
#pragma unroll
      for (int i = 0; i < NO; ++i) acc[i] = __fmul_rn(acc[i], (i & 2) ? corr1 : corr0);
    }

    // acc += p_hi v + p_lo v, v MN-major (transposed), 16 keys a step
    tc_fence_regs(acc);
    tc_wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcKeys / 16; ++kk) {
      wgmma_rs<DP>(acc, pp[0] + 4 * kk, dv + stage + kk * 16);
      wgmma_rs<DP>(acc, pp[1] + 4 * kk, dv + stage + kk * 16);
    }
    tc_wgmma_commit();
    // BYVAL: tile t + 2 into registers while P V runs, held across the
    // barrier (the softmax holds none of them)
    if constexpr (BYVAL)
      if (t + 1 < t_hi) fetch(t + 2);
    tc_wgmma_wait();
    tc_fence_regs(acc);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // (l_0 + l_1) + (l_2 + l_3) over the quad, on all four lanes
  l0 = __fadd_rn(l0, __shfl_xor_sync(0xFFFFFFFFu, l0, 1));
  l0 = __fadd_rn(l0, __shfl_xor_sync(0xFFFFFFFFu, l0, 2));
  l1 = __fadd_rn(l1, __shfl_xor_sync(0xFFFFFFFFu, l1, 1));
  l1 = __fadd_rn(l1, __shfl_xor_sync(0xFFFFFFFFu, l1, 2));
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* o0 = o + ((long long)bh * T + q0 + r0) * D;
  __nv_bfloat16* o1 = o0 + 8 * (long long)D;
#pragma unroll
  for (int c = 0; c < NO / 4; ++c) {
    const int col = 8 * c + c0;
    if (col >= D) continue;
    if (BYVAL && (D & 1)) {  // odd D: rows start on 2-byte boundaries, col + 1 may be D
#pragma unroll
      for (int e = 0; e < 2 && col + e < D; ++e) {
        if (r0 < rows) o0[col + e] = __float2bfloat16_rn(__fdiv_rn(acc[4 * c + e], den0));
        if (r0 + 8 < rows) o1[col + e] = __float2bfloat16_rn(__fdiv_rn(acc[4 * c + 2 + e], den1));
      }
      continue;
    }
    if (r0 < rows)
      *reinterpret_cast<__nv_bfloat162*>(o0 + col) = __floats2bfloat162_rn(
          __fdiv_rn(acc[4 * c], den0), __fdiv_rn(acc[4 * c + 1], den0));
    if (r0 + 8 < rows)
      *reinterpret_cast<__nv_bfloat162*>(o1 + col) = __floats2bfloat162_rn(
          __fdiv_rn(acc[4 * c + 2], den1), __fdiv_rn(acc[4 * c + 3], den1));
  }
}

typedef CUresult (*TcEncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up through the runtime (no -lcuda)
static TcEncodeTiled tc_encoder() {
  static TcEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<TcEncodeTiled>(p);
  }
  return fn;
}

// A [heads, rows, D] bf16 array as TMA sees it: one box is a [DP / 8][box]
// tile of 16-byte chunks, chunk (g, i) holding row i's dims 8g .. 8g + 7 (the
// unswizzled wgmma layout); dims past D and rows past `rows` land as zeros.
static bool tc_tensor_map(CUtensorMap* map, const void* base, int heads, int rows, int D,
                          int DP, int box) {
  TcEncodeTiled encode = tc_encoder();
  if (encode == nullptr) return false;
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  // dims, innermost first: the 8 values of a chunk, rows, chunks, heads (the
  // chunks' stride, 16 bytes, below the rows': the box lands chunk-major)
  const cuuint64_t dims[4] = {8, (cuuint64_t)rows, (cuuint64_t)(D / 8), (cuuint64_t)heads};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, 16, (cuuint64_t)rows * D * 2};
  const cuuint32_t boxd[4] = {8, (cuuint32_t)box, (cuuint32_t)(DP / 8), 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                strides, boxd, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP, bool BYVAL>
cudaError_t launch_flash_tc(const void* q, const void* k, const void* v, void* o, int BH,
                            int T, int S, int D, int group, int causal, int window,
                            long long q_offset, long long k_offset, float scale,
                            cudaStream_t stream) {
  constexpr int ROWS = 64 * kTcGroups;
  CUtensorMap mq{}, mk{}, mv{};
  if (!BYVAL && (!tc_tensor_map(&mq, q, BH, T, D, DP, ROWS) ||
                 !tc_tensor_map(&mk, k, BH / group, S, D, DP, kTcKeys) ||
                 !tc_tensor_map(&mv, v, BH / group, S, D, DP, kTcKeys)))
    return cudaErrorInvalidValue;
  // the q tile, two stages of a k and a v tile, two mbarriers
  const size_t smem = ((size_t)ROWS + 4 * kTcKeys) * DP * 2 + 16;
  auto kernel = flash_attention_tc_kernel<DP, BYVAL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned bands = (unsigned)((T + ROWS - 1) / ROWS);
  if (DP == 256 && bands > 65535) return cudaErrorInvalidValue;
  const dim3 grid = DP == 256 ? dim3((unsigned)BH, bands) : dim3(bands, (unsigned)BH);
  kernel<<<grid, 128 * kTcGroups, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)o, T, S, D, group, causal, window, q_offset, k_offset, scale, mq, mk,
      mv);
  return cudaGetLastError();
}

// DP = D rounded up to 16, 32, 64, 128 or 256
template <bool BYVAL>
cudaError_t launch_flash_tc_dp(const void* q, const void* k, const void* v, void* o, int BH,
                               int T, int S, int D, int group, int causal, int window,
                               long long q_offset, long long k_offset, float scale,
                               cudaStream_t stream) {
  if (D <= 16)
    return launch_flash_tc<16, BYVAL>(q, k, v, o, BH, T, S, D, group, causal, window,
                                      q_offset, k_offset, scale, stream);
  if (D <= 32)
    return launch_flash_tc<32, BYVAL>(q, k, v, o, BH, T, S, D, group, causal, window,
                                      q_offset, k_offset, scale, stream);
  if (D <= 64)
    return launch_flash_tc<64, BYVAL>(q, k, v, o, BH, T, S, D, group, causal, window,
                                      q_offset, k_offset, scale, stream);
  if (D <= 128)
    return launch_flash_tc<128, BYVAL>(q, k, v, o, BH, T, S, D, group, causal, window,
                                       q_offset, k_offset, scale, stream);
  return launch_flash_tc<256, BYVAL>(q, k, v, o, BH, T, S, D, group, causal, window,
                                     q_offset, k_offset, scale, stream);
}

// ---------------------------------------------------------------------------
// flash_attention_f32tc_kernel: f32 on the tensor cores, every operand split
// into three bf16 parts (see the note above).
// ---------------------------------------------------------------------------

// Eight f32 values of one row, dims d0 .. d0 + 7: dims past D, and a row that
// is not `live`, read as zeros.  `vec`: D % 4 == 0 and 16-byte aligned bases,
// so two 16-byte loads (D % 4 == 0 puts d0 + 4 < D iff d0 < D).
__device__ __forceinline__ void fa_load8(const float* row, int d0, int D, bool vec,
                                         bool live, float (&x)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) x[j] = 0.f;
  if (!live) return;
  if (vec) {
    if (d0 < D) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(row + d0));
      x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
    }
    if (d0 + 4 < D) {
      const float4 b = __ldg(reinterpret_cast<const float4*>(row + d0 + 4));
      x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (d0 + j < D) x[j] = __ldg(row + d0 + j);
  }
}

// This thread's chunks of R rows of an f32 array (tc_chunk above; rows from
// `live` on, and dims from D on, as zeros).
template <int R, int DP, int NT>
__device__ __forceinline__ void tc_load_tile(float (&x)[tc_chunks<R, DP, NT>()][8],
                                             const float* src, int live, int ld, int D,
                                             bool vec, int tid) {
  constexpr int CHUNKS = R * DP / 8;
#pragma unroll
  for (int it = 0; it < tc_chunks<R, DP, NT>(); ++it) {
    const int e = tid + it * NT;
    const int2 c = tc_chunk<R, DP>(e);
    fa_load8(src + (long long)c.x * ld, 8 * c.y, D, vec, c.x < live && e < CHUNKS, x[it]);
  }
}

// Those chunks, each value times `scale` if SCALE, split into three bf16 part
// tiles at dst + j R DP 2 in the unswizzled wgmma layout: chunk (g, i), 16
// bytes at (g R + i) 16, holds row i's dims 8g .. 8g + 7 (neighbouring
// threads store neighbouring 16 bytes: no bank conflict).
template <int R, int DP, int NT, bool SCALE>
__device__ __forceinline__ void tc_store_tile(unsigned char* dst,
                                              const float (&x)[tc_chunks<R, DP, NT>()][8],
                                              float scale, int tid) {
  constexpr int CHUNKS = R * DP / 8;
#pragma unroll
  for (int it = 0; it < tc_chunks<R, DP, NT>(); ++it) {
    const int e = tid + it * NT;
    if (CHUNKS % NT && e >= CHUNKS) break;
    uint32_t w[3][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t pw[3];
      if constexpr (SCALE)
        tc_split_pair<3>(__fmul_rn(x[it][2 * j], scale), __fmul_rn(x[it][2 * j + 1], scale),
                         pw);
      else
        tc_split_pair<3>(x[it][2 * j], x[it][2 * j + 1], pw);
#pragma unroll
      for (int part = 0; part < 3; ++part) w[part][j] = pw[part];
    }
    const int2 c = tc_chunk<R, DP>(e);
#pragma unroll
    for (int part = 0; part < 3; ++part)
      *reinterpret_cast<uint4*>(dst + part * R * DP * 2 + (c.y * R + c.x) * 16) =
          make_uint4(w[part][0], w[part][1], w[part][2], w[part][3]);
  }
}

// The six part-products (a, b) of a three-way split, a + b <= 2, in the
// order b0c0, b0c1, b1c0, b0c2, b1c1, b2c0
__device__ constexpr int tc_pa(int j) { return j == 2 || j == 4 ? 1 : j == 5 ? 2 : 0; }
__device__ constexpr int tc_pb(int j) { return j == 1 || j == 4 ? 1 : j == 3 ? 2 : 0; }

// The f32 kernel's shape.  Up to DP = 128 each of G warpgroups owns 64 query
// rows and every dim, over key tiles of 64, and the block stages the q, k
// and v parts together.  At DP = 256 (G = 2) both warpgroups own the same 64
// rows, warpgroup w the dims [128 w, 128 w + 128), over key tiles of 32: each
// stages its own dims of q, k and v (a unit of its 128 threads), computes
// its partial s over them, and the two partials meet in shared memory.
template <int DP, int G>
struct F32tcShape {
  static constexpr bool kHalves = DP == 256;
  static constexpr int ROWS = kHalves ? 64 : 64 * G;   // query rows a block
  static constexpr int KEYS = kHalves ? 32 : kTcKeys;  // keys a tile
  static constexpr int DW = kHalves ? DP / 2 : DP;     // dims a warpgroup
  static constexpr int UNITS = kHalves ? G : 1;        // units that stage parts
  static constexpr int UT = 128 * G / UNITS;           // threads a unit
  // bytes of one part of a unit's q tile and of its k or v tile
  static constexpr int QP = ROWS * DW * 2, KP = KEYS * DW * 2;
  // the partial s of each warpgroup, twice (by the tile's parity)
  static constexpr int XB = kHalves ? 2 * G * 64 * KEYS * 4 : 0;
  // shared: each unit's three q part tiles, then each unit's three k and
  // three v part tiles, then the partials: 3 (64 G + 128) DP 2 bytes up to
  // DP = 128, 229,376 at 256; one block a SM
  static constexpr size_t kSmem = (size_t)UNITS * 3 * (QP + 2 * KP) + XB;
};

template <int DP, int G>
__global__ void __launch_bounds__(128 * G, 1)
flash_attention_f32tc_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, float* __restrict__ o, int T,
                             int S, int D, int group, int causal, int window,
                             long long q_offset, long long k_offset, float scale, int vec) {
  using Sh = F32tcShape<DP, G>;
  constexpr bool kHalves = Sh::kHalves;
  constexpr int ROWS = Sh::ROWS, KEYS = Sh::KEYS, DW = Sh::DW, UT = Sh::UT;
  constexpr int QP = Sh::QP, KP = Sh::KP;
  constexpr int NS = KEYS / 2;  // score accumulators a thread
  constexpr int NO = DW / 2;    // output accumulators a thread
  extern __shared__ __align__(128) unsigned char tc_buf[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wg = warp >> 2;
  // this thread's unit (the block, or at DP = 256 its warpgroup), its index
  // there, and its warpgroup's first dim
  const int unit = kHalves ? wg : 0, utid = kHalves ? tid & 127 : tid;
  const int d_lo = kHalves ? DW * wg : 0;
  unsigned char* bq = tc_buf + unit * 3 * QP;
  unsigned char* bk = tc_buf + Sh::UNITS * 3 * QP + unit * 3 * KP;
  unsigned char* bv = tc_buf + Sh::UNITS * 3 * (QP + KP) + unit * 3 * KP;
  float4* bx = reinterpret_cast<float4*>(tc_buf + Sh::UNITS * 3 * (QP + 2 * KP));
  const uint32_t sq = static_cast<uint32_t>(__cvta_generic_to_shared(bq));
  const uint32_t sk = static_cast<uint32_t>(__cvta_generic_to_shared(bk));
  const uint32_t sv = static_cast<uint32_t>(__cvta_generic_to_shared(bv));
  // at DP = 256 a warpgroup's threads wait for each other (named barriers 1
  // and 2; 0 is __syncthreads')
  auto sync_warpgroup = [&] { asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory"); };

  // blocks go out head by head within each band of rows, the longest causal
  // rows first: the last blocks to run are the shortest
  const int bh = blockIdx.x, kvh = bh / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * ROWS;
  const int rows = min(ROWS, T - q0);

  // Tiles masked for the whole block may be skipped only if every row of
  // the block sees some key in [k_offset, k_offset + S).
  int sees = 1;
  if (tid < rows) {
    const long long qp = q_offset + q0 + tid;
    long long lo = k_offset, hi = k_offset + S - 1;
    if (causal) hi = min(hi, qp);
    if (window) lo = max(lo, qp - window + 1);
    sees = lo <= hi;
  }
  const bool may_skip = __syncthreads_and(sees) && window >= 0;
  const long long qa = q_offset + q0, qb = qa + rows - 1;
  // the tiles with a visible (row, key) pair form one run [t_lo, t_hi]
  const int nt = (S + KEYS - 1) / KEYS;
  auto any = [&](int t) {
    const long long ka = k_offset + (long long)t * KEYS;
    const long long kb = ka + min(KEYS, S - t * KEYS) - 1;
    return (!causal || ka <= qb) && (!window || kb > qa - window);
  };
  int t_lo = 0, t_hi = nt - 1;
  if (may_skip) {
    while (t_lo < t_hi && !any(t_lo)) ++t_lo;
    while (t_hi > t_lo && !any(t_hi)) --t_hi;
  }

  // q (1/sqrt(D)) in f32, then split: the unit's q parts for the whole loop
  {
    float xq[tc_chunks<ROWS, DW, UT>()][8];
    tc_load_tile<ROWS, DW, UT>(xq, q + ((long long)bh * T + q0) * D + d_lo, rows, D,
                               D - d_lo, vec, utid);
    tc_store_tile<ROWS, DW, UT, true>(bq, xq, scale, utid);
  }
  const float* kh = k + (long long)kvh * S * D + d_lo;
  const float* vh = v + (long long)kvh * S * D + d_lo;
  constexpr int NC = tc_chunks<KEYS, DW, UT>();
  float xk[NC][8], xv[NC][8];
  // tile t's k and v in registers, loaded while the products of tile t - 1
  // run and split at the top of tile t (at DP = 256 one of them at a time)
  auto fetch_one = [&](float (&x)[NC][8], const float* src, int t) {
    const int f0 = t * KEYS;
    tc_load_tile<KEYS, DW, UT>(x, src + (long long)f0 * D, min(KEYS, S - f0), D, D - d_lo,
                               vec, utid);
  };
  auto fetch = [&](int t) {
    const int f0 = t * KEYS, fk = min(KEYS, S - f0);
    tc_load_tile<KEYS, DW, UT>(xk, kh + (long long)f0 * D, fk, D, D - d_lo, vec, utid);
    tc_load_tile<KEYS, DW, UT>(xv, vh + (long long)f0 * D, fk, D, D - d_lo, vec, utid);
  };
  fetch(t_lo);

  // accumulator fragment as in flash_attention_tc_kernel
  const int r0 = (kHalves ? 0 : 64 * wg) + (warp & 3) * 16 + (lane >> 2), c0 = 2 * (lane & 3);
  const long long qp0 = qa + r0;
  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.f, l1 = 0.f;
  // descriptors of part 0; part j lies j QP (q) or j KP (k, v) bytes on
  const uint64_t dq = tc_desc(sq + (kHalves ? 0 : 64 * 16 * wg), ROWS * 16, 128);
  const uint64_t dk = tc_desc(sk, KEYS * 16, 128);
  const uint64_t dv = tc_desc(sv, 128, KEYS * 16);
  constexpr uint64_t QJ = QP / 16, KJ = KP / 16;  // a part's step in descriptor units

  // At DP = 256 the loop is pipelined: S(t) runs while v(t) is split, the
  // partials' barrier also publishes v(t)'s parts, P V(t) runs while k(t +
  // 1) is split, and a barrier of the warpgroup publishes k(t + 1) and frees
  // v's parts.  The parts are written by the threads (the generic proxy);
  // wgmma reads them through the async proxy, hence each fence.
  if constexpr (kHalves) {
    tc_store_tile<KEYS, DW, UT, false>(bk, xk, 1.f, utid);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    sync_warpgroup();
    if (t_lo < t_hi) fetch_one(xk, kh, t_lo + 1);
  }
  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * KEYS, keys = min(KEYS, S - k0);
    if constexpr (!kHalves) {
      if (t > t_lo) __syncthreads();  // every warpgroup is done with the last tile
      tc_store_tile<KEYS, DW, UT, false>(bk, xk, 1.f, utid);
      tc_store_tile<KEYS, DW, UT, false>(bv, xv, 1.f, utid);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
    }

    // S = sum of the six part-products Q_a K_b^T over this warpgroup's dims,
    // K-major, 16 dims a step
    float s[NS];
    tc_wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DW / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 6; ++j)
        wgmma_ss<KEYS>(s, dq + tc_pa(j) * QJ + kk * 2 * ROWS,
                       dk + tc_pb(j) * KJ + kk * 2 * KEYS, kk > 0 || j > 0);
    tc_wgmma_commit();
    if constexpr (kHalves) {
      tc_store_tile<KEYS, DW, UT, false>(bv, xv, 1.f, utid);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      if (t < t_hi) fetch_one(xv, vh, t + 1);
    }
    tc_wgmma_wait();
    tc_fence_regs(s);
    if constexpr (kHalves) {
      // s = s_0 + s_1: thread i of one warpgroup holds the same (row, key)
      // entries as thread i of the other; addition commutes exactly, so
      // both warpgroups hold the same bits, and so the same m, l and p
      float4* mine = bx + ((t & 1) * G + wg) * (NS / 4) * UT + utid;
      const float4* theirs = bx + ((t & 1) * G + 1 - wg) * (NS / 4) * UT + utid;
#pragma unroll
      for (int i = 0; i < NS / 4; ++i)
        mine[i * UT] = make_float4(s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3]);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < NS / 4; ++i) {
        const float4 x = theirs[i * UT];
        s[4 * i] = __fadd_rn(s[4 * i], x.x);
        s[4 * i + 1] = __fadd_rn(s[4 * i + 1], x.y);
        s[4 * i + 2] = __fadd_rn(s[4 * i + 2], x.z);
        s[4 * i + 3] = __fadd_rn(s[4 * i + 3], x.w);
      }
    }

    // a tile every row sees whole takes no mask
    const long long ka = k_offset + k0, kb = ka + keys - 1;
    const bool full = keys == KEYS && (!causal || kb <= qa) && (!window || ka > qb - window);
    uint32_t pp[3][NS / 2];
    float corr0, corr1;
    tc_softmax<NS, 3, false>(s, pp, m0, m1, l0, l1, corr0, corr1, full, qp0 - ka, c0,
                             causal, window, keys, 1.f);
    // acc * 1 is acc: a warp whose rows all keep their max skips the rescale
    if (__any_sync(0xFFFFFFFFu, corr0 != 1.f || corr1 != 1.f)) {
#pragma unroll
      for (int i = 0; i < NO; ++i) acc[i] = __fmul_rn(acc[i], (i & 2) ? corr1 : corr0);
    }

    // acc += sum of the six part-products P_a V_b, v MN-major, 16 keys a step
    tc_fence_regs(acc);
    tc_wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KEYS / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 6; ++j)
        wgmma_rs<DW>(acc, pp[tc_pa(j)] + 4 * kk, dv + tc_pb(j) * KJ + kk * 16);
    tc_wgmma_commit();
    if constexpr (kHalves) {
      if (t < t_hi) {  // every S(t) was waited for before the partials' barrier
        tc_store_tile<KEYS, DW, UT, false>(bk, xk, 1.f, utid);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        if (t + 1 < t_hi) fetch_one(xk, kh, t + 2);
      }
    } else {
      if (t < t_hi) fetch(t + 1);
    }
    tc_wgmma_wait();
    tc_fence_regs(acc);
    if constexpr (kHalves) sync_warpgroup();
  }

  // (l_0 + l_1) + (l_2 + l_3) over the quad, on all four lanes
  l0 = __fadd_rn(l0, __shfl_xor_sync(0xFFFFFFFFu, l0, 1));
  l0 = __fadd_rn(l0, __shfl_xor_sync(0xFFFFFFFFu, l0, 2));
  l1 = __fadd_rn(l1, __shfl_xor_sync(0xFFFFFFFFu, l1, 1));
  l1 = __fadd_rn(l1, __shfl_xor_sync(0xFFFFFFFFu, l1, 2));
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  float* o0 = o + ((long long)bh * T + q0 + r0) * D + d_lo;
  float* o1 = o0 + 8 * (long long)D;
#pragma unroll
  for (int c = 0; c < NO / 4; ++c) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * c + c0 + e;
      if (col >= D - d_lo) continue;
      if (r0 < rows) o0[col] = __fdiv_rn(acc[4 * c + e], den0);
      if (r0 + 8 < rows) o1[col] = __fdiv_rn(acc[4 * c + 2 + e], den1);
    }
  }
}

template <int DP, int G>
cudaError_t launch_flash_f32tc(const void* q, const void* k, const void* v, void* o, int BH,
                               int T, int S, int D, int group, int causal, int window,
                               long long q_offset, long long k_offset, float scale,
                               cudaStream_t stream) {
  using Sh = F32tcShape<DP, G>;
  auto kernel = flash_attention_f32tc_kernel<DP, G>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Sh::kSmem);
  if (err != cudaSuccess) return err;
  const int vec = D % 4 == 0 && ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
  const unsigned bands = (unsigned)((T + Sh::ROWS - 1) / Sh::ROWS);
  if (bands > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)BH, bands);
  kernel<<<grid, 128 * G, Sh::kSmem, stream>>>((const float*)q, (const float*)k,
                                               (const float*)v, (float*)o, T, S, D, group,
                                               causal, window, q_offset, k_offset, scale,
                                               vec);
  return cudaGetLastError();
}

cudaError_t launch_flash_attention(const void* q, const void* k, const void* v, void* o,
                                   int bf16, int BH, int T, int S, int D, int group,
                                   int causal, int window, long long q_offset,
                                   long long k_offset, float scale, cudaStream_t stream) {
  if (BH < 1 || BH > 65535 || T < 1 || S < 1 || D < 1 || D > 256 || group < 1 ||
      BH % group != 0)
    return cudaErrorInvalidValue;
  if (!bf16) {  // f32 on the tensor cores, three-way split
    // four warpgroups a block up to DP = 64 (147 KB of shared memory at 64),
    // two at 128 (196 KB), two on the two halves of the dims at 256 (224 KB)
    if (D <= 16)
      return launch_flash_f32tc<16, 4>(q, k, v, o, BH, T, S, D, group, causal, window,
                                       q_offset, k_offset, scale, stream);
    if (D <= 32)
      return launch_flash_f32tc<32, 4>(q, k, v, o, BH, T, S, D, group, causal, window,
                                       q_offset, k_offset, scale, stream);
    if (D <= 64)
      return launch_flash_f32tc<64, 4>(q, k, v, o, BH, T, S, D, group, causal, window,
                                       q_offset, k_offset, scale, stream);
    if (D <= 128)
      return launch_flash_f32tc<128, 2>(q, k, v, o, BH, T, S, D, group, causal, window,
                                        q_offset, k_offset, scale, stream);
    return launch_flash_f32tc<256, 2>(q, k, v, o, BH, T, S, D, group, causal, window,
                                      q_offset, k_offset, scale, stream);
  }
  // bf16 on the tensor cores: TMA where a row is whole 16-byte chunks (16-byte
  // aligned bases), by value otherwise
  if (D % 8 == 0) {
    if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16) return cudaErrorMisalignedAddress;
    return launch_flash_tc_dp<false>(q, k, v, o, BH, T, S, D, group, causal, window,
                                     q_offset, k_offset, scale, stream);
  }
  return launch_flash_tc_dp<true>(q, k, v, o, BH, T, S, D, group, causal, window, q_offset,
                                  k_offset, scale, stream);
}

}  // namespace repro

// Flash attention for Hopper (sm_90a): the forward (causal or full, GQA)
// with online softmax, and the two backward kernels, dQ and dK/dV.  f32
// operands run the three as split-TF32 kernels, bf16 operands as
// tensor-core kernels (below).  The launcher picks by dtype.
//
// What they compute, in f32 as the reference (src/repro/kernels/
// flash_attention/kernel.py).  For q (B, H, T, D) and k, v (B, KV, S, D),
// query head h reads kv head h / (H / KV) (K and V are never expanded):
//
//   s   = (q * sc) k^T,  masked to -1e30 where qpos < kpos when causal
//   m, l, acc by online softmax over kv chunks, then l = max(l, 1e-30)
//   O   = acc / l cast to q's dtype,  lse = m + log(l) in f32
//
// Keys past S get -inf (they weigh 0 whatever the row holds) and rows past
// T are computed and not written, so T and S need not be multiples of the
// chunks.  The backward is the recompute formulation, with lse from the
// forward and delta = rowsum(dO * O) computed by the caller:
//
//   p  = exp((q * sc) k^T - lse)   (the same mask; keys past S weigh 0)
//   dp = dO v^T,  ds = p * (dp - delta)
//   dQ = ds k * sc,  dK = ds^T q * sc,  dV = p^T dO
//
// Split TF32 (f32 operands; flash_fwd_tf32_kernel replaces _fwd_call /
// _fwd_kernel, flash_bwd_dq_tf32_kernel _bwd_call's _dq_kernel,
// flash_bwd_dkv_tf32_kernel, with flash_dkv_reduce_kernel when G > 1, its
// _dkv_kernel).
// Every product runs on the tensor cores as sm_90a wgmma m64nNk8 .tf32 with
// f32 sums and keeps f32 accuracy: each operand x is split into TF32
// halves and each k step takes three products, hi hi + hi lo + lo hi
// (~20 bits of each operand, at 495 TFLOP/s: 165 TFLOP/s of f32-accurate
// products, 2.5x the FMA units).  The tensor cores ignore a .tf32
// operand's low 13 bits, so hi is the f32 word as it is and lo = x - hi's
// top 19 bits (split_tf32; on the card: errors as with cvt.rna halves, the
// kernels 8-21 % faster).  q k^T and dO v^T need the split too: an operand
// read once as TF32 puts ~2^-11 |s| into the exponent of p (ref.py's
// flash_attention_fwd_tf32_plain and flash_attention_bwd_tf32_plain mirror
// the arithmetic, and their one-product controls fail the checks).  What
// f32 operands change against the bf16 design:
// * wgmma transposes only 16-bit operands, so every B is staged K-major:
//   the chunk's tiles are copied raw (cp.async), the copy serving as its
//   own hi half, then the whole block splits them in one pass over shared
//   memory: lo beside the copy where the tile is read as it is, and both
//   halves transposed where a product sums over the chunk (V^T for the
//   forward; K^T for dQ; q^T and dO^T for dK/dV).
// * An f32 accumulator is the next product's A fragment register for
//   register, but an 8-column block holds columns (2 tig, 2 tig + 1) where
//   the TF32 fragment takes k slots (tig, tig + 4): the transposed tiles
//   store each group of 8 chunk positions in slot order 0, 2, 4, 6, 1, 3,
//   5, 7 (tslot), so p and ds never leave registers.  A operands held in
//   shared memory (q in the forward; q, dO in dQ; K, V in dK/dV) stay raw,
//   loaded and split a k step at a time.
// * The tensor cores add into f32 with truncation: each chunk's product
//   (L / 8 steps of 3 wgmmas) sums into a fresh partial, added into the
//   running sums with rounded f32 adds (the forward: O = alpha O + part).
// The forward and dQ: one block per (b, h, 128 query rows), two warpgroups
// sharing 64-key chunks (32 above d 80); the forward keeps the online
// softmax in registers, dQ reads lse.  dK/dV: one block per (b, query head,
// 64 keys),
// warpgroup 0 s^T, p^T and dV, warpgroup 1 dp^T, ds^T and dK, p^T passed
// through shared memory, over 64-row query chunks (32 above d 80).  G = 1
// writes dK and dV directly; G > 1 writes f32 sums per query head and the
// reduce kernel sums the group in order.  No atomics: the same bits on every
// run.
//
// Bound (H100 SXM, 495 TFLOP/s TF32): the split triples each product, so
// at HuBERT-XLarge's shape (B 1, H 16, T 2048, d 80, bidirectional; one
// product 10.74 GFLOP) the forward's 2 products take 0.130 ms, dQ's 3
// 0.195 ms, dK/dV's 4 0.260 ms; the bytes (~50 MB) ~0.015 ms.  What holds
// them (ablate.py --f32, at that shape; PERF.md): not the tensor cores,
// whose work runs near that rate (the forward 0.34 ms, 0.23 with no
// wgmma), but the block's serial work around it at one
// block a SM: the split pass, the fragments' loads and splits, and the
// copies (each key block re-reads its head's q and dO, 0.67 GB through L2
// for dK/dV).  A producer warpgroup splitting the next chunk into a second
// tile set under the products (it fits at d <= 80 with 32-row chunks) is
// the next step.  dK/dV at d 80 slows by 20-50 % when ptxas gives it fewer
// registers (134-173 in ablate.py's variants against 225 as built).
//
// Shared memory: the forward 2 raw 64 x D q tiles (rows padded by 4
// words, or XOR-swizzled when D is a multiple of 32), the chunk's K (hi,
// lo), V as copied and V^T (hi, lo); dQ 4 raw tiles (q, dO of each
// warpgroup) and the chunk's K, V (hi, lo) and K^T (hi, lo); dK/dV raw K
// and V, the chunk's q and dO (hi, lo) and both transposed (hi, lo), lse
// and delta, the p^T exchange: forward / dQ / dK/dV 146 / 209 / 225 KB at
// D = 80, 111 / 172 / 157 KB at 96, 148 / 230 / 206 KB at 128.  Each
// launch opts in above 48 KB with cudaFuncSetAttribute.
//
// Tensor-core kernels (bf16 operands; flash_fwd_tc_kernel replaces
// _fwd_call / _fwd_kernel, flash_bwd_dq_tc_kernel _bwd_call's _dq_kernel,
// flash_bwd_dkv_tc_kernel with flash_dkv_reduce_kernel _bwd_call's
// _dkv_kernel).  Every product runs as sm_90a wgmma (m64nNk16, bf16 x bf16,
// f32 sums) and keeps the f32 reference's precision:
// * q k^T and dO v^T have bf16 operands: their products are exact in f32.
//   The sum is scaled by sc afterwards, in f32.
// * A product with an f32 operand x (p v; ds k; p^T dO and ds^T q) takes x
//   as two
//   bf16 halves, hi = bf16(x) and lo = bf16(x - hi), and runs two wgmmas
//   into one f32 accumulator: hi + lo keeps ~16 bits of x where bf16 keeps
//   8.  With hi alone (p rounded to bf16, as SDPA does) O, dQ and dK/dV err
//   by about 1e-2 of their rms beyond one bf16 rounding of the output, and
//   the checks reject that at 1e-3; with both halves the error is ~1e-5 (on
//   an H100 SXM at the shapes below: O 3.0e-5, dQ 4.6e-5, dK 6.5e-5, dV
//   6.9e-5; chip_smoke.py).
// Tiles live in shared memory as 8 x 8 core matrices without a swizzle,
// which wgmma reads both K-major (q, K, V, dO as the A or B of q k^T,
// K q^T, V dO^T) and MN-major (V, K, dO, q as the B of p v, ds k, p^T dO,
// ds^T q);
// cp.async copies 16-byte chunks into them, a ring of stages ahead of the
// wgmmas (FWD_STAGES, DQ_STAGES, DKV_STAGES).  The accumulator of a 64 x 64
// score
// tile is, register for register, the A fragment of the next product, so
// p and ds never leave registers on their way into it.  Softmax runs in
// base 2 (exp2f of s sc log2(e)), one FMA and one exp2 a score.
//
// Forward: one block per (b, h, 128 query rows), longest causal rows
// first, two warpgroups of 64 rows each sharing the block's K and V
// chunks (half the K/V traffic of a warpgroup a block); per 64-key chunk,
// up to each warpgroup's diagonal: s = q K^T (D / 16 wgmmas), the causal
// and ragged masks (on the chunks that need them), the online softmax in
// registers (row max and sum over the 4 lanes that share a row), then
// O += p_hi V + p_lo V (8 wgmmas), V MN-major.  Shared memory: two q tiles
// and two stages of K and V, 96 KB at D = 128 (one block, 8 warps, a SM).
//
// dQ: the forward's block (b, h, 128 query rows, longest first, two
// warpgroups sharing a ring of K and V chunks); per 64-key chunk, s = q K^T
// and dp = dO V^T (2 D / 16 wgmmas), p and ds in registers, then
// dQ += ds_hi K + ds_lo K (8 wgmmas, K MN-major).  Shared memory: two q and
// two dO tiles, two stages of K and V, 128 KB at D = 128.  It replaces the
// FMA kernel for bf16, which ran every product in f32 FMAs (10.6 ms at
// train_4k on an H100 SXM, chip_smoke.py).
//
// dK/dV: one block per (b, query head, 64 keys), two warpgroups, so 2,048
// blocks at B 1, H 32, S 4096 where a block per kv head would give 256 of
// very uneven work.  Per 64-row q chunk from the diagonal on, warpgroup 0
// computes s^T = K q^T and p^T = exp(s^T sc - lse), hands p^T to
// warpgroup 1 through shared memory behind a named barrier, and adds
// p^T dO (split) to dV; warpgroup 1 computes dp^T = V dO^T, ds^T =
// p^T (dp^T - delta), and adds ds^T q (split) to dK.  Each writes its f32
// sums for the query head ((B, H, S, d) scratch); the reduce kernel sums
// the G heads of each kv head in order g = 0 .. G - 1, scales dK by sc and
// casts into k's and v's layouts.  No atomics: the same bits on every run.
// Shared memory: K, V, two stages of q and dO, their lse and delta, and
// the p^T slots, 113 KB at D = 128 (one block, 8 warps, a SM).
//
// What limits them (H100 SXM, train_4k shape, flash_attention/ablate.py,
// which cuts parts out): no single unit.  With every wgmma removed the
// forward still takes 0.65-0.68 of its 0.82-0.85 ms and dK/dV 1.16-1.19 of
// 2.21-2.28 ms; without the copies 0.57-0.59 and 1.56-1.59; a third ring
// stage gains nothing.  Each warpgroup runs copy, wgmma, softmax (or dS)
// and wgmma as one dependent chain with 8 warps a SM to hide it.  Warp
// specialisation (a producer warp, TMA) and two warpgroups that alternate
// softmax and wgmma are the next step.
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s), over the
// causal half, for the precision-keeping design (one wgmma-rate product
// for q k^T and dO v^T, two for each f32-operand product): the forward at
// prefill (B 4, H 32, KV 4, T = S = 2048, D 128) 3 x 68.7 GFLOP, 0.209 ms;
// dK/dV at train_4k (B 1, H 32, KV 4, T = S = 4096) 6 x 68.7 GFLOP,
// 0.417 ms; dQ 4 products, 0.278 ms.  The bytes (q, k, v, dO once, the
// outputs once; about 100 MB) take ~0.03 ms: operations bound all three.
// dQ runs the forward's chain (copy, wgmma, elementwise, wgmma) without
// the online softmax's rescaling, so it is held by the same serialisation.
//
// Head dimensions: every kernel, forward and backward, f32 and bf16, is
// instantiated at D = 16, 32, 64, 80, 96 and 128 (80 and 96 for
// HuBERT-XLarge and Phi-3-Vision), and runs any head dim d <= 128 in the
// smallest D >= d (head_dim_for; OLMoE's smoke config has d 24): d is a
// run-time argument beside the template D, the loads of q, k, v and dO are
// predicated per 16-byte chunk and fill columns [d, D) with zeros, and O,
// dQ, dK and dV (and the dK/dV sums per query head, (B, H, S, d)) are
// stored at columns below d only.  Zero columns add exactly 0 to q k^T and
// dO v^T, and V's, q's and dO's zero columns make output columns that are
// never stored; the scale is the caller's, from d.  The 16-byte copies need
// d x the itemsize to be a multiple of 16 (d a multiple of 8 in bf16, 4 in
// f32; ops.py pads any other d).  A head dim above 128 runs the *_wide
// kernels (the output-column split, below the tensor-core kernels).
// 80 and 96 are multiples of 16 but not of 64, so the tiles keep the
// unswizzled core-matrix layout (a 128-byte swizzle cannot cover a row of
// 80): q k^T, dO v^T, K q^T and V dO^T run D / 16 (5 or 6) k16 steps, and
// each product with an MN-major B of N = D (p v, ds k, p^T dO, ds^T q)
// one wgmma m64nDk16 a 16-key slice, 40 and 48 accumulator registers a
// thread.  Shared memory at D = 80 / 96: the tensor-core forward 60 / 72
// KB, dQ 80 / 96 KB, dK/dV 77 / 89 KB.
//
// C interface (ctypes): pointers and the stream are void*, sizes are int,
// strides (in elements, for the b, h and t axes; the d axis is contiguous)
// are long long, sc is float; dtype 0 = f32, 1 = bf16 (every q-, k-, v-
// and dO-shaped operand has it; lse and delta are f32, contiguous
// (B, H, T)).  flash_attention_fwd, flash_attention_bwd_dq and
// flash_attention_bwd_dkv take f32 only (dtype 0), with 16-byte aligned
// addresses and strides; flash_attention_bwd_dkv
// takes two f32 (B, H, S, d) scratch buffers after dk and dv, used when
// G > 1.  flash_attention_fwd_tc, flash_attention_bwd_dq_tc and
// flash_attention_bwd_dkv_tc take the arguments of their f32 entries and
// bf16 only (dtype 1), with 16-byte aligned addresses and strides, the
// dK/dV scratch always.  Each returns cudaGetLastError()
// after its launches, or cudaErrorInvalidValue for a head dimension no
// kernel takes (below 1, or rows of d that the 16-byte copies cannot
// cover).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;

struct Strides {
  long long b, h, t;
};

int opt_in(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  void *dq, *dk, *dv;
  int B, H, KV, Tq, S, d;  // d: the head dim asked for (the template's D >= d)
  Strides qs, ks, vs, dos, dqs, dks, dvs;
  float sc;
  int causal;
  cudaStream_t st;
};

// ---------------------------------------------------------------------------
// Tensor-core kernels (bf16 operands, sm_90a wgmma)
// ---------------------------------------------------------------------------

constexpr int TC_BQ = 64;   // query rows of a warpgroup tile (wgmma's M)
constexpr int TC_BK = 64;   // keys a chunk (wgmma's N for q k^T)
constexpr int WG = 128;     // threads of a warpgroup
// The forward's warpgroups a block (each 64 query rows, sharing the block's
// K and V chunks) and its ring of K and V stages; dK/dV's ring of q, dO,
// lse and delta stages.  Each ring's copies run (stages - 1) chunks ahead.
constexpr int FWD_WGS = 2;
constexpr int FWD_STAGES = 2;
constexpr int DKV_STAGES = 2;
// dQ's warpgroups a block and its ring of K and V stages, as the forward's.
constexpr int DQ_WGS = 2;
constexpr int DQ_STAGES = 2;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A 64-row bf16 tile [64][D] lives in shared memory as 8 x 8 core matrices
// (8 rows of 16 bytes, 128 contiguous bytes each): element (r, c) at byte
// (c / 8) * 1024 + r * 16 + (c % 8) * 2.  wgmma reads it without a swizzle
// either way round:
// * K-major (rows are M or N, the sum runs over c): core matrices step
//   1024 bytes along c (the leading byte offset) and 128 bytes along r (the
//   stride byte offset); the k-th 16-column slice starts 2048 k bytes in.
// * MN-major (the sum runs over r, N is c): 128 bytes along r (leading),
//   1024 bytes along c (stride); the k-th 16-row slice starts 256 k bytes
//   in.
constexpr uint32_t TILE_COL8 = TC_BQ * 16;   // bytes between 8-column blocks

__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  // start address, leading and stride byte offsets in 16-byte units;
  // base offset 0 and layout type 0 (no swizzle) in bits 49-51 and 62-63
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32);
}

__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int k) {
  return smem_desc(tile + k * 2 * TILE_COL8, TILE_COL8, 128);
}

__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int k) {
  return smem_desc(tile + k * 256, 128, TILE_COL8);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// cp.async writes through the generic proxy, wgmma reads through the async
// proxy: each thread fences its landed copies before the block barrier.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accesses of an accumulator across a
// wgmma's issue or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Rows [r0, r0 + 64) of a (rows, d) bf16 slab with row stride st into a
// core-matrix tile of D columns, zero past ``rows`` and in columns [d, D)
// (d a multiple of 8); every thread of ``nthreads`` copies 16-byte chunks,
// eight neighbouring rows of one chunk column a warp quarter, so the
// stores fill whole 128-byte core matrices.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t tile, const bf16* src,
                                          long long st, int r0, int rows,
                                          int d, int tid, int nthreads) {
  constexpr int CH = D / 8;
  for (int i = tid; i < TC_BQ * CH; i += nthreads) {
    const int r = (i % 8) + 8 * (i / (8 * CH));
    const int c8 = (i / 8) % CH;
    const int t = r0 + r;
    const bool in = t < rows && c8 * 8 < d;
    cp_async16(tile + c8 * TILE_COL8 + r * 16,
               in ? static_cast<const void*>(src + t * st + c8 * 8) : src,
               in ? 16 : 0);
  }
}

// D (64 x 64, f32) += A (64 x 16) B (16 x 64), A and B K-major in shared
// memory; scale_d = 0 ignores D's old value.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 16, f32) += A (64 x 16, bf16 fragments in registers) B (16 x 16),
// B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[8], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// D (64 x 32, f32) += A (64 x 16, bf16 fragments in registers) B (16 x 32),
// B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[16], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// D (64 x 64, f32) += A (64 x 16, bf16 fragments in registers) B (16 x 64),
// B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// D (64 x 80, f32) += A (64 x 16, bf16 fragments in registers) B (16 x 80),
// B MN-major in shared memory (40 accumulator registers a thread: the
// forward's P V at head dim 80).
__device__ __forceinline__ void wgmma_rs(float (&d)[40], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// D (64 x 96, f32) += A (64 x 16, bf16 fragments in registers) B (16 x 96),
// B MN-major in shared memory (48 accumulator registers a thread: the
// forward's P V at head dim 96).
__device__ __forceinline__ void wgmma_rs(float (&d)[48], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, bf16 fragments in registers) B (16 x 128),
// B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
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
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Splits a 64 x 64 f32 accumulator (p or ds) into the A fragments of
// hi = bf16(x) and lo = bf16(x - hi), four 16-column slices of four
// registers each: slice k is the accumulator's 8-column blocks 2k and
// 2k + 1, which is wgmma's A layout for rows warp*16 + (lane/4) (+8).
__device__ __forceinline__ void split_frags(const float (&x)[32],
                                            uint32_t (&hi)[16],
                                            uint32_t (&lo)[16]) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      // r: 0 = (row, block 2k), 1 = (row + 8, 2k), 2 = (row, 2k + 1),
      //    3 = (row + 8, 2k + 1)
      const int idx = (2 * k + (r >> 1)) * 4 + (r & 1) * 2;
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(x[idx], x[idx + 1]);
      const float2 hf = __bfloat1622float2(h2);
      hi[k * 4 + r] = *reinterpret_cast<const uint32_t*>(&h2);
      lo[k * 4 + r] = pack_bf16(x[idx] - hf.x, x[idx + 1] - hf.y);
    }
}

// O (64 x D) += (hi + lo) V over one 64-key chunk: eight wgmmas, two per
// 16-key slice, both into the one f32 accumulator.
template <int N>
__device__ __forceinline__ void split_product(float (&acc)[N / 2],
                                              const uint32_t (&hi)[16],
                                              const uint32_t (&lo)[16],
                                              uint32_t btile) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    wgmma_rs(acc, hi[4 * k], hi[4 * k + 1], hi[4 * k + 2], hi[4 * k + 3],
             desc_mnmajor(btile, k));
#pragma unroll
  for (int k = 0; k < 4; ++k)
    wgmma_rs(acc, lo[4 * k], lo[4 * k + 1], lo[4 * k + 2], lo[4 * k + 3],
             desc_mnmajor(btile, k));
}

// S (64 x 64) = A B^T over D columns: A and B are 64-row core-matrix tiles.
// The wide kernels sum a d-step into S (``acc``) and take its first
// ``ksteps`` 16-column steps only (the last d-step's columns past d are
// zero); the defaults are the whole tile into a fresh S.
template <int D>
__device__ __forceinline__ void scores_tc(float (&s)[32], uint32_t atile,
                                          uint32_t btile, bool acc = false,
                                          int ksteps = D / 16) {
#pragma unroll
  for (int k = 0; k < D / 16; ++k)
    if (k < ksteps)
      wgmma_ss_n64(s, desc_kmajor(atile, k), desc_kmajor(btile, k),
                   acc || k > 0);
}

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// One chunk of the online softmax on a 64 x 2N score accumulator (N
// registers a thread: rows warp*16 + gid (+8), keys n8*8 + tig*2 (+1)),
// in base 2: scale by scl = sc log2(e), mask, update the running max m (of
// s scl), turn s into p = 2^(s scl - m) = exp(s sc - m ln 2) in place, and
// return the rescale alpha and the row sums of p (summed over the quad
// that shares a row).
// ``masked``: the chunk holds keys past S or past the diagonal.
template <int N>
__device__ __forceinline__ void softmax_chunk(float (&s)[N], float (&m)[2],
                                              float (&alpha)[2],
                                              float (&sum)[2], int qrow,
                                              int kv0, int tig, int S,
                                              int causal, bool masked,
                                              float scl) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = qrow + 8 * i;
    float mx = NEG_INF;
#pragma unroll
    for (int n8 = 0; n8 < N / 4; ++n8)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int idx = n8 * 4 + i * 2 + e;
        float x = s[idx] * scl;
        if (masked) {
          const int kpos = kv0 + n8 * 8 + tig * 2 + e;
          if (kpos >= S)
            x = -INFINITY;
          else if (causal && qpos < kpos)
            x = NEG_INF;
        }
        s[idx] = x;
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[i], mx);
    alpha[i] = exp2f(m[i] - m_new);
    float t = 0.f;
#pragma unroll
    for (int n8 = 0; n8 < N / 4; ++n8)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int idx = n8 * 4 + i * 2 + e;
        s[idx] = exp2f(s[idx] - m_new);
        t += s[idx];
      }
    t += __shfl_xor_sync(0xffffffffu, t, 1);
    t += __shfl_xor_sync(0xffffffffu, t, 2);
    sum[i] = t;
    m[i] = m_new;
  }
}

template <int D>
__global__ void __launch_bounds__(FWD_WGS * WG, 1) flash_fwd_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
    int H, int KV, int Tq, int S, int d, Strides qs, Strides ks, Strides vs,
    Strides os, float sc, int causal) {
  constexpr int TILE = TC_BQ * D;   // bf16 elements of a tile
  constexpr uint32_t TB = TILE * 2;  // bytes of a tile
  constexpr int NT = FWD_WGS * WG;  // threads of the block
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [FWD_WGS][TILE]
  bf16* Ks = Qs + FWD_WGS * TILE;                // [FWD_STAGES][TILE]
  bf16* Vs = Ks + FWD_STAGES * TILE;             // [FWD_STAGES][TILE]

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  // the longest causal rows first
  const int qi = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int wg = tid / WG;
  const int t = tid % WG;
  const int warp = t / 32;
  const int gid = (t % 32) / 4;
  const int tig = t % 4;
  const int qb0 = qi * TC_BQ * FWD_WGS;  // the block's first row
  const int q0 = qb0 + wg * TC_BQ;       // this warpgroup's first row
  const int qrow = q0 + warp * 16 + gid;

  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + kvh * ks.h;
  const bf16* vb = v + b * vs.b + kvh * vs.h;
  const uint32_t qtile = smem_u32(Qs);
  const uint32_t ktile = smem_u32(Ks);
  const uint32_t vtile = smem_u32(Vs);
  const int kv_end = causal ? min(S, qb0 + FWD_WGS * TC_BQ) : S;
  const int nkv = (kv_end + TC_BK - 1) / TC_BK;
  // this warpgroup's chunks: those holding a key at or before its last row
  const int mine = causal ? min(nkv, q0 / TC_BK + 1) : nkv;
  auto load_chunk = [&](int c) {
    if (c < nkv) {
      const int st = c % FWD_STAGES;
      load_tile<D>(ktile + st * TB, kb, ks.t, c * TC_BK, S, d, tid, NT);
      load_tile<D>(vtile + st * TB, vb, vs.t, c * TC_BK, S, d, tid, NT);
    }
    cp_commit();  // a group per chunk, empty past the last
  };

#pragma unroll
  for (int w = 0; w < FWD_WGS; ++w)
    load_tile<D>(qtile + w * TB, qb, qs.t, qb0 + w * TC_BQ, Tq, d, tid, NT);
#pragma unroll
  for (int c = 0; c < FWD_STAGES - 1; ++c) load_chunk(c);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2], sum[2];

  for (int j = 0; j < nkv; ++j) {
    // chunk j landed, and every warp is past chunk j - 1, whose stage the
    // copies of chunk j + FWD_STAGES - 1 refill
    cp_wait<FWD_STAGES - 2>();
    fence_async_smem();
    __syncthreads();
    load_chunk(j + FWD_STAGES - 1);
    if (j >= mine) continue;  // past this warpgroup's diagonal

    const uint32_t st = (j % FWD_STAGES) * TB;
    const int kv0 = j * TC_BK;
    float s[32] = {};
    wg_fence();
    scores_tc<D>(s, qtile + wg * TB, ktile + st);
    wg_commit();
    wg_wait_all();
    fence_regs(s);
    softmax_chunk(s, m, alpha, sum, qrow, kv0, tig, S, causal,
                  kv0 + TC_BK > S || (causal && kv0 + TC_BK - 1 > q0),
                  sc * LOG2E);
#pragma unroll
    for (int n8 = 0; n8 < D / 8; ++n8)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[n8 * 4 + r] *= alpha[r >> 1];
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];

    uint32_t hi[16], lo[16];
    split_frags(s, hi, lo);
    fence_regs(acc);
    wg_fence();
    split_product<D>(acc, hi, lo, vtile + st);
    wg_commit();
    wg_wait_all();
    fence_regs(acc);
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int tq = qrow + 8 * i;
    if (tq >= Tq) continue;
    const float li = fmaxf(l[i], 1e-30f);
    bf16* orow = o + b * os.b + h * os.h + tq * os.t;
#pragma unroll
    for (int n8 = 0; n8 < D / 8; ++n8) {
      const int c = n8 * 8 + tig * 2;
      if (c < d)  // columns [d, D) hold V's zeros: never stored
        *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(
            acc[n8 * 4 + i * 2] / li, acc[n8 * 4 + i * 2 + 1] / li);
    }
    if (tig == 0)  // m is in base 2
      lse[(static_cast<int64_t>(b) * H + h) * Tq + tq] = m[i] * LN2 + logf(li);
  }
}

// dK/dV on the tensor cores: one block per (b, query head, 64 keys), two
// warpgroups.  Both recompute their 64 keys x 64 queries tile per q chunk
// transposed (keys are the rows, so the accumulators are already the A
// fragments of p^T and ds^T):
//   warpgroup 0: s^T = K q^T, p^T = exp(s^T sc - lse), dV += p^T dO
//   warpgroup 1: dp^T = V dO^T, ds^T = p^T (dp^T - delta), dK += ds^T q
// p^T passes from 0 to 1 through shared memory (f32, one slot a thread:
// thread i of each warpgroup holds the same elements) behind a named
// barrier.  Each writes its f32 sums for this query head; the reduce kernel
// sums the group's heads in a fixed order.
template <int D>
__global__ void __launch_bounds__(2 * WG, 1) flash_bwd_dkv_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk_part, float* __restrict__ dv_part, int H, int KV,
    int Tq, int S, int d, Strides qs, Strides ks, Strides vs, Strides dos,
    float sc, int causal) {
  constexpr int TILE = TC_BQ * D;
  constexpr uint32_t TB = TILE * 2;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + TILE;
  bf16* Qs = Vs + TILE;                   // [DKV_STAGES][TILE]
  bf16* dOs = Qs + DKV_STAGES * TILE;     // [DKV_STAGES][TILE]
  float* Ls = reinterpret_cast<float*>(dOs + DKV_STAGES * TILE);
  float* Dl = Ls + DKV_STAGES * TC_BQ;    // lse, delta: [DKV_STAGES][64]
  float* Pex = Dl + DKV_STAGES * TC_BQ;   // [32][WG]

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kvh = h / (H / KV);
  const int k0 = blockIdx.y * TC_BK;  // blockIdx.y = 0 (most q chunks) first
  const int tid = threadIdx.x;
  const int wg = tid / WG;
  const int t = tid % WG;
  const int warp = t / 32;
  const int gid = (t % 32) / 4;
  const int tig = t % 4;

  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* dob = dout + b * dos.b + h * dos.h;
  const int64_t row0 = (static_cast<int64_t>(b) * H + h) * Tq;
  const uint32_t ktile = smem_u32(Ks), vtile = smem_u32(Vs);
  const uint32_t qtile = smem_u32(Qs), dotile = smem_u32(dOs);

  const int nq = (Tq + TC_BQ - 1) / TC_BQ;
  const int lo_q = causal ? k0 / TC_BQ : 0;  // the first q chunk that sees k0

  // a group per q chunk (empty past the last); chunk qc in stage
  // (qc - lo_q) % DKV_STAGES
  auto stage = [&](int qc) {
    if (qc >= nq) {
      cp_commit();
      return;
    }
    const int sidx = (qc - lo_q) % DKV_STAGES;
    const int q0 = qc * TC_BQ;
    load_tile<D>(qtile + sidx * TB, qb, qs.t, q0, Tq, d, tid, 2 * WG);
    load_tile<D>(dotile + sidx * TB, dob, dos.t, q0, Tq, d, tid, 2 * WG);
    if (tid < 2 * TC_BQ) {  // the rows' lse and delta, zero past T
      const int r = tid % TC_BQ;
      const int tq = q0 + r;
      const float* src = (tid < TC_BQ ? lse : delta) + row0;
      cp_async4(smem_u32((tid < TC_BQ ? Ls : Dl) + sidx * TC_BQ + r),
                tq < Tq ? src + tq : src, tq < Tq ? 4 : 0);
    }
    cp_commit();
  };

  load_tile<D>(ktile, k + b * ks.b + kvh * ks.h, ks.t, k0, S, d, tid, 2 * WG);
  load_tile<D>(vtile, v + b * vs.b + kvh * vs.h, vs.t, k0, S, d, tid, 2 * WG);
  // K and V go with the first q chunk's group
#pragma unroll
  for (int c = 0; c < DKV_STAGES - 1; ++c) stage(lo_q + c);

  float acc[D / 2];  // dV (warpgroup 0) or dK (warpgroup 1), unscaled
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int qc = lo_q; qc < nq; ++qc) {
    // chunk qc landed, and every thread is past chunk qc - 1, whose stage
    // (and Pex) the next copies refill
    cp_wait<DKV_STAGES - 2>();
    fence_async_smem();
    __syncthreads();
    stage(qc + DKV_STAGES - 1);
    const int sidx = (qc - lo_q) % DKV_STAGES;

    const int q0 = qc * TC_BQ;
    const float scl = sc * LOG2E;
    const float* Lst = Ls + sidx * TC_BQ;
    const float* Dst = Dl + sidx * TC_BQ;
    float x[32] = {};
    wg_fence();
    if (wg == 0)
      scores_tc<D>(x, ktile, qtile + sidx * TB);
    else
      scores_tc<D>(x, vtile, dotile + sidx * TB);
    wg_commit();
    wg_wait_all();
    fence_regs(x);

    // the tile holds keys past S, rows past T, or the causal diagonal
    const bool masked =
        k0 + TC_BK > S || q0 + TC_BQ > Tq || (causal && q0 < k0 + TC_BK - 1);
    if (wg == 0) {
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int idx = n8 * 4 + r;
          const int kpos = k0 + warp * 16 + gid + 8 * (r >> 1);
          const int c = n8 * 8 + tig * 2 + (r & 1);
          const int qpos = q0 + c;
          const bool in = !masked || (kpos < S && qpos < Tq &&
                                      !(causal && qpos < kpos));
          // exp(s sc - lse) in base 2
          const float p =
              in ? exp2f(fmaf(x[idx], scl, -Lst[c] * LOG2E)) : 0.f;
          x[idx] = p;
          Pex[idx * WG + t] = p;
        }
      asm volatile("bar.arrive 1, %0;\n" ::"n"(2 * WG) : "memory");
    } else {
      asm volatile("bar.sync 1, %0;\n" ::"n"(2 * WG) : "memory");
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int idx = n8 * 4 + r;
          const int c = n8 * 8 + tig * 2 + (r & 1);
          x[idx] = Pex[idx * WG + t] * (x[idx] - Dst[c]);
        }
    }

    uint32_t hi[16], lo[16];
    split_frags(x, hi, lo);
    fence_regs(acc);
    wg_fence();
    split_product<D>(acc, hi, lo, (wg == 0 ? dotile : qtile) + sidx * TB);
    wg_commit();
    wg_wait_all();
    fence_regs(acc);
  }
  cp_wait<0>();  // a block with no q chunk leaves no copy in flight

  float* part = wg == 0 ? dv_part : dk_part;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = k0 + warp * 16 + gid + 8 * i;
    if (s >= S) continue;
    float* row = part + ((static_cast<int64_t>(b) * H + h) * S + s) * d;
#pragma unroll
    for (int n8 = 0; n8 < D / 8; ++n8)
      if (n8 * 8 + tig * 2 < d)
        *reinterpret_cast<float2*>(row + n8 * 8 + tig * 2) =
            make_float2(acc[n8 * 4 + i * 2], acc[n8 * 4 + i * 2 + 1]);
  }
}

// Four f32 sums into four elements of T (rounded once for bf16).
__device__ __forceinline__ void store4(bf16* dst, float4 x) {
  reinterpret_cast<__nv_bfloat162*>(dst)[0] = __floats2bfloat162_rn(x.x, x.y);
  reinterpret_cast<__nv_bfloat162*>(dst)[1] = __floats2bfloat162_rn(x.z, x.w);
}
__device__ __forceinline__ void store4(float* dst, float4 x) {
  *reinterpret_cast<float4*>(dst) = x;
}

// dK = sc * sum_g dk_part[h = kvh * G + g], dV = sum_g dv_part[...], g in
// order 0 .. G - 1 (the same order on every run), into k's and v's layouts
// as T (bf16 after the tensor-core dK/dV, f32 after the split-TF32 one);
// the parts are (B, H, S, d) f32, d a multiple of 4; blockIdx.y = 0 for
// dK, 1 for dV; a thread owns 4 columns.
template <typename T>
__global__ void __launch_bounds__(256) flash_dkv_reduce_kernel(
    const float* __restrict__ dk_part, const float* __restrict__ dv_part,
    T* __restrict__ dk, T* __restrict__ dv, int H, int KV, int S, int d,
    Strides dks, Strides dvs, float sc, long long n4) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= n4) return;
  const int c = static_cast<int>(idx % (d / 4)) * 4;
  const long long row = idx / (d / 4);
  const int s = static_cast<int>(row % S);
  const long long bk = row / S;
  const int kvh = static_cast<int>(bk % KV);
  const int b = static_cast<int>(bk / KV);
  const int G = H / KV;
  const bool is_v = blockIdx.y == 1;
  const float* part = is_v ? dv_part : dk_part;
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const float4 x = *reinterpret_cast<const float4*>(
        part + ((static_cast<int64_t>(b) * H + h) * S + s) * d + c);
    sum.x += x.x;
    sum.y += x.y;
    sum.z += x.z;
    sum.w += x.w;
  }
  const float f = is_v ? 1.f : sc;
  const Strides& st = is_v ? dvs : dks;
  T* dst = (is_v ? dv : dk) + b * st.b + kvh * st.h + s * st.t + c;
  store4(dst, make_float4(sum.x * f, sum.y * f, sum.z * f, sum.w * f));
}

// dQ on the tensor cores: one block per (b, query head, 128 query rows),
// longest causal rows first, two warpgroups of 64 rows each sharing a ring
// of K and V chunks, as the forward.  Per 64-key chunk up to each
// warpgroup's diagonal:
//   s = q K^T, dp = dO V^T                        (2 D / 16 wgmmas)
//   p = exp(s sc - lse) in base 2, ds = p (dp - delta)   (registers)
//   dQ += ds_hi K + ds_lo K                       (8 wgmmas, K MN-major)
// The score accumulators are the A fragments of ds; q, dO, and the rows'
// lse and delta (registers) are loaded once.  dQ is scaled by sc and cast
// to bf16 at the end.  Each output element is written by one thread: no
// atomics, the same bits on every run.
template <int D>
__global__ void __launch_bounds__(DQ_WGS * WG, 1) flash_bwd_dq_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int H, int KV, int Tq, int S, int d, Strides qs,
    Strides ks, Strides vs, Strides dos, Strides dqs, float sc, int causal) {
  constexpr int TILE = TC_BQ * D;
  constexpr uint32_t TB = TILE * 2;
  constexpr int NT = DQ_WGS * WG;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [DQ_WGS][TILE]
  bf16* dOs = Qs + DQ_WGS * TILE;                // [DQ_WGS][TILE]
  bf16* Ks = dOs + DQ_WGS * TILE;                // [DQ_STAGES][TILE]
  bf16* Vs = Ks + DQ_STAGES * TILE;              // [DQ_STAGES][TILE]

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  // the longest causal rows first
  const int qi = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int wg = tid / WG;
  const int t = tid % WG;
  const int warp = t / 32;
  const int gid = (t % 32) / 4;
  const int tig = t % 4;
  const int qb0 = qi * TC_BQ * DQ_WGS;  // the block's first row
  const int q0 = qb0 + wg * TC_BQ;      // this warpgroup's first row
  const int qrow = q0 + warp * 16 + gid;

  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* dob = dout + b * dos.b + h * dos.h;
  const bf16* kb = k + b * ks.b + kvh * ks.h;
  const bf16* vb = v + b * vs.b + kvh * vs.h;
  const uint32_t qtile = smem_u32(Qs), dotile = smem_u32(dOs);
  const uint32_t ktile = smem_u32(Ks), vtile = smem_u32(Vs);
  const int kv_end = causal ? min(S, qb0 + DQ_WGS * TC_BQ) : S;
  const int nkv = (kv_end + TC_BK - 1) / TC_BK;
  // this warpgroup's chunks: those holding a key at or before its last row
  const int mine = causal ? min(nkv, q0 / TC_BK + 1) : nkv;
  auto load_chunk = [&](int c) {
    if (c < nkv) {
      const int st = c % DQ_STAGES;
      load_tile<D>(ktile + st * TB, kb, ks.t, c * TC_BK, S, d, tid, NT);
      load_tile<D>(vtile + st * TB, vb, vs.t, c * TC_BK, S, d, tid, NT);
    }
    cp_commit();  // a group per chunk, empty past the last
  };

#pragma unroll
  for (int w = 0; w < DQ_WGS; ++w) {
    load_tile<D>(qtile + w * TB, qb, qs.t, qb0 + w * TC_BQ, Tq, d, tid, NT);
    load_tile<D>(dotile + w * TB, dob, dos.t, qb0 + w * TC_BQ, Tq, d, tid, NT);
  }
#pragma unroll
  for (int c = 0; c < DQ_STAGES - 1; ++c) load_chunk(c);

  // the rows' lse (in base 2) and delta; rows past T weigh 0 (q and dO
  // are zero there, so ds = 1 * (0 - 0))
  const int64_t row0 = (static_cast<int64_t>(b) * H + h) * Tq;
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int tq = qrow + 8 * i;
    lse2[i] = tq < Tq ? lse[row0 + tq] * LOG2E : 0.f;
    dl[i] = tq < Tq ? delta[row0 + tq] : 0.f;
  }
  const float scl = sc * LOG2E;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int j = 0; j < nkv; ++j) {
    // chunk j landed, and every warp is past chunk j - 1, whose stage the
    // copies of chunk j + DQ_STAGES - 1 refill
    cp_wait<DQ_STAGES - 2>();
    fence_async_smem();
    __syncthreads();
    load_chunk(j + DQ_STAGES - 1);
    if (j >= mine) continue;  // past this warpgroup's diagonal

    const uint32_t st = (j % DQ_STAGES) * TB;
    const int kv0 = j * TC_BK;
    float s[32] = {}, dp[32] = {};
    wg_fence();
    scores_tc<D>(s, qtile + wg * TB, ktile + st);
    scores_tc<D>(dp, dotile + wg * TB, vtile + st);
    wg_commit();
    wg_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // the chunk holds keys past S or the causal diagonal
    const bool masked = kv0 + TC_BK > S || (causal && kv0 + TC_BK - 1 > q0);
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int idx = n8 * 4 + r;
        const int i = r >> 1;
        const int kpos = kv0 + n8 * 8 + tig * 2 + (r & 1);
        const bool in =
            !masked || (kpos < S && !(causal && qrow + 8 * i < kpos));
        const float p = in ? exp2f(fmaf(s[idx], scl, -lse2[i])) : 0.f;
        s[idx] = p * (dp[idx] - dl[i]);
      }

    uint32_t hi[16], lo[16];
    split_frags(s, hi, lo);
    fence_regs(acc);
    wg_fence();
    split_product<D>(acc, hi, lo, ktile + st);
    wg_commit();
    wg_wait_all();
    fence_regs(acc);
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int tq = qrow + 8 * i;
    if (tq >= Tq) continue;
    bf16* row = dq + b * dqs.b + h * dqs.h + tq * dqs.t;
#pragma unroll
    for (int n8 = 0; n8 < D / 8; ++n8)
      if (n8 * 8 + tig * 2 < d)
        *reinterpret_cast<__nv_bfloat162*>(row + n8 * 8 + tig * 2) =
            __floats2bfloat162_rn(acc[n8 * 4 + i * 2] * sc,
                                  acc[n8 * 4 + i * 2 + 1] * sc);
  }
}

constexpr size_t fwd_tc_smem_bytes(int d) {
  return 2 * static_cast<size_t>(TC_BQ) * d * (FWD_WGS + 2 * FWD_STAGES);
}

constexpr size_t dq_tc_smem_bytes(int d) {
  return 2 * static_cast<size_t>(TC_BQ) * d * (2 * DQ_WGS + 2 * DQ_STAGES);
}

constexpr size_t dkv_tc_smem_bytes(int d) {
  return 2 * static_cast<size_t>(TC_BQ) * d * (2 + 2 * DKV_STAGES) +
         sizeof(float) *
             (2 * DKV_STAGES * static_cast<size_t>(TC_BQ) + 32 * WG);
}

template <int D>
int launch_fwd_tc(const void* q, const void* k, const void* v, void* o,
                  float* lse, int B, int H, int KV, int Tq, int S, int d,
                  Strides qs, Strides ks, Strides vs, Strides os, float sc,
                  int causal, cudaStream_t st) {
  const size_t smem = fwd_tc_smem_bytes(D);
  const int err = opt_in(reinterpret_cast<const void*>(
                             flash_fwd_tc_kernel<D>), smem);
  if (err) return err;
  const dim3 grid(B * H, (Tq + FWD_WGS * TC_BQ - 1) / (FWD_WGS * TC_BQ));
  flash_fwd_tc_kernel<D><<<grid, FWD_WGS * WG, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, H, KV, Tq, S,
      d, qs, ks, vs, os, sc, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq_tc(const BwdArgs& a) {
  const size_t smem = dq_tc_smem_bytes(D);
  const int err = opt_in(reinterpret_cast<const void*>(
                             flash_bwd_dq_tc_kernel<D>), smem);
  if (err) return err;
  const dim3 grid(a.B * a.H, (a.Tq + DQ_WGS * TC_BQ - 1) / (DQ_WGS * TC_BQ));
  flash_bwd_dq_tc_kernel<D><<<grid, DQ_WGS * WG, smem, a.st>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse,
      a.delta, static_cast<bf16*>(a.dq), a.H, a.KV, a.Tq, a.S, a.d, a.qs, a.ks,
      a.vs, a.dos, a.dqs, a.sc, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv_tc(const BwdArgs& a, float* dk_part, float* dv_part) {
  const size_t smem = dkv_tc_smem_bytes(D);
  int err = opt_in(reinterpret_cast<const void*>(flash_bwd_dkv_tc_kernel<D>),
                   smem);
  if (err) return err;
  const dim3 grid(a.B * a.H, (a.S + TC_BK - 1) / TC_BK);
  flash_bwd_dkv_tc_kernel<D><<<grid, 2 * WG, smem, a.st>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse,
      a.delta, dk_part, dv_part, a.H, a.KV, a.Tq, a.S, a.d, a.qs, a.ks, a.vs,
      a.dos, a.sc, a.causal);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const long long n4 = static_cast<long long>(a.B) * a.KV * a.S * (a.d / 4);
  const dim3 rgrid(static_cast<unsigned>((n4 + 255) / 256), 2);
  flash_dkv_reduce_kernel<bf16><<<rgrid, 256, 0, a.st>>>(
      dk_part, dv_part, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
      a.H, a.KV, a.S, a.d, a.dks, a.dvs, a.sc, n4);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Head dims above 128: the output-column split (bf16 and f32)
// ---------------------------------------------------------------------------
//
// A head dim d > 128 runs the *_wide kernels, instantiated at W = WIDE
// (128): the outputs (O; dQ; dK and dV) are cut into ceil(d / W) column
// slices, blockIdx.z = z owning columns [z W, z W + W) of them (zero past
// d on chip, never stored), with exactly the accumulators and wgmma shapes
// of the D = W kernels.  The score products (q k^T; dO v^T in the
// backward) cover all of d, summed into one accumulator over d-steps of W
// columns, the last one's zero 16- (8-) column steps skipped; the d-steps'
// tiles of q and K (and dO and V) stream through the block's shared memory
// one d-step at a time, so a block's shared memory does not grow with d.
// The slice's own tiles (V; K; dO and q), whose columns are those of
// d-step z, are copied with d-step z.  Each slice's blocks recompute the
// scores: at d 256 the forward does 1.5x the math's products (2 x 2 score
// products over half of d plus one p v, where the math does 1 + 1), dQ and
// dK/dV 1.67x (5 for 3).  Every slice computes the same scores, in the
// same order, so m and l are the same bits in each; slice 0 writes lse.
// The dK/dV sums per query head keep their (B, H, S, d) layout, each slice
// writing its columns, and the group sum runs as for d <= 128.
constexpr int WIDE = 128;        // columns of a slice and of a d-step
constexpr int WIDE_STAGES = 2;   // the tensor-core kernels' ring of d-steps

// The tensor-core forward at d > 128: the D = W forward's block (b, h, 128
// query rows, two warpgroups) for output columns [z W, z W + W).  Its ring
// holds a d-step's two q tiles and K tile a stage; per 64-key chunk, s =
// q K^T sums over the d-steps, then the chunk's online softmax and O +=
// p_hi V + p_lo V with V's slice (two buffers, by chunk parity).
template <int W>
__global__ void __launch_bounds__(FWD_WGS * WG, 1) flash_fwd_tc_wide_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
    int H, int KV, int Tq, int S, int d, Strides qs, Strides ks, Strides vs,
    Strides os, float sc, int causal) {
  constexpr uint32_t TB = TC_BQ * W * 2;        // bytes of a tile
  constexpr uint32_t STAGE = (FWD_WGS + 1) * TB;
  constexpr int NT = FWD_WGS * WG;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t ring = smem_u32(smem_raw);             // [STAGES][q.., K]
  const uint32_t vtile = ring + WIDE_STAGES * STAGE;    // [2] V's slice

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int qi = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int z = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int wg = tid / WG;
  const int t = tid % WG;
  const int warp = t / 32;
  const int gid = (t % 32) / 4;
  const int tig = t % 4;
  const int qb0 = qi * TC_BQ * FWD_WGS;
  const int q0 = qb0 + wg * TC_BQ;
  const int qrow = q0 + warp * 16 + gid;
  const int c0 = z * W;                  // the slice's first column
  const int dz = min(W, d - c0);         // ... and its columns below d
  const int ne = (d + W - 1) / W;        // d-steps

  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + kvh * ks.h;
  const bf16* vb = v + b * vs.b + kvh * vs.h;
  const int kv_end = causal ? min(S, qb0 + FWD_WGS * TC_BQ) : S;
  const int nkv = (kv_end + TC_BK - 1) / TC_BK;
  const int mine = causal ? min(nkv, q0 / TC_BK + 1) : nkv;
  const int nu = nkv * ne;               // (chunk, d-step) units
  auto load_step = [&](int u) {
    if (u < nu) {
      const int j = u / ne, e = u % ne;
      const int cols = min(W, d - e * W);
      const uint32_t st = ring + (u % WIDE_STAGES) * STAGE;
#pragma unroll
      for (int w = 0; w < FWD_WGS; ++w)
        load_tile<W>(st + w * TB, qb + e * W, qs.t, qb0 + w * TC_BQ, Tq,
                     cols, tid, NT);
      load_tile<W>(st + FWD_WGS * TB, kb + e * W, ks.t, j * TC_BK, S, cols,
                   tid, NT);
      if (e == z)
        load_tile<W>(vtile + (j & 1) * TB, vb + c0, vs.t, j * TC_BK, S, dz,
                     tid, NT);
    }
    cp_commit();  // a group per unit, empty past the last
  };
  load_step(0);

  float acc[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2], sum[2];
  float s[32] = {};

  for (int u = 0; u < nu; ++u) {
    // unit u landed, and every warp is past unit u - 1, whose stage unit
    // u + 1 refills
    cp_wait<0>();
    fence_async_smem();
    __syncthreads();
    load_step(u + 1);
    const int j = u / ne, e = u % ne;
    if (j >= mine) continue;  // past this warpgroup's diagonal
    const uint32_t st = ring + (u % WIDE_STAGES) * STAGE;
    const int cols = min(W, d - e * W);
    wg_fence();
    scores_tc<W>(s, st + wg * TB, st + FWD_WGS * TB, e > 0, (cols + 15) / 16);
    wg_commit();
    wg_wait_all();
    fence_regs(s);
    if (e < ne - 1) continue;  // the chunk's scores need more d-steps

    const int kv0 = j * TC_BK;
    softmax_chunk(s, m, alpha, sum, qrow, kv0, tig, S, causal,
                  kv0 + TC_BK > S || (causal && kv0 + TC_BK - 1 > q0),
                  sc * LOG2E);
#pragma unroll
    for (int n8 = 0; n8 < W / 8; ++n8)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[n8 * 4 + r] *= alpha[r >> 1];
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];

    uint32_t hi[16], lo[16];
    split_frags(s, hi, lo);
    fence_regs(acc);
    wg_fence();
    split_product<W>(acc, hi, lo, vtile + (j & 1) * TB);
    wg_commit();
    wg_wait_all();
    fence_regs(acc);
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int tq = qrow + 8 * i;
    if (tq >= Tq) continue;
    const float li = fmaxf(l[i], 1e-30f);
    bf16* orow = o + b * os.b + h * os.h + tq * os.t + c0;
#pragma unroll
    for (int n8 = 0; n8 < W / 8; ++n8) {
      const int c = n8 * 8 + tig * 2;
      if (c < dz)
        *reinterpret_cast<__nv_bfloat162*>(orow + c) = __floats2bfloat162_rn(
            acc[n8 * 4 + i * 2] / li, acc[n8 * 4 + i * 2 + 1] / li);
    }
    if (tig == 0 && z == 0)  // m is in base 2
      lse[(static_cast<int64_t>(b) * H + h) * Tq + tq] = m[i] * LN2 + logf(li);
  }
}

// The tensor-core dQ at d > 128: the D = W dQ's block for dQ's columns
// [z W, z W + W).  Its ring holds a d-step's two q, two dO, K and V tiles a
// stage; per 64-key chunk s = q K^T and dp = dO V^T sum over the d-steps,
// then ds in registers and dQ += ds_hi K + ds_lo K with K's slice (two
// buffers, by chunk parity).
template <int W>
__global__ void __launch_bounds__(DQ_WGS * WG, 1) flash_bwd_dq_tc_wide_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int H, int KV, int Tq, int S, int d, Strides qs,
    Strides ks, Strides vs, Strides dos, Strides dqs, float sc, int causal) {
  constexpr uint32_t TB = TC_BQ * W * 2;
  constexpr uint32_t STAGE = (2 * DQ_WGS + 2) * TB;  // q.., dO.., K, V
  constexpr int NT = DQ_WGS * WG;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t ring = smem_u32(smem_raw);
  const uint32_t kslice = ring + WIDE_STAGES * STAGE;  // [2] K's slice

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int qi = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int z = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int wg = tid / WG;
  const int t = tid % WG;
  const int warp = t / 32;
  const int gid = (t % 32) / 4;
  const int tig = t % 4;
  const int qb0 = qi * TC_BQ * DQ_WGS;
  const int q0 = qb0 + wg * TC_BQ;
  const int qrow = q0 + warp * 16 + gid;
  const int c0 = z * W;
  const int dz = min(W, d - c0);
  const int ne = (d + W - 1) / W;

  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* dob = dout + b * dos.b + h * dos.h;
  const bf16* kb = k + b * ks.b + kvh * ks.h;
  const bf16* vb = v + b * vs.b + kvh * vs.h;
  const int kv_end = causal ? min(S, qb0 + DQ_WGS * TC_BQ) : S;
  const int nkv = (kv_end + TC_BK - 1) / TC_BK;
  const int mine = causal ? min(nkv, q0 / TC_BK + 1) : nkv;
  const int nu = nkv * ne;
  auto load_step = [&](int u) {
    if (u < nu) {
      const int j = u / ne, e = u % ne;
      const int cols = min(W, d - e * W);
      const uint32_t st = ring + (u % WIDE_STAGES) * STAGE;
#pragma unroll
      for (int w = 0; w < DQ_WGS; ++w) {
        load_tile<W>(st + w * TB, qb + e * W, qs.t, qb0 + w * TC_BQ, Tq,
                     cols, tid, NT);
        load_tile<W>(st + (DQ_WGS + w) * TB, dob + e * W, dos.t,
                     qb0 + w * TC_BQ, Tq, cols, tid, NT);
      }
      load_tile<W>(st + 2 * DQ_WGS * TB, kb + e * W, ks.t, j * TC_BK, S,
                   cols, tid, NT);
      load_tile<W>(st + (2 * DQ_WGS + 1) * TB, vb + e * W, vs.t, j * TC_BK,
                   S, cols, tid, NT);
      if (e == z)
        load_tile<W>(kslice + (j & 1) * TB, kb + c0, ks.t, j * TC_BK, S, dz,
                     tid, NT);
    }
    cp_commit();
  };
  load_step(0);

  const int64_t row0 = (static_cast<int64_t>(b) * H + h) * Tq;
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int tq = qrow + 8 * i;
    lse2[i] = tq < Tq ? lse[row0 + tq] * LOG2E : 0.f;
    dl[i] = tq < Tq ? delta[row0 + tq] : 0.f;
  }
  const float scl = sc * LOG2E;

  float acc[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) acc[i] = 0.f;
  float s[32] = {}, dp[32] = {};

  for (int u = 0; u < nu; ++u) {
    cp_wait<0>();
    fence_async_smem();
    __syncthreads();
    load_step(u + 1);
    const int j = u / ne, e = u % ne;
    if (j >= mine) continue;
    const uint32_t st = ring + (u % WIDE_STAGES) * STAGE;
    const int steps = (min(W, d - e * W) + 15) / 16;
    wg_fence();
    scores_tc<W>(s, st + wg * TB, st + 2 * DQ_WGS * TB, e > 0, steps);
    scores_tc<W>(dp, st + (DQ_WGS + wg) * TB, st + (2 * DQ_WGS + 1) * TB,
                 e > 0, steps);
    wg_commit();
    wg_wait_all();
    fence_regs(s);
    fence_regs(dp);
    if (e < ne - 1) continue;

    const int kv0 = j * TC_BK;
    const bool masked = kv0 + TC_BK > S || (causal && kv0 + TC_BK - 1 > q0);
#pragma unroll
    for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int idx = n8 * 4 + r;
        const int i = r >> 1;
        const int kpos = kv0 + n8 * 8 + tig * 2 + (r & 1);
        const bool in =
            !masked || (kpos < S && !(causal && qrow + 8 * i < kpos));
        const float p = in ? exp2f(fmaf(s[idx], scl, -lse2[i])) : 0.f;
        s[idx] = p * (dp[idx] - dl[i]);
      }

    uint32_t hi[16], lo[16];
    split_frags(s, hi, lo);
    fence_regs(acc);
    wg_fence();
    split_product<W>(acc, hi, lo, kslice + (j & 1) * TB);
    wg_commit();
    wg_wait_all();
    fence_regs(acc);
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int tq = qrow + 8 * i;
    if (tq >= Tq) continue;
    bf16* row = dq + b * dqs.b + h * dqs.h + tq * dqs.t + c0;
#pragma unroll
    for (int n8 = 0; n8 < W / 8; ++n8)
      if (n8 * 8 + tig * 2 < dz)
        *reinterpret_cast<__nv_bfloat162*>(row + n8 * 8 + tig * 2) =
            __floats2bfloat162_rn(acc[n8 * 4 + i * 2] * sc,
                                  acc[n8 * 4 + i * 2 + 1] * sc);
  }
}

// The tensor-core dK/dV at d > 128: the D = W dK/dV's block (b, query head,
// 64 keys, two warpgroups) for dK's and dV's columns [z W, z W + W).  Its
// ring holds a d-step's K, V, q and dO tiles a stage; per 64-row q chunk,
// s^T = K q^T (warpgroup 0) and dp^T = V dO^T (warpgroup 1) sum over the
// d-steps, p^T passes to warpgroup 1 behind the block barrier, then dV +=
// p^T dO and dK += ds^T q with dO's and q's slices (two buffers each, by
// chunk parity; the rows' lse and delta likewise, copied with d-step 0).
template <int W>
__global__ void __launch_bounds__(2 * WG, 1) flash_bwd_dkv_tc_wide_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk_part, float* __restrict__ dv_part, int H, int KV,
    int Tq, int S, int d, Strides qs, Strides ks, Strides vs, Strides dos,
    float sc, int causal) {
  constexpr uint32_t TB = TC_BQ * W * 2;
  constexpr uint32_t STAGE = 4 * TB;  // K, V, q, dO
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t ring = smem_u32(smem_raw);
  const uint32_t slices = ring + WIDE_STAGES * STAGE;  // [2][q, dO] slices
  float* Ls = reinterpret_cast<float*>(smem_raw + WIDE_STAGES * STAGE +
                                       4 * TB);        // [2][64] lse
  float* Dl = Ls + 2 * TC_BQ;                           // [2][64] delta
  float* Pex = Dl + 2 * TC_BQ;                          // [32][WG]

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kvh = h / (H / KV);
  const int k0 = blockIdx.y * TC_BK;
  const int z = blockIdx.z;
  const int tid = threadIdx.x;
  const int wg = tid / WG;
  const int t = tid % WG;
  const int warp = t / 32;
  const int gid = (t % 32) / 4;
  const int tig = t % 4;
  const int c0 = z * W;
  const int dz = min(W, d - c0);
  const int ne = (d + W - 1) / W;

  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* dob = dout + b * dos.b + h * dos.h;
  const bf16* kb = k + b * ks.b + kvh * ks.h;
  const bf16* vb = v + b * vs.b + kvh * vs.h;
  const int64_t row0 = (static_cast<int64_t>(b) * H + h) * Tq;
  const int nq = (Tq + TC_BQ - 1) / TC_BQ;
  const int lo_q = causal ? k0 / TC_BQ : 0;
  const int nu = max(nq - lo_q, 0) * ne;
  auto load_step = [&](int u) {
    if (u < nu) {
      const int qc = lo_q + u / ne, e = u % ne;
      const int cols = min(W, d - e * W);
      const int par = qc & 1;
      const int q0 = qc * TC_BQ;
      const uint32_t st = ring + (u % WIDE_STAGES) * STAGE;
      load_tile<W>(st, kb + e * W, ks.t, k0, S, cols, tid, 2 * WG);
      load_tile<W>(st + TB, vb + e * W, vs.t, k0, S, cols, tid, 2 * WG);
      load_tile<W>(st + 2 * TB, qb + e * W, qs.t, q0, Tq, cols, tid, 2 * WG);
      load_tile<W>(st + 3 * TB, dob + e * W, dos.t, q0, Tq, cols, tid,
                   2 * WG);
      if (e == z) {
        load_tile<W>(slices + 2 * par * TB, qb + c0, qs.t, q0, Tq, dz, tid,
                     2 * WG);
        load_tile<W>(slices + (2 * par + 1) * TB, dob + c0, dos.t, q0, Tq,
                     dz, tid, 2 * WG);
      }
      if (e == 0 && tid < 2 * TC_BQ) {  // the rows' lse and delta, zero past T
        const int r = tid % TC_BQ;
        const int tq = q0 + r;
        const float* src = (tid < TC_BQ ? lse : delta) + row0;
        cp_async4(smem_u32((tid < TC_BQ ? Ls : Dl) + par * TC_BQ + r),
                  tq < Tq ? src + tq : src, tq < Tq ? 4 : 0);
      }
    }
    cp_commit();
  };
  load_step(0);

  float acc[W / 2];  // dV (warpgroup 0) or dK (warpgroup 1), unscaled
#pragma unroll
  for (int i = 0; i < W / 2; ++i) acc[i] = 0.f;
  const float scl = sc * LOG2E;
  float x[32] = {};

  for (int u = 0; u < nu; ++u) {
    cp_wait<0>();
    fence_async_smem();
    __syncthreads();
    load_step(u + 1);
    const int qc = lo_q + u / ne, e = u % ne;
    const uint32_t st = ring + (u % WIDE_STAGES) * STAGE;
    const int steps = (min(W, d - e * W) + 15) / 16;
    wg_fence();
    if (wg == 0)
      scores_tc<W>(x, st, st + 2 * TB, e > 0, steps);
    else
      scores_tc<W>(x, st + TB, st + 3 * TB, e > 0, steps);
    wg_commit();
    wg_wait_all();
    fence_regs(x);
    if (e < ne - 1) continue;

    const int par = qc & 1;
    const int q0 = qc * TC_BQ;
    const float* Lst = Ls + par * TC_BQ;
    const float* Dst = Dl + par * TC_BQ;
    const bool masked =
        k0 + TC_BK > S || q0 + TC_BQ > Tq || (causal && q0 < k0 + TC_BK - 1);
    if (wg == 0) {
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int idx = n8 * 4 + r;
          const int kpos = k0 + warp * 16 + gid + 8 * (r >> 1);
          const int c = n8 * 8 + tig * 2 + (r & 1);
          const int qpos = q0 + c;
          const bool in = !masked || (kpos < S && qpos < Tq &&
                                      !(causal && qpos < kpos));
          const float p =
              in ? exp2f(fmaf(x[idx], scl, -Lst[c] * LOG2E)) : 0.f;
          x[idx] = p;
          Pex[idx * WG + t] = p;
        }
    }
    __syncthreads();  // p^T for warpgroup 1
    if (wg == 1) {
#pragma unroll
      for (int n8 = 0; n8 < 8; ++n8)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int idx = n8 * 4 + r;
          const int c = n8 * 8 + tig * 2 + (r & 1);
          x[idx] = Pex[idx * WG + t] * (x[idx] - Dst[c]);
        }
    }

    uint32_t hi[16], lo[16];
    split_frags(x, hi, lo);
    fence_regs(acc);
    wg_fence();
    split_product<W>(acc, hi, lo, slices + (2 * par + (wg == 0)) * TB);
    wg_commit();
    wg_wait_all();
    fence_regs(acc);
  }
  cp_wait<0>();

  float* part = wg == 0 ? dv_part : dk_part;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = k0 + warp * 16 + gid + 8 * i;
    if (s >= S) continue;
    float* row = part + ((static_cast<int64_t>(b) * H + h) * S + s) * d + c0;
#pragma unroll
    for (int n8 = 0; n8 < W / 8; ++n8)
      if (n8 * 8 + tig * 2 < dz)
        *reinterpret_cast<float2*>(row + n8 * 8 + tig * 2) =
            make_float2(acc[n8 * 4 + i * 2], acc[n8 * 4 + i * 2 + 1]);
  }
}

// Shared memory of the wide tensor-core kernels, in bytes: the ring of
// d-steps and the slice's tiles (and dK/dV's lse, delta and p^T slots).
constexpr size_t fwd_tc_wide_smem_bytes(int w) {
  return 2 * static_cast<size_t>(TC_BQ) * w *
         (WIDE_STAGES * (FWD_WGS + 1) + 2);
}

constexpr size_t dq_tc_wide_smem_bytes(int w) {
  return 2 * static_cast<size_t>(TC_BQ) * w *
         (WIDE_STAGES * (2 * DQ_WGS + 2) + 2);
}

constexpr size_t dkv_tc_wide_smem_bytes(int w) {
  return 2 * static_cast<size_t>(TC_BQ) * w * (WIDE_STAGES * 4 + 4) +
         sizeof(float) * (4 * static_cast<size_t>(TC_BQ) + 32 * WG);
}

// The slices of head dim d: blockIdx.z's extent.
unsigned wide_slices(int d, int w) { return static_cast<unsigned>((d + w - 1) / w); }

template <int W>
int launch_fwd_tc_wide(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int H, int KV, int Tq, int S, int d,
                       Strides qs, Strides ks, Strides vs, Strides os,
                       float sc, int causal, cudaStream_t st) {
  const size_t smem = fwd_tc_wide_smem_bytes(W);
  const int err = opt_in(reinterpret_cast<const void*>(
                             flash_fwd_tc_wide_kernel<W>), smem);
  if (err) return err;
  const dim3 grid(B * H, (Tq + FWD_WGS * TC_BQ - 1) / (FWD_WGS * TC_BQ),
                  wide_slices(d, W));
  flash_fwd_tc_wide_kernel<W><<<grid, FWD_WGS * WG, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, H, KV, Tq, S,
      d, qs, ks, vs, os, sc, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int W>
int launch_dq_tc_wide(const BwdArgs& a) {
  const size_t smem = dq_tc_wide_smem_bytes(W);
  const int err = opt_in(reinterpret_cast<const void*>(
                             flash_bwd_dq_tc_wide_kernel<W>), smem);
  if (err) return err;
  const dim3 grid(a.B * a.H, (a.Tq + DQ_WGS * TC_BQ - 1) / (DQ_WGS * TC_BQ),
                  wide_slices(a.d, W));
  flash_bwd_dq_tc_wide_kernel<W><<<grid, DQ_WGS * WG, smem, a.st>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse,
      a.delta, static_cast<bf16*>(a.dq), a.H, a.KV, a.Tq, a.S, a.d, a.qs, a.ks,
      a.vs, a.dos, a.dqs, a.sc, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <int W>
int launch_dkv_tc_wide(const BwdArgs& a, float* dk_part, float* dv_part) {
  const size_t smem = dkv_tc_wide_smem_bytes(W);
  int err = opt_in(reinterpret_cast<const void*>(
                       flash_bwd_dkv_tc_wide_kernel<W>), smem);
  if (err) return err;
  const dim3 grid(a.B * a.H, (a.S + TC_BK - 1) / TC_BK, wide_slices(a.d, W));
  flash_bwd_dkv_tc_wide_kernel<W><<<grid, 2 * WG, smem, a.st>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse,
      a.delta, dk_part, dv_part, a.H, a.KV, a.Tq, a.S, a.d, a.qs, a.ks, a.vs,
      a.dos, a.sc, a.causal);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  const long long n4 = static_cast<long long>(a.B) * a.KV * a.S * (a.d / 4);
  const dim3 rgrid(static_cast<unsigned>((n4 + 255) / 256), 2);
  flash_dkv_reduce_kernel<bf16><<<rgrid, 256, 0, a.st>>>(
      dk_part, dv_part, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
      a.H, a.KV, a.S, a.d, a.dks, a.dvs, a.sc, n4);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Split-TF32 backward kernels (f32 operands, sm_90a wgmma .tf32)
// ---------------------------------------------------------------------------

// Keys a chunk (dQ) or query rows a chunk (dK/dV): 64 up to d 80, 32 above,
// where the split tiles of 64 would not fit a block's shared memory.
__host__ __device__ constexpr int tf32_chunk(int d) {
  return d <= 80 ? 64 : 32;
}

// Words of a row of a raw A tile (q and dO in dQ, K and V in dK/dV): d when
// d is a multiple of 32 (the columns are then XOR-swizzled by the row), else
// d + 4; either way the A fragments' loads hit 32 distinct banks.
__host__ __device__ constexpr int raw_row(int d) {
  return d % 32 == 0 ? d : d + 4;
}

template <int D>
__device__ __forceinline__ int raw_word(int r, int c) {
  if constexpr (D % 32 == 0)
    return r * D + (c ^ ((r & 7) << 2));
  else
    return r * (D + 4) + c;
}

// The slot of chunk position p in a transposed tile: of each group of 8,
// the even positions take slots 0-3 and the odd ones 4-7, the k order in
// which an accumulator's 8-column block is an A fragment (acc_frags).
__device__ __forceinline__ int tslot(int p) {
  return (p & ~7) | ((p & 7) >> 1) | ((p & 1) << 2);
}

// A natural tile (R rows, the keys or query rows of a chunk; D columns)
// lies K-major in TF32 core matrices (8 rows of 4 words): element (r, c) at
// word (c / 4) 4 R + 4 r + c % 4, so a 16-byte copy of 4 columns of a row
// lands whole; step kk (columns 8 kk ..) starts 32 R kk bytes in.
template <int R>
__device__ __forceinline__ uint64_t desc_nat(uint32_t tile, int kk) {
  return smem_desc(tile + kk * 32 * R, 16 * R, 128);
}

// A transposed tile (D rows, L slots): element (row, s) at word
// (s / 4)(4 D + 4) + 4 row + s % 4.  The 16 bytes between slot groups put
// the split pass's transposed stores (32 neighbouring chunk positions, one
// row) on 32 banks.
template <int D>
__device__ __forceinline__ uint64_t desc_trn(uint32_t tile, int kk) {
  return smem_desc(tile + kk * 2 * (16 * D + 16), 16 * D + 16, 128);
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// D (64 x 16, f32) = A (64 x 8, TF32 fragments in registers) B^T + D if
// scale_d else 0, B (16 x 8) K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32(float (&d)[8],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D (64 x 32, f32) = A (64 x 8, TF32 fragments in registers) B^T + D if
// scale_d else 0, B (32 x 8) K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) = A (64 x 8, TF32 fragments in registers) B^T + D if
// scale_d else 0, B (64 x 8) K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D (64 x 80, f32) = A (64 x 8, TF32 fragments in registers) B^T + D if
// scale_d else 0, B (80 x 8) K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32(float (&d)[40],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D (64 x 96, f32) = A (64 x 8, TF32 fragments in registers) B^T + D if
// scale_d else 0, B (96 x 8) K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32(float (&d)[48],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D (64 x 128, f32) = A (64 x 8, TF32 fragments in registers) B^T + D if
// scale_d else 0, B (128 x 8) K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// x -> (hi, lo) TF32 halves as the tensor cores read them: a .tf32
// operand's low 13 bits are ignored (checked on the card: with these
// halves the kernels agree with the plain backward as with cvt.rna ones),
// so hi is the f32 word itself, read as x with those bits cleared, and lo
// = x - that, exact in f32 and read with its own low 13 bits cleared: hi +
// lo is within 2^-20 |x| of x.  Two instructions, where cvt.rna.tf32.f32
// compiles to four a half.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x);
  lo = __float_as_uint(x - __uint_as_float(hi & 0xFFFFE000u));
}

// One k step of a split product, three wgmmas into one accumulator:
// a_hi b_hi + a_hi b_lo + a_lo b_hi (a product of two TF32 values is exact
// in f32; the dropped a_lo b_lo is below 2^-22 of the product).
template <int M>
__device__ __forceinline__ void mma3(float (&d)[M], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint64_t bh,
                                     uint64_t bl, int scale_d) {
  wgmma_tf32(d, ah, bh, scale_d);
  wgmma_tf32(d, ah, bl, 1);
  wgmma_tf32(d, al, bh, 1);
}

// Rows [r0, r0 + 64) of a (rows, d) f32 slab with row stride st into a raw
// A tile of D columns, zero past ``rows`` and in columns [d, D) (d a
// multiple of 4): 16-byte copies, a row's chunks by neighbouring threads.
template <int D>
__device__ __forceinline__ void load_raw(float* tile, const float* src,
                                         long long st, int r0, int rows,
                                         int d, int tid, int nthreads) {
  constexpr int CH = D / 4;
  for (int i = tid; i < TC_BQ * CH; i += nthreads) {
    const int r = i / CH;
    const int c = (i % CH) * 4;
    const int t = r0 + r;
    const bool in = t < rows && c < d;
    cp_async16(smem_u32(tile + raw_word<D>(r, c)),
               in ? static_cast<const void*>(src + t * st + c) : src,
               in ? 16 : 0);
  }
}

// Rows [r0, r0 + L) of a (rows, d) f32 slab into a natural tile of D
// columns, zero past ``rows`` and in columns [d, D): eight neighbouring rows
// of one 4-column chunk a warp quarter, so the stores fill whole core
// matrices.
template <int D, int L>
__device__ __forceinline__ void load_nat(float* tile, const float* src,
                                         long long st, int r0, int rows,
                                         int d, int tid, int nthreads) {
  constexpr int CH = D / 4;
  for (int i = tid; i < L * CH; i += nthreads) {
    const int r = (i % 8) + 8 * (i / (8 * CH));
    const int c4 = (i / 8) % CH;
    const int t = r0 + r;
    const bool in = t < rows && c4 * 4 < d;
    cp_async16(smem_u32(tile + c4 * 4 * L + 4 * r),
               in ? static_cast<const void*>(src + t * st + c4 * 4) : src,
               in ? 16 : 0);
  }
}

// The split pass over a natural tile nh as copied, which is its own hi
// half: with LO, lo into nl; with TRANS, both halves into the transposed
// tiles th and tl (the chunk positions in tslot order).  Each thread takes
// 4 columns of one row; 32 neighbouring rows a warp.
template <int D, int L, bool LO, bool TRANS>
__device__ __forceinline__ void split_tile(float* nh, float* nl, float* th,
                                           float* tl, int tid,
                                           int nthreads) {
  for (int i = tid; i < L * (D / 4); i += nthreads) {
    const int r = i % L;
    const int c4 = i / L;
    const int w = c4 * 4 * L + 4 * r;
    const float4 x = *reinterpret_cast<const float4*>(nh + w);
    const float xs[4] = {x.x, x.y, x.z, x.w};
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) split_tf32(xs[j], hi[j], lo[j]);
    if constexpr (LO)
      *reinterpret_cast<uint4*>(nl + w) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    if constexpr (TRANS) {
      const int s = tslot(r);
      const int t0 = (s >> 2) * (4 * D + 4) + 16 * c4 + (s & 3);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        th[t0 + 4 * j] = __uint_as_float(hi[j]);
        tl[t0 + 4 * j] = __uint_as_float(lo[j]);
      }
    }
  }
}

// The A fragment of step kk of a raw tile (rows row and row + 8, columns
// col = 8 kk + tig and col + 4), split into TF32 halves.
template <int D>
__device__ __forceinline__ void raw_frags(const float* X, int row, int col,
                                          uint32_t (&hi)[4],
                                          uint32_t (&lo)[4]) {
  split_tf32(X[raw_word<D>(row, col)], hi[0], lo[0]);
  split_tf32(X[raw_word<D>(row + 8, col)], hi[1], lo[1]);
  split_tf32(X[raw_word<D>(row, col + 4)], hi[2], lo[2]);
  split_tf32(X[raw_word<D>(row + 8, col + 4)], hi[3], lo[3]);
}

// An f32 accumulator (64 x L: rows warp*16 + gid (+8), columns n8*8 + 2 tig
// (+1)) as the split A fragments of a product over its columns: block n8 is
// step n8's fragment, (gid, 2 tig), (gid + 8, 2 tig), (gid, 2 tig + 1),
// (gid + 8, 2 tig + 1) in k slots tig, tig, tig + 4, tig + 4, so slot j of a
// step holds column 2 j (j < 4) or 2 (j - 4) + 1, the order tslot gives the
// transposed B tiles.
template <int L>
__device__ __forceinline__ void acc_frags(const float (&x)[L / 2],
                                          uint32_t (&hi)[L / 8][4],
                                          uint32_t (&lo)[L / 8][4]) {
#pragma unroll
  for (int n8 = 0; n8 < L / 8; ++n8) {
    split_tf32(x[4 * n8], hi[n8][0], lo[n8][0]);
    split_tf32(x[4 * n8 + 2], hi[n8][1], lo[n8][1]);
    split_tf32(x[4 * n8 + 1], hi[n8][2], lo[n8][2]);
    split_tf32(x[4 * n8 + 3], hi[n8][3], lo[n8][3]);
  }
}

// x = X B^T and, with TWO, y = Y C^T over D columns: X and Y raw 64-row
// tiles whose A fragments are loaded and split one step at a time into two
// register sets (each step's wgmmas are committed together and the next
// step waits for the one before, whose set it refills), B and C natural tile
// pairs (hi, lo; L rows).  One accumulator over the D / 8 steps; the wide
// kernels sum a d-step into x and y (``acc``) over its first ``ksteps``
// steps only.
template <int D, int L, bool TWO>
__device__ __forceinline__ void scores_tf32(float (&x)[L / 2],
                                            float (&y)[L / 2],
                                            const float* X, const float* Y,
                                            uint32_t bh, uint32_t bl,
                                            uint32_t ch, uint32_t cl,
                                            int row, int tig,
                                            bool acc = false,
                                            int ksteps = D / 8) {
  uint32_t f[2][4][4];
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    if (kk >= ksteps) break;
    uint32_t (&g)[4][4] = f[kk & 1];
    raw_frags<D>(X, row, 8 * kk + tig, g[0], g[1]);
    if constexpr (TWO) raw_frags<D>(Y, row, 8 * kk + tig, g[2], g[3]);
    wg_fence();
    mma3(x, g[0], g[1], desc_nat<L>(bh, kk), desc_nat<L>(bl, kk),
         acc || kk > 0);
    if constexpr (TWO)
      mma3(y, g[2], g[3], desc_nat<L>(ch, kk), desc_nat<L>(cl, kk),
           acc || kk > 0);
    wg_commit();
    wg_wait<1>();
  }
  wg_wait<0>();
  fence_regs(x);
  if constexpr (TWO) fence_regs(y);
}

// part (64 x D) = x B over one chunk: x an f32 accumulator (64 x L) as A
// fragments, B a transposed tile pair; L / 8 steps of three products into
// a fresh partial (scale_d 0 on the first), committed together, one wait.
template <int D, int L>
__device__ __forceinline__ void chunk_product(float (&part)[D / 2],
                                              const float (&x)[L / 2],
                                              uint32_t bh, uint32_t bl) {
  uint32_t hi[L / 8][4], lo[L / 8][4];
  acc_frags<L>(x, hi, lo);
  fence_regs(part);
  wg_fence();
#pragma unroll
  for (int n8 = 0; n8 < L / 8; ++n8)
    mma3(part, hi[n8], lo[n8], desc_trn<D>(bh, n8), desc_trn<D>(bl, n8),
         n8 > 0);
  wg_commit();
  wg_wait<0>();
  fence_regs(part);
}

// The forward in split TF32: one block per (b, query head, 128 query rows),
// longest causal rows first, two warpgroups of 64 rows each sharing the key
// chunks (L = tf32_chunk(D) keys).  Each warpgroup keeps its rows' q raw
// (f32) in shared memory; per chunk up to its diagonal:
//   s = q K^T                   (A: q split per step; B: K hi / lo)
//   the mask, the online softmax in base 2 and p      (registers)
//   part = p V, O = alpha O + part    (A: p split; B: V^T hi / lo)
// The chunk's K and V are copied raw, then split by the whole block in one
// pass (K's lo beside the copy, V's halves transposed only), and the next
// chunk's copies run under the softmax and p V once both warpgroups'
// scores are done.  O = acc / l and lse = m ln 2 + log l (m in base 2),
// each element written by one thread: the same bits on every run.
template <int D>
__global__ void __launch_bounds__(2 * WG, 1) flash_fwd_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, int H, int KV, int Tq, int S, int d, Strides qs,
    Strides ks, Strides vs, Strides os, float sc, int causal) {
  constexpr int L = tf32_chunk(D);
  constexpr int RAW = TC_BQ * raw_row(D);  // words of a raw tile
  constexpr int NAT = L * D;               // ... of a natural chunk tile
  constexpr int TRN = L * (D + 1);         // ... of a transposed one
  constexpr int NT = 2 * WG;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* Qr = reinterpret_cast<float*>(smem_raw);  // [2][RAW] q, by warpgroup
  float* Kh = Qr + 2 * RAW;   // K as copied: its hi half
  float* Kl = Kh + NAT;
  float* Vh = Kl + NAT;       // V as copied
  float* VTh = Vh + NAT;      // V^T, hi and lo
  float* VTl = VTh + TRN;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  // the longest causal rows first
  const int qi = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int wg = tid / WG;
  const int t = tid % WG;
  const int warp = t / 32;
  const int gid = (t % 32) / 4;
  const int tig = t % 4;
  const int qb0 = qi * 2 * TC_BQ;       // the block's first row
  const int q0 = qb0 + wg * TC_BQ;      // this warpgroup's first row
  const int row = warp * 16 + gid;      // this thread's rows: row, row + 8
  const int qrow = q0 + row;

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;
  const int kv_end = causal ? min(S, qb0 + 2 * TC_BQ) : S;
  const int nkv = (kv_end + L - 1) / L;
  // this warpgroup's chunks: those holding a key at or before its last row
  const int mine = causal ? min(nkv, (q0 + TC_BQ - 1) / L + 1) : nkv;
  auto load_chunk = [&](int c) {
    if (c < nkv) {
      load_nat<D, L>(Kh, kb, ks.t, c * L, S, d, tid, NT);
      load_nat<D, L>(Vh, vb, vs.t, c * L, S, d, tid, NT);
    }
    cp_commit();  // a group per chunk, empty past the last
  };
#pragma unroll
  for (int w = 0; w < 2; ++w)
    load_raw<D>(Qr + w * RAW, qb, qs.t, qb0 + w * TC_BQ, Tq, d, tid, NT);
  load_chunk(0);  // with q in its group

  const float scl = sc * LOG2E;
  const float* Xq = Qr + wg * RAW;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2], sum[2];

  for (int j = 0; j < nkv; ++j) {
    // chunk j landed; every warp is past chunk j - 1's products
    cp_wait<0>();
    __syncthreads();
    split_tile<D, L, true, false>(Kh, Kl, nullptr, nullptr, tid, NT);
    split_tile<D, L, false, true>(Vh, nullptr, VTh, VTl, tid, NT);
    fence_async_smem();  // the split tiles, written generically, for wgmma
    __syncthreads();
    const bool active = j < mine;  // at or before this warpgroup's diagonal
    const int kv0 = j * L;
    float s[L / 2] = {};
    if (active)
      scores_tf32<D, L, false>(s, s, Xq, Xq, smem_u32(Kh), smem_u32(Kl), 0,
                               0, row, tig);
    // both warpgroups' scores are done: chunk j + 1's copies refill K and V
    __syncthreads();
    load_chunk(j + 1);
    if (!active) continue;

    // the chunk holds keys past S or the causal diagonal
    softmax_chunk(s, m, alpha, sum, qrow, kv0, tig, S, causal,
                  kv0 + L > S || (causal && kv0 + L - 1 > q0), scl);
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];
    float part[D / 2];
    chunk_product<D, L>(part, s, smem_u32(VTh), smem_u32(VTl));
#pragma unroll
    for (int i = 0; i < D / 2; ++i)
      acc[i] = __fadd_rn(acc[i] * alpha[(i >> 1) & 1], part[i]);
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int tq = qrow + 8 * i;
    if (tq >= Tq) continue;
    const float li = fmaxf(l[i], 1e-30f);
    float* out = o + b * os.b + h * os.h + tq * os.t;
#pragma unroll
    for (int n8 = 0; n8 < D / 8; ++n8)
      if (n8 * 8 + tig * 2 < d)  // columns [d, D): V's zeros, not stored
        *reinterpret_cast<float2*>(out + n8 * 8 + tig * 2) = make_float2(
            acc[n8 * 4 + i * 2] / li, acc[n8 * 4 + i * 2 + 1] / li);
    if (tig == 0)  // m is in base 2
      lse[(static_cast<int64_t>(b) * H + h) * Tq + tq] = m[i] * LN2 + logf(li);
  }
}

// dQ in split TF32: one block per (b, query head, 128 query rows), longest
// causal rows first, two warpgroups of 64 rows each sharing the key chunks
// (L = tf32_chunk(D) keys).  Each warpgroup keeps its rows' q and dO raw
// (f32) in shared memory; per chunk up to its diagonal:
//   s = q K^T, dp = dO V^T      (A: q, dO split per step; B: K, V hi / lo)
//   p = exp(s sc - lse) in base 2, ds = p (dp - delta)        (registers)
//   part = ds K, dQ += part     (A: ds split; B: K^T hi / lo; rounded adds)
// The chunk's K and V are copied raw, then split by the whole block in one
// pass (K also transposed), and the next chunk's copies run under the
// products of ds once both warpgroups' scores are done.  dQ is scaled by sc
// at the end; each element is written by one thread: the same bits on
// every run.
template <int D>
__global__ void __launch_bounds__(2 * WG, 1) flash_bwd_dq_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int H, int KV, int Tq, int S, int d, Strides qs,
    Strides ks, Strides vs, Strides dos, Strides dqs, float sc, int causal) {
  constexpr int L = tf32_chunk(D);
  constexpr int RAW = TC_BQ * raw_row(D);  // words of a raw tile
  constexpr int NAT = L * D;               // ... of a natural chunk tile
  constexpr int TRN = L * (D + 1);         // ... of a transposed one
  constexpr int NT = 2 * WG;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* Qr = reinterpret_cast<float*>(smem_raw);  // [2][RAW] q, by warpgroup
  float* Or = Qr + 2 * RAW;                        // [2][RAW] dO
  float* Kh = Or + 2 * RAW;   // K as copied: its hi half
  float* Kl = Kh + NAT;
  float* Vh = Kl + NAT;       // V as copied: its hi half
  float* Vl = Vh + NAT;
  float* KTh = Vl + NAT;      // K^T, hi and lo
  float* KTl = KTh + TRN;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  // the longest causal rows first
  const int qi = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int wg = tid / WG;
  const int t = tid % WG;
  const int warp = t / 32;
  const int gid = (t % 32) / 4;
  const int tig = t % 4;
  const int qb0 = qi * 2 * TC_BQ;       // the block's first row
  const int q0 = qb0 + wg * TC_BQ;      // this warpgroup's first row
  const int row = warp * 16 + gid;      // this thread's rows: row, row + 8
  const int qrow = q0 + row;

  const float* qb = q + b * qs.b + h * qs.h;
  const float* dob = dout + b * dos.b + h * dos.h;
  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;
  const int kv_end = causal ? min(S, qb0 + 2 * TC_BQ) : S;
  const int nkv = (kv_end + L - 1) / L;
  // this warpgroup's chunks: those holding a key at or before its last row
  const int mine = causal ? min(nkv, (q0 + TC_BQ - 1) / L + 1) : nkv;
  auto load_chunk = [&](int c) {
    if (c < nkv) {
      load_nat<D, L>(Kh, kb, ks.t, c * L, S, d, tid, NT);
      load_nat<D, L>(Vh, vb, vs.t, c * L, S, d, tid, NT);
    }
    cp_commit();  // a group per chunk, empty past the last
  };
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    load_raw<D>(Qr + w * RAW, qb, qs.t, qb0 + w * TC_BQ, Tq, d, tid, NT);
    load_raw<D>(Or + w * RAW, dob, dos.t, qb0 + w * TC_BQ, Tq, d, tid, NT);
  }
  load_chunk(0);  // with q and dO in its group

  // the rows' lse (in base 2) and delta; rows past T weigh 0 (q and dO
  // are zero there, so ds = 1 * (0 - 0))
  const int64_t row0 = (static_cast<int64_t>(b) * H + h) * Tq;
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int tq = qrow + 8 * i;
    lse2[i] = tq < Tq ? lse[row0 + tq] * LOG2E : 0.f;
    dl[i] = tq < Tq ? delta[row0 + tq] : 0.f;
  }
  const float scl = sc * LOG2E;
  const float* Xq = Qr + wg * RAW;
  const float* Xo = Or + wg * RAW;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int j = 0; j < nkv; ++j) {
    // chunk j landed; every warp is past chunk j - 1's products
    cp_wait<0>();
    __syncthreads();
    split_tile<D, L, true, true>(Kh, Kl, KTh, KTl, tid, NT);
    split_tile<D, L, true, false>(Vh, Vl, nullptr, nullptr, tid, NT);
    fence_async_smem();  // the split tiles, written generically, for wgmma
    __syncthreads();
    const bool active = j < mine;  // at or before this warpgroup's diagonal
    const int kv0 = j * L;
    float s[L / 2] = {}, dp[L / 2] = {};
    if (active)
      scores_tf32<D, L, true>(s, dp, Xq, Xo, smem_u32(Kh), smem_u32(Kl),
                              smem_u32(Vh), smem_u32(Vl), row, tig);
    // both warpgroups' scores are done: chunk j + 1's copies refill K and V
    __syncthreads();
    load_chunk(j + 1);
    if (!active) continue;

    // the chunk holds keys past S or the causal diagonal
    const bool masked = kv0 + L > S || (causal && kv0 + L - 1 > q0);
#pragma unroll
    for (int n8 = 0; n8 < L / 8; ++n8)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int idx = n8 * 4 + r;
        const int i = r >> 1;
        const int kpos = kv0 + n8 * 8 + tig * 2 + (r & 1);
        const bool in =
            !masked || (kpos < S && !(causal && qrow + 8 * i < kpos));
        const float p = in ? exp2f(fmaf(s[idx], scl, -lse2[i])) : 0.f;
        s[idx] = p * (dp[idx] - dl[i]);
      }

    float part[D / 2] = {};
    chunk_product<D, L>(part, s, smem_u32(KTh), smem_u32(KTl));
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int tq = qrow + 8 * i;
    if (tq >= Tq) continue;
    float* out = dq + b * dqs.b + h * dqs.h + tq * dqs.t;
#pragma unroll
    for (int n8 = 0; n8 < D / 8; ++n8)
      if (n8 * 8 + tig * 2 < d)
        *reinterpret_cast<float2*>(out + n8 * 8 + tig * 2) = make_float2(
            acc[n8 * 4 + i * 2] * sc, acc[n8 * 4 + i * 2 + 1] * sc);
  }
}

// dK/dV in split TF32: one block per (b, query head, 64 keys), two
// warpgroups over the query chunks (L = tf32_chunk(D) rows) from the
// diagonal on; K and V stay raw (f32) in shared memory.  Per chunk, after
// the block's split pass over q and dO (hi in place, lo, and both
// transposed):
//   warpgroup 0: s^T = K q^T (A: K split per step; B: q hi / lo),
//                p^T = exp(s^T sc - lse), dV += p^T dO (B: dO^T hi / lo)
//   warpgroup 1: dp^T = V dO^T, ds^T = p^T (dp^T - delta),
//                dK += ds^T q (B: q^T hi / lo)
// p^T passes from 0 to 1 through shared memory (one f32 slot a thread and
// element) behind the block barrier after both score products, which also
// frees q's and dO's natural tiles for the next chunk's copies.  Each
// chunk's product sums into a fresh partial, added with rounded adds.  The
// sums go to dk_out and dv_out at (b, h, s) with strides dko and dvo, dK
// times ksc: dK and dV themselves when G = 1 (ksc = sc), per query head f32
// scratch when G > 1 (ksc = 1), summed by flash_dkv_reduce_kernel.
template <int D>
__global__ void __launch_bounds__(2 * WG, 1) flash_bwd_dkv_tf32_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk_out, float* __restrict__ dv_out, int H, int KV,
    int Tq, int S, int d, Strides qs, Strides ks, Strides vs, Strides dos,
    Strides dko, Strides dvo, float ksc, float sc, int causal) {
  constexpr int L = tf32_chunk(D);
  constexpr int RAW = TC_BQ * raw_row(D);
  constexpr int NAT = L * D;
  constexpr int TRN = L * (D + 1);
  constexpr int NT = 2 * WG;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* Kr = reinterpret_cast<float*>(smem_raw);  // [RAW] the block's keys
  float* Vr = Kr + RAW;                            // [RAW] their values
  float* Qh = Vr + RAW;    // the chunk's q as copied: its hi half
  float* Ql = Qh + NAT;
  float* Oh = Ql + NAT;    // its dO as copied: its hi half
  float* Ol = Oh + NAT;
  float* QTh = Ol + NAT;   // q^T, hi and lo
  float* QTl = QTh + TRN;
  float* OTh = QTl + TRN;  // dO^T, hi and lo
  float* OTl = OTh + TRN;
  float* Ls = OTl + TRN;   // [2][L] lse, by chunk parity
  float* Dl = Ls + 2 * L;  // [2][L] delta
  float* Pex = Dl + 2 * L; // [L / 2][WG]

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kvh = h / (H / KV);
  const int k0 = blockIdx.y * TC_BK;  // blockIdx.y = 0 (most q chunks) first
  const int tid = threadIdx.x;
  const int wg = tid / WG;
  const int t = tid % WG;
  const int warp = t / 32;
  const int gid = (t % 32) / 4;
  const int tig = t % 4;
  const int row = warp * 16 + gid;  // this thread's keys: k0 + row, + 8

  const float* qb = q + b * qs.b + h * qs.h;
  const float* dob = dout + b * dos.b + h * dos.h;
  const int64_t row0 = (static_cast<int64_t>(b) * H + h) * Tq;
  const int nq = (Tq + L - 1) / L;
  const int lo_q = causal ? k0 / L : 0;  // the first q chunk that sees k0

  // a group per q chunk (empty past the last): its q and dO into the
  // natural tiles, its lse and delta (zero past T) into slot qc % 2
  auto stage = [&](int qc) {
    if (qc < nq) {
      const int q0 = qc * L;
      load_nat<D, L>(Qh, qb, qs.t, q0, Tq, d, tid, NT);
      load_nat<D, L>(Oh, dob, dos.t, q0, Tq, d, tid, NT);
      if (tid < 2 * L) {
        const int r = tid % L;
        const int tq = q0 + r;
        const float* src = (tid < L ? lse : delta) + row0;
        cp_async4(smem_u32((tid < L ? Ls : Dl) + (qc & 1) * L + r),
                  tq < Tq ? src + tq : src, tq < Tq ? 4 : 0);
      }
    }
    cp_commit();
  };
  load_raw<D>(Kr, k + b * ks.b + kvh * ks.h, ks.t, k0, S, d, tid, NT);
  load_raw<D>(Vr, v + b * vs.b + kvh * vs.h, vs.t, k0, S, d, tid, NT);
  stage(lo_q);  // K and V go with the first q chunk's group

  const float scl = sc * LOG2E;
  float acc[D / 2];  // dV (warpgroup 0) or dK (warpgroup 1), unscaled
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  for (int qc = lo_q; qc < nq; ++qc) {
    // chunk qc landed; every thread is past chunk qc - 1's products
    cp_wait<0>();
    __syncthreads();
    split_tile<D, L, true, true>(Qh, Ql, QTh, QTl, tid, NT);
    split_tile<D, L, true, true>(Oh, Ol, OTh, OTl, tid, NT);
    fence_async_smem();
    __syncthreads();

    const int q0 = qc * L;
    const float* Lst = Ls + (qc & 1) * L;
    const float* Dst = Dl + (qc & 1) * L;
    float x[L / 2] = {};
    if (wg == 0)
      scores_tf32<D, L, false>(x, x, Kr, Kr, smem_u32(Qh), smem_u32(Ql), 0,
                               0, row, tig);
    else
      scores_tf32<D, L, false>(x, x, Vr, Vr, smem_u32(Oh), smem_u32(Ol), 0,
                               0, row, tig);

    // the tile holds keys past S, rows past T, or the causal diagonal
    const bool masked =
        k0 + TC_BK > S || q0 + L > Tq || (causal && q0 < k0 + TC_BK - 1);
    if (wg == 0) {
#pragma unroll
      for (int n8 = 0; n8 < L / 8; ++n8)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int idx = n8 * 4 + r;
          const int kpos = k0 + row + 8 * (r >> 1);
          const int c = n8 * 8 + tig * 2 + (r & 1);
          const int qpos = q0 + c;
          const bool in = !masked || (kpos < S && qpos < Tq &&
                                      !(causal && qpos < kpos));
          // exp(s sc - lse) in base 2
          const float p =
              in ? exp2f(fmaf(x[idx], scl, -Lst[c] * LOG2E)) : 0.f;
          x[idx] = p;
          Pex[idx * WG + t] = p;
        }
    }
    // p^T for warpgroup 1; both warpgroups' scores are done: chunk qc + 1's
    // copies refill q's and dO's natural tiles and the other lse slot
    __syncthreads();
    stage(qc + 1);
    if (wg == 1) {
#pragma unroll
      for (int n8 = 0; n8 < L / 8; ++n8)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int idx = n8 * 4 + r;
          const int c = n8 * 8 + tig * 2 + (r & 1);
          x[idx] = Pex[idx * WG + t] * (x[idx] - Dst[c]);
        }
    }

    float part[D / 2] = {};
    chunk_product<D, L>(part, x, smem_u32(wg == 0 ? OTh : QTh),
                        smem_u32(wg == 0 ? OTl : QTl));
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
  }
  cp_wait<0>();  // a block with no q chunk leaves no copy in flight

  float* out = wg == 0 ? dv_out : dk_out;
  const Strides o = wg == 0 ? dvo : dko;
  const float f = wg == 0 ? 1.f : ksc;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = k0 + row + 8 * i;
    if (s >= S) continue;
    float* dst = out + b * o.b + h * o.h + s * o.t;
#pragma unroll
    for (int n8 = 0; n8 < D / 8; ++n8)
      if (n8 * 8 + tig * 2 < d)
        *reinterpret_cast<float2*>(dst + n8 * 8 + tig * 2) = make_float2(
            acc[n8 * 4 + i * 2] * f, acc[n8 * 4 + i * 2 + 1] * f);
  }
}

// Shared memory of the split-TF32 kernels, in bytes: the forward two raw q
// tiles, the chunk's K (hi, lo), V as copied and V^T (hi, lo); dQ two raw q and two
// raw dO tiles, the chunk's K and V (hi, lo) and K^T (hi, lo); dK/dV raw K
// and V, the chunk's q and dO (hi, lo), both transposed (hi, lo), two slots
// of lse and delta and the p^T exchange.
constexpr size_t fwd_tf32_smem_bytes(int d) {
  return 4 * (2 * static_cast<size_t>(TC_BQ) * raw_row(d) +
              static_cast<size_t>(tf32_chunk(d)) * (3 * d + 2 * (d + 1)));
}

constexpr size_t dq_tf32_smem_bytes(int d) {
  return 4 * (4 * static_cast<size_t>(TC_BQ) * raw_row(d) +
              static_cast<size_t>(tf32_chunk(d)) * (4 * d + 2 * (d + 1)));
}

constexpr size_t dkv_tf32_smem_bytes(int d) {
  return 4 * (2 * static_cast<size_t>(TC_BQ) * raw_row(d) +
              static_cast<size_t>(tf32_chunk(d)) *
                  (4 * d + 4 * (d + 1) + 4 + WG / 2));
}

template <int D>
int launch_fwd_tf32(const void* q, const void* k, const void* v, void* o,
                    float* lse, int B, int H, int KV, int Tq, int S, int d,
                    Strides qs, Strides ks, Strides vs, Strides os, float sc,
                    int causal, cudaStream_t st) {
  const size_t smem = fwd_tf32_smem_bytes(D);
  const int err = opt_in(reinterpret_cast<const void*>(
                             flash_fwd_tf32_kernel<D>), smem);
  if (err) return err;
  const dim3 grid(B * H, (Tq + 2 * TC_BQ - 1) / (2 * TC_BQ));
  flash_fwd_tf32_kernel<D><<<grid, 2 * WG, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H, KV, Tq,
      S, d, qs, ks, vs, os, sc, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq_tf32(const BwdArgs& a) {
  const size_t smem = dq_tf32_smem_bytes(D);
  const int err = opt_in(reinterpret_cast<const void*>(
                             flash_bwd_dq_tf32_kernel<D>), smem);
  if (err) return err;
  const dim3 grid(a.B * a.H, (a.Tq + 2 * TC_BQ - 1) / (2 * TC_BQ));
  flash_bwd_dq_tf32_kernel<D><<<grid, 2 * WG, smem, a.st>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.dq), a.H, a.KV, a.Tq, a.S, a.d,
      a.qs,
      a.ks, a.vs, a.dos, a.dqs, a.sc, a.causal);
  return static_cast<int>(cudaGetLastError());
}

// The caller chooses: null dk_part and dv_part (only at G = H / KV = 1):
// the kernel writes dK and dV; else per query head sums into dk_part and
// dv_part ((B, H, S, d) f32), then the group sum.
template <int D>
int launch_dkv_tf32(const BwdArgs& a, float* dk_part, float* dv_part) {
  const bool direct = dk_part == nullptr;
  if (direct != (dv_part == nullptr) || (direct && a.H != a.KV))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = dkv_tf32_smem_bytes(D);
  int err = opt_in(reinterpret_cast<const void*>(flash_bwd_dkv_tf32_kernel<D>),
                   smem);
  if (err) return err;
  const Strides part{static_cast<long long>(a.H) * a.S * a.d,
                     static_cast<long long>(a.S) * a.d, a.d};
  const dim3 grid(a.B * a.H, (a.S + TC_BK - 1) / TC_BK);
  flash_bwd_dkv_tf32_kernel<D><<<grid, 2 * WG, smem, a.st>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, direct ? static_cast<float*>(a.dk) : dk_part,
      direct ? static_cast<float*>(a.dv) : dv_part, a.H, a.KV, a.Tq, a.S, a.d,
      a.qs, a.ks, a.vs, a.dos, direct ? a.dks : part, direct ? a.dvs : part,
      direct ? a.sc : 1.f, a.sc, a.causal);
  err = static_cast<int>(cudaGetLastError());
  if (err || direct) return err;
  const long long n4 = static_cast<long long>(a.B) * a.KV * a.S * (a.d / 4);
  const dim3 rgrid(static_cast<unsigned>((n4 + 255) / 256), 2);
  flash_dkv_reduce_kernel<float><<<rgrid, 256, 0, a.st>>>(
      dk_part, dv_part, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      a.H, a.KV, a.S, a.d, a.dks, a.dvs, a.sc, n4);
  return static_cast<int>(cudaGetLastError());
}

// The split-TF32 kernels at d > 128 (the output-column split above), at
// W = WIDE: each keeps the D = W kernel's shared memory, its tiles holding
// one d-step at a time (raw q, dO, K, V and the natural tiles of the
// chunk), and the slice's transposed tiles (V^T; K^T; q^T and dO^T), split
// from the natural tiles of d-step z.  The score products of each d-step
// (three TF32 products a k step) sum into one accumulator; the d-step's
// copies land before its split pass, and the next d-step's copies run
// under the last one's softmax and products.

// The split-TF32 forward at d > 128, for O's columns [z W, z W + W).
template <int W>
__global__ void __launch_bounds__(2 * WG, 1) flash_fwd_tf32_wide_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, int H, int KV, int Tq, int S, int d, Strides qs,
    Strides ks, Strides vs, Strides os, float sc, int causal) {
  constexpr int L = tf32_chunk(W);
  constexpr int RAW = TC_BQ * raw_row(W);
  constexpr int NAT = L * W;
  constexpr int TRN = L * (W + 1);
  constexpr int NT = 2 * WG;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* Qr = reinterpret_cast<float*>(smem_raw);  // [2][RAW] a d-step of q
  float* Kh = Qr + 2 * RAW;   // ... of K, as copied: its hi half
  float* Kl = Kh + NAT;
  float* Vh = Kl + NAT;       // V's slice as copied
  float* VTh = Vh + NAT;      // V's slice transposed, hi and lo
  float* VTl = VTh + TRN;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int qi = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int z = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int wg = tid / WG;
  const int t = tid % WG;
  const int warp = t / 32;
  const int gid = (t % 32) / 4;
  const int tig = t % 4;
  const int qb0 = qi * 2 * TC_BQ;
  const int q0 = qb0 + wg * TC_BQ;
  const int row = warp * 16 + gid;
  const int qrow = q0 + row;
  const int c0 = z * W;
  const int dz = min(W, d - c0);
  const int ne = (d + W - 1) / W;

  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;
  const int kv_end = causal ? min(S, qb0 + 2 * TC_BQ) : S;
  const int nkv = (kv_end + L - 1) / L;
  const int mine = causal ? min(nkv, (q0 + TC_BQ - 1) / L + 1) : nkv;
  const int nu = nkv * ne;
  auto load_step = [&](int u) {
    if (u < nu) {
      const int j = u / ne, e = u % ne;
      const int cols = min(W, d - e * W);
#pragma unroll
      for (int w = 0; w < 2; ++w)
        load_raw<W>(Qr + w * RAW, qb + e * W, qs.t, qb0 + w * TC_BQ, Tq, cols,
                    tid, NT);
      load_nat<W, L>(Kh, kb + e * W, ks.t, j * L, S, cols, tid, NT);
      if (e == z) load_nat<W, L>(Vh, vb + c0, vs.t, j * L, S, dz, tid, NT);
    }
    cp_commit();
  };
  load_step(0);

  const float scl = sc * LOG2E;
  const float* Xq = Qr + wg * RAW;
  float acc[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2], sum[2];
  float s[L / 2] = {};

  for (int u = 0; u < nu; ++u) {
    // unit u landed; every warp is past unit u - 1's products
    cp_wait<0>();
    __syncthreads();
    const int j = u / ne, e = u % ne;
    split_tile<W, L, true, false>(Kh, Kl, nullptr, nullptr, tid, NT);
    if (e == z) split_tile<W, L, false, true>(Vh, nullptr, VTh, VTl, tid, NT);
    fence_async_smem();
    __syncthreads();
    const bool active = j < mine;
    if (active)
      scores_tf32<W, L, false>(s, s, Xq, Xq, smem_u32(Kh), smem_u32(Kl), 0,
                               0, row, tig, e > 0,
                               (min(W, d - e * W) + 7) / 8);
    // both warpgroups' scores are done: unit u + 1's copies refill q and K
    __syncthreads();
    load_step(u + 1);
    if (!active || e < ne - 1) continue;

    const int kv0 = j * L;
    softmax_chunk(s, m, alpha, sum, qrow, kv0, tig, S, causal,
                  kv0 + L > S || (causal && kv0 + L - 1 > q0), scl);
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];
    float part[W / 2];
    chunk_product<W, L>(part, s, smem_u32(VTh), smem_u32(VTl));
#pragma unroll
    for (int i = 0; i < W / 2; ++i)
      acc[i] = __fadd_rn(acc[i] * alpha[(i >> 1) & 1], part[i]);
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int tq = qrow + 8 * i;
    if (tq >= Tq) continue;
    const float li = fmaxf(l[i], 1e-30f);
    float* out = o + b * os.b + h * os.h + tq * os.t + c0;
#pragma unroll
    for (int n8 = 0; n8 < W / 8; ++n8)
      if (n8 * 8 + tig * 2 < dz)
        *reinterpret_cast<float2*>(out + n8 * 8 + tig * 2) = make_float2(
            acc[n8 * 4 + i * 2] / li, acc[n8 * 4 + i * 2 + 1] / li);
    if (tig == 0 && z == 0)  // m is in base 2
      lse[(static_cast<int64_t>(b) * H + h) * Tq + tq] = m[i] * LN2 + logf(li);
  }
}

// The split-TF32 dQ at d > 128, for dQ's columns [z W, z W + W); K's slice
// is d-step z's K tile, so its split pass also writes K^T there.
template <int W>
__global__ void __launch_bounds__(2 * WG, 1) flash_bwd_dq_tf32_wide_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int H, int KV, int Tq, int S, int d, Strides qs,
    Strides ks, Strides vs, Strides dos, Strides dqs, float sc, int causal) {
  constexpr int L = tf32_chunk(W);
  constexpr int RAW = TC_BQ * raw_row(W);
  constexpr int NAT = L * W;
  constexpr int TRN = L * (W + 1);
  constexpr int NT = 2 * WG;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* Qr = reinterpret_cast<float*>(smem_raw);  // [2][RAW] a d-step of q
  float* Or = Qr + 2 * RAW;                        // [2][RAW] ... of dO
  float* Kh = Or + 2 * RAW;   // ... of K, as copied: its hi half
  float* Kl = Kh + NAT;
  float* Vh = Kl + NAT;       // ... of V, as copied
  float* Vl = Vh + NAT;
  float* KTh = Vl + NAT;      // K's slice transposed, hi and lo
  float* KTl = KTh + TRN;

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int qi = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int z = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int wg = tid / WG;
  const int t = tid % WG;
  const int warp = t / 32;
  const int gid = (t % 32) / 4;
  const int tig = t % 4;
  const int qb0 = qi * 2 * TC_BQ;
  const int q0 = qb0 + wg * TC_BQ;
  const int row = warp * 16 + gid;
  const int qrow = q0 + row;
  const int c0 = z * W;
  const int dz = min(W, d - c0);
  const int ne = (d + W - 1) / W;

  const float* qb = q + b * qs.b + h * qs.h;
  const float* dob = dout + b * dos.b + h * dos.h;
  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;
  const int kv_end = causal ? min(S, qb0 + 2 * TC_BQ) : S;
  const int nkv = (kv_end + L - 1) / L;
  const int mine = causal ? min(nkv, (q0 + TC_BQ - 1) / L + 1) : nkv;
  const int nu = nkv * ne;
  auto load_step = [&](int u) {
    if (u < nu) {
      const int j = u / ne, e = u % ne;
      const int cols = min(W, d - e * W);
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        load_raw<W>(Qr + w * RAW, qb + e * W, qs.t, qb0 + w * TC_BQ, Tq, cols,
                    tid, NT);
        load_raw<W>(Or + w * RAW, dob + e * W, dos.t, qb0 + w * TC_BQ, Tq,
                    cols, tid, NT);
      }
      load_nat<W, L>(Kh, kb + e * W, ks.t, j * L, S, cols, tid, NT);
      load_nat<W, L>(Vh, vb + e * W, vs.t, j * L, S, cols, tid, NT);
    }
    cp_commit();
  };
  load_step(0);

  const int64_t row0 = (static_cast<int64_t>(b) * H + h) * Tq;
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int tq = qrow + 8 * i;
    lse2[i] = tq < Tq ? lse[row0 + tq] * LOG2E : 0.f;
    dl[i] = tq < Tq ? delta[row0 + tq] : 0.f;
  }
  const float scl = sc * LOG2E;
  const float* Xq = Qr + wg * RAW;
  const float* Xo = Or + wg * RAW;

  float acc[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) acc[i] = 0.f;
  float s[L / 2] = {}, dp[L / 2] = {};

  for (int u = 0; u < nu; ++u) {
    cp_wait<0>();
    __syncthreads();
    const int j = u / ne, e = u % ne;
    if (e == z)
      split_tile<W, L, true, true>(Kh, Kl, KTh, KTl, tid, NT);
    else
      split_tile<W, L, true, false>(Kh, Kl, nullptr, nullptr, tid, NT);
    split_tile<W, L, true, false>(Vh, Vl, nullptr, nullptr, tid, NT);
    fence_async_smem();
    __syncthreads();
    const bool active = j < mine;
    if (active)
      scores_tf32<W, L, true>(s, dp, Xq, Xo, smem_u32(Kh), smem_u32(Kl),
                              smem_u32(Vh), smem_u32(Vl), row, tig, e > 0,
                              (min(W, d - e * W) + 7) / 8);
    __syncthreads();
    load_step(u + 1);
    if (!active || e < ne - 1) continue;

    const int kv0 = j * L;
    const bool masked = kv0 + L > S || (causal && kv0 + L - 1 > q0);
#pragma unroll
    for (int n8 = 0; n8 < L / 8; ++n8)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int idx = n8 * 4 + r;
        const int i = r >> 1;
        const int kpos = kv0 + n8 * 8 + tig * 2 + (r & 1);
        const bool in =
            !masked || (kpos < S && !(causal && qrow + 8 * i < kpos));
        const float p = in ? exp2f(fmaf(s[idx], scl, -lse2[i])) : 0.f;
        s[idx] = p * (dp[idx] - dl[i]);
      }

    float part[W / 2] = {};
    chunk_product<W, L>(part, s, smem_u32(KTh), smem_u32(KTl));
#pragma unroll
    for (int i = 0; i < W / 2; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int tq = qrow + 8 * i;
    if (tq >= Tq) continue;
    float* out = dq + b * dqs.b + h * dqs.h + tq * dqs.t + c0;
#pragma unroll
    for (int n8 = 0; n8 < W / 8; ++n8)
      if (n8 * 8 + tig * 2 < dz)
        *reinterpret_cast<float2*>(out + n8 * 8 + tig * 2) = make_float2(
            acc[n8 * 4 + i * 2] * sc, acc[n8 * 4 + i * 2 + 1] * sc);
  }
}

// The split-TF32 dK/dV at d > 128, for dK's and dV's columns [z W, z W +
// W): K and V stream with q and dO a d-step at a time; q's and dO's slices
// are d-step z's natural tiles, so their split pass also writes q^T and
// dO^T there; the rows' lse and delta are copied with d-step 0.
template <int W>
__global__ void __launch_bounds__(2 * WG, 1) flash_bwd_dkv_tf32_wide_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk_out, float* __restrict__ dv_out, int H, int KV,
    int Tq, int S, int d, Strides qs, Strides ks, Strides vs, Strides dos,
    Strides dko, Strides dvo, float ksc, float sc, int causal) {
  constexpr int L = tf32_chunk(W);
  constexpr int RAW = TC_BQ * raw_row(W);
  constexpr int NAT = L * W;
  constexpr int TRN = L * (W + 1);
  constexpr int NT = 2 * WG;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* Kr = reinterpret_cast<float*>(smem_raw);  // [RAW] a d-step of K
  float* Vr = Kr + RAW;                            // [RAW] ... of V
  float* Qh = Vr + RAW;    // ... of the chunk's q, as copied: its hi half
  float* Ql = Qh + NAT;
  float* Oh = Ql + NAT;    // ... of its dO
  float* Ol = Oh + NAT;
  float* QTh = Ol + NAT;   // q's slice transposed, hi and lo
  float* QTl = QTh + TRN;
  float* OTh = QTl + TRN;  // dO's slice transposed, hi and lo
  float* OTl = OTh + TRN;
  float* Ls = OTl + TRN;   // [2][L] lse, by chunk parity
  float* Dl = Ls + 2 * L;  // [2][L] delta
  float* Pex = Dl + 2 * L; // [L / 2][WG]

  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kvh = h / (H / KV);
  const int k0 = blockIdx.y * TC_BK;
  const int z = blockIdx.z;
  const int tid = threadIdx.x;
  const int wg = tid / WG;
  const int t = tid % WG;
  const int warp = t / 32;
  const int gid = (t % 32) / 4;
  const int tig = t % 4;
  const int row = warp * 16 + gid;
  const int c0 = z * W;
  const int dz = min(W, d - c0);
  const int ne = (d + W - 1) / W;

  const float* qb = q + b * qs.b + h * qs.h;
  const float* dob = dout + b * dos.b + h * dos.h;
  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;
  const int64_t row0 = (static_cast<int64_t>(b) * H + h) * Tq;
  const int nq = (Tq + L - 1) / L;
  const int lo_q = causal ? k0 / L : 0;
  const int nu = max(nq - lo_q, 0) * ne;
  auto load_step = [&](int u) {
    if (u < nu) {
      const int qc = lo_q + u / ne, e = u % ne;
      const int cols = min(W, d - e * W);
      const int q0 = qc * L;
      load_raw<W>(Kr, kb + e * W, ks.t, k0, S, cols, tid, NT);
      load_raw<W>(Vr, vb + e * W, vs.t, k0, S, cols, tid, NT);
      load_nat<W, L>(Qh, qb + e * W, qs.t, q0, Tq, cols, tid, NT);
      load_nat<W, L>(Oh, dob + e * W, dos.t, q0, Tq, cols, tid, NT);
      if (e == 0 && tid < 2 * L) {
        const int r = tid % L;
        const int tq = q0 + r;
        const float* src = (tid < L ? lse : delta) + row0;
        cp_async4(smem_u32((tid < L ? Ls : Dl) + (qc & 1) * L + r),
                  tq < Tq ? src + tq : src, tq < Tq ? 4 : 0);
      }
    }
    cp_commit();
  };
  load_step(0);

  const float scl = sc * LOG2E;
  float acc[W / 2];  // dV (warpgroup 0) or dK (warpgroup 1), unscaled
#pragma unroll
  for (int i = 0; i < W / 2; ++i) acc[i] = 0.f;
  float x[L / 2] = {};

  for (int u = 0; u < nu; ++u) {
    cp_wait<0>();
    __syncthreads();
    const int qc = lo_q + u / ne, e = u % ne;
    if (e == z) {
      split_tile<W, L, true, true>(Qh, Ql, QTh, QTl, tid, NT);
      split_tile<W, L, true, true>(Oh, Ol, OTh, OTl, tid, NT);
    } else {
      split_tile<W, L, true, false>(Qh, Ql, nullptr, nullptr, tid, NT);
      split_tile<W, L, true, false>(Oh, Ol, nullptr, nullptr, tid, NT);
    }
    fence_async_smem();
    __syncthreads();

    const int steps = (min(W, d - e * W) + 7) / 8;
    if (wg == 0)
      scores_tf32<W, L, false>(x, x, Kr, Kr, smem_u32(Qh), smem_u32(Ql), 0,
                               0, row, tig, e > 0, steps);
    else
      scores_tf32<W, L, false>(x, x, Vr, Vr, smem_u32(Oh), smem_u32(Ol), 0,
                               0, row, tig, e > 0, steps);
    const bool last = e == ne - 1;
    const int q0 = qc * L;
    const float* Lst = Ls + (qc & 1) * L;
    const float* Dst = Dl + (qc & 1) * L;
    if (last && wg == 0) {
      const bool masked =
          k0 + TC_BK > S || q0 + L > Tq || (causal && q0 < k0 + TC_BK - 1);
#pragma unroll
      for (int n8 = 0; n8 < L / 8; ++n8)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int idx = n8 * 4 + r;
          const int kpos = k0 + row + 8 * (r >> 1);
          const int c = n8 * 8 + tig * 2 + (r & 1);
          const int qpos = q0 + c;
          const bool in = !masked || (kpos < S && qpos < Tq &&
                                      !(causal && qpos < kpos));
          const float p =
              in ? exp2f(fmaf(x[idx], scl, -Lst[c] * LOG2E)) : 0.f;
          x[idx] = p;
          Pex[idx * WG + t] = p;
        }
    }
    // p^T for warpgroup 1; both warpgroups' scores are done: unit u + 1's
    // copies refill the d-step's tiles
    __syncthreads();
    load_step(u + 1);
    if (!last) continue;
    if (wg == 1) {
#pragma unroll
      for (int n8 = 0; n8 < L / 8; ++n8)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int idx = n8 * 4 + r;
          const int c = n8 * 8 + tig * 2 + (r & 1);
          x[idx] = Pex[idx * WG + t] * (x[idx] - Dst[c]);
        }
    }

    float part[W / 2] = {};
    chunk_product<W, L>(part, x, smem_u32(wg == 0 ? OTh : QTh),
                        smem_u32(wg == 0 ? OTl : QTl));
#pragma unroll
    for (int i = 0; i < W / 2; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
  }
  cp_wait<0>();

  float* out = wg == 0 ? dv_out : dk_out;
  const Strides os = wg == 0 ? dvo : dko;
  const float f = wg == 0 ? 1.f : ksc;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int s = k0 + row + 8 * i;
    if (s >= S) continue;
    float* dst = out + b * os.b + h * os.h + s * os.t + c0;
#pragma unroll
    for (int n8 = 0; n8 < W / 8; ++n8)
      if (n8 * 8 + tig * 2 < dz)
        *reinterpret_cast<float2*>(dst + n8 * 8 + tig * 2) = make_float2(
            acc[n8 * 4 + i * 2] * f, acc[n8 * 4 + i * 2 + 1] * f);
  }
}

template <int W>
int launch_fwd_tf32_wide(const void* q, const void* k, const void* v, void* o,
                         float* lse, int B, int H, int KV, int Tq, int S,
                         int d, Strides qs, Strides ks, Strides vs,
                         Strides os, float sc, int causal, cudaStream_t st) {
  const size_t smem = fwd_tf32_smem_bytes(W);
  const int err = opt_in(reinterpret_cast<const void*>(
                             flash_fwd_tf32_wide_kernel<W>), smem);
  if (err) return err;
  const dim3 grid(B * H, (Tq + 2 * TC_BQ - 1) / (2 * TC_BQ),
                  wide_slices(d, W));
  flash_fwd_tf32_wide_kernel<W><<<grid, 2 * WG, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H, KV, Tq,
      S, d, qs, ks, vs, os, sc, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int W>
int launch_dq_tf32_wide(const BwdArgs& a) {
  const size_t smem = dq_tf32_smem_bytes(W);
  const int err = opt_in(reinterpret_cast<const void*>(
                             flash_bwd_dq_tf32_wide_kernel<W>), smem);
  if (err) return err;
  const dim3 grid(a.B * a.H, (a.Tq + 2 * TC_BQ - 1) / (2 * TC_BQ),
                  wide_slices(a.d, W));
  flash_bwd_dq_tf32_wide_kernel<W><<<grid, 2 * WG, smem, a.st>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, static_cast<float*>(a.dq), a.H, a.KV, a.Tq, a.S, a.d,
      a.qs, a.ks, a.vs, a.dos, a.dqs, a.sc, a.causal);
  return static_cast<int>(cudaGetLastError());
}

// As launch_dkv_tf32: null dk_part and dv_part (only at G = 1) write dK and
// dV directly, else per query head sums and the group sum.
template <int W>
int launch_dkv_tf32_wide(const BwdArgs& a, float* dk_part, float* dv_part) {
  const bool direct = dk_part == nullptr;
  if (direct != (dv_part == nullptr) || (direct && a.H != a.KV))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = dkv_tf32_smem_bytes(W);
  int err = opt_in(reinterpret_cast<const void*>(
                       flash_bwd_dkv_tf32_wide_kernel<W>), smem);
  if (err) return err;
  const Strides part{static_cast<long long>(a.H) * a.S * a.d,
                     static_cast<long long>(a.S) * a.d, a.d};
  const dim3 grid(a.B * a.H, (a.S + TC_BK - 1) / TC_BK, wide_slices(a.d, W));
  flash_bwd_dkv_tf32_wide_kernel<W><<<grid, 2 * WG, smem, a.st>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, direct ? static_cast<float*>(a.dk) : dk_part,
      direct ? static_cast<float*>(a.dv) : dv_part, a.H, a.KV, a.Tq, a.S, a.d,
      a.qs, a.ks, a.vs, a.dos, direct ? a.dks : part, direct ? a.dvs : part,
      direct ? a.sc : 1.f, a.sc, a.causal);
  err = static_cast<int>(cudaGetLastError());
  if (err || direct) return err;
  const long long n4 = static_cast<long long>(a.B) * a.KV * a.S * (a.d / 4);
  const dim3 rgrid(static_cast<unsigned>((n4 + 255) / 256), 2);
  flash_dkv_reduce_kernel<float><<<rgrid, 256, 0, a.st>>>(
      dk_part, dv_part, static_cast<float*>(a.dk), static_cast<float*>(a.dv),
      a.H, a.KV, a.S, a.d, a.dks, a.dvs, a.sc, n4);
  return static_cast<int>(cudaGetLastError());
}

// head_dim_for's answer for a head dim above 128: the wide kernels.
constexpr int WIDE_DIMS = -1;

// The instantiated head dim a head dim d runs in: the smallest D of 16,
// 32, 64, 80, 96 and 128 at least d (budget.flash_head_dim), WIDE_DIMS
// above 128 (the *_wide kernels at W = WIDE), or 0 for a d no kernel
// takes: below 1, or a row of d elements of `itemsize` bytes that the
// 16-byte copies cannot cover.
int head_dim_for(int d, int itemsize) {
  constexpr int kDims[] = {16, 32, 64, 80, 96, 128};
  if (d < 1 || d * itemsize % 16 != 0) return 0;
  for (int D : kDims)
    if (d <= D) return D;
  return WIDE_DIMS;
}

// The entries' common checks: sizes, and the dtype each takes.
bool bad_sizes(int B, int H, int KV, int Tq, int S, int dtype, int want) {
  return B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Tq <= 0 || S <= 0 ||
         dtype != want;
}

BwdArgs bwd_args(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta, int B,
                 int H, int KV, int Tq, int S, int d, Strides qs, Strides ks,
                 Strides vs, Strides dos, float sc, int causal, void* stream) {
  BwdArgs a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.B = B; a.H = H; a.KV = KV; a.Tq = Tq; a.S = S; a.d = d;
  a.qs = qs; a.ks = ks; a.vs = vs; a.dos = dos;
  a.sc = sc; a.causal = causal;
  a.st = static_cast<cudaStream_t>(stream);
  return a;
}

// One case of an entry's switch: instantiation D of launcher F, or F's
// wide launcher (F_wide) at W = WIDE above 128.
#define FLASH_DIMS(F, ...)                                   \
  switch (head_dim_for(d, dtype == 0 ? 4 : 2)) {            \
    case 16: return F<16>(__VA_ARGS__);                     \
    case 32: return F<32>(__VA_ARGS__);                     \
    case 64: return F<64>(__VA_ARGS__);                     \
    case 80: return F<80>(__VA_ARGS__);                     \
    case 96: return F<96>(__VA_ARGS__);                     \
    case 128: return F<128>(__VA_ARGS__);                   \
    case WIDE_DIMS: return F##_wide<WIDE>(__VA_ARGS__);     \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

}  // namespace

// d: the head dim of every q-, k-, v- and dO-shaped operand; the kernels
// run in the smallest instantiation D >= d (head_dim_for), columns [d, D)
// zero on chip and never stored, or above 128 in the wide kernels, one
// block per output slice of WIDE columns.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int H, int KV, int Tq, int S, int d, long long q_sb, long long q_sh,
    long long q_st, long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st, long long o_sb,
    long long o_sh, long long o_st, float sc, int causal, int dtype,
    void* stream) {
  if (bad_sizes(B, H, KV, Tq, S, dtype, 0))  // bf16: the *_tc entry
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_sh, q_st}, ks{k_sb, k_sh, k_st},
      vs{v_sb, v_sh, v_st}, os{o_sb, o_sh, o_st};
  FLASH_DIMS(launch_fwd_tf32, q, k, v, o, static_cast<float*>(lse), B, H, KV,
             Tq, S, d, qs, ks, vs, os, sc, causal,
             static_cast<cudaStream_t>(stream))
}

extern "C" int flash_attention_fwd_tc(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int H, int KV, int Tq, int S, int d, long long q_sb, long long q_sh,
    long long q_st, long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st, long long o_sb,
    long long o_sh, long long o_st, float sc, int causal, int dtype,
    void* stream) {
  if (bad_sizes(B, H, KV, Tq, S, dtype, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_sh, q_st}, ks{k_sb, k_sh, k_st},
      vs{v_sb, v_sh, v_st}, os{o_sb, o_sh, o_st};
  FLASH_DIMS(launch_fwd_tc, q, k, v, o, static_cast<float*>(lse), B, H, KV,
             Tq, S, d, qs, ks, vs, os, sc, causal,
             static_cast<cudaStream_t>(stream))
}

extern "C" int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int H, int KV,
    int Tq, int S, int d, long long q_sb, long long q_sh, long long q_st,
    long long k_sb, long long k_sh, long long k_st, long long v_sb,
    long long v_sh, long long v_st, long long do_sb, long long do_sh,
    long long do_st, long long dq_sb, long long dq_sh, long long dq_st,
    float sc, int causal, int dtype, void* stream) {
  if (bad_sizes(B, H, KV, Tq, S, dtype, 0))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a = bwd_args(q, k, v, dout, lse, delta, B, H, KV, Tq, S, d,
                       {q_sb, q_sh, q_st}, {k_sb, k_sh, k_st},
                       {v_sb, v_sh, v_st}, {do_sb, do_sh, do_st}, sc, causal,
                       stream);
  a.dq = dq;
  a.dqs = {dq_sb, dq_sh, dq_st};
  FLASH_DIMS(launch_dq_tf32, a)
}

extern "C" int flash_attention_bwd_dq_tc(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int H, int KV,
    int Tq, int S, int d, long long q_sb, long long q_sh, long long q_st,
    long long k_sb, long long k_sh, long long k_st, long long v_sb,
    long long v_sh, long long v_st, long long do_sb, long long do_sh,
    long long do_st, long long dq_sb, long long dq_sh, long long dq_st,
    float sc, int causal, int dtype, void* stream) {
  if (bad_sizes(B, H, KV, Tq, S, dtype, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a = bwd_args(q, k, v, dout, lse, delta, B, H, KV, Tq, S, d,
                       {q_sb, q_sh, q_st}, {k_sb, k_sh, k_st},
                       {v_sb, v_sh, v_st}, {do_sb, do_sh, do_st}, sc, causal,
                       stream);
  a.dq = dq;
  a.dqs = {dq_sb, dq_sh, dq_st};
  FLASH_DIMS(launch_dq_tc, a)
}

extern "C" int flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, void* dk_part,
    void* dv_part, int B, int H, int KV, int Tq, int S, int d,
    long long q_sb, long long q_sh, long long q_st, long long k_sb,
    long long k_sh, long long k_st, long long v_sb, long long v_sh,
    long long v_st, long long do_sb, long long do_sh, long long do_st,
    long long dk_sb, long long dk_sh, long long dk_st, long long dv_sb,
    long long dv_sh, long long dv_st, float sc, int causal, int dtype,
    void* stream) {
  if (bad_sizes(B, H, KV, Tq, S, dtype, 0))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a = bwd_args(q, k, v, dout, lse, delta, B, H, KV, Tq, S, d,
                       {q_sb, q_sh, q_st}, {k_sb, k_sh, k_st},
                       {v_sb, v_sh, v_st}, {do_sb, do_sh, do_st}, sc, causal,
                       stream);
  a.dk = dk; a.dv = dv;
  a.dks = {dk_sb, dk_sh, dk_st}; a.dvs = {dv_sb, dv_sh, dv_st};
  FLASH_DIMS(launch_dkv_tf32, a, static_cast<float*>(dk_part),
             static_cast<float*>(dv_part))
}

extern "C" int flash_attention_bwd_dkv_tc(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, void* dk_part,
    void* dv_part, int B, int H, int KV, int Tq, int S, int d,
    long long q_sb, long long q_sh, long long q_st, long long k_sb,
    long long k_sh, long long k_st, long long v_sb, long long v_sh,
    long long v_st, long long do_sb, long long do_sh, long long do_st,
    long long dk_sb, long long dk_sh, long long dk_st, long long dv_sb,
    long long dv_sh, long long dv_st, float sc, int causal, int dtype,
    void* stream) {
  if (bad_sizes(B, H, KV, Tq, S, dtype, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a = bwd_args(q, k, v, dout, lse, delta, B, H, KV, Tq, S, d,
                       {q_sb, q_sh, q_st}, {k_sb, k_sh, k_st},
                       {v_sb, v_sh, v_st}, {do_sb, do_sh, do_st}, sc, causal,
                       stream);
  a.dk = dk; a.dv = dv;
  a.dks = {dk_sb, dk_sh, dk_st}; a.dvs = {dv_sb, dv_sh, dv_st};
  FLASH_DIMS(launch_dkv_tc, a, static_cast<float*>(dk_part),
             static_cast<float*>(dv_part))
}

// Block-sparse (BCSR) direct convolution with a fused epilogue, on Hopper's
// tensor cores (sm_90a).
//
// Replaces the TPU kernel bsr_conv_pallas / _kernel in
// src/repro/kernels/bsr_conv/kernel.py.  The filter bank is blocked over its
// flattened (M, C*R*S) matrix into (BM, BN) tiles; for block-row i and each
// kept tile kb < nblocks[i], flat column j = blockcol[i,kb]*BN + jl stands
// for the weight (c, r, s) with j = c*RS + r*S + s.  In f32:
//
//   out[n, i*BM + ml, e, f] = relu?( sum_kb sum_jl blocks[i,kb,ml,jl] *
//          xpad[n, min(c, C-1), e*st + r, f*st + s] + bias + residual? )
//
// Columns past C*R*S (the format's right-padding) have zero weights; their
// channel is clamped to C-1 as in the reference, so the read stays in bounds.
// Rows past M (channel padding to GBM*BM) are zero too; the caller slices
// them off.
//
// The product, written transposed: out^T[pixels, channels] = patch^T W^T,
// with the pixels (n, e, f) flattened, so that wgmma's M dimension is 64
// pixels and small late layers (7 x 7 an image) still fill a tile.
//
//   * A block owns WGS x 64 pixels (a warpgroup each) and a group of NB
//     block-rows, N = NB*BM output channels (32 or 64: two stages of a
//     128-deep column of both TF32 halves of 64 channels fill 128 KB; at
//     bf16 also 128); BM is 8, 16, 32 or 64 (NB >= 1, so BM = 64 only at N
//     >= 64).  A
//     (BM, BN) tile alone would be an m64n8 product, too narrow to keep the
//     tensor cores busy; the reuse left is the im2col patch across
//     block-rows, so every patch element a block gathers feeds N channels.
//   * The block walks the block columns its group keeps (any row keeping a
//     tile there), one BN-deep column at a time.  For each it stages the
//     group's tiles at that column into one K-major B operand (N x BN,
//     zero for a row that keeps nothing there) with cp.async, a warp 8
//     rows of a tile at a time, BSTAGES stages (BSTAGES16 at bf16), the
//     next columns' copies under this column's products.  A table built at the start, (row g, column j) -> kb, finds
//     the tiles, so any order of a row's tiles works; a repeated column is
//     refused by the launcher.
//   * The patch is never stored: each thread gathers its A fragments (two
//     pixels x two columns of each 8-deep step) straight from xpad through
//     L1/L2 into registers, a whole block column ahead of their use, by the
//     column offsets (c*Hp + r)*Wp + s the block decodes once per column
//     into shared memory, two columns ahead.
//   * f32 accuracy on the tensor cores: TF32 is off as a library setting,
//     so f32 operands are split.  The split is TF32 big + small halves of
//     both operands: x_hi = tf32(x), x_lo = tf32(x - x_hi) (cvt.rna, to
//     nearest, ties away), likewise w (split once per bank by the wrapper),
//     and three products x_hi w_hi + x_hi w_lo + x_lo w_hi, each wgmma
//     m64nNk8 .tf32 with f32 sums (a product of two TF32 values is exact in
//     f32; the dropped x_lo w_lo is below 2^-22 of the product).  It keeps
//     about 21 bits of each operand, at 495 TFLOP/s: a bf16 hi + lo split
//     (989 TFLOP/s) keeps about 16 and fails the card tests' elementwise
//     1e-4 on sums of a few hundred products; one product on operands
//     rounded once to TF32 keeps 11 and fails every check
//     (ref.bsr_conv_split_plain mirrors both).
//   * A quantised bank (int8 or e4m3 tiles, an f32 scale a channel: the
//     reference's scale operand) stages its tiles' bytes, a quarter of the
//     f32 tiles', with the same cp.async ring; at each column the block
//     converts the stage's bytes into the TF32 B operand (both types are
//     exact in TF32), one pass over the stage, and takes two products,
//     x_hi w + x_lo w (w has no lo half).  The scale multiplies each
//     channel's f32 sum in the epilogue, once, before the bias: the
//     reference scales each tile's contribution, the same function up to
//     f32 rounding (ref.py's plain version does what the kernel does).
//   * bf16 activations (the TPU kernel stages xpad.dtype; HALF): no split.
//     The A fragments are the bf16 inputs as they are, the B operand bf16
//     tiles (copied as they are) or a quantised bank's bytes converted on
//     chip into bf16 (int8 and e4m3 values are exact in bf16), and each
//     16-deep step is one wgmma m64nNk16 .f32.bf16.bf16: a product of two
//     bf16 values is exact in f32, one product a step where split TF32
//     takes three 8-deep ones.  The epilogue reads the bf16 residual and
//     writes bf16, rounded once from the f32 sums.
//   * The tensor cores add into their f32 accumulator with truncation, so
//     that error grows with the wgmmas a sum takes: on f32 activations
//     each group of 4 steps sums into a fresh partial, added into the f32
//     sums with rounded adds (the card measured 8e-3 at res5a/3x3 without
//     it, 2e-4 with it, against the check's 1e-4 x (1 + max |y|)).
//
// bf16 activations (row 2e of PERF.md).  What held the first bf16 kernel
// (bsr_conv/ablate.py --act bf16, PERF.md) was latency, not the tensor
// cores' rate (3 % of it): each 16-deep step's wgmma waited for the step
// before (wg_wait<1>, its A registers to be read) and the partials' adds,
// a serial chain of KS wgmmas a column; then the A gathers (eight 2-byte
// loads a thread a step, through L1), then the B copies.  The bf16 design:
//   * One commit and one wait a column: its KS wgmmas issue back to back
//     into the f32 sums, with no partials (the truncation over a sum's
//     wgmmas, 8e-3 at res5a/3x3 in f32, is far below a bf16 ulp of
//     outputs that reach the hundreds; chip_smoke.py holds every output to
//     one ulp of its plain version).  The A registers of a column must stay
//     untouched until its wgmmas are done, so the A values sit in
//     three sets, one read by this column's wgmmas while the column two
//     ahead is gathered into another, under them, so that a load has two
//     columns' products to land; the B stages are copied two ahead too.
//   * Wider channel groups: a bf16 stage of N x 128 x 2 bytes has no lo
//     half, a quarter of the f32 path's, so N = 128 fits (wgmma
//     m64n128k16, 64 accumulators a thread): each gathered A value feeds
//     128 channels.  budget.BSR_CONV_BF16_TILES lists the tiles; the
//     schedule takes the widest that still gives the card enough blocks.
//   * With (8, 128) tiles of a magnitude-pruned bank nearly every tile is
//     kept (0.7 sparsity: all of them at the five main-path layers), so a
//     group's product is the dense one: the tensor-core work executed
//     equals the useful work counted by the bound, and the zero-filled
//     rows of a group (a row keeping no tile at a column its group keeps)
//     add nothing there.
//   * The epilogue (bias, residual, ReLU) is applied to the sums and
//     written straight to (N, M, E, F): a fragment's stores cover eight
//     neighbouring pixels of four channels, whole 32-byte sectors.
//
// Bound on an H100 SXM: the work is 2*kept_tiles*BM*BN*N*E*F operations;
// as three TF32 products on the tensor cores (495 TFLOP/s) the bytes of
// xpad + tiles + out bound the smaller layers and the operations the
// larger; on the f32 FMA units (67 TFLOP/s) the operations bound.  What
// holds the kernel is the traffic around the products, the tiles' copies
// first: every block copies its group's tiles, both halves, for every
// block column, 64 KB a column at N = 64 (bsr_conv/ablate.py, PERF.md).
//
// C interface (ctypes): pointers and the stream are void*, sizes are int,
// residual may be null; act 0 (f32 xpad, residual and out) or 1 (bf16);
// qtype 0 takes the f32 tiles' TF32 halves (whi, wlo) at act 0, the bf16
// tiles in whi at act 1 (wlo null), 1 (int8) or 2 (e4m3) the tiles' bytes
// in whi and the (GBM*BM) f32 scales (wlo null); returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// shape no instantiation takes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int WG = 128;  // threads of a warpgroup
constexpr int BN = 128;  // block width: the (BM, 128) tiles of the format
constexpr int BSTAGES = 2;  // stages of the B operand (the group's tiles)
constexpr int BSTAGES16 = 3;  // ... on bf16 activations

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A shared-memory matrix descriptor without a swizzle: start address,
// leading and stride byte offsets in 16-byte units.  K-major: the leading
// offset steps between the 8 x 8 core matrices along K, the stride offset
// between those along N.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
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

// D (64 x 32, f32) = A (64 x 16, bf16 fragments in registers) B^T + D if
// scale_d else 0, B (32 x 16) K-major in shared memory.
__device__ __forceinline__ void wgmma_bf16(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D (64 x 64, f32) = A (64 x 16, bf16 fragments in registers) B^T + D if
// scale_d else 0, B (64 x 16) K-major in shared memory.
__device__ __forceinline__ void wgmma_bf16(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
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

// D (64 x 128, f32) = A (64 x 16, bf16 fragments in registers) B^T + D if
// scale_d else 0, B (128 x 16) K-major in shared memory.
__device__ __forceinline__ void wgmma_bf16(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
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
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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

// The activation type (f32, or bf16 under HALF), an element widened to f32
// (exact) and an f32 result rounded once to it; two bf16 values packed into
// a 32-bit word, the first in its low half.
template <bool HALF>
struct Act {
  using T = float;
};
template <>
struct Act<true> {
  using T = __nv_bfloat16;
};
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// f32 -> TF32, rounded to nearest, ties away from zero (the low 13 bits
// of the result are 0).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t t;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(t) : "f"(x));
  return t;
}

// x -> (hi, lo) TF32 halves: hi = tf32(x), lo = tf32(x - hi).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// e4m3 (fn) byte -> f32, exactly: sign, 4 exponent bits (bias 7), 3
// mantissa bits; exponent 0 is subnormal (mantissa x 2^-9).
__device__ __forceinline__ float e4m3_to_f32(uint32_t b) {
  const uint32_t e = (b >> 3) & 0xFu;
  const uint32_t m = b & 7u;
  const float mag = e ? __uint_as_float(((e + 120u) << 23) | (m << 20))
                      : static_cast<float>(m) * 0.001953125f;
  return (b & 0x80u) ? -mag : mag;
}

// byte j (0..3) of a word, as a quantised value of type qtype
__device__ __forceinline__ float narrow(uint32_t w, int j, int qtype) {
  const uint32_t b = (w >> (8 * j)) & 0xFFu;
  return qtype == 1 ? static_cast<float>(static_cast<int8_t>(b))
                    : e4m3_to_f32(b);
}

// Shared memory, in order: NST stages of the B operand, each the hi
// (N x BN) TF32 tile, element (n, k) at (k / 4) * N * 16 + n * 16 +
// (k % 4) * 4 (8 rows x 16 bytes core matrices, K-major; a bf16 tile's at
// (k / 8) * N * 16 + n * 16 + (k % 8) * 2), then the lo one (f32 tiles on
// f32 activations) or the tiles' bytes (quantised: 16-byte piece
// (n, k / 16) at ((k / 16) * N + n) * 16); 3 slots of BN int32 column
// offsets; the (NB x KBC) int32 table of kept tiles; the KBC live columns.
// BMT is the block height, or 0 where it is the run-time bmr (the bf16
// instances: one build for every height, the heights touching only the
// tile table, the copies and the epilogue, not the products).  The f32
// activations' instances keep the height a template parameter: with it at
// run time their staged layers ran 3-5 % slower on an H100 (device time,
// f32 and int8 tiles; compare_conv.py, PERF.md section 6).
template <int BMT, int N, int WGS, bool QUANT, bool HALF>
__global__ void __launch_bounds__(WGS * WG) bsr_conv_tc_kernel(
    const typename Act<HALF>::T* __restrict__ xpad,
    const float* __restrict__ whi, const float* __restrict__ wlo,
    const float* __restrict__ scale, const int* __restrict__ blockcol,
    const int* __restrict__ nblocks, const float* __restrict__ bias,
    const typename Act<HALF>::T* __restrict__ residual,
    typename Act<HALF>::T* __restrict__ out, int NIMG, int C, int Hp,
    int Wp, int GBM, int KB, int RS, int S, int E, int F, int stride,
    int relu, int qtype, int bmr) {
  static_assert(BMT == 0 || N % BMT == 0, "a group holds whole block-rows");
  const int BM = BMT ? BMT : bmr;
  const int NB = N / BM;          // block-rows of the group
  constexpr int NTH = WGS * WG;
  constexpr int NWARPS = NTH / 32;
  constexpr int ACC = N / 2;      // f32 accumulator registers a thread
  constexpr int OPB = HALF ? 2 : 4;          // bytes of an operand element
  constexpr int KS = BN / (32 / OPB);  // 8-deep (TF32), 16-deep (bf16) steps
  constexpr int GS = 4;           // steps a partial sums before it is added
  static_assert(KS % (2 * GS) == 0, "a column holds whole pairs of groups");
  constexpr int TILE = N * BN * OPB;          // bytes of one B operand
  // a stage: the operand, then the TF32 lo half (f32 tiles on f32
  // activations) or the tiles' bytes (quantised)
  constexpr int STAGE = TILE + (QUANT ? N * BN : (HALF ? 0 : TILE));
  // bytes of a tile row in device memory; a warp copies 8 rows of a tile
  // (half) at a time, in pieces of 16 bytes, PPL a lane
  constexpr int ROWB = BN * (QUANT ? 1 : OPB);
  constexpr int PPL = 8 * (ROWB / 16) / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  const int KBC = (C * RS + BN - 1) / BN;     // block columns of the bank
  const uint32_t bbase = smem_u32(smem);
  constexpr int NST = HALF ? BSTAGES16 : BSTAGES;  // stages of B
  int* coloff = reinterpret_cast<int*>(smem + NST * STAGE);    // [3][BN]
  int* table = coloff + 3 * BN;                                // [NB][KBC]
  int* live = table + NB * KBC;                                // [KBC]
  __shared__ int nlive;

  const int tid = threadIdx.x;
  const int wg = tid / WG;
  const int gwarp = tid / 32;
  const int warp = (tid % WG) / 32;
  const int lane = tid % 32;
  const int gid = lane / 4;
  const int tig = lane % 4;
  const int i0 = blockIdx.y * NB;
  const int EF = E * F;
  const int P = NIMG * EF;
  const int Mp = GBM * BM;
  const int64_t img = static_cast<int64_t>(C) * Hp * Wp;

  // -- the group's kept tiles, by (row, block column) --------------------
  for (int t = tid; t < NB * KBC; t += NTH) table[t] = -1;
  __syncthreads();
  for (int t = tid; t < NB * KB; t += NTH) {
    const int g = t / KB;
    const int kb = t - g * KB;
    const int i = i0 + g;
    if (i < GBM && kb < nblocks[i]) {
      const int j = blockcol[static_cast<int64_t>(i) * KB + kb];
      table[g * KBC + j] = kb;
    }
  }
  __syncthreads();
  // the columns any row of the group keeps, in ascending order
  if (tid < 32) {
    int count = 0;
    for (int base = 0; base < KBC; base += 32) {
      const int j = base + lane;
      bool any = false;
      if (j < KBC)
        for (int g = 0; g < NB; ++g) any |= table[g * KBC + j] >= 0;
      const unsigned m = __ballot_sync(0xffffffffu, any);
      if (any) live[count + __popc(m & ((1u << lane) - 1))] = j;
      count += __popc(m);
    }
    if (lane == 0) nlive = count;
  }

  // column offsets (c*Hp + r)*Wp + s of live column t into slot t % 3
  auto decode = [&](int t, int nl) {
    if (t >= nl) return;
    const int j0 = live[t] * BN;
    int* dst = coloff + (t % 3) * BN;
    for (int k = tid; k < BN; k += NTH) {
      const int j = j0 + k;
      const int c = j / RS;
      const int rem = j - c * RS;
      const int r = rem / S;
      dst[k] = (min(c, C - 1) * Hp + r) * Wp + (rem - r * S);
    }
  };
  // A lane's pieces of 8 rows: piece q = lane + 32 u is row q % 8 and
  // 16-byte column q / 8, so that eight lanes fill one 128-byte core
  // matrix (f32), or eight rows' pieces lie side by side (bytes); its
  // offsets in the rows (global, bytes) and in the stage (shared, bytes)
  // are the same for every 8 rows.
  int src_off[PPL], dst_off[PPL];
#pragma unroll
  for (int u = 0; u < PPL; ++u) {
    const int q = lane + 32 * u;
    const int m = q % 8;
    const int k16 = q / 8;
    src_off[u] = m * ROWB + 16 * k16;
    dst_off[u] = QUANT ? (k16 * N + m) * 16 : k16 * (N * 16) + m * 16;
  }
  // the group's tiles at live column t into B stage t % 2, zero where a
  // row keeps none: a warp 8 rows of a (row, half) at a time (f32), or of
  // a row's bytes (quantised).  One cp.async group.
  auto stage = [&](int t, int nl) {
    if (t < nl) {
      const int j = live[t];
      const uint32_t sb = bbase + (t % NST) * STAGE;
      constexpr int R8 = N / 8;   // 8-row pieces of the group
      for (int job = gwarp; job < (QUANT || HALF ? 1 : 2) * R8;
           job += NWARPS) {
        const int r8 = job % R8;
        const int half = job / R8;
        const int g = r8 / (BM / 8);
        const int kb = table[g * KBC + j];
        const int64_t row0 =
            kb >= 0 ? ((static_cast<int64_t>(i0 + g) * KB + kb) * BM +
                       (r8 % (BM / 8)) * 8) * BN
                    : 0;
        const unsigned char* src =
            reinterpret_cast<const unsigned char*>(half ? wlo : whi) +
            row0 * (QUANT ? 1 : OPB);
        const uint32_t dst =
            sb + (QUANT || half ? TILE : 0) + r8 * 8 * 16;
#pragma unroll
        for (int u = 0; u < PPL; ++u)
          cp_async16(dst + dst_off[u], src + src_off[u], kb >= 0 ? 16 : 0);
      }
    }
    cp_commit();
  };
  // a quantised stage's bytes into its operand: 16 values a thread at a
  // time, piece (n, k16) -> four 16-byte slots (k / 4, n) of TF32, or two
  // (k / 8, n) of bf16
  auto convert = [&](int t) {
    unsigned char* st = smem + (t % NST) * STAGE;
    for (int p = tid; p < N * (BN / 16); p += NTH) {
      const int n = p % N;
      const int k16 = p / N;
      const uint4 raw = *reinterpret_cast<const uint4*>(
          st + TILE + (k16 * N + n) * 16);
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
      if (HALF) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            v[i] = pack_bf16(narrow(w[2 * h + i / 2], 2 * (i % 2), qtype),
                             narrow(w[2 * h + i / 2], 2 * (i % 2) + 1, qtype));
          *reinterpret_cast<uint4*>(st + (2 * k16 + h) * (N * 16) + n * 16) =
              make_uint4(v[0], v[1], v[2], v[3]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          *reinterpret_cast<float4*>(st + (4 * k16 + i) * (N * 16) +
                                     n * 16) =
              make_float4(narrow(w[i], 0, qtype), narrow(w[i], 1, qtype),
                          narrow(w[i], 2, qtype), narrow(w[i], 3, qtype));
      }
    }
  };

  __syncthreads();
  const int nl = nlive;
  decode(0, nl);
  decode(1, nl);
#pragma unroll
  for (int t = 0; t < NST - 1; ++t) stage(t, nl);
  __syncthreads();  // slots 0 and 1 of the column offsets

  // this thread's two pixels (rows warp*16 + gid, + 8 of its warpgroup's
  // 64): their windows' origins in xpad, pixel 0's past the end
  const int p0 = blockIdx.x * (WGS * 64) + wg * 64 + warp * 16 + gid;
  int64_t pbase[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = p0 + 8 * h < P ? p0 + 8 * h : 0;
    const int n = p / EF;
    const int ef = p - n * EF;
    const int e = ef / F;
    pbase[h] = n * img + static_cast<int64_t>(e) * stride * Wp +
               (ef - e * F) * stride;
  }

  float acc[ACC];
#pragma unroll
  for (int e = 0; e < ACC; ++e) acc[e] = 0.f;

  if constexpr (HALF) {
    // bf16: a column's KS products issued back to back, one commit and one
    // wait a column, into one f32 sum a channel (no partial sums: the
    // tensor cores' truncation over a sum's wgmmas stays far below a bf16
    // ulp of the output, which the card checks).  The A values come from
    // registers, so a column's fragments must stay untouched until its
    // products are done: three sets, one read by this column's wgmmas
    // while the column two ahead is gathered into another, under them (the
    // column loop runs in threes, so each set is a fixed set of registers);
    // the B stages are copied two columns ahead too.  Fragment ks: the
    // four words of the step's 16 x 16, (gid, 2 tig and 2 tig + 1), (gid +
    // 8, ...), (gid, 2 tig + 8 and + 9), (gid + 8, ...).
    // (32-bit offsets: the launcher takes inputs below 2^31 elements)
    const unsigned short* xh = reinterpret_cast<const unsigned short*>(xpad);
    const int pb[2] = {static_cast<int>(pbase[0]), static_cast<int>(pbase[1])};
    auto gather = [&](int col, uint32_t (&xv)[KS][4]) {
      if (col >= nl) return;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int* co = coloff + (col % 3) * BN + ks * 16 + 2 * tig;
        const int c0 = co[0], c1 = co[1], c8 = co[8], c9 = co[9];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          xv[ks][h] =
              __ldg(xh + (pb[h] + c0)) |
              (static_cast<uint32_t>(__ldg(xh + (pb[h] + c1))) << 16);
          xv[ks][2 + h] =
              __ldg(xh + (pb[h] + c8)) |
              (static_cast<uint32_t>(__ldg(xh + (pb[h] + c9))) << 16);
        }
      }
    };
    auto column = [&](int col, const uint32_t (&cur)[KS][4],
                      uint32_t (&ahead)[KS][4]) {
      // this column's tiles have landed (the next column's may be in
      // flight); every warpgroup's products of the column before are done
      // (each waits at its column's end), so that column's stage, its
      // offsets' slot and its fragments' set are free
      cp_wait<NST - 2>();
      fence_async_smem();
      __syncthreads();
      stage(col + NST - 1, nl);
      decode(col + 3, nl);
      if (QUANT) {
        // the operand, written through the generic proxy, fenced for wgmma
        convert(col);
        fence_async_smem();
        __syncthreads();
      }
      const uint32_t sb0 = bbase + (col % NST) * STAGE;
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        wgmma_bf16(acc, cur[ks],
                   smem_desc(sb0 + ks * 2 * (N * 16), N * 16, 128), 1);
      }
      wg_commit();
      gather(col + 2, ahead);  // under this column's products
      wg_wait<0>();
    };
    uint32_t xa[KS][4], xb[KS][4], xc[KS][4];
    decode(2, nl);
    __syncthreads();  // slot 2 of the column offsets
    gather(0, xa);
    gather(1, xb);
    for (int col = 0; col < nl; col += 3) {
      column(col, xa, xc);
      if (col + 1 < nl) column(col + 1, xb, xa);
      if (col + 2 < nl) column(col + 2, xc, xb);
    }
    fence_regs(acc);
  } else {
    // The tensor cores add each product into their f32 accumulator with
    // truncation, so an error grows with the number of wgmmas a sum takes
    // and with its size.  Each group of GS steps therefore sums into a
    // fresh partial (two, alternating), which is then added into acc with
    // f32 adds rounded to nearest, once the next group's first step has
    // waited for it (the column's last group at the column's end).
    float part[2][ACC];
#pragma unroll
    for (int e = 0; e < ACC; ++e) part[0][e] = part[1][e] = 0.f;

    // The A values of a whole column are gathered a column ahead: step ks
    // of column c + 1 is loaded into xv[ks] as soon as step ks of column c
    // has been split, so each load has a column's products to land.
    // xv[ks]: (row gid, col tig), (gid + 8, tig), (gid, tig + 4), (gid + 8,
    // tig + 4) of the step's 16 x 8, the A fragment's order.
    float xv[KS][4];
    auto gather = [&](int col, int ks) {
      if (col >= nl) return;
      const int* co = coloff + (col % 3) * BN + ks * 8 + tig;
      const int c0 = co[0], c4 = co[4];
      xv[ks][0] = __ldg(xpad + pbase[0] + c0);
      xv[ks][1] = __ldg(xpad + pbase[1] + c0);
      xv[ks][2] = __ldg(xpad + pbase[0] + c4);
      xv[ks][3] = __ldg(xpad + pbase[1] + c4);
    };
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) gather(0, ks);

    uint32_t ahi[2][4], alo[2][4];
    for (int col = 0; col < nl; ++col) {
      // every product of the last column is done (below), its stage is
      // free; this column's tiles have landed
      cp_wait<BSTAGES - 2>();
      fence_async_smem();
      __syncthreads();
      stage(col + BSTAGES - 1, nl);
      decode(col + 2, nl);
      if (QUANT) {
        // the operand, written through the generic proxy, fenced for wgmma
        convert(col);
        fence_async_smem();
        __syncthreads();
      }
      const uint32_t sb0 = bbase + (col % BSTAGES) * STAGE;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        // split into the A fragments, gather the next column's step, issue
        // the three products
        uint32_t (&hi)[4] = ahi[ks % 2];
        uint32_t (&lo)[4] = alo[ks % 2];
#pragma unroll
        for (int v = 0; v < 4; ++v) split_tf32(xv[ks][v], hi[v], lo[v]);
        gather(col + 1, ks);
        const uint32_t sb = sb0 + ks * 2 * (N * 16);
        const uint64_t dhi = smem_desc(sb, N * 16, 128);
        const uint64_t dlo = smem_desc(sb + TILE, N * 16, 128);
        float (&d)[ACC] = part[(ks / GS) % 2];
        wg_fence();
        wgmma_tf32(d, hi, dhi, ks % GS != 0);
        if (!QUANT) wgmma_tf32(d, hi, dlo, 1);
        wgmma_tf32(d, lo, dhi, 1);
        wg_commit();
        wg_wait<1>();  // the step before has read its fragments
        if (ks % GS == 0 && ks > 0) {
          // the group before is done: add its partial
          float (&q)[ACC] = part[(ks / GS + 1) % 2];
          fence_regs(q);
#pragma unroll
          for (int e = 0; e < ACC; ++e) acc[e] = __fadd_rn(acc[e], q[e]);
        }
      }
      // the column's last group: wait for it and add it here, so that no
      // partial is carried from one column to the next (a copy of an
      // accumulator a wgmma is still writing would read it too soon)
      wg_wait<0>();
      float (&q)[ACC] = part[(KS / GS - 1) % 2];
      fence_regs(q);
#pragma unroll
      for (int e = 0; e < ACC; ++e) acc[e] = __fadd_rn(acc[e], q[e]);
    }
  }
  cp_wait_all();

  // accumulator element e: pixel row warp*16 + gid + 8 (e / 2 % 2),
  // channel 8 (e / 4) + 2 tig + e % 2 of the group
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = p0 + 8 * h;
    if (p >= P) continue;
    const int n = p / EF;
    const int ef = p - n * EF;
#pragma unroll
    for (int n8 = 0; n8 < N / 8; ++n8)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int m = i0 * BM + n8 * 8 + tig * 2 + b;
        if (m >= Mp) continue;
        const int64_t o = (static_cast<int64_t>(n) * Mp + m) * EF + ef;
        float v = acc[n8 * 4 + h * 2 + b];
        if (QUANT) v = __fmul_rn(v, scale[m]);
        v = v + bias[m];
        if (residual != nullptr) v += widen(residual[o]);
        if (relu) v = fmaxf(v, 0.f);
        put(out + o, v);
      }
  }
}

template <int BMT, int N, int WGS, bool QUANT, bool HALF>
int launch(int BM, const void* xv, const float* whi, const float* wlo,
           const float* sc, const int* bc, const int* nb, const float* b,
           const void* resv, void* ov, int NIMG, int C, int Hp, int Wp,
           int GBM, int KB, int RS, int S, int E, int F, int stride, int relu,
           int qtype, cudaStream_t st) {
  using XT = typename Act<HALF>::T;
  const int KBC = (C * RS + BN - 1) / BN;
  const size_t opb = HALF ? 2 : 4;
  const size_t smem =
      static_cast<size_t>(HALF ? BSTAGES16 : BSTAGES) * N * BN *
          (opb + (QUANT ? 1 : (HALF ? 0 : 4))) +
      4 * (3 * BN + (N / BM + 1) * KBC);
  const cudaError_t err = cudaFuncSetAttribute(
      bsr_conv_tc_kernel<BMT, N, WGS, QUANT, HALF>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int P = NIMG * E * F;
  const dim3 grid((P + WGS * 64 - 1) / (WGS * 64),
                  (GBM + N / BM - 1) / (N / BM));
  bsr_conv_tc_kernel<BMT, N, WGS, QUANT, HALF><<<grid, WGS * WG, smem, st>>>(
      static_cast<const XT*>(xv), whi, wlo, sc, bc, nb, b,
      static_cast<const XT*>(resv), static_cast<XT*>(ov), NIMG, C, Hp, Wp,
      GBM, KB, RS, S, E, F, stride, relu, qtype, BM);
  return static_cast<int>(cudaGetLastError());
}

// BM > 0: the f32 instances of that height; BM = 0 the bf16 ones (the
// height at run time, bm)
template <int BM>
int pick(int bm, int n_tile, int wgs, int qtype, int act, const void* x,
         const float* whi, const float* wlo, const float* sc, const int* bc,
         const int* nb, const float* b, const void* res, void* o, int NIMG,
         int C, int Hp, int Wp, int GBM, int KB, int RS, int S, int E, int F,
         int stride, int relu, cudaStream_t st) {
#define BSR_CONV_KIND(N, W, Q, H)                                            \
  return launch<BM, N, W, Q, H>(bm, x, whi, wlo, sc, bc, nb, b, res, o,     \
                                NIMG, C, Hp, Wp, GBM, KB, RS, S, E, F,      \
                                stride, relu, qtype, st);
  // f32 activations: N = 32 or 64 (the TF32 halves of N = 128 would not
  // fit); bf16: N = 32, 64 or 128
#define BSR_CONV_LAUNCH(N, W, H)                                             \
  if constexpr ((BM == 0) == H && (BM == 0 || N % BM == 0)) {                \
    if (n_tile == N && wgs == W && N % bm == 0) {                            \
      if (qtype) BSR_CONV_KIND(N, W, true, H)                                \
      BSR_CONV_KIND(N, W, false, H)                                          \
    }                                                                        \
  }
  BSR_CONV_LAUNCH(32, 1, false)
  BSR_CONV_LAUNCH(32, 2, false)
  BSR_CONV_LAUNCH(64, 1, false)
  BSR_CONV_LAUNCH(64, 2, false)
  BSR_CONV_LAUNCH(32, 1, true)
  BSR_CONV_LAUNCH(32, 2, true)
  BSR_CONV_LAUNCH(64, 1, true)
  BSR_CONV_LAUNCH(64, 2, true)
  BSR_CONV_LAUNCH(128, 1, true)
  BSR_CONV_LAUNCH(128, 2, true)
#undef BSR_CONV_LAUNCH
#undef BSR_CONV_KIND
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int bsr_conv_tc(const void* xpad, const void* whi, const void* wlo,
                           const void* scale, const void* blockcol,
                           const void* nblocks, const void* bias,
                           const void* residual, void* out, int NIMG, int C,
                           int Hp, int Wp, int GBM, int KB, int BM, int bn,
                           int RS, int S, int E, int F, int stride,
                           int n_tile, int wgs, int relu, int qtype, int act,
                           void* stream) {
  const float* hi = static_cast<const float*>(whi);
  const float* lo = static_cast<const float*>(wlo);
  const float* sc = static_cast<const float*>(scale);
  const int* bc = static_cast<const int*>(blockcol);
  const int* nb = static_cast<const int*>(nblocks);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the f32 tiles' split needs its lo half; bf16 and quantised tiles have
  // none, a quantised bank its scales
  if (bn != BN || NIMG <= 0 || GBM <= 0 || qtype < 0 || qtype > 2 ||
      act < 0 || act > 1 || (qtype ? sc == nullptr : (lo == nullptr) != act))
    return static_cast<int>(cudaErrorInvalidValue);
#define BSR_CONV_PICK(BM_)                                                   \
  case BM_:                                                                  \
    return pick<BM_>(BM, n_tile, wgs, qtype, act, xpad, hi, lo, sc, bc, nb,  \
                     b, residual, out, NIMG, C, Hp, Wp, GBM, KB, RS, S, E,   \
                     F, stride, relu, st);
  if (act && (BM == 8 || BM == 16 || BM == 32 || BM == 64))
    return pick<0>(BM, n_tile, wgs, qtype, act, xpad, hi, lo, sc, bc, nb, b,
                   residual, out, NIMG, C, Hp, Wp, GBM, KB, RS, S, E, F,
                   stride, relu, st);
  switch (BM) {
    BSR_CONV_PICK(8)
    BSR_CONV_PICK(16)
    BSR_CONV_PICK(32)
    BSR_CONV_PICK(64)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef BSR_CONV_PICK
}

// Direct sparse convolution over an ELL filter bank (the paper's Algorithm 2)
// with a fused epilogue, for Hopper (sm_90a).
//
// Replaces the TPU kernel sparse_conv_pallas / _kernel in
// src/repro/kernels/sparse_conv/kernel.py.  Computes, in f32,
//
//   out[n,m,e,f] = relu?( sum_{k < nnz[m]} value[m,k] * xpad[n, c, e*st + r, f*st + s]
//                         + bias[m] + residual?[n,m,e,f] )
//
// with (c, r, s) the k-th nonzero of row m, in the bank's (c, r, s) order.
//
// Mapping (the paper's GPU mapping, Section 3.2, with the input staged):
//   * A block owns TM output channels and a tile of P = 32*PX output pixels,
//     flat over (n, e, f), so a tile may span images (ResNet-50's res5 has 49
//     pixels an image).  At stride 1, f runs over the padded row's Ws
//     columns, the last Ws - F computed and dropped, so that neighbouring
//     lanes read neighbouring slab words (no bank conflicts where a warp's
//     pixels cross a row).  Its 8 warps take TM/8 rows each; lane l of a warp
//     keeps pixels l, l + 32, ... of the tile, PX of them, in registers, with
//     one f32 sum for each of its rows: a strip of PX pixels x TM/8 rows.
//   * The block walks the input channels in chunks of CC.  For each chunk it
//     stages in shared memory, with cp.async, the input slab its pixels read:
//     the CC channels' padded rows from the tile's first window to its last
//     (whole padded rows, across images where the tile spans them), each
//     channel ROWS rows apart.
//   * The nonzeros come stretched (the paper's weight stretching, done once
//     per bank and schedule by the launcher, kernel.py): each is an
//     (offset, value) pair whose offset is the byte offset of its window's
//     origin in any tile's slab, (c % CC)*ROWS*Ws + r*Ws + s, and each row's
//     entries of chunk k are the contiguous run rowptr[m][k] ..
//     rowptr[m][k + 1] (ELL rows keep their nonzeros in (c, r, s) order).
//     A warp walks its row's run with one pointer; padding entries are never
//     read.  The pairs come from L2 32 at a time, one coalesced load a
//     window into the lanes' registers (the next window's load under this
//     one's sums, a row's first window of a chunk under the chunk before),
//     and each pair is broadcast to the warp by a shuffle.
//   * The sums: each pair feeds the lane's PX pixels, whose inputs come from
//     the slab in shared memory at the pair's offset + the pixel's base.
//   * pipeline = 1 double-buffers the slab: chunk k + 1 is copied while
//     chunk k is summed (the reference's pipeline=True halo schedule).
//     pipeline = 0 is the blocking schedule: copy, wait, sum.  Both give the
//     same bits.
//   * bias, residual and ReLU are applied to the sums, and the output is
//     written once (neighbouring lanes, neighbouring pixels).
//   * A 1x1 conv has no halo, so a slab would serve only the block's rows:
//     its kernel (sparse_conv_1x1_kernel) stages nothing and reads each
//     input straight from L1, the whole row one run.
//   * bf16 activations (the TPU kernel stages xpad.dtype in VMEM): both
//     kernels are templated on the activation type XT.  At bf16 the input
//     is read from device memory and staged as bf16, half the slab's bytes,
//     a slab row copied two elements at a time (one 4-byte cp.async: the
//     launcher takes an even padded width, which ops.py pads).  The sums
//     are f32, and the epilogue reads the bf16 residual and writes the
//     output in bf16, rounded once (__float2bfloat16_rn): there is no cast
//     pass before or after.
//
//   * A quantised bank (int8 or e4m3 values and an f32 scale a row, the
//     reference's scale operand) streams its narrow values: each nonzero is
//     one 32-bit word, its slab offset in words above its value's byte
//     ((off / 4) << 8 | byte, offsets below 2^23 words, checked by the
//     launcher), half the pairs' bytes.  Each lane decodes its entry of a
//     window once, before the window's shuffles (int8 exactly, e4m3
//     exactly by its bit fields), multiplied by its row's scale, rounded
//     once (__fmul_rn), before the sums below: the
//     kernel on a quantised bank is bit for bit the f32 kernel on
//     dequantize(bank), whose values are that same product.
//
// Each sum is formed nonzero by nonzero in bank order, exactly as the plain
// PyTorch version (ref.py) forms it, acc + value * x with the product and
// the sum each rounded to f32: the kernel is bit-identical to it, in either
// schedule and for an nnz-balanced bank.  For f32 operands that costs two
// FP instructions a nonzero and pixel (__fmul_rn, __fadd_rn): fmaf would
// round once and break the bit identity, which caps the f32 kernel at half
// of its FMA-priced bound (67 TFLOP/s on an H100 SXM).  A second cap: every
// multiply-add reads one input from shared memory (32 lanes a clock an SM),
// a quarter of the FMA rate; the unstructured sparsity leaves no operand to
// reuse from registers.
//
// A bf16 bank on bf16 activations (row 1c of PERF.md).  What bounds it is
// the issue slots of the sums, not the bytes: each nonzero and pixel took a
// 2-byte LDS, a widening, an FMUL and an FADD, as many shared-memory reads
// as the f32 kernel for half the bytes, and each nonzero an 8-byte (offset,
// f32 value) pair and two shuffles.  Three things exist only at bf16:
//   * One FMA a nonzero and pixel.  A product of two bf16 values is exact
//     in f32 (8 + 8 significant bits <= 24), so fmaf(v, x, acc) rounds to
//     the bits of __fadd_rn(acc, __fmul_rn(v, x)): the bit identity holds
//     with one FP instruction.  It fails only where a product falls below
//     f32's normal range (|v x| < 2^-126: the rounded product is then
//     subnormal or 0, the fused one is not) or overflows it; no input the
//     tests or the smoke draw comes near either.  An f32 bank on bf16
//     input and a quantised bank (value = q * scale rounded to f32, not a
//     bf16 value) keep __fmul_rn + __fadd_rn.
//   * One 32-bit word a nonzero (VK_BF16): the slab offset above the
//     value's 16 bits (offsets below 2^16, checked by the launcher, which
//     takes the (offset, f32 value) pairs past it), half the pairs' bytes
//     from L2 and one shuffle a nonzero where the pairs take two; the
//     word is decoded after the shuffle, a shift for each half.
//   * Two pixels a 32-bit shared-memory read (PAIRED: stride 1, a staged
//     conv).  Lane l keeps the neighbouring pixels 2i and 2i + 1, i = l +
//     32 j, of the tile; at stride 1 the slab's rows are whole padded rows
//     of even width, so the two windows' inputs are neighbouring elements
//     at any offset.  The slab is kept twice: plane 0 as copied (element
//     2k and 2k + 1 in word k) and plane 1 shifted by one element (2k + 1
//     and 2k + 2), built in shared memory from plane 0 once a chunk.  A
//     nonzero at an even element offset o reads plane 0's word (b + o)/2,
//     one at an odd offset plane 1's word (b + o - 1)/2 (b, the pair's
//     window origin, is even): the stretched offset is that word's index,
//     (o & 1) * PW + (o >> 1), PW the words of a plane.  The 32 lanes read
//     32 neighbouring words, no bank conflicts; each word's halves are
//     widened by a shift and a mask.  A nonzero and pixel pair then takes
//     one LDS, two widenings and two FMAs where it took two LDS, two
//     widenings, two FMULs and two FADDs; a nonzero one shuffle where it
//     took two.  The 1x1 kernel pairs its pixels the same way where two
//     neighbouring pixels are neighbouring in xpad (stride 1, an even
//     output width), read from L1 as one 4-byte load; its words hold the
//     channel, times Hp * Wp in the kernel, so no 1x1 input is too large.
//     Plane 1 costs a pass over the slab a chunk and the slab's bytes
//     again, so a paired slab is always blocking (PAIRED implies !PIPE):
//     its two planes take the room of the pipelined schedule's second
//     stage, as many channels a chunk.
//
// C interface (ctypes): pointers and the stream are void*, sizes are int,
// residual may be null, scale null unless the bank is quantised; qtype 0
// (f32 pairs), 1 (int8 words), 2 (e4m3 words) or 3 (bf16 words: bf16
// activations only); act 0 (f32 xpad, residual and out) or 1 (bf16);
// paired 1 for the paired slab (bf16 words, stride 1); returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// tile no instantiation takes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTH = 256;          // threads of a block
constexpr int NWARPS = NTH / 32;
constexpr unsigned FULL = 0xffffffffu;

// entry kinds: an (offset bytes, f32 value bits) pair, a quantised word
// (offset words << 8 | value byte), a bf16 word (offset << 16 | bf16 bits)
constexpr int VK_PAIR = 0;
constexpr int VK_QUANT = 1;
constexpr int VK_BF16 = 2;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int VK>
struct Entry {
  using T = uint32_t;
};
template <>
struct Entry<VK_PAIR> {
  using T = int2;
};

// an activation element widened to f32 (exact), and an f32 sum rounded
// once to the activation's type
__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// log2 of an activation element's bytes: a quantised word's offset is in
// elements
template <typename XT>
__host__ __device__ constexpr int elem_shift() {
  return sizeof(XT) == 4 ? 2 : 1;
}

__device__ __forceinline__ int2 zero_entry(int2) { return make_int2(0, 0); }
__device__ __forceinline__ uint32_t zero_entry(uint32_t) { return 0u; }

// e4m3 (fn) byte -> f32, exactly: sign, 4 exponent bits (bias 7), 3
// mantissa bits; exponent 0 is subnormal (mantissa x 2^-9).
__device__ __forceinline__ float e4m3_to_f32(uint32_t b) {
  const uint32_t e = (b >> 3) & 0xFu;
  const uint32_t m = b & 7u;
  const float mag = e ? __uint_as_float(((e + 120u) << 23) | (m << 20))
                      : static_cast<float>(m) * 0.001953125f;
  return (b & 0x80u) ? -mag : mag;
}

// (byte offset, value) of a pair or a quantised word; a quantised value is
// multiplied by its row's scale, rounded once; its offset is in elements of
// 1 << shift bytes.
__device__ __forceinline__ void decode(int2 e, float, int, int, int& off,
                                       float& v) {
  off = e.x;
  v = __int_as_float(e.y);
}
__device__ __forceinline__ void decode(uint32_t e, float scale, int qtype,
                                       int shift, int& off, float& v) {
  off = static_cast<int>((e >> 8) << shift);
  const uint32_t b = e & 0xFFu;
  const float q = qtype == 1 ? static_cast<float>(static_cast<int8_t>(b))
                             : e4m3_to_f32(b);
  v = __fmul_rn(q, scale);
}

// v x + acc rounded once: the bits of __fadd_rn(acc, __fmul_rn(v, x))
// where v x is exact in f32, as the product of two bf16 values is
__device__ __forceinline__ float fma_exact(float v, float x, float acc) {
  return fmaf(v, x, acc);
}

// The sums of one window of a row's entries (``cnt`` of them, lane t
// holding entry t in ``win``) into the lane's PX pixel sums ``acc``.
// ``base`` is the inputs' base (the slab, or xpad), ``pix`` the lane's
// pixels' (or pixel pairs') byte offsets from it, ``unit`` the bytes of a
// bf16 word's offset unit; ``load`` reads one input (one pixel) or one
// 32-bit word (a pixel pair) at a byte address.
template <int VK, bool PAIRED, int PX, typename XT, typename Load>
__device__ __forceinline__ void sum_window(
    typename Entry<VK>::T win, int cnt, float scale, int qtype, int unit,
    const unsigned char* base, const int (&pix)[PAIRED ? PX / 2 : PX],
    float (&acc)[PX], Load load) {
  if constexpr (VK == VK_BF16) {
    // one shuffle a nonzero, the word decoded after it; fmaf is exact
    // here (bf16 x bf16 products; see the note above)
#pragma unroll 4
    for (int t = 0; t < cnt; ++t) {
      const uint32_t w = __shfl_sync(FULL, win, t);
      const float v = __uint_as_float(w << 16);
      const unsigned char* xs = base + (w >> 16) * unit;
      if constexpr (PAIRED) {
#pragma unroll
        for (int j = 0; j < PX / 2; ++j) {
          const uint32_t x2 = load(xs + pix[j]);
          acc[2 * j] = fma_exact(v, __uint_as_float(x2 << 16), acc[2 * j]);
          acc[2 * j + 1] = fma_exact(v, __uint_as_float(x2 & 0xFFFF0000u),
                                     acc[2 * j + 1]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < PX; ++j)
          acc[j] = fma_exact(v, widen(load(xs + pix[j])), acc[j]);
      }
    }
  } else {
    // each lane decodes its own entry of the window, once; the product
    // and the sum rounded apart
    int woff;
    float wv;
    decode(win, scale, qtype, elem_shift<XT>(), woff, wv);
#pragma unroll 4
    for (int t = 0; t < cnt; ++t) {
      const int off = __shfl_sync(FULL, woff, t);
      const float v = __shfl_sync(FULL, wv, t);
#pragma unroll
      for (int j = 0; j < PX; ++j)
        acc[j] = __fadd_rn(acc[j], __fmul_rn(v, widen(load(base + off +
                                                            pix[j]))));
    }
  }
}

// the pixel that accumulator j of lane ``lane`` holds, in a tile's flat
// order: lane l's pixels l + 32 j, or its pixel pairs 2 (l + 32 j') and
// 2 (l + 32 j') + 1
template <bool PAIRED>
__device__ __forceinline__ int pixel_of(int j, int lane) {
  return PAIRED ? 2 * ((j / 2) * 32 + lane) + (j & 1) : j * 32 + lane;
}

// Words of one plane of a paired slab of E elements (the copied ones and
// the slack): plane 1's word k is built from plane 0's words k and k + 1;
// a multiple of 4, so that plane 1 starts PW words after plane 0.
__host__ __device__ constexpr int plane_words(int elems) {
  return ((elems + 1) / 2 + 2 + 3) & ~3;
}

// Shared memory: STAGES slabs of CC x ROWS x Ws elements of XT, then the
// (CC x ROWS) xpad offsets of the slab's rows (-1 past the tile's), then
// the block's rows' run bounds, TM x (nchunks + 1).  A paired slab (never
// pipelined): plane 0, plane 1 (PW words each: a word offset o >= PW from
// plane 0 lands in plane 1).  RS > 1: a 1x1 conv runs
// sparse_conv_1x1_kernel.
template <int TM, int PX, bool PIPE, int VK, bool PAIRED, typename XT>
__global__ void __launch_bounds__(NTH) sparse_conv_kernel(
    const XT* __restrict__ xpad, const typename Entry<VK>::T* __restrict__ pairs,
    const int* __restrict__ rowptr, const float* __restrict__ scale,
    const float* __restrict__ bias, const XT* __restrict__ residual,
    XT* __restrict__ out, int NIMG, int C, int Hp, int Wp, int M, int K,
    int RS, int S, int E, int F, int stride, int CC, int ROWS, int relu,
    int qtype) {
  using EntryT = typename Entry<VK>::T;
  static_assert(!PAIRED || (sizeof(XT) == 2 && VK == VK_BF16 && PX % 2 == 0),
                "a paired slab holds bf16 inputs, read by bf16 words");
  static_assert(!(PIPE && PAIRED), "a paired slab is blocking");
  constexpr int RPW = TM / NWARPS;  // rows a warp sums
  constexpr int P = 32 * PX;        // pixels a block
  constexpr int STAGES = PIPE ? 2 : 1;
  constexpr int EPC = 4 / sizeof(XT);  // elements a 4-byte copy
  constexpr int NPIX = PAIRED ? PX / 2 : PX;
  extern __shared__ __align__(16) unsigned char smem[];

  const int st = stride;
  const int Hs = Hp;
  const int Ws = Wp;
  const int RT = RS / S;            // filter rows
  // At stride 1 the pixels run over whole slab rows (Wq = Ws columns, the
  // last Ws - F of a row computed and dropped), so that the 32 lanes of a
  // warp read 32 neighbouring words of the slab: no bank conflicts.
  const int Wq = st == 1 ? Ws : F;
  const int EQ = E * Wq;
  const int NEQ = NIMG * EQ;
  const int nchunks = (C + CC - 1) / CC;
  // (the slack of S elements, S + 1 paired, keeps a dropped pixel's reads
  // inside the slab)
  const int PW = plane_words(CC * ROWS * Ws + S + 1);
  const int slab_bytes =
      PAIRED ? 4 * PW
             : ((CC * ROWS * Ws + S) * static_cast<int>(sizeof(XT)) + 15) &
                   ~15;
  uint32_t* plane0 = reinterpret_cast<uint32_t*>(smem);
  uint32_t* plane1 = plane0 + PW;
  int* tab = reinterpret_cast<int*>(smem + (STAGES + PAIRED) * slab_bytes);
  int* bounds = tab + CC * ROWS;    // [TM][nchunks + 1]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int m0 = blockIdx.y * TM;
  const int q0 = blockIdx.x * P;
  const int q1 = min(q0 + P, NEQ) - 1;
  // the padded rows the tile reads, global over images: g = n*Hs + h
  const int na = q0 / EQ, ea = (q0 - na * EQ) / Wq;
  const int nb = q1 / EQ, eb = (q1 - nb * EQ) / Wq;
  const int ga = na * Hs + ea * st;
  const int RB = nb * Hs + eb * st + RT - 1 - ga + 1;  // <= ROWS
  const int HW = Hp * Wp;

  // slab row (cl, r) -> xpad offset of (n, cl, h) for g = ga + r, or -1
  for (int t = tid; t < CC * ROWS; t += NTH) {
    const int cl = t / ROWS;
    const int r = t - cl * ROWS;
    const int g = ga + r;
    const int n = g / Hs;
    tab[t] = r < RB ? (n * C + cl) * HW + (g - n * Hs) * Wp : -1;
  }
  for (int t = tid; t < TM * (nchunks + 1); t += NTH) {
    const int ml = t / (nchunks + 1);
    bounds[t] = m0 + ml < M
                    ? rowptr[static_cast<int64_t>(m0) * (nchunks + 1) + t]
                    : 0;
  }

  // this lane's pixels (pixel pairs): their windows' origins in the slab,
  // in bytes (in a paired slab, the byte of plane 0's word b / 2, b even)
  int pix[NPIX];
#pragma unroll
  for (int j = 0; j < NPIX; ++j) {
    const int q = q0 + pixel_of<PAIRED>(PAIRED ? 2 * j : j, lane);
    int base = 0;
    if (q <= q1) {
      const int n = q / EQ;
      const int eq = q - n * EQ;
      const int e = eq / Wq;
      base = (n * Hs + e * st - ga) * Ws + (eq - e * Wq) * st;
    }
    pix[j] = PAIRED ? 2 * base : static_cast<int>(sizeof(XT)) * base;
  }
  __syncthreads();

  // slab increments a thread takes between its 4-byte copies (EPC
  // elements of one row: at bf16 Ws is even)
  const int drow = NTH * EPC / Ws, dcol = NTH * EPC - drow * Ws;

  // chunk k's slab into stage k % STAGES (a paired slab: into plane 0),
  // zero past C and past the tile's rows.  One cp.async group.
  auto stage = [&](int k) {
    if (k < nchunks) {
      const uint32_t sb = smem_u32(smem + (PIPE ? k % 2 : 0) * slab_bytes);
      const int c0 = k * CC;
      const int live_rows = min(CC, C - c0) * ROWS;
      const XT* xc = xpad + static_cast<int64_t>(c0) * HW;
      int row = tid * EPC / Ws, col = tid * EPC - row * Ws;
      for (int t = tid; t < CC * ROWS * Ws / EPC; t += NTH) {
        const int src = row < live_rows ? tab[row] : -1;
        cp_async4(sb + 4 * t, src >= 0 ? xc + src + col : xpad,
                  src >= 0 ? 4 : 0);
        col += dcol;
        row += drow;
        if (col >= Ws) {
          col -= Ws;
          ++row;
        }
      }
    }
    cp_commit();
  };
  // a paired slab's plane 1 from the chunk as copied (plane 0): its word
  // t holds elements 2t + 1 and 2t + 2 (the high half of word t, the low
  // half of word t + 1)
  auto build_planes = [&]() {
    for (int t = tid; t < PW - 1; t += NTH)
      plane1[t] = __byte_perm(plane0[t], plane0[t + 1], 0x5432);
  };

  float acc[RPW][PX];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr)
#pragma unroll
    for (int j = 0; j < PX; ++j) acc[rr][j] = 0.f;

  // each of the warp's rows' scale (a quantised bank)
  float rscale[RPW];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int m = m0 + warp * RPW + rr;
    rscale[rr] = VK == VK_QUANT && m < M ? scale[m] : 1.f;
  }

  // the first window of each of the warp's rows for chunk k, loaded a
  // chunk ahead
  EntryT first[RPW];
  auto load_first = [&](int k) {
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int ml = warp * RPW + rr;
      const int beg = k < nchunks ? bounds[ml * (nchunks + 1) + k] : 0;
      const int fin = k < nchunks ? bounds[ml * (nchunks + 1) + k + 1] : 0;
      first[rr] = beg + lane < fin
                      ? __ldg(pairs + static_cast<int64_t>(m0 + ml) * K + beg +
                              lane)
                      : zero_entry(EntryT());
    }
  };
  load_first(0);

  // one input (a pixel) or one plane word (a pixel pair) of the slab
  auto load = [](const unsigned char* a) {
    if constexpr (PAIRED)
      return *reinterpret_cast<const uint32_t*>(a);
    else
      return *reinterpret_cast<const XT*>(a);
  };

  if (PIPE) stage(0);
  for (int k = 0; k < nchunks; ++k) {
    if (!PIPE) stage(k);
    cp_wait_all();
    __syncthreads();  // chunk k landed; in the pipeline, chunk k - 1 summed
    if constexpr (PAIRED) {
      build_planes();
      __syncthreads();  // chunk k's planes built, its copy read
    }
    if (PIPE) stage(k + 1);
    const unsigned char* slab = smem + (PIPE ? k % 2 : 0) * slab_bytes;
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int ml = warp * RPW + rr;
      const EntryT* pr = pairs + static_cast<int64_t>(m0 + ml) * K;
      const int end = bounds[ml * (nchunks + 1) + k + 1];
      // the run in windows of 32 entries, lane l holding entry i + l (one
      // coalesced load a window, the next one loaded under this one's
      // sums); each entry is broadcast to the warp by shuffles
      int i = bounds[ml * (nchunks + 1) + k];
      EntryT win = first[rr];
      while (i < end) {
        const int cnt = min(32, end - i);
        const EntryT nxt = i + 32 + lane < end ? __ldg(pr + i + 32 + lane)
                                               : zero_entry(EntryT());
        sum_window<VK, PAIRED, PX, XT>(win, cnt, rscale[rr], qtype,
                                       PAIRED ? 4 : 2, slab, pix, acc[rr],
                                       load);
        win = nxt;
        i += 32;
      }
    }
    load_first(k + 1);
    if (!PIPE) __syncthreads();  // chunk k summed before k + 1 is copied
  }

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int m = m0 + warp * RPW + rr;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      const int q = q0 + pixel_of<PAIRED>(j, lane);
      const int n = q / EQ;
      const int e = (q - n * EQ) / Wq;
      const int f = q - n * EQ - e * Wq;
      if (q > q1 || f >= F) continue;
      const int64_t o =
          (static_cast<int64_t>(n) * M + m) * (E * F) + e * F + f;
      float v = __fadd_rn(acc[rr][j], bias[m]);
      if (residual != nullptr) v = __fadd_rn(v, widen(residual[o]));
      if (relu) v = fmaxf(v, 0.f);
      put(out + o, v);
    }
  }
}

// A 1x1 conv has no halo: a staged slab would serve only the block's own
// rows, so nothing is staged.  Each entry's input is read straight from
// xpad through L1 (the block's rows read the same pixels' channels), the
// entries walked in windows as above, the whole row one run (rowptr (M,
// 2), offsets c*Hp*Wp; a bf16 word's offset is the channel c, times
// Hp*Wp here), and the sums formed in the same order.  PAIRED: a lane's
// pixel pairs (stride 1, even F and Wp) read as one 4-byte load each.
template <int TM, int PX, int VK, bool PAIRED, typename XT>
__global__ void __launch_bounds__(NTH) sparse_conv_1x1_kernel(
    const XT* __restrict__ xpad, const typename Entry<VK>::T* __restrict__ pairs,
    const int* __restrict__ rowptr, const float* __restrict__ scale,
    const float* __restrict__ bias, const XT* __restrict__ residual,
    XT* __restrict__ out, int NIMG, int C, int Hp, int Wp, int M, int K,
    int E, int F, int stride, int relu, int qtype) {
  using EntryT = typename Entry<VK>::T;
  static_assert(!PAIRED || (sizeof(XT) == 2 && VK == VK_BF16 && PX % 2 == 0),
                "paired 1x1 loads take bf16 inputs and bf16 words");
  constexpr int RPW = TM / NWARPS;
  constexpr int P = 32 * PX;
  constexpr int NPIX = PAIRED ? PX / 2 : PX;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int m0 = blockIdx.y * TM;
  const int q0 = blockIdx.x * P;
  const int EF = E * F;
  const int q1 = min(q0 + P, NIMG * EF) - 1;
  const unsigned char* xb = reinterpret_cast<const unsigned char*>(xpad);
  // a bf16 word's offset unit: one channel of xpad
  const int unit = Hp * Wp * static_cast<int>(sizeof(XT));

  // this lane's pixels (pixel pairs, whose second pixel is the first's
  // neighbour in xpad): their inputs' byte offsets in xpad at channel 0
  int pix[NPIX];
#pragma unroll
  for (int j = 0; j < NPIX; ++j) {
    // (a pair lies whole in the tile: N*E*F is even where pairs are read)
    const int q = min(q0 + pixel_of<PAIRED>(PAIRED ? 2 * j : j, lane),
                      PAIRED ? q1 - 1 : q1);
    const int n = q / EF;
    const int e = (q - n * EF) / F;
    pix[j] = static_cast<int>(sizeof(XT)) *
             ((n * C * Hp + e * stride) * Wp + (q - n * EF - e * F) * stride);
  }
  auto load = [](const unsigned char* a) {
    if constexpr (PAIRED)
      return __ldg(reinterpret_cast<const uint32_t*>(a));
    else
      return __ldg(reinterpret_cast<const XT*>(a));
  };

  float acc[RPW][PX];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
#pragma unroll
    for (int j = 0; j < PX; ++j) acc[rr][j] = 0.f;
    const int m = m0 + warp * RPW + rr;
    if (m >= M) continue;
    const EntryT* pr = pairs + static_cast<int64_t>(m) * K;
    const float sc = VK == VK_QUANT ? scale[m] : 1.f;
    const int end = rowptr[2 * m + 1];
    int i = rowptr[2 * m];
    EntryT win = i + lane < end ? __ldg(pr + i + lane) : zero_entry(EntryT());
    while (i < end) {
      const int cnt = min(32, end - i);
      const EntryT nxt = i + 32 + lane < end ? __ldg(pr + i + 32 + lane)
                                             : zero_entry(EntryT());
      sum_window<VK, PAIRED, PX, XT>(win, cnt, sc, qtype, unit, xb, pix,
                                     acc[rr], load);
      win = nxt;
      i += 32;
    }
  }

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int m = m0 + warp * RPW + rr;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      const int q = q0 + pixel_of<PAIRED>(j, lane);
      if (q > q1) continue;
      const int n = q / EF;
      const int64_t o = (static_cast<int64_t>(n) * M + m) * EF + (q - n * EF);
      float v = __fadd_rn(acc[rr][j], bias[m]);
      if (residual != nullptr) v = __fadd_rn(v, widen(residual[o]));
      if (relu) v = fmaxf(v, 0.f);
      put(out + o, v);
    }
  }
}

template <int TM, int PX, int VK, bool PAIRED, typename XT>
int launch_1x1(const XT* xpad, const void* pairs, const int* rowptr,
               const float* scale, const float* bias, const XT* residual,
               XT* out, int N, int C, int Hp, int Wp, int M, int K, int E,
               int F, int stride, int relu, int qtype, cudaStream_t stream) {
  if (PAIRED && (stride != 1 || F % 2 || Wp % 2))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N * E * F + 32 * PX - 1) / (32 * PX), (M + TM - 1) / TM);
  sparse_conv_1x1_kernel<TM, PX, VK, PAIRED, XT><<<grid, NTH, 0, stream>>>(
      xpad, static_cast<const typename Entry<VK>::T*>(pairs), rowptr, scale,
      bias, residual, out, N, C, Hp, Wp, M, K, E, F, stride, relu, qtype);
  return static_cast<int>(cudaGetLastError());
}

template <int TM, int PX, bool PIPE, int VK, bool PAIRED, typename XT>
int launch(const XT* xpad, const void* pairs, const int* rowptr,
           const float* scale, const float* bias, const XT* residual,
           XT* out, int N, int C, int Hp, int Wp, int M, int K, int RS,
           int S, int E, int F, int stride, int cc, int rows, int relu,
           int qtype, cudaStream_t stream) {
  if (sizeof(XT) == 2 && Wp % 2) return static_cast<int>(cudaErrorInvalidValue);
  if (PAIRED && stride != 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t elems = static_cast<size_t>(cc) * rows * Wp;
  const size_t slab_bytes =
      PAIRED ? 4 * static_cast<size_t>(
                       plane_words(static_cast<int>(elems) + S + 1))
             : ((elems + S) * sizeof(XT) + 15) & ~15;
  const size_t nchunks = (C + cc - 1) / cc;
  const size_t smem = ((PIPE ? 2 : 1) + (PAIRED ? 1 : 0)) * slab_bytes +
                      static_cast<size_t>(cc) * rows * 4 +
                      static_cast<size_t>(TM) * (nchunks + 1) * 4;
  const cudaError_t err = cudaFuncSetAttribute(
      sparse_conv_kernel<TM, PX, PIPE, VK, PAIRED, XT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int Wq = stride == 1 ? Wp : F;  // the kernel's pixel rows
  const dim3 grid((N * E * Wq + 32 * PX - 1) / (32 * PX), (M + TM - 1) / TM);
  sparse_conv_kernel<TM, PX, PIPE, VK, PAIRED, XT><<<grid, NTH, smem, stream>>>(
      xpad, static_cast<const typename Entry<VK>::T*>(pairs), rowptr, scale,
      bias, residual, out, N, C, Hp, Wp, M, K, RS, S, E, F, stride, cc, rows,
      relu, qtype);
  return static_cast<int>(cudaGetLastError());
}

template <int TM, int PX, int VK, bool PAIRED, typename XT>
int dispatch(const void* xv, const void* pr, const int* rp, const float* sc,
             const float* b, const void* resv, void* ov, int N, int C,
             int Hp, int Wp, int M, int K, int RS, int S, int E, int F,
             int stride, int cc, int rows, int pipeline, int relu, int qtype,
             cudaStream_t st) {
  const XT* x = static_cast<const XT*>(xv);
  const XT* res = static_cast<const XT*>(resv);
  XT* o = static_cast<XT*>(ov);
  if (RS == 1)
    return launch_1x1<TM, PX, VK, PAIRED, XT>(x, pr, rp, sc, b, res, o, N, C,
                                              Hp, Wp, M, K, E, F, stride,
                                              relu, qtype, st);
  // (a paired slab is blocking: no pipelined instance of it)
  if (PAIRED && pipeline) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (!PAIRED) {
    if (pipeline)
      return launch<TM, PX, true, VK, false, XT>(
          x, pr, rp, sc, b, res, o, N, C, Hp, Wp, M, K, RS, S, E, F, stride,
          cc, rows, relu, qtype, st);
  }
  return launch<TM, PX, false, VK, PAIRED, XT>(
      x, pr, rp, sc, b, res, o, N, C, Hp, Wp, M, K, RS, S, E, F, stride, cc,
      rows, relu, qtype, st);
}

template <int TM, int PX>
int by_type(int qtype, int act, int paired, const void* x, const void* pr,
            const int* rp, const float* sc, const float* b, const void* res,
            void* o, int N, int C, int Hp, int Wp, int M, int K, int RS,
            int S, int E, int F, int stride, int cc, int rows, int pipeline,
            int relu, cudaStream_t st) {
#define SPARSE_CONV_TYPE(VK, PAIRED, XT)                                     \
  return dispatch<TM, PX, VK, PAIRED, XT>(x, pr, rp, sc, b, res, o, N, C,   \
                                          Hp, Wp, M, K, RS, S, E, F, stride, \
                                          cc, rows, pipeline, relu, qtype,   \
                                          st);
  if (act) {
    if (qtype == 3) {
      if constexpr (PX % 2 == 0) {
        if (paired) SPARSE_CONV_TYPE(VK_BF16, true, __nv_bfloat16)
      }
      SPARSE_CONV_TYPE(VK_BF16, false, __nv_bfloat16)
    }
    if (paired) return static_cast<int>(cudaErrorInvalidValue);
    if (qtype) SPARSE_CONV_TYPE(VK_QUANT, false, __nv_bfloat16)
    SPARSE_CONV_TYPE(VK_PAIR, false, __nv_bfloat16)
  }
  if (paired || qtype == 3) return static_cast<int>(cudaErrorInvalidValue);
  if (qtype) SPARSE_CONV_TYPE(VK_QUANT, false, float)
  SPARSE_CONV_TYPE(VK_PAIR, false, float)
#undef SPARSE_CONV_TYPE
}

}  // namespace

// pairs: (M, K) of (slab byte offset, value bits) for an f32 or bf16 bank
// (qtype 0), of words (slab element offset << 8 | value byte) for a
// quantised one (qtype 1: int8, 2: e4m3), with scale its (M,) f32 scales,
// or of words (offset << 16 | bf16 bits) for a bf16 bank on bf16
// activations (qtype 3; the offset in elements, in plane words where
// paired, in channels for a 1x1 conv); rowptr: (M, nchunks + 1) run bounds
// (ref.py: stretch_bank).  xpad, residual and out are f32 (act 0) or bf16
// (act 1).  A 1x1 conv (RS = 1) runs the unstaged kernel: its offsets are
// of c*Hp*Wp, one run a row.
extern "C" int sparse_conv_ell(const void* xpad, const void* pairs,
                               const void* rowptr, const void* scale,
                               const void* bias, const void* residual,
                               void* out, int N, int C, int Hp, int Wp, int M,
                               int K, int RS, int S, int E, int F, int stride,
                               int tm, int px, int cc, int rows, int pipeline,
                               int relu, int qtype, int act, int paired,
                               void* stream) {
  const int* rp = static_cast<const int*>(rowptr);
  const float* sc = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cc <= 0 || rows <= 0 || qtype < 0 || qtype > 3 || act < 0 || act > 1 ||
      ((qtype == 1 || qtype == 2) && sc == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
#define SPARSE_CONV_LAUNCH(TM, PX)                                           \
  if (tm == TM && px == PX)                                                  \
    return by_type<TM, PX>(qtype, act, paired, xpad, pairs, rp, sc, b,       \
                           residual, out, N, C, Hp, Wp, M, K, RS, S, E, F,   \
                           stride, cc, rows, pipeline, relu, st);
  SPARSE_CONV_LAUNCH(8, 1)
  SPARSE_CONV_LAUNCH(8, 2)
  SPARSE_CONV_LAUNCH(8, 4)
  SPARSE_CONV_LAUNCH(8, 8)
  SPARSE_CONV_LAUNCH(16, 1)
  SPARSE_CONV_LAUNCH(16, 2)
  SPARSE_CONV_LAUNCH(16, 4)
  SPARSE_CONV_LAUNCH(32, 1)
  SPARSE_CONV_LAUNCH(32, 2)
  SPARSE_CONV_LAUNCH(32, 4)
#undef SPARSE_CONV_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

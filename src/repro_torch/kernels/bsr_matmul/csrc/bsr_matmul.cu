// Block-sparse (BCSR) matmul y = x @ W^T with f32 accumulation, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel bsr_matmul_pallas / _kernel in
// src/repro/kernels/bsr_matmul/kernel.py.  W of logical shape (M, N) is
// blocked into (BM, BN) tiles; block-row i keeps nblocks[i] tiles
// blocks[i, kb] (kb < nblocks[i]) at block columns blockcol[i, kb], padded
// to KB with inert zero tiles that the kernels never read.  For x (B, N)
// (N a multiple of BN) and the GM*BM outputs:
//
//   y[r, i*BM + m] = sum_{kb < nblocks[i]} sum_j blocks[i,kb,m,j] *
//                    x[r, blockcol[i,kb]*BN + j]             (f32 sums)
//
// rounded once to the output's dtype (f32 or bf16).  BM and BN are any
// multiples of 16 (the reference's default (128, 128) tiles among them;
// kernel.py re-tiles a bank of any other block first).  Both schedules
// read the bank as GS = GM * S sub-rows, S = BM / 16: sub-row r = i S + j
// reads the (16, BN) piece j of each of block-row i's kept tiles (tile
// rows 16 j .. 16 j + 15: 16 BN contiguous elements, the pieces of
// successive tiles BM BN apart) and writes outputs 16 r .. 16 r + 15.  At
// BM = 16 a sub-row is a block-row, and the walks are the (16, BN) tiles'
// as they were.  Two schedules, picked by the launcher (kernel.py) from the
// row count and the dtype:
//
//   rows (f32 or bf16 inputs) -- up to 2048 bf16 rows (decode: 4 on the
//     serving path), f32 at any count.  At decode the work is 2*B*kept*BM*BN
//     operations over the kept tiles' bytes, far below the card's 295
//     operations per byte: the weight bytes bound it (3.3 GB a Yi-9B
//     decode step, 0.99 ms at 3.35 TB/s), and a kernel streams them well
//     only with many bytes in flight on every SM.  The launcher cuts each
//     sub-row's run of kept pieces into `cluster` units of about equal
//     size (a work list built once per bank), and a block's producer warp
//     streams its units into a ring of RSTAGES shared-memory stages on an
//     mbarrier each, by 1-D bulk copies (cp.async.bulk): one a stage at
//     BM = 16, where a unit's pieces are contiguous (blocks[i, kb0:kb1]),
//     one a piece above, while RW consumer warps multiply: a (16, 16)
//     part of a piece is one mma.sync m16n8k16 for each 8 rows of x, x's
//     fragments read from shared memory, where the producer staged x's
//     rows of the pass with one more bulk copy (bf16 passes of 8 rows, up
//     to RX_MAX bytes; else through L1).  A bank of many sub-rows takes
//     whole sub-rows (cluster 1), each block an equal share of them; one
//     of fewer sub-rows than SMs (wk, wv in (16, 16) tiles: 32) splits
//     each over a thread-block cluster, whose first block adds the others'
//     sums, stored into its shared memory, in block order.  One launch, no
//     atomics: the same bits on every call.  Only the kept pieces are
//     copied, in any column order.
//
//   wgmma (tensor cores, bf16 inputs only) -- for many rows, as in prefill
//     (B*T = 8192 rows).  The kept tiles' products are bound by the bf16
//     tensor cores (989 TFLOP/s on an H100 SXM) only if x, which every
//     block-row reads at its own scattered block columns, is not fetched
//     again for each tile: a tile is one 16-deep step of 16 outputs, so
//     its reuse has to come from the x columns the block-rows share.  One
//     block owns 128 rows of x and a group of GB = 16 sub-rows (256
//     outputs); each of its two warpgroups accumulates 8 of the
//     sub-rows for all 128 rows (two 64-row halves, 8 f32 registers a
//     thread for each sub-row and half).  The block walks the columns of
//     x in chunks of CW = 128, filled by cp.async into two rings: per
//     chunk, x[rows, chunk] once for the whole group
//     (XSTAGES = 3 stages, two chunks ahead of the wgmmas), and the 16-
//     column parts of the group's kept pieces that fall in the chunk
//     (TSTAGES = 2 stages of a slot per sub-row and 16-column block, one
//     chunk ahead; a tile across the chunk's edge, where BN does not
//     divide CW, is taken in two parts).  blockcol ascends strictly within
//     a row up to nblocks[i] (bcsr_from_dense keeps the kept tiles in
//     row-major order), so one pointer a sub-row walks its tiles in step
//     with the chunks, passing a tile once its last part is staged, and
//     padding tiles are never reached.  A bank out of order would lose
//     tiles silently (the walk stops short), a repeated column would
//     overwrite its twin's slot: the launcher (kernel.py) refuses both,
//     checked once per bank.  Each kept (16, 16) part is two
//     wgmma m64n16k16, one per 64-row half (x and the tile K-major in shared
//     memory, in 8 x 8 core matrices without a swizzle; the x sub-tile of
//     16-column block jj sits 2048 jj bytes into the chunk) into its
//     sub-row's accumulator; a bitmask a sub-row and stage says which
//     of the chunk's 8 slots hold a part.  Blocks run group-major
//     (the groups of one row slab are consecutive block indices), so the
//     blocks that share a slab of x run together and x comes from device
//     memory about once; it crosses L2 once per group (M / 256 times) and
//     each tile once per 128 rows.  The epilogue writes y in the output
//     dtype straight from the accumulators.
//
//     What holds it (H100 SXM, Yi-9B's gate at 8192 rows, ablate.py): not
//     the tensor cores, which the kept tiles would keep busy for 0.15 ms
//     of its ~2.8 ms.  With no copy it still takes ~60 % of that time,
//     with no wgmma ~75 %: a chunk's copies, its walk and its wgmmas
//     largely follow one another.  A wgmma of 16 outputs costs about as
//     much to issue as a wider one, and a data-dependent run of them gets
//     a warpgroup arrive each (ptxas C7519); issuing every slot (empty
//     ones reading zeros), each under a predicate, or mma.sync per warp
//     measured slower.  Chunks of 64 columns, or blocks of 64 rows two to
//     an SM, are slower too (more per-chunk overhead; each tile crosses L2
//     twice as often).  A deeper tile ring needs compact slots (the worst
//     case of a slot per block-row and 16-column block fills the shared
//     memory) and a producer warp ahead of the consumers: the next step.
//
// Rows past B are bounds-tested (no padding of x is needed); N must be a
// multiple of BN (the wrapper pads), BM and BN multiples of 16.  x and the
// tiles must be 16-byte aligned (the wrapper checks).
//
// C interface (ctypes): pointers and the stream are void*, sizes are int;
// dtype and out_dtype 0 = f32, 1 = bf16; schedule 0 = rows, 1 = wgmma.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a combination no kernel takes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(bf16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as .to(bfloat16)
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// rows schedule (f32 or bf16 inputs)
// ---------------------------------------------------------------------------

constexpr int RW = 4;                   // consumer warps of a rows block
constexpr int RTHREADS = (RW + 1) * 32;  // and one producer warp
constexpr int RSTAGES = 4;              // stages of the tile ring
constexpr int RHEAD = 128;              // bytes of mbarriers before the ring
constexpr int RCHUNK = 64;              // pieces a block fetches x for at once
constexpr int RCLUSTER_MAX = 8;         // units of a block-row (portable)
constexpr int RMIN_BLOCKS = 4;          // blocks an SM must hold

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
          bar)
      : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}
// One thread waits for the phase of parity `parity` to complete.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}
// A whole warp waits and leaves together: try_wait may time out in some
// lanes and not others, and the warp-wide instructions after it (mma.sync,
// bar.sync) need every lane.
__device__ __forceinline__ void mbar_wait_warp(uint32_t bar, int parity) {
  while (!__all_sync(0xffffffffu, mbar_try_wait(bar, parity))) {
  }
}
// The barrier's one arrival, announcing `bytes` to land on it: its phase
// completes when they have.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 st;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          bar),
      "r"(bytes)
      : "memory");
}
// One 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from device memory into shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t bar, uint32_t dst,
                                          const void* src, uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// One bulk copy of `bytes` into shared memory on the barrier's one arrival.
__device__ __forceinline__ void load_stage(uint32_t bar, uint32_t dst,
                                           const void* src, uint32_t bytes) {
  mbar_expect(bar, bytes);
  bulk_copy(bar, dst, src, bytes);
}
// `n` pieces of `bytes` each, `stride` elements apart in device memory,
// side by side into shared memory on the barrier's one arrival: one copy
// where they are contiguous.
template <typename T>
__device__ __forceinline__ void load_pieces(uint32_t bar, uint32_t dst,
                                            const T* src, int n,
                                            uint32_t bytes, int64_t stride) {
  if (stride * static_cast<int64_t>(sizeof(T)) == bytes) {
    load_stage(bar, dst, src, n * bytes);
    return;
  }
  mbar_expect(bar, n * bytes);
  for (int p = 0; p < n; ++p)
    bulk_copy(bar, dst + p * bytes, src + p * stride, bytes);
}
// A cluster barrier in two halves: every thread of every block of the
// cluster arrives, then waits.  A plain arrive releases the thread's
// writes to shared memory, the wait acquires the others'.
__device__ __forceinline__ void cluster_arrive(bool relaxed) {
  if (relaxed)
    asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
  else
    asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}
// Stores v at the same shared-memory offset as p in block `rank` of the
// cluster.
__device__ __forceinline__ void st_cluster(float* p, int rank, float v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(p)), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(remote), "f"(v)
               : "memory");
}

// Four consecutive bf16 of x as two bf16 pairs (an mma B fragment), or
// zeros past the last row.
__device__ __forceinline__ uint2 load_x4(const bf16* p, bool in) {
  return in ? __ldg(reinterpret_cast<const uint2*>(p)) : make_uint2(0u, 0u);
}

// D (16 x 8, f32) += A (16 x 16, bf16) B (16 x 8, bf16): a0..a3 and b0, b1
// in the fragment order of mma.m16n8k16 (a0 row gid, a1 row gid + 8, a2
// and a3 the same rows' second half of k).
__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Eight consecutive f32 at a 16-byte aligned address.
__device__ __forceinline__ void load8f(const float* p, float* v, bool ldg) {
  const float4 a = ldg ? __ldg(reinterpret_cast<const float4*>(p))
                       : *reinterpret_cast<const float4*>(p);
  const float4 b = ldg ? __ldg(reinterpret_cast<const float4*>(p) + 1)
                       : *(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// A consumer warp's sums over its pieces of the unit, kept in registers:
// a piece is (16, 16) of a tile (16 outputs by 16 columns of x).  bf16: one
// m16n8k16 mma a piece and group of 8 rows of the pass (R / 8 groups), f32
// sums in its accumulator fragment.  The k order of the fragments is
// permuted, the same way in A and B, which leaves the product unchanged:
// lane (gid, tig) loads 8 contiguous bytes of tile rows gid and gid + 8
// and of x row gid, columns 4 tig .. 4 tig + 3 of the piece, which stand
// at k = 2 tig, 2 tig + 1 (first register) and 2 tig + 8, 2 tig + 9
// (second).  A warp reads whole 32-byte tile rows.  The x fragments of up
// to PF pieces (a warp's share of a chunk) are loaded before the first of
// their products.
template <typename T, int R, bool XS>
struct RowsSums;

// XS: x's rows of the pass staged in shared memory at `x` (row 0 the
// pass's first); else x in device memory, read through L1.
template <int R, bool XS>
struct RowsSums<bf16, R, XS> {
  static constexpr int G = R / 8;
  static constexpr int PF = RCHUNK / RW / G;  // 32 registers of fragments
  const bf16* x;
  int r0, B, N, gid, tig;
  float acc[G][4];
  uint2 xf[PF][G];
  __device__ __forceinline__ RowsSums(const bf16* x_, int r0_, int B_,
                                      int N_, int lane)
      : x(x_), r0(r0_), B(B_), N(N_), gid(lane / 4), tig(lane % 4) {}
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;
  }
  // slot k: the x fragments of the piece at column `col`
  __device__ __forceinline__ void fetch(int k, int col, bool live) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int row = 8 * g + gid;  // of the pass
      const bool in = live && r0 + row < B;
      if constexpr (XS) {
        xf[k][g] = in ? *reinterpret_cast<const uint2*>(
                            x + row * N + col + 4 * tig)
                      : make_uint2(0u, 0u);
      } else {
        xf[k][g] = load_x4(
            x + static_cast<int64_t>(r0 + row) * N + col + 4 * tig, in);
      }
    }
  }
  // the piece of slot k at `a` (its tile's row 0, its first column), tiles
  // BN wide
  __device__ __forceinline__ void piece(int k, const bf16* a, int BN) {
    const uint2 lo = *reinterpret_cast<const uint2*>(a + gid * BN + 4 * tig);
    const uint2 hi =
        *reinterpret_cast<const uint2*>(a + (gid + 8) * BN + 4 * tig);
#pragma unroll
    for (int g = 0; g < G; ++g)
      mma16816(acc[g], lo.x, hi.x, lo.y, hi.y, xf[k][g].x, xf[k][g].y);
  }
  // (row, m) sums into part[row][m]; accumulator element e is output
  // m = gid + 8 (e / 2) of row 2 tig + e % 2 of group g
  __device__ __forceinline__ void spill(float* part) const {
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        part[(8 * g + 2 * tig + e % 2) * 16 + gid + 8 * (e / 2)] =
            acc[g][e];
  }
};

// f32: lane (m, h) multiplies tile row m = lane / 2, columns 8 h .. 8 h + 7
// of the piece, with each row of the pass (x read through L1 when the
// piece's stage has landed), one f32 sum a row; lane pairs are added at
// the end.
template <int R, bool XS>
struct RowsSums<float, R, XS> {
  static constexpr int PF = 4;
  const float* x;
  int r0, B, N, m, h;
  float acc[R];
  int col[PF];
  __device__ __forceinline__ RowsSums(const float* x_, int r0_, int B_,
                                      int N_, int lane)
      : x(x_), r0(r0_), B(B_), N(N_), m(lane / 2), h(lane % 2) {}
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
  }
  __device__ __forceinline__ void fetch(int k, int c, bool) { col[k] = c; }
  __device__ __forceinline__ void piece(int k, const float* a, int BN) {
    float w[8];
    load8f(a + m * BN + 8 * h, w, false);
    const float* xr = x + static_cast<int64_t>(r0) * N + col[k] + 8 * h;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r0 + r < B) {
        float xv[8];
        load8f(xr + static_cast<int64_t>(r) * N, xv, true);
        float s = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) s = fmaf(w[j], xv[j], s);
        acc[r] += s;
      }
    }
  }
  __device__ __forceinline__ void spill(float* part) {
    const int lane = 2 * m + h;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float v = acc[r] + __shfl_xor_sync(0xffffffffu, acc[r], 1);
      if (lane % 2 == 0) part[r * 16 + m] = v;
    }
  }
};

// Consumer warps only: a barrier of the RW * 32 consumer threads (each
// warp converged: bar.sync is barrier.sync.aligned).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(RW * 32) : "memory");
}

// Bytes of shared memory the XS kernel gives x's rows of a pass (`rows`
// rows of N), rounded up to 128.
template <typename T>
__host__ __device__ inline int rows_x_bytes(int rows, int N) {
  return (rows * N * static_cast<int>(sizeof(T)) + 127) / 128 * 128;
}
constexpr int RX_MAX = 96 * 1024;  // the most x may take (else via L1)

template <typename T>
__host__ __device__ constexpr int stage1_tiles() {
  return 4096 / (16 * 16 * static_cast<int>(sizeof(T)));  // bytes a stage
}

// Bytes of the ring: RSTAGES stages of stage_tiles tiles BN wide.
template <typename T>
__host__ __device__ inline int rows_ring_bytes(int stage_tiles, int BN) {
  return RSTAGES * stage_tiles * 16 * BN * static_cast<int>(sizeof(T));
}

// Dynamic shared memory of a rows block: the barriers; x's rows of the
// pass (XS); the ring; the warps' f32 sums of a pass; with a cluster, a
// slot of a pass's sums for each of its blocks.
template <typename T, int R, bool XS>
__host__ __device__ inline int rows_smem_bytes(int B, int N, int BN,
                                               int stage_tiles, int cluster) {
  return RHEAD + (XS ? rows_x_bytes<T>(B < R ? B : R, N) : 0) +
         rows_ring_bytes<T>(stage_tiles, BN) + RW * R * 16 * 4 +
         (cluster > 1 ? cluster * R * 16 * 4 : 0);
}

// A block takes units blockIdx.x, + gridDim.x, ... of a pass of R rows of
// x (blockIdx.y); with a cluster (the `cluster` units of a sub-row are the
// consecutive blocks of one thread-block cluster, unit u its block
// u % cluster), one unit, gridDim.x the units.  Unit u (an int4: sub-row
// r = i S + j, its tiles [kb0, kb1); their block columns at
// cols[u * maxt ..]) is piece j of block-row i's tiles kb0 .. kb1 - 1,
// (16, BN) each, BM BN elements apart (contiguous at S = 1).  The producer
// warp stages x's rows of the pass (XS, one bulk copy), then streams the
// block's units into the ring back to back, stage by stage (a stage of
// `stage_tiles` pieces of one unit, on the stage's `full` barrier; a stage
// is refilled once the RW consumer warps have arrived on its `empty`
// barrier).  Within a unit, (16, 16) part p goes to consumer warp p % RW
// (a stage holds a multiple of RW parts).  A warp takes its parts in
// chunks of PF: it loads the chunk's block columns (one load a lane,
// independent of the unit's descriptor; for passes of 8 rows the next
// unit's are loaded during this one) and every x fragment of its parts
// there, then waits for each stage and multiplies.  At a unit's end the
// warps' sums are added in warp order; without a cluster they are y, else
// block 0 of the cluster adds its blocks' sums in block order (stored into
// its shared memory) and writes y: no atomics, the same bits on every
// launch.  KS is the parts a piece for (16, 16 KS) pieces (KS = 1 for
// (BM, 16) tiles, whose stage size is then a constant, stage1_tiles, and
// every index a shift), or 0 for any width.
template <typename T, typename TO, int R, int KS, bool XS>
__global__ void __launch_bounds__(RTHREADS, RMIN_BLOCKS) bsr_matmul_rows(
    const T* __restrict__ x, const T* __restrict__ blocks,
    const int4* __restrict__ units, const int* __restrict__ cols,
    TO* __restrict__ y, int B, int N, int GS, int S, int KB, int BN_,
    int stage_tiles_, int cluster, int maxt, int nunits) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int BN = KS ? 16 * KS : BN_;
  const int stage_tiles = KS == 1 ? stage1_tiles<T>() : stage_tiles_;
  const uint32_t bars = smem_u32(smem);  // full, then empty, then x's
  const uint32_t xbar = bars + 16 * RSTAGES;
  T* xs = reinterpret_cast<T*>(smem + RHEAD);
  const int xoff = XS ? rows_x_bytes<T>(min(R, B), N) : 0;
  T* ring = reinterpret_cast<T*>(smem + RHEAD + xoff);
  float* part = reinterpret_cast<float*>(
      smem + RHEAD + xoff + rows_ring_bytes<T>(stage_tiles, BN));
  float* slots = part + RW * R * 16;

  const int r0 = blockIdx.y * R;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int ks = BN / 16;                    // parts a piece
  const int tile_elems = 16 * BN;            // elements of a piece
  const int stage_elems = stage_tiles * tile_elems;
  const int stage_pieces = stage_tiles * ks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < RSTAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (RSTAGES + s), RW);
    }
    mbar_init(xbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  // a block may write another's shared memory only once that block runs:
  // the first phase of the cluster barrier, waited on before the writes
  if (cluster > 1) cluster_arrive(true);

  using Sums = RowsSums<T, R, XS>;
  constexpr int PF = Sums::PF;
  Sums sums(XS ? xs : x, r0, B, N, lane);
  if (warp == RW) {  // the producer
    if (lane == 0) {
      if (XS)  // the pass's rows of x: contiguous, one copy
        load_stage(xbar, smem_u32(xs), x + static_cast<int64_t>(r0) * N,
                   min(R, B - r0) * N * static_cast<uint32_t>(sizeof(T)));
      int gs = 0;  // stages issued by this block
      int4 next = units[blockIdx.x];
      for (int u = blockIdx.x; u < nunits; u += gridDim.x) {
        const int4 un = next;
        if (u + gridDim.x < nunits) next = units[u + gridDim.x];
        const int nt = un.z - un.y;
        // piece j = un.x % S of block-row un.x / S's tile un.y, the next
        // tile's piece S tile_elems on
        const int64_t stride = static_cast<int64_t>(S) * tile_elems;
        const T* src = blocks +
                       (static_cast<int64_t>(un.x / S) * KB + un.y) * stride +
                       (un.x % S) * tile_elems;
        for (int t = 0; t < nt; t += stage_tiles, ++gs) {
          const int slot = gs % RSTAGES;
          if (gs >= RSTAGES)
            mbar_wait(bars + 8 * (RSTAGES + slot), (gs / RSTAGES - 1) & 1);
          load_pieces(bars + 8 * slot,
                      smem_u32(ring + static_cast<int64_t>(slot) * stage_elems),
                      src + t * stride, min(stage_tiles, nt - t),
                      tile_elems * static_cast<uint32_t>(sizeof(T)), stride);
        }
      }
    }
    __syncwarp();  // the producer warp together again
  } else {  // a consumer
    // KS == 1: a chunk (RW * PF pieces) starts a stage and holds whole
    // stages, so a warp's piece k of it is the first of its stage's when
    // k % (pieces a warp a stage) == 0
    constexpr int PJ1 = stage1_tiles<T>() / RW;
    static_assert(KS != 1 || ((RW * PF) % stage1_tiles<T>() == 0 &&
                              stage1_tiles<T>() % RW == 0),
                  "a chunk holds whole stages, a stage RW pieces or more");
    // AHEAD: a unit's descriptor and its first 64 block columns (at a
    // stride of maxt a unit in the work list, read without waiting for
    // the descriptor) are loaded one unit ahead.  Only for passes of 8
    // rows: at 16 and 32 rows it measured slower (more registers live
    // beside the fragments), at 4 faster.
    constexpr bool AHEAD = R == 8;
    auto first_cols = [&](int u, int off) {
      return off + lane < maxt ? cols[static_cast<int64_t>(u) * maxt + off +
                                      lane]
                               : 0;
    };
    int4 next = {};
    int next_lo = 0, next_hi = 0;
    if (AHEAD) {
      next = units[blockIdx.x];
      next_lo = first_cols(blockIdx.x, 0);
      next_hi = first_cols(blockIdx.x, 32);
    }
    if (XS) mbar_wait_warp(xbar, 0);
    int gbase = 0;  // stages of the block's earlier units
    for (int u = blockIdx.x; u < nunits; u += gridDim.x) {
      const int* bc = cols + static_cast<int64_t>(u) * maxt;
      const int4 un = AHEAD ? next : units[u];
      int c_lo = next_lo, c_hi = next_hi;
      if (AHEAD && u + gridDim.x < nunits) {
        next = units[u + gridDim.x];
        next_lo = first_cols(u + gridDim.x, 0);
        next_hi = first_cols(u + gridDim.x, 32);
      }
      const int nt = un.z - un.y;
      const int total = nt * ks;             // pieces of the unit
      sums.zero();
      for (int c0 = 0; c0 < total; c0 += RW * PF) {
        // the chunk's tiles (at most 64 from t0): lane l holds the block
        // columns of tiles t0 + l and t0 + 32 + l
        const int t0 = c0 / ks;
        if (!AHEAD || c0 > 0) {
          c_lo = t0 + lane < maxt ? bc[t0 + lane] : 0;
          c_hi = t0 + 32 + lane < maxt ? bc[t0 + 32 + lane] : 0;
        }
#pragma unroll
        for (int k = 0; k < PF; ++k) {
          const int q = c0 + warp + RW * k;
          const int t = q / ks - t0;
          const int tc =
              __shfl_sync(0xffffffffu, t < 32 ? c_lo : c_hi, t & 31);
          sums.fetch(k, tc * BN + (q % ks) * 16, q < total);
        }
#pragma unroll
        for (int k = 0; k < PF; ++k) {
          const int q = c0 + warp + RW * k;
          if (q < total) {
            const int s = q / stage_pieces;
            const int gs = gbase + s;
            const int slot = gs % RSTAGES;
            if (KS != 1 || k % PJ1 == 0)
              mbar_wait_warp(bars + 8 * slot, (gs / RSTAGES) & 1);
            sums.piece(k,
                       ring + static_cast<int64_t>(slot) * stage_elems +
                           (q % stage_pieces) / ks * tile_elems +
                           (q % ks) * 16,
                       BN);
            // this warp is done with the stage: the producer may refill it
            if (q + RW >= total || (q + RW) / stage_pieces != s) {
              __syncwarp();
              if (lane == 0) mbar_arrive(bars + 8 * (RSTAGES + slot));
              __syncwarp();
            }
          }
        }
      }
      // a warp with no piece in the unit's last stage (a part of a stage)
      // releases it too: the producer refills the slot for the next unit.
      // It waits for the stage to land first, as a warp with a piece there
      // does: only then has the slot's previous phase (the stage RSTAGES
      // back) completed, so that this arrival counts toward this stage's.
      // Arriving earlier would let a warp RSTAGES stages ahead of another
      // complete that phase without the slower warp's arrival: the producer
      // would refill the slot under it, and the slower warp, finding the
      // full barrier two phases on, would wait on it for ever.
      if (total > 0 && warp >= total - (total - 1) / stage_pieces *
                                           stage_pieces) {
        const int gs = gbase + (total - 1) / stage_pieces;
        mbar_wait_warp(bars + 8 * (gs % RSTAGES), (gs / RSTAGES) & 1);
        if (lane == 0) mbar_arrive(bars + 8 * (RSTAGES + gs % RSTAGES));
        __syncwarp();
      }
      gbase += (nt + stage_tiles - 1) / stage_tiles;
      // the unit's sums of (row, m): the warps' added in order, into
      // part's first slice; y, unless the cluster adds them
      sums.spill(part + warp * R * 16);
      __syncwarp();
      consumers_sync();
      for (int o = threadIdx.x; o < R * 16; o += RW * 32) {
        float v = part[o];
#pragma unroll
        for (int w = 1; w < RW; ++w) v += part[w * R * 16 + o];
        const int row = r0 + o / 16;
        if (cluster > 1)
          part[o] = v;
        else if (row < B)
          store1(y + static_cast<int64_t>(row) * GS * 16 + un.x * 16 + o % 16,
                 v);
      }
      consumers_sync();  // part is free for the next unit
    }
  }
  if (cluster == 1) return;

  // one unit a block: its sums into its slot in the cluster's block 0,
  // which adds them in block order once all are stored
  __syncthreads();
  const int rank = blockIdx.x % cluster;
  const int i = units[blockIdx.x].x;
  cluster_wait();
  for (int o = threadIdx.x; o < R * 16; o += RTHREADS)
    st_cluster(slots + rank * R * 16 + o, 0, part[o]);
  cluster_arrive(false);
  cluster_wait();
  if (rank != 0) return;
  for (int o = threadIdx.x; o < R * 16; o += RTHREADS) {
    const int row = r0 + o / 16;
    if (row >= B) continue;
    float v = slots[o];
    for (int r = 1; r < cluster; ++r) v += slots[r * R * 16 + o];
    store1(y + static_cast<int64_t>(row) * GS * 16 + i * 16 + o % 16, v);
  }
}

// ---------------------------------------------------------------------------
// wgmma schedule (bf16 inputs)
// ---------------------------------------------------------------------------

constexpr int WG = 128;                 // threads of a warpgroup
constexpr int GW = 2;                   // warpgroups a block, 64 rows each
constexpr int GR = GW * 64;             // rows of x a block
constexpr int GB = 16;                  // block-rows a block (its group)
constexpr int CW = 128;                 // columns of x a chunk
constexpr int CSUB = CW / 16;           // 16-column sub-tile slots a chunk
// Two rings: x, the larger part of the bytes, is copied XSTAGES - 1 chunks
// ahead of the wgmmas, the kept tiles TSTAGES - 1 chunks ahead.
constexpr int XSTAGES = 3;
constexpr int TSTAGES = 2;
constexpr int NTH = GW * WG;            // threads of a block
constexpr int NWARPS = NTH / 32;
constexpr int MIN_BLOCKS = 1;           // blocks an SM must hold
// Each warpgroup multiplies every row of the block (its GW 64-row halves)
// for GPW of the group's block-rows: GW wgmmas a kept tile on one walk of
// the masks.
constexpr int GPW = GB / GW;
constexpr int XTILE = 64 * CW * 2;      // bytes of a 64-row half of an x chunk
constexpr int XSTAGE = GW * XTILE;      // bytes of an x stage
constexpr int SLOT = 16 * 16 * 2;       // bytes of a (16, 16) bf16 sub-tile
constexpr int TSTAGE = GB * CSUB * SLOT;  // bytes of a tile stage
constexpr int MASKS = TSTAGES * GB * 4;
constexpr int WGMMA_SMEM = XSTAGES * XSTAGE + TSTAGES * TSTAGE + MASKS;

// A shared-memory matrix descriptor without a swizzle: start address,
// leading and stride byte offsets in 16-byte units (base offset 0, layout
// type 0).  K-major: the leading offset steps between the 8 x 8 core
// matrices along K, the stride offset between those along M or N.
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
__device__ __forceinline__ void fence_regs(float (&d)[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 16, f32) += A (64 x 16) B (16 x 16)^T, A and B K-major in shared
// memory.
__device__ __forceinline__ void wgmma_n16(float (&d)[8], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

// Shared memory: XSTAGES x stages, each the GW 64-row halves of the chunk,
// 64 rows x CW columns with element (r, c) at (c / 8) * 1024 + r * 16 +
// (c % 8) * 2; then TSTAGES tile stages of GB x CSUB (16, 16) slots, slot
// (g, jj) holding the part of sub-row g's pieces that falls on the chunk's
// 16-column block jj, element (m, k) at (k / 8) * 256 + m * 16 + (k % 8) *
// 2; then TSTAGES x GB masks, bit jj of mask (stage, g) set iff slot
// (g, jj) holds a part.
template <typename TO>
__global__ void __launch_bounds__(NTH, MIN_BLOCKS) bsr_matmul_wgmma(
    const bf16* __restrict__ x, const bf16* __restrict__ blocks,
    const int* __restrict__ blockcol, const int* __restrict__ nblocks,
    TO* __restrict__ y, int B, int N, int GS, int S, int KB, int BN,
    int ngroups) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t xbase = smem_u32(smem);
  const uint32_t tbase = xbase + XSTAGES * XSTAGE;
  uint32_t* masks = reinterpret_cast<uint32_t*>(
      smem + XSTAGES * XSTAGE + TSTAGES * TSTAGE);

  // group-major: the groups of one row slab are consecutive blocks
  const int r0 = (blockIdx.x / ngroups) * GR;
  const int i0 = (blockIdx.x % ngroups) * GB;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int wg = tid / WG;
  const int wwarp = (tid % WG) / 32;
  const int gid = lane / 4;
  const int tig = lane % 4;
  const int MO = GS * 16;
  const int nchunks = (N + CW - 1) / CW;
  const int64_t tstride = static_cast<int64_t>(S) * 16 * BN;  // a tile

  // Warp w stages the pieces of sub-rows w, w + NWARPS, ... of the group:
  // each keeps its sub-row's pointer (the first tile not wholly staged),
  // its block-row's tile count, and a window of 32 of its block columns,
  // lane l holding blockcol[i / S, wbase + l] (refilled when fewer than
  // CSUB lie past ptr).
  constexpr int RPW = GB / NWARPS;  // sub-rows a warp stages
  int ptr[RPW], nbr[RPW], wbase[RPW], wcol[RPW];
  auto window = [&](int i, int nb, int kb) {
    return kb < nb ? blockcol[static_cast<int64_t>(i / S) * KB + kb]
                   : 0x7fffffff;
  };
#pragma unroll
  for (int e = 0; e < RPW; ++e) {
    const int i = i0 + warp + NWARPS * e;
    ptr[e] = 0;
    wbase[e] = 0;
    nbr[e] = i < GS ? nblocks[i / S] : 0;
    wcol[e] = window(i, nbr[e], lane);
  }

  // x[r0 .. r0 + 127, chunk c]: eight neighbouring rows of one 16-byte
  // column a warp quarter, so the stores fill whole 128-byte core
  // matrices; zero past B and past N.  One cp.async group.
  auto load_x = [&](int c) {
    if (c < nchunks) {
      const uint32_t sbase = xbase + (c % XSTAGES) * XSTAGE;
      const int col0 = c * CW;
      for (int idx = tid; idx < GR * (CW / 8); idx += NTH) {
        const int r = (idx % 8) + 8 * (idx / (8 * (CW / 8)));
        const int c8 = (idx / 8) % (CW / 8);
        const int row = r0 + r;
        const int col = col0 + c8 * 8;
        const bool in = row < B && col < N;
        cp_async16(sbase + (r / 64) * XTILE + c8 * 1024 + (r % 64) * 16,
                   in ? static_cast<const void*>(
                            x + static_cast<int64_t>(row) * N + col)
                      : static_cast<const void*>(x),
                   in ? 16 : 0);
      }
    }
    cp_commit();  // a group per chunk, empty past the last
  };

  // The parts of the group's kept pieces that fall in chunk c: for each
  // sub-row, the run of its tiles from its pointer on that overlap the
  // chunk, each tile's 16-column parts inside it; the pointer passes a
  // tile once its last part is staged (a tile across the chunk's end is
  // the run's last, and stays).  One cp.async group; the masks are plain
  // stores.
  auto load_tiles = [&](int c) {
    if (c < nchunks) {
      const int st = c % TSTAGES;
      const uint32_t sbase = tbase + st * TSTAGE;
      const int col0 = c * CW;
#pragma unroll
      for (int e = 0; e < RPW; ++e) {
        const int g = warp + NWARPS * e;
        const int i = i0 + g;
        uint32_t mask = 0;
        if (i < GS) {
          if (ptr[e] + CSUB > wbase[e] + 32) {
            wbase[e] = ptr[e];
            wcol[e] = window(i, nbr[e], wbase[e] + lane);
          }
          const int off = ptr[e] - wbase[e];
          const long long cb = static_cast<long long>(wcol[e]) * BN;
          // the leading tiles from the pointer on whose columns overlap
          // the chunk (past nblocks the window holds no column); at most
          // CSUB, each with a part of its own in the chunk
          const bool in = lane >= off && cb < col0 + CW && cb + BN > col0;
          const unsigned long long run =
              ~(static_cast<unsigned long long>(
                    __ballot_sync(0xffffffffu, in)) >> off);
          const int n = __ffsll(run) - 1;
          int passed = n;
          for (int t = 0; t < n; ++t) {
            // the tile's first column from the chunk's (a multiple of 16,
            // below 0 for a tile begun in an earlier chunk) and its parts
            // [q0, q1) in the chunk
            const int tc =
                __shfl_sync(0xffffffffu, wcol[e], off + t) * BN - col0;
            const int q0 = tc < 0 ? -tc / 16 : 0;
            const int q1 = min(BN, CW - tc) / 16;
            if (tc + BN > CW) passed = t;
            mask |= ((1u << (q1 - q0)) - 1) << (tc / 16 + q0);
            const bf16* tile = blocks +
                               (static_cast<int64_t>(i / S) * KB + ptr[e] + t) *
                                   tstride +
                               (i % S) * 16 * BN;
            const int pieces = 2 * (q1 - q0);  // 16-byte pieces a row
            for (int q = lane; q < 16 * pieces; q += 32) {
              const int m = q / pieces;
              const int c8 = 2 * q0 + q % pieces;
              cp_async16(sbase + (g * CSUB + tc / 16 + c8 / 2) * SLOT +
                             (c8 % 2) * 256 + m * 16,
                         tile + m * BN + c8 * 8, 16);
            }
          }
          ptr[e] += passed;
        }
        if (lane == 0) masks[st * GB + g] = mask;
      }
    }
    cp_commit();
  };

  // Groups are committed as x(0), tiles(0), x(1), ..., tiles(c), x(c + 1):
  // iteration c commits the tiles of chunk c + TSTAGES - 1, then the x of
  // chunk c + XSTAGES - 1, so that at the top of iteration c only the
  // newest group, x of chunk c + 1, may be left in flight.
  static_assert(XSTAGES == TSTAGES + 1, "the wait below counts one x group");
#pragma unroll
  for (int c = 0; c < TSTAGES - 1; ++c) {
    load_x(c);
    load_tiles(c);
  }
  load_x(TSTAGES - 1);

  // warpgroup wg accumulates block-rows g0 .. g0 + GPW - 1 of the group
  // for each 64-row half h of the block's rows
  const int g0 = wg * GPW;
  float acc[GPW][GW][8];
#pragma unroll
  for (int g = 0; g < GPW; ++g)
#pragma unroll
    for (int h = 0; h < GW; ++h)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][h][e] = 0.f;

  for (int c = 0; c < nchunks; ++c) {
    // chunk c's x and tiles landed (only the x of chunk c + XSTAGES - 2,
    // committed last, may still be in flight), and every warp is past
    // chunk c - 1, whose stages the copies below refill
    cp_wait<1>();
    fence_async_smem();
    __syncthreads();
    load_tiles(c + TSTAGES - 1);
    load_x(c + XSTAGES - 1);

    const uint32_t xs = xbase + (c % XSTAGES) * XSTAGE;
    const uint32_t slots = tbase + (c % TSTAGES) * TSTAGE;
    const uint32_t* mk = masks + (c % TSTAGES) * GB;
    wg_fence();
#pragma unroll
    for (int g = 0; g < GPW; ++g) {
      uint32_t m = mk[g0 + g];
      while (m) {
        const int jj = __ffs(m) - 1;
        m &= m - 1;
        const uint64_t bd =
            smem_desc(slots + ((g0 + g) * CSUB + jj) * SLOT, 256, 128);
#pragma unroll
        for (int h = 0; h < GW; ++h)
          wgmma_n16(acc[g][h],
                    smem_desc(xs + h * XTILE + jj * 2048, 1024, 128), bd);
      }
    }
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int g = 0; g < GPW; ++g)
#pragma unroll
      for (int h = 0; h < GW; ++h) fence_regs(acc[g][h]);
  }
  cp_wait<0>();

  // accumulator element e: row wwarp * 16 + gid + 8 (e / 2 % 2) of the
  // 64-row half, output column 8 (e / 4) + 2 tig + e % 2 of the block-row
#pragma unroll
  for (int g = 0; g < GPW; ++g) {
    const int i = i0 + g0 + g;
    if (i >= GS) continue;
#pragma unroll
    for (int h = 0; h < GW; ++h)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = r0 + h * 64 + wwarp * 16 + gid + 8 * hr;
        if (row >= B) continue;
        TO* out = y + static_cast<int64_t>(row) * MO + i * 16 + tig * 2;
#pragma unroll
        for (int n8 = 0; n8 < 2; ++n8)
          store2(out + n8 * 8, acc[g][h][n8 * 4 + hr * 2],
                 acc[g][h][n8 * 4 + hr * 2 + 1]);
      }
  }
}

// The card's SMs, or 0.
inline int card_sms() {
  static int sms = 0;
  if (sms == 0 &&
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0) !=
          cudaSuccess)
    return 0;
  return sms;
}

// The blocks of `kernel` an SM holds at `smem` bytes (asked once for each
// kernel and size, then kept), or 0.
inline int blocks_per_sm(const void* kernel, int smem) {
  struct Entry { const void* kernel; int smem, blocks; };
  static Entry seen[64];
  static int n = 0;
  for (int e = 0; e < n; ++e)
    if (seen[e].kernel == kernel && seen[e].smem == smem)
      return seen[e].blocks;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                    RTHREADS, smem) !=
      cudaSuccess)
    return 0;
  if (n < 64) seen[n++] = {kernel, smem, blocks};
  return blocks;
}

template <typename T, typename TO, int R, int KS, bool XS>
int launch_rows_ks(const void* x, const void* blocks, const int* units,
                   const int* cols, void* y, int B, int N, int GS, int S, int KB,
                   int BN, int nunits, int stage_tiles, int cluster, int maxt,
                   int per_sm, cudaStream_t st) {
  auto kernel = bsr_matmul_rows<T, TO, R, KS, XS>;
  const int smem =
      rows_smem_bytes<T, R, XS>(B, N, BN, stage_tiles, cluster);
  static int opted = 48 * 1024;  // this kernel's opt-in so far
  if (smem > opted) {  // above the default only after the opt-in
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = smem;
  }
  // without a cluster, at most per_sm blocks an SM (as many as fit, for
  // 0), each taking an equal share of the units
  int grid = nunits;
  if (cluster == 1) {
    int fit = blocks_per_sm(reinterpret_cast<const void*>(kernel), smem);
    if (per_sm > 0) fit = min(fit, per_sm);
    const int cap = fit * card_sms();
    if (cap <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const int each = (nunits + cap - 1) / cap;
    grid = (nunits + each - 1) / each;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, (B + R - 1) / R);
  cfg.blockDim = dim3(RTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(x), static_cast<const T*>(blocks),
      reinterpret_cast<const int4*>(units), cols, static_cast<TO*>(y), B, N,
      GS, S, KB, BN, stage_tiles, cluster, maxt, nunits);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// (BM, 16) tiles take the KS = 1 kernel, whose stage is the constant
// stage1_tiles (the launcher's is ignored); bf16 passes of 8 rows stage x
// in shared memory where its rows take at most RX_MAX bytes
template <typename T, typename TO, int R, bool XS>
int launch_rows_xs(const void* x, const void* blocks, const int* units,
                   const int* cols, void* y, int B, int N, int GS, int S, int KB,
                   int BN, int nunits, int stage_tiles, int cluster,
                   int maxt, int per_sm, cudaStream_t st) {
  if (BN == 16)
    return launch_rows_ks<T, TO, R, 1, XS>(x, blocks, units, cols, y, B, N,
                                           GS, S, KB, BN, nunits,
                                           stage1_tiles<T>(), cluster, maxt,
                                           per_sm, st);
  return launch_rows_ks<T, TO, R, 0, XS>(x, blocks, units, cols, y, B, N, GS, S,
                                         KB, BN, nunits, stage_tiles, cluster,
                                         maxt, per_sm, st);
}

template <typename T, typename TO, int R>
int launch_rows_pass(const void* x, const void* blocks, const int* units,
                     const int* cols, void* y, int B, int N, int GS, int S, int KB,
                     int BN, int nunits, int stage_tiles, int cluster,
                     int maxt, int per_sm, cudaStream_t st) {
  const bool xs = rows_x_bytes<T>(min(R, B), N) <= RX_MAX;
  if constexpr (sizeof(T) == 2 && R == 8) {
    if (xs)
      return launch_rows_xs<T, TO, R, true>(x, blocks, units, cols, y, B, N,
                                            GS, S, KB, BN, nunits, stage_tiles,
                                            cluster, maxt, per_sm, st);
  }
  return launch_rows_xs<T, TO, R, false>(x, blocks, units, cols, y, B, N, GS, S,
                                         KB, BN, nunits, stage_tiles, cluster,
                                         maxt, per_sm, st);
}

// the passes the source instantiates (budget.BSR_MATMUL_ROWS_PASS_*)
template <typename T, typename TO>
int launch_rows(const void* x, const void* blocks, const int* units,
                const int* cols, void* y, int B, int N, int GS, int S, int KB,
                int BN, int nunits, int stage_tiles, int cluster, int maxt,
                int per_sm, int rows_pass, cudaStream_t st) {
  if (stage_tiles <= 0 || (stage_tiles * BN / 16) % RW != 0 ||
      cluster < 1 || cluster > RCLUSTER_MAX || nunits != GS * cluster ||
      maxt < 0 || per_sm < 0)
    return static_cast<int>(cudaErrorInvalidValue);
#define BSR_ROWS_PASS(R)                                                    \
  if (rows_pass == R)                                                       \
    return launch_rows_pass<T, TO, R>(x, blocks, units, cols, y, B, N, GS, \
                                      S, KB, BN, nunits, stage_tiles,       \
                                      cluster, maxt, per_sm, st);
  BSR_ROWS_PASS(8)
  BSR_ROWS_PASS(32)
  if constexpr (sizeof(T) == 2) {
    BSR_ROWS_PASS(16)
    BSR_ROWS_PASS(64)
  }
#undef BSR_ROWS_PASS
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename TO>
int launch_wgmma(const void* x, const void* blocks, const int* bc,
                 const int* nb, void* y, int B, int N, int GS, int S, int KB,
                 int BN, cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      bsr_matmul_wgmma<TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      WGMMA_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ngroups = (GS + GB - 1) / GB;
  const int nslabs = (B + GR - 1) / GR;
  bsr_matmul_wgmma<TO><<<nslabs * ngroups, NTH, WGMMA_SMEM, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(blocks), bc, nb,
      static_cast<TO*>(y), B, N, GS, S, KB, BN, ngroups);
  return static_cast<int>(cudaGetLastError());
}

template <typename TO>
int run(const void* x, const void* blocks, const int* bc, const int* nb,
        const int* units, const int* cols, void* y, int B, int N, int GS,
        int S, int KB, int BN, int nunits, int stage_tiles, int cluster, int maxt,
        int per_sm, int rows_pass, int dtype, int schedule, cudaStream_t st) {
  if (schedule == 0 && dtype == 0)
    return launch_rows<float, TO>(x, blocks, units, cols, y, B, N, GS, S, KB, BN,
                                  nunits, stage_tiles, cluster, maxt, per_sm,
                                  rows_pass, st);
  if (schedule == 0 && dtype == 1)
    return launch_rows<bf16, TO>(x, blocks, units, cols, y, B, N, GS, S, KB, BN,
                                 nunits, stage_tiles, cluster, maxt, per_sm,
                                 rows_pass, st);
  if (schedule == 1 && dtype == 1)
    return launch_wgmma<TO>(x, blocks, bc, nb, y, B, N, GS, S, KB, BN, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// units, cols, nunits, stage_tiles, cluster, maxt, per_sm and rows_pass
// are the rows schedule's (its work list and launch shape, kernel.py);
// the wgmma schedule reads blockcol and nblocks instead.
extern "C" int bsr_matmul(const void* x, const void* blocks,
                          const void* blockcol, const void* nblocks, void* y,
                          const void* units, const void* cols, int B, int N,
                          int GM, int KB, int BM, int BN, int nunits,
                          int stage_tiles, int cluster, int maxt, int per_sm,
                          int rows_pass, int dtype, int out_dtype,
                          int schedule, void* stream) {
  const int* bc = static_cast<const int*>(blockcol);
  const int* nb = static_cast<const int*>(nblocks);
  const int* un = static_cast<const int*>(units);
  const int* cl = static_cast<const int*>(cols);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BM <= 0 || BM % 16 != 0 || BN <= 0 || BN % 16 != 0 || N % BN != 0 ||
      B <= 0 || GM <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int S = BM / 16, GS = GM * S;  // sub-rows a block-row, in all
  if (out_dtype == 0)
    return run<float>(x, blocks, bc, nb, un, cl, y, B, N, GS, S, KB, BN, nunits,
                      stage_tiles, cluster, maxt, per_sm, rows_pass, dtype,
                      schedule, st);
  if (out_dtype == 1)
    return run<bf16>(x, blocks, bc, nb, un, cl, y, B, N, GS, S, KB, BN, nunits,
                     stage_tiles, cluster, maxt, per_sm, rows_pass, dtype,
                     schedule, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

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
// rounded once to the output's dtype (f32 or bf16).  Two schedules, picked
// by the launcher (kernel.py) from the row count and the dtype:
//
//   rows (SIMT, f32 or bf16 inputs) -- for few rows, as in decode (4 rows
//     on the serving path).  One block per (block-row i, 8 rows of x); its
//     4 warps split the kept tiles of row i between them (warp w takes
//     kb = w, w+4, ...).  A warp reads a whole tile at once, each lane 16
//     contiguous bytes of one tile row (a (16, 16) bf16 tile is 512
//     contiguous bytes: 32 lanes x 16 B), and the matching 8 columns of
//     each of its rows of x (L1/L2-resident: x is a few KB), and keeps one
//     f32 sum per row in registers.  Lanes of a tile row, then the 4 warps,
//     are reduced at the end (shuffles, then shared memory).  At decode the
//     work is 2*B*kept*BM*BN operations over the kept tiles' bytes, far
//     below the card's 295 operations per byte: the weight bytes bound it,
//     and stopping at nblocks[i] reads exactly the kept tiles.
//
//   wgmma (tensor cores, bf16 inputs only) -- for many rows, as in prefill
//     (B*T = 8192 rows).  The kept tiles' products are bound by the bf16
//     tensor cores (989 TFLOP/s on an H100 SXM) only if x, which every
//     block-row reads at its own scattered block columns, is not fetched
//     again for each tile: a tile is one 16-deep step of 16 outputs, so
//     its reuse has to come from the x columns the block-rows share.  One
//     block owns 128 rows of x and a group of GB = 16 block-rows (256
//     outputs); each of its two warpgroups accumulates 8 of the
//     block-rows for all 128 rows (two 64-row halves, 8 f32 registers a
//     thread for each block-row and half).  The block walks the columns of
//     x in chunks of CW = 128, filled by cp.async into two rings: per
//     chunk, x[rows, chunk] once for the whole group
//     (XSTAGES = 3 stages, two chunks ahead of the wgmmas), and every kept
//     tile of the group whose block column falls in the chunk (TSTAGES = 2
//     stages of a slot per block-row and 16-column block, one chunk
//     ahead).  blockcol ascends strictly within a row up to nblocks[i]
//     (bcsr_from_dense keeps the kept tiles in row-major order), so one
//     pointer a block-row walks its tiles in step with the chunks, and
//     padding tiles are never reached.  A bank out of order would lose
//     tiles silently (the walk stops short), a repeated column would
//     overwrite its twin's slot: the launcher (kernel.py) refuses both,
//     checked once per bank.  Each kept (16, 16) sub-tile is two
//     wgmma m64n16k16, one per 64-row half (x and the tile K-major in shared
//     memory, in 8 x 8 core matrices without a swizzle; the x sub-tile of
//     16-column block jj sits 2048 jj bytes into the chunk) into its
//     block-row's accumulator; a bitmask a block-row and stage says which
//     of the chunk's 8 sub-tile slots hold a tile.  Blocks run group-major
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
// multiple of BN (the wrapper pads), BN a multiple of 16 (wgmma: a divisor
// of CW = 128), BM 16 (the transformer's (16, 16) tiles).  x and the tiles
// must be 16-byte aligned (the wrapper checks).
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

constexpr int ROWS = 8;       // rows of x one `rows` block keeps in registers
constexpr int WARPS = 4;      // warps of a `rows` block, splitting the tiles

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

// Eight consecutive elements at a 16-byte aligned address, as floats.
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const bf16* p, float* v) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 -> f32 is exact: the high 16 bits
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T, typename TO, int BM>
__global__ void __launch_bounds__(WARPS * 32) bsr_matmul_rows(
    const T* __restrict__ x, const T* __restrict__ blocks,
    const int* __restrict__ blockcol, const int* __restrict__ nblocks,
    TO* __restrict__ y, int B, int N, int KB, int BN, int MO) {
  constexpr int LPR = 32 / BM;  // lanes per tile row
  __shared__ float part[WARPS][ROWS][BM];
  const int i = blockIdx.x;
  const int r0 = blockIdx.y * ROWS;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int ml = lane / LPR;
  const int sub = lane % LPR;
  const int nrows = min(ROWS, B - r0);
  const int chunks = BN / 8;
  const T* xr = x + static_cast<int64_t>(r0) * N;

  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;

  const int nb = nblocks[i];
  for (int kb = warp; kb < nb; kb += WARPS) {
    const int64_t t = static_cast<int64_t>(i) * KB + kb;
    const int col0 = blockcol[t] * BN;
    const T* tile = blocks + (t * BM + ml) * BN;
    for (int c = sub; c < chunks; c += LPR) {
      float w[8];
      load8(tile + c * 8, w);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r < nrows) {
          float xv[8];
          load8(xr + static_cast<int64_t>(r) * N + col0 + c * 8, xv);
          float s = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j) s = fmaf(w[j], xv[j], s);
          acc[r] += s;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1)
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
  }
  if (sub == 0) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) part[warp][r][ml] = acc[r];
  }
  __syncthreads();
  for (int o = threadIdx.x; o < ROWS * BM; o += blockDim.x) {
    const int r = o / BM;
    const int m = o % BM;
    if (r < nrows) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += part[w][r][m];
      store1(y + static_cast<int64_t>(r0 + r) * MO + i * BM + m, s);
    }
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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
// (c % 8) * 2; then TSTAGES tile stages of GB x CSUB sub-tile slots, slot
// (g, jj) holding block-row g's tile columns that fall on the chunk's
// 16-column block jj, element (m, k) at (k / 8) * 256 + m * 16 + (k % 8) *
// 2; then TSTAGES x GB masks, bit jj of mask (stage, g) set iff slot
// (g, jj) holds a tile.
template <typename TO>
__global__ void __launch_bounds__(NTH, MIN_BLOCKS) bsr_matmul_wgmma(
    const bf16* __restrict__ x, const bf16* __restrict__ blocks,
    const int* __restrict__ blockcol, const int* __restrict__ nblocks,
    TO* __restrict__ y, int B, int N, int GM, int KB, int BN, int ngroups) {
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
  const int MO = GM * 16;
  const int nchunks = (N + CW - 1) / CW;
  const int pieces = BN / 8;  // 16-byte pieces of a tile row

  // Warp w stages the tiles of block-rows w, w + NWARPS, ... of the group:
  // each keeps its row's pointer (the first tile not yet staged), its tile
  // count, and a window of 32 of its block columns, lane l holding
  // blockcol[i, wbase + l] (refilled when fewer than CSUB lie past ptr).
  constexpr int RPW = GB / NWARPS;  // block-rows a warp stages
  int ptr[RPW], nbr[RPW], wbase[RPW], wcol[RPW];
  auto window = [&](int i, int nb, int kb) {
    return kb < nb ? blockcol[static_cast<int64_t>(i) * KB + kb] : 0x7fffffff;
  };
#pragma unroll
  for (int e = 0; e < RPW; ++e) {
    const int i = i0 + warp + NWARPS * e;
    ptr[e] = 0;
    wbase[e] = 0;
    nbr[e] = i < GM ? nblocks[i] : 0;
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

  // The group's kept tiles whose block columns fall in chunk c: for each
  // block-row, the run of its tiles from its pointer on.  One cp.async
  // group; the masks are plain stores.
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
        if (i < GM) {
          if (ptr[e] + CSUB > wbase[e] + 32) {
            wbase[e] = ptr[e];
            wcol[e] = window(i, nbr[e], wbase[e] + lane);
          }
          const int off = ptr[e] - wbase[e];
          const long long cb = static_cast<long long>(wcol[e]) * BN;
          // the leading tiles from the pointer on whose block columns fall
          // in the chunk (past nblocks the window holds no column)
          const bool in = lane >= off && cb >= col0 && cb < col0 + CW;
          const unsigned long long run =
              ~(static_cast<unsigned long long>(
                    __ballot_sync(0xffffffffu, in)) >> off);
          const int n = __ffsll(run) - 1;
          for (int t = 0; t < n; ++t) {
            const int jj0 =
                (__shfl_sync(0xffffffffu, wcol[e], off + t) * BN - col0) / 16;
            mask |= ((1u << (BN / 16)) - 1) << jj0;
            const bf16* tile =
                blocks + (static_cast<int64_t>(i) * KB + ptr[e] + t) * 16 * BN;
            for (int q = lane; q < 16 * pieces; q += 32) {
              const int m = q / pieces;
              const int c8 = q % pieces;
              cp_async16(sbase + (g * CSUB + jj0 + c8 / 2) * SLOT +
                             (c8 % 2) * 256 + m * 16,
                         tile + m * BN + c8 * 8, 16);
            }
          }
          ptr[e] += n;
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
    if (i >= GM) continue;
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

template <typename T, typename TO>
int launch_rows(const void* x, const void* blocks, const int* bc,
                const int* nb, void* y, int B, int N, int GM, int KB, int BN,
                cudaStream_t st) {
  const dim3 grid(GM, (B + ROWS - 1) / ROWS);
  bsr_matmul_rows<T, TO, 16><<<grid, WARPS * 32, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(blocks), bc, nb,
      static_cast<TO*>(y), B, N, KB, BN, GM * 16);
  return static_cast<int>(cudaGetLastError());
}

template <typename TO>
int launch_wgmma(const void* x, const void* blocks, const int* bc,
                 const int* nb, void* y, int B, int N, int GM, int KB,
                 int BN, cudaStream_t st) {
  if (CW % BN != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      bsr_matmul_wgmma<TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      WGMMA_SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ngroups = (GM + GB - 1) / GB;
  const int nslabs = (B + GR - 1) / GR;
  bsr_matmul_wgmma<TO><<<nslabs * ngroups, NTH, WGMMA_SMEM, st>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(blocks), bc, nb,
      static_cast<TO*>(y), B, N, GM, KB, BN, ngroups);
  return static_cast<int>(cudaGetLastError());
}

template <typename TO>
int run(const void* x, const void* blocks, const int* bc, const int* nb,
        void* y, int B, int N, int GM, int KB, int BN, int dtype,
        int schedule, cudaStream_t st) {
  if (schedule == 0 && dtype == 0)
    return launch_rows<float, TO>(x, blocks, bc, nb, y, B, N, GM, KB, BN, st);
  if (schedule == 0 && dtype == 1)
    return launch_rows<bf16, TO>(x, blocks, bc, nb, y, B, N, GM, KB, BN, st);
  if (schedule == 1 && dtype == 1)
    return launch_wgmma<TO>(x, blocks, bc, nb, y, B, N, GM, KB, BN, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int bsr_matmul(const void* x, const void* blocks,
                          const void* blockcol, const void* nblocks, void* y,
                          int B, int N, int GM, int KB, int BM, int BN,
                          int dtype, int out_dtype, int schedule,
                          void* stream) {
  const int* bc = static_cast<const int*>(blockcol);
  const int* nb = static_cast<const int*>(nblocks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BM != 16 || BN % 16 != 0 || N % BN != 0 || B <= 0 || GM <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (out_dtype == 0)
    return run<float>(x, blocks, bc, nb, y, B, N, GM, KB, BN, dtype,
                      schedule, st);
  if (out_dtype == 1)
    return run<bf16>(x, blocks, bc, nb, y, B, N, GM, KB, BN, dtype, schedule,
                     st);
  return static_cast<int>(cudaErrorInvalidValue);
}

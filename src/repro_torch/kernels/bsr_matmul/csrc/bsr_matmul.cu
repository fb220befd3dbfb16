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
// Two schedules, picked by the launcher (kernel.py) from the row count:
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
//   mma (tensor cores, bf16 inputs only) -- for many rows, as in prefill
//     (B*T = 8192 rows).  One warp per (64 rows of x, block-row i), 4 warps
//     a block on the same block-row (their tiles are shared through L1).
//     For each kept tile and each 16-wide k step the warp loads the A
//     fragments (x, 4 x m16k16) and B fragments (the tile is W's rows,
//     which is B = W^T in "col" layout) straight from device memory into
//     registers and issues mma.sync.m16n8k16.bf16 with f32 accumulators
//     (64 x BM sums per warp).  Prefill is bound by operations (bf16 tensor
//     cores, 989 TFLOP/s on an H100 SXM); this first design stages nothing
//     in shared memory and keeps no loads in flight across tiles, so it
//     runs well below that.  wgmma with TMA-staged tiles is later work.
//
// Rows past B are bounds-tested (no padding of x is needed); N must be a
// multiple of BN (the wrapper pads), BN a multiple of 16, BM 16 (the
// transformer's (16, 16) tiles).  Inputs of x and the tiles must be 16-byte aligned (the wrapper
// checks).
//
// C interface (ctypes): pointers and the stream are void*, sizes are int;
// dtype 0 = f32, 1 = bf16; schedule 0 = rows, 1 = mma.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// combination no kernel takes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 8;       // rows of x one `rows` block keeps in registers
constexpr int WARPS = 4;      // warps of a `rows` block, splitting the tiles
constexpr int MMA_WARPS = 4;  // warps of an `mma` block
constexpr int MT = 4;         // m16 tiles per `mma` warp: 64 rows

// Eight consecutive elements at a 16-byte aligned address, as floats.
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 a = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // bf16 -> f32 is exact: the high 16 bits
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T, int BM>
__global__ void __launch_bounds__(WARPS * 32) bsr_matmul_rows(
    const T* __restrict__ x, const T* __restrict__ blocks,
    const int* __restrict__ blockcol, const int* __restrict__ nblocks,
    float* __restrict__ y, int B, int N, int KB, int BN, int MO) {
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
      y[static_cast<int64_t>(r0 + r) * MO + i * BM + m] = s;
    }
  }
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators.
__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <int BM>
__global__ void __launch_bounds__(MMA_WARPS * 32) bsr_matmul_mma(
    const __nv_bfloat16* __restrict__ x,
    const __nv_bfloat16* __restrict__ blocks,
    const int* __restrict__ blockcol, const int* __restrict__ nblocks,
    float* __restrict__ y, int B, int N, int KB, int BN, int MO) {
  constexpr int NT = BM / 8;  // n8 tiles of the block-row's outputs
  const int i = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row (A, C) / column (B)
  const int q = lane & 3;   // fragment column pair
  const int row0 = (blockIdx.x * MMA_WARPS + warp) * (MT * 16);
  if (row0 >= B) return;

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int nb = nblocks[i];
  for (int kb = 0; kb < nb; ++kb) {
    const int64_t t = static_cast<int64_t>(i) * KB + kb;
    const int col0 = blockcol[t] * BN;
    const __nv_bfloat16* tile = blocks + t * BM * BN;
    for (int ks = 0; ks < BN; ks += 16) {
      uint32_t bf[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* tp = tile + (nt * 8 + g) * BN + ks + q * 2;
        bf[nt][0] = ld32(tp);
        bf[nt][1] = ld32(tp + 8);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int ra = row0 + mt * 16 + g;
        const int rb = ra + 8;
        const __nv_bfloat16* xa =
            x + static_cast<int64_t>(ra) * N + col0 + ks + q * 2;
        const __nv_bfloat16* xb = xa + static_cast<int64_t>(8) * N;
        const uint32_t a0 = ra < B ? ld32(xa) : 0u;
        const uint32_t a1 = rb < B ? ld32(xb) : 0u;
        const uint32_t a2 = ra < B ? ld32(xa + 8) : 0u;
        const uint32_t a3 = rb < B ? ld32(xb + 8) : 0u;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_bf16(acc[mt][nt], a0, a1, a2, a3, bf[nt][0], bf[nt][1]);
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int ra = row0 + mt * 16 + g;
    const int rb = ra + 8;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = i * BM + nt * 8 + q * 2;
      if (ra < B)
        *reinterpret_cast<float2*>(y + static_cast<int64_t>(ra) * MO + col) =
            make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      if (rb < B)
        *reinterpret_cast<float2*>(y + static_cast<int64_t>(rb) * MO + col) =
            make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
}

template <typename T, int BM>
int launch_rows(const void* x, const void* blocks, const int* bc,
                const int* nb, float* y, int B, int N, int GM, int KB, int BN,
                cudaStream_t st) {
  const dim3 grid(GM, (B + ROWS - 1) / ROWS);
  bsr_matmul_rows<T, BM><<<grid, WARPS * 32, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(blocks), bc, nb, y, B,
      N, KB, BN, GM * BM);
  return static_cast<int>(cudaGetLastError());
}

template <int BM>
int launch_mma(const void* x, const void* blocks, const int* bc,
               const int* nb, float* y, int B, int N, int GM, int KB, int BN,
               cudaStream_t st) {
  const int rows_per_block = MMA_WARPS * MT * 16;
  const dim3 grid((B + rows_per_block - 1) / rows_per_block, GM);
  bsr_matmul_mma<BM><<<grid, MMA_WARPS * 32, 0, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(blocks), bc, nb, y, B, N, KB, BN,
      GM * BM);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bsr_matmul(const void* x, const void* blocks,
                          const void* blockcol, const void* nblocks, void* y,
                          int B, int N, int GM, int KB, int BM, int BN,
                          int dtype, int schedule, void* stream) {
  const int* bc = static_cast<const int*>(blockcol);
  const int* nb = static_cast<const int*>(nblocks);
  float* out = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (BM != 16 || BN % 16 != 0 || N % BN != 0 || B <= 0 || GM <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (schedule == 0 && dtype == 0)
    return launch_rows<float, 16>(x, blocks, bc, nb, out, B, N, GM, KB, BN,
                                  st);
  if (schedule == 0 && dtype == 1)
    return launch_rows<__nv_bfloat16, 16>(x, blocks, bc, nb, out, B, N, GM,
                                          KB, BN, st);
  if (schedule == 1 && dtype == 1)
    return launch_mma<16>(x, blocks, bc, nb, out, B, N, GM, KB, BN, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

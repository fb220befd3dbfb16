// Block-sparse (BCSR) direct convolution with a fused epilogue, for Hopper
// (sm_90a).
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
// Rows past M (channel padding to gbm*BM) are zero too; the caller slices
// them off.
//
// Mapping:
//   * One block per (image n, block-row i, TP output pixels), one thread per
//     pixel, flat over (e, f) so a warp's input reads coalesce.
//   * For each kept tile the block loads the (BM, BN) weight tile into shared
//     memory and decodes the tile's BN columns once into input offsets
//     (c*Hp + r)*Wp + s.  Each thread then gathers its pixel's column of the
//     (BN, TP) im2col patch straight from xpad by those offsets, one value at
//     a time, and multiplies it into its BM sums (weights read from shared
//     memory as broadcasts).  No patch is materialised in device memory.
//   * The sums stay in registers; bias, residual and ReLU are applied and
//     the output is written once.
//
// Bound on an H100 SXM: the work is 2*kept_tiles*BM*BN*N*E*F f32 operations
// over xpad + tiles + out bytes; at the main path's shapes the operations
// bound (67 TFLOP/s without tensor cores) is the larger.  Each gathered input
// value now feeds BM multiply-adds, so the kernel issues one load per BM
// FMAs instead of one per FMA as the ELL kernel does; it runs on the FMA
// units, not the tensor cores.  Tensor cores (wgmma on staged patch tiles)
// are later work.
//
// C interface (ctypes): pointers and the stream are void*, sizes are int,
// residual may be null; returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int BM>
__global__ void __launch_bounds__(256) bsr_conv_kernel(
    const float* __restrict__ xpad, const float* __restrict__ blocks,
    const int* __restrict__ blockcol, const int* __restrict__ nblocks,
    const float* __restrict__ bias, const float* __restrict__ residual,
    float* __restrict__ out, int C, int Hp, int Wp, int KB, int BN, int RS,
    int S, int E, int F, int stride, int relu) {
  extern __shared__ int4 smem_raw[];
  float* s_w = reinterpret_cast<float*>(smem_raw);  // [BM][BN]
  int* s_off = reinterpret_cast<int*>(s_w + BM * BN);  // [BN]

  const int n = blockIdx.z;
  const int i = blockIdx.y;
  const int Mp = gridDim.y * BM;
  const int EF = E * F;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = p < EF;
  const int e = live ? p / F : 0;
  const int f = live ? p - e * F : 0;
  const float* xin = xpad + static_cast<int64_t>(n) * C * Hp * Wp +
                     static_cast<int64_t>(e) * stride * Wp +
                     static_cast<int64_t>(f) * stride;

  float acc[BM];
#pragma unroll
  for (int ml = 0; ml < BM; ++ml) acc[ml] = 0.f;

  const int nb = nblocks[i];
  for (int kb = 0; kb < nb; ++kb) {
    __syncthreads();  // the previous tile has been consumed
    const float* tile = blocks + (static_cast<int64_t>(i) * KB + kb) * BM * BN;
    for (int t = threadIdx.x; t < BM * BN; t += blockDim.x) s_w[t] = tile[t];
    const int j0 = blockcol[static_cast<int64_t>(i) * KB + kb] * BN;
    for (int jl = threadIdx.x; jl < BN; jl += blockDim.x) {
      const int j = j0 + jl;
      const int cj = j / RS;
      const int rem = j - cj * RS;
      const int r = rem / S;
      const int s = rem - r * S;
      s_off[jl] = (min(cj, C - 1) * Hp + r) * Wp + s;
    }
    __syncthreads();
    if (live) {
      for (int jl = 0; jl < BN; ++jl) {
        const float xv = __ldg(xin + s_off[jl]);
#pragma unroll
        for (int ml = 0; ml < BM; ++ml) {
          acc[ml] = fmaf(s_w[ml * BN + jl], xv, acc[ml]);
        }
      }
    }
  }

  if (!live) return;
#pragma unroll
  for (int ml = 0; ml < BM; ++ml) {
    const int m = i * BM + ml;
    const int64_t o = (static_cast<int64_t>(n) * Mp + m) * EF + p;
    float v = acc[ml] + bias[m];
    if (residual != nullptr) v += residual[o];
    if (relu) v = fmaxf(v, 0.f);
    out[o] = v;
  }
}

template <int BM>
int launch(const float* xpad, const float* blocks, const int* blockcol,
           const int* nblocks, const float* bias, const float* residual,
           float* out, int N, int C, int Hp, int Wp, int GBM, int KB, int BN,
           int RS, int S, int E, int F, int stride, int tp, int relu,
           cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(BM) * BN * 4 + BN * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        bsr_conv_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((E * F + tp - 1) / tp, GBM, N);
  bsr_conv_kernel<BM><<<grid, tp, smem, stream>>>(
      xpad, blocks, blockcol, nblocks, bias, residual, out, C, Hp, Wp, KB, BN,
      RS, S, E, F, stride, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bsr_conv_f32(const void* xpad, const void* blocks,
                            const void* blockcol, const void* nblocks,
                            const void* bias, const void* residual, void* out,
                            int N, int C, int Hp, int Wp, int GBM, int KB,
                            int BM, int BN, int RS, int S, int E, int F,
                            int stride, int tp, int relu, void* stream) {
  const float* x = static_cast<const float*>(xpad);
  const float* w = static_cast<const float*>(blocks);
  const int* bc = static_cast<const int*>(blockcol);
  const int* nb = static_cast<const int*>(nblocks);
  const float* b = static_cast<const float*>(bias);
  const float* res = static_cast<const float*>(residual);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (BM) {
    case 8:
      return launch<8>(x, w, bc, nb, b, res, o, N, C, Hp, Wp, GBM, KB, BN, RS,
                       S, E, F, stride, tp, relu, st);
    case 16:
      return launch<16>(x, w, bc, nb, b, res, o, N, C, Hp, Wp, GBM, KB, BN,
                        RS, S, E, F, stride, tp, relu, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

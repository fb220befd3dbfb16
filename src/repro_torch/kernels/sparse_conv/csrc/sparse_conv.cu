// Direct sparse convolution over an ELL filter bank (the paper's Algorithm 2)
// with a fused epilogue, for Hopper (sm_90a).
//
// Replaces the TPU kernel sparse_conv_pallas / _kernel in
// src/repro/kernels/sparse_conv/kernel.py.  Computes, in f32,
//
//   out[n,m,e,f] = relu?( sum_{k < nnz[m]} value[m,k] * xpad[n, c, e*st + r, f*st + s]
//                         + bias[m] + residual?[n,m,e,f] )
//
// with (c, r, s) decoded from packed[m,k] = c*RS + r*S + s.
//
// Mapping: the paper's own GPU mapping (Section 3.2).
//   * One block per (image n, TM output channels, TP output pixels).
//   * The block stages its rows' nonzeros in shared memory ("CSR in shared
//     memory"), slab by slab of KS entries, so any K fits (K reaches 1504 on
//     ResNet-50 res5 3x3).  While staging it decodes each packed index into the
//     stretched offset (c*Hp + r)*Wp + s of the padded image: the paper's weight
//     stretching, done once per nonzero per block instead of per thread.
//   * One thread per output pixel, flat over (e, f): neighbouring threads take
//     neighbouring f, so the input reads of a warp coalesce (the paper's warp
//     over w).
//   * Each row's loop stops at nnz[m]; padding entries are never read.
//   * The sums stay in registers; bias, residual and ReLU are applied to them
//     and the output is written once.
//
// Bound on an H100 SXM: the work is 2*nnz*N*E*F f32 operations over
// xpad + values + indices + out bytes; at the main path's shapes the
// operations bound (67 TFLOP/s without tensor cores) is the larger.  This
// kernel does not reach it: every multiply-add needs its own 4-byte load of
// the input (from L1/L2), so it is bound by load issue.  The design keeps
// those loads coalesced and cached and takes the index decode out of the
// inner loop; register tiling over pixels and reuse of a staged input slab
// are later work.
//
// The multiply and the add are rounded separately (__fmul_rn, __fadd_rn), in
// nonzero order, so each sum is formed exactly as the plain PyTorch version
// (ref.py) forms it.  That costs two FP instructions per nonzero where one
// fmaf would do, so the kernel could reach at most half the FMA peak its
// bound assumes; it sits far further than 2x above that bound, held back by
// the loads (PERF.md, Open questions).
//
// C interface (ctypes): pointers and the stream are void*, sizes are int,
// residual may be null; returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int TM>
__global__ void __launch_bounds__(256) sparse_conv_kernel(
    const float* __restrict__ xpad, const float* __restrict__ value,
    const int* __restrict__ packed, const int* __restrict__ nnz,
    const float* __restrict__ bias, const float* __restrict__ residual,
    float* __restrict__ out, int C, int Hp, int Wp, int M, int K, int RS,
    int S, int E, int F, int stride, int ks, int relu) {
  extern __shared__ int4 smem_raw[];
  int* s_off = reinterpret_cast<int*>(smem_raw);  // [TM][ks]
  float* s_val = reinterpret_cast<float*>(s_off + TM * ks);  // [TM][ks]
  int* s_nnz = reinterpret_cast<int*>(s_val + TM * ks);  // [TM]

  const int n = blockIdx.z;
  const int m0 = blockIdx.y * TM;
  const int EF = E * F;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = p < EF;
  const int e = live ? p / F : 0;
  const int f = live ? p - e * F : 0;
  const float* xin = xpad + static_cast<int64_t>(n) * C * Hp * Wp +
                     static_cast<int64_t>(e) * stride * Wp +
                     static_cast<int64_t>(f) * stride;

  for (int t = threadIdx.x; t < TM; t += blockDim.x) {
    const int m = m0 + t;
    s_nnz[t] = m < M ? nnz[m] : 0;
  }
  __syncthreads();
  int kmax = 0;
#pragma unroll
  for (int ml = 0; ml < TM; ++ml) kmax = max(kmax, s_nnz[ml]);

  float acc[TM];
#pragma unroll
  for (int ml = 0; ml < TM; ++ml) acc[ml] = 0.f;

  for (int k0 = 0; k0 < kmax; k0 += ks) {
    const int kn = min(ks, kmax - k0);
    __syncthreads();  // the previous slab has been consumed
    for (int t = threadIdx.x; t < TM * kn; t += blockDim.x) {
      const int ml = t / kn;
      const int kk = t - ml * kn;
      const int m = m0 + ml;
      int off = 0;
      float v = 0.f;
      if (m < M && k0 + kk < s_nnz[ml]) {
        const int64_t g = static_cast<int64_t>(m) * K + k0 + kk;
        const int pk = packed[g];
        const int c = pk / RS;
        const int rem = pk - c * RS;
        const int r = rem / S;
        const int s = rem - r * S;
        off = (c * Hp + r) * Wp + s;
        v = value[g];
      }
      s_off[ml * ks + kk] = off;
      s_val[ml * ks + kk] = v;
    }
    __syncthreads();
    if (live) {
#pragma unroll
      for (int ml = 0; ml < TM; ++ml) {
        const int kend = min(kn, s_nnz[ml] - k0);
        const int* so = s_off + ml * ks;
        const float* sv = s_val + ml * ks;
        float a = acc[ml];
        for (int kk = 0; kk < kend; ++kk) {
          a = __fadd_rn(a, __fmul_rn(sv[kk], __ldg(xin + so[kk])));
        }
        acc[ml] = a;
      }
    }
  }

  if (!live) return;
#pragma unroll
  for (int ml = 0; ml < TM; ++ml) {
    const int m = m0 + ml;
    if (m >= M) break;
    const int64_t o = (static_cast<int64_t>(n) * M + m) * EF + p;
    float v = __fadd_rn(acc[ml], bias[m]);
    if (residual != nullptr) v = __fadd_rn(v, residual[o]);
    if (relu) v = fmaxf(v, 0.f);
    out[o] = v;
  }
}

template <int TM>
int launch(const float* xpad, const float* value, const int* packed,
           const int* nnz, const float* bias, const float* residual,
           float* out, int N, int C, int Hp, int Wp, int M, int K, int RS,
           int S, int E, int F, int stride, int tp, int ks, int relu,
           cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(TM) * ks * 8 + TM * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sparse_conv_kernel<TM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((E * F + tp - 1) / tp, (M + TM - 1) / TM, N);
  sparse_conv_kernel<TM><<<grid, tp, smem, stream>>>(
      xpad, value, packed, nnz, bias, residual, out, C, Hp, Wp, M, K, RS, S,
      E, F, stride, ks, relu);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sparse_conv_f32(const void* xpad, const void* value,
                               const void* packed, const void* nnz,
                               const void* bias, const void* residual,
                               void* out, int N, int C, int Hp, int Wp, int M,
                               int K, int RS, int S, int E, int F, int stride,
                               int tm, int tp, int ks, int relu,
                               void* stream) {
  const float* x = static_cast<const float*>(xpad);
  const float* v = static_cast<const float*>(value);
  const int* pk = static_cast<const int*>(packed);
  const int* nz = static_cast<const int*>(nnz);
  const float* b = static_cast<const float*>(bias);
  const float* res = static_cast<const float*>(residual);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tm) {
    case 8:
      return launch<8>(x, v, pk, nz, b, res, o, N, C, Hp, Wp, M, K, RS, S, E,
                       F, stride, tp, ks, relu, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

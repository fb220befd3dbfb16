// Flash-attention forward (causal or full, GQA) with online softmax, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel _fwd_call / _fwd_kernel in
// src/repro/kernels/flash_attention/kernel.py.  For q (B, H, T, D) and k, v
// (B, KV, S, D), query head h reads kv head h / (H / KV) (K and V are never
// expanded).  In f32, as the reference:
//
//   s   = (q * sc) k^T,  masked to -1e30 where qpos < kpos when causal
//   m, l, acc by online softmax over kv chunks, then l = max(l, 1e-30)
//   O   = acc / l cast to q's dtype,  lse = m + log(l) in f32
//
// Mapping: one block per (b, h, 64-row q chunk), 256 threads as a 16 x 16
// grid (ty, tx).  The q chunk is scaled by sc in f32 and kept in shared
// memory; the block walks kv chunks of 32 rows, stopping at the causal
// diagonal (chunks wholly past the last query row of the block are never
// read).  Per chunk: K and V go to shared memory in f32; each thread
// computes s for its 4 query rows (ty*4..+3) and 2 keys (tx, tx+16); the
// row max and row sum reduce over the 16 lanes of a row group with
// shuffles; p goes to shared memory, and each thread updates its 4 rows x
// D/16 columns of acc (tx + 16*j) in registers.  Rows past T and keys past S
// are bounds-tested (keys past S get -inf, so they weigh 0 whatever the
// row holds), so T and S need not be multiples of the chunks.
//
// Bound on an H100 SXM: at prefill (B 4, H 32, T = S = 2048, D 128, causal)
// the work is ~2*B*H*T*S/2*D operations for q k^T and as many for p v,
// against a few hundred MB of q, k, v and O: operations bound it.  This
// first design runs both products on the FMA units in f32 (67 TFLOP/s),
// reading each operand from shared memory; tensor cores (mma / wgmma on
// bf16 q, k and on p, v) are later work.
//
// Dynamic shared memory: (64 + 32) rows x (D + 1) f32 for q and k, 32 x D
// for v and 64 x 33 for p: 74 KB at D = 128, so the launch opts in above
// 48 KB with cudaFuncSetAttribute.
//
// C interface (ctypes): pointers and the stream are void*, sizes are int,
// strides (in elements, for the b, h and t axes; the d axis is contiguous)
// are long long, sc is float; dtype 0 = f32, 1 = bf16.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a head
// dimension no instantiation takes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 32;   // keys per kv chunk
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as astype(bf16)
}

struct Strides {
  long long b, h, t;
};

constexpr size_t smem_bytes(int d) {
  return sizeof(float) *
         (static_cast<size_t>(BQ) * (d + 1) + static_cast<size_t>(BK) * (d + 1) +
          static_cast<size_t>(BK) * d + static_cast<size_t>(BQ) * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int H, int KV, int Tq, int S,
    Strides qs, Strides ks, Strides vs, Strides os, float sc, int causal) {
  constexpr int DJ = D / 16;  // acc columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                    // [BQ][D + 1]
  float* Ks = Qs + BQ * (D + 1);       // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);       // [BK][D]
  float* Ps = Vs + BK * D;             // [BQ][BK + 1]

  const int qi = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int q0 = qi * BQ;

  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D;
    const int c = idx % D;
    const int t = q0 + r;
    Qs[r * (D + 1) + c] = t < Tq ? to_f32(qb[t * qs.t + c]) * sc : 0.f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int kv_end = causal ? min(S, q0 + BQ) : S;
  for (int kv0 = 0; kv0 < kv_end; kv0 += BK) {
    __syncthreads();  // the previous chunk's K, V, P are consumed
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int r = idx / D;
      const int c = idx % D;
      const int s = kv0 + r;
      const bool in = s < S;
      Ks[r * (D + 1) + c] = in ? to_f32(kb[s * ks.t + c]) : 0.f;
      Vs[r * D + c] = in ? to_f32(vb[s * vs.t + c]) : 0.f;
    }
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float k0 = Ks[tx * (D + 1) + d];
      const float k1 = Ks[(tx + 16) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qv = Qs[(ty * 4 + i) * (D + 1) + d];
        s[i][0] = fmaf(qv, k0, s[i][0]);
        s[i][1] = fmaf(qv, k1, s[i][1]);
      }
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = kv0 + tx + 16 * j;
        if (kpos >= S)
          s[i][j] = -INFINITY;
        else if (causal && qpos < kpos)
          s[i][j] = NEG_INF;
      }
      float mx = fmaxf(s[i][0], s[i][1]);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - m_new);
      const float p0 = expf(s[i][0] - m_new);
      const float p1 = expf(s[i][1] - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha[i] + sum;
      m[i] = m_new;
      Ps[(ty * 4 + i) * (BK + 1) + tx] = p0;
      Ps[(ty * 4 + i) * (BK + 1) + tx + 16] = p1;
    }
    __syncwarp();  // a row's p is written by the 16 lanes of its warp

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha[i];
    for (int kc = 0; kc < BK; ++kc) {
      float vv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[kc * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(ty * 4 + i) * (BK + 1) + kc];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    if (t >= Tq) continue;
    const float li = fmaxf(l[i], 1e-30f);
    T* orow = o + b * os.b + h * os.h + t * os.t;
#pragma unroll
    for (int j = 0; j < DJ; ++j) orow[tx + 16 * j] = from_f32<T>(acc[i][j] / li);
    if (tx == 0)
      lse[(static_cast<int64_t>(b) * H + h) * Tq + t] = m[i] + logf(li);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int KV, int Tq, int S, Strides qs, Strides ks,
           Strides vs, Strides os, float sc, int causal, cudaStream_t st) {
  const size_t smem = smem_bytes(D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((Tq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, KV, Tq, S, qs, ks,
      vs, os, sc, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             float* lse, int B, int H, int KV, int Tq, int S, int D,
             Strides qs, Strides ks, Strides vs, Strides os, float sc,
             int causal, cudaStream_t st) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, lse, B, H, KV, Tq, S, qs, ks, vs, os,
                           sc, causal, st);
    case 32:
      return launch<T, 32>(q, k, v, o, lse, B, H, KV, Tq, S, qs, ks, vs, os,
                           sc, causal, st);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, B, H, KV, Tq, S, qs, ks, vs, os,
                           sc, causal, st);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, B, H, KV, Tq, S, qs, ks, vs, os,
                            sc, causal, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int H, int KV, int Tq, int S, int D, long long q_sb, long long q_sh,
    long long q_st, long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st, long long o_sb,
    long long o_sh, long long o_st, float sc, int causal, int dtype,
    void* stream) {
  if (B <= 0 || H <= 0 || KV <= 0 || H % KV != 0 || Tq <= 0 || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides qs{q_sb, q_sh, q_st}, ks{k_sb, k_sh, k_st},
      vs{v_sb, v_sh, v_st}, os{o_sb, o_sh, o_st};
  float* l = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, l, B, H, KV, Tq, S, D, qs, ks, vs, os,
                           sc, causal, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, l, B, H, KV, Tq, S, D, qs, ks,
                                   vs, os, sc, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

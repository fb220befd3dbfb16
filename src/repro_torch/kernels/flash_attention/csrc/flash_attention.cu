// Flash attention for Hopper (sm_90a): the forward (causal or full, GQA)
// with online softmax, and the two backward kernels, dQ and dK/dV.
//
// Forward.  Replaces the TPU kernel _fwd_call / _fwd_kernel in
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
// Backward.  Replaces _bwd_call's two pallas_calls: _dq_kernel and
// _dkv_kernel.  The recompute formulation, in f32, with lse from the
// forward and delta = rowsum(dO * O) computed by the caller:
//
//   p  = exp((q * sc) k^T - lse)   (the same mask; keys past S weigh 0)
//   dp = dO v^T,  ds = p * (dp - delta)
//   dQ = ds k * sc,  dK = ds^T q * sc,  dV = p^T dO
//
// dQ: one block per (b, h, 64 query rows), the forward's mapping.  The
// block stages its q (scaled), dO, lse and delta rows, walks 32-key chunks
// of K and V up to the causal diagonal, computes s, dp and ds for its
// 4 rows x 2 keys a thread, writes ds to shared memory and adds ds k to
// its 4 rows x D/16 columns of dQ in registers.
// dK/dV: one block per (b, kv head, 32 keys).  K and V stay in shared
// memory; the block walks the G query heads of its kv head and, inside
// each, the 64-row q chunks from the first that sees its keys (k0 / 64
// when causal).  Per chunk it stages q, dO, lse and delta, computes p and
// ds as above (rows past T weigh 0), and each thread adds p^T dO and
// ds^T q to its 2 keys x D/16 columns.  The group's sums stay in the block:
// no atomics, the same order on every run, as the reference's head_body.
//
// Bound on an H100 SXM: at prefill (B 4, H 32, T = S = 2048, D 128, causal)
// the work is ~2*B*H*T*S/2*D operations for q k^T and as many for p v,
// against a few hundred MB of q, k, v and O: operations bound it.  The
// backward does three such products for dQ and four for dK/dV against the
// same few hundred MB: operations again.  This first design runs every
// product on the FMA units in f32 (67 TFLOP/s), reading each operand from
// shared memory; tensor cores (mma / wgmma on bf16 operands) are later
// work.
//
// Dynamic shared memory, rows padded by one word (no bank conflicts on the
// column walk): forward (64 + 32) x (D + 1) f32 for q and k, 32 x D for v
// and 64 x 33 for p: 74 KB at D = 128; dQ 2 x 64 x (D + 1) for q and dO,
// 2 x 32 x (D + 1) for k and v, 64 x 33 for ds, 2 x 64 for lse and delta:
// 106 KB; dK/dV the same plus 64 x 33 for p: 114 KB.  Each launch opts in
// above 48 KB with cudaFuncSetAttribute.
//
// C interface (ctypes): pointers and the stream are void*, sizes are int,
// strides (in elements, for the b, h and t axes; the d axis is contiguous)
// are long long, sc is float; dtype 0 = f32, 1 = bf16 (every q-, k-, v-
// and dO-shaped operand has it; lse and delta are f32, contiguous
// (B, H, T)).  Each returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a head dimension no instantiation takes.

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

constexpr size_t dq_smem_bytes(int d) {
  return sizeof(float) *
         (2 * static_cast<size_t>(BQ) * (d + 1) +
          2 * static_cast<size_t>(BK) * (d + 1) +
          static_cast<size_t>(BQ) * (BK + 1) + 2 * static_cast<size_t>(BQ));
}

constexpr size_t dkv_smem_bytes(int d) {
  return dq_smem_bytes(d) + sizeof(float) * static_cast<size_t>(BQ) * (BK + 1);
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


// Stages rows [r0, r0 + n) of a (T, D) slab with row stride st into
// dst[n][D + 1] as f32 times ``scale``, zero past ``rows``.
template <typename T, int D, int N>
__device__ __forceinline__ void stage_rows(float* dst, const T* src,
                                           long long st, int r0, int rows,
                                           float scale) {
  for (int idx = threadIdx.x; idx < N * D; idx += THREADS) {
    const int r = idx / D;
    const int c = idx % D;
    const int t = r0 + r;
    dst[r * (D + 1) + c] = t < rows ? to_f32(src[t * st + c]) * scale : 0.f;
  }
}

// s = (q * sc) k^T and dp = dO v^T for a thread's 4 rows (ty*4 + i) and
// 2 keys (tx, tx + 16) of a (64 x 32) tile; Qs holds q already scaled when
// qscale is 1, or unscaled q with qscale = sc.
template <int D>
__device__ __forceinline__ void scores(const float* Qs, const float* dOs,
                                       const float* Ks, const float* Vs,
                                       int ty, int tx, float qscale,
                                       float (&s)[4][2], float (&dp)[4][2]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.f;
  for (int d = 0; d < D; ++d) {
    const float k0 = Ks[tx * (D + 1) + d];
    const float k1 = Ks[(tx + 16) * (D + 1) + d];
    const float v0 = Vs[tx * (D + 1) + d];
    const float v1 = Vs[(tx + 16) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float qv = Qs[(ty * 4 + i) * (D + 1) + d] * qscale;
      const float ov = dOs[(ty * 4 + i) * (D + 1) + d];
      s[i][0] = fmaf(qv, k0, s[i][0]);
      s[i][1] = fmaf(qv, k1, s[i][1]);
      dp[i][0] = fmaf(ov, v0, dp[i][0]);
      dp[i][1] = fmaf(ov, v1, dp[i][1]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int H, int KV,
    int Tq, int S, Strides qs, Strides ks, Strides vs, Strides dos,
    Strides dqs, float sc, int causal) {
  constexpr int DJ = D / 16;  // dQ columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                    // [BQ][D + 1], q * sc
  float* dOs = Qs + BQ * (D + 1);      // [BQ][D + 1]
  float* Ks = dOs + BQ * (D + 1);      // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);       // [BK][D + 1]
  float* dSs = Vs + BK * (D + 1);      // [BQ][BK + 1]
  float* Ls = dSs + BQ * (BK + 1);     // [BQ] lse
  float* Dl = Ls + BQ;                 // [BQ] delta

  const int qi = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int q0 = qi * BQ;

  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  const int64_t row0 = (static_cast<int64_t>(b) * H + h) * Tq;
  stage_rows<T, D, BQ>(Qs, q + b * qs.b + h * qs.h, qs.t, q0, Tq, sc);
  stage_rows<T, D, BQ>(dOs, dout + b * dos.b + h * dos.h, dos.t, q0, Tq, 1.f);
  for (int r = tid; r < BQ; r += THREADS) {
    const int t = q0 + r;
    Ls[r] = t < Tq ? lse[row0 + t] : 0.f;
    Dl[r] = t < Tq ? delta[row0 + t] : 0.f;
  }

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const int kv_end = causal ? min(S, q0 + BQ) : S;
  for (int kv0 = 0; kv0 < kv_end; kv0 += BK) {
    __syncthreads();  // the previous chunk's K and dS are consumed
    stage_rows<T, D, BK>(Ks, kb, ks.t, kv0, S, 1.f);
    stage_rows<T, D, BK>(Vs, vb, vs.t, kv0, S, 1.f);
    __syncthreads();

    float s[4][2], dp[4][2];
    scores<D>(Qs, dOs, Ks, Vs, ty, tx, 1.f, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = kv0 + tx + 16 * j;
        const float sv = (causal && qpos < kpos) ? NEG_INF : s[i][j];
        const float p = kpos < S ? expf(sv - Ls[r]) : 0.f;
        dSs[r * (BK + 1) + tx + 16 * j] = p * (dp[i][j] - Dl[r]);
      }
    }
    __syncwarp();  // a row's ds is written by the 16 lanes of its warp

    for (int kc = 0; kc < BK; ++kc) {
      float kk[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kk[j] = Ks[kc * (D + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = dSs[(ty * 4 + i) * (BK + 1) + kc];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(ds, kk[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    if (t >= Tq) continue;
    T* row = dq + b * dqs.b + h * dqs.h + t * dqs.t;
#pragma unroll
    for (int j = 0; j < DJ; ++j) row[tx + 16 * j] = from_f32<T>(acc[i][j] * sc);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int H, int KV, int Tq, int S, Strides qs, Strides ks, Strides vs,
    Strides dos, Strides dks, Strides dvs, float sc, int causal) {
  constexpr int DJ = D / 16;  // dK / dV columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                    // [BQ][D + 1], unscaled q
  float* dOs = Qs + BQ * (D + 1);      // [BQ][D + 1]
  float* Ks = dOs + BQ * (D + 1);      // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);       // [BK][D + 1]
  float* dSs = Vs + BK * (D + 1);      // [BQ][BK + 1]
  float* Ls = dSs + BQ * (BK + 1);     // [BQ] lse
  float* Dl = Ls + BQ;                 // [BQ] delta
  float* Ps = Dl + BQ;                 // [BQ][BK + 1]

  const int ki = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const int k0 = ki * BK;

  stage_rows<T, D, BK>(Ks, k + b * ks.b + kvh * ks.h, ks.t, k0, S, 1.f);
  stage_rows<T, D, BK>(Vs, v + b * vs.b + kvh * vs.h, vs.t, k0, S, 1.f);

  float dka[2][DJ], dva[2][DJ];
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dka[e][j] = dva[e][j] = 0.f;

  const int nq = (Tq + BQ - 1) / BQ;
  const int lo = causal ? k0 / BQ : 0;  // the first q chunk that sees k0
  for (int gi = 0; gi < G; ++gi) {
    const int h = kvh * G + gi;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* dob = dout + b * dos.b + h * dos.h;
    const int64_t row0 = (static_cast<int64_t>(b) * H + h) * Tq;
    for (int qc = lo; qc < nq; ++qc) {
      const int q0 = qc * BQ;
      __syncthreads();  // K, V staged; the previous chunk's q, dO, p, ds used
      stage_rows<T, D, BQ>(Qs, qb, qs.t, q0, Tq, 1.f);
      stage_rows<T, D, BQ>(dOs, dob, dos.t, q0, Tq, 1.f);
      for (int r = tid; r < BQ; r += THREADS) {
        const int t = q0 + r;
        Ls[r] = t < Tq ? lse[row0 + t] : 0.f;
        Dl[r] = t < Tq ? delta[row0 + t] : 0.f;
      }
      __syncthreads();

      float s[4][2], dp[4][2];
      scores<D>(Qs, dOs, Ks, Vs, ty, tx, sc, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        const int qpos = q0 + r;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int kpos = k0 + tx + 16 * j;
          const float sv = (causal && qpos < kpos) ? NEG_INF : s[i][j];
          const float p =
              (kpos < S && qpos < Tq) ? expf(sv - Ls[r]) : 0.f;
          Ps[r * (BK + 1) + tx + 16 * j] = p;
          dSs[r * (BK + 1) + tx + 16 * j] = p * (dp[i][j] - Dl[r]);
        }
      }
      __syncthreads();  // every row's p and ds, for every key column

      for (int r = 0; r < BQ; ++r) {
        float pe[2], dse[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          pe[e] = Ps[r * (BK + 1) + ty * 2 + e];
          dse[e] = dSs[r * (BK + 1) + ty * 2 + e];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const float ov = dOs[r * (D + 1) + tx + 16 * j];
          const float qv = Qs[r * (D + 1) + tx + 16 * j];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            dva[e][j] = fmaf(pe[e], ov, dva[e][j]);
            dka[e][j] = fmaf(dse[e], qv, dka[e][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int s = k0 + ty * 2 + e;
    if (s >= S) continue;
    T* krow = dk + b * dks.b + kvh * dks.h + s * dks.t;
    T* vrow = dv + b * dvs.b + kvh * dvs.h + s * dvs.t;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      krow[tx + 16 * j] = from_f32<T>(dka[e][j] * sc);
      vrow[tx + 16 * j] = from_f32<T>(dva[e][j]);
    }
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
  int B, H, KV, Tq, S;
  Strides qs, ks, vs, dos, dqs, dks, dvs;
  float sc;
  int causal;
  cudaStream_t st;
};

template <typename T, int D>
int launch_dq(const BwdArgs& a) {
  const size_t smem = dq_smem_bytes(D);
  const int err = opt_in(reinterpret_cast<const void*>(
                             flash_bwd_dq_kernel<T, D>), smem);
  if (err) return err;
  const dim3 grid((a.Tq + BQ - 1) / BQ, a.H, a.B);
  flash_bwd_dq_kernel<T, D><<<grid, THREADS, smem, a.st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dq), a.H, a.KV, a.Tq, a.S, a.qs, a.ks, a.vs,
      a.dos, a.dqs, a.sc, a.causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv(const BwdArgs& a) {
  const size_t smem = dkv_smem_bytes(D);
  const int err = opt_in(reinterpret_cast<const void*>(
                             flash_bwd_dkv_kernel<T, D>), smem);
  if (err) return err;
  const dim3 grid((a.S + BK - 1) / BK, a.KV, a.B);
  flash_bwd_dkv_kernel<T, D><<<grid, THREADS, smem, a.st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.H, a.KV, a.Tq,
      a.S, a.qs, a.ks, a.vs, a.dos, a.dks, a.dvs, a.sc, a.causal);
  return static_cast<int>(cudaGetLastError());
}

// which: 0 = dQ, 1 = dK/dV.
template <typename T>
int dispatch_bwd(const BwdArgs& a, int D, int which) {
  switch (D) {
    case 16:
      return which ? launch_dkv<T, 16>(a) : launch_dq<T, 16>(a);
    case 32:
      return which ? launch_dkv<T, 32>(a) : launch_dq<T, 32>(a);
    case 64:
      return which ? launch_dkv<T, 64>(a) : launch_dq<T, 64>(a);
    case 128:
      return which ? launch_dkv<T, 128>(a) : launch_dq<T, 128>(a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int run_bwd(const BwdArgs& a, int D, int dtype, int which) {
  if (a.B <= 0 || a.H <= 0 || a.KV <= 0 || a.H % a.KV != 0 || a.Tq <= 0 ||
      a.S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return dispatch_bwd<float>(a, D, which);
  if (dtype == 1) return dispatch_bwd<__nv_bfloat16>(a, D, which);
  return static_cast<int>(cudaErrorInvalidValue);
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

extern "C" int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int H, int KV,
    int Tq, int S, int D, long long q_sb, long long q_sh, long long q_st,
    long long k_sb, long long k_sh, long long k_st, long long v_sb,
    long long v_sh, long long v_st, long long do_sb, long long do_sh,
    long long do_st, long long dq_sb, long long dq_sh, long long dq_st,
    float sc, int causal, int dtype, void* stream) {
  BwdArgs a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = dq;
  a.B = B; a.H = H; a.KV = KV; a.Tq = Tq; a.S = S;
  a.qs = {q_sb, q_sh, q_st}; a.ks = {k_sb, k_sh, k_st};
  a.vs = {v_sb, v_sh, v_st}; a.dos = {do_sb, do_sh, do_st};
  a.dqs = {dq_sb, dq_sh, dq_st};
  a.sc = sc; a.causal = causal;
  a.st = static_cast<cudaStream_t>(stream);
  return run_bwd(a, D, dtype, 0);
}

extern "C" int flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int H,
    int KV, int Tq, int S, int D, long long q_sb, long long q_sh,
    long long q_st, long long k_sb, long long k_sh, long long k_st,
    long long v_sb, long long v_sh, long long v_st, long long do_sb,
    long long do_sh, long long do_st, long long dk_sb, long long dk_sh,
    long long dk_st, long long dv_sb, long long dv_sh, long long dv_st,
    float sc, int causal, int dtype, void* stream) {
  BwdArgs a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dk = dk; a.dv = dv;
  a.B = B; a.H = H; a.KV = KV; a.Tq = Tq; a.S = S;
  a.qs = {q_sb, q_sh, q_st}; a.ks = {k_sb, k_sh, k_st};
  a.vs = {v_sb, v_sh, v_st}; a.dos = {do_sb, do_sh, do_st};
  a.dks = {dk_sb, dk_sh, dk_st}; a.dvs = {dv_sb, dv_sh, dv_st};
  a.sc = sc; a.causal = causal;
  a.st = static_cast<cudaStream_t>(stream);
  return run_bwd(a, D, dtype, 1);
}

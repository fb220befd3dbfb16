// A CPU stand-in for the CUDA features the flash kernels use, so that
// tests/_torch_cuda_emu.py can compile csrc/flash_attention.cu with g++
// and run its kernels on CPU tensors.  A block runs as std::threads;
// __syncthreads() is a barrier of the block's threads; __shfl_xor_sync an
// exchange behind a barrier of the warp's 32 threads; cp.async copies at
// issue (and zero-fills); and wgmma .tf32 (A in registers, B K-major in
// shared memory) is computed at
// issue by the warpgroup's 128 threads together: each thread posts its A
// fragment, and after a warpgroup barrier computes its own accumulator
// registers, reading B through the descriptor (start address, leading and
// stride byte offsets, 8 x 16-byte core matrices).  The fragment layouts
// are those the card's results confirm (accumulator register n8*4 + r:
// row warp*16 + gid + 8 (r / 2), column n8*8 + 2 tig + r % 2; A register r:
// row warp*16 + gid + 8 (r % 2), k slot tig + 4 (r / 2)).  Operands are
// read as the card reads .tf32 words, their low 13 bits cleared, and each
// step's 8 products summed in double.  The bf16 wgmmas the tensor-core
// kernels use are computed the same way: m64n64k16 with A and B K-major in
// shared memory (8 x 16-byte core matrices: element (row, k) at start +
// (k / 8) lbo + (row / 8) sbo + (row % 8) 16 + (k % 8) 2), and m64nNk16 with
// A's bf16 pairs in registers (register r: row warp*16 + gid + 8 (r % 2),
// k 8 (r / 2) + 2 tig and + 1 in its high half) and B MN-major (element
// (k, n) at start + (k / 8) lbo + (n / 8) sbo + (k % 8) 16 + (n % 8) 2),
// each step's 16 products summed in double; bf16 rounds to nearest even.
// Named barriers (bar.sync / bar.arrive) are not emulated: a kernel that
// needs them cannot run here.  Only the single-translation-unit build of
// the test uses it.
#pragma once
#include <cmath>
#include <condition_variable>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>
#include <algorithm>
using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__
#define __restrict__
#define __align__(n) __attribute__((aligned(n)))
#define __launch_bounds__(...)
#define EMU_ASM(...) ((void)0)

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct EmuIdx {
  unsigned x, y, z;
};
thread_local EmuIdx threadIdx, blockIdx;
EmuIdx gridDim, blockDim;
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <typename F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
struct __nv_bfloat16 {
  unsigned short x;
};
struct __nv_bfloat162 {
  __nv_bfloat16 x, y;
};
struct float2 {
  float x, y;
};
struct float4 {
  float x, y, z, w;
};
struct uint4 {
  unsigned x, y, z, w;
};
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d};
}
inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return u;
}
inline __nv_bfloat16 emu_bf16(float f) {
  uint32_t u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {0x7fc0};  // NaN
  u += 0x7fffu + ((u >> 16) & 1u);                      // to nearest even
  return {static_cast<unsigned short>(u >> 16)};
}
inline float emu_float(unsigned short bits) {
  return __uint_as_float(static_cast<uint32_t>(bits) << 16);
}
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {emu_bf16(a), emu_bf16(b)};
}
inline float2 __bfloat1622float2(__nv_bfloat162 v) {
  return {emu_float(v.x.x), emu_float(v.y.x)};
}
inline float __fadd_rn(float a, float b) { return a + b; }

constexpr size_t EMU_SMEM = 232448;  // a block's dynamic shared memory
alignas(128) unsigned char smem_raw[EMU_SMEM];
inline size_t __cvta_generic_to_shared(const void* p) {
  return static_cast<size_t>(static_cast<const unsigned char*>(p) - smem_raw);
}

struct EmuBarrier {
  std::mutex m;
  std::condition_variable cv;
  int n, count = 0;
  long gen = 0;
  explicit EmuBarrier(int n_) : n(n_) {}
  void wait() {
    std::unique_lock<std::mutex> lk(m);
    const long g = gen;
    if (++count == n) {
      count = 0;
      ++gen;
      cv.notify_all();
      return;
    }
    cv.wait(lk, [&] { return gen != g; });
  }
};
EmuBarrier* emu_block_bar;
EmuBarrier* emu_wg_bar[2];
EmuBarrier* emu_warp_bar[8];
uint32_t emu_a[2][128][4];  // each warpgroup's posted A fragments
float emu_lane[8][32];      // each warp's posted shuffle operands
inline void __syncthreads() { emu_block_bar->wait(); }
inline void __syncwarp() {}

// A full-warp shuffle: each lane posts its value, and after the warp's
// barrier reads its partner's.
inline float __shfl_xor_sync(unsigned, float v, int mask) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  emu_lane[w][lane] = v;
  emu_warp_bar[w]->wait();
  const float r = emu_lane[w][lane ^ mask];
  emu_warp_bar[w]->wait();
  return r;
}

inline void emu_cp_async(uint32_t dst, const void* src, int bytes, int size) {
  std::memset(smem_raw + dst, 0, size);
  std::memcpy(smem_raw + dst, src, bytes);
}

template <int M>
inline void emu_wgmma_tf32(float (&d)[M], const uint32_t (&a)[4],
                           uint64_t desc, int scale_d) {
  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  for (int i = 0; i < 4; ++i) emu_a[wg][t][i] = a[i];
  emu_wg_bar[wg]->wait();
  const uint32_t start = static_cast<uint32_t>(desc & 0x3FFF) << 4;
  const uint32_t lbo = static_cast<uint32_t>((desc >> 16) & 0x3FFF) << 4;
  const uint32_t sbo = static_cast<uint32_t>((desc >> 32) & 0x3FFF) << 4;
  const int warp = t / 32, gid = (t % 32) / 4, tig = t % 4;
  for (int idx = 0; idx < M; ++idx) {
    const int n8 = idx / 4, r = idx % 4;
    const int m = warp * 16 + gid + 8 * (r >> 1);
    const int n = n8 * 8 + tig * 2 + (r & 1);
    double sum = 0;
    for (int k = 0; k < 8; ++k) {
      const int owner = (m / 16) * 32 + (m % 8) * 4 + (k % 4);
      const int reg = ((m % 16) >= 8 ? 1 : 0) + (k >= 4 ? 2 : 0);
      const float av = __uint_as_float(emu_a[wg][owner][reg] & ~0x1fffu);
      uint32_t bu;
      std::memcpy(&bu, smem_raw + start + (k / 4) * lbo + (n / 8) * sbo +
                           (n % 8) * 16 + (k % 4) * 4, 4);
      sum += static_cast<double>(av) * __uint_as_float(bu & ~0x1fffu);
    }
    d[idx] = static_cast<float>((scale_d ? static_cast<double>(d[idx]) : 0.0)
                                + sum);
  }
  emu_wg_bar[wg]->wait();
}

inline float emu_smem_bf16(uint32_t byte) {
  unsigned short bits;
  std::memcpy(&bits, smem_raw + byte, 2);
  return emu_float(bits);
}

struct EmuDesc {
  uint32_t start, lbo, sbo;
  explicit EmuDesc(uint64_t desc)
      : start(static_cast<uint32_t>(desc & 0x3FFF) << 4),
        lbo(static_cast<uint32_t>((desc >> 16) & 0x3FFF) << 4),
        sbo(static_cast<uint32_t>((desc >> 32) & 0x3FFF) << 4) {}
  // bf16 element (row, k) of a K-major operand, (k, n) of an MN-major one
  float kmajor(int row, int k) const {
    return emu_smem_bf16(start + (k / 8) * lbo + (row / 8) * sbo +
                         (row % 8) * 16 + (k % 8) * 2);
  }
  float mnmajor(int k, int n) const {
    return emu_smem_bf16(start + (k / 8) * lbo + (n / 8) * sbo +
                         (k % 8) * 16 + (n % 8) * 2);
  }
};

// D (64 x 64) (+)= A (64 x 16) B^T (64 x 16), bf16, both K-major in shared
// memory; every thread computes its own accumulator registers (nothing is
// posted, but the warpgroup meets before and after, as the card's
// wgmma.wait does for the shared memory it reads).
inline void emu_wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                         int scale_d) {
  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  emu_wg_bar[wg]->wait();
  const EmuDesc a(da), b(db);
  const int warp = t / 32, gid = (t % 32) / 4, tig = t % 4;
  for (int idx = 0; idx < 32; ++idx) {
    const int n8 = idx / 4, r = idx % 4;
    const int m = warp * 16 + gid + 8 * (r >> 1);
    const int n = n8 * 8 + tig * 2 + (r & 1);
    double sum = 0;
    for (int k = 0; k < 16; ++k)
      sum += static_cast<double>(a.kmajor(m, k)) * b.kmajor(n, k);
    d[idx] = static_cast<float>((scale_d ? static_cast<double>(d[idx]) : 0.0)
                                + sum);
  }
  emu_wg_bar[wg]->wait();
}

// D (64 x N: M = N / 2 accumulator registers a thread) += A (64 x 16,
// bf16 pairs in registers) B (16 x N), B MN-major in shared memory.
template <int M>
inline void emu_wgmma_rs(float (&d)[M], uint32_t a0, uint32_t a1,
                         uint32_t a2, uint32_t a3, uint64_t db) {
  const int tid = threadIdx.x, wg = tid / 128, t = tid % 128;
  emu_a[wg][t][0] = a0;
  emu_a[wg][t][1] = a1;
  emu_a[wg][t][2] = a2;
  emu_a[wg][t][3] = a3;
  emu_wg_bar[wg]->wait();
  const EmuDesc b(db);
  const int warp = t / 32, gid = (t % 32) / 4, tig = t % 4;
  for (int idx = 0; idx < M; ++idx) {
    const int n8 = idx / 4, r = idx % 4;
    const int m = warp * 16 + gid + 8 * (r >> 1);
    const int n = n8 * 8 + tig * 2 + (r & 1);
    double sum = 0;
    for (int k = 0; k < 16; ++k) {
      // the owner of (m, k): its register and half
      const int owner = (m / 16) * 32 + (m % 8) * 4 + (k % 8) / 2;
      const int reg = ((m % 16) >= 8 ? 1 : 0) + (k >= 8 ? 2 : 0);
      const uint32_t pair = emu_a[wg][owner][reg];
      const float av = emu_float(static_cast<unsigned short>(
          k % 2 ? pair >> 16 : pair & 0xFFFFu));
      sum += static_cast<double>(av) * b.mnmajor(k, n);
    }
    d[idx] = static_cast<float>(static_cast<double>(d[idx]) + sum);
  }
  emu_wg_bar[wg]->wait();
}

// A launch: the grid's blocks one after another, each as `threads` threads
// over a shared memory first filled with NaN bit patterns (a read of a word
// no copy or store wrote shows up in the results).
inline void emu_launch(dim3 grid, int threads, size_t smem_bytes,
                       const std::function<void()>& fn) {
  if (smem_bytes > EMU_SMEM) {
    std::fprintf(stderr, "emu: %zu bytes of shared memory\n", smem_bytes);
    std::abort();
  }
  gridDim = {grid.x, grid.y, grid.z};
  blockDim = {static_cast<unsigned>(threads), 1, 1};
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        std::memset(smem_raw, 0xFF, EMU_SMEM);
        EmuBarrier block(threads), wg0(128), wg1(128);
        emu_block_bar = &block;
        emu_wg_bar[0] = &wg0;
        emu_wg_bar[1] = &wg1;
        std::vector<std::unique_ptr<EmuBarrier>> warps;
        for (int w = 0; w < threads / 32; ++w) {
          warps.emplace_back(new EmuBarrier(32));
          emu_warp_bar[w] = warps.back().get();
        }
        std::vector<std::thread> ts;
        for (int i = 0; i < threads; ++i)
          ts.emplace_back([&, i] {
            threadIdx = {static_cast<unsigned>(i), 0, 0};
            blockIdx = {x, y, z};
            fn();
          });
        for (auto& th : ts) th.join();
      }
}

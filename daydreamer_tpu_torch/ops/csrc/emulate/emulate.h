// A CPU stand-in for the few CUDA features the kernels of this directory
// use, so that a kernel's arithmetic can be run and held against its plain
// PyTorch version where there is no card and no nvcc (see ops/emulate.py).
// One OS thread plays one CUDA thread; the blocks of a launch run one after
// another; __syncthreads() is a barrier over the block's threads, and a
// warp shuffle is an exchange through memory between two such barriers (so
// every thread of the block has to reach it, which holds for these
// kernels). It shows a wrong index, layout or formula. It does not show a
// missing barrier reliably, and it says nothing about speed.
#pragma once

#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__

struct uint3 { unsigned x, y, z; };
inline thread_local uint3 threadIdx, blockIdx;
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
struct int4 { int x, y, z, w; };

typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F>
cudaError_t cudaFuncSetAttribute(F, int, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

namespace emu {

inline thread_local float* smem;  // The block's dynamic shared memory.
inline std::barrier<>* barrier;
inline float* exchange;           // One float per thread, for shuffles.

// kernel<<<blocks, threads, bytes, stream>>>(p), one block at a time.
// Shared memory starts as NaN, so a read of an unset value shows.
template <class K, class P>
void launch(K kernel, int blocks, int threads, size_t bytes, cudaStream_t,
            P p) {
  for (int b = 0; b < blocks; ++b) {
    std::vector<float> memory(bytes / sizeof(float) + 4, NAN);
    std::vector<float> slots(threads);
    std::barrier<> sync(threads);
    barrier = &sync;
    exchange = slots.data();
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t)
      pool.emplace_back([=, &memory]() {
        threadIdx = {(unsigned)t, 0, 0};
        blockIdx = {(unsigned)b, 0, 0};
        smem = memory.data();
        kernel(p);
      });
    for (auto& thread : pool) thread.join();
  }
}

}  // namespace emu

inline void __syncthreads() { emu::barrier->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int offset) {
  emu::exchange[threadIdx.x] = v;
  __syncthreads();
  const float other = emu::exchange[threadIdx.x ^ offset];
  __syncthreads();
  return other;
}
inline float rsqrtf(float x) { return 1.f / std::sqrt(x); }
using std::max;
using std::min;

struct __nv_bfloat16 { uint16_t bits; };
inline float __bfloat162float(__nv_bfloat16 b) {
  const uint32_t u = (uint32_t)b.bits << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16(float f) {  // Round to nearest even.
  uint32_t u;
  memcpy(&u, &f, 4);
  u += 0x7fff + ((u >> 16) & 1);
  return {(uint16_t)(u >> 16)};
}
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline float2 __bfloat1622float2(__nv_bfloat162 v) {
  return {__bfloat162float(v.x), __bfloat162float(v.y)};
}

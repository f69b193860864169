// A CPU stand-in for the few CUDA features the kernels of this directory
// use, so that a kernel's arithmetic can be run and held against its plain
// PyTorch version where there is no card and no nvcc (see ops/emulate.py).
// One OS thread plays one CUDA thread; the blocks of a launch run one after
// another, or one cluster after another with the blocks of a cluster alive
// together; __syncthreads() is a barrier over the block's threads, and a
// warp shuffle is an exchange through memory between two such barriers (so
// every thread of the block has to reach it, which holds for these
// kernels). The warp-wide operations of ptx.h (ldmatrix, mma) meet at a
// barrier of their own warp. It shows a wrong index, layout or formula. It
// does not show a missing barrier or a race between the ranks of a cluster
// reliably, and it says nothing about speed.
#pragma once

#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
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
inline float2 make_float2(float x, float y) { return {x, y}; }

typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F>
cudaError_t cudaFuncSetAttribute(F, int, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

#define __cluster_dims__(...)

namespace emu {

using Barrier = std::barrier<>;

// What a thread knows of its block, its warp and its cluster.
inline thread_local float* smem;        // The block's dynamic shared memory.
inline thread_local Barrier* barrier;   // The block's.
inline thread_local Barrier* warp_barrier;
inline thread_local Barrier* cluster_barrier;
inline thread_local float* exchange;    // One float per thread, for shuffles.
inline thread_local uint64_t* lanes;    // 32 x 8 words of the thread's warp.
inline thread_local float* const* cluster_smem;  // Each rank's shared memory.
inline thread_local int cluster_rank;

struct Block {
  std::vector<float> memory, slots;
  std::vector<uint64_t> words;
  std::unique_ptr<Barrier> sync;
  std::vector<std::unique_ptr<Barrier>> warps;
  Block(int threads, size_t bytes)
      : memory(bytes / sizeof(float) + 4, NAN), slots(threads),
        words((threads + 31) / 32 * 32 * 8), sync(new Barrier(threads)) {
    for (int t = 0; t < threads; t += 32)
      warps.emplace_back(new Barrier(std::min(32, threads - t)));
  }
};

// kernel<<<blocks, threads, bytes, stream>>>(args...), one cluster of
// `cluster` blocks at a time (one block at a time without clusters).
// Shared memory starts as NaN, so a read of an unset value shows.
template <class K, class... Args>
void launch(int cluster, K kernel, int blocks, int threads, size_t bytes,
            cudaStream_t, Args... args) {
  for (int first = 0; first < blocks; first += cluster) {
    std::vector<std::unique_ptr<Block>> alive;
    std::vector<float*> bases;
    for (int r = 0; r < cluster; ++r) {
      alive.emplace_back(new Block(threads, bytes));
      bases.push_back(alive.back()->memory.data());
    }
    Barrier all(cluster * threads);
    std::vector<std::thread> pool;
    for (int r = 0; r < cluster; ++r)
      for (int t = 0; t < threads; ++t)
        pool.emplace_back([=, &alive, &bases, &all]() {
          Block& block = *alive[r];
          threadIdx = {(unsigned)t, 0, 0};
          blockIdx = {(unsigned)(first + r), 0, 0};
          smem = block.memory.data();
          barrier = block.sync.get();
          warp_barrier = block.warps[t / 32].get();
          cluster_barrier = &all;
          exchange = block.slots.data();
          lanes = block.words.data() + (size_t)(t / 32) * 32 * 8;
          cluster_smem = bases.data();
          cluster_rank = r;
          kernel(args...);
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

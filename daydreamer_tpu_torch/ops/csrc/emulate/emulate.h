// A CPU stand-in for the few CUDA features the kernels of this directory
// use, so that a kernel's arithmetic can be run and held against its plain
// PyTorch version where there is no card and no nvcc (see ops/emulate.py).
// One fiber (a stack of its own, switched in user space) plays one CUDA
// thread; the blocks of a launch run one after another, or one cluster
// after another with the blocks of a cluster alive together (a cooperative
// launch's grid is one cluster), all on the calling OS thread. A fiber
// runs until it waits at a barrier or sleeps in a loop that waits for
// memory (__nanosleep): __syncthreads() is a barrier over the block's
// fibers, a warp shuffle an exchange through memory between two barriers
// of its warp, and the warp-wide operations of ptx.h (ldmatrix, mma) meet
// at their warp's barrier too. The scheduler walks the fibers forward and backward in
// turns, so a fiber that reads what another writes between the same two
// barriers sees the write in one order or the other. A barrier that some
// fibers never reach stops the run (a deadlock on the card). It shows a
// wrong index, layout or formula. It does not show a missing barrier or a
// race between the ranks of a cluster reliably, and it says nothing about
// speed.
//
// Why fibers and not OS threads: a cluster of 4 blocks is 4096 CUDA
// threads, and with an OS thread each, every barrier had the operating
// system wake all of them. The 13 cases of ops/emulate.py took 133 s so on
// an idle 8-core machine, 8.4 minutes of it system time against 4 of user
// time, and over 600 s beside other work; as fibers they take 37 s on one
// core. A switch between fibers is a few instructions.
#pragma once

#include <sys/mman.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__

struct uint3 { unsigned x, y, z; };
inline thread_local uint3 threadIdx, blockIdx, blockDim, gridDim;
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
struct int4 { int x, y, z, w; };
inline float2 make_float2(float x, float y) { return {x, y}; }
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x = 1, unsigned y = 1, unsigned z = 1) : x(x), y(y), z(z) {}
};

typedef void* cudaStream_t;
typedef int cudaError_t;
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorNotSupported = 801
};
enum {
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaFuncAttributeNonPortableClusterSizeAllowed = 11
};
template <class F>
cudaError_t cudaFuncSetAttribute(F, int, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

#define __cluster_dims__(...)

// cudaLaunchKernelEx and its configuration, as far as the kernels use them:
// the grid, the block, the dynamic shared memory and a cluster size.
enum cudaLaunchAttributeID {
  cudaLaunchAttributeCooperative = 2,
  cudaLaunchAttributeClusterDimension = 4
};
struct cudaLaunchAttributeValue {
  struct { unsigned x, y, z; } clusterDim;
  int cooperative;
};
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  cudaLaunchAttributeValue val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
// The card the launches go to, and what it holds: an H100's 132 SMs, 4
// blocks of any kernel each, so that a launch's grid is what its caller
// caps it at.
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int* device) {
  *device = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr, int) {
  *value = 132;
  return cudaSuccess;
}
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, F, int,
                                                          size_t) {
  *blocks = 4;
  return cudaSuccess;
}
// How many clusters fit the card at once: as many as its blocks above
// make, whole clusters of the launch's size.
template <class F>
cudaError_t cudaOccupancyMaxActiveClusters(int* count, F,
                                           const cudaLaunchConfig_t* config) {
  int cluster = 1;
  for (unsigned i = 0; i < config->numAttrs; ++i)
    if (config->attrs[i].id == cudaLaunchAttributeClusterDimension)
      cluster = static_cast<int>(config->attrs[i].val.clusterDim.x);
  *count = 132 * 4 / cluster;
  return cudaSuccess;
}

// Saves the callee-saved registers and the stack pointer of the running
// context at *save and resumes the context saved at `load` (x86-64 System
// V). A new fiber's first switch returns into emu_start, which calls r12
// with rbx as its argument. Both are local to each translation unit, so
// that a kernel built from several sources links.
extern "C" __attribute__((visibility("hidden"))) void emu_switch(void** save,
                                                                 void* load);
extern "C" __attribute__((visibility("hidden"))) void emu_start();
asm(R"(
  .text
  .local emu_switch
  .type emu_switch, @function
emu_switch:
  pushq %rbp
  pushq %rbx
  pushq %r12
  pushq %r13
  pushq %r14
  pushq %r15
  movq %rsp, (%rdi)
  movq %rsi, %rsp
  popq %r15
  popq %r14
  popq %r13
  popq %r12
  popq %rbx
  popq %rbp
  ret
  .size emu_switch, .-emu_switch
  .local emu_start
  .type emu_start, @function
emu_start:
  movq %rbx, %rdi
  callq *%r12
  ud2
  .size emu_start, .-emu_start
)");

namespace emu {

struct Barrier;

// One CUDA thread: its saved context, the barrier it waits at, and what it
// knows of its block, its warp and its cluster.
struct Fiber {
  void* sp;
  Barrier* waits;
  unsigned phase;  // The phase of `waits` it waits to end.
  bool done;
  const std::function<void()>* body;
  uint3 thread, block;
  float* smem;
  Barrier *sync, *warp, *cluster;
  float* exchange;
  uint64_t* lanes;
  float* const* cluster_smem;
  int rank;
};

inline thread_local Fiber* current;     // The fiber that runs.
inline thread_local void* scheduler;    // The scheduler's saved context.
// What the running fiber knows, set at every switch to it.
inline thread_local float* smem;        // The block's dynamic shared memory.
inline thread_local Barrier* barrier;   // The block's.
inline thread_local Barrier* warp_barrier;
inline thread_local Barrier* cluster_barrier;
inline thread_local float* exchange;    // One float per thread, for shuffles.
inline thread_local uint64_t* lanes;    // 32 x 8 words of the thread's warp.
inline thread_local float* const* cluster_smem;  // Each rank's shared memory.
inline thread_local int cluster_rank;

struct Barrier {
  explicit Barrier(int n) : n(n) {}
  // The last to arrive goes on; the others wait until the scheduler sees
  // the phase end.
  void arrive_and_wait() {
    if (++arrived == n) {
      arrived = 0;
      ++phase;
      return;
    }
    current->waits = this;
    current->phase = phase;
    emu_switch(&current->sp, scheduler);
  }
  int n, arrived = 0;
  unsigned phase = 0;
};

inline void run_fiber(Fiber* f) {
  (*f->body)();
  f->done = true;
  emu_switch(&f->sp, scheduler);
  __builtin_trap();  // A finished fiber is never resumed.
}

constexpr size_t STACK = 256 << 10;  // Bytes of a fiber's stack.

// Stacks are mapped once and kept for every later launch; the lowest page
// of each is a guard.
inline char* stack(size_t i) {
  static thread_local std::vector<char*> stacks;
  while (stacks.size() <= i) {
    void* p = mmap(nullptr, STACK, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0);
    if (p == MAP_FAILED) {
      fprintf(stderr, "emulate: no memory for a fiber's stack\n");
      abort();
    }
    mprotect(p, 4096, PROT_NONE);
    stacks.push_back(static_cast<char*>(p));
  }
  return stacks[i];
}

// The first context of a fiber: emu_switch pops six registers (r12: the
// function, rbx: its argument) and returns into emu_start, whose call finds
// the stack aligned to 16 bytes.
inline void* first_context(char* base, Fiber* f) {
  uintptr_t top = (reinterpret_cast<uintptr_t>(base) + STACK) & ~uintptr_t(15);
  uint64_t* sp = reinterpret_cast<uint64_t*>(top - 16 - 7 * 8);
  const uint64_t words[7] = {
      0, 0, 0, reinterpret_cast<uint64_t>(&run_fiber),       // r15 .. r12
      reinterpret_cast<uint64_t>(f), 0,                      // rbx, rbp
      reinterpret_cast<uint64_t>(&emu_start)};               // return
  memcpy(sp, words, sizeof(words));
  return sp;
}

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

// Runs the fibers until all are done, walking them forward and backward in
// turns; stops the process if they wait for each other (a deadlock).
inline void schedule(std::vector<Fiber>& fibers) {
  const int n = static_cast<int>(fibers.size());
  for (bool forward = true;; forward = !forward) {
    int alive = 0;
    bool moved = false;
    for (int i = 0; i < n; ++i) {
      Fiber& f = fibers[forward ? i : n - 1 - i];
      if (f.done) continue;
      ++alive;
      if (f.waits && f.waits->phase == f.phase) continue;
      f.waits = nullptr;
      threadIdx = f.thread;
      blockIdx = f.block;
      smem = f.smem;
      barrier = f.sync;
      warp_barrier = f.warp;
      cluster_barrier = f.cluster;
      exchange = f.exchange;
      lanes = f.lanes;
      cluster_smem = f.cluster_smem;
      cluster_rank = f.rank;
      current = &f;
      emu_switch(&scheduler, f.sp);
      moved = true;
    }
    if (!alive) return;
    if (!moved) {
      fprintf(stderr, "emulate: the threads of a launch wait for each other "
                      "at different barriers\n");
      abort();
    }
  }
}

// kernel<<<blocks, threads, bytes, stream>>>(args...), one cluster of
// `cluster` blocks at a time (one block at a time without clusters).
// Shared memory starts as NaN, so a read of an unset value shows.
template <class K, class... Args>
void launch(int cluster, K kernel, int blocks, int threads, size_t bytes,
            cudaStream_t, Args... args) {
  const std::function<void()> body = [&]() { kernel(args...); };
  gridDim = {(unsigned)blocks, 1, 1};
  blockDim = {(unsigned)threads, 1, 1};
  for (int first = 0; first < blocks; first += cluster) {
    std::vector<std::unique_ptr<Block>> alive;
    std::vector<float*> bases;
    for (int r = 0; r < cluster; ++r) {
      alive.emplace_back(new Block(threads, bytes));
      bases.push_back(alive.back()->memory.data());
    }
    Barrier all(cluster * threads);
    std::vector<Fiber> fibers(static_cast<size_t>(cluster) * threads);
    for (int r = 0; r < cluster; ++r)
      for (int t = 0; t < threads; ++t) {
        Block& block = *alive[r];
        const size_t i = static_cast<size_t>(r) * threads + t;
        Fiber& f = fibers[i];
        f = Fiber{};
        f.body = &body;
        f.thread = {(unsigned)t, 0, 0};
        f.block = {(unsigned)(first + r), 0, 0};
        f.smem = block.memory.data();
        f.sync = block.sync.get();
        f.warp = block.warps[t / 32].get();
        f.cluster = &all;
        f.exchange = block.slots.data();
        f.lanes = block.words.data() + (size_t)(t / 32) * 32 * 8;
        f.cluster_smem = bases.data();
        f.rank = r;
        f.sp = first_context(stack(i), &f);
      }
    schedule(fibers);
  }
}

}  // namespace emu

// cudaLaunchKernelEx(config, kernel, args...): the launch above, with the
// cluster size the configuration asks for; a cooperative launch runs all
// its blocks side by side, as the card holds them all at once.
template <class... Ps, class... Args>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* config,
                               void (*kernel)(Ps...), Args&&... args) {
  int cluster = 1;
  for (unsigned i = 0; i < config->numAttrs; ++i) {
    if (config->attrs[i].id == cudaLaunchAttributeClusterDimension)
      cluster = static_cast<int>(config->attrs[i].val.clusterDim.x);
    if (config->attrs[i].id == cudaLaunchAttributeCooperative &&
        config->attrs[i].val.cooperative)
      cluster = static_cast<int>(config->gridDim.x);
  }
  emu::launch(cluster, kernel, static_cast<int>(config->gridDim.x),
              static_cast<int>(config->blockDim.x), config->dynamicSmemBytes,
              config->stream, Ps(args)...);
  return cudaSuccess;
}

inline void __syncthreads() { emu::barrier->arrive_and_wait(); }
// A thread that waits for a value in memory lets the others run; the
// scheduler resumes it on its next pass.
inline void __nanosleep(unsigned) {
  emu::current->waits = nullptr;
  emu_switch(&emu::current->sp, emu::scheduler);
}
inline float __shfl_xor_sync(unsigned, float v, int offset) {
  emu::exchange[threadIdx.x] = v;
  emu::warp_barrier->arrive_and_wait();
  const float other = emu::exchange[threadIdx.x ^ offset];
  emu::warp_barrier->arrive_and_wait();
  return other;
}
inline int __shfl_xor_sync(unsigned mask, int v, int offset) {
  float f, other;
  memcpy(&f, &v, 4);
  other = __shfl_xor_sync(mask, f, offset);
  memcpy(&v, &other, 4);
  return v;
}
// The threads of a launch take turns on one OS thread here, so an atomic
// is a plain read-modify-write, a fence orders nothing that is not
// already in order, and a load past L1 is a load.
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  const unsigned old = *p;
  *p = old + v;
  return old;
}
inline unsigned atomicExch(unsigned* p, unsigned v) {
  const unsigned old = *p;
  *p = v;
  return old;
}
inline void __threadfence() {}
inline float4 __ldcg(const float4* p) { return *p; }
inline float __ldcg(const float* p) { return *p; }
inline float rsqrtf(float x) { return 1.f / std::sqrt(x); }
// The intrinsics of one IEEE rounding each: g++ contracts nothing here.
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
using std::isfinite;
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
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16(a), __float2bfloat16(b)};
}

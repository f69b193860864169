// Device functions shared by the three kernels of the observe chain
// (observe_fwd.cu, observe_bwd.cu, observe.cu), whose products
// observe_cluster.cuh splits across a thread block cluster.
//
// Layout. A block owns R rows of the batch for the whole chunk. Every
// vector of a step lives in shared memory as float, transposed: element n
// of row r is at [n * R + r], so a flat index i runs over a buffer with
// row i % R, and, as the block size is a multiple of R, a thread always
// meets the same row. Weights are [K][N] row-major in global memory in the
// element type T (float or bf16) and are widened to float at the read;
// every product accumulates in float.
//
// The loads. A thread reads V adjacent weights of a row at once: 16 bytes
// (4 of float, 8 of bf16) where every product's N is a multiple of that,
// as at the shipped widths, else single values (a bf16 row of 20 values,
// or an odd width). The kernels take V as a template argument, which the
// wrapper picks from the widths (`load_values` in ops/rssm.py). Loads of
// 8 and 4 bytes would serve some widths better, but each V is another
// instantiation of every kernel of the chain, and the build of
// observe_bwd.cu, the longest, grew by about 10 s for each.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace obs {

constexpr int R = 2;             // Rows per block.
constexpr int NT = 1024;         // Threads per block.
constexpr int NW = NT / 32;      // Warps per block.
constexpr int PASS = 512;        // Columns per pass of dense().
constexpr int MAXL = 8;          // Most prior layers of the shipped path.
constexpr int MANY = 128;        // Most prior layers of the wide path.
constexpr int UNROLL = 16;       // Weight rows in flight per thread.

// The values of a 16-byte load of T: the widest V.
template <typename T> constexpr int VMAX = 16 / sizeof(T);
// Floats of a product's scratch, sized for the widest loads of the
// narrowest type (bf16, V = 8); narrower loads take fewer slices of K.
constexpr int SCRATCH = (NT / (PASS / 8)) * PASS * R;

static_assert(R >= 1 && R <= 32 && (R & (R - 1)) == 0, "R: a power of two");
static_assert(NT % (PASS / 4) == 0 && NT % 32 == 0, "block shape");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}
// x rounded to T and widened again: what a carry kept in T holds.
template <typename T> __device__ __forceinline__ float rnd(float x) {
  return to_f(from_f<T>(x));
}

// The V adjacent weights at p, widened to float, in one load of V *
// sizeof(T) bytes; p is aligned to that.
template <int V> struct Vec { float v[V]; };
template <int V>
__device__ __forceinline__ Vec<V> load_v(const float* p) {
  static_assert(V == 1 || V == 2 || V == 4, "a load of 4 to 16 bytes");
  Vec<V> out;
  if constexpr (V == 4) {
    const float4 w = *reinterpret_cast<const float4*>(p);
    out = {{w.x, w.y, w.z, w.w}};
  } else if constexpr (V == 2) {
    const float2 w = *reinterpret_cast<const float2*>(p);
    out.v[0] = w.x;
    out.v[1] = w.y;
  } else {
    out.v[0] = *p;
  }
  return out;
}
template <int V>
__device__ __forceinline__ Vec<V> load_v(const __nv_bfloat16* p) {
  static_assert(V == 1 || V == 2 || V == 4 || V == 8,
                "a load of 2 to 16 bytes");
  Vec<V> out;
  if constexpr (V == 1) {
    out.v[0] = __bfloat162float(*p);
  } else {
    unsigned words[V / 2];
    if constexpr (V == 8) {
      const uint4 raw = *reinterpret_cast<const uint4*>(p);
      words[0] = raw.x;
      words[1] = raw.y;
      words[2] = raw.z;
      words[3] = raw.w;
    } else if constexpr (V == 4) {
      const uint2 raw = *reinterpret_cast<const uint2*>(p);
      words[0] = raw.x;
      words[1] = raw.y;
    } else {
      words[0] = *reinterpret_cast<const unsigned*>(p);
    }
#pragma unroll
    for (int i = 0; i < V / 2; ++i) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&words[i]));
      out.v[2 * i] = f.x;
      out.v[2 * i + 1] = f.y;
    }
  }
  return out;
}

// f(std::integral_constant<int, V>()) for the V of T that `values` names
// (the wrapper's pick, see above): VMAX or 1; an error for any other.
template <typename T, class F>
__host__ int with_values(int values, F f) {
  if (values == VMAX<T>) return f(std::integral_constant<int, VMAX<T>>());
  if (values == 1) return f(std::integral_constant<int, 1>());
  return (int)cudaErrorInvalidValue;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}
__device__ __forceinline__ float elu(float n) {
  return n > 0.f ? n : expf(n) - 1.f;
}
__device__ __forceinline__ float elu_grad(float n) {
  return n > 0.f ? 1.f : expf(n);
}

// One input of a product. X: [K][R] in shared memory (or in the block's
// workspace, see observe_cluster.cuh). idx: the classes
// [S][R] of a one-hot X with S = K / C groups (then X is not read), scale:
// a factor [R] on that gathered sum (the is_first mask), or null.
template <typename T>
struct In {
  const float* X;
  const int* idx;
  const float* scale;
  int K;
  const T* W;  // Null: no input.
};

// Rows row0 .. row0 + R - 1 of src [B][width] (global, row-major) into dst
// [width][R], times scale[r] where given; rows past B read as zero. No
// barrier.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int width,
                                          int row0, int B,
                                          const float* scale) {
  for (int i = threadIdx.x; i < R * width; i += NT) {
    const int r = i / width, j = i % width, row = row0 + r;
    float v = row < B ? to_f(src[(size_t)row * width + j]) : 0.f;
    if (scale) v *= scale[r];
    dst[j * R + r] = v;
  }
}

// The reverse: src [width][R] into rows of dst [B][width]. No barrier.
template <typename T>
__device__ __forceinline__ void store_rows(T* dst, const float* src,
                                           int width, int row0, int B) {
  for (int i = threadIdx.x; i < R * width; i += NT) {
    const int r = i / width, j = i % width, row = row0 + r;
    if (row < B) dst[(size_t)row * width + j] = from_f<T>(src[j * R + r]);
  }
}

}  // namespace obs

// Device functions shared by the kernels that roll the RSSM image cell over
// many rows (imagine_actor.cu, imagine.cu).
//
// Layout. A block owns R = 8 rows for all steps. Every vector of a step
// lives in shared memory as float, transposed ([width][R]), so one 16-byte
// load gives a column of four rows. Weights are [K][N] row-major in global
// memory in the element type T (float or bf16) and stream from L2; each
// thread owns two output columns and reads its weights coalesced along the
// output axis. Products accumulate in float; values are rounded to T
// exactly where the JAX cell rounds (after each product, LayerNorm and
// ELU), so a kernel agrees with its plain PyTorch version. LayerNorm uses
// one warp per row. A product with the rollout's own one-hot sample is a
// gather of S weight rows, added in the order the dense loop visits them.
//
// Each kernel writes its steps out itself and keeps its pointers into
// shared memory as plain locals derived from the shared array. A version
// with the image cell's step as one function of this header, its buffers
// handed over in a struct of pointers, gave the same bits and took 24.0 ms
// in place of 18.4 ms for imagine_actor (NVIDIA H100 80GB HBM3, 700 W,
// bfloat16, xarm shape, both in one run; 48 registers in place of 64):
// the likely reason is that the compiler no longer knew those pointers for
// shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace img {

constexpr int R = 8;      // Rows per block.
constexpr int NT = 256;   // Threads per block: one warp per row for LN.
constexpr int MAXL = 8;   // Most prior / actor layers of the shipped path.
constexpr int MANY = 128; // Most prior / actor layers of the wide path.

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// acc[c][r] += sum_k X[k][r] * W[k][n_c] for the thread's columns n0, n1.
template <typename T>
__device__ __forceinline__ void mm(float (&acc)[2][R], const float* X, int K,
                                   const T* __restrict__ W, int N, int n0,
                                   int n1) {
  const bool v0 = n0 < N, v1 = n1 < N;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const T* row = W + (size_t)k * N;
    const float w0 = v0 ? to_f(row[n0]) : 0.f;
    const float w1 = v1 ? to_f(row[n1]) : 0.f;
    const float4 xa = *reinterpret_cast<const float4*>(X + k * R);
    const float4 xb = *reinterpret_cast<const float4*>(X + k * R + 4);
    const float x[R] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
    for (int r = 0; r < R; ++r) {
      acc[0][r] = fmaf(x[r], w0, acc[0][r]);
      acc[1][r] = fmaf(x[r], w1, acc[1][r]);
    }
  }
}

// The same product for a one-hot X of S groups of C classes, given by its
// classes idx[s][r]: a sum of S weight rows per row. The rows are added in
// the order the dense loop visits them, so the sum is the dense one's.
template <typename T>
__device__ __forceinline__ void mm_onehot(float (&acc)[2][R], const int* idx,
                                          int S, int C,
                                          const T* __restrict__ W, int N,
                                          int n0, int n1) {
  const bool v0 = n0 < N, v1 = n1 < N;
#pragma unroll 2
  for (int s = 0; s < S; ++s) {
    const int4 ia = *reinterpret_cast<const int4*>(idx + s * R);
    const int4 ib = *reinterpret_cast<const int4*>(idx + s * R + 4);
    const int k[R] = {ia.x, ia.y, ia.z, ia.w, ib.x, ib.y, ib.z, ib.w};
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const T* row = W + (size_t)(s * C + k[r]) * N;
      if (v0) acc[0][r] += to_f(row[n0]);
      if (v1) acc[1][r] += to_f(row[n1]);
    }
  }
}

// One input of a product: X [K][R], or the one-hot given by idx (S = K / C
// groups) when idx is set.
struct In {
  const float* X;
  const int* idx;
  int K;
  const void* W;
};

template <typename T>
__device__ __forceinline__ void mm_in(float (&acc)[2][R], const In& in,
                                      int C, int N, int n0, int n1) {
  const T* W = static_cast<const T*>(in.W);
  if (in.idx)
    mm_onehot<T>(acc, in.idx, in.K / C, C, W, N, n0, n1);
  else
    mm<T>(acc, in.X, in.K, W, N, n0, n1);
}

// Y[n][r] = X1 @ W1 (+ X2 @ W2) (+ bias), rounded to T when `round`.
template <typename T>
__device__ void dense(const In& in1, const In& in2, int C, int N,
                      const void* bias, bool round, float* Y) {
  for (int base = 0; base < N; base += 2 * NT) {
    const int n0 = base + threadIdx.x, n1 = n0 + NT;
    float acc[2][R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[0][r] = acc[1][r] = 0.f;
    mm_in<T>(acc, in1, C, N, n0, n1);
    if (in2.W) mm_in<T>(acc, in2, C, N, n0, n1);
    const int ns[2] = {n0, n1};
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (ns[c] >= N) continue;
      const float b = bias ? to_f(static_cast<const T*>(bias)[ns[c]]) : 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float v = acc[c][r] + b;
        Y[ns[c] * R + r] = round ? rnd<T>(v) : v;
      }
    }
  }
  __syncthreads();
}

// In place over Y [N][R]: LayerNorm (float, eps 1e-3) then optional ELU,
// rounding to T after each, as nets.py / pallas_rssm.py do.
template <typename T>
__device__ void ln_act(float* Y, int N, const void* scale_, const void* bias_,
                       bool elu) {
  const T* scale = static_cast<const T*>(scale_);
  const T* bias = static_cast<const T*>(bias_);
  const int r = threadIdx.x / 32, lane = threadIdx.x % 32;
  float s = 0.f;
  for (int n = lane; n < N; n += 32) s += Y[n * R + r];
  const float mean = warp_sum(s) / N;
  float v = 0.f;
  for (int n = lane; n < N; n += 32) {
    const float d = Y[n * R + r] - mean;
    v += d * d;
  }
  const float inv = rsqrtf(warp_sum(v) / N + 1e-3f);
  for (int n = lane; n < N; n += 32) {
    float y = rnd<T>((Y[n * R + r] - mean) * inv * to_f(scale[n]) +
                     to_f(bias[n]));
    if (elu) y = rnd<T>(y > 0.f ? y : expf(y) - 1.f);
    Y[n * R + r] = y;
  }
  __syncthreads();
}

}  // namespace img

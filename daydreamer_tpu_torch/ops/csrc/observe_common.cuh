// Device functions shared by the two kernels of the fused observe chain
// (observe_fwd.cu, observe_bwd.cu).
//
// Layout. A block owns R rows of the batch for the whole chunk. Every
// vector of a step lives in shared memory as float, transposed: element n
// of row r is at [n * R + r], so a flat index i runs over a buffer with
// row i % R, and, as the block size is a multiple of R, a thread always
// meets the same row. Weights are [K][N] row-major in global memory in the
// element type T (float or bf16) and are widened to float at the read;
// every product accumulates in float and nothing is rounded between
// layers (the reference computes the chain in float32 and rounds only its
// carries).
//
// dense(): Y = X1 @ W1 (+ X2 @ W2) (+ bias) (+ addend). A step waits for
// its weights to arrive from L2, not for its FMAs, so the product is laid
// out for loads: a pass covers 512 output columns, a thread owns the V
// adjacent columns that one 16-byte load brings (4 of float, 8 of bf16,
// coalesced along the weight row) and one of KS interleaved slices of the
// K axis (8 for float, 16 for bf16), each thread with UNROLL rows in
// flight. The slices' partial sums meet in shared memory and are added in
// a fixed order, one output element per thread, so a result does not
// change from run to run. An input that is a one-hot per group of C
// classes is given by its classes and becomes a sum of S weight rows.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace obs {

constexpr int R = 2;             // Rows per block.
constexpr int NT = 1024;         // Threads per block.
constexpr int NW = NT / 32;      // Warps per block.
constexpr int PASS = 512;        // Columns per pass of dense().
constexpr int MAXL = 8;          // Most prior layers.
constexpr int UNROLL = 16;       // Weight rows in flight per thread.

// How dense() splits a pass among the threads for weights of type T.
template <typename T>
struct Tile {
  static constexpr int V = 16 / sizeof(T);  // Adjacent columns per thread.
  static constexpr int CG = PASS / V;       // Column groups per pass.
  static constexpr int KS = NT / CG;        // Slices of the K axis.
};
// Floats of dense()'s scratch, sized for the narrowest type (bf16).
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

// The V adjacent weights of one 16-byte load; p is aligned to 16 bytes.
template <int V> struct Vec { float v[V]; };
__device__ __forceinline__ Vec<4> load_v(const float* p) {
  const float4 w = *reinterpret_cast<const float4*>(p);
  return {{w.x, w.y, w.z, w.w}};
}
__device__ __forceinline__ Vec<8> load_v(const __nv_bfloat16* p) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const unsigned words[4] = {raw.x, raw.y, raw.z, raw.w};
  Vec<8> out;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&words[i]));
    out.v[2 * i] = f.x;
    out.v[2 * i + 1] = f.y;
  }
  return out;
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

// One input of a product. X: [K][R] in shared memory. idx: the classes
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

template <typename T>
__device__ __forceinline__ void accumulate(float (&acc)[Tile<T>::V][R],
                                           const In<T>& in, int C, int N,
                                           int n, int ks) {
  constexpr int V = Tile<T>::V, KS = Tile<T>::KS;
  if (in.idx) {
    float g[V][R];
#pragma unroll
    for (int c = 0; c < V; ++c)
#pragma unroll
      for (int r = 0; r < R; ++r) g[c][r] = 0.f;
    const int S = in.K / C;
    for (int s = ks; s < S; s += KS) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int k = s * C + in.idx[s * R + r];
        const Vec<V> w = load_v(in.W + (size_t)k * N + n);
#pragma unroll
        for (int c = 0; c < V; ++c) g[c][r] += w.v[c];
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float sc = in.scale ? in.scale[r] : 1.f;
#pragma unroll
      for (int c = 0; c < V; ++c) acc[c][r] = fmaf(sc, g[c][r], acc[c][r]);
    }
  } else {
#pragma unroll UNROLL
    for (int k = ks; k < in.K; k += KS) {
      const Vec<V> w = load_v(in.W + (size_t)k * N + n);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float x = in.X[k * R + r];
#pragma unroll
        for (int c = 0; c < V; ++c) acc[c][r] = fmaf(x, w.v[c], acc[c][r]);
      }
    }
  }
}

// Y[n][r] = a.X @ a.W (+ b.X @ b.W) (+ bias[n]) (+ addend[n][r]). N is a
// multiple of 8. Y must be none of the inputs; addend may be Y. scratch
// holds SCRATCH floats. Ends with a barrier.
template <typename T>
__device__ void dense(float* Y, int N, const In<T>& a, const In<T>& b, int C,
                      const T* bias, const float* addend, float* scratch) {
  constexpr int V = Tile<T>::V, CG = Tile<T>::CG, KS = Tile<T>::KS;
  const int cg = threadIdx.x % CG, ks = threadIdx.x / CG;
  for (int base = 0; base < N; base += PASS) {
    const int n = base + V * cg;
    if (n < N) {
      float acc[V][R];
#pragma unroll
      for (int c = 0; c < V; ++c)
#pragma unroll
        for (int r = 0; r < R; ++r) acc[c][r] = 0.f;
      accumulate<T>(acc, a, C, N, n, ks);
      if (b.W) accumulate<T>(acc, b, C, N, n, ks);
      float* s = scratch + ((size_t)ks * PASS + V * cg) * R;
#pragma unroll
      for (int c = 0; c < V; ++c)
#pragma unroll
        for (int r = 0; r < R; ++r) s[c * R + r] = acc[c][r];
    }
    __syncthreads();
    // One output element per thread: the slices' partials in order.
    for (int e = threadIdx.x; e < PASS * R; e += NT) {
      const int col = base + e / R;
      if (col < N) {
        float v = 0.f;
#pragma unroll
        for (int j = 0; j < KS; ++j) v += scratch[(size_t)j * PASS * R + e];
        if (bias) v += to_f(bias[col]);
        if (addend) v += addend[col * R + e % R];
        Y[col * R + e % R] = v;
      }
    }
    __syncthreads();
  }
}

// Sum over the block of the threads' partials v, separately for each row:
// a thread's partial belongs to row threadIdx.x % R. red: NW * R floats.
__device__ __forceinline__ float row_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o >= R; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  __syncthreads();  // An earlier call's readers are done with red.
  if (lane < R) red[warp * R + lane] = v;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < NW; ++w) total += red[w * R + threadIdx.x % R];
  return total;
}

// LayerNorm (eps 1e-3) over Z [N][R]. Writes xhat to `xhat` and the rows'
// 1/std to `inv` [R] where given, and to `act` where given the output
// xhat * scale + bias, through ELU when `use_elu`. xhat and act may be Z.
// Ends with a barrier.
template <typename T>
__device__ void ln_fwd(const float* Z, int N, const T* scale, const T* bias,
                       float* xhat, float* inv, bool use_elu, float* act,
                       float* red) {
  const int tid = threadIdx.x, total = N * R;
  float s = 0.f;
  for (int i = tid; i < total; i += NT) s += Z[i];
  const float mean = row_sum(s, red) / N;
  float v = 0.f;
  for (int i = tid; i < total; i += NT) {
    const float d = Z[i] - mean;
    v += d * d;
  }
  const float iv = rsqrtf(row_sum(v, red) / N + 1e-3f);
  for (int i = tid; i < total; i += NT) {
    const float xh = (Z[i] - mean) * iv;
    if (act) {
      const float n = xh * to_f(scale[i / R]) + to_f(bias[i / R]);
      act[i] = use_elu ? elu(n) : n;
    }
    if (xhat) xhat[i] = xh;
  }
  if (inv && tid < R) inv[tid] = iv;
  __syncthreads();
}

// In place over G [N][R]: the gradient dn at a LayerNorm's output becomes
// the gradient dz at its input. Ends with a barrier.
template <typename T>
__device__ void ln_bwd(float* G, int N, const float* xhat, const float* inv,
                       const T* scale, float* red) {
  const int tid = threadIdx.x, total = N * R;
  float s1 = 0.f, s2 = 0.f;
  for (int i = tid; i < total; i += NT) {
    const float dx = G[i] * to_f(scale[i / R]);
    s1 += dx;
    s2 += dx * xhat[i];
  }
  const float m1 = row_sum(s1, red) / N;
  const float m2 = row_sum(s2, red) / N;
  const float iv = inv[tid % R];
  for (int i = tid; i < total; i += NT) {
    const float dx = G[i] * to_f(scale[i / R]);
    G[i] = iv * (dx - m1 - xhat[i] * m2);
  }
  __syncthreads();
}

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

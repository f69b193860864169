// LayerNorm with its casts and the activation after it, forward and
// backward, for Hopper (sm_90a).
//
// Replaces the loop fusion that XLA makes of the JAX package's Norm
// (daydreamer_tpu/nn/layers.py:140-160: upcast to float32, two-pass mean
// and variance, rsqrt, scale and bias, downcast) with the ELU that follows
// it in a layer. Eagerly that is five or more kernels a way, each reading
// and writing whole tensors (the upcast, the norm, the downcast, the ELU;
// backward their gradients and the columns' sums), about 24 bytes a value
// forward in bfloat16; here it is one pass: x in, y out, 4 bytes a value.
//
// Forward, one row of C values:
//   mean = sum(x) / C, var = sum((x - mean)^2) / C   (float32, two passes
//   over the row held in registers), rstd = rsqrt(var + eps),
//   n = round_T((x - mean) * rstd * scale + bias),
//   y = act == elu ? round_T(n > 0 ? n : expm1(n)) : n;
// it writes y and the row's mean and rstd.
// Backward: the pre-activation n recomputed from x, mean, rstd, scale and
// bias; dn = round_T(n > 0 ? dy : dy * exp(n)) for the ELU (autograd of
// F.elu in T rounds so), else dy; then in float32
//   xhat = (x - mean) * rstd, g = dn * scale,
//   dx = rstd * (g - mean(g) - xhat * mean(g * xhat)),
//   dscale = sum over rows of dn * xhat, dbias = sum over rows of dn.
// Each block sums its rows' dscale and dbias into one row of partial sums
// in a fixed order; ln_param_grads sums those rows in a fixed order. No
// atomic add: the same inputs give the same bits in any launch.
//
// Layout: a group of G lanes takes a row, G the power of two >= the row's
// vectors and at most a warp, so that a group's sums are warp shuffles.
// Each lane loads 16-byte vectors (VEC = 8 bfloat16 or 4 float32 values; 1
// value where C is no multiple of that) and keeps its N of them in
// registers between the passes, so x is read from memory once; the
// backward keeps dy too (overwritten in its first pass with the gradient
// at the norm's output, a value of T), and the sums of its N * VEC columns
// of dscale and dbias over its rows; scale and bias are read as 16-byte
// vectors. N is one of 1, 2, 3, 4, 6, 8, 12 and 16, with at
// most 64 values a lane in bfloat16 and 48 in float32 (about 200 registers
// in the backward): a warp takes rows of up to 2 048 bfloat16 or 1 536
// float32 values (512 where C is no multiple of a vector), every width of
// the xarm and a1 updates. A wider row (the GRU's norm over 3 x 1 024 of
// the default config) takes 2, 4 or 8 warps, whose sums go through shared
// memory. Rows a block of 256 threads takes at once, bfloat16: C = 64, 32
// rows (G = 8, N = 1); C = 128, 16 (G = 16); C = 256, 8 (G = 32); C = 512,
// 8 (N = 2); C = 768, 8 (N = 3); C = 1 536, 8 (N = 6); C = 3 072, 4 (G =
// 64, N = 6); float32: C = 64, 16 (G = 16); C = 512, 8 (N = 4); C = 1 536,
// 8 (N = 12). The forward gives each group one row; the backward gives
// each block a run of rows (at most BWD_BLOCKS blocks, a multiple of its
// groups a block), so that its partial sums stay few.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void narrow(float x, float* out) { *out = x; }
__device__ __forceinline__ void narrow(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16(x);
}
template <class T>
__device__ __forceinline__ float rounded(float x) {
  T t;
  narrow(x, &t);
  return widen(t);
}

template <class T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

struct Shape {
  int rows, C, nvec, G, groups, act;
};

// The sum of `s` over a group of G lanes (a power of two, the group
// aligned in its warp, or G / 32 whole warps); every lane of the group
// gets the same bits. `red`: WARPS floats of shared memory. Every lane of
// the warp calls it, and every thread of the block where G > 32.
__device__ __forceinline__ float group_sum(float s, int G, float* red) {
  for (int o = (G < 32 ? G : 32) / 2; o > 0; o >>= 1)
    s += __shfl_xor_sync(FULL, s, o);
  if (G > 32) {
    __syncthreads();  // The last call's readers are done with `red`.
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
    __syncthreads();
    const int first = (int)threadIdx.x / G * (G / 32);
    s = 0.f;
    for (int w = 0; w < G / 32; ++w) s += red[first + w];
  }
  return s;
}

// VEC float32 values from p (16-byte aligned where VEC is a multiple of 4).
template <int VEC>
__device__ __forceinline__ void load_vec(const float* __restrict__ p,
                                         float* out) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int k = 0; k < VEC; k += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + k);
      out[k] = q.x;
      out[k + 1] = q.y;
      out[k + 2] = q.z;
      out[k + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) out[k] = p[k];
  }
}

template <class T, int VEC, int N>
__global__ void __launch_bounds__(256)
    ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, T* __restrict__ y,
                  float* __restrict__ mean_out, float* __restrict__ rstd_out,
                  Shape s, float eps) {
  extern __shared__ __align__(16) float smem[];
  const int sub = threadIdx.x % s.G, group = threadIdx.x / s.G;
  const long row = (long)blockIdx.x * s.groups + group;
  const bool valid = row < s.rows;
  const long base = valid ? row * s.C : 0;
  Pack<T, VEC> xv[N];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int j = i * s.G + sub;
    if (valid && j < s.nvec) {
      xv[i] = *reinterpret_cast<const Pack<T, VEC>*>(x + base + j * VEC);
#pragma unroll
      for (int k = 0; k < VEC; ++k) sum += widen(xv[i].v[k]);
    }
  }
  const float mean = group_sum(sum, s.G, smem) / s.C;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int j = i * s.G + sub;
    if (valid && j < s.nvec) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float d = widen(xv[i].v[k]) - mean;
        sq += d * d;
      }
    }
  }
  const float rstd = rsqrtf(group_sum(sq, s.G, smem) / s.C + eps);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int j = i * s.G + sub;
    if (valid && j < s.nvec) {
      Pack<T, VEC> out;
      float sc[VEC], bi[VEC];
      load_vec<VEC>(scale + j * VEC, sc);
      load_vec<VEC>(bias + j * VEC, bi);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float xhat = (widen(xv[i].v[k]) - mean) * rstd;
        float n = rounded<T>(xhat * sc[k] + bi[k]);
        if (s.act) n = n > 0.f ? n : expm1f(n);
        narrow(n, &out.v[k]);
      }
      *reinterpret_cast<Pack<T, VEC>*>(y + base + j * VEC) = out;
    }
  }
  if (valid && sub == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

template <class T, int VEC, int N>
__global__ void __launch_bounds__(256)
    ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias,
                  const float* __restrict__ mean,
                  const float* __restrict__ rstd, const T* __restrict__ dy,
                  T* __restrict__ dx, float* __restrict__ partial, Shape s,
                  int rows_per_block) {
  // WARPS floats for group_sum, then the slab of the partial sums: two
  // halves (dscale, dbias) of [groups][G * VEC].
  extern __shared__ __align__(16) float smem[];
  float* slab = smem + WARPS;
  const int sub = threadIdx.x % s.G, group = threadIdx.x / s.G;
  float acc_s[N][VEC], acc_b[N][VEC];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc_s[i][k] = acc_b[i][k] = 0.f;

  // Every group runs the same number of rows (rows_per_block is a multiple
  // of the groups), so that the lanes of a warp shuffle together.
  for (int r = group; r < rows_per_block; r += s.groups) {
    const long row = (long)blockIdx.x * rows_per_block + r;
    const bool valid = row < s.rows;
    const long base = valid ? row * s.C : 0;
    const float mu = valid ? mean[row] : 0.f;
    const float rs = valid ? rstd[row] : 0.f;
    Pack<T, VEC> xv[N], gv[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int j = i * s.G + sub;
      if (valid && j < s.nvec) {
        xv[i] = *reinterpret_cast<const Pack<T, VEC>*>(x + base + j * VEC);
        gv[i] = *reinterpret_cast<const Pack<T, VEC>*>(dy + base + j * VEC);
      }
    }
    // The gradient at the norm's rounded output, dn, a value of T, in
    // place of dy: the ELU's from the recomputed pre-activation n.
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int j = i * s.G + sub;
      if (valid && j < s.nvec) {
        float sc[VEC], bi[VEC];
        load_vec<VEC>(scale + j * VEC, sc);
        if (s.act) load_vec<VEC>(bias + j * VEC, bi);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float xhat = (widen(xv[i].v[k]) - mu) * rs;
          float dn = widen(gv[i].v[k]);
          if (s.act) {
            const float n = rounded<T>(xhat * sc[k] + bi[k]);
            if (!(n > 0.f)) {
              dn = rounded<T>(dn * expf(n));
              narrow(dn, &gv[i].v[k]);
            }
          }
          const float g = dn * sc[k];
          s1 += g;
          s2 += g * xhat;
        }
      }
    }
    const float m1 = group_sum(s1, s.G, smem) / s.C;
    const float m2 = group_sum(s2, s.G, smem) / s.C;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int j = i * s.G + sub;
      if (valid && j < s.nvec) {
        Pack<T, VEC> out;
        float sc[VEC];
        load_vec<VEC>(scale + j * VEC, sc);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float xhat = (widen(xv[i].v[k]) - mu) * rs;
          const float dn = widen(gv[i].v[k]);
          narrow(rs * (dn * sc[k] - m1 - xhat * m2), &out.v[k]);
          acc_s[i][k] += dn * xhat;
          acc_b[i][k] += dn;
        }
        *reinterpret_cast<Pack<T, VEC>*>(dx + base + j * VEC) = out;
      }
    }
  }

  // The block's partial sums, one slab of G * VEC columns at a time: each
  // lane puts its columns' sums in its group's row, then the threads sum
  // each column over the groups in order.
  const int width = s.G * VEC;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    __syncthreads();
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      slab[group * width + sub * VEC + k] = acc_s[i][k];
      slab[THREADS * VEC + group * width + sub * VEC + k] = acc_b[i][k];
    }
    __syncthreads();
    for (int t = threadIdx.x; t < 2 * width; t += THREADS) {
      const int half = t / width, col = t % width;
      float sum = 0.f;
      for (int g = 0; g < s.groups; ++g)
        sum += slab[half * THREADS * VEC + g * width + col];
      const int c = i * width + col;
      if (c < s.C) partial[((long)blockIdx.x * 2 + half) * s.C + c] = sum;
    }
  }
}

// dscale and dbias: the sums of `blocks` rows of partial sums [blocks][2]
// [C], each column over the blocks in a fixed order: 8 slices of the
// blocks, one a warp, then the slices in order. A block takes 32 columns
// of one half.
__global__ void __launch_bounds__(256)
    ln_param_grads_kernel(const float* __restrict__ partial,
                          float* __restrict__ dscale,
                          float* __restrict__ dbias, int C, int blocks) {
  extern __shared__ __align__(16) float smem[];
  const int col = threadIdx.x & 31, slice = threadIdx.x >> 5;
  const int tiles = (C + 31) / 32;
  const int half = blockIdx.x / tiles;
  const int c = (blockIdx.x % tiles) * 32 + col;
  float sum = 0.f;
  if (c < C)
    for (int b = slice; b < blocks; b += WARPS)
      sum += partial[((long)b * 2 + half) * C + c];
  smem[slice * 32 + col] = sum;
  __syncthreads();
  if (slice == 0 && c < C) {
    float total = 0.f;
    for (int w = 0; w < WARPS; ++w) total += smem[w * 32 + col];
    (half ? dbias : dscale)[c] = total;
  }
}

// The vectors a lane may keep (the kernels' N), and the values a lane
// keeps at most in T.
constexpr int NS[] = {1, 2, 3, 4, 6, 8, 12, 16};
template <class T>
constexpr int max_values() {
  return sizeof(T) == 2 ? 64 : 48;
}

// The geometry of rows of C values of T: vectors, group, groups a block.
// Returns the vectors a lane keeps (N), 0 where a row is too wide.
template <class T>
int plan(int rows, int C, int act, Shape* s, int* vec) {
  const int wide = sizeof(T) == 2 ? 8 : 4;
  *vec = C % wide == 0 ? wide : 1;
  s->rows = rows;
  s->C = C;
  s->act = act;
  s->nvec = C / *vec;
  s->G = 1;
  while (s->G < s->nvec && s->G < 32) s->G *= 2;
  for (; s->G <= THREADS; s->G *= 2) {
    s->groups = THREADS / s->G;
    const int need = (s->nvec + s->G - 1) / s->G;
    for (const int n : NS)
      if (n >= need && n * *vec <= max_values<T>()) return n;
  }
  return 0;
}

template <class T, int VEC, int N>
cudaError_t fwd(void* const* p, Shape s, float eps, cudaStream_t stream) {
  auto kernel = ln_fwd_kernel<T, VEC, N>;
  const T* x = static_cast<const T*>(p[0]);
  const float* scale = static_cast<const float*>(p[1]);
  const float* bias = static_cast<const float*>(p[2]);
  T* y = static_cast<T*>(p[3]);
  float* mean = static_cast<float*>(p[4]);
  float* rstd = static_cast<float*>(p[5]);
  const int grid = (s.rows + s.groups - 1) / s.groups;
  const size_t bytes = WARPS * sizeof(float);
  kernel<<<grid, THREADS, bytes, stream>>>(x, scale, bias, y, mean, rstd, s, eps);
  return cudaGetLastError();
}

template <class T, int VEC, int N>
cudaError_t bwd(void* const* p, Shape s, int max_blocks,
                cudaStream_t stream) {
  auto kernel = ln_bwd_kernel<T, VEC, N>;
  const T* x = static_cast<const T*>(p[0]);
  const float* scale = static_cast<const float*>(p[1]);
  const float* bias = static_cast<const float*>(p[2]);
  const float* mean = static_cast<const float*>(p[3]);
  const float* rstd = static_cast<const float*>(p[4]);
  const T* dy = static_cast<const T*>(p[5]);
  T* dx = static_cast<T*>(p[6]);
  float* partial = static_cast<float*>(p[7]);
  float* dscale = static_cast<float*>(p[8]);
  float* dbias = static_cast<float*>(p[9]);
  // Runs of rows, a multiple of the groups each, over at most max_blocks.
  const long steps = (s.rows + s.groups - 1) / s.groups;
  const long per = (steps + max_blocks - 1) / max_blocks;
  const int rows_per_block = (int)(per * s.groups);
  const int blocks = (int)((s.rows + rows_per_block - 1) / rows_per_block);
  // 16.4 KB at VEC = 8: under the 48 KB a launch may take unasked.
  const size_t bytes = (WARPS + 2 * THREADS * VEC) * sizeof(float);
  kernel<<<blocks, THREADS, bytes, stream>>>(x, scale, bias, mean, rstd, dy, dx, partial, s, rows_per_block);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto sums = ln_param_grads_kernel;
  const int grid = 2 * ((s.C + 31) / 32);
  const size_t sum_bytes = THREADS * sizeof(float);
  const int C = s.C;
  sums<<<grid, THREADS, sum_bytes, stream>>>(partial, dscale, dbias, C, blocks);
  return cudaGetLastError();
}

// One launch (forward or backward) at the plan's VEC and N.
template <class T>
cudaError_t run(bool backward, void* const* p, const int* dims, float eps,
                cudaStream_t stream) {
  Shape s;
  int vec;
  const int n = plan<T>(dims[0], dims[1], dims[2], &s, &vec);
  if (n == 0 || dims[0] <= 0) return cudaErrorInvalidValue;
#define LN_CASE(V, NN)                                                  \
  if constexpr (V * NN <= max_values<T>())                              \
    if (vec == V && n == NN)                                            \
      return backward ? bwd<T, V, NN>(p, s, dims[3], stream)            \
                      : fwd<T, V, NN>(p, s, eps, stream);
#define LN_CASES(V)                                                     \
  LN_CASE(V, 1) LN_CASE(V, 2) LN_CASE(V, 3) LN_CASE(V, 4) LN_CASE(V, 6) \
  LN_CASE(V, 8) LN_CASE(V, 12) LN_CASE(V, 16)
  if constexpr (sizeof(T) == 2) {
    LN_CASES(8)
  } else {
    LN_CASES(4)
  }
  LN_CASES(1)
#undef LN_CASES
#undef LN_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// ptrs: x, scale, bias, y, mean, rstd. dims: rows, C, act (0 none, 1
// elu), unused.
extern "C" int layer_norm_act_fwd(int bf16, void* const* ptrs,
                                  const int* dims, float eps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? run<__nv_bfloat16>(false, ptrs, dims, eps, st)
              : run<float>(false, ptrs, dims, eps, st);
}

// ptrs: x, scale, bias, mean, rstd, dy, dx, partial [max_blocks][2][C],
// dscale, dbias. dims: rows, C, act, max_blocks.
extern "C" int layer_norm_act_bwd(int bf16, void* const* ptrs,
                                  const int* dims, float eps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? run<__nv_bfloat16>(true, ptrs, dims, eps, st)
              : run<float>(true, ptrs, dims, eps, st);
}

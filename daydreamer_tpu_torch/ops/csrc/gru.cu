// The RSSM's GRU cell after its product, forward and backward, for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: it stands for the loop fusion that XLA makes
// of the JAX package's `RSSM._gru` tail (daydreamer_tpu/models/nets.py:
// 271-287) inside the scan step: the LayerNorm of the `gru_out` product
// over its 3 D columns (float32 statistics, eps, float32 scale and bias,
// rounded to the input's type), the split into reset, cand and update,
//   r = sigmoid(reset), c = tanh(r * cand), u = sigmoid(update - 1),
//   out = u * c + (1 - u) * deter,
// each elementwise result rounded to T (bfloat16 or float32) as the eager
// chain rounds it. Eagerly that is the norm's kernel and 9 elementwise
// kernels forward, about 15 and the norm's backward under autograd, each
// reading and writing whole tensors; here it is one pass each way.
//
// Backward: from the forward's x, deter, each row's mean and rstd, scale
// and bias it recomputes the norm's output n = [nr, nc, nu] and the gates,
// then follows autograd of the eager chain in T:
//   g_om = g * deter, g_deter = g * (1 - u), g_u = g * c - g_om,
//   g_c = g * u, dnu = g_u * (1 - u) * u, g_p = g_c * (1 - c * c),
//   dnr = (g_p * nc) * (1 - r) * r, dnc = g_p * r      (each rounded to T)
// and runs the LayerNorm backward on dn = [dnr, dnc, dnu] in float32, as
// layer_norm.cu does: xhat = (x - mean) * rstd, gs = dn * scale,
//   dx = rstd * (gs - mean(gs) - xhat * mean(gs * xhat)),
//   dscale = sum over rows of dn * xhat, dbias = sum over rows of dn.
//
// Both are bound by bytes (about 10 bytes a bfloat16 output value forward
// and 20 backward, against some 50 and 80 operations): the design keeps a
// row in registers between its passes so that each input is read once.
// Layout: a group of G lanes takes a row (G a power of two, a warp or up
// to 8 warps, whose sums meet in shared memory); a lane holds N vectors of
// VEC values (16 bytes, or 1 value where D is no multiple of that) of each
// of the three parts at the same columns, so the gates need no exchange,
// and at most SPREAD values a part, so that the backward's column sums
// (2 x 3 x SPREAD floats a lane) stay in registers. bfloat16 D = 256: a
// warp a row, 8 rows a block; D = 512: 2 warps a row. The forward walks
// rows by a stride of the grid; the backward's blocks each take a run of
// rows, write their column sums to a row of `partial`, and a second launch
// (gru_sum_kernel) sums those rows in block order: no float atomic, so the
// same inputs give the same bits in any launch and in a CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
// Values of each part a lane keeps at most.
constexpr int SPREAD = 8;

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

// PyTorch's sigmoid: 1 / (1 + exp(-x)) in float32.
__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

template <class T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

struct Shape {
  int rows, D, nvec, G, groups;
};

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

// The sum of `s` over a group of G lanes (a power of two, the group
// aligned in its warp, or G / 32 whole warps); every lane of the group
// gets the same bits. `red`: WARPS floats of shared memory. Every lane of
// the warp calls it, and every thread of the block where G > 32. (As in
// layer_norm.cu.)
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

// A lane's vectors of one part of a row: the N vectors j = i * G + sub
// below nvec, from `base` (the part's first value in the row).
template <class T, int VEC, int N>
__device__ __forceinline__ void load_part(Pack<T, VEC> (&v)[N],
                                          const T* __restrict__ base,
                                          const Shape& s, int sub) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int j = i * s.G + sub;
    if (j < s.nvec)
      v[i] = *reinterpret_cast<const Pack<T, VEC>*>(base + j * VEC);
  }
}

// The gates of one column from the norm's rounded outputs: r, c, u and
// 1 - u, each rounded to T.
template <class T>
struct Gates {
  float r, c, u, om;
  __device__ __forceinline__ Gates(float nr, float nc, float nu) {
    r = rounded<T>(sigmoid(nr));
    c = rounded<T>(tanhf(rounded<T>(r * nc)));
    u = rounded<T>(sigmoid(rounded<T>(nu - 1.f)));
    om = rounded<T>(1.f - u);
  }
};

template <class T, int VEC, int N>
__global__ void __launch_bounds__(256)
    gru_fwd_kernel(const T* __restrict__ x, const T* __restrict__ deter,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias, T* __restrict__ out,
                   float* __restrict__ mean_out, float* __restrict__ rstd_out,
                   Shape s, float eps) {
  extern __shared__ __align__(16) float smem[];  // WARPS floats: group_sum.
  const int sub = threadIdx.x % s.G, group = threadIdx.x / s.G;
  const int D = s.D, C3 = 3 * s.D;
  const int steps = (s.rows + s.groups - 1) / s.groups;
  // Every thread of the block runs the same steps (the lanes of a warp
  // shuffle together, the warps of a wide row meet at barriers).
  for (int st = blockIdx.x; st < steps; st += gridDim.x) {
    const int row = st * s.groups + group;
    const bool valid = row < s.rows;
    const T* xr = x + (long)row * C3;
    Pack<T, VEC> v[3][N];
    float sum = 0.f;
    if (valid) {
#pragma unroll
      for (int p = 0; p < 3; ++p) load_part<T, VEC, N>(v[p], xr + p * D, s, sub);
    }
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int i = 0; i < N; ++i)
        if (valid && i * s.G + sub < s.nvec) {
#pragma unroll
          for (int k = 0; k < VEC; ++k) sum += widen(v[p][i].v[k]);
        }
    const float mean = group_sum(sum, s.G, smem) / C3;
    float sq = 0.f;
#pragma unroll
    for (int p = 0; p < 3; ++p)
#pragma unroll
      for (int i = 0; i < N; ++i)
        if (valid && i * s.G + sub < s.nvec) {
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            const float e = widen(v[p][i].v[k]) - mean;
            sq += e * e;
          }
        }
    const float rstd = rsqrtf(group_sum(sq, s.G, smem) / C3 + eps);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int j = i * s.G + sub;
      if (!valid || j >= s.nvec) continue;
      const Pack<T, VEC> d =
          *reinterpret_cast<const Pack<T, VEC>*>(deter + (long)row * D + j * VEC);
      Pack<T, VEC> o;
      float sc[3][VEC], bi[3][VEC];
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        load_vec<VEC>(scale + p * D + j * VEC, sc[p]);
        load_vec<VEC>(bias + p * D + j * VEC, bi[p]);
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        float n[3];
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          const float xhat = (widen(v[p][i].v[k]) - mean) * rstd;
          n[p] = rounded<T>(xhat * sc[p][k] + bi[p][k]);
        }
        const Gates<T> g(n[0], n[1], n[2]);
        // Each product rounded on its own, then their sum: no fused
        // multiply-add, as the eager chain's separate kernels.
        const float a = rounded<T>(__fmul_rn(g.u, g.c));
        const float b = rounded<T>(__fmul_rn(g.om, widen(d.v[k])));
        narrow(__fadd_rn(a, b), &o.v[k]);
      }
      *reinterpret_cast<Pack<T, VEC>*>(out + (long)row * D + j * VEC) = o;
    }
    if (valid && sub == 0) {
      mean_out[row] = mean;
      rstd_out[row] = rstd;
    }
  }
}

template <class T, int VEC, int N>
__global__ void __launch_bounds__(256)
    gru_bwd_kernel(const T* __restrict__ x, const T* __restrict__ deter,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias,
                   const float* __restrict__ mean,
                   const float* __restrict__ rstd, const T* __restrict__ dout,
                   T* __restrict__ dx, T* __restrict__ ddeter,
                   float* __restrict__ partial, float* __restrict__ dscale,
                   float* __restrict__ dbias, Shape s) {
  constexpr int V = N * VEC;  // Values of a part a lane keeps.
  // 2 * WARPS floats for the group sums, then THREADS * 3 V floats: the
  // lanes' column sums, one half (dscale's, then dbias's) at a time.
  extern __shared__ __align__(16) float smem[];
  float* sums = smem + 2 * WARPS;
  const int sub = threadIdx.x % s.G, group = threadIdx.x / s.G;
  const int D = s.D, C3 = 3 * s.D;
  const int steps = (s.rows + s.groups - 1) / s.groups;
  // A run of consecutive steps a block.
  const int per = (steps + gridDim.x - 1) / gridDim.x;
  const int first = blockIdx.x * per;
  const int last = first + per < steps ? first + per : steps;
  float acc_s[3 * V], acc_b[3 * V];
#pragma unroll
  for (int e = 0; e < 3 * V; ++e) acc_s[e] = acc_b[e] = 0.f;

  for (int st = first; st < last; ++st) {
    const int row = st * s.groups + group;
    const bool valid = row < s.rows;
    Pack<T, VEC> v[3][N], dn[3][N];
    float mu = 0.f, rs = 0.f;
    if (valid) {
#pragma unroll
      for (int p = 0; p < 3; ++p)
        load_part<T, VEC, N>(v[p], x + (long)row * C3 + p * D, s, sub);
      mu = mean[row];
      rs = rstd[row];
    }
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int j = i * s.G + sub;
      if (!valid || j >= s.nvec) continue;
      const long at = (long)row * D + j * VEC;
      const Pack<T, VEC> d = *reinterpret_cast<const Pack<T, VEC>*>(deter + at);
      const Pack<T, VEC> go = *reinterpret_cast<const Pack<T, VEC>*>(dout + at);
      Pack<T, VEC> dd;
      float sc[3][VEC], bi[3][VEC];
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        load_vec<VEC>(scale + p * D + j * VEC, sc[p]);
        load_vec<VEC>(bias + p * D + j * VEC, bi[p]);
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        float xhat[3], n[3];
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          xhat[p] = (widen(v[p][i].v[k]) - mu) * rs;
          n[p] = rounded<T>(xhat[p] * sc[p][k] + bi[p][k]);
        }
        const Gates<T> gt(n[0], n[1], n[2]);
        const float g = widen(go.v[k]);
        const float g_om = rounded<T>(g * widen(d.v[k]));
        narrow(g * gt.om, &dd.v[k]);
        const float g_u = rounded<T>(rounded<T>(g * gt.c) - g_om);
        const float g_c = rounded<T>(g * gt.u);
        const float g_p = rounded<T>(g_c * (1.f - gt.c * gt.c));
        const float g_r = rounded<T>(g_p * n[1]);
        float dnv[3];
        dnv[0] = rounded<T>(g_r * (1.f - gt.r) * gt.r);
        dnv[1] = rounded<T>(g_p * gt.r);
        dnv[2] = rounded<T>(g_u * (1.f - gt.u) * gt.u);
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          narrow(dnv[p], &dn[p][i].v[k]);
          const float gs = dnv[p] * sc[p][k];
          s1 += gs;
          s2 += gs * xhat[p];
        }
      }
      *reinterpret_cast<Pack<T, VEC>*>(ddeter + at) = dd;
    }
    s1 = group_sum(s1, s.G, smem);
    s2 = group_sum(s2, s.G, smem + WARPS);
    const float m1 = s1 / C3, m2 = s2 / C3;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int j = i * s.G + sub;
      if (!valid || j >= s.nvec) continue;
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        float sc[VEC];
        load_vec<VEC>(scale + p * D + j * VEC, sc);
        Pack<T, VEC> o;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float xhat = (widen(v[p][i].v[k]) - mu) * rs;
          const float dnv = widen(dn[p][i].v[k]);
          narrow(rs * (dnv * sc[k] - m1 - xhat * m2), &o.v[k]);
          acc_s[(p * N + i) * VEC + k] += dnv * xhat;
          acc_b[(p * N + i) * VEC + k] += dnv;
        }
        *reinterpret_cast<Pack<T, VEC>*>(dx + (long)row * C3 + p * D +
                                         j * VEC) = o;
      }
    }
  }

  // The block's sums: each column over the block's groups in order, into
  // dscale and dbias where the grid is one block, else into the block's
  // row of `partial` (dscale's 3 D columns, then dbias's).
  const int P = 2 * C3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    __syncthreads();  // The last half's readers are done with `sums`.
#pragma unroll
    for (int e = 0; e < 3 * V; ++e)
      sums[e * THREADS + threadIdx.x] = half ? acc_b[e] : acc_s[e];
    __syncthreads();
    for (int c = threadIdx.x; c < C3; c += THREADS) {
      const int p = c / D, col = c % D;
      const int j = col / VEC, k = col % VEC;
      const int i = j / s.G, lane = j % s.G;
      const int e = (p * N + i) * VEC + k;
      float sum = 0.f;
      for (int g = 0; g < s.groups; ++g)
        sum += sums[e * THREADS + g * s.G + lane];
      if (gridDim.x == 1)
        (half ? dbias : dscale)[c] = sum;
      else
        partial[(long)blockIdx.x * P + half * C3 + c] = sum;
    }
  }
}

// dscale and dbias: the blocks' rows of `partial` summed in block order,
// a thread a column.
__global__ void __launch_bounds__(256)
    gru_sum_kernel(const float* __restrict__ partial, int blocks, int C3,
                   float* __restrict__ dscale, float* __restrict__ dbias) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= 2 * C3) return;
  float sum = 0.f;
  for (int b = 0; b < blocks; ++b) sum += partial[(long)b * 2 * C3 + c];
  if (c < C3)
    dscale[c] = sum;
  else
    dbias[c - C3] = sum;
}

// The vectors a lane may keep of a part (the kernels' N).
constexpr int NS[] = {1, 2, 4, 8};

// The geometry of rows of D values a part of T: vectors, group, groups a
// block. Returns the vectors a lane keeps of a part (N), 0 where D is
// wider than THREADS lanes of SPREAD values.
template <class T>
int plan(int rows, int D, Shape* s, int* vec) {
  const int wide = 16 / (int)sizeof(T);
  *vec = D % wide == 0 ? wide : 1;
  s->rows = rows;
  s->D = D;
  s->nvec = D / *vec;
  int first = 1;
  while (first < s->nvec && first < 32) first *= 2;
  for (s->G = first; s->G <= THREADS; s->G *= 2) {
    s->groups = THREADS / s->G;
    const int need = (s->nvec + s->G - 1) / s->G;
    for (const int n : NS)
      if (n >= need && n * *vec <= SPREAD) return n;
  }
  return 0;
}

// dims: rows, D, max_blocks.
template <class T, int VEC, int N>
cudaError_t fwd(void* const* p, Shape s, const int* dims, float eps,
                cudaStream_t stream) {
  auto kernel = gru_fwd_kernel<T, VEC, N>;
  const size_t bytes = WARPS * sizeof(float);
  const long steps = ((long)s.rows + s.groups - 1) / s.groups;
  const int grid = (int)std::min<long>(steps, dims[2]);
  kernel<<<grid, THREADS, bytes, stream>>>(static_cast<const T*>(p[0]), static_cast<const T*>(p[1]), static_cast<const float*>(p[2]), static_cast<const float*>(p[3]), static_cast<T*>(p[4]), static_cast<float*>(p[5]), static_cast<float*>(p[6]), s, eps);
  return cudaGetLastError();
}

// dims: rows, D, max_blocks, rows of `partial`.
template <class T, int VEC, int N>
cudaError_t bwd(void* const* p, Shape s, const int* dims,
                cudaStream_t stream) {
  auto kernel = gru_bwd_kernel<T, VEC, N>;
  // At most 24.6 KB: no attribute is needed below 48 KB.
  const size_t bytes = (2 * WARPS + 3 * N * VEC * THREADS) * sizeof(float);
  const long steps = ((long)s.rows + s.groups - 1) / s.groups;
  // Blocks of equal runs of steps, none empty.
  int grid = (int)std::min<long>(steps, dims[2]);
  const long per = (steps + grid - 1) / grid;
  grid = (int)((steps + per - 1) / per);
  if (grid > dims[3]) return cudaErrorInvalidValue;
  float* partial = static_cast<float*>(p[8]);
  float* dscale = static_cast<float*>(p[9]);
  float* dbias = static_cast<float*>(p[10]);
  kernel<<<grid, THREADS, bytes, stream>>>(static_cast<const T*>(p[0]), static_cast<const T*>(p[1]), static_cast<const float*>(p[2]), static_cast<const float*>(p[3]), static_cast<const float*>(p[4]), static_cast<const float*>(p[5]), static_cast<const T*>(p[6]), static_cast<T*>(p[7]), static_cast<T*>(p[11]), partial, dscale, dbias, s);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || grid == 1) return err;
  const int C3 = 3 * s.D, sum_grid = (2 * C3 + THREADS - 1) / THREADS;
  gru_sum_kernel<<<sum_grid, THREADS, 0, stream>>>(partial, grid, C3, dscale, dbias);
  return cudaGetLastError();
}

// One launch (forward or backward) at the plan's VEC and N.
template <class T>
cudaError_t run(bool backward, void* const* p, const int* dims, float eps,
                cudaStream_t stream) {
  Shape s;
  int vec;
  const int n = plan<T>(dims[0], dims[1], &s, &vec);
  if (n == 0 || dims[0] <= 0 || dims[2] <= 0) return cudaErrorInvalidValue;
#define GRU_CASE(V, NN)                                                 \
  if constexpr (V * NN <= SPREAD)                                       \
    if (vec == V && n == NN)                                            \
      return backward ? bwd<T, V, NN>(p, s, dims, stream)               \
                      : fwd<T, V, NN>(p, s, dims, eps, stream);
#define GRU_CASES(V) GRU_CASE(V, 1) GRU_CASE(V, 2) GRU_CASE(V, 4) GRU_CASE(V, 8)
  if constexpr (sizeof(T) == 2) {
    GRU_CASES(8)
  } else {
    GRU_CASES(4)
  }
  GRU_CASES(1)
#undef GRU_CASES
#undef GRU_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// ptrs: x [rows][3 D], deter [rows][D], scale [3 D], bias [3 D], out
// [rows][D], mean [rows], rstd [rows]. dims: rows, D, max_blocks.
extern "C" int gru_cell_fwd(int bf16, void* const* ptrs, const int* dims,
                            float eps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? run<__nv_bfloat16>(false, ptrs, dims, eps, st)
              : run<float>(false, ptrs, dims, eps, st);
}

// ptrs: x, deter, scale, bias, mean, rstd, dout [rows][D], dx [rows][3 D],
// partial [rows of partial][6 D], dscale [3 D], dbias [3 D], ddeter
// [rows][D]. dims: rows, D, max_blocks, rows of partial.
extern "C" int gru_cell_bwd(int bf16, void* const* ptrs, const int* dims,
                            float eps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? run<__nv_bfloat16>(true, ptrs, dims, eps, st)
              : run<float>(true, ptrs, dims, eps, st);
}

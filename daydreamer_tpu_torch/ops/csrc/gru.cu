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
// Across the card both are bound by bytes (about 10 bytes a bfloat16
// output value forward and 20 backward) more than by their operations
// (some 50 and 180 a column of the three parts: the gates' exp, tanh and
// divides, and a dozen roundings to T); on a few SMs the backward's
// operations bound it (one cluster of 16 SMs took 1 024 rows in 3x the
// time of 128 blocks). The design keeps a row in registers between its
// passes so that each input is read once. Layout: a group of G lanes
// takes a row (G a power of two, up to 8 warps, whose sums meet in shared
// memory); a lane holds N vectors of VEC values of each of the three parts
// at the same columns, so the gates need no exchange.
//
// The forward: its group is at least a warp (or the row's vectors, where
// fewer), and wider where the rows x G fall short of the caller's count of
// lanes, with the widest vector that leaves no lane of the group without
// one: a1's 1 024 rows of 256 take a warp a row and 16-byte vectors,
// xarm's 1 024 rows of 512 two warps, 1 and 32 rows 8 warps and one or two
// values a vector, so that few rows run few columns a lane. A group that
// spans warps takes a block of its own (else blocks of 256 threads, each
// walking rows by the grid's stride). At 1 024 rows bfloat16 ran slower
// than float32 with half the bytes: by count, its some 12 roundings a
// column, each a conversion instruction at a quarter of a multiply's rate;
// so bfloat16 values round in pairs, one conversion instruction for two
// (the same bits). A lane loads its scale and bias once, before its first
// row's x, and holds them for every row it takes (the same columns); a
// row's deter follows the row sums, beside its use. Issued with x, before
// the sums, deter cost 5 % at 1 024 rows of 512 float32, gained 2-7 % at 1
// and 32 rows of float32 and nothing in bfloat16; scale and bias after the
// sums cost 3-19 % at 1 and 32 rows.
//
// The backward is one launch of blocks of 256 threads. Its group is the
// narrowest (at that width the widest vector, at most SPREAD values a part
// a lane) whose rows x G reach the caller's count of lanes, so that few
// rows spread over more lanes: a1's 1 024 rows of 256 take a warp a row
// and 16-byte vectors, its 32 rows 4 warps a row and 4-byte vectors, 1 row
// 8 warps. Each block takes a run of steps of rows and keeps its lanes'
// 2 x 3 x V column sums in registers, and a fixed-order tree over its
// groups sums them. One block writes
// dscale and dbias itself; up to 16 blocks make one cluster (beside each
// other on the card), whose ranks each sum a share of the columns over the
// ranks in rank order through distributed shared memory; more make a
// cooperative grid (all its blocks on the card at once), whose blocks
// write their sums to rows of `partial`, meet at a barrier in global
// memory and each sum a share of the columns over the rows in block order.
// No second launch and no float atomic: the same inputs give the same bits
// in any launch and in a CUDA graph.
//
// Two paths take what that layout does not. Without a norm (`norm: none`)
// the gates read x itself: one elementwise kernel each way, a thread a
// vector of columns, with no row or column sums (gru_bare_*_kernel). A deter
// past MAX_D = 2 048 (3 D values, more than 256 lanes of SPREAD values
// hold) takes, forward, a block of up to 1 024 threads a row at a time
// over a run of rows, each row read once and kept in registers, scale and
// bias held in shared memory for every row (gru_block_fwd_kernel, below;
// for many rows where a thread would keep few values of a row, and where
// no block holds one, gru_wide_fwd_kernel: a block a row that streams the
// row from memory in three passes), and backward a cluster
// of 8 blocks, 16 where 8 hold too little (gru_cluster_bwd_kernel, with
// row_cluster.cuh): the cluster takes a run of rows and each lane of the
// cluster the same columns of the three parts, of deter, dout and ddeter
// in every row, so that a row is read from memory once and kept in
// registers (at most 16 bytes of a part a lane: deters of up to 32 768
// bfloat16 or 16 384 float32 values at 16 blocks of 256 threads); the
// rows' sums meet through distributed shared memory, a batch of rows a
// cluster barrier with the next batch's loads in flight, and the columns'
// sums in one row of `partial` a cluster, summed in a fixed order by the
// blocks that draw the last tickets (two levels where clusters take
// several rows; no cooperative grid, no barrier in global memory). What
// bounded the streaming backward before it (a block a row on 128 blocks,
// each row read twice with its gradient parked in dx, a block barrier a
// row, a row of `partial` a block) and what bounds this one are in
// PERF.md. Deters wider than the cluster backward takes (or where the
// caller gives no cluster) take that streaming backward
// (gru_wide_bwd_kernel): two passes over memory, its blocks' column sums
// in rows of `partial` summed in block order by a cooperative grid as
// above.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper_ptx.cuh"
#include "row_cluster.cuh"

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

// The P values of v (1 or 2) rounded to T, as rounded<T> rounds each:
// bfloat16 pairs in one conversion instruction (the card issues
// conversions at a quarter of a multiply's rate, and the forward has some
// 12 a column).
template <class T, int P>
__device__ __forceinline__ void round_all(float (&v)[P]) {
  if constexpr (sizeof(T) == 2 && P == 2) {
    const float2 f =
        __bfloat1622float2(__floats2bfloat162_rn(v[0], v[1]));
    v[0] = f.x;
    v[1] = f.y;
  } else {
#pragma unroll
    for (int q = 0; q < P; ++q) v[q] = rounded<T>(v[q]);
  }
}

// The P values of v rounded to T, stored at out.
template <class T, int P>
__device__ __forceinline__ void narrow_all(const float (&v)[P], T* out) {
  if constexpr (sizeof(T) == 2 && P == 2) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[0], v[1]);
    out[0] = h.x;
    out[1] = h.y;
  } else {
#pragma unroll
    for (int q = 0; q < P; ++q) narrow(v[q], &out[q]);
  }
}

// The gates of P columns (1 or 2) from the norm's rounded outputs n[0..2]
// (reset, cand, update): r, c, u and 1 - u, each rounded to T as
// gru_cell_plain rounds it (round_all: bfloat16 pairs in one conversion).
template <class T, int P>
struct Gates {
  float r[P], c[P], u[P], om[P];
  __device__ __forceinline__ explicit Gates(const float (&n)[3][P]) {
#pragma unroll
    for (int q = 0; q < P; ++q) r[q] = sigmoid(n[0][q]);
    round_all<T, P>(r);
#pragma unroll
    for (int q = 0; q < P; ++q) c[q] = r[q] * n[1][q];
    round_all<T, P>(c);
#pragma unroll
    for (int q = 0; q < P; ++q) c[q] = tanhf(c[q]);
    round_all<T, P>(c);
#pragma unroll
    for (int q = 0; q < P; ++q) u[q] = n[2][q] - 1.f;
    round_all<T, P>(u);
#pragma unroll
    for (int q = 0; q < P; ++q) u[q] = sigmoid(u[q]);
    round_all<T, P>(u);
#pragma unroll
    for (int q = 0; q < P; ++q) om[q] = 1.f - u[q];
    round_all<T, P>(om);
  }
};

// The new deter of one column from its three gate inputs n (the norm's
// rounded outputs, or x itself without a norm) and the previous deter, as
// gru_fwd_kernel computes it in pairs.
template <class T>
__device__ __forceinline__ float cell(const float (&n)[3][1], float d) {
  const Gates<T, 1> g(n);
  return __fadd_rn(rounded<T>(__fmul_rn(g.u[0], g.c[0])),
                   rounded<T>(__fmul_rn(g.om[0], d)));
}

// The gradients of one column, following autograd of the eager chain in T
// (see the head of the file): from the gate inputs n, the new deter's
// gradient g and the previous deter d, the gradients at n (each rounded to
// T) and at d (to be rounded by the caller).
template <class T>
__device__ __forceinline__ void cell_grad(const float (&n)[3][1], float g,
                                          float d, float (&dn)[3],
                                          float* dd) {
  const Gates<T, 1> g1(n);
  const float r = g1.r[0], c = g1.c[0], u = g1.u[0];
  const float g_om = rounded<T>(g * d);
  *dd = g * g1.om[0];
  const float g_u = rounded<T>(rounded<T>(g * c) - g_om);
  const float g_c = rounded<T>(g * u);
  const float g_p = rounded<T>(g_c * (1.f - c * c));
  const float g_r = rounded<T>(g_p * n[1][0]);
  dn[0] = rounded<T>(g_r * (1.f - r) * r);
  dn[1] = rounded<T>(g_p * r);
  dn[2] = rounded<T>(g_u * (1.f - u) * u);
}

// cell_grad of P columns (1 or 2) at once, the same roundings in the same
// order (row_cluster::round_pair: bfloat16 pairs in one conversion
// instruction).
template <class T, int P>
__device__ __forceinline__ void cell_grad_pair(const float (&n)[3][P],
                                               const float (&g)[P],
                                               const float (&d)[P],
                                               float (&dn)[3][P],
                                               float (&dd)[P]) {
  const Gates<T, P> ga(n);
  float g_om[P], g_u[P], g_c[P], g_p[P], g_r[P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    g_om[q] = g[q] * d[q];
    dd[q] = g[q] * ga.om[q];
    g_u[q] = g[q] * ga.c[q];
    g_c[q] = g[q] * ga.u[q];
  }
  row_cluster::round_pair<T, P>(g_om);
  row_cluster::round_pair<T, P>(g_u);
  row_cluster::round_pair<T, P>(g_c);
#pragma unroll
  for (int q = 0; q < P; ++q) {
    g_u[q] -= g_om[q];
    g_p[q] = g_c[q] * (1.f - ga.c[q] * ga.c[q]);
  }
  row_cluster::round_pair<T, P>(g_u);
  row_cluster::round_pair<T, P>(g_p);
#pragma unroll
  for (int q = 0; q < P; ++q) {
    g_r[q] = g_p[q] * n[1][q];
    dn[1][q] = g_p[q] * ga.r[q];
    dn[2][q] = g_u[q] * (1.f - ga.u[q]) * ga.u[q];
  }
  row_cluster::round_pair<T, P>(g_r);
#pragma unroll
  for (int q = 0; q < P; ++q) dn[0][q] = g_r[q] * (1.f - ga.r[q]) * ga.r[q];
#pragma unroll
  for (int p = 0; p < 3; ++p) row_cluster::round_pair<T, P>(dn[p]);
}

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
  // The lane's scale and bias: the same columns in every row it takes,
  // loaded once.
  float sc[3][N][VEC], bi[3][N][VEC];
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int j = i * s.G + sub;
      if (j < s.nvec) {
        load_vec<VEC>(scale + p * D + j * VEC, sc[p][i]);
        load_vec<VEC>(bias + p * D + j * VEC, bi[p][i]);
      }
    }
  // Every thread of the block runs the same steps (the lanes of a warp
  // shuffle together, the warps of a wide row meet at barriers).
  for (int st = blockIdx.x; st < steps; st += gridDim.x) {
    const int row = st * s.groups + group;
    const bool valid = row < s.rows;
    Pack<T, VEC> v[3][N];
    if (valid) {
#pragma unroll
      for (int p = 0; p < 3; ++p)
        load_part<T, VEC, N>(v[p], x + (long)row * C3 + p * D, s, sub);
    }
    float sum = 0.f;
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
      // deter after the sums, beside its use (see the head of the file).
      const Pack<T, VEC> d = *reinterpret_cast<const Pack<T, VEC>*>(
          deter + (long)row * D + j * VEC);
      Pack<T, VEC> o;
      // Columns in pairs where the vector has them.
      constexpr int P = VEC % 2 == 0 ? 2 : 1;
#pragma unroll
      for (int k = 0; k < VEC; k += P) {
        float n[3][P];
#pragma unroll
        for (int p = 0; p < 3; ++p) {
#pragma unroll
          for (int q = 0; q < P; ++q) {
            const float xhat = (widen(v[p][i].v[k + q]) - mean) * rstd;
            n[p][q] = xhat * sc[p][i][k + q] + bi[p][i][k + q];
          }
          round_all<T, P>(n[p]);
        }
        const Gates<T, P> g(n);
        // Each product rounded on its own, then their sum: no fused
        // multiply-add, as the eager chain's separate kernels.
        float a[P], b[P];
#pragma unroll
        for (int q = 0; q < P; ++q) {
          a[q] = __fmul_rn(g.u[q], g.c[q]);
          b[q] = __fmul_rn(g.om[q], widen(d.v[k + q]));
        }
        round_all<T, P>(a);
        round_all<T, P>(b);
#pragma unroll
        for (int q = 0; q < P; ++q) a[q] = __fadd_rn(a[q], b[q]);
        narrow_all<T, P>(a, &o.v[k]);
      }
      *reinterpret_cast<Pack<T, VEC>*>(out + (long)row * D + j * VEC) = o;
    }
    if (valid && sub == 0) {
      mean_out[row] = mean;
      rstd_out[row] = rstd;
    }
  }
}

// Blocks of a cluster at most, where the card takes a cluster past the 8
// that are portable.
constexpr int MAX_CLUSTER = 16;

// The sums of `a` and `b` over a group of G lanes, as group_sum, with one
// pair of barriers where G spans warps. `red`: 2 x WARPS floats.
__device__ __forceinline__ void group_sum2(float* a, float* b, int G,
                                           float* red) {
  for (int o = (G < 32 ? G : 32) / 2; o > 0; o >>= 1) {
    *a += __shfl_xor_sync(FULL, *a, o);
    *b += __shfl_xor_sync(FULL, *b, o);
  }
  if (G > 32) {
    __syncthreads();  // The last call's readers are done with `red`.
    if ((threadIdx.x & 31) == 0) {
      red[threadIdx.x >> 5] = *a;
      red[WARPS + (threadIdx.x >> 5)] = *b;
    }
    __syncthreads();
    const int first = (int)threadIdx.x / G * (G / 32);
    *a = *b = 0.f;
    for (int w = 0; w < G / 32; ++w) {
      *a += red[first + w];
      *b += red[WARPS + first + w];
    }
  }
}

// Every block of the grid waits here until all have arrived; the grid is
// on the card at once (a cooperative launch). bar[0] counts the arrivals,
// bar[1] is the barrier's generation: the last to arrive resets the count
// and moves the generation on, so the two serve the next launch of any
// grid. A fence before the arrival and after the release orders the
// blocks' stores before the barrier against their loads after it.
__device__ __forceinline__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* generation = bar + 1;
    const unsigned seen = *generation;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*generation == seen) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// The column of dscale (half 0) or dbias (half 1) whose sum a lane keeps
// in its slot e, or -1 past the row.
template <int VEC, int N>
__device__ __forceinline__ int sum_column(int e, int lane, const Shape& s,
                                          int* half) {
  constexpr int V = N * VEC;
  *half = e >= 3 * V;
  const int f = e - *half * 3 * V, p = f / V, i = f % V / VEC, k = f % VEC;
  const int j = i * s.G + lane;
  return j < s.nvec ? p * s.D + j * VEC + k : -1;
}

// After the grid's barrier: dscale and dbias from the grid's rows of
// `partial` (dscale's C3 columns, then dbias's; a row a block). Block b
// sums its share of the columns: its threads split the rows into chunks,
// each summed in block order with 8 rows in flight, and the chunks' sums
// are added in chunk order. `tree`: THREADS floats of shared memory.
__device__ __forceinline__ void sum_partial(const float* partial, int C3,
                                            float* __restrict__ dscale,
                                            float* __restrict__ dbias,
                                            float* tree) {
  const int P = 2 * C3;
  const int blocks = gridDim.x, share = (P + blocks - 1) / blocks;
  const int lo = min(P, (int)blockIdx.x * share), hi = min(P, lo + share);
  for (int base = lo; base < hi; base += THREADS) {
    const int cols = min(THREADS, hi - base), chunks = THREADS / cols;
    const int per = (blocks + chunks - 1) / chunks;
    const int col = threadIdx.x % cols, chunk = threadIdx.x / cols;
    if (chunk < chunks) {
      const float* column = partial + base + col;
      const int last = min(blocks, (chunk + 1) * per);
      float sum = 0.f;
      for (int b = chunk * per; b < last; b += 8) {
        float rows[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (b + u < last) rows[u] = __ldcg(column + (long)(b + u) * P);
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (b + u < last) sum += rows[u];
      }
      tree[chunk * cols + col] = sum;
    }
    __syncthreads();
    if (threadIdx.x < cols) {
      float sum = 0.f;
      for (int k = 0; k < chunks; ++k) sum += tree[k * cols + threadIdx.x];
      const int c = base + threadIdx.x;
      (c < C3 ? dscale : dbias)[c < C3 ? c : c - C3] = sum;
    }
    __syncthreads();
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
                   float* __restrict__ dbias, unsigned* __restrict__ barrier,
                   Shape s, int cluster) {
  constexpr int V = N * VEC;  // Values of a part a lane keeps.
  constexpr int E = 6 * V;    // A lane's column sums: dscale's, dbias's.
  // 2 x WARPS floats for the group sums, then the tree's E x THREADS / 2
  // floats, then (in a cluster) the block's sums, slot (e, lane) at
  // own[e * G + lane].
  extern __shared__ __align__(16) float smem[];
  float* tree = smem + 2 * WARPS;
  float* own = tree + E * THREADS / 2;
  const int sub = threadIdx.x % s.G, group = threadIdx.x / s.G;
  const int D = s.D, C3 = 3 * s.D;
  const int steps = (s.rows + s.groups - 1) / s.groups;
  // A run of consecutive steps a block; the grid's last blocks may have
  // none.
  const int per = (steps + gridDim.x - 1) / gridDim.x;
  const int first = min(steps, (int)blockIdx.x * per);
  const int last = min(steps, first + per);
  // The lane's column sums of dn * xhat (slots 0 .. 3 V) and dn.
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;

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
        float xhat[3], n[3][1];
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          xhat[p] = (widen(v[p][i].v[k]) - mu) * rs;
          n[p][0] = rounded<T>(xhat[p] * sc[p][k] + bi[p][k]);
        }
        float dnv[3], ddv;
        cell_grad<T>(n, widen(go.v[k]), widen(d.v[k]), dnv, &ddv);
        narrow(ddv, &dd.v[k]);
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
    group_sum2(&s1, &s2, s.G, smem);
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
          acc[(p * N + i) * VEC + k] += dnv * xhat;
          acc[3 * V + (p * N + i) * VEC + k] += dnv;
        }
        *reinterpret_cast<Pack<T, VEC>*>(dx + (long)row * C3 + p * D +
                                         j * VEC) = o;
      }
    }
  }

  // The block's sums: a tree over its groups (a power of two), the upper
  // half of the groups handing its sums to the lower at each level; group
  // 0 ends with them.
  for (int h = s.groups / 2; h > 0; h >>= 1) {
    const int width = h * s.G;
    __syncthreads();  // The last level's readers are done with `tree`.
    if (group >= h && group < 2 * h) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        tree[e * width + threadIdx.x - width] = acc[e];
    }
    __syncthreads();
    if (group < h) {
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] += tree[e * width + threadIdx.x];
    }
  }
  if (gridDim.x == 1) {
    if (group == 0) {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        int half;
        const int c = sum_column<VEC, N>(e, sub, s, &half);
        if (c >= 0) (half ? dbias : dscale)[c] = acc[e];
      }
    }
    return;
  }

  if (cluster > 1) {
    // One cluster: rank r sums its share of the slots over the cluster's
    // blocks in rank order (distributed shared memory, every rank's value
    // in flight at once) into dscale and dbias.
    if (group == 0) {
#pragma unroll
      for (int e = 0; e < E; ++e) own[e * s.G + sub] = acc[e];
    }
    const int slots = E * s.G, rank = ptx::cluster_rank();
    const int share = (slots + cluster - 1) / cluster;
    const int lo = min(slots, rank * share), hi = min(slots, lo + share);
    ptx::cluster_sync();
    for (int q = lo + threadIdx.x; q < hi; q += THREADS) {
      float ranks[MAX_CLUSTER];
#pragma unroll
      for (int r = 0; r < MAX_CLUSTER; ++r)
        if (r < cluster) ranks[r] = ptx::cluster_map(own, r)[q];
      float sum = 0.f;
#pragma unroll
      for (int r = 0; r < MAX_CLUSTER; ++r)
        if (r < cluster) sum += ranks[r];
      int half;
      const int c = sum_column<VEC, N>(q / s.G, q % s.G, s, &half);
      if (c >= 0) (half ? dbias : dscale)[c] = sum;
    }
    // No block leaves before the cluster's reads of its sums are done.
    ptx::cluster_sync();
    return;
  }

  // Several blocks, all on the card at once (a cooperative launch): each
  // writes its sums to its row of `partial` (dscale's 3 D columns, then
  // dbias's) and the grid meets at a barrier.
  const int P = 2 * C3;
  if (group == 0) {
    float* mine = partial + (long)blockIdx.x * P;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      int half;
      const int c = sum_column<VEC, N>(e, sub, s, &half);
      if (c >= 0) mine[half * C3 + c] = acc[e];
    }
  }
  grid_sync(barrier);
  sum_partial(partial, C3, dscale, dbias, tree);
}

// The two paths past the register layout above: without a norm, and rows
// too wide for a group of lanes to hold (see the head of the file).

// Without a norm (`norm: none`) the cell is elementwise: a thread takes a
// vector of VEC columns of a row (those of its three parts and of deter),
// the grid walking the rows' vectors by its stride. The forward writes the
// new deter; the backward dx (the gradients at x, which are the gates'
// inputs) and ddeter (in `out`). No row sums, no column sums: one pass
// each way.
template <class T, int VEC, bool BACKWARD>
__device__ __forceinline__ void bare_cell(const T* __restrict__ x,
                                          const T* __restrict__ deter,
                                          const T* __restrict__ dout,
                                          T* __restrict__ out,
                                          T* __restrict__ dx, int rows,
                                          int D) {
  const int nvec = D / VEC;
  const long total = (long)rows * nvec;
  for (long e = (long)blockIdx.x * THREADS + threadIdx.x; e < total;
       e += (long)gridDim.x * THREADS) {
    const long row = e / nvec;
    const int col = (int)(e % nvec) * VEC;
    const long at = row * D + col;
    Pack<T, VEC> v[3];
#pragma unroll
    for (int p = 0; p < 3; ++p)
      v[p] = *reinterpret_cast<const Pack<T, VEC>*>(x + row * 3 * D + p * D +
                                                     col);
    const Pack<T, VEC> d = *reinterpret_cast<const Pack<T, VEC>*>(deter + at);
    if constexpr (!BACKWARD) {
      Pack<T, VEC> o;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float n[3][1] = {{widen(v[0].v[k])}, {widen(v[1].v[k])},
                               {widen(v[2].v[k])}};
        narrow(cell<T>(n, widen(d.v[k])), &o.v[k]);
      }
      *reinterpret_cast<Pack<T, VEC>*>(out + at) = o;
      continue;
    }
    const Pack<T, VEC> go = *reinterpret_cast<const Pack<T, VEC>*>(dout + at);
    Pack<T, VEC> dd, dn[3];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float n[3][1] = {{widen(v[0].v[k])}, {widen(v[1].v[k])},
                             {widen(v[2].v[k])}};
      float dnv[3], ddv;
      cell_grad<T>(n, widen(go.v[k]), widen(d.v[k]), dnv, &ddv);
      narrow(ddv, &dd.v[k]);
#pragma unroll
      for (int p = 0; p < 3; ++p) narrow(dnv[p], &dn[p].v[k]);
    }
    *reinterpret_cast<Pack<T, VEC>*>(out + at) = dd;  // ddeter.
#pragma unroll
    for (int p = 0; p < 3; ++p)
      *reinterpret_cast<Pack<T, VEC>*>(dx + row * 3 * D + p * D + col) =
          dn[p];
  }
}

template <class T, int VEC>
__global__ void __launch_bounds__(256)
    gru_bare_fwd_kernel(const T* __restrict__ x, const T* __restrict__ deter,
                        T* __restrict__ out, int rows, int D) {
  bare_cell<T, VEC, false>(x, deter, nullptr, out, nullptr, rows, D);
}

template <class T, int VEC>
__global__ void __launch_bounds__(256)
    gru_bare_bwd_kernel(const T* __restrict__ x, const T* __restrict__ deter,
                        const T* __restrict__ dout, T* __restrict__ ddeter,
                        T* __restrict__ dx, int rows, int D) {
  bare_cell<T, VEC, true>(x, deter, dout, ddeter, dx, rows, D);
}

// Rows of a deter past MAX_D (3 D values more than a group of lanes holds
// in registers): a block takes a row at a time and streams it, re-reading
// it from L2 for each pass. The forward's passes: the mean, the mean of
// squared deviations (as the JAX Norm takes the variance, not E[x^2] -
// mean^2), then the gates, each thread a vector of VEC columns of the
// three parts at a time.
template <class T, int VEC>
__global__ void __launch_bounds__(256)
    gru_wide_fwd_kernel(const T* __restrict__ x, const T* __restrict__ deter,
                        const float* __restrict__ scale,
                        const float* __restrict__ bias, T* __restrict__ out,
                        float* __restrict__ mean_out,
                        float* __restrict__ rstd_out, int rows, int D,
                        float eps) {
  extern __shared__ __align__(16) float smem[];  // WARPS floats: group_sum.
  const int C3 = 3 * D, nvec = C3 / VEC, dvec = D / VEC;
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const T* xr = x + (long)row * C3;
    float sum = 0.f;
    for (int j = threadIdx.x; j < nvec; j += THREADS) {
      const Pack<T, VEC> v = reinterpret_cast<const Pack<T, VEC>*>(xr)[j];
#pragma unroll
      for (int k = 0; k < VEC; ++k) sum += widen(v.v[k]);
    }
    const float mean = group_sum(sum, THREADS, smem) / C3;
    float sq = 0.f;
    for (int j = threadIdx.x; j < nvec; j += THREADS) {
      const Pack<T, VEC> v = reinterpret_cast<const Pack<T, VEC>*>(xr)[j];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float e = widen(v.v[k]) - mean;
        sq += e * e;
      }
    }
    const float rstd = rsqrtf(group_sum(sq, THREADS, smem) / C3 + eps);
    for (int j = threadIdx.x; j < dvec; j += THREADS) {
      Pack<T, VEC> v[3];
      float sc[3][VEC], bi[3][VEC];
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        v[p] = reinterpret_cast<const Pack<T, VEC>*>(xr + p * D)[j];
        load_vec<VEC>(scale + p * D + j * VEC, sc[p]);
        load_vec<VEC>(bias + p * D + j * VEC, bi[p]);
      }
      const Pack<T, VEC> d =
          reinterpret_cast<const Pack<T, VEC>*>(deter + (long)row * D)[j];
      Pack<T, VEC> o;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        float n[3][1];
#pragma unroll
        for (int p = 0; p < 3; ++p)
          n[p][0] = rounded<T>((widen(v[p].v[k]) - mean) * rstd * sc[p][k] +
                               bi[p][k]);
        narrow(cell<T>(n, widen(d.v[k])), &o.v[k]);
      }
      reinterpret_cast<Pack<T, VEC>*>(out + (long)row * D)[j] = o;
    }
    if (threadIdx.x == 0) {
      mean_out[row] = mean;
      rstd_out[row] = rstd;
    }
  }
}

// Rows of the wide backward whose column sums a thread keeps in registers
// between two stores of them.
constexpr int CHUNK = 8;

// The backward of those rows: a block takes a run of consecutive rows, in
// chunks of up to CHUNK rows. First a pass over each row of the chunk
// recomputes the norm's output and the gates and writes ddeter, the
// gradient at the norm's output (a value of T) into dx, and the row's two
// sums; then, a thread's vectors of columns at a time, a pass down the
// chunk's rows reads it back (the same thread, the same columns), writes
// dx over it and keeps dn * xhat and dn in registers, added once a chunk
// to the block's column sums: its row of `partial` (dscale's 3 D columns,
// then dbias's; each column kept by one thread), or dscale and dbias
// themselves where the grid is one block. Several blocks make a
// cooperative grid that meets at the barrier and sums the blocks' rows in
// block order (sum_partial), as gru_bwd_kernel's grid does.
template <class T, int VEC>
__global__ void __launch_bounds__(256)
    gru_wide_bwd_kernel(const T* __restrict__ x, const T* __restrict__ deter,
                        const float* __restrict__ scale,
                        const float* __restrict__ bias,
                        const float* __restrict__ mean,
                        const float* __restrict__ rstd,
                        const T* __restrict__ dout, T* __restrict__ dx,
                        T* __restrict__ ddeter, float* __restrict__ partial,
                        float* __restrict__ dscale, float* __restrict__ dbias,
                        unsigned* __restrict__ barrier, int rows, int D) {
  // 2 x WARPS floats for group_sum2, then THREADS floats: a chunk's rows'
  // mean, rstd and two sums, then sum_partial's tree.
  extern __shared__ __align__(16) float smem[];
  float4* stats = reinterpret_cast<float4*>(smem + 2 * WARPS);
  const int C3 = 3 * D, dvec = D / VEC;
  const int per = (rows + gridDim.x - 1) / gridDim.x;
  const int first = min(rows, (int)blockIdx.x * per);
  const int last = min(rows, first + per);
  float* sums_s = gridDim.x == 1 ? dscale : partial + (long)blockIdx.x * 2 * C3;
  float* sums_b = gridDim.x == 1 ? dbias : sums_s + C3;
  for (int c0 = first; c0 < last; c0 += CHUNK) {
    const int n = min(CHUNK, last - c0);
    for (int row = c0; row < c0 + n; ++row) {
      const T* xr = x + (long)row * C3;
      T* dxr = dx + (long)row * C3;
      const float mu = mean[row], rs = rstd[row];
      float s1 = 0.f, s2 = 0.f;
      for (int j = threadIdx.x; j < dvec; j += THREADS) {
        Pack<T, VEC> v[3], dn[3];
        float sc[3][VEC], bi[3][VEC];
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          v[p] = reinterpret_cast<const Pack<T, VEC>*>(xr + p * D)[j];
          load_vec<VEC>(scale + p * D + j * VEC, sc[p]);
          load_vec<VEC>(bias + p * D + j * VEC, bi[p]);
        }
        const long at = (long)row * D + j * VEC;
        const Pack<T, VEC> d =
            *reinterpret_cast<const Pack<T, VEC>*>(deter + at);
        const Pack<T, VEC> go =
            *reinterpret_cast<const Pack<T, VEC>*>(dout + at);
        Pack<T, VEC> dd;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          float xhat[3], nv[3][1];
#pragma unroll
          for (int p = 0; p < 3; ++p) {
            xhat[p] = (widen(v[p].v[k]) - mu) * rs;
            nv[p][0] = rounded<T>(xhat[p] * sc[p][k] + bi[p][k]);
          }
          float dnv[3], ddv;
          cell_grad<T>(nv, widen(go.v[k]), widen(d.v[k]), dnv, &ddv);
          narrow(ddv, &dd.v[k]);
#pragma unroll
          for (int p = 0; p < 3; ++p) {
            narrow(dnv[p], &dn[p].v[k]);
            const float gs = dnv[p] * sc[p][k];
            s1 += gs;
            s2 += gs * xhat[p];
          }
        }
        *reinterpret_cast<Pack<T, VEC>*>(ddeter + at) = dd;
#pragma unroll
        for (int p = 0; p < 3; ++p)
          reinterpret_cast<Pack<T, VEC>*>(dxr + p * D)[j] = dn[p];
      }
      // Its barriers also keep the last chunk's readers of `stats` ahead
      // of this write.
      group_sum2(&s1, &s2, THREADS, smem);
      if (threadIdx.x == 0)
        stats[row - c0] = make_float4(mu, rs, s1 / C3, s2 / C3);
    }
    __syncthreads();
    for (int j = threadIdx.x; j < dvec; j += THREADS) {
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        float sc[VEC], sum_s[VEC], sum_b[VEC];
        load_vec<VEC>(scale + p * D + j * VEC, sc);
#pragma unroll
        for (int k = 0; k < VEC; ++k) sum_s[k] = sum_b[k] = 0.f;
        for (int r = 0; r < n; ++r) {
          const float4 st = stats[r];
          const T* xr = x + (long)(c0 + r) * C3 + p * D;
          T* dxr = dx + (long)(c0 + r) * C3 + p * D;
          const Pack<T, VEC> v = reinterpret_cast<const Pack<T, VEC>*>(xr)[j];
          const Pack<T, VEC> dn =
              reinterpret_cast<const Pack<T, VEC>*>(dxr)[j];
          Pack<T, VEC> o;
#pragma unroll
          for (int k = 0; k < VEC; ++k) {
            const float xhat = (widen(v.v[k]) - st.x) * st.y;
            const float dnv = widen(dn.v[k]);
            narrow(st.y * (dnv * sc[k] - st.z - xhat * st.w), &o.v[k]);
            sum_s[k] += dnv * xhat;
            sum_b[k] += dnv;
          }
          reinterpret_cast<Pack<T, VEC>*>(dxr)[j] = o;
        }
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const int c = p * D + j * VEC + k;
          sums_s[c] = (c0 == first ? 0.f : sums_s[c]) + sum_s[k];
          sums_b[c] = (c0 == first ? 0.f : sums_b[c]) + sum_b[k];
        }
      }
    }
  }
  if (gridDim.x == 1) return;
  grid_sync(barrier);
  sum_partial(partial, C3, dscale, dbias, smem + 2 * WARPS);
}

// The backward of those rows, redesigned: a cluster of `ranks` blocks takes
// a run of `per` consecutive rows, and lane rank * blockDim.x + threadIdx.x
// of the cluster owns the same NV vectors of VEC columns of each of the
// three parts, of deter, dout and ddeter in every row (vectors lane, lane +
// lanes, ...; see row_cluster.cuh), so the gates need no exchange. Each
// row's x, deter and dout are read from memory once and kept in registers
// (the gradient at the norm's output, dn, rounded to T, beside x) for both
// halves of the backward. A batch of B rows pays one cluster barrier for
// its row sums (row_totals), with the next batch's loads issued before it.
// The lane's scale and bias sit in its own slots of shared memory, and its
// columns' sums of dn * xhat and dn in registers over all of the cluster's
// rows, flushed once (flush_sums: the clusters' rows of `partial` summed
// through the tickets), so no cooperative grid is needed.
template <class T, int VEC, int NV>
struct CellRow {
  Pack<T, VEC> x[3][NV], d[NV], go[NV];
  float mu, rs;
};

template <class T, int VEC, int NV>
__device__ __forceinline__ void load_cell_row(
    CellRow<T, VEC, NV>* r, const T* __restrict__ x,
    const T* __restrict__ deter, const T* __restrict__ dout,
    const float* __restrict__ mean, const float* __restrict__ rstd, int row,
    int last, int D, int nvec, int lane, int lanes) {
  if (row >= last) return;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = i * lanes + lane;
    if (j >= nvec) continue;
    const long at = (long)row * D + j * VEC;
#pragma unroll
    for (int p = 0; p < 3; ++p)
      r->x[p][i] = *reinterpret_cast<const Pack<T, VEC>*>(
          x + (long)row * 3 * D + p * D + j * VEC);
    r->d[i] = *reinterpret_cast<const Pack<T, VEC>*>(deter + at);
    r->go[i] = *reinterpret_cast<const Pack<T, VEC>*>(dout + at);
  }
  r->mu = mean[row];
  r->rs = rstd[row];
}

template <class T, int VEC, int NV>
__global__ void __launch_bounds__(256)
    gru_cluster_bwd_kernel(const T* __restrict__ x,
                           const T* __restrict__ deter,
                           const float* __restrict__ scale,
                           const float* __restrict__ bias,
                           const float* __restrict__ mean,
                           const float* __restrict__ rstd,
                           const T* __restrict__ dout, T* __restrict__ dx,
                           T* __restrict__ ddeter,
                           float* __restrict__ partial,
                           float* __restrict__ dscale,
                           float* __restrict__ dbias,
                           unsigned* __restrict__ tickets, int rows, int D,
                           int ranks, int per) {
  // x's three parts, deter and dout.
  constexpr int B = row_cluster::rows_at(5 * NV * VEC * (int)sizeof(T));
  constexpr int HEAD_B = row_cluster::head_floats<B>();
  constexpr int V = NV * VEC;  // Values of a part a lane keeps.
  // Columns rounded to T at once: bfloat16 in pairs.
  constexpr int P = sizeof(T) == 2 && VEC % 2 == 0 ? 2 : 1;
  // The row sums' and the ticket's floats, then the lane's scale and bias
  // at [3][V][blockDim.x] each.
  extern __shared__ __align__(16) float smem[];
  const int threads = blockDim.x, C3 = 3 * D, nvec = D / VEC;
  float* sc = smem + HEAD_B;
  float* bi = sc + 3 * V * threads;
  const int rank = ptx::cluster_rank(), mine = blockIdx.x / ranks;
  const int lanes = ranks * threads, lane = rank * threads + threadIdx.x;
  const int first = mine * per, last = min(rows, first + per);
  auto param = [&](int p, int i, int k) {
    return ((p * NV + i) * VEC + k) * threads + threadIdx.x;
  };
  // Only this thread reads its slots: no barrier.
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = i * lanes + lane;
      if (j >= nvec) continue;
      float v[VEC], w[VEC];
      load_vec<VEC>(scale + p * D + j * VEC, v);
      load_vec<VEC>(bias + p * D + j * VEC, w);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        sc[param(p, i, k)] = v[k];
        bi[param(p, i, k)] = w[k];
      }
    }
  // The lane's column sums: dscale's and dbias's of each part.
  float acc[2][3 * NV][VEC];
#pragma unroll
  for (int e = 0; e < 3 * NV; ++e)
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[0][e][k] = acc[1][e][k] = 0.f;

  CellRow<T, VEC, NV> cur[B], next[B];
  Pack<T, VEC> dn[B][3][NV];
#pragma unroll
  for (int b = 0; b < B; ++b)
    load_cell_row(&cur[b], x, deter, dout, mean, rstd, first + b, last, D,
                  nvec, lane, lanes);
  int buf = 0;
  for (int r0 = first; r0 < last; r0 += B, buf ^= 1) {
    // The next batch in flight before this one's sums.
#pragma unroll
    for (int b = 0; b < B; ++b)
      load_cell_row(&next[b], x, deter, dout, mean, rstd, r0 + B + b, last,
                    D, nvec, lane, lanes);
    float s1[B], s2[B];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      s1[b] = s2[b] = 0.f;
      const int row = r0 + b;
      if (row >= last) continue;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int j = i * lanes + lane;
        if (j >= nvec) continue;
        Pack<T, VEC> dd;
#pragma unroll
        for (int k = 0; k < VEC; k += P) {
          float xhat[3][P], n[3][P], g[P], d[P], dnv[3][P], ddv[P];
#pragma unroll
          for (int p = 0; p < 3; ++p) {
#pragma unroll
            for (int q = 0; q < P; ++q) {
              xhat[p][q] =
                  (widen(cur[b].x[p][i].v[k + q]) - cur[b].mu) * cur[b].rs;
              n[p][q] = xhat[p][q] * sc[param(p, i, k + q)] +
                        bi[param(p, i, k + q)];
            }
            row_cluster::round_pair<T, P>(n[p]);
          }
#pragma unroll
          for (int q = 0; q < P; ++q) {
            g[q] = widen(cur[b].go[i].v[k + q]);
            d[q] = widen(cur[b].d[i].v[k + q]);
          }
          cell_grad_pair<T, P>(n, g, d, dnv, ddv);
          row_cluster::store_pair<T, P>(ddv, &dd.v[k]);
#pragma unroll
          for (int p = 0; p < 3; ++p)
            row_cluster::store_pair<T, P>(dnv[p], &dn[b][p][i].v[k]);
#pragma unroll
          for (int q = 0; q < P; ++q)
#pragma unroll
            for (int p = 0; p < 3; ++p) {
              const float gs = dnv[p][q] * sc[param(p, i, k + q)];
              s1[b] += gs;
              s2[b] += gs * xhat[p][q];
            }
        }
        *reinterpret_cast<Pack<T, VEC>*>(ddeter + (long)row * D + j * VEC) =
            dd;
      }
    }
    row_cluster::row_totals<B>(s1, s2, smem, buf, ranks);
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int row = r0 + b;
      if (row >= last) continue;
      const float m1 = s1[b] / C3, m2 = s2[b] / C3;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int j = i * lanes + lane;
        if (j >= nvec) continue;
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          Pack<T, VEC> o;
#pragma unroll
          for (int k = 0; k < VEC; k += P) {
            float v[P];
#pragma unroll
            for (int q = 0; q < P; ++q) {
              const float xhat =
                  (widen(cur[b].x[p][i].v[k + q]) - cur[b].mu) * cur[b].rs;
              const float dnv = widen(dn[b][p][i].v[k + q]);
              v[q] = cur[b].rs * (dnv * sc[param(p, i, k + q)] - m1 -
                                  xhat * m2);
              acc[0][p * NV + i][k + q] += dnv * xhat;
              acc[1][p * NV + i][k + q] += dnv;
            }
            row_cluster::store_pair<T, P>(v, &o.v[k]);
          }
          *reinterpret_cast<Pack<T, VEC>*>(dx + (long)row * C3 + p * D +
                                           j * VEC) = o;
        }
      }
    }
#pragma unroll
    for (int b = 0; b < B; ++b) cur[b] = next[b];
  }
  // No block leaves before every rank's reads of its row sums are done.
  ptx::cluster_sync();
  int col[3 * NV];
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = i * lanes + lane;
      col[p * NV + i] = j < nvec ? p * D + j * VEC : -1;
    }
  row_cluster::flush_sums<3 * NV, VEC>(acc, col, C3, partial, 2L * C3,
                                       gridDim.x / ranks, per > 1, mine,
                                       tickets, rank, dscale, dbias,
                                       smem + HEAD_B - 1);
}

// The forward of those rows (gru_block_fwd_kernel): a block of up to
// 1 024 threads holds a row, thread t the same NV vectors of VEC columns
// (t, t + blockDim.x, ...) of the three parts and of deter in every row it
// takes, at most 16 bytes of a part (FwdRow), so that each row is read from
// memory once and kept in registers for its mean, its variance and its
// gates. A grid of no more blocks than the card holds at once walks runs of
// rows: a thread loads its scale and bias once, into its own slots of
// shared memory (no barrier), for all of its block's rows, and the next
// row's loads are in flight while the current one is reduced. The rows'
// sums meet over the block's warps in shared memory (block_total, two
// barriers a sum: the mean, then the squared deviations from it, as the
// JAX Norm's two passes), in a fixed order, so that every launch gives the
// same bits. The per-column arithmetic and its rounding are
// gru_fwd_kernel's (the norm's output rounded to T, Gates, the two
// products rounded on their own before their sum), bfloat16 columns in
// pairs. ops/gru.py, `fwd_plan`, picks the threads and the vector: the
// most threads for few rows, the fewest for many.
template <class T, int VEC, int NV>
struct FwdRow {
  Pack<T, VEC> x[3][NV], d[NV];
};

// The thread's vectors of row `row` (none past `last`).
template <class T, int VEC, int NV>
__device__ __forceinline__ void load_fwd_row(FwdRow<T, VEC, NV>* r,
                                             const T* __restrict__ x,
                                             const T* __restrict__ deter,
                                             int row, int last, int D,
                                             int nvec) {
  if (row >= last) return;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = i * blockDim.x + threadIdx.x;
    if (j >= nvec) continue;
#pragma unroll
    for (int p = 0; p < 3; ++p)
      r->x[p][i] = *reinterpret_cast<const Pack<T, VEC>*>(
          x + (long)row * 3 * D + p * D + j * VEC);
    r->d[i] = *reinterpret_cast<const Pack<T, VEC>*>(deter + (long)row * D +
                                                     j * VEC);
  }
}

// The slot of the thread's scale or bias of part p, vector i, value k in
// its [3][V][blockDim.x] floats.
template <int VEC, int NV>
__device__ __forceinline__ int fwd_slot(int p, int i, int k) {
  return ((p * NV + i) * VEC + k) * blockDim.x + threadIdx.x;
}

// The thread's scale and bias into its slots at sc and bi: only this
// thread reads them, so no barrier.
template <int VEC, int NV>
__device__ __forceinline__ void fwd_params(const float* __restrict__ scale,
                                           const float* __restrict__ bias,
                                           float* sc, float* bi, int D,
                                           int nvec) {
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = i * blockDim.x + threadIdx.x;
      if (j >= nvec) continue;
      float v[VEC], w[VEC];
      load_vec<VEC>(scale + p * D + j * VEC, v);
      load_vec<VEC>(bias + p * D + j * VEC, w);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        sc[fwd_slot<VEC, NV>(p, i, k)] = v[k];
        bi[fwd_slot<VEC, NV>(p, i, k)] = w[k];
      }
    }
}

// The thread's share of the sum of a row (squares false) or of its squared
// deviations from `mean`.
template <class T, int VEC, int NV>
__device__ __forceinline__ float fwd_sum(const FwdRow<T, VEC, NV>& r,
                                         bool squares, float mean,
                                         int nvec) {
  float s = 0.f;
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int i = 0; i < NV; ++i)
      if (i * (int)blockDim.x + (int)threadIdx.x < nvec) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float e = widen(r.x[p][i].v[k]) - (squares ? mean : 0.f);
          s += squares ? e * e : e;
        }
      }
  return s;
}

// The new deter of the thread's columns of one row from the row's mean and
// rstd and the thread's scale and bias at sc and bi, stored in out_row.
template <class T, int VEC, int NV>
__device__ __forceinline__ void fwd_gates(const FwdRow<T, VEC, NV>& r,
                                          float mean, float rstd,
                                          const float* sc, const float* bi,
                                          T* __restrict__ out_row, int nvec) {
  // Columns rounded to T at once: bfloat16 in pairs.
  constexpr int P = sizeof(T) == 2 && VEC % 2 == 0 ? 2 : 1;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = i * blockDim.x + threadIdx.x;
    if (j >= nvec) continue;
    Pack<T, VEC> o;
#pragma unroll
    for (int k = 0; k < VEC; k += P) {
      float n[3][P];
#pragma unroll
      for (int p = 0; p < 3; ++p) {
#pragma unroll
        for (int q = 0; q < P; ++q) {
          const float xhat = (widen(r.x[p][i].v[k + q]) - mean) * rstd;
          n[p][q] = xhat * sc[fwd_slot<VEC, NV>(p, i, k + q)] +
                    bi[fwd_slot<VEC, NV>(p, i, k + q)];
        }
        round_all<T, P>(n[p]);
      }
      const Gates<T, P> g(n);
      // Each product rounded on its own, then their sum.
      float a[P], c[P];
#pragma unroll
      for (int q = 0; q < P; ++q) {
        a[q] = __fmul_rn(g.u[q], g.c[q]);
        c[q] = __fmul_rn(g.om[q], widen(r.d[i].v[k + q]));
      }
      round_all<T, P>(a);
      round_all<T, P>(c);
#pragma unroll
      for (int q = 0; q < P; ++q) a[q] = __fadd_rn(a[q], c[q]);
      narrow_all<T, P>(a, &o.v[k]);
    }
    *reinterpret_cast<Pack<T, VEC>*>(out_row + j * VEC) = o;
  }
}

// Floats of shared memory block_total takes at the head of a block's (a
// multiple of 4, so that what follows is 16-byte aligned).
constexpr int BLOCK_RED = 36;

// The sum of `a` over the block's threads (up to 32 warps): the warps'
// shuffles, then warp 0 over the warps' sums in a butterfly; every thread
// gets the same bits. `red`: BLOCK_RED floats of shared memory. Every
// thread of the block calls it.
__device__ __forceinline__ float block_total(float a, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) a += __shfl_xor_sync(FULL, a, o);
  if (lane == 0) red[warp] = a;
  __syncthreads();
  if (warp == 0) {
    float v = lane < (int)(blockDim.x + 31) / 32 ? red[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  return red[32];
}

// The block forward's launch bounds: a block of at most FWD_TIGHT threads
// that keep one 16-byte vector of each part (bfloat16 <8, 1>, float32
// <4, 1>; ops/gru.py's `fwd_plan` gives many rows 288 to 544 threads up to
// a deter of 4 100) takes the instantiation built for that many, whose
// threads may keep up to 96 registers (65 536 over 640, to a multiple of
// 8), so that two rows' vectors stay in registers; every other block the
// one built for 1 024 threads (64), which kept more blocks an SM where
// the 640 bound's registers cost them.
constexpr int FWD_TIGHT = 640;

template <class T, int VEC, int NV, int BOUND>
__global__ void __launch_bounds__(BOUND)
    gru_block_fwd_kernel(const T* __restrict__ x, const T* __restrict__ deter,
                         const float* __restrict__ scale,
                         const float* __restrict__ bias,
                         T* __restrict__ out, float* __restrict__ mean_out,
                         float* __restrict__ rstd_out, int rows, int D,
                         int per, float eps) {
  // block_total's floats, then the threads' scale and bias at
  // [3][V][blockDim.x] each.
  extern __shared__ __align__(16) float smem[];
  const int C3 = 3 * D, nvec = D / VEC;
  float* sc = smem + BLOCK_RED;
  float* bi = sc + 3 * NV * VEC * blockDim.x;
  const int first = blockIdx.x * per, last = min(rows, first + per);
  FwdRow<T, VEC, NV> cur, next;
  load_fwd_row(&cur, x, deter, first, last, D, nvec);
  fwd_params<VEC, NV>(scale, bias, sc, bi, D, nvec);
  for (int row = first; row < last; ++row) {
    // The next row in flight before this one's sums.
    load_fwd_row(&next, x, deter, row + 1, last, D, nvec);
    const float mean =
        block_total(fwd_sum(cur, false, 0.f, nvec), smem) / C3;
    const float sq = block_total(fwd_sum(cur, true, mean, nvec), smem);
    const float rstd = rsqrtf(sq / C3 + eps);
    fwd_gates(cur, mean, rstd, sc, bi, out + (long)row * D, nvec);
    if (threadIdx.x == 0) {
      mean_out[row] = mean;
      rstd_out[row] = rstd;
    }
    cur = next;
  }
}

// The vectors a lane may keep of a part (the kernels' N).
constexpr int NS[] = {1, 2, 4, 8};

// The geometry of rows of D values a part of T, vectors of `vec` values:
// a group of lanes a row, from the narrowest (with the widest vector at
// that width, no lane of the group without one, at most SPREAD values a
// part a lane) to the widest, until the group is at least `least` lanes
// (or the row's vectors, where fewer) and rows x G reach `lanes`. Returns
// N, the vectors a lane keeps of a part (0: none fits).
template <class T>
int plan(int rows, int D, int lanes, int least, Shape* s, int* vec) {
  int best = 0;
  for (int G = 1; G <= THREADS; G *= 2) {
    int found = 0;
    for (int v = 16 / (int)sizeof(T); v >= 1 && !found; v /= 2) {
      if (D % v) continue;
      const int nvec = D / v, need = (nvec + G - 1) / G;
      // No lane of the group without a vector.
      if (G > 1 && G / 2 >= nvec) continue;
      for (const int n : NS)
        if (!found && n >= need && n * v <= SPREAD) found = n;
      if (found) {
        *s = Shape{rows, D, nvec, G, THREADS / G};
        *vec = v;
      }
    }
    if (found) best = found;
    if (found && G >= std::min(least, s->nvec) && (long)rows * G >= lanes)
      break;
  }
  return best;
}

// dims: rows, D, max_blocks, lanes to spread the rows over.
template <class T, int VEC, int N>
cudaError_t fwd(void* const* p, Shape s, const int* dims, float eps,
                cudaStream_t stream) {
  auto kernel = gru_fwd_kernel<T, VEC, N>;
  // A group that spans warps takes a block of its own, so that its
  // barriers hold no other row back.
  const int threads = s.G > 32 ? s.G : THREADS;
  s.groups = threads / s.G;
  const size_t bytes = WARPS * sizeof(float);
  const long steps = ((long)s.rows + s.groups - 1) / s.groups;
  const int grid = (int)std::min<long>(steps, dims[2]);
  kernel<<<grid, threads, bytes, stream>>>(static_cast<const T*>(p[0]), static_cast<const T*>(p[1]), static_cast<const float*>(p[2]), static_cast<const float*>(p[3]), static_cast<T*>(p[4]), static_cast<float*>(p[5]), static_cast<float*>(p[6]), s, eps);
  return cudaGetLastError();
}

// Blocks of `kernel` the card holds at once, THREADS threads and `bytes`
// of shared memory each.
template <class K>
cudaError_t resident(K kernel, size_t bytes, int* blocks) {
  int device = 0, sms = 1, per_sm = 1;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        THREADS, bytes);
  *blocks = std::max(1, sms * per_sm);
  return err;
}

// Allows `kernel` the bytes of shared memory past 48 KB and, where
// `cluster` is past the portable 8, clusters of that size.
template <class K>
cudaError_t allow(K kernel, size_t bytes, int cluster) {
  cudaError_t err = cudaSuccess;
  if (bytes > 48 * 1024)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

// dims: rows, D, max_blocks, rows of `partial`, blocks a cluster at most,
// lanes to spread the rows over, counters in `barrier`.
template <class T, int VEC, int N>
cudaError_t bwd(void* const* p, Shape s, const int* dims,
                cudaStream_t stream) {
  auto kernel = gru_bwd_kernel<T, VEC, N>;
  const size_t bytes =
      (2 * WARPS + 6 * N * VEC * (THREADS / 2 + s.G)) * sizeof(float);
  const long steps = ((long)s.rows + s.groups - 1) / s.groups;
  int blocks = (int)std::min<long>(steps, dims[2]);
  // Up to the cluster's blocks, one cluster of a power of two blocks (its
  // last ones may have no step); past it a cooperative grid of no more
  // blocks than the card holds at once.
  int cluster = 1;
  while (cluster < blocks) cluster *= 2;
  if (cluster > std::min(dims[4], MAX_CLUSTER)) cluster = 1;
  cudaError_t err = allow(kernel, bytes, cluster);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  if (cluster > 1) {
    blocks = cluster;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
  } else {
    int fits = 1;
    err = resident(kernel, bytes, &fits);
    if (err != cudaSuccess) return err;
    blocks = std::min(blocks, fits);
    if (blocks > 1 && (blocks > dims[3] || dims[6] < 2))
      return cudaErrorInvalidValue;
    attr.id = cudaLaunchAttributeCooperative;
    attr.val.cooperative = 1;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks);
  config.blockDim = dim3(THREADS);
  config.dynamicSmemBytes = bytes;
  config.stream = stream;
  config.attrs = &attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(
      &config, kernel, static_cast<const T*>(p[0]),
      static_cast<const T*>(p[1]), static_cast<const float*>(p[2]),
      static_cast<const float*>(p[3]), static_cast<const float*>(p[4]),
      static_cast<const float*>(p[5]), static_cast<const T*>(p[6]),
      static_cast<T*>(p[7]), static_cast<T*>(p[11]),
      static_cast<float*>(p[8]), static_cast<float*>(p[9]),
      static_cast<float*>(p[10]), static_cast<unsigned*>(p[12]), s, cluster);
}

// The widest vector of T (up to 16 bytes) that D is a multiple of.
template <class T>
int widest(int D) {
  int vec = 16 / (int)sizeof(T);
  while (D % vec) vec /= 2;
  return vec;
}

// Without a norm. dims: rows, D, max_blocks.
template <class T, int VEC>
cudaError_t bare(bool backward, void* const* p, const int* dims,
                 cudaStream_t stream) {
  const long vectors = (long)dims[0] * (dims[1] / VEC);
  const int grid =
      (int)std::min<long>((vectors + THREADS - 1) / THREADS, dims[2]);
  const T* x = static_cast<const T*>(p[0]);
  const T* deter = static_cast<const T*>(p[1]);
  if (backward) {
    auto kernel = gru_bare_bwd_kernel<T, VEC>;
    kernel<<<grid, THREADS, 0, stream>>>(x, deter, static_cast<const T*>(p[6]), static_cast<T*>(p[11]), static_cast<T*>(p[7]), dims[0], dims[1]);
  } else {
    auto kernel = gru_bare_fwd_kernel<T, VEC>;
    kernel<<<grid, THREADS, 0, stream>>>(x, deter, static_cast<T*>(p[4]), dims[0], dims[1]);
  }
  return cudaGetLastError();
}

// Rows past MAX_D. Forward dims: rows, D, max_blocks; backward: rows, D,
// max_blocks, rows of `partial`, and at [6] the counters in `barrier`.
template <class T, int VEC>
cudaError_t wide(bool backward, void* const* p, const int* dims, float eps,
                 cudaStream_t stream) {
  const int rows = dims[0], D = dims[1];
  if (!backward) {
    auto kernel = gru_wide_fwd_kernel<T, VEC>;
    const int grid = std::min(rows, dims[2]);
    kernel<<<grid, THREADS, WARPS * sizeof(float), stream>>>(static_cast<const T*>(p[0]), static_cast<const T*>(p[1]), static_cast<const float*>(p[2]), static_cast<const float*>(p[3]), static_cast<T*>(p[4]), static_cast<float*>(p[5]), static_cast<float*>(p[6]), rows, D, eps);
    return cudaGetLastError();
  }
  auto kernel = gru_wide_bwd_kernel<T, VEC>;
  const size_t bytes = (2 * WARPS + THREADS) * sizeof(float);
  int fits = 1;
  cudaError_t err = resident(kernel, bytes, &fits);
  if (err != cudaSuccess) return err;
  // A cooperative grid (all its blocks on the card at once), every block
  // with a run of rows: no row of `partial` is left unwritten.
  int blocks = std::min(rows, std::min(dims[2], fits));
  const int per = (rows + blocks - 1) / blocks;
  blocks = (rows + per - 1) / per;
  if (blocks > 1 && (blocks > dims[3] || dims[6] < 2))
    return cudaErrorInvalidValue;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks);
  config.blockDim = dim3(THREADS);
  config.dynamicSmemBytes = bytes;
  config.stream = stream;
  config.attrs = &attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(
      &config, kernel, static_cast<const T*>(p[0]),
      static_cast<const T*>(p[1]), static_cast<const float*>(p[2]),
      static_cast<const float*>(p[3]), static_cast<const float*>(p[4]),
      static_cast<const float*>(p[5]), static_cast<const T*>(p[6]),
      static_cast<T*>(p[7]), static_cast<T*>(p[11]),
      static_cast<float*>(p[8]), static_cast<float*>(p[9]),
      static_cast<float*>(p[10]), static_cast<unsigned*>(p[12]), rows, D);
}

// The cluster backward. dims as `run` reads them: [8] blocks a cluster,
// [9] threads a block, [10] the vector's values, [11] clusters at most,
// [12] counters in `tickets` (p[13]); `partial` (dims[3] rows) and the
// counters must hold the clusters' and their groups' (row_cluster.cuh).
template <class T, int VEC, int NV>
cudaError_t cluster_bwd(void* const* p, const int* dims,
                        cudaStream_t stream) {
  auto kernel = gru_cluster_bwd_kernel<T, VEC, NV>;
  constexpr int B = row_cluster::rows_at(5 * NV * VEC * (int)sizeof(T));
  const int rows = dims[0], D = dims[1], ranks = dims[8], threads = dims[9];
  if (ranks > row_cluster::MAX_RANKS || threads > THREADS ||
      threads % 32)
    return cudaErrorInvalidValue;
  const size_t bytes =
      (row_cluster::head_floats<B>() + 6 * NV * VEC * threads) *
      sizeof(float);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t config;
  int clusters = std::min(dims[11], rows);
  cudaError_t err = row_cluster::configure(kernel, ranks, threads, bytes,
                                           stream, &attr, &config, &clusters);
  if (err != cudaSuccess) return err;
  // A run of `per` rows a cluster, every cluster with one.
  const int per = (rows + clusters - 1) / clusters;
  clusters = (rows + per - 1) / per;
  config.gridDim = dim3(ranks * clusters);
  // The clusters' rows of `partial`, then the groups' (where clusters take
  // several rows each and meet in groups); a counter a rank, and a counter a
  // rank for each group.
  int groups = 0;
  if (clusters > 1 && per > 1) row_cluster::group_size(clusters, &groups);
  if (clusters + (groups > 1 ? groups : 0) > dims[3] ||
      row_cluster::MAX_RANKS * (1 + groups) > dims[12])
    return cudaErrorInvalidValue;
  return cudaLaunchKernelEx(
      &config, kernel, static_cast<const T*>(p[0]),
      static_cast<const T*>(p[1]), static_cast<const float*>(p[2]),
      static_cast<const float*>(p[3]), static_cast<const float*>(p[4]),
      static_cast<const float*>(p[5]), static_cast<const T*>(p[6]),
      static_cast<T*>(p[7]), static_cast<T*>(p[11]),
      static_cast<float*>(p[8]), static_cast<float*>(p[9]),
      static_cast<float*>(p[10]), static_cast<unsigned*>(p[13]), rows, D,
      ranks, per);
}

// The cluster backward at the vector dims[10] (up to 4 values) and the
// vectors a lane keeps of a part (the fewest of 1, 2, 4, 8 that hold the
// row, at most 16 bytes of each part a lane).
template <class T>
cudaError_t run_cluster(void* const* p, const int* dims,
                        cudaStream_t stream) {
  const int vec = dims[10], lanes = dims[8] * dims[9];
  if (vec <= 0 || dims[1] % vec || vec * (int)sizeof(T) > 16 || lanes <= 0)
    return cudaErrorInvalidValue;
  const int nvec = dims[1] / vec;
  int nv = 1;
  while ((long)nv * lanes < nvec) nv *= 2;
#define GRU_CLUSTER(V, NN)                                              \
  if constexpr (V * NN * sizeof(T) <= 16)                               \
    if (vec == V && nv == NN) return cluster_bwd<T, V, NN>(p, dims, stream);
#define GRU_CLUSTERS(V)                                                 \
  GRU_CLUSTER(V, 1) GRU_CLUSTER(V, 2) GRU_CLUSTER(V, 4) GRU_CLUSTER(V, 8)
  GRU_CLUSTERS(4)
  GRU_CLUSTERS(2)
  GRU_CLUSTERS(1)
#undef GRU_CLUSTERS
#undef GRU_CLUSTER
  return cudaErrorInvalidValue;
}

// The block forward. dims as `run` reads them: [2] blocks at most, [5]
// threads a block, [6] the vector's values, [7] the launch bound of the
// instantiation (FWD_TIGHT or 1 024); no more blocks than the card holds
// at once, each with a run of rows. A launch whose shared memory or
// threads the card refuses returns the error.
template <class T, int VEC, int NV, int BOUND>
cudaError_t block_fwd(void* const* p, const int* dims, float eps,
                      cudaStream_t stream) {
  auto kernel = gru_block_fwd_kernel<T, VEC, NV, BOUND>;
  const int rows = dims[0], D = dims[1], threads = dims[5];
  if (threads > BOUND || threads % 32) return cudaErrorInvalidValue;
  const size_t bytes = (BLOCK_RED + 6 * NV * VEC * threads) * sizeof(float);
  int device = 0, sms = 1, per_sm = 0;
  cudaError_t err = allow(kernel, bytes, 1);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, bytes);
  if (err != cudaSuccess) return err;
  if (per_sm <= 0) return cudaErrorInvalidValue;
  int blocks = std::min(rows, std::min(dims[2], sms * per_sm));
  // A run of `per` rows a block, every block with one.
  const int per = (rows + blocks - 1) / blocks;
  blocks = (rows + per - 1) / per;
  kernel<<<blocks, threads, bytes, stream>>>(static_cast<const T*>(p[0]), static_cast<const T*>(p[1]), static_cast<const float*>(p[2]), static_cast<const float*>(p[3]), static_cast<T*>(p[4]), static_cast<float*>(p[5]), static_cast<float*>(p[6]), rows, D, per, eps);
  return cudaGetLastError();
}

// The block forward at the vector dims[6], the vectors a thread keeps of
// a part (the fewest of 1, 2, 4 that hold the row, at most 16 bytes of a
// part a thread, a vector of fewer than 4 bytes counted as 4) and the
// launch bound dims[7] (FWD_TIGHT only for one 16-byte vector a part).
template <class T>
cudaError_t run_block_fwd(void* const* p, const int* dims, float eps,
                          cudaStream_t stream) {
  const int vec = dims[6], threads = dims[5], bound = dims[7];
  if (vec <= 0 || dims[1] % vec || vec * (int)sizeof(T) > 16 || threads <= 0
      || (bound != FWD_TIGHT && bound != 1024))
    return cudaErrorInvalidValue;
  const int nvec = dims[1] / vec;
  int nv = 1;
  while ((long)nv * threads < nvec) nv *= 2;
#define GRU_BLOCK_FWD(V, NN)                                            \
  if constexpr (NN * (V * sizeof(T) < 4 ? 4 : V * sizeof(T)) <= 16)     \
    if (vec == V && nv == NN) {                                         \
      if constexpr (NN == 1 && V * sizeof(T) == 16)                     \
        if (bound == FWD_TIGHT)                                         \
          return block_fwd<T, V, NN, FWD_TIGHT>(p, dims, eps, stream);  \
      return bound == 1024 ? block_fwd<T, V, NN, 1024>(p, dims, eps, stream) \
                           : cudaErrorInvalidValue;                     \
    }
#define GRU_BLOCK_FWDS(V)                                               \
  GRU_BLOCK_FWD(V, 1) GRU_BLOCK_FWD(V, 2) GRU_BLOCK_FWD(V, 4)
  if constexpr (sizeof(T) == 2) {
    GRU_BLOCK_FWDS(8)
  }
  GRU_BLOCK_FWDS(4)
  GRU_BLOCK_FWDS(2)
  GRU_BLOCK_FWDS(1)
#undef GRU_BLOCK_FWDS
#undef GRU_BLOCK_FWD
  return cudaErrorInvalidValue;
}

}  // namespace

// The cluster backward and the block forward (gru_cell_bwd's and
// gru_cell_fwd's pointers and dims). Their instantiations are compiled
// beside this file's, each by an nvcc of its own (gru_cluster.cu and
// gru_block_fwd.cu include this file with GRU_CLUSTER_PART or
// GRU_BLOCK_FWD_PART defined), and the objects are linked into one
// library (ops/build.py, `parts`).
#ifdef GRU_CLUSTER_PART
extern "C" int gru_cluster_bwd(int bf16, void* const* ptrs, const int* dims,
                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? run_cluster<__nv_bfloat16>(ptrs, dims, st)
              : run_cluster<float>(ptrs, dims, st);
}
#else
extern "C" int gru_cluster_bwd(int bf16, void* const* ptrs, const int* dims,
                               void* stream);
#endif
#ifdef GRU_BLOCK_FWD_PART
extern "C" int gru_block_fwd(int bf16, void* const* ptrs, const int* dims,
                             float eps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? run_block_fwd<__nv_bfloat16>(ptrs, dims, eps, st)
              : run_block_fwd<float>(ptrs, dims, eps, st);
}
#else
extern "C" int gru_block_fwd(int bf16, void* const* ptrs, const int* dims,
                             float eps, void* stream);
#endif

namespace {

// One launch (forward or backward): without a norm the elementwise kernel;
// else at the plan's VEC and N, or where no group of lanes holds the row
// (D past MAX_D), the backward's cluster kernel where the caller gives it
// a cluster (dims[8] > 0), the forward's block kernel where the caller
// gives it a block (dims[5] > 0), else the wide rows' kernels.
template <class T>
cudaError_t run(bool backward, void* const* p, const int* dims, float eps,
                cudaStream_t stream) {
  if (dims[0] <= 0 || dims[1] <= 0 || dims[2] <= 0)
    return cudaErrorInvalidValue;
  const bool norm = dims[backward ? 7 : 4];
#define GRU_OTHER(V)                                                    \
  if (widest<T>(dims[1]) == V)                                          \
    return norm ? wide<T, V>(backward, p, dims, eps, stream)            \
                : bare<T, V>(backward, p, dims, stream);
  Shape s;
  int vec;
  // The backward: the narrowest group whose rows x G reach its lanes. The
  // forward: at least a warp a row.
  const int n = !norm ? 0
                : backward ? plan<T>(dims[0], dims[1], dims[5], 1, &s, &vec)
                           : plan<T>(dims[0], dims[1], dims[3], 32, &s, &vec);
  if (n == 0 && norm && backward && dims[8] > 0)
    return static_cast<cudaError_t>(
        gru_cluster_bwd(sizeof(T) == 2, p, dims, stream));
  if (n == 0 && norm && !backward && dims[5] > 0)
    return static_cast<cudaError_t>(
        gru_block_fwd(sizeof(T) == 2, p, dims, eps, stream));
  if (n == 0) {
    if constexpr (sizeof(T) == 2) {
      GRU_OTHER(8)
    }
    GRU_OTHER(4)
    GRU_OTHER(2)
    GRU_OTHER(1)
    return cudaErrorInvalidValue;
  }
#undef GRU_OTHER
#define GRU_CASE(V, NN)                                                 \
  if (vec == V && n == NN) {                                            \
    if constexpr (V * NN <= SPREAD)                                     \
      return backward ? bwd<T, V, NN>(p, s, dims, stream)               \
                      : fwd<T, V, NN>(p, s, dims, eps, stream);         \
  }
#define GRU_CASES(V) GRU_CASE(V, 1) GRU_CASE(V, 2) GRU_CASE(V, 4) GRU_CASE(V, 8)
  if constexpr (sizeof(T) == 2) {
    GRU_CASES(8)
  }
  GRU_CASES(4)
  GRU_CASES(2)
  GRU_CASES(1)
#undef GRU_CASES
#undef GRU_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

#if !defined(GRU_CLUSTER_PART) && !defined(GRU_BLOCK_FWD_PART)
// ptrs: x [rows][3 D], deter [rows][D], scale [3 D], bias [3 D], out
// [rows][D], mean [rows], rstd [rows]. dims: rows, D, max_blocks, lanes to
// spread the rows over, norm (0: `norm: none`, scale, bias, mean and rstd
// unused), and for rows past MAX_D the block kernel's threads a block
// (0: the wide kernel) and vector.
extern "C" int gru_cell_fwd(int bf16, void* const* ptrs, const int* dims,
                            float eps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? run<__nv_bfloat16>(false, ptrs, dims, eps, st)
              : run<float>(false, ptrs, dims, eps, st);
}

// ptrs: x, deter, scale, bias, mean, rstd, dout [rows][D], dx [rows][3 D],
// partial [rows of partial][6 D] (a row a block of a cooperative grid, or
// a cluster of the cluster kernel), dscale [3 D], dbias [3 D], ddeter
// [rows][D], barrier (2 unsigned, zero before the first launch), tickets
// (unsigned, zero between launches). dims: rows, D, max_blocks, rows of
// partial, blocks a cluster at most (up to 16), lanes to spread the rows
// over, counters in barrier, norm, and for rows past MAX_D the cluster
// kernel's blocks a cluster (0: the wide kernels), threads a block, vector,
// clusters at most and counters in tickets (norm 0: `norm: none`; then
// only x, deter, dout, dx and ddeter are used).
extern "C" int gru_cell_bwd(int bf16, void* const* ptrs, const int* dims,
                            float eps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? run<__nv_bfloat16>(true, ptrs, dims, eps, st)
              : run<float>(true, ptrs, dims, eps, st);
}
#endif  // neither part

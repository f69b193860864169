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
//
// Both kernels are bound by bytes: about 8 operations a value forward and
// 16 backward against 4 and 6 bytes a bfloat16 value. But with the ELU's
// exponential and the roundings they issue about 25 and 37 instructions a
// value, near the card's issue rate, and a row's sums are a dependent
// chain of shuffles: warps an SM hide it, so registers count twice. What
// kept them from the bound at the update's sites (PERF.md, section 6) and
// what this design does about it:
// - A second launch on every backward call, to sum the blocks' partial
//   dscale and dbias. Here the backward is one launch of clusters of up to
//   8 blocks (the grid no more clusters than the card holds at once): each
//   block sums its rows into a row of partial sums in shared memory; block
//   r of a cluster sums its share r of the columns over the cluster's
//   blocks in rank order (distributed shared memory), into dscale and
//   dbias where the grid is one cluster, else into the cluster's row of
//   `partial`, and takes a ticket of counter r (an integer atomicAdd by
//   one thread, after a fence that orders the stores the cluster's
//   barrier made it see); the block of rank r that draws the last ticket
//   sums its share of the clusters' rows in cluster order into dscale and
//   dbias and resets counter r to 0. The counters (ops/norm.py keeps
//   them, one array a card, zeroed once) are so ready for the next launch
//   and the next replay of a CUDA graph. The same inputs give the same
//   bits in any launch: no float atomic, every sum in a fixed order.
// - Loads issued only after a row's sums. A block walks many steps of
//   rows: the forward steps b, b + grid, ... (the grid what the card holds
//   at once, at most FWD_BLOCKS), the backward a run of consecutive steps
//   (at most BWD_BLOCKS blocks). Where a lane's row is at most 16 bytes of
//   x (and 16 of dy in the backward) the next step's row is in flight
//   while the current one is reduced; past that a second row's registers
//   cost more warps than it gains. The backward's scale and bias go into
//   shared memory once, before its first row's sums. The forward reads its
//   lane's scale and bias after the sums, from L1 (every row of a block
//   reads the same columns): held across the sums in registers, or staged
//   through shared memory, they cost more than they gain (PERF.md).
// - Registers, and rows of 768 and more in one warp. A lane keeps at most
//   SPREAD = 16 values of a row: wider rows take 2 to 8 warps (768 bfloat16
//   values: 2 warps, 1 536: 4), whose sums meet in shared memory, so that
//   the backward's column sums (2 x 16 floats a lane) stay in registers;
//   __launch_bounds__ asks for 6 forward or 4 backward blocks an SM at 8
//   values a lane, where the backward spills 12 bytes: the variant
//   measured without the spill, at 3 blocks an SM, was slower (PERF.md).
//   Registers and spills of each instantiation: chip_smoke.py prints them
//   from the build log.
//
// Layout: a group of G lanes takes a row, G a power of two, the narrowest
// whose lanes keep at most SPREAD values each, so that a group of up to a
// warp sums by shuffles and a wider one through shared memory. Each lane
// loads 16-byte vectors (VEC = 8 bfloat16 or 4 float32 values; 1 value
// where C is no multiple of that) and keeps its N of them in registers
// between the passes, so x is read from memory once; the backward keeps dy
// too (overwritten in its first pass with the gradient at the norm's
// output, a value of T). Rows a block of 256 threads takes at a step,
// bfloat16: C = 64, 32 rows (G = 8, N = 1); C = 128, 16 (G = 16); C = 256,
// 8 (G = 32); C = 512, 8 (N = 2); C = 768, 4 (G = 64, N = 2); C = 1 536, 2
// (G = 128, N = 2); C = 3 072, 1 (G = 256, N = 2); float32: C = 64, 16 (G =
// 16); C = 512, 8 (N = 4); C = 1 536, 2 (G = 128, N = 3). Past 256 lanes
// of SPREAD values a lane keeps up to 64 bfloat16 or 48 float32 values
// (rows of up to 16 384 and 12 288, 4 096 where C is no multiple of a
// vector). Wider rows take, as the caller picks, the staged forward
// (ln_staged_fwd_kernel: a block a row at a time, copied into shared
// memory once with the next rows' copies in flight) or the streaming one
// (ln_stream_fwd_kernel, which re-reads a row from L1 or L2 for each of
// its three passes), and the cluster backward (ln_cluster_bwd_kernel,
// with row_cluster.cuh): a cluster of 8 blocks (16 where 8 hold too little)
// takes a run of rows and each lane of the cluster the same columns of
// every row, so that a row is read from memory once and kept in registers
// (at most 32 bytes of x a lane: rows of up to 65 536 bfloat16 or 32 768
// float32 values at 16 blocks of 256 threads); the rows' sums meet
// through distributed shared memory, a batch of rows a cluster barrier
// with the next batch's loads in flight, and the columns' sums in one row
// of `partial` a cluster, summed through tickets (two levels where
// clusters take several rows). What bounded the streaming backward before
// it (a block a row on 128 blocks, each row read twice with its gradient
// parked in dx, a block barrier a row, a row of `partial` a block) and
// what bounds this one are in PERF.md. Rows wider than the cluster
// backward takes (or where the caller gives no cluster) take the
// streaming backward (ln_stream_bwd_kernel), two passes over memory.

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
// Floats of shared memory before the per-column arrays: two a warp for the
// group sums, then the ticket's flag (16-byte aligned after it).
constexpr int HEAD = 2 * WARPS + 4;
// Blocks of a backward cluster at most: the portable cluster size.
constexpr int CLUSTER = 8;
// How a block walks the steps of `groups` rows: the forward takes steps
// blockIdx.x, blockIdx.x + gridDim.x, ...; the backward a run of
// consecutive steps.
constexpr bool FWD_CONTIGUOUS = false;
constexpr bool BWD_CONTIGUOUS = true;

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

// What a lane keeps of a row of N vectors of VEC values of T, and how the
// kernels hold it.
template <class T, int VEC, int N>
struct Lane {
  static constexpr int V = N * VEC;                 // Values of a row.
  static constexpr int BYTES = V * (int)sizeof(T);  // Of x, or of dy.
  // The next row in flight while a row is reduced, where its registers
  // leave room: x's (and in the backward dy's) bytes of a row.
  static constexpr bool FWD_AHEAD = BYTES <= 16;
  static constexpr bool BWD_AHEAD = 2 * BYTES <= 32;
  // Blocks an SM that the registers must leave room for, up to SPREAD
  // values a lane (past that, rows wider than the update's).
  static constexpr int FWD_MIN_BLOCKS = V <= 8 ? 6 : V <= 16 ? 4 : 1;
  static constexpr int BWD_MIN_BLOCKS = V <= 8 ? 4 : V <= 16 ? 2 : 1;
  // The backward's column sums in registers up to 16 values a lane.
  static constexpr bool SHARED_SUMS = V > 16;
  // Floats of the column sums' two halves (dscale, dbias), at least the
  // THREADS float4 that `sum_rows` takes after them.
  static constexpr int SUMS = 2 * THREADS * V > 4 * THREADS
                                  ? 2 * THREADS * V
                                  : 4 * THREADS;
};

// A lane's share of a row for the backward: x, dy (then dn), mean, rstd.
template <class T, int VEC, int N>
struct GradRow {
  Pack<T, VEC> x[N], g[N];
  float mu, rs;
};

// The index of a lane's column sum (vector i, value k) in one half of the
// sums: 16-byte slots of consecutive lanes side by side.
template <int VEC>
__device__ __forceinline__ int sum_index(int i, int k, int lane) {
  constexpr int Q = VEC % 4 == 0 ? 4 : 1;
  return ((i * (VEC / Q) + k / Q) * THREADS + lane) * Q + k % Q;
}

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

// group_sum of two values at once, each summed as group_sum sums it.
// `red`: 2 * WARPS floats.
__device__ __forceinline__ void group_sum2(float* a, float* b, int G,
                                           float* red) {
  for (int o = (G < 32 ? G : 32) / 2; o > 0; o >>= 1) {
    *a += __shfl_xor_sync(FULL, *a, o);
    *b += __shfl_xor_sync(FULL, *b, o);
  }
  if (G > 32) {
    __syncthreads();
    if ((threadIdx.x & 31) == 0) {
      red[2 * (threadIdx.x >> 5)] = *a;
      red[2 * (threadIdx.x >> 5) + 1] = *b;
    }
    __syncthreads();
    const int first = (int)threadIdx.x / G * (G / 32);
    *a = *b = 0.f;
    for (int w = 0; w < G / 32; ++w) {
      *a += red[2 * (first + w)];
      *b += red[2 * (first + w) + 1];
    }
  }
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

// The steps a block takes: [first, last) by stride.
struct Walk {
  int first, last, stride;
};
template <bool CONTIGUOUS>
__device__ __forceinline__ Walk walk(int steps) {
  if constexpr (CONTIGUOUS) {
    const int per = (steps + gridDim.x - 1) / gridDim.x;
    const int first = blockIdx.x * per;
    return {first, first + per < steps ? first + per : steps, 1};
  }
  return {(int)blockIdx.x, steps, (int)gridDim.x};
}

// A lane's vectors of `row` of p (nothing past the last row).
template <class T, int VEC, int N>
__device__ __forceinline__ void load_row(Pack<T, VEC> (&v)[N],
                                         const T* __restrict__ p, long row,
                                         const Shape& s, int sub) {
  if (row >= s.rows) return;
  const T* base = p + row * s.C;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int j = i * s.G + sub;
    if (j < s.nvec)
      v[i] = *reinterpret_cast<const Pack<T, VEC>*>(base + j * VEC);
  }
}

// scale and bias into shared memory, C floats each from `at`, by the whole
// block (ahead of a barrier that the caller keeps).
__device__ __forceinline__ void stage_params(const float* __restrict__ scale,
                                             const float* __restrict__ bias,
                                             float* at, int C, int Cp) {
  for (int c = threadIdx.x; c < C; c += THREADS) {
    at[c] = scale[c];
    at[Cp + c] = bias[c];
  }
}

template <class T, int VEC, int N>
__global__ void __launch_bounds__(256, (Lane<T, VEC, N>::FWD_MIN_BLOCKS))
    ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias, T* __restrict__ y,
                  float* __restrict__ mean_out, float* __restrict__ rstd_out,
                  Shape s, float eps) {
  using L = Lane<T, VEC, N>;
  extern __shared__ __align__(16) float smem[];  // WARPS floats: group_sum.
  const int sub = threadIdx.x % s.G, group = threadIdx.x / s.G;
  const Walk w = walk<FWD_CONTIGUOUS>((s.rows + s.groups - 1) / s.groups);
  // The block's first step in flight before anything else.
  Pack<T, VEC> cur[N], next[N];
  load_row<T, VEC, N>(cur, x, w.first * s.groups + group, s, sub);

  // Every thread of the block runs the same steps (the lanes of a warp
  // shuffle together, the warps of a wide row meet at barriers).
  for (int st = w.first; st < w.last; st += w.stride) {
    // The next step's row in flight before this one's sums.
    const int ahead =
        st + w.stride < w.last ? (st + w.stride) * s.groups + group : s.rows;
    if constexpr (L::FWD_AHEAD) load_row<T, VEC, N>(next, x, ahead, s, sub);
    const int row = st * s.groups + group;
    const bool valid = row < s.rows;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int j = i * s.G + sub;
      if (valid && j < s.nvec) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) sum += widen(cur[i].v[k]);
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
          const float e = widen(cur[i].v[k]) - mean;
          sq += e * e;
        }
      }
    }
    const float rstd = rsqrtf(group_sum(sq, s.G, smem) / s.C + eps);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int j = i * s.G + sub;
      if (valid && j < s.nvec) {
        Pack<T, VEC> out;
        // Scale and bias from L1 (every row of the block reads the
        // lane's same columns), after the sums: held across them they
        // would cost blocks an SM.
        float scv[VEC], biv[VEC];
        load_vec<VEC>(scale + j * VEC, scv);
        load_vec<VEC>(bias + j * VEC, biv);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float xhat = (widen(cur[i].v[k]) - mean) * rstd;
          float n = rounded<T>(xhat * scv[k] + biv[k]);
          if (s.act) n = n > 0.f ? n : expm1f(n);
          narrow(n, &out.v[k]);
        }
        *reinterpret_cast<Pack<T, VEC>*>(y + (long)row * s.C + j * VEC) = out;
      }
    }
    if (valid && sub == 0) {
      mean_out[row] = mean;
      rstd_out[row] = rstd;
    }
    if constexpr (L::FWD_AHEAD) {
#pragma unroll
      for (int i = 0; i < N; ++i) cur[i] = next[i];
    } else {
      load_row<T, VEC, N>(cur, x, ahead, s, sub);
    }
  }
}

// dscale and dbias at the 16-byte slots [lo, hi) of the rows of P floats
// (dscale's columns [0, C), then dbias's from Cp): the sums over `count`
// rows (`src`, P floats apart), each column over the rows in order, read
// past L1 (other blocks wrote them). Where the slots are fewer than the
// block's threads, slices of the rows are summed side by side and then in
// slice order through `scratch` (THREADS float4). Every thread of the block
// calls it.
__device__ __forceinline__ void sum_rows(const float* src, int count, int P,
                                         int lo, int hi, int C, int Cp,
                                         float* __restrict__ dscale,
                                         float* __restrict__ dbias,
                                         float4* scratch) {
  const int slots = hi - lo;
  if (slots <= 0) return;
  const int slices = slots >= THREADS ? 1 : THREADS / slots;
  for (int base = 0; base < slots; base += THREADS) {
    const int slot = slices == 1 ? base + (int)threadIdx.x
                                 : (int)threadIdx.x % slots;
    const int slice = slices == 1 ? 0 : (int)threadIdx.x / slots;
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    if (slot < slots && slice < slices) {
#pragma unroll 8
      for (int r = slice; r < count; r += slices) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(
                                    src + (long)r * P) + lo + slot);
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
    }
    bool writes = slot < slots;
    if (slices > 1) {
      scratch[threadIdx.x] = sum;
      __syncthreads();
      writes = (int)threadIdx.x < slots;
      if (writes) {
        sum = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int w = 0; w < slices; ++w) {
          const float4 v = scratch[w * slots + threadIdx.x];
          sum.x += v.x;
          sum.y += v.y;
          sum.z += v.z;
          sum.w += v.w;
        }
      }
    }
    if (writes) {
      const float vals[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = (lo + slot) * 4 + e, half = col >= Cp;
        const int c = col - half * Cp;
        if (c < C) (half ? dbias : dscale)[c] = vals[e];
      }
    }
  }
}

// A lane's share of `row` for the backward (nothing past the last row).
template <class T, int VEC, int N>
__device__ __forceinline__ void load_grad_row(
    GradRow<T, VEC, N>* r, const T* __restrict__ x, const T* __restrict__ dy,
    const float* __restrict__ mean, const float* __restrict__ rstd, long row,
    const Shape& s, int sub) {
  load_row<T, VEC, N>(r->x, x, row, s, sub);
  load_row<T, VEC, N>(r->g, dy, row, s, sub);
  if (row < s.rows) {
    r->mu = mean[row];
    r->rs = rstd[row];
  }
}

template <class T, int VEC, int N>
__global__ void __launch_bounds__(256, (Lane<T, VEC, N>::BWD_MIN_BLOCKS))
    ln_bwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                  const float* __restrict__ bias,
                  const float* __restrict__ mean,
                  const float* __restrict__ rstd, const T* __restrict__ dy,
                  T* __restrict__ dx, float* __restrict__ partial,
                  float* __restrict__ dscale, float* __restrict__ dbias,
                  unsigned* __restrict__ tickets, Shape s, int cluster) {
  using L = Lane<T, VEC, N>;
  constexpr int V = L::V;
  // 2 * WARPS floats for group_sum2, the ticket's flag; from HEAD the two
  // halves of the column sums (L::SUMS floats), then scale and bias, then
  // the block's row of sums (P floats).
  extern __shared__ __align__(16) float smem[];
  float* sums = smem + HEAD;
  const int Cp = (s.C + 3) & ~3;
  float* params = sums + L::SUMS;
  const int sub = threadIdx.x % s.G, group = threadIdx.x / s.G;
  const Walk w = walk<BWD_CONTIGUOUS>((s.rows + s.groups - 1) / s.groups);

  // The block's first step in flight before anything else.
  GradRow<T, VEC, N> cur, next;
  load_grad_row(&cur, x, dy, mean, rstd, w.first * s.groups + group, s, sub);
  stage_params(scale, bias, params, s.C, Cp);
  // The lane's column sums of dn * xhat and dn over its rows.
  float acc_s[L::SHARED_SUMS ? 1 : V], acc_b[L::SHARED_SUMS ? 1 : V];
  if constexpr (L::SHARED_SUMS) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const int at = sum_index<VEC>(i, k, threadIdx.x);
        sums[at] = sums[THREADS * V + at] = 0.f;
      }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) acc_s[k] = acc_b[k] = 0.f;
  }
  __syncthreads();

  for (int st = w.first; st < w.last; st += w.stride) {
    // The next step's rows in flight before this one's sums.
    const int ahead =
        st + w.stride < w.last ? (st + w.stride) * s.groups + group : s.rows;
    if constexpr (L::BWD_AHEAD)
      load_grad_row(&next, x, dy, mean, rstd, ahead, s, sub);
    const int row = st * s.groups + group;
    const bool valid = row < s.rows;
    // The gradient at the norm's rounded output, dn, a value of T, in
    // place of dy: the ELU's from the recomputed pre-activation n.
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int j = i * s.G + sub;
      if (valid && j < s.nvec) {
        float scv[VEC], biv[VEC];
        load_vec<VEC>(params + j * VEC, scv);
        if (s.act) load_vec<VEC>(params + Cp + j * VEC, biv);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float xhat = (widen(cur.x[i].v[k]) - cur.mu) * cur.rs;
          float dn = widen(cur.g[i].v[k]);
          if (s.act) {
            const float n = rounded<T>(xhat * scv[k] + biv[k]);
            if (!(n > 0.f)) {
              dn = rounded<T>(dn * expf(n));
              narrow(dn, &cur.g[i].v[k]);
            }
          }
          const float g = dn * scv[k];
          s1 += g;
          s2 += g * xhat;
        }
      }
    }
    group_sum2(&s1, &s2, s.G, smem);
    const float m1 = s1 / s.C, m2 = s2 / s.C;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int j = i * s.G + sub;
      if (valid && j < s.nvec) {
        Pack<T, VEC> out;
        float scv[VEC];
        load_vec<VEC>(params + j * VEC, scv);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float xhat = (widen(cur.x[i].v[k]) - cur.mu) * cur.rs;
          const float dn = widen(cur.g[i].v[k]);
          narrow(cur.rs * (dn * scv[k] - m1 - xhat * m2), &out.v[k]);
          if constexpr (L::SHARED_SUMS) {
            const int at = sum_index<VEC>(i, k, threadIdx.x);
            sums[at] += dn * xhat;
            sums[THREADS * V + at] += dn;
          } else {
            acc_s[i * VEC + k] += dn * xhat;
            acc_b[i * VEC + k] += dn;
          }
        }
        *reinterpret_cast<Pack<T, VEC>*>(dx + (long)row * s.C + j * VEC) = out;
      }
    }
    if constexpr (L::BWD_AHEAD)
      cur = next;
    else
      load_grad_row(&cur, x, dy, mean, rstd, ahead, s, sub);
  }

  // The block's sums: each column over the block's groups in order, into
  // its row of P = 2 Cp floats in shared memory (dscale's columns, then
  // dbias's).
  if constexpr (!L::SHARED_SUMS) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const int at = sum_index<VEC>(i, k, threadIdx.x);
        sums[at] = acc_s[i * VEC + k];
        sums[THREADS * V + at] = acc_b[i * VEC + k];
      }
  }
  __syncthreads();
  const int P = 2 * Cp;
  float* own = params + 2 * Cp;
  for (int t = threadIdx.x; t < P; t += THREADS) {
    const int half = t >= Cp, c = t - half * Cp;
    float sum = 0.f;
    if (c < s.C) {
      const int j = c / VEC, k = c % VEC;
      const int i = j / s.G, lane = j % s.G;
      for (int g = 0; g < s.groups; ++g)
        sum += sums[half * THREADS * V + sum_index<VEC>(i, k, g * s.G + lane)];
    }
    own[t] = sum;
  }

  // The cluster's sums: rank r sums its share [lo, hi) of the row's
  // 16-byte slots over the cluster's blocks in rank order (distributed
  // shared memory), into dscale and dbias for a grid of one cluster, else
  // into the cluster's row of `partial`.
  const int rank = ptx::cluster_rank(), clusters = gridDim.x / cluster;
  const int mine = blockIdx.x / cluster, per = (P / 4 + cluster - 1) / cluster;
  const int lo = min(P / 4, rank * per), hi = min(P / 4, lo + per);
  ptx::cluster_sync();
  for (int slot = lo + threadIdx.x; slot < hi; slot += THREADS) {
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < cluster; ++r) {
      const float4 v =
          reinterpret_cast<const float4*>(ptx::cluster_map(own, r))[slot];
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    if (clusters == 1) {
      const float vals[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = slot * 4 + e, half = col >= Cp, c = col - half * Cp;
        if (c < s.C) (half ? dbias : dscale)[c] = vals[e];
      }
    } else {
      reinterpret_cast<float4*>(partial + (long)mine * P)[slot] = sum;
    }
  }
  // No block leaves before the cluster's reads of its row are done.
  ptx::cluster_sync();
  if (clusters == 1) return;

  // Rank r's ticket (counter r): of the clusters' blocks of rank r, the
  // one that draws the last ticket sums the clusters' rows in cluster
  // order at its share of the slots into dscale and dbias, and resets the
  // counter. One thread fences (the barrier made it see the block's
  // stores of its share) and takes the ticket; the other threads' stores
  // of dx are not waited for.
  float* flag = smem + 2 * WARPS;
  if (threadIdx.x == 0) {
    __threadfence();
    flag[0] = atomicAdd(tickets + rank, 1u) == (unsigned)(clusters - 1)
                  ? 1.f
                  : 0.f;
    __threadfence();
  }
  __syncthreads();
  if (flag[0] == 0.f) return;
  if (threadIdx.x == 0) tickets[rank] = 0;
  sum_rows(partial, clusters, P, lo, hi, s.C, Cp, dscale, dbias,
           reinterpret_cast<float4*>(sums));
}

// Rows past `plan`'s (more values than 256 lanes keep in registers): a
// block takes a row at a time and streams it, re-reading it from L2 for
// each pass, VEC values of T a thread at a time. The forward's passes: the
// mean, the mean of squared deviations, then y.
template <class T, int VEC>
__global__ void __launch_bounds__(256)
    ln_stream_fwd_kernel(const T* __restrict__ x,
                         const float* __restrict__ scale,
                         const float* __restrict__ bias, T* __restrict__ y,
                         float* __restrict__ mean_out,
                         float* __restrict__ rstd_out, Shape s, float eps) {
  extern __shared__ __align__(16) float smem[];  // WARPS floats: group_sum.
  for (long row = blockIdx.x; row < s.rows; row += gridDim.x) {
    const Pack<T, VEC>* xr = reinterpret_cast<const Pack<T, VEC>*>(x + row * s.C);
    float sum = 0.f;
    for (int j = threadIdx.x; j < s.nvec; j += THREADS) {
      const Pack<T, VEC> v = xr[j];
#pragma unroll
      for (int k = 0; k < VEC; ++k) sum += widen(v.v[k]);
    }
    const float mean = group_sum(sum, THREADS, smem) / s.C;
    float sq = 0.f;
    for (int j = threadIdx.x; j < s.nvec; j += THREADS) {
      const Pack<T, VEC> v = xr[j];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float e = widen(v.v[k]) - mean;
        sq += e * e;
      }
    }
    const float rstd = rsqrtf(group_sum(sq, THREADS, smem) / s.C + eps);
    for (int j = threadIdx.x; j < s.nvec; j += THREADS) {
      const Pack<T, VEC> v = xr[j];
      float scv[VEC], biv[VEC];
      load_vec<VEC>(scale + j * VEC, scv);
      load_vec<VEC>(bias + j * VEC, biv);
      Pack<T, VEC> out;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float xhat = (widen(v.v[k]) - mean) * rstd;
        float n = rounded<T>(xhat * scv[k] + biv[k]);
        if (s.act) n = n > 0.f ? n : expm1f(n);
        narrow(n, &out.v[k]);
      }
      reinterpret_cast<Pack<T, VEC>*>(y + row * s.C)[j] = out;
    }
    if (threadIdx.x == 0) {
      mean_out[row] = mean;
      rstd_out[row] = rstd;
    }
  }
}

// The forward of rows past the plan, redesigned: a block of blockDim.x
// threads takes rows b, b + grid, ... and copies each from memory once
// into one of `stages` buffers of shared memory (cp.async, 16 bytes a
// copy, past L1), so that the copies of its next stages - 1 rows are in
// flight while it reduces a row; a row's copy is issued as soon as the
// row before it in that buffer is done. The mean pass, the variance pass
// and the output pass read the row there, scale and bias from L1, and the
// output is written from registers. A row lies in its buffer at its
// address modulo 16 bytes: its first and last 16-byte chunks may hold
// bytes of the rows beside it (rows of C values that are no multiple of a
// 16-byte vector start off 16 bytes), so every chunk is a whole 16-byte
// copy but one past the tensor's last byte, which thread 0 loads value by
// value into registers and stores before that row's barrier. A row's two
// sums take shuffles, then the warps' sums through shared memory in warp
// order, each to every thread (one barrier each, two arrays in turn); one
// more barrier a row shows the row's copy and hands the buffer of the row
// before it back. Sums in a fixed order, so that every launch gives the
// same bits.
constexpr int STAGE_RED = 64;  // Floats: two arrays of a slot a warp.
constexpr int STAGES_MOST = 4;

// Bytes of a buffer of a row of C values of `item` bytes.
__host__ __device__ constexpr long stage_bytes(int C, int item) {
  return ((long)C * item + 15) / 16 * 16 + 16;
}

// The sum of `s` over the block (every thread calls it; each gets the same
// bits): the warp's by shuffles, then the warps' from `red` in order.
__device__ __forceinline__ float block_total(float s, float* red) {
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  float t = 0.f;
  const int warps = (int)(blockDim.x >> 5);
  for (int w = 0; w < warps; ++w) t += red[w];
  return t;
}

// What thread 0 holds of a chunk past the tensor's last byte: its values,
// where they go, and how many.
template <class T>
struct Tail {
  T v[16 / sizeof(T)];
  char* to;
  int n;
};

// Issues the copies of `row` of x (`total` bytes) into `buf`: the 16-byte
// chunks from the one that holds its first byte, and where the last
// passes the tensor's end, its values into thread 0's `tail`.
template <class T>
__device__ __forceinline__ void stage_row(const T* __restrict__ x, long row,
                                          int C, long total, char* buf,
                                          Tail<T>* tail) {
  const char* base = reinterpret_cast<const char*>(x);
  const long start = row * C * (long)sizeof(T);
  const long end = start + (long)C * sizeof(T), first = start & ~15L;
  const long whole =
      ((end + 15) & ~15L) < (total & ~15L) ? (end + 15) & ~15L : total & ~15L;
  for (long at = first + 16L * threadIdx.x; at < whole;
       at += 16L * blockDim.x)
    ptx::cp_async16(buf + (at - first), base + at);
  if (threadIdx.x == 0 && whole < end) {
    tail->to = buf + (whole - first);
    tail->n = (int)((end - whole) / (long)sizeof(T));
    const T* src = reinterpret_cast<const T*>(base + whole);
#pragma unroll
    for (int k = 0; k < 16 / (int)sizeof(T); ++k)
      if (k < tail->n) tail->v[k] = src[k];
  }
}

// Until the copies of the oldest of `stages` - 1 rows in flight are done.
__device__ __forceinline__ void wait_oldest(int stages) {
  if (stages == 2) ptx::cp_async_wait<0>();
  else if (stages == 3) ptx::cp_async_wait<1>();
  else ptx::cp_async_wait<2>();
}

template <class T, int VEC>
__global__ void __launch_bounds__(1024)
    ln_staged_fwd_kernel(const T* __restrict__ x,
                         const float* __restrict__ scale,
                         const float* __restrict__ bias, T* __restrict__ y,
                         float* __restrict__ mean_out,
                         float* __restrict__ rstd_out, Shape s, float eps,
                         int stages) {
  // STAGE_RED floats for the sums, then the buffers.
  extern __shared__ __align__(16) float smem[];
  char* bufs = reinterpret_cast<char*>(smem + STAGE_RED);
  const long bytes = stage_bytes(s.C, sizeof(T));
  const long total = (long)s.rows * s.C * (long)sizeof(T);
  Tail<T> tail;
  tail.to = nullptr;
  tail.n = 0;
  // The block's k-th row goes to buffer k modulo `stages`; a group of
  // copies a row, an empty one past the last.
  for (int k = 0; k + 1 < stages; ++k) {
    const long row = blockIdx.x + (long)k * gridDim.x;
    if (row < s.rows) stage_row(x, row, s.C, total, bufs + k * bytes, &tail);
    ptx::cp_async_commit();
  }
  int slot = 0;
  for (long row = blockIdx.x; row < s.rows; row += gridDim.x) {
    if (tail.to != nullptr) {
#pragma unroll
      for (int k = 0; k < 16 / (int)sizeof(T); ++k)
        if (k < tail.n) reinterpret_cast<T*>(tail.to)[k] = tail.v[k];
      tail.to = nullptr;
    }
    wait_oldest(stages);
    // The row's copy seen by every thread; the row before it read by
    // every thread, so that its buffer takes the row stages - 1 ahead.
    __syncthreads();
    const long ahead = row + (long)(stages - 1) * gridDim.x;
    if (ahead < s.rows)
      stage_row(x, ahead, s.C, total,
                bufs + (slot == 0 ? stages - 1 : slot - 1) * bytes, &tail);
    ptx::cp_async_commit();
    const Pack<T, VEC>* xs = reinterpret_cast<const Pack<T, VEC>*>(
        bufs + slot * bytes + (row * s.C * (long)sizeof(T)) % 16);
    slot = slot + 1 == stages ? 0 : slot + 1;
    float sum = 0.f;
#pragma unroll 4
    for (int j = threadIdx.x; j < s.nvec; j += blockDim.x) {
      const Pack<T, VEC> v = xs[j];
#pragma unroll
      for (int k = 0; k < VEC; ++k) sum += widen(v.v[k]);
    }
    const float mean = block_total(sum, smem) / s.C;
    float sq = 0.f;
#pragma unroll 4
    for (int j = threadIdx.x; j < s.nvec; j += blockDim.x) {
      const Pack<T, VEC> v = xs[j];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float e = widen(v.v[k]) - mean;
        sq += e * e;
      }
    }
    const float rstd = rsqrtf(block_total(sq, smem + 32) / s.C + eps);
    Pack<T, VEC>* out = reinterpret_cast<Pack<T, VEC>*>(y + row * s.C);
#pragma unroll 2
    for (int j = threadIdx.x; j < s.nvec; j += blockDim.x) {
      const Pack<T, VEC> v = xs[j];
      float scv[VEC], biv[VEC];
      load_vec<VEC>(scale + j * VEC, scv);
      load_vec<VEC>(bias + j * VEC, biv);
      Pack<T, VEC> o;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float xhat = (widen(v.v[k]) - mean) * rstd;
        float n = rounded<T>(xhat * scv[k] + biv[k]);
        if (s.act) n = n > 0.f ? n : expm1f(n);
        narrow(n, &o.v[k]);
      }
      out[j] = o;
    }
    if (threadIdx.x == 0) {
      mean_out[row] = mean;
      rstd_out[row] = rstd;
    }
  }
}

// Rows of the streaming backward whose column sums a thread keeps in
// registers between two stores of them.
constexpr int CHUNK = 8;

// The backward of those rows: a block takes a run of consecutive rows, in
// chunks of up to CHUNK rows. First a pass over each row of the chunk
// makes the gradient at the norm's output (dy, or the ELU's, a value of T
// parked in dx) and the row's two sums; then, a thread's vectors of
// columns at a time, a pass down the chunk's rows writes dx and keeps
// dn * xhat and dn in registers, added once a chunk to the block's column
// sums: its row of `partial` in memory (dscale's Cp columns, then dbias's;
// each column kept by one thread). Then as ln_bwd_kernel: rank r of a
// cluster sums its share r of the columns over the cluster's blocks in
// rank order, into dscale and dbias for a grid of one cluster, else over
// the share of the cluster's first block's row; and the block of rank r
// that draws the last ticket of counter r sums its share of the clusters'
// rows in cluster order into dscale and dbias, and resets the counter. The
// same inputs give the same bits in any launch.
template <class T, int VEC>
__global__ void __launch_bounds__(256)
    ln_stream_bwd_kernel(const T* __restrict__ x,
                         const float* __restrict__ scale,
                         const float* __restrict__ bias,
                         const float* __restrict__ mean,
                         const float* __restrict__ rstd,
                         const T* __restrict__ dy, T* __restrict__ dx,
                         float* __restrict__ partial,
                         float* __restrict__ dscale, float* __restrict__ dbias,
                         unsigned* __restrict__ tickets, Shape s,
                         int cluster) {
  // 2 * WARPS floats for group_sum2, the ticket's flag; from HEAD THREADS
  // float4: a chunk's rows' mean, rstd and two sums, then sum_rows'
  // scratch.
  extern __shared__ __align__(16) float smem[];
  float4* stats = reinterpret_cast<float4*>(smem + HEAD);
  const int Cp = (s.C + 3) & ~3, P = 2 * Cp;
  const Walk w = walk<true>(s.rows);
  float* own = partial + (long)blockIdx.x * P;
  // A block without rows adds nothing to its cluster's sums; the columns
  // past C (up to Cp) are zero.
  for (int c = w.first < w.last ? s.C + threadIdx.x : threadIdx.x; c < Cp;
       c += THREADS)
    own[c] = own[Cp + c] = 0.f;
  // The gradient at the norm's rounded output: dy, or the ELU's from the
  // recomputed pre-activation, parked in dx.
  const T* dn_src = s.act ? dx : dy;
  for (int c0 = w.first; c0 < w.last; c0 += CHUNK) {
    const int n = min(CHUNK, w.last - c0);
    for (int row = c0; row < c0 + n; ++row) {
      const long at = (long)row * s.C;
      const float mu = mean[row], rs = rstd[row];
      float s1 = 0.f, s2 = 0.f;
      for (int j = threadIdx.x; j < s.nvec; j += THREADS) {
        const Pack<T, VEC> v =
            reinterpret_cast<const Pack<T, VEC>*>(x + at)[j];
        Pack<T, VEC> g = reinterpret_cast<const Pack<T, VEC>*>(dy + at)[j];
        float scv[VEC], biv[VEC];
        load_vec<VEC>(scale + j * VEC, scv);
        if (s.act) load_vec<VEC>(bias + j * VEC, biv);
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float xhat = (widen(v.v[k]) - mu) * rs;
          float dn = widen(g.v[k]);
          if (s.act) {
            const float pre = rounded<T>(xhat * scv[k] + biv[k]);
            if (!(pre > 0.f)) {
              dn = rounded<T>(dn * expf(pre));
              narrow(dn, &g.v[k]);
            }
          }
          const float gs = dn * scv[k];
          s1 += gs;
          s2 += gs * xhat;
        }
        if (s.act) reinterpret_cast<Pack<T, VEC>*>(dx + at)[j] = g;
      }
      // Its barriers also keep the last chunk's readers of `stats` ahead
      // of this write.
      group_sum2(&s1, &s2, THREADS, smem);
      if (threadIdx.x == 0)
        stats[row - c0] = make_float4(mu, rs, s1 / s.C, s2 / s.C);
    }
    __syncthreads();
    for (int j = threadIdx.x; j < s.nvec; j += THREADS) {
      float scv[VEC], sum_s[VEC], sum_b[VEC];
      load_vec<VEC>(scale + j * VEC, scv);
#pragma unroll
      for (int k = 0; k < VEC; ++k) sum_s[k] = sum_b[k] = 0.f;
      for (int r = 0; r < n; ++r) {
        const long at = (long)(c0 + r) * s.C;
        const float4 st = stats[r];
        const Pack<T, VEC> v =
            reinterpret_cast<const Pack<T, VEC>*>(x + at)[j];
        const Pack<T, VEC> g =
            reinterpret_cast<const Pack<T, VEC>*>(dn_src + at)[j];
        Pack<T, VEC> out;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float xhat = (widen(v.v[k]) - st.x) * st.y;
          const float dn = widen(g.v[k]);
          narrow(st.y * (dn * scv[k] - st.z - xhat * st.w), &out.v[k]);
          sum_s[k] += dn * xhat;
          sum_b[k] += dn;
        }
        reinterpret_cast<Pack<T, VEC>*>(dx + at)[j] = out;
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const int c = j * VEC + k;
        own[c] = (c0 == w.first ? 0.f : own[c]) + sum_s[k];
        own[Cp + c] = (c0 == w.first ? 0.f : own[Cp + c]) + sum_b[k];
      }
    }
  }

  // The cluster's sums: rank r sums its share [lo, hi) of the row's
  // 16-byte slots over the cluster's blocks' rows in rank order (each
  // rank's writes seen after the cluster's barrier, read past L1).
  const int rank = ptx::cluster_rank(), clusters = gridDim.x / cluster;
  const int mine = blockIdx.x / cluster, per = (P / 4 + cluster - 1) / cluster;
  const int lo = min(P / 4, rank * per), hi = min(P / 4, lo + per);
  float* first = partial + (long)mine * cluster * P;
  ptx::cluster_sync();
  for (int slot = lo + threadIdx.x; slot < hi; slot += THREADS) {
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < cluster; ++r) {
      const float4 v =
          __ldcg(reinterpret_cast<const float4*>(first + (long)r * P) + slot);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    if (clusters == 1) {
      const float vals[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = slot * 4 + e, half = col >= Cp, c = col - half * Cp;
        if (c < s.C) (half ? dbias : dscale)[c] = vals[e];
      }
    } else {
      reinterpret_cast<float4*>(first)[slot] = sum;
    }
  }
  if (clusters == 1) return;

  // Rank r's ticket (counter r), as in ln_bwd_kernel: every thread fences
  // its stores of the cluster's row, then one takes the ticket.
  float* flag = smem + 2 * WARPS;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    flag[0] = atomicAdd(tickets + rank, 1u) == (unsigned)(clusters - 1)
                  ? 1.f
                  : 0.f;
    __threadfence();
  }
  __syncthreads();
  if (flag[0] == 0.f) return;
  if (threadIdx.x == 0) tickets[rank] = 0;
  sum_rows(partial, clusters, cluster * P, lo, hi, s.C, Cp, dscale, dbias,
           reinterpret_cast<float4*>(smem + HEAD));
}

// The backward of rows past the plan, redesigned: a cluster of `ranks`
// blocks takes a run of `per` consecutive rows, and lane rank * blockDim.x
// + threadIdx.x of the cluster owns the same NV vectors of VEC columns of
// every row (vectors lane, lane + lanes, ...; see row_cluster.cuh). Each
// row's x and dy are read from memory once and kept in registers for both
// halves of the backward; the gradient at the norm's output (the ELU's,
// rounded to T) replaces dy there. A batch of B rows pays one cluster
// barrier for its row sums (row_totals), with the next batch's loads
// issued before it. The lane's scale and bias sit in its own slots of
// shared memory, and its columns' sums of dn * xhat and dn in registers
// over all of the cluster's rows, flushed once (flush_sums: the clusters'
// rows of `partial` summed through the tickets).
template <class T, int VEC, int NV>
struct ClusterRow {
  Pack<T, VEC> x[NV], g[NV];
  float mu, rs;
};

template <class T, int VEC, int NV>
__device__ __forceinline__ void load_cluster_row(
    ClusterRow<T, VEC, NV>* r, const T* __restrict__ x,
    const T* __restrict__ dy, const float* __restrict__ mean,
    const float* __restrict__ rstd, int row, int last, const Shape& s,
    int lane, int lanes) {
  if (row >= last) return;
  const long at = (long)row * s.C;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = i * lanes + lane;
    if (j < s.nvec) {
      r->x[i] = *reinterpret_cast<const Pack<T, VEC>*>(x + at + j * VEC);
      r->g[i] = *reinterpret_cast<const Pack<T, VEC>*>(dy + at + j * VEC);
    }
  }
  r->mu = mean[row];
  r->rs = rstd[row];
}

template <class T, int VEC, int NV>
__global__ void __launch_bounds__(256)
    ln_cluster_bwd_kernel(const T* __restrict__ x,
                          const float* __restrict__ scale,
                          const float* __restrict__ bias,
                          const float* __restrict__ mean,
                          const float* __restrict__ rstd,
                          const T* __restrict__ dy, T* __restrict__ dx,
                          float* __restrict__ partial,
                          float* __restrict__ dscale,
                          float* __restrict__ dbias,
                          unsigned* __restrict__ tickets, Shape s, int ranks,
                          int per) {
  constexpr int B =
      row_cluster::rows_at(2 * NV * VEC * (int)sizeof(T));  // x and dy.
  constexpr int HEAD_B = row_cluster::head_floats<B>();
  // Values rounded to T at once: bfloat16 in pairs.
  constexpr int P = sizeof(T) == 2 && VEC % 2 == 0 ? 2 : 1;
  // The row sums' and the ticket's floats, then the lane's scale and bias
  // at [NV * VEC][blockDim.x] each.
  extern __shared__ __align__(16) float smem[];
  const int threads = blockDim.x;
  float* sc = smem + HEAD_B;
  float* bi = sc + NV * VEC * threads;
  const int rank = ptx::cluster_rank(), mine = blockIdx.x / ranks;
  const int lanes = ranks * threads, lane = rank * threads + threadIdx.x;
  const int first = mine * per, last = min(s.rows, first + per);
  // Only this thread reads its slots: no barrier.
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = i * lanes + lane;
    if (j < s.nvec) {
      float v[VEC], w[VEC];
      load_vec<VEC>(scale + j * VEC, v);
      load_vec<VEC>(bias + j * VEC, w);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        sc[(i * VEC + k) * threads + threadIdx.x] = v[k];
        bi[(i * VEC + k) * threads + threadIdx.x] = w[k];
      }
    }
  }
  float acc[2][NV][VEC];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[0][i][k] = acc[1][i][k] = 0.f;

  ClusterRow<T, VEC, NV> cur[B], next[B];
#pragma unroll
  for (int b = 0; b < B; ++b)
    load_cluster_row(&cur[b], x, dy, mean, rstd, first + b, last, s, lane,
                     lanes);
  int buf = 0;
  for (int r0 = first; r0 < last; r0 += B, buf ^= 1) {
    // The next batch in flight before this one's sums.
#pragma unroll
    for (int b = 0; b < B; ++b)
      load_cluster_row(&next[b], x, dy, mean, rstd, r0 + B + b, last, s,
                       lane, lanes);
    float s1[B], s2[B];
#pragma unroll
    for (int b = 0; b < B; ++b) {
      s1[b] = s2[b] = 0.f;
      if (r0 + b >= last) continue;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        if (i * lanes + lane >= s.nvec) continue;
#pragma unroll
        for (int k = 0; k < VEC; k += P) {
          float scv[P], xhat[P], dn[P];
#pragma unroll
          for (int q = 0; q < P; ++q) {
            scv[q] = sc[(i * VEC + k + q) * threads + threadIdx.x];
            xhat[q] = (widen(cur[b].x[i].v[k + q]) - cur[b].mu) * cur[b].rs;
            dn[q] = widen(cur[b].g[i].v[k + q]);
          }
          if (s.act) {
            // The ELU's gradient where n <= 0, dy where n > 0 (exact in T:
            // its rounding changes nothing), rounded to T in its place.
            float n[P];
#pragma unroll
            for (int q = 0; q < P; ++q)
              n[q] = xhat[q] * scv[q] +
                     bi[(i * VEC + k + q) * threads + threadIdx.x];
            row_cluster::round_pair<T, P>(n);
#pragma unroll
            for (int q = 0; q < P; ++q)
              if (!(n[q] > 0.f)) dn[q] *= expf(n[q]);
            row_cluster::keep_pair<T, P>(dn, &cur[b].g[i].v[k]);
          }
#pragma unroll
          for (int q = 0; q < P; ++q) {
            const float gs = dn[q] * scv[q];
            s1[b] += gs;
            s2[b] += gs * xhat[q];
          }
        }
      }
    }
    row_cluster::row_totals<B>(s1, s2, smem, buf, ranks);
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int row = r0 + b;
      if (row >= last) continue;
      const float m1 = s1[b] / s.C, m2 = s2[b] / s.C;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int j = i * lanes + lane;
        if (j >= s.nvec) continue;
        Pack<T, VEC> out;
#pragma unroll
        for (int k = 0; k < VEC; k += P) {
          float o[P];
#pragma unroll
          for (int q = 0; q < P; ++q) {
            const float scv = sc[(i * VEC + k + q) * threads + threadIdx.x];
            const float xhat =
                (widen(cur[b].x[i].v[k + q]) - cur[b].mu) * cur[b].rs;
            const float dn = widen(cur[b].g[i].v[k + q]);
            o[q] = cur[b].rs * (dn * scv - m1 - xhat * m2);
            acc[0][i][k + q] += dn * xhat;
            acc[1][i][k + q] += dn;
          }
          row_cluster::store_pair<T, P>(o, &out.v[k]);
        }
        *reinterpret_cast<Pack<T, VEC>*>(dx + (long)row * s.C + j * VEC) = out;
      }
    }
#pragma unroll
    for (int b = 0; b < B; ++b) cur[b] = next[b];
  }
  // No block leaves before every rank's reads of its row sums are done.
  ptx::cluster_sync();
  int col[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = i * lanes + lane;
    col[i] = j < s.nvec ? j * VEC : -1;
  }
  const int Cp = (s.C + 3) & ~3;
  row_cluster::flush_sums<NV, VEC>(acc, col, Cp, partial, 2L * Cp,
                                   gridDim.x / ranks, per > 1, mine,
                                   tickets, rank, dscale, dbias,
                                   smem + HEAD_B - 1);
}

// The vectors a lane may keep (the kernels' N), and the values a lane
// keeps at most in T.
constexpr int NS[] = {1, 2, 3, 4, 6, 8, 12, 16};
template <class T>
constexpr int max_values() {
  return sizeof(T) == 2 ? 64 : 48;
}
// The values a lane keeps where a group of up to a block's lanes can take
// the row with no more.
constexpr int SPREAD = 16;

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
  int first = 1;
  while (first < s->nvec && first < 32) first *= 2;
  // The narrowest group whose lanes keep at most SPREAD values; past a
  // block's lanes, at most max_values.
  for (const int most : {SPREAD, max_values<T>()}) {
    for (s->G = first; s->G <= THREADS; s->G *= 2) {
      s->groups = THREADS / s->G;
      const int need = (s->nvec + s->G - 1) / s->G;
      for (const int n : NS)
        if (n >= need && n * *vec <= most) return n;
    }
  }
  return 0;
}

// Allows `kernel` the bytes of shared memory past 48 KB.
template <class K>
cudaError_t allow(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Blocks of `kernel` the card holds at once with `bytes` of shared memory
// each (allowed first).
template <class K>
int resident(K kernel, size_t bytes, cudaError_t* err) {
  int device = 0, sms = 1, per_sm = 1;
  *err = allow(kernel, bytes);
  if (*err == cudaSuccess) *err = cudaGetDevice(&device);
  if (*err == cudaSuccess)
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  device);
  if (*err == cudaSuccess)
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                         THREADS, bytes);
  return std::max(1, sms * per_sm);
}

// dims: rows, C, act, max_blocks.
template <class T, int VEC, int N>
cudaError_t fwd(void* const* p, Shape s, const int* dims, float eps,
                cudaStream_t stream) {
  auto kernel = ln_fwd_kernel<T, VEC, N>;
  const T* x = static_cast<const T*>(p[0]);
  const float* scale = static_cast<const float*>(p[1]);
  const float* bias = static_cast<const float*>(p[2]);
  T* y = static_cast<T*>(p[3]);
  float* mean = static_cast<float*>(p[4]);
  float* rstd = static_cast<float*>(p[5]);
  const size_t bytes = HEAD * sizeof(float);
  cudaError_t err;
  const int fits = resident(kernel, bytes, &err);
  if (err != cudaSuccess) return err;
  const long steps = ((long)s.rows + s.groups - 1) / s.groups;
  const int grid = (int)std::min<long>(steps, std::min(dims[3], fits));
  kernel<<<grid, THREADS, bytes, stream>>>(x, scale, bias, y, mean, rstd, s, eps);
  return cudaGetLastError();
}

// dims: rows, C, act, max_blocks, rows of `partial`, counters in `tickets`.
template <class T, int VEC, int N>
cudaError_t bwd(void* const* p, Shape s, const int* dims,
                cudaStream_t stream) {
  using L = Lane<T, VEC, N>;
  auto kernel = ln_bwd_kernel<T, VEC, N>;
  const int Cp = (s.C + 3) & ~3;
  const size_t bytes = (HEAD + L::SUMS + 4 * Cp) * sizeof(float);
  cudaError_t err = allow(kernel, bytes);
  if (err != cudaSuccess) return err;
  const long steps = ((long)s.rows + s.groups - 1) / s.groups;
  int blocks = (int)std::min<long>(steps, dims[3]);
  // Clusters of up to CLUSTER blocks, the grid a whole number of them and
  // no more than the card holds at once: a cluster's blocks share a GPC,
  // so that fewer fit than blocks an SM times SMs.
  const int cluster = std::min(CLUSTER, blocks);
  blocks = (blocks + cluster - 1) / cluster * cluster;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks);
  config.blockDim = dim3(THREADS);
  config.dynamicSmemBytes = bytes;
  config.stream = stream;
  config.attrs = &attr;
  config.numAttrs = 1;
  int held = 0;
  err = cudaOccupancyMaxActiveClusters(&held, kernel, &config);
  if (err != cudaSuccess) return err;
  if (held > 0 && blocks > held * cluster) {
    blocks = held * cluster;
    config.gridDim = dim3(blocks);
  }
  if (blocks / cluster > dims[4] || dims[5] < cluster)
    return cudaErrorInvalidValue;
  return cudaLaunchKernelEx(
      &config, kernel, static_cast<const T*>(p[0]),
      static_cast<const float*>(p[1]), static_cast<const float*>(p[2]),
      static_cast<const float*>(p[3]), static_cast<const float*>(p[4]),
      static_cast<const T*>(p[5]), static_cast<T*>(p[6]),
      static_cast<float*>(p[7]), static_cast<float*>(p[8]),
      static_cast<float*>(p[9]), static_cast<unsigned*>(p[10]), s, cluster);
}

// Rows past the plan. dims: rows, C, act, max_blocks (and in the
// backward rows of `partial`, counters in `tickets`).
template <class T, int VEC>
cudaError_t stream_fwd(void* const* p, Shape s, const int* dims, float eps,
                       cudaStream_t stream) {
  auto kernel = ln_stream_fwd_kernel<T, VEC>;
  const size_t bytes = HEAD * sizeof(float);
  cudaError_t err;
  const int fits = resident(kernel, bytes, &err);
  if (err != cudaSuccess) return err;
  const int grid = std::min(s.rows, std::min(dims[3], fits));
  kernel<<<grid, THREADS, bytes, stream>>>(static_cast<const T*>(p[0]), static_cast<const float*>(p[1]), static_cast<const float*>(p[2]), static_cast<T*>(p[3]), static_cast<float*>(p[4]), static_cast<float*>(p[5]), s, eps);
  return cudaGetLastError();
}

// The staged forward. dims as `stream_fwd` reads them, and [4] the
// buffers a block (2 to STAGES_MOST), [5] threads a block (0: 1 024 where
// the card's SMs outnumber the rows, else 512), [6] the most blocks. A
// launch whose shared memory the card refuses returns the error.
template <class T, int VEC>
cudaError_t staged_fwd(void* const* p, Shape s, const int* dims, float eps,
                       cudaStream_t stream) {
  auto kernel = ln_staged_fwd_kernel<T, VEC>;
  const int stages = dims[4];
  if (stages < 2 || stages > STAGES_MOST) return cudaErrorInvalidValue;
  const size_t bytes =
      STAGE_RED * sizeof(float) + stages * stage_bytes(s.C, sizeof(T));
  int device = 0, sms = 1, per_sm = 0;
  cudaError_t err = allow(kernel, bytes);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  const int threads = dims[5] > 0 ? dims[5] : s.rows <= sms ? 1024 : 512;
  if (threads < 32 || threads > 1024 || threads % 32)
    return cudaErrorInvalidValue;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, bytes);
  if (err != cudaSuccess) return err;
  const int grid =
      std::min(s.rows, std::min(dims[6], std::max(1, sms * per_sm)));
  kernel<<<grid, threads, bytes, stream>>>(static_cast<const T*>(p[0]), static_cast<const float*>(p[1]), static_cast<const float*>(p[2]), static_cast<T*>(p[3]), static_cast<float*>(p[4]), static_cast<float*>(p[5]), s, eps, stages);
  return cudaGetLastError();
}

// The staged forward at the widest vector of up to 16 bytes that C is a
// multiple of.
template <class T>
cudaError_t run_staged(void* const* p, Shape s, const int* dims, float eps,
                       cudaStream_t stream) {
  int vec = 16 / (int)sizeof(T);
  while (s.C % vec) vec /= 2;
  s.nvec = s.C / vec;
#define LN_STAGED(V) \
  if (vec == V) return staged_fwd<T, V>(p, s, dims, eps, stream);
  if constexpr (sizeof(T) == 2) {
    LN_STAGED(8)
  }
  LN_STAGED(4)
  LN_STAGED(2)
  LN_STAGED(1)
#undef LN_STAGED
  return cudaErrorInvalidValue;
}

template <class T, int VEC>
cudaError_t stream_bwd(void* const* p, Shape s, const int* dims,
                       cudaStream_t stream) {
  auto kernel = ln_stream_bwd_kernel<T, VEC>;
  const size_t bytes = (HEAD + 4 * THREADS) * sizeof(float);
  cudaError_t err = allow(kernel, bytes);
  if (err != cudaSuccess) return err;
  // A row of `partial` a block, CHUNK rows a block where there are as
  // many: no more blocks than rows of `partial`, a whole number of
  // clusters of up to CLUSTER blocks (rounded down).
  int blocks = std::min((s.rows + CHUNK - 1) / CHUNK,
                        std::min(dims[3], dims[4]));
  const int cluster = std::min(CLUSTER, blocks);
  blocks = blocks / cluster * cluster;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks);
  config.blockDim = dim3(THREADS);
  config.dynamicSmemBytes = bytes;
  config.stream = stream;
  config.attrs = &attr;
  config.numAttrs = 1;
  int held = 0;
  err = cudaOccupancyMaxActiveClusters(&held, kernel, &config);
  if (err != cudaSuccess) return err;
  if (held > 0 && blocks > held * cluster) {
    blocks = held * cluster;
    config.gridDim = dim3(blocks);
  }
  if (dims[5] < cluster) return cudaErrorInvalidValue;
  return cudaLaunchKernelEx(
      &config, kernel, static_cast<const T*>(p[0]),
      static_cast<const float*>(p[1]), static_cast<const float*>(p[2]),
      static_cast<const float*>(p[3]), static_cast<const float*>(p[4]),
      static_cast<const T*>(p[5]), static_cast<T*>(p[6]),
      static_cast<float*>(p[7]), static_cast<float*>(p[8]),
      static_cast<float*>(p[9]), static_cast<unsigned*>(p[10]), s, cluster);
}

// The cluster backward. dims as `run` reads them: [6] blocks a cluster,
// [7] threads a block, [8] the vector's values, [9] clusters at most;
// `partial` (dims[4] rows) and the counters (dims[5]) must hold the
// clusters' and their groups' (row_cluster.cuh).
template <class T, int VEC, int NV>
cudaError_t cluster_bwd(void* const* p, Shape s, const int* dims,
                        cudaStream_t stream) {
  auto kernel = ln_cluster_bwd_kernel<T, VEC, NV>;
  constexpr int B = row_cluster::rows_at(2 * NV * VEC * (int)sizeof(T));
  const int ranks = dims[6], threads = dims[7];
  if (ranks > row_cluster::MAX_RANKS || threads > THREADS ||
      threads % 32)
    return cudaErrorInvalidValue;
  const size_t bytes =
      (row_cluster::head_floats<B>() + 2 * NV * VEC * threads) *
      sizeof(float);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t config;
  int clusters = std::min(dims[9], s.rows);
  cudaError_t err = row_cluster::configure(kernel, ranks, threads, bytes,
                                           stream, &attr, &config, &clusters);
  if (err != cudaSuccess) return err;
  // A run of `per` rows a cluster, every cluster with one.
  const int per = (s.rows + clusters - 1) / clusters;
  clusters = (s.rows + per - 1) / per;
  config.gridDim = dim3(ranks * clusters);
  // The clusters' rows of `partial`, then the groups' (where clusters take
  // several rows each and meet in groups); a counter a rank, and a counter a
  // rank for each group.
  int groups = 0;
  if (clusters > 1 && per > 1) row_cluster::group_size(clusters, &groups);
  if (clusters + (groups > 1 ? groups : 0) > dims[4] ||
      row_cluster::MAX_RANKS * (1 + groups) > dims[5])
    return cudaErrorInvalidValue;
  return cudaLaunchKernelEx(
      &config, kernel, static_cast<const T*>(p[0]),
      static_cast<const float*>(p[1]), static_cast<const float*>(p[2]),
      static_cast<const float*>(p[3]), static_cast<const float*>(p[4]),
      static_cast<const T*>(p[5]), static_cast<T*>(p[6]),
      static_cast<float*>(p[7]), static_cast<float*>(p[8]),
      static_cast<float*>(p[9]), static_cast<unsigned*>(p[10]), s, ranks,
      per);
}

// The cluster backward at the vector dims[8] and the vectors a lane keeps
// (the fewest of 1, 2, 4, 8, 16 that hold the row, at most 32 bytes of x a
// lane).
template <class T>
cudaError_t run_cluster(void* const* p, Shape s, const int* dims,
                        cudaStream_t stream) {
  const int vec = dims[8], lanes = dims[6] * dims[7];
  if (vec <= 0 || s.C % vec || vec * (int)sizeof(T) > 16 || lanes <= 0)
    return cudaErrorInvalidValue;
  s.nvec = s.C / vec;
  int nv = 1;
  while ((long)nv * lanes < s.nvec) nv *= 2;
#define LN_CLUSTER(V, NN)                                               \
  if constexpr (V * NN * sizeof(T) <= 32 && V * sizeof(T) <= 16)        \
    if (vec == V && nv == NN) return cluster_bwd<T, V, NN>(p, s, dims, stream);
#define LN_CLUSTERS(V)                                                  \
  LN_CLUSTER(V, 1) LN_CLUSTER(V, 2) LN_CLUSTER(V, 4) LN_CLUSTER(V, 8)   \
  LN_CLUSTER(V, 16)
  LN_CLUSTERS(8)
  LN_CLUSTERS(4)
  LN_CLUSTERS(2)
  LN_CLUSTERS(1)
#undef LN_CLUSTERS
#undef LN_CLUSTER
  return cudaErrorInvalidValue;
}

}  // namespace

// The cluster backward (layer_norm_act_bwd's pointers and dims). Its
// instantiations are compiled beside this file's, by an nvcc of their own
// (layer_norm_cluster.cu includes this file with LAYER_NORM_CLUSTER_PART
// defined), and the two objects are linked into one library
// (ops/build.py, `parts`).
#ifdef LAYER_NORM_CLUSTER_PART
extern "C" int layer_norm_cluster_bwd(int bf16, void* const* ptrs,
                                      const int* dims, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Shape s;
  int vec;
  if (bf16) {
    plan<__nv_bfloat16>(dims[0], dims[1], dims[2], &s, &vec);
    return run_cluster<__nv_bfloat16>(ptrs, s, dims, st);
  }
  plan<float>(dims[0], dims[1], dims[2], &s, &vec);
  return run_cluster<float>(ptrs, s, dims, st);
}
#else
extern "C" int layer_norm_cluster_bwd(int bf16, void* const* ptrs,
                                      const int* dims, void* stream);
#endif

// The staged forward (layer_norm_act_fwd's pointers and dims), compiled
// beside this file as the cluster backward is (layer_norm_staged.cu).
#ifdef LAYER_NORM_STAGED_PART
extern "C" int layer_norm_staged_fwd(int bf16, void* const* ptrs,
                                     const int* dims, float eps,
                                     void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Shape s;
  int vec;
  if (bf16) {
    plan<__nv_bfloat16>(dims[0], dims[1], dims[2], &s, &vec);
    return run_staged<__nv_bfloat16>(ptrs, s, dims, eps, st);
  }
  plan<float>(dims[0], dims[1], dims[2], &s, &vec);
  return run_staged<float>(ptrs, s, dims, eps, st);
}
#else
extern "C" int layer_norm_staged_fwd(int bf16, void* const* ptrs,
                                     const int* dims, float eps,
                                     void* stream);
#endif

namespace {

// One launch (forward or backward) at the plan's VEC and N, or where the
// plan holds no row of C values (0), the staged forward where the caller
// asks for it (dims[4] > 0), the backward's cluster kernel where the
// caller gives it a cluster (dims[6] > 0), else the streaming kernels at
// the widest vector of up to 16 bytes that C is a multiple of.
template <class T>
cudaError_t run(bool backward, void* const* p, const int* dims, float eps,
                cudaStream_t stream) {
  Shape s;
  int vec;
  if (dims[0] <= 0 || dims[1] <= 0 || dims[3] <= 0)
    return cudaErrorInvalidValue;
  const int n = plan<T>(dims[0], dims[1], dims[2], &s, &vec);
  if (n == 0 && backward && dims[6] > 0)
    return static_cast<cudaError_t>(
        layer_norm_cluster_bwd(sizeof(T) == 2, p, dims, stream));
  if (n == 0 && !backward && dims[4] > 0)
    return static_cast<cudaError_t>(
        layer_norm_staged_fwd(sizeof(T) == 2, p, dims, eps, stream));
  if (n == 0) {
    for (vec = 16 / (int)sizeof(T); s.C % vec;) vec /= 2;
    s.nvec = s.C / vec;
#define LN_STREAM(V)                                                    \
  if (vec == V)                                                         \
    return backward ? stream_bwd<T, V>(p, s, dims, stream)              \
                    : stream_fwd<T, V>(p, s, dims, eps, stream);
    if constexpr (sizeof(T) == 2) {
      LN_STREAM(8)
    }
    LN_STREAM(4)
    LN_STREAM(2)
    LN_STREAM(1)
#undef LN_STREAM
    return cudaErrorInvalidValue;
  }
#define LN_CASE(V, NN)                                                  \
  if constexpr (V * NN <= max_values<T>())                              \
    if (vec == V && n == NN)                                            \
      return backward ? bwd<T, V, NN>(p, s, dims, stream)               \
                      : fwd<T, V, NN>(p, s, dims, eps, stream);
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

#if !defined(LAYER_NORM_CLUSTER_PART) && !defined(LAYER_NORM_STAGED_PART)
// ptrs: x, scale, bias, y, mean, rstd. dims: rows, C, act (0 none, 1
// elu), max_blocks, and for rows past the plan the staged forward's
// buffers a block (0: the streaming kernel), threads a block (0: by the
// rows) and most blocks.
extern "C" int layer_norm_act_fwd(int bf16, void* const* ptrs,
                                  const int* dims, float eps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? run<__nv_bfloat16>(false, ptrs, dims, eps, st)
              : run<float>(false, ptrs, dims, eps, st);
}

// ptrs: x, scale, bias, mean, rstd, dy, dx, partial [a row a cluster][2
// Cp] (Cp: C rounded up to 4), dscale, dbias, tickets (unsigned, zero
// between launches). dims: rows, C, act, max_blocks, rows of partial,
// tickets, and for rows past the plan the cluster kernel's blocks a
// cluster (0: the streaming kernel), threads a block, vector and clusters
// at most.
extern "C" int layer_norm_act_bwd(int bf16, void* const* ptrs,
                                  const int* dims, float eps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? run<__nv_bfloat16>(true, ptrs, dims, eps, st)
              : run<float>(true, ptrs, dims, eps, st);
}
#endif  // the parts

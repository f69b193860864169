// The product of observe_bwd.cu across a thread block cluster. It builds on
// observe_common.cuh (R = 2 rows, NT = 1024 threads, the vectors' layout
// [n][R], the 16-byte weight loads, the LayerNorms) and leaves that header,
// which observe_fwd.cu and observe.cu share, as it is.
//
// A cluster of CL = 4 blocks owns one pair of rows. Every block (rank) holds
// every vector of the step in its own shared memory, and the ranks hold
// them bit for bit alike: whatever is not a product (LayerNorm statistics,
// the softmax, the GRU's elementwise part) every rank computes for itself
// from the same values in the same order. A product is split by output
// columns: cdense() gives each rank a quarter of the columns (in units of
// the V columns of one 16-byte load, so the split is ragged where N / V is
// no multiple of 4, and a rank may own none). The rank splits K into up to
// 64 interleaved slices among its threads, so that all 1024 threads fetch
// and each has few weight rows to wait for; the slices' partial sums meet
// in the rank's shared memory and are added in a fixed order, two lanes an
// output; each sum is then written into the vector in all four shared
// memories (distributed shared memory), and the cluster meets at its
// barrier before anyone reads the vector.
//
// Why 4 blocks and not the 8 a cluster may have: a block holds 160 KB, so
// one fits an SM, and of clusters of 8 such blocks only 15 fit an H100 at
// once (cudaOccupancyMaxActiveClusters) where the xarm batch needs 16: the
// last cluster waited for a whole run of the others, 13.8 ms. Of clusters
// of 4, 30 fit. The constants are the best of a sweep on the card (NVIDIA
// H100 80GB HBM3, 700 W, xarm shape, bfloat16; slices / lanes: 32 / 4
// 7.4 ms, 128 / 8 7.7, 64 / 4 6.5, 32 / 2 7.0, 64 / 2 6.3).
//
// A rank that is ahead writes its columns of Y into the others while they
// may still be between the barrier before and this one. So between those
// two barriers a rank's own code must not touch Y, except that it may read
// its own columns of it (the addend). observe_bwd.cu orders its step so.
//
// The workspace. Where a step's vectors outgrow shared memory (deter past
// about 2 300 in observe_bwd.cu at xarm's other widths, or many prior
// layers), a kernel's wide instantiation (WS) keeps them in global memory
// instead: each block a copy of its own, `stride` floats after the copy
// of the block before, which the wrapper allocates and which stays in L2
// at these sizes. cdense() then writes each sum into the four ranks'
// copies there; the cluster's barrier orders those writes before the
// reads as it orders the shared memory's (release and acquire at the
// cluster's scope). Everything else reads and writes its own copy as it
// did its shared memory. The scratch of the products, the row sums and
// the classes stay in shared memory.

#pragma once

#include "hopper_ptx.cuh"
#include "observe_common.cuh"

namespace obc {

using namespace obs;

constexpr int CL = 4;       // Blocks in a cluster.
constexpr int KSMAX = 64;   // Most slices of K.
constexpr int CGMAX = 64;   // Most column groups of a rank in one go.
constexpr int LANES = 2;    // Lanes that add one output's partial sums.

static_assert(NT / CGMAX * CGMAX * 8 * R <= SCRATCH, "scratch holds a go");

// obs::accumulate with `slices` interleaved slices of K, of which this
// thread takes slice ks.
template <typename T, int V>
__device__ __forceinline__ void accumulate(float (&acc)[V][R],
                                           const In<T>& in, int C, int N,
                                           int n, int ks, int slices) {
  if (in.idx) {
    float g[V][R];
#pragma unroll
    for (int c = 0; c < V; ++c)
#pragma unroll
      for (int r = 0; r < R; ++r) g[c][r] = 0.f;
    const int S = in.K / C;
    for (int s = ks; s < S; s += slices) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int k = s * C + in.idx[s * R + r];
        const Vec<V> w = load_v<V>(in.W + (size_t)k * N + n);
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
    for (int k = ks; k < in.K; k += slices) {
      const Vec<V> w = load_v<V>(in.W + (size_t)k * N + n);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float x = in.X[k * R + r];
#pragma unroll
        for (int c = 0; c < V; ++c) acc[c][r] = fmaf(x, w.v[c], acc[c][r]);
      }
    }
  }
}

// obs::row_sum for M sums at once, with the warps' partials met by a
// butterfly in place of a walk over all of them by every thread: what is
// left of a step once its products are split is a chain of such small
// phases, which every rank runs alike. A thread's partials belong to row
// threadIdx.x % R; red: M * NW * R floats. Every thread of a row ends with
// the same bits.
template <int M>
__device__ __forceinline__ void row_sums(float (&v)[M], float* red) {
#pragma unroll
  for (int o = 16; o >= R; o >>= 1)
#pragma unroll
    for (int m = 0; m < M; ++m) v[m] += __shfl_xor_sync(0xffffffffu, v[m], o);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  __syncthreads();  // An earlier call's readers are done with red.
  if (lane < R)
#pragma unroll
    for (int m = 0; m < M; ++m) red[(m * NW + warp) * R + lane] = v[m];
  __syncthreads();
  // Lane l adds the partials of warps l / R, l / R + 32 / R, ... for its
  // row l % R; then the lanes of a row meet.
#pragma unroll
  for (int m = 0; m < M; ++m) {
    v[m] = 0.f;
    for (int w = lane / R; w < NW; w += 32 / R)
      v[m] += red[(m * NW + w) * R + lane % R];
  }
#pragma unroll
  for (int o = 16; o >= R; o >>= 1)
#pragma unroll
    for (int m = 0; m < M; ++m) v[m] += __shfl_xor_sync(0xffffffffu, v[m], o);
}

// obs::ln_fwd on row_sums(). Ends with a barrier.
template <typename T>
__device__ void ln_forward(const float* Z, int N, const T* scale,
                           const T* bias, float* xhat, float* inv,
                           bool use_elu, float* act, float* red) {
  const int tid = threadIdx.x, total = N * R;
  float s[1] = {0.f};
  for (int i = tid; i < total; i += NT) s[0] += Z[i];
  row_sums(s, red);
  const float mean = s[0] / N;
  float v[1] = {0.f};
  for (int i = tid; i < total; i += NT) {
    const float d = Z[i] - mean;
    v[0] += d * d;
  }
  row_sums(v, red);
  const float iv = rsqrtf(v[0] / N + 1e-3f);
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

// obs::ln_bwd with its two sums in one row_sums(). Ends with a barrier.
template <typename T>
__device__ void ln_backward(float* G, int N, const float* xhat,
                            const float* inv, const T* scale, float* red) {
  const int tid = threadIdx.x, total = N * R;
  float s[2] = {0.f, 0.f};
  for (int i = tid; i < total; i += NT) {
    const float dx = G[i] * to_f(scale[i / R]);
    s[0] += dx;
    s[1] += dx * xhat[i];
  }
  row_sums(s, red);
  const float m1 = s[0] / N, m2 = s[1] / N;
  const float iv = inv[tid % R];
  for (int i = tid; i < total; i += NT) {
    const float dx = G[i] * to_f(scale[i / R]);
    G[i] = iv * (dx - m1 - xhat[i] * m2);
  }
  __syncthreads();
}

// Y[n][r] = a.X @ a.W (+ b.X @ b.W) (+ bias[n]) (+ addend[n][r]) in every
// rank of the cluster, this rank computing its share of the columns, V at
// a time. N is a multiple of V. Y must be none of the inputs; addend may be
// Y. scratch holds SCRATCH floats. With WS, Y lies in the workspace, the
// ranks' copies `stride` floats apart. Every thread of every rank must
// call it; it ends with the cluster's barrier.
template <typename T, int V, bool WS>
__device__ __forceinline__ void cdense_body(
    float* Y, int N, const In<T>& a, const In<T>& b, int C, const T* bias,
    const float* addend, float* scratch, int rank, size_t stride) {
  const int groups = N / V;
  const int g_end = (rank + 1) * groups / CL;
  for (int g0 = rank * groups / CL; g0 < g_end; g0 += CGMAX) {
    const int ng = min(CGMAX, g_end - g0);
    const int slices = min(KSMAX, NT / ng);
    const int outputs = ng * V * R;
    const int cg = threadIdx.x % ng, ks = threadIdx.x / ng;
    if (ks < slices) {
      const int n = (g0 + cg) * V;
      float acc[V][R];
#pragma unroll
      for (int c = 0; c < V; ++c)
#pragma unroll
        for (int r = 0; r < R; ++r) acc[c][r] = 0.f;
      accumulate<T, V>(acc, a, C, N, n, ks, slices);
      if (b.W) accumulate<T, V>(acc, b, C, N, n, ks, slices);
      float* s = scratch + (size_t)ks * outputs + cg * V * R;
#pragma unroll
      for (int c = 0; c < V; ++c)
#pragma unroll
        for (int r = 0; r < R; ++r) s[c * R + r] = acc[c][r];
    }
    __syncthreads();
    // LANES lanes an output: each adds every LANES-th partial in order,
    // the first also the bias and the addend (read here, before any lane
    // writes Y: a lane that wrote its rank's Y first would hand the others
    // the sum for an addend), then the lanes' sums meet in a butterfly, so
    // all hold the same bits; each writes the sum into its share of the
    // ranks.
    for (int base = 0; base < outputs * LANES; base += NT) {
      const int e = base + threadIdx.x, o = e / LANES, part = e % LANES;
      const int at = g0 * V * R + o;  // [column][row] in Y.
      float v = 0.f;
      if (o < outputs) {
        for (int j = part; j < slices; j += LANES)
          v += scratch[(size_t)j * outputs + o];
        if (part == 0 && bias) v += to_f(bias[at / R]);
        if (part == 0 && addend) v += addend[at];
      }
#pragma unroll
      for (int m = 1; m < LANES; m <<= 1)
        v += __shfl_xor_sync(0xffffffffu, v, m);
      if (o < outputs)
        for (int q = part; q < CL; q += LANES) {
          if constexpr (WS)
            Y[at + (q - rank) * (ptrdiff_t)stride] = v;
          else
            *ptx::cluster_map(Y + at, q) = v;
        }
    }
    __syncthreads();
  }
  ptx::cluster_sync();
}


// cdense_body as a function of its own, for Y in shared memory: the
// product of the shipped paths, its parameters as they always were.
template <typename T, int V>
__device__ void cdense_shared(float* Y, int N, const In<T>& a,
                              const In<T>& b, int C, const T* bias,
                              const float* addend, float* scratch,
                              int rank) {
  cdense_body<T, V, false>(Y, N, a, b, C, bias, addend, scratch, rank, 0);
}

// The same for Y in the workspace (the wide paths).
template <typename T, int V>
__device__ void cdense_ws(float* Y, int N, const In<T>& a, const In<T>& b,
                          int C, const T* bias, const float* addend,
                          float* scratch, int rank, size_t stride) {
  cdense_body<T, V, true>(Y, N, a, b, C, bias, addend, scratch, rank,
                          stride);
}

// The product of a kernel whose vectors lie in its workspace with WS, else
// in shared memory (stride is then unused).
template <typename T, int V = VMAX<T>, bool WS = false>
__device__ __forceinline__ void cdense(float* Y, int N, const In<T>& a,
                                       const In<T>& b, int C, const T* bias,
                                       const float* addend, float* scratch,
                                       int rank, size_t stride = 0) {
  if constexpr (WS)
    cdense_ws<T, V>(Y, N, a, b, C, bias, addend, scratch, rank, stride);
  else
    cdense_shared<T, V>(Y, N, a, b, C, bias, addend, scratch, rank);
}

}  // namespace obc

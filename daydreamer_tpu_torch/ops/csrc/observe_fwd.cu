// Fused RSSM observe chain, forward, for Hopper (sm_90a).
//
// Replaces daydreamer_tpu/ops/pallas_rssm_vjp.py::_obs_fwd_kernel (launched
// by _observe_fused_fwd). For each of B rows and T steps: the is_first mask
// on the incoming stoch, deter and action; the image cell (split product
// over stoch and action, LN, ELU; GRU with LN and update bias -1; the
// prior MLP); the raw prior logits; the posterior head over [deter, embed]
// (LN, ELU, logits); the softmax within each group of C classes, the
// unimix, and a Gumbel-max one-hot (the first maximum of a group). It
// writes deters and stochs in the element type T and both logits raw in
// float32. All arithmetic is float32; only the carries are rounded to T.
// The Gumbel noise is an input (null: the modes).
//
// Bound. At the xarm shape (T = 32 steps of B = 32 rows, D = U = 512,
// S * C = 1024, E = 2560, three prior layers) a row-step is about 5.0 M
// dense multiply-adds plus a gather of S weight rows, 10.3 GFLOP in all,
// 10.4 us at 989 TFLOP/s; the bytes are the 11 MB of bf16 weights once plus
// 21 MB of inputs, noise and outputs, 9.6 us at 3.35 TB/s. The roofline
// does not describe this kernel: the chain has only 32 independent rows
// and 32 dependent steps of dependent layers, so it is bound by latency.
//
// Design. The parent kernel ran every step whole in one block per pair of
// rows, 16 SMs, each pulling about 9.9 MB of weights a step from L2: 5.1 ms
// (NVIDIA H100 80GB HBM3, 700 W, xarm shape, bfloat16). Two pieces of a
// step are not part of the chain: the prior head reads this step's d_t
// and nothing later reads its output, and e @ w_obs_e reads only inputs.
// Together they were half the weights a step streamed and half its
// LayerNorms. So one call makes three launches, in order on the stream:
//   1. embed_kernel: e_proj = embeds @ w_obs_e for all T * B rows, in
//      float32, into a scratch [T][B][U]. RW = 8 rows a block (128 blocks
//      at xarm), embeds staged through shared memory KC rows of K at a
//      time, so any E is taken; FMA in float32 (tensor cores would sum
//      differently, and the Gumbel choices follow the sums).
//   2. chain_kernel: the time loop, cut to what the next step needs: the
//      masked inputs, [stoch, action] @ W_in (a gather from step 1 on), LN,
//      ELU; the GRU with its LN; d_t; d_t @ w_obs_d + e_proj[t], LN, ELU;
//      @ w_post + b_post; the sample. It runs in observe_bwd's layout
//      (observe_cluster.cuh): a thread block cluster of CL = 4 blocks per
//      pair of rows, each product's columns split among the ranks, the
//      rest computed alike on every rank, each output stored by one rank
//      in turns. Its sample gives a warp to each group of C classes. Its
//      cluster size is given at the launch (cudaLaunchKernelEx), so that
//      observe_fwd_clusters can ask how many clusters of 4 and of 8 fit.
//      It writes d_t in float32 to a second scratch [T][B][D]: the prior
//      head reads d_t unrounded.
//   3. prior_kernel: over all T * B rows of that d_t, the n_out layers of
//      Linear + LN + ELU and @ w_st + b_st into the prior logits: RW = 8
//      rows a block for all layers, weights from L2, float32 sums.
// The wide products (1, 3) give a thread the V columns of one 16-byte
// weight load and one of KSW interleaved slices of K; the slices' partial
// sums meet in shared memory and are added in a fixed order. The call takes
// 1.74 ms in place of 5.13 (same card and shape), 1.46 of it the chain.
// Clusters of 8 would halve each rank's columns, but only 15 fit the card
// at once where the xarm batch needs 16 (observe_fwd_clusters; 30 of 4).
//
// Every width the JAX kernel takes. The products read V weights at a time, a
// template argument the wrapper picks from the widths (observe_common.cuh:
// 16-byte loads at the shipped widths, single values where a row is no multiple
// of 16 bytes). The prior head takes any number of layers, 0 included (the head
// then reads d_t): up to MAXL the layers' addresses lie in the launch's
// parameters as they always did, past it in a second instantiation of
// prior_kernel whose parameters hold MANY. Where the chain's vectors outgrow
// shared memory (deter past about 2 300 at xarm's other widths) the wrapper
// hands over a workspace and the chain's wide instantiation keeps them there
// (observe_cluster.cuh).

#include "observe_cluster.cuh"

namespace {

using namespace obc;

struct Params {
  const void *stoch0, *deter0, *actions, *embeds;
  const float *first, *noise;
  void* deter_out;
  float *post_out, *prior_out;
  void* stoch_out;
  const void *w_in_s, *w_in_a, *ln_in_s, *ln_in_b;
  const void *w_gru_d, *w_gru_x, *ln_gru_s, *ln_gru_b;
  const void *w_st, *b_st, *w_obs_d, *w_obs_e, *ln_obs_s, *ln_obs_b;
  const void *w_post, *b_post;
  float *eproj, *dt;  // Scratch: [T][B][U], [T][B][D], float32.
  float* ws;          // The chain's workspace, or null (shared memory).
  int T, B, A, E, D, U, S, C, n_out;
  float unimix;
};

// The prior layers' addresses, up to L of them: prior_kernel's second
// parameter.
template <int L>
struct Layers {
  const void *w_out[L], *ln_out_s[L], *ln_out_b[L];
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---- The wide products: embed_kernel and prior_kernel -------------------

constexpr int RW = 8;            // Rows a block.
constexpr int NTW = 256;         // Threads a block: a warp a row for LN.
constexpr int CGW = 64;          // Column groups of a pass.
constexpr int KSW = NTW / CGW;   // Slices of K.
constexpr int KC = 512;          // Rows of K of embeds staged at a time.

static_assert(NTW == 32 * RW && KC % KSW == 0, "wide layout");

// Columns of a pass: CGW groups of V.
template <int V>
__host__ __device__ constexpr int pass_w() { return CGW * V; }

// acc[c][r] += X[k - k0][r] * W[k][n + c] over the k of [k0, k1) in slice
// ks. X: [k1 - k0][RW] float in shared memory; W: [K][N] in T.
template <typename T, int V>
__device__ __forceinline__ void rows_accumulate(
    float (&acc)[V][RW], const float* X, int k0, int k1, int ks,
    const T* W, int N, int n) {
#pragma unroll 8
  for (int k = k0 + ks; k < k1; k += KSW) {
    const Vec<V> w = load_v<V>(W + (size_t)k * N + n);
    const float4 xa = *reinterpret_cast<const float4*>(X + (k - k0) * RW);
    const float4 xb = *reinterpret_cast<const float4*>(X + (k - k0) * RW + 4);
    const float x[RW] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
    for (int c = 0; c < V; ++c)
#pragma unroll
      for (int r = 0; r < RW; ++r) acc[c][r] = fmaf(x[r], w.v[c], acc[c][r]);
  }
}

// The pass's partial sums into scratch [KSW][RW][pass], then each output
// adds its KSW partials in order (+ bias[n]) into Y[r * ldy + n] for the
// first `rows` rows. Ends with a barrier.
template <typename T, int V>
__device__ __forceinline__ void rows_reduce(
    const float (&acc)[V][RW], float* scratch, int base, int N,
    const T* bias, float* Y, int ldy, int rows) {
  constexpr int PASS_W = pass_w<V>();
  const int cg = threadIdx.x % CGW, ks = threadIdx.x / CGW;
#pragma unroll
  for (int c = 0; c < V; ++c)
#pragma unroll
    for (int r = 0; r < RW; ++r)
      scratch[(ks * RW + r) * PASS_W + cg * V + c] = acc[c][r];
  __syncthreads();
  for (int e = threadIdx.x; e < RW * PASS_W; e += NTW) {
    const int r = e / PASS_W, c = e % PASS_W, n = base + c;
    if (n < N && r < rows) {
      float v = 0.f;
#pragma unroll
      for (int j = 0; j < KSW; ++j) v += scratch[(j * RW + r) * PASS_W + c];
      if (bias) v += to_f(bias[n]);
      Y[(size_t)r * ldy + n] = v;
    }
  }
  __syncthreads();
}

// Y[r][n] = X @ W (+ bias) for X [K][RW] in shared memory. Ends with a
// barrier.
template <typename T, int V>
__device__ void rows_dense(const float* X, int K, const T* W, int N,
                           const T* bias, float* scratch, float* Y, int ldy,
                           int rows) {
  constexpr int PASS_W = pass_w<V>();
  const int n_of = (threadIdx.x % CGW) * V, ks = threadIdx.x / CGW;
  for (int base = 0; base < N; base += PASS_W) {
    float acc[V][RW] = {};
    if (base + n_of < N)
      rows_accumulate<T, V>(acc, X, 0, K, ks, W, N, base + n_of);
    rows_reduce<T, V>(acc, scratch, base, N, bias, Y, ldy, rows);
  }
}

template <int V>
size_t embed_bytes() {
  return sizeof(float) * ((size_t)KC * RW + (size_t)KSW * RW * pass_w<V>());
}

// e_proj[m][n] = embeds[m] @ w_obs_e for RW rows m of the T * B.
template <typename T, int V>
__global__ void __launch_bounds__(NTW) embed_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int PASS_W = pass_w<V>();
  float* s_x = smem;                  // [KC][RW]
  float* scratch = s_x + KC * RW;     // [KSW][RW][PASS_W]
  const int M = p.T * p.B, E = p.E, U = p.U, row0 = blockIdx.x * RW;
  const T* embeds = static_cast<const T*>(p.embeds);
  const T* w = static_cast<const T*>(p.w_obs_e);
  const int tid = threadIdx.x, n_of = (tid % CGW) * V, ks = tid / CGW;
  for (int base = 0; base < U; base += PASS_W) {
    float acc[V][RW] = {};
    for (int k0 = 0; k0 < E; k0 += KC) {
      const int width = min(KC, E - k0);
      __syncthreads();  // Every thread is done with the chunk before.
      for (int i = tid; i < RW * width; i += NTW) {
        const int r = i / width, k = i % width, row = row0 + r;
        s_x[k * RW + r] =
            row < M ? to_f(embeds[(size_t)row * E + k0 + k]) : 0.f;
      }
      __syncthreads();
      if (base + n_of < U)
        rows_accumulate<T, V>(acc, s_x, k0, k0 + width, ks, w, U,
                              base + n_of);
    }
    rows_reduce<T, V>(acc, scratch, base, U, nullptr,
                   p.eproj + (size_t)row0 * U, U, M - row0);
  }
}

template <int V>
size_t prior_bytes(const Params& p) {
  const int K = p.D > p.U ? p.D : p.U;
  return sizeof(float) * ((size_t)K * RW + (size_t)RW * p.U +
                          (size_t)KSW * RW * pass_w<V>());
}

// The prior head over RW rows of the chain's float32 d_t: n_out layers of
// Linear + LN (eps 1e-3) + ELU, then @ w_st + b_st into the prior logits
// (with no layer, d_t @ w_st + b_st).
template <typename T, int V, int L>
__global__ void __launch_bounds__(NTW) prior_kernel(Params p,
                                                    Layers<L> layers) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.D, U = p.U, SC = p.S * p.C, M = p.T * p.B;
  float* s_x = smem;                  // Layer input [K][RW].
  float* s_y = s_x + max(D, U) * RW;  // Layer sums [RW][U].
  float* scratch = s_y + RW * U;
  const int tid = threadIdx.x, row0 = blockIdx.x * RW;
  auto W = [](const void* w) { return static_cast<const T*>(w); };
  for (int i = tid; i < RW * D; i += NTW) {
    const int r = i / D, k = i % D, row = row0 + r;
    s_x[k * RW + r] = row < M ? p.dt[(size_t)row * D + k] : 0.f;
  }
  __syncthreads();
  int width = D;
  const int r = tid / 32, lane = tid % 32;
  for (int l = 0; l < p.n_out; ++l) {
    rows_dense<T, V>(s_x, width, W(layers.w_out[l]), U, nullptr, scratch,
                     s_y, U, RW);
    // LayerNorm and ELU of row r, by warp r, into the next layer's input.
    const float* y = s_y + r * U;
    float s = 0.f;
    for (int n = lane; n < U; n += 32) s += y[n];
    const float mean = warp_sum(s) / U;
    float v = 0.f;
    for (int n = lane; n < U; n += 32) v += (y[n] - mean) * (y[n] - mean);
    const float inv = rsqrtf(warp_sum(v) / U + 1e-3f);
    const T* scale = W(layers.ln_out_s[l]);
    const T* bias = W(layers.ln_out_b[l]);
    for (int n = lane; n < U; n += 32)
      s_x[n * RW + r] =
          elu((y[n] - mean) * inv * to_f(scale[n]) + to_f(bias[n]));
    __syncthreads();
    width = U;
  }
  rows_dense<T, V>(s_x, width, W(p.w_st), SC, W(p.b_st), scratch,
                p.prior_out + (size_t)row0 * SC, SC, M - row0);
}

// ---- The chain --------------------------------------------------------

// Every rank holds every vector; one of them stores it, in turns.
__device__ __forceinline__ bool my_turn(int& turn, int rank) {
  return turn++ % CL == rank;
}

// The floats of a block's vectors: in shared memory, or with WS a block's
// copy in the workspace.
__host__ __device__ size_t vector_floats(const Params& p) {
  return (size_t)R * (2 * p.S * p.C + 6 * p.D + p.A + 3 * p.U);
}

template <bool WS>
size_t chain_bytes(const Params& p) {
  const size_t floats = (size_t)R * (1 + NW + p.S) + SCRATCH;
  return (floats + (WS ? 0 : vector_floats(p))) * sizeof(float);
}

template <typename T, int V, bool WS>
__global__ void __launch_bounds__(NT) chain_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.D, U = p.U, A = p.A, S = p.S, C = p.C;
  const int SC = S * C, B = p.B;
  const size_t stride = WS ? vector_floats(p) : 0;
  // stoch0, masked (step 0 only).
  float* s_stoch = WS ? p.ws + blockIdx.x * stride : smem;
  float* s_deter = s_stoch + SC * R;     // The deter carry, rounded to T.
  float* s_dm = s_deter + D * R;         // The masked deter of this step.
  float* s_dt = s_dm + D * R;            // This step's deter, float32.
  float* s_g = s_dt + D * R;             // GRU gates [3D][R].
  float* s_a = s_g + 3 * D * R;
  float* s_h = s_a + A * R;              // Input layer.
  float* s_z2 = s_h + U * R;             // e_proj[t], then z2.
  float* s_x2 = s_z2 + U * R;            // Posterior hidden layer.
  float* s_post = s_x2 + U * R;
  float* s_keep = WS ? smem : s_post + SC * R;
  float* s_red = s_keep + R;
  float* s_scratch = s_red + NW * R;
  int* s_idx = reinterpret_cast<int*>(s_scratch + SCRATCH);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int row0 = blockIdx.x / CL * R, rank = ptx::cluster_rank();
  int turn = 0;  // Counts the stored vectors, see my_turn().
  const In<T> none = {nullptr, nullptr, nullptr, 0, nullptr};
  auto W = [](const void* w) { return static_cast<const T*>(w); };

  load_rows(s_deter, W(p.deter0), D, row0, B, nullptr);
  // No rank writes into another's shared memory before all have started.
  ptx::cluster_sync();

  for (int t = 0; t < p.T; ++t) {
    const size_t tb = (size_t)t * B;
    if (tid < R) {
      const int row = row0 + tid;
      s_keep[tid] = row < B ? 1.f - p.first[tb + row] : 0.f;
    }
    __syncthreads();
    if (t == 0) load_rows(s_stoch, W(p.stoch0), SC, row0, B, s_keep);
    load_rows(s_a, W(p.actions) + tb * A, A, row0, B, s_keep);
    load_rows(s_z2, p.eproj + tb * U, U, row0, B, nullptr);
    for (int i = tid; i < D * R; i += NT) s_dm[i] = s_deter[i] * s_keep[i % R];
    __syncthreads();

    // Image cell input: [stoch, action] @ W_in, LN, ELU.
    const In<T> stoch = t == 0
        ? In<T>{s_stoch, nullptr, nullptr, SC, W(p.w_in_s)}
        : In<T>{nullptr, s_idx, s_keep, SC, W(p.w_in_s)};
    cdense<T, V, WS>(s_h, U, stoch, {s_a, nullptr, nullptr, A, W(p.w_in_a)}, C,
                     nullptr, nullptr, s_scratch, rank, stride);
    ln_forward<T>(s_h, U, W(p.ln_in_s), W(p.ln_in_b), nullptr, nullptr, true,
                  s_h, s_red);
    // GRU gates: [deter, x] @ W_gru, LN; update bias -1.
    cdense<T, V, WS>(s_g, 3 * D, {s_dm, nullptr, nullptr, D, W(p.w_gru_d)},
                     {s_h, nullptr, nullptr, U, W(p.w_gru_x)}, C, nullptr,
                     nullptr, s_scratch, rank, stride);
    ln_forward<T>(s_g, 3 * D, W(p.ln_gru_s), W(p.ln_gru_b), nullptr, nullptr,
                  false, s_g, s_red);
    for (int i = tid; i < D * R; i += NT) {
      const int d = i / R, r = i % R;
      const float reset = sigmoid(s_g[d * R + r]);
      const float cand = tanhf(reset * s_g[(D + d) * R + r]);
      const float update = sigmoid(s_g[(2 * D + d) * R + r] - 1.f);
      const float dt = update * cand + (1.f - update) * s_dm[i];
      s_dt[i] = dt;
      s_deter[i] = rnd<T>(dt);
    }
    __syncthreads();
    if (my_turn(turn, rank))
      store_rows(static_cast<T*>(p.deter_out) + tb * D, s_dt, D, row0, B);
    if (my_turn(turn, rank)) store_rows(p.dt + tb * D, s_dt, D, row0, B);
    // Posterior head: d_t @ w_obs_d + e_proj, LN, ELU, logits.
    cdense<T, V, WS>(s_z2, U, {s_dt, nullptr, nullptr, D, W(p.w_obs_d)}, none,
                     C, nullptr, s_z2, s_scratch, rank, stride);
    ln_forward<T>(s_z2, U, W(p.ln_obs_s), W(p.ln_obs_b), nullptr, nullptr,
                  true, s_x2, s_red);
    cdense<T, V, WS>(s_post, SC, {s_x2, nullptr, nullptr, U, W(p.w_post)}, none,
                     C, W(p.b_post), nullptr, s_scratch, rank, stride);
    if (my_turn(turn, rank))
      store_rows(p.post_out + tb * SC, s_post, SC, row0, B);
    // Sample, a warp a group: the first maximum of log((1-u) softmax(z) +
    // u/C) + g in each group, or of the mixed probabilities themselves
    // without noise. A lane takes the classes lane, lane + 32, ...; the
    // lanes then keep the larger score, or at equal scores the smaller
    // class.
    const bool emit = my_turn(turn, rank);
    for (int q = warp; q < R * S; q += NW) {
      const int r = q / S, s = q % S, row = row0 + r;
      const float* z = s_post + (size_t)s * C * R + r;
      float m = -INFINITY;
      for (int c = lane; c < C; c += 32) m = fmaxf(m, z[c * R]);
      m = warp_max(m);
      float sum = 0.f;
      for (int c = lane; c < C; c += 32) sum += expf(z[c * R] - m);
      sum = warp_sum(sum);
      const float* g = p.noise
          ? p.noise + (tb + min(row, B - 1)) * SC + (size_t)s * C
          : nullptr;
      int best = lane;
      float top = -INFINITY;
      for (int c = lane; c < C; c += 32) {
        float score = expf(z[c * R] - m) / sum;
        if (p.unimix != 0.f)
          score = (1.f - p.unimix) * score + p.unimix / C;
        if (g) score = logf(score) + g[c];
        if (score > top) { top = score; best = c; }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float other = __shfl_xor_sync(0xffffffffu, top, o);
        const int at = __shfl_xor_sync(0xffffffffu, best, o);
        if (other > top || (other == top && at < best)) {
          top = other;
          best = at;
        }
      }
      if (lane == 0) s_idx[s * R + r] = best;  // The stoch carry.
      if (emit && row < B) {
        T* out = static_cast<T*>(p.stoch_out) + (tb + row) * SC + (size_t)s * C;
        for (int c = lane; c < C; c += 32)
          out[c] = from_f<T>(c == best ? 1.f : 0.f);
      }
    }
    __syncthreads();
  }
}

// A launch of the chain with its cluster size.
cudaLaunchConfig_t chain_config(const Params& p, size_t bytes,
                                cudaStream_t stream, int cluster,
                                cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((p.B + R - 1) / R * cluster);  // A pair of rows each.
  config.blockDim = dim3(NT);
  config.dynamicSmemBytes = bytes;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  return config;
}

template <typename T, int V, bool WS>
int launch_chain(const Params& p, cudaStream_t stream) {
  const size_t bytes = chain_bytes<WS>(p);
  cudaError_t err = cudaFuncSetAttribute(
      chain_kernel<T, V, WS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t config = chain_config(p, bytes, stream, CL, &attr);
  return (int)cudaLaunchKernelEx(&config, chain_kernel<T, V, WS>, p);
}

template <typename T, int V, int L>
int launch_prior(const Params& p, const Layers<L>& layers, int tiles,
                 cudaStream_t stream) {
  const size_t bytes = prior_bytes<V>(p);
  const cudaError_t err = cudaFuncSetAttribute(
      prior_kernel<T, V, L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  prior_kernel<T, V, L><<<tiles, NTW, bytes, stream>>>(p, layers);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch(const Params& p, void* const* layers, cudaStream_t stream) {
  const int tiles = (p.T * p.B + RW - 1) / RW;
  if (tiles == 0) return (int)cudaSuccess;
  size_t bytes = embed_bytes<V>();
  cudaError_t err = cudaFuncSetAttribute(
      embed_kernel<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  embed_kernel<T, V><<<tiles, NTW, bytes, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int chain = p.ws ? launch_chain<T, V, true>(p, stream)
                         : launch_chain<T, V, false>(p, stream);
  if (chain != cudaSuccess) return chain;
  // layers: w_out[n_out], ln_out_s[n_out], ln_out_b[n_out].
  auto prior = [&](auto held) {
    Layers<decltype(held)::value> l = {};
    for (int i = 0; i < p.n_out; ++i) {
      l.w_out[i] = layers[i];
      l.ln_out_s[i] = layers[p.n_out + i];
      l.ln_out_b[i] = layers[2 * p.n_out + i];
    }
    return launch_prior<T, V, decltype(held)::value>(p, l, tiles, stream);
  };
  return p.n_out <= MAXL ? prior(std::integral_constant<int, MAXL>())
                         : prior(std::integral_constant<int, MANY>());
}

// launch<T, V> for the V that `values` names.
template <typename T>
int dispatch(const Params& p, void* const* layers, int values,
             cudaStream_t stream) {
  return with_values<T>(values, [&](auto v) {
    return launch<T, decltype(v)::value>(p, layers, stream);
  });
}

template <typename T>
int clusters(const Params& p, int* fit) {
  const size_t bytes = chain_bytes<false>(p);
  auto kernel = chain_kernel<T, VMAX<T>, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  const int sizes[2] = {CL, 8};
  for (int i = 0; i < 2 && err == cudaSuccess; ++i) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t config =
        chain_config(p, bytes, nullptr, sizes[i], &attr);
    err = cudaOccupancyMaxActiveClusters(&fit[i], kernel, &config);
  }
  return (int)err;
}

Params read_dims(const int* dims) {
  Params p = {};
  p.T = dims[0];
  p.B = dims[1];
  p.A = dims[2];
  p.E = dims[3];
  p.D = dims[4];
  p.U = dims[5];
  p.S = dims[6];
  p.C = dims[7];
  p.n_out = dims[8];
  return p;
}

}  // namespace

// ptrs: stoch0, deter0, actions, embeds, first, noise (or null), deter_out,
//   post_out, prior_out, stoch_out, w_in_s, w_in_a, ln_in_s, ln_in_b,
//   w_gru_d, w_gru_x, ln_gru_s, ln_gru_b, w_out[n_out], ln_out_s[n_out],
//   ln_out_b[n_out], w_st, b_st, w_obs_d, w_obs_e, ln_obs_s, ln_obs_b,
//   w_post, b_post, then the scratch eproj [T][B][U] and dt [T][B][D]
//   (float32), and the chain's workspace (float32, a block's vectors a
//   block of the chain's grid) or null (last, so that the parent kernel,
//   which reads as far as b_post, takes the same list).
// dims: T, B, A, E, D, U, S, C, n_out (0 to MANY), values (the V of every
//   load, see observe_common.cuh).
// Returns cudaGetLastError() after the last launch (0 on success).
extern "C" int observe_fwd(int bf16, void* const* ptrs, const int* dims,
                           float unimix, void* stream) {
  Params p = read_dims(dims);
  if (p.n_out < 0 || p.n_out > MANY) return (int)cudaErrorInvalidValue;
  int i = 0;
  p.stoch0 = ptrs[i++];
  p.deter0 = ptrs[i++];
  p.actions = ptrs[i++];
  p.embeds = ptrs[i++];
  p.first = static_cast<const float*>(ptrs[i++]);
  p.noise = static_cast<const float*>(ptrs[i++]);
  p.deter_out = ptrs[i++];
  p.post_out = static_cast<float*>(ptrs[i++]);
  p.prior_out = static_cast<float*>(ptrs[i++]);
  p.stoch_out = ptrs[i++];
  p.w_in_s = ptrs[i++];
  p.w_in_a = ptrs[i++];
  p.ln_in_s = ptrs[i++];
  p.ln_in_b = ptrs[i++];
  p.w_gru_d = ptrs[i++];
  p.w_gru_x = ptrs[i++];
  p.ln_gru_s = ptrs[i++];
  p.ln_gru_b = ptrs[i++];
  void* const* layers = ptrs + i;
  i += 3 * p.n_out;
  p.w_st = ptrs[i++];
  p.b_st = ptrs[i++];
  p.w_obs_d = ptrs[i++];
  p.w_obs_e = ptrs[i++];
  p.ln_obs_s = ptrs[i++];
  p.ln_obs_b = ptrs[i++];
  p.w_post = ptrs[i++];
  p.b_post = ptrs[i++];
  p.eproj = static_cast<float*>(ptrs[i++]);
  p.dt = static_cast<float*>(ptrs[i++]);
  p.ws = static_cast<float*>(ptrs[i++]);
  p.unimix = unimix;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(p, layers, dims[9], s)
              : dispatch<float>(p, layers, dims[9], s);
}

// fit[0], fit[1]: how many clusters of CL and of 8 blocks of the chain fit
// the card at once at these dims (cudaOccupancyMaxActiveClusters); the
// chain needs one per pair of rows. dims as observe_fwd's.
extern "C" int observe_fwd_clusters(int bf16, const int* dims, int* fit) {
  const Params p = read_dims(dims);
  return bf16 ? clusters<__nv_bfloat16>(p, fit) : clusters<float>(p, fit);
}

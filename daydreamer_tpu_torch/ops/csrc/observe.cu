// RSSM observe chain, forward only, for Hopper (sm_90a).
//
// Replaces daydreamer_tpu/ops/pallas_rssm.py::_observe_kernel (entry
// observe_pallas). For each of B rows and T steps: the incoming stoch,
// deter and action are zeroed where is_first; the image cell gives the new
// deter (split product over stoch and action, LN, ELU; GRU with LN and
// update bias -1; the prior head is not needed and not computed); the
// posterior head over [deter, embed] (LN, ELU, logits); a Gumbel-max
// one-hot of the posterior per group of C classes, which is the next
// step's stoch. It writes deters and stochs in the element type T and the
// posterior logits raw in float32. Every product is rounded to T, and so
// is every LayerNorm and ELU, as the JAX cell rounds them (observe_fwd.cu,
// the training path's chain, is float32 throughout: in bfloat16 the two
// differ). The Gumbel noise is an input (null: the argmax of the logits);
// the TPU kernel's in-core generator and its literal unimix mixture are
// replaced by argmax(log((1-u) softmax(z) + u/C) + g), the same
// distribution.
//
// Bound. At the xarm proof shape (T = 32 steps of B = 32 rows, D = U = 512,
// S * C = 1024, E = 512, A = 5) a row-step is about 2.6 M dense
// multiply-adds plus a gather of S weight rows, 5.4 GFLOP in all, 5.5 us at
// 989 TFLOP/s bf16; the bytes are 6 MB of bf16 weights once plus 13 MB of
// inputs, noise and outputs, 5.7 us at 3.35 TB/s, so the bytes bound it by
// a hair. The prior head's weights are neither read nor counted. The
// roofline does not describe the kernel: 32 rows walk 32 dependent steps of
// dependent layers, so it is bound by latency.
//
// Design. The parent kernel ran every step whole in one block per pair of
// rows, 16 SMs, each pulling about 5.2 MB of weights a step from L2: 3.25
// ms (NVIDIA H100 80GB HBM3, 700 W, xarm proof shape, bfloat16). The embed
// half of the posterior head's product reads only inputs, so one call
// makes two launches, in order on the stream, as observe_fwd.cu does:
//   1. embed_kernel: e_proj = embeds @ w_obs_e for all T * B rows, in
//      float32 and unrounded, into a scratch [T][B][U]: the reference sums
//      deter @ w_obs_d + embed @ w_obs_e in float32 and rounds once, so
//      e_proj is the float32 addend of the chain's w_obs_d product. RW = 8
//      rows a block, embeds staged through shared memory KC rows of K at a
//      time, so any E is taken; FMA in float32 (tensor cores would sum
//      differently, and the Gumbel choices follow the sums).
//   2. chain_kernel: the time loop: the masked inputs, [stoch, action] @
//      W_in (a gather from step 1 on), LN, ELU; the GRU with its LN; the
//      deter; deter @ w_obs_d + e_proj[t], LN, ELU; @ w_post + b_post; the
//      sample. It runs in observe_bwd's layout (observe_cluster.cuh): a
//      thread block cluster of CL = 4 blocks per pair of rows, each
//      product's columns split among the ranks, the rest computed alike on
//      every rank, each output stored by one rank in turns. The products'
//      float32 sums are rounded to T by ln_rounded() below, after the
//      product's closing cluster barrier (a rank ahead writes into the
//      others' Y until then). The sample gives a warp to each group of C
//      classes. The cluster size is given at the launch
//      (cudaLaunchKernelEx), so that observe_clusters can ask how many
//      clusters of 4 and of 8 fit.
// The chain streams the input, GRU, w_obs_d and w_post weights a step, 4.7
// MB at xarm in place of 5.2, split four ways.
//
// Every width the JAX kernel takes. The products read V weights at a time, a
// template argument the wrapper picks from the widths (observe_common.cuh:
// 16-byte loads at the shipped widths, single values where a row is no multiple
// of 16 bytes). Where the chain's vectors outgrow shared memory (deter past
// about 3 500 at U = 512, S * C = 1 024) the wrapper hands over a workspace and
// the chain's wide instantiation keeps them there (observe_cluster.cuh).

#include "observe_cluster.cuh"

namespace {

using namespace obc;

struct Params {
  const void *stoch0, *deter0, *actions, *embeds;
  const float *first, *noise;
  void* deter_out;
  float* logit_out;
  void* stoch_out;
  const void *w_in_s, *w_in_a, *ln_in_s, *ln_in_b;
  const void *w_gru_d, *w_gru_x, *ln_gru_s, *ln_gru_b;
  const void *w_obs_d, *w_obs_e, *ln_obs_s, *ln_obs_b, *w_post, *b_post;
  float* eproj;  // Scratch: [T][B][U], float32.
  float* ws;     // The chain's workspace, or null (shared memory).
  int T, B, A, E, D, U, S, C;
  float unimix;
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

// ---- The prologue: embed_kernel ----------------------------------------

constexpr int RW = 8;            // Rows a block.
constexpr int NTW = 256;         // Threads a block.
constexpr int CGW = 64;          // Column groups of a pass.
constexpr int KSW = NTW / CGW;   // Slices of K.
constexpr int KC = 512;          // Rows of K of embeds staged at a time.

static_assert(KC % KSW == 0, "wide layout");

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
// adds its KSW partials in order into Y[r * ldy + n] for the first `rows`
// rows. Ends with a barrier.
template <int V>
__device__ __forceinline__ void rows_reduce(
    const float (&acc)[V][RW], float* scratch, int base, int N,
    float* Y, int ldy, int rows) {
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
      Y[(size_t)r * ldy + n] = v;
    }
  }
  __syncthreads();
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
    rows_reduce<V>(acc, scratch, base, U, p.eproj + (size_t)row0 * U, U,
                   M - row0);
  }
}

// ---- The chain ----------------------------------------------------------

// Every rank holds every vector; one of them stores it, in turns.
__device__ __forceinline__ bool my_turn(int& turn, int rank) {
  return turn++ % CL == rank;
}

// In place over Z [N][R], a product's float32 sums: round them to T, take
// the LayerNorm (float32, eps 1e-3) and round it to T, then, when
// `use_elu`, the ELU, rounded again: _layernorm and _elu of the JAX cell
// on a product cast to T. Every rank computes it alike. Ends with a
// barrier.
template <typename T>
__device__ void ln_rounded(float* Z, int N, const T* scale, const T* bias,
                           bool use_elu, float* red) {
  const int tid = threadIdx.x, total = N * R;
  float s[1] = {0.f};
  for (int i = tid; i < total; i += NT) {
    const float z = rnd<T>(Z[i]);
    Z[i] = z;
    s[0] += z;
  }
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
    float y = rnd<T>((Z[i] - mean) * iv * to_f(scale[i / R]) +
                     to_f(bias[i / R]));
    if (use_elu) y = rnd<T>(elu(y));
    Z[i] = y;
  }
  __syncthreads();
}

// The floats of a block's vectors: in shared memory, or with WS a block's
// copy in the workspace.
__host__ __device__ size_t vector_floats(const Params& p) {
  return (size_t)R * (2 * p.S * p.C + 5 * p.D + p.A + 2 * p.U);
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
  float* s_g = s_dm + D * R;             // GRU gates [3D][R].
  float* s_a = s_g + 3 * D * R;
  float* s_h = s_a + A * R;              // Input layer.
  float* s_z = s_h + U * R;              // e_proj[t], then the head's layer.
  float* s_post = s_z + U * R;           // Posterior logits, float32.
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
    load_rows(s_z, p.eproj + tb * U, U, row0, B, nullptr);
    for (int i = tid; i < D * R; i += NT) s_dm[i] = s_deter[i] * s_keep[i % R];
    __syncthreads();

    // Image cell input: [stoch, action] @ W_in, LN, ELU. From step 1 the
    // stoch is the chain's own one-hot sample, kept as its classes.
    const In<T> stoch = t == 0
        ? In<T>{s_stoch, nullptr, nullptr, SC, W(p.w_in_s)}
        : In<T>{nullptr, s_idx, s_keep, SC, W(p.w_in_s)};
    cdense<T, V, WS>(s_h, U, stoch, {s_a, nullptr, nullptr, A, W(p.w_in_a)}, C,
                     nullptr, nullptr, s_scratch, rank, stride);
    ln_rounded<T>(s_h, U, W(p.ln_in_s), W(p.ln_in_b), true, s_red);
    // GRU gates: [deter, x] @ W_gru, LN; update bias -1.
    cdense<T, V, WS>(s_g, 3 * D, {s_dm, nullptr, nullptr, D, W(p.w_gru_d)},
                     {s_h, nullptr, nullptr, U, W(p.w_gru_x)}, C, nullptr,
                     nullptr, s_scratch, rank, stride);
    ln_rounded<T>(s_g, 3 * D, W(p.ln_gru_s), W(p.ln_gru_b), false, s_red);
    for (int i = tid; i < D * R; i += NT) {
      const int d = i / R, r = i % R;
      const float reset = sigmoid(s_g[d * R + r]);
      const float cand = tanhf(reset * s_g[(D + d) * R + r]);
      const float update = sigmoid(s_g[(2 * D + d) * R + r] - 1.f);
      s_deter[i] = rnd<T>(update * cand + (1.f - update) * s_dm[i]);
    }
    __syncthreads();
    if (my_turn(turn, rank))
      store_rows(static_cast<T*>(p.deter_out) + tb * D, s_deter, D, row0, B);
    // Posterior head: the rounded deter @ w_obs_d + e_proj, LN, ELU,
    // logits.
    cdense<T, V, WS>(s_z, U, {s_deter, nullptr, nullptr, D, W(p.w_obs_d)}, none,
                     C, nullptr, s_z, s_scratch, rank, stride);
    ln_rounded<T>(s_z, U, W(p.ln_obs_s), W(p.ln_obs_b), true, s_red);
    cdense<T, V, WS>(s_post, SC, {s_z, nullptr, nullptr, U, W(p.w_post)}, none,
                     C, W(p.b_post), nullptr, s_scratch, rank, stride);
    if (my_turn(turn, rank))
      store_rows(p.logit_out + tb * SC, s_post, SC, row0, B);
    // Sample, a warp a group: the first maximum of log((1-u) softmax(z) +
    // u/C) + g in each group, or of the logits themselves without noise. A
    // lane takes the classes lane, lane + 32, ...; the lanes then keep the
    // larger score, or at equal scores the smaller class.
    const bool emit = my_turn(turn, rank);
    for (int q = warp; q < R * S; q += NW) {
      const int r = q / S, s = q % S, row = row0 + r;
      const float* z = s_post + (size_t)s * C * R + r;
      const float* g = nullptr;
      float m = 0.f, sum = 1.f;
      if (p.noise) {
        g = p.noise + (tb + min(row, B - 1)) * SC + (size_t)s * C;
        m = -INFINITY;
        for (int c = lane; c < C; c += 32) m = fmaxf(m, z[c * R]);
        m = warp_max(m);
        sum = 0.f;
        for (int c = lane; c < C; c += 32) sum += expf(z[c * R] - m);
        sum = warp_sum(sum);
      }
      int best = lane;
      float top = -INFINITY;
      for (int c = lane; c < C; c += 32) {
        float score = z[c * R];
        if (g) {
          const float prob = expf(score - m) / sum;
          score = logf((1.f - p.unimix) * prob + p.unimix / C) + g[c];
        }
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

template <typename T, int V>
int launch(const Params& p, cudaStream_t stream) {
  const int tiles = (p.T * p.B + RW - 1) / RW;
  if (tiles == 0) return (int)cudaSuccess;
  const size_t bytes = embed_bytes<V>();
  cudaError_t err = cudaFuncSetAttribute(
      embed_kernel<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  embed_kernel<T, V><<<tiles, NTW, bytes, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return p.ws ? launch_chain<T, V, true>(p, stream)
              : launch_chain<T, V, false>(p, stream);
}

// launch<T, V> for the V that `values` names.
template <typename T>
int dispatch(const Params& p, int values, cudaStream_t stream) {
  return with_values<T>(values, [&](auto v) {
    return launch<T, decltype(v)::value>(p, stream);
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
  return p;
}

}  // namespace

// ptrs: stoch0, deter0, actions, embeds, first, noise (or null), deter_out,
//   logit_out, stoch_out, w_in_s, w_in_a, ln_in_s, ln_in_b, w_gru_d, w_gru_x,
//   ln_gru_s, ln_gru_b, w_obs_d, w_obs_e, ln_obs_s, ln_obs_b, w_post, b_post,
//   then the scratch eproj [T][B][U] (float32) and the chain's workspace
//   (float32, a block's vectors a block of the chain's grid) or null (last,
//   so that the parent kernel, which reads as far as b_post, takes the same
//   list).
// dims: T, B, A, E, D, U, S, C, values (the V of every load, see
//   observe_common.cuh).
// Returns cudaGetLastError() after the last launch (0 on success).
extern "C" int observe(int bf16, void* const* ptrs, const int* dims,
                       float unimix, void* stream) {
  Params p = read_dims(dims);
  int i = 0;
  p.stoch0 = ptrs[i++];
  p.deter0 = ptrs[i++];
  p.actions = ptrs[i++];
  p.embeds = ptrs[i++];
  p.first = static_cast<const float*>(ptrs[i++]);
  p.noise = static_cast<const float*>(ptrs[i++]);
  p.deter_out = ptrs[i++];
  p.logit_out = static_cast<float*>(ptrs[i++]);
  p.stoch_out = ptrs[i++];
  p.w_in_s = ptrs[i++];
  p.w_in_a = ptrs[i++];
  p.ln_in_s = ptrs[i++];
  p.ln_in_b = ptrs[i++];
  p.w_gru_d = ptrs[i++];
  p.w_gru_x = ptrs[i++];
  p.ln_gru_s = ptrs[i++];
  p.ln_gru_b = ptrs[i++];
  p.w_obs_d = ptrs[i++];
  p.w_obs_e = ptrs[i++];
  p.ln_obs_s = ptrs[i++];
  p.ln_obs_b = ptrs[i++];
  p.w_post = ptrs[i++];
  p.b_post = ptrs[i++];
  p.eproj = static_cast<float*>(ptrs[i++]);
  p.ws = static_cast<float*>(ptrs[i++]);
  p.unimix = unimix;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? dispatch<__nv_bfloat16>(p, dims[8], s)
              : dispatch<float>(p, dims[8], s);
}

// fit[0], fit[1]: how many clusters of CL and of 8 blocks of the chain fit
// the card at once at these dims (cudaOccupancyMaxActiveClusters); the
// chain needs one per pair of rows. dims as observe's.
extern "C" int observe_clusters(int bf16, const int* dims, int* fit) {
  const Params p = read_dims(dims);
  return bf16 ? clusters<__nv_bfloat16>(p, fit) : clusters<float>(p, fit);
}

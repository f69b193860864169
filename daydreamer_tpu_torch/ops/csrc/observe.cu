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
// a hair. The prior head's weights are neither read nor counted. As for
// observe_fwd.cu the roofline does not describe the kernel: 32 rows walk
// 32 dependent steps of six dependent layers, so it is bound by latency,
// the time one SM takes to pull a step's weights out of L2, 32 times in a
// row.
//
// Design. observe_fwd.cu's: a block owns R = 2 rows for all T steps (16
// blocks at B = 32), carries and intermediates in shared memory, weights
// from L2 through the load-shaped product of observe_common.cuh (float32
// accumulation, the slices' partial sums added in a fixed order), no
// grid-wide barrier. The rounding to T happens where the LayerNorm reads
// the product and where it writes.

#include "observe_common.cuh"

namespace {

using namespace obs;

struct Params {
  const void *stoch0, *deter0, *actions, *embeds;
  const float *first, *noise;
  void* deter_out;
  float* logit_out;
  void* stoch_out;
  const void *w_in_s, *w_in_a, *ln_in_s, *ln_in_b;
  const void *w_gru_d, *w_gru_x, *ln_gru_s, *ln_gru_b;
  const void *w_obs_d, *w_obs_e, *ln_obs_s, *ln_obs_b, *w_post, *b_post;
  int T, B, A, E, D, U, S, C;
  float unimix;
};

__host__ __device__ inline int gate_width(int D, int SC) {
  return 3 * D > SC ? 3 * D : SC;
}

// In place over Z [N][R], a product's float32 sums: round them to T, take
// the LayerNorm (float32, eps 1e-3) and round it to T, then, when
// `use_elu`, the ELU, rounded again. Ends with a barrier.
template <typename T>
__device__ void ln_rounded(float* Z, int N, const T* scale, const T* bias,
                           bool use_elu, float* red) {
  const int tid = threadIdx.x, total = N * R;
  float s = 0.f;
  for (int i = tid; i < total; i += NT) s += rnd<T>(Z[i]);
  const float mean = row_sum(s, red) / N;
  float v = 0.f;
  for (int i = tid; i < total; i += NT) {
    const float d = rnd<T>(Z[i]) - mean;
    v += d * d;
  }
  const float iv = rsqrtf(row_sum(v, red) / N + 1e-3f);
  for (int i = tid; i < total; i += NT) {
    float y = rnd<T>((rnd<T>(Z[i]) - mean) * iv * to_f(scale[i / R]) +
                     to_f(bias[i / R]));
    if (use_elu) y = rnd<T>(elu(y));
    Z[i] = y;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(NT) observe_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.D, U = p.U, A = p.A, E = p.E, S = p.S, C = p.C;
  const int SC = S * C, B = p.B;
  float* s_stoch = smem;                 // stoch0, masked (step 0 only).
  float* s_deter = s_stoch + SC * R;     // The deter carry, rounded to T.
  float* s_dm = s_deter + D * R;         // The masked deter of this step.
  float* s_a = s_dm + D * R;
  float* s_e = s_a + A * R;
  float* s_h0 = s_e + E * R;
  float* s_h1 = s_h0 + U * R;
  float* s_g = s_h1 + U * R;             // GRU gates, then the logits.
  float* s_keep = s_g + gate_width(D, SC) * R;
  float* s_red = s_keep + R;
  float* s_scratch = s_red + NW * R;
  int* s_idx = reinterpret_cast<int*>(s_scratch + SCRATCH);
  const int tid = threadIdx.x, row0 = blockIdx.x * R;
  const In<T> none = {nullptr, nullptr, nullptr, 0, nullptr};
  auto W = [](const void* w) { return static_cast<const T*>(w); };

  load_rows(s_stoch, W(p.stoch0), SC, row0, B, nullptr);
  load_rows(s_deter, W(p.deter0), D, row0, B, nullptr);
  __syncthreads();

  for (int t = 0; t < p.T; ++t) {
    if (tid < R) {
      const int row = row0 + tid;
      s_keep[tid] = row < B ? 1.f - p.first[(size_t)t * B + row] : 0.f;
    }
    __syncthreads();
    load_rows(s_a, W(p.actions) + (size_t)t * B * A, A, row0, B, s_keep);
    load_rows(s_e, W(p.embeds) + (size_t)t * B * E, E, row0, B, nullptr);
    for (int i = tid; i < D * R; i += NT) s_dm[i] = s_deter[i] * s_keep[i % R];
    if (t == 0)
      for (int i = tid; i < SC * R; i += NT) s_stoch[i] *= s_keep[i % R];
    __syncthreads();

    // Image cell input: [stoch, action] @ W_in, LN, ELU. From step 1 the
    // stoch is the kernel's own one-hot sample, kept as its classes.
    const In<T> stoch = t == 0
        ? In<T>{s_stoch, nullptr, nullptr, SC, W(p.w_in_s)}
        : In<T>{nullptr, s_idx, s_keep, SC, W(p.w_in_s)};
    dense<T>(s_h0, U, stoch, {s_a, nullptr, nullptr, A, W(p.w_in_a)}, C,
             nullptr, nullptr, s_scratch);
    ln_rounded<T>(s_h0, U, W(p.ln_in_s), W(p.ln_in_b), true, s_red);
    // GRU gates: [deter, x] @ W_gru, LN; update bias -1.
    dense<T>(s_g, 3 * D, {s_dm, nullptr, nullptr, D, W(p.w_gru_d)},
             {s_h0, nullptr, nullptr, U, W(p.w_gru_x)}, C, nullptr, nullptr,
             s_scratch);
    ln_rounded<T>(s_g, 3 * D, W(p.ln_gru_s), W(p.ln_gru_b), false, s_red);
    for (int i = tid; i < D * R; i += NT) {
      const int d = i / R, r = i % R;
      const float reset = sigmoid(s_g[d * R + r]);
      const float cand = tanhf(reset * s_g[(D + d) * R + r]);
      const float update = sigmoid(s_g[(2 * D + d) * R + r] - 1.f);
      s_deter[i] = rnd<T>(update * cand + (1.f - update) * s_dm[i]);
    }
    __syncthreads();
    store_rows(static_cast<T*>(p.deter_out) + (size_t)t * B * D, s_deter, D,
               row0, B);
    // Posterior head: [deter, embed] @ W_obs, LN, ELU, logits.
    dense<T>(s_h1, U, {s_deter, nullptr, nullptr, D, W(p.w_obs_d)},
             {s_e, nullptr, nullptr, E, W(p.w_obs_e)}, C, nullptr, nullptr,
             s_scratch);
    ln_rounded<T>(s_h1, U, W(p.ln_obs_s), W(p.ln_obs_b), true, s_red);
    dense<T>(s_g, SC, {s_h1, nullptr, nullptr, U, W(p.w_post)}, none, C,
             W(p.b_post), nullptr, s_scratch);
    store_rows(p.logit_out + (size_t)t * B * SC, s_g, SC, row0, B);
    // Sample: the first maximum of log((1-u) softmax(z) + u/C) + g in each
    // group, or of the logits themselves without noise.
    for (int i = tid; i < R * S; i += NT) {
      const int r = i / S, s = i % S, row = row0 + r;
      const float* z = s_g + (size_t)s * C * R + r;
      int best = 0;
      float top = -INFINITY;
      if (p.noise) {
        float m = -INFINITY;
        for (int c = 0; c < C; ++c) m = fmaxf(m, z[c * R]);
        float sum = 0.f;
        for (int c = 0; c < C; ++c) sum += expf(z[c * R] - m);
        const float* g =
            p.noise + ((size_t)t * B + min(row, B - 1)) * SC + (size_t)s * C;
        for (int c = 0; c < C; ++c) {
          float prob = expf(z[c * R] - m) / sum;
          prob = (1.f - p.unimix) * prob + p.unimix / C;
          const float score = logf(prob) + g[c];
          if (score > top) { top = score; best = c; }
        }
      } else {
        for (int c = 0; c < C; ++c)
          if (z[c * R] > top) { top = z[c * R]; best = c; }
      }
      s_idx[s * R + r] = best;  // The stoch carry.
      if (row < B) {
        T* out = static_cast<T*>(p.stoch_out) +
                 ((size_t)t * B + row) * SC + (size_t)s * C;
        for (int c = 0; c < C; ++c) out[c] = from_f<T>(c == best ? 1.f : 0.f);
      }
    }
    __syncthreads();
  }
}

size_t smem_bytes(const Params& p) {
  const int SC = p.S * p.C;
  const size_t floats = (size_t)R * (SC + 2 * p.D + p.A + p.E + 2 * p.U +
                                     gate_width(p.D, SC) + 1 + NW +
                                     SCRATCH / R + p.S);
  return floats * sizeof(float);
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  const size_t bytes = smem_bytes(p);
  cudaError_t err = cudaFuncSetAttribute(
      observe_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (p.B + R - 1) / R;
  observe_kernel<T><<<blocks, NT, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: stoch0, deter0, actions, embeds, first, noise (or null), deter_out,
//   logit_out, stoch_out, w_in_s, w_in_a, ln_in_s, ln_in_b, w_gru_d, w_gru_x,
//   ln_gru_s, ln_gru_b, w_obs_d, w_obs_e, ln_obs_s, ln_obs_b, w_post, b_post.
// dims: T, B, A, E, D, U, S, C.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int observe(int bf16, void* const* ptrs, const int* dims,
                       float unimix, void* stream) {
  Params p = {};
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
  p.T = dims[0];
  p.B = dims[1];
  p.A = dims[2];
  p.E = dims[3];
  p.D = dims[4];
  p.U = dims[5];
  p.S = dims[6];
  p.C = dims[7];
  p.unimix = unimix;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(p, s) : launch<float>(p, s);
}

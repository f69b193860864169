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
// and 32 dependent steps of about ten dependent layers each, so it is bound
// by latency: the time one SM takes to pull a step's 7 M weights out of L2
// and to issue their 14 M FMAs, 32 times in a row.
//
// Design. A block owns R = 2 rows for all T steps and loops over time
// inside (16 blocks at B = 32); nothing crosses blocks, so there is no
// grid-wide barrier. More rows per block would add FMAs to every block
// without shortening its stream of weights, and fewer would repeat the
// same stream on more SMs. The rows' carries and every intermediate stay
// in shared memory (see observe_common.cuh for the layout and the
// product); the weights stream from L2, which holds all of them. From step
// 1 on the stoch is the kernel's own sample, kept as its classes, and its
// product is a gather. Splitting each layer's columns over a cluster of
// SMs per block of rows (or over all SMs with a grid barrier between
// layers, weights resident in shared memory) is the faster design and
// later work, as are mma.sync / wgmma.

#include "observe_common.cuh"

namespace {

using namespace obs;

struct Params {
  const void *stoch0, *deter0, *actions, *embeds;
  const float *first, *noise;
  void* deter_out;
  float *post_out, *prior_out;
  void* stoch_out;
  const void *w_in_s, *w_in_a, *ln_in_s, *ln_in_b;
  const void *w_gru_d, *w_gru_x, *ln_gru_s, *ln_gru_b;
  const void *w_out[MAXL], *ln_out_s[MAXL], *ln_out_b[MAXL];
  const void *w_st, *b_st, *w_obs_d, *w_obs_e, *ln_obs_s, *ln_obs_b;
  const void *w_post, *b_post;
  int T, B, A, E, D, U, S, C, n_out;
  float unimix;
};

__host__ __device__ inline int gate_width(int D, int SC) {
  return 3 * D > SC ? 3 * D : SC;
}

template <typename T>
__global__ void __launch_bounds__(NT) observe_fwd_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.D, U = p.U, A = p.A, E = p.E, S = p.S, C = p.C;
  const int SC = S * C, B = p.B;
  float* s_stoch = smem;                 // stoch0, masked (step 0 only).
  float* s_deter = s_stoch + SC * R;     // The deter carry, rounded to T.
  float* s_dm = s_deter + D * R;         // The masked deter of this step.
  float* s_dt = s_dm + D * R;            // This step's deter, float32.
  float* s_a = s_dt + D * R;
  float* s_e = s_a + A * R;
  float* s_h0 = s_e + E * R;
  float* s_h1 = s_h0 + U * R;
  float* s_g = s_h1 + U * R;             // GRU gates, then prior logits.
  float* s_post = s_g + gate_width(D, SC) * R;
  float* s_keep = s_post + SC * R;
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

    // Image cell input: [stoch, action] @ W_in, LN, ELU.
    const In<T> stoch = t == 0
        ? In<T>{s_stoch, nullptr, nullptr, SC, W(p.w_in_s)}
        : In<T>{nullptr, s_idx, s_keep, SC, W(p.w_in_s)};
    dense<T>(s_h0, U, stoch, {s_a, nullptr, nullptr, A, W(p.w_in_a)}, C,
             nullptr, nullptr, s_scratch);
    ln_fwd<T>(s_h0, U, W(p.ln_in_s), W(p.ln_in_b), nullptr, nullptr, true,
              s_h0, s_red);
    // GRU gates: [deter, x] @ W_gru, LN; update bias -1.
    dense<T>(s_g, 3 * D, {s_dm, nullptr, nullptr, D, W(p.w_gru_d)},
             {s_h0, nullptr, nullptr, U, W(p.w_gru_x)}, C, nullptr, nullptr,
             s_scratch);
    ln_fwd<T>(s_g, 3 * D, W(p.ln_gru_s), W(p.ln_gru_b), nullptr, nullptr,
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
    store_rows(static_cast<T*>(p.deter_out) + (size_t)t * B * D, s_dt, D,
               row0, B);
    // Prior MLP and the raw prior logits.
    const float* h = s_dt;
    int width = D;
    for (int l = 0; l < p.n_out; ++l) {
      float* out = (l % 2 == 0) ? s_h0 : s_h1;
      dense<T>(out, U, {h, nullptr, nullptr, width, W(p.w_out[l])}, none, C,
               nullptr, nullptr, s_scratch);
      ln_fwd<T>(out, U, W(p.ln_out_s[l]), W(p.ln_out_b[l]), nullptr, nullptr,
                true, out, s_red);
      h = out;
      width = U;
    }
    dense<T>(s_g, SC, {h, nullptr, nullptr, width, W(p.w_st)}, none, C,
             W(p.b_st), nullptr, s_scratch);
    store_rows(p.prior_out + (size_t)t * B * SC, s_g, SC, row0, B);
    // Posterior head: [deter, embed] @ W_obs, LN, ELU, logits.
    float* x2 = (h == s_h0) ? s_h1 : s_h0;
    dense<T>(x2, U, {s_dt, nullptr, nullptr, D, W(p.w_obs_d)},
             {s_e, nullptr, nullptr, E, W(p.w_obs_e)}, C, nullptr, nullptr,
             s_scratch);
    ln_fwd<T>(x2, U, W(p.ln_obs_s), W(p.ln_obs_b), nullptr, nullptr, true,
              x2, s_red);
    dense<T>(s_post, SC, {x2, nullptr, nullptr, U, W(p.w_post)}, none, C,
             W(p.b_post), nullptr, s_scratch);
    store_rows(p.post_out + (size_t)t * B * SC, s_post, SC, row0, B);
    // Sample: the first maximum of log((1-u) softmax(z) + u/C) + g in each
    // group, or of the mixed probabilities themselves without noise.
    for (int i = tid; i < R * S; i += NT) {
      const int r = i / S, s = i % S, row = row0 + r;
      const float* z = s_post + (size_t)s * C * R + r;
      float m = -INFINITY;
      for (int c = 0; c < C; ++c) m = fmaxf(m, z[c * R]);
      float sum = 0.f;
      for (int c = 0; c < C; ++c) sum += expf(z[c * R] - m);
      const float* g = p.noise
          ? p.noise + ((size_t)t * B + min(row, B - 1)) * SC + (size_t)s * C
          : nullptr;
      int best = 0;
      float top = -INFINITY;
      for (int c = 0; c < C; ++c) {
        float score = expf(z[c * R] - m) / sum;
        if (p.unimix != 0.f)
          score = (1.f - p.unimix) * score + p.unimix / C;
        if (g) score = logf(score) + g[c];
        if (score > top) { top = score; best = c; }
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
  const size_t floats = (size_t)R * (SC + 3 * p.D + p.A + p.E + 2 * p.U +
                                     gate_width(p.D, SC) + SC + 1 + NW +
                                     SCRATCH / R + p.S);
  return floats * sizeof(float);
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  const size_t bytes = smem_bytes(p);
  cudaError_t err = cudaFuncSetAttribute(
      observe_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (p.B + R - 1) / R;
  observe_fwd_kernel<T><<<blocks, NT, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: stoch0, deter0, actions, embeds, first, noise (or null), deter_out,
//   post_out, prior_out, stoch_out, w_in_s, w_in_a, ln_in_s, ln_in_b,
//   w_gru_d, w_gru_x, ln_gru_s, ln_gru_b, w_out[n_out], ln_out_s[n_out],
//   ln_out_b[n_out], w_st, b_st, w_obs_d, w_obs_e, ln_obs_s, ln_obs_b,
//   w_post, b_post.
// dims: T, B, A, E, D, U, S, C, n_out.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int observe_fwd(int bf16, void* const* ptrs, const int* dims,
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
  p.post_out = static_cast<float*>(ptrs[i++]);
  p.prior_out = static_cast<float*>(ptrs[i++]);
  p.stoch_out = ptrs[i++];
  p.T = dims[0];
  p.B = dims[1];
  p.A = dims[2];
  p.E = dims[3];
  p.D = dims[4];
  p.U = dims[5];
  p.S = dims[6];
  p.C = dims[7];
  p.n_out = dims[8];
  if (p.n_out < 1 || p.n_out > MAXL) return (int)cudaErrorInvalidValue;
  p.w_in_s = ptrs[i++];
  p.w_in_a = ptrs[i++];
  p.ln_in_s = ptrs[i++];
  p.ln_in_b = ptrs[i++];
  p.w_gru_d = ptrs[i++];
  p.w_gru_x = ptrs[i++];
  p.ln_gru_s = ptrs[i++];
  p.ln_gru_b = ptrs[i++];
  for (int l = 0; l < p.n_out; ++l) p.w_out[l] = ptrs[i++];
  for (int l = 0; l < p.n_out; ++l) p.ln_out_s[l] = ptrs[i++];
  for (int l = 0; l < p.n_out; ++l) p.ln_out_b[l] = ptrs[i++];
  p.w_st = ptrs[i++];
  p.b_st = ptrs[i++];
  p.w_obs_d = ptrs[i++];
  p.w_obs_e = ptrs[i++];
  p.ln_obs_s = ptrs[i++];
  p.ln_obs_b = ptrs[i++];
  p.w_post = ptrs[i++];
  p.b_post = ptrs[i++];
  p.unimix = unimix;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(p, s) : launch<float>(p, s);
}

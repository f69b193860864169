// Policy-in-the-loop imagination rollout for Hopper (sm_90a).
//
// Replaces daydreamer_tpu/ops/pallas_rssm.py::_imagine_actor_kernel (entry
// imagine_actor_pallas). For each of B rows and H steps: the RSSM image
// cell (split matmul over stoch and action, LN, ELU; GRU with LN and update
// bias -1; the prior MLP; the prior logits), a Gumbel-max one-hot sample
// of the prior per group of C classes, the actor MLP over [deter, stoch],
// the action unimix and a Gumbel-max action. It computes what the TPU
// kernel's interpret path computes: the Gumbel noise arrives as inputs,
// and the logits it returns are raw (the caller applies the unimix).
//
// Bound: at the xarm shape (B=1024, H=15, D=U=512, S*C=1024, A=6, three
// prior layers, a four-layer actor) each row-step is ~3.94 M dense
// multiply-adds plus the products with the one-hot stoch, which are sums
// of S = 32 weight rows (S*U adds) except the first step's stoch0 @ W_in,
// which is dense: ~122.5 GFLOP in all, ~0.124 ms at 989 TFLOP/s bf16,
// against ~56 us for the bytes (10 MB of weights, 110 MB of outputs, 63 MB
// of noise). So the operations bound it.
//
// Design. Rows are independent for the whole horizon, so a block owns
// R = 8 rows for all H steps and loops over time inside; nothing crosses
// blocks and no grid-wide sync is needed. The block keeps its rows'
// carries (deter, action, and the stoch as its sampled classes [S][R])
// and every intermediate in shared memory; the weights stream from L2
// (about 10 MB in bf16, which the 50 MB L2 holds across blocks and steps).
// The layout, the product and the rounding are in imagine_common.cuh,
// shared with imagine.cu. mma.sync / wgmma and an in-kernel Philox
// generator are later work.

#include "imagine_common.cuh"

namespace {

using namespace img;

struct Params {
  const void *stoch0, *deter0, *action0;
  const float *g_s, *g_a;  // Gumbel noise [H,B,SC], [H,B,A]; null: argmax.
  const void *w_in_s, *w_in_a, *ln_in_s, *ln_in_b;
  const void *w_gru_d, *w_gru_x, *ln_gru_s, *ln_gru_b;
  const void *w_st, *b_st;
  const void *a_w_d, *a_w_s, *a_w_out, *a_b_out;
  void *deter_out, *stoch_out, *action_out;
  float *logit_out;
  const void *w_out[MAXL], *ln_out_s[MAXL], *ln_out_b[MAXL];
  const void *a_ln_s[MAXL], *a_ln_b[MAXL], *a_w_h[MAXL];
  int B, H, D, U, S, C, A, n_out, n_act;
  float unimix, act_unimix;
};

template <typename T>
__global__ void __launch_bounds__(NT) imagine_actor_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.D, U = p.U, A = p.A, S = p.S, C = p.C, SC = S * C;
  const int B = p.B;
  const int G = max(3 * D, SC);
  const int Ap = (A + 3) / 4 * 4;
  float* s_stoch = smem;
  float* s_deter = s_stoch + SC * R;
  float* s_act = s_deter + D * R;
  float* s_g = s_act + Ap * R;
  float* s_ha = s_g + G * R;
  float* s_hb = s_ha + U * R;
  float* s_alog = s_hb + U * R;
  int* s_idx = reinterpret_cast<int*>(s_alog + Ap * R);  // [S][R] classes.
  const In none = {nullptr, nullptr, 0, nullptr};
  const int row0 = blockIdx.x * R;
  const int tid = threadIdx.x;

  // Carries in: [B, width] in global -> [width][R] float in shared.
  for (int i = tid; i < R * SC; i += NT) {
    const int r = i / SC, j = i % SC, row = row0 + r;
    s_stoch[j * R + r] =
        row < B ? to_f(static_cast<const T*>(p.stoch0)[(size_t)row * SC + j])
                : 0.f;
  }
  for (int i = tid; i < R * D; i += NT) {
    const int r = i / D, j = i % D, row = row0 + r;
    s_deter[j * R + r] =
        row < B ? to_f(static_cast<const T*>(p.deter0)[(size_t)row * D + j])
                : 0.f;
  }
  for (int i = tid; i < R * Ap; i += NT) {
    const int r = i / Ap, j = i % Ap, row = row0 + r;
    s_act[j * R + r] =
        (row < B && j < A)
            ? to_f(static_cast<const T*>(p.action0)[(size_t)row * A + j])
            : 0.f;
  }
  __syncthreads();

  for (int t = 0; t < p.H; ++t) {
    // Image cell input: [stoch, action] @ W_in, LN, ELU. From step 1 the
    // stoch is the kernel's own one-hot sample; stoch0 may be any value.
    dense<T>({s_stoch, t > 0 ? s_idx : nullptr, SC, p.w_in_s},
             {s_act, nullptr, A, p.w_in_a}, C, U, nullptr, true, s_ha);
    ln_act<T>(s_ha, U, p.ln_in_s, p.ln_in_b, true);
    // GRU gates: [deter, x] @ W_gru, LN; update bias -1.
    dense<T>({s_deter, nullptr, D, p.w_gru_d}, {s_ha, nullptr, U, p.w_gru_x},
             C, 3 * D, nullptr, true, s_g);
    ln_act<T>(s_g, 3 * D, p.ln_gru_s, p.ln_gru_b, false);
    for (int i = tid; i < D * R; i += NT) {
      const int d = i / R, r = i % R;
      const float reset = sigmoid(s_g[d * R + r]);
      const float cand = tanhf(reset * s_g[(D + d) * R + r]);
      const float update = sigmoid(s_g[(2 * D + d) * R + r] - 1.f);
      s_deter[i] = rnd<T>(update * cand + (1.f - update) * s_deter[i]);
    }
    __syncthreads();
    for (int i = tid; i < R * D; i += NT) {
      const int r = i / D, j = i % D, row = row0 + r;
      if (row < B)
        static_cast<T*>(p.deter_out)[((size_t)t * B + row) * D + j] =
            from_f<T>(s_deter[j * R + r]);
    }
    // Prior MLP and the raw prior logits.
    const float* h = s_deter;
    int width = D;
    for (int l = 0; l < p.n_out; ++l) {
      float* out = (l % 2 == 0) ? s_ha : s_hb;
      dense<T>({h, nullptr, width, p.w_out[l]}, none, C, U, nullptr, true,
               out);
      ln_act<T>(out, U, p.ln_out_s[l], p.ln_out_b[l], true);
      h = out;
      width = U;
    }
    dense<T>({h, nullptr, width, p.w_st}, none, C, SC, p.b_st, false, s_g);
    for (int i = tid; i < R * SC; i += NT) {
      const int r = i / SC, j = i % SC, row = row0 + r;
      if (row < B)
        p.logit_out[((size_t)t * B + row) * SC + j] = s_g[j * R + r];
    }
    // Prior sample: argmax(log((1-u) softmax(z) + u/C) + g) per group.
    for (int i = tid; i < R * S; i += NT) {
      const int r = i / S, s = i % S, row = row0 + r;
      const float* z = s_g + (size_t)s * C * R + r;
      int best = 0;
      if (p.g_s) {
        float m = -INFINITY;
        for (int c = 0; c < C; ++c) m = fmaxf(m, z[c * R]);
        float sum = 0.f;
        for (int c = 0; c < C; ++c) sum += expf(z[c * R] - m);
        const float* g =
            p.g_s + ((size_t)t * B + min(row, B - 1)) * SC + (size_t)s * C;
        float top = -INFINITY;
        for (int c = 0; c < C; ++c) {
          float prob = expf(z[c * R] - m) / sum;
          prob = (1.f - p.unimix) * prob + p.unimix / C;
          const float score = logf(prob) + g[c];
          if (score > top) { top = score; best = c; }
        }
      } else {
        float top = -INFINITY;
        for (int c = 0; c < C; ++c)
          if (z[c * R] > top) { top = z[c * R]; best = c; }
      }
      s_idx[s * R + r] = best;  // The stoch carry from here on.
      for (int c = 0; c < C; ++c) {
        const float v = (c == best) ? 1.f : 0.f;
        if (row < B)
          static_cast<T*>(p.stoch_out)[((size_t)t * B + row) * SC + s * C +
                                       c] = from_f<T>(v);
      }
    }
    __syncthreads();
    // Actor MLP over [deter, stoch], then the action logits.
    dense<T>({s_deter, nullptr, D, p.a_w_d}, {nullptr, s_idx, SC, p.a_w_s}, C,
             U, nullptr, true, s_ha);
    ln_act<T>(s_ha, U, p.a_ln_s[0], p.a_ln_b[0], true);
    h = s_ha;
    for (int l = 1; l < p.n_act; ++l) {
      float* out = (l % 2 == 1) ? s_hb : s_ha;
      dense<T>({h, nullptr, U, p.a_w_h[l - 1]}, none, C, U, nullptr, true,
               out);
      ln_act<T>(out, U, p.a_ln_s[l], p.a_ln_b[l], true);
      h = out;
    }
    dense<T>({h, nullptr, U, p.a_w_out}, none, C, A, p.a_b_out, false,
             s_alog);
    // Action: act-unimix on the logits, then a Gumbel-max one-hot.
    if (tid < R) {
      const int r = tid, row = row0 + r;
      float m = -INFINITY;
      for (int a = 0; a < A; ++a) m = fmaxf(m, s_alog[a * R + r]);
      float sum = 0.f;
      for (int a = 0; a < A; ++a) sum += expf(s_alog[a * R + r] - m);
      int best = 0;
      float top = -INFINITY;
      for (int a = 0; a < A; ++a) {
        float score = s_alog[a * R + r];
        if (p.act_unimix != 0.f) {
          const float prob = expf(score - m) / sum;
          score = logf((1.f - p.act_unimix) * prob + p.act_unimix / A);
        }
        if (p.g_a) score += p.g_a[((size_t)t * B + min(row, B - 1)) * A + a];
        if (score > top) { top = score; best = a; }
      }
      for (int a = 0; a < A; ++a) {
        const float v = (a == best) ? 1.f : 0.f;
        s_act[a * R + r] = v;
        if (row < B)
          static_cast<T*>(p.action_out)[((size_t)t * B + row) * A + a] =
              from_f<T>(v);
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  const int SC = p.S * p.C;
  const int G = 3 * p.D > SC ? 3 * p.D : SC;
  const int Ap = (p.A + 3) / 4 * 4;
  const size_t floats =
      (size_t)R * (SC + p.D + Ap + G + 2 * p.U + Ap + p.S);  // + s_idx.
  const size_t bytes = floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      imagine_actor_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (p.B + R - 1) / R;
  imagine_actor_kernel<T><<<blocks, NT, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: stoch0, deter0, action0, g_s, g_a, w_in_s, w_in_a, ln_in_s,
//   ln_in_b, w_gru_d, w_gru_x, ln_gru_s, ln_gru_b, w_st, b_st, a_w_d, a_w_s,
//   a_w_out, a_b_out, deter_out, logit_out, stoch_out, action_out, then
//   (w_out, ln_out_s, ln_out_b) per prior layer, (a_ln_s, a_ln_b) per actor
//   layer, a_w_h per hidden actor layer.
// dims: B, H, D, U, S, C, A, n_out, n_act.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int imagine_actor(int bf16, void* const* ptrs, const int* dims,
                             float unimix, float act_unimix, void* stream) {
  Params p = {};
  int i = 0;
  p.stoch0 = ptrs[i++];
  p.deter0 = ptrs[i++];
  p.action0 = ptrs[i++];
  p.g_s = static_cast<const float*>(ptrs[i++]);
  p.g_a = static_cast<const float*>(ptrs[i++]);
  p.w_in_s = ptrs[i++];
  p.w_in_a = ptrs[i++];
  p.ln_in_s = ptrs[i++];
  p.ln_in_b = ptrs[i++];
  p.w_gru_d = ptrs[i++];
  p.w_gru_x = ptrs[i++];
  p.ln_gru_s = ptrs[i++];
  p.ln_gru_b = ptrs[i++];
  p.w_st = ptrs[i++];
  p.b_st = ptrs[i++];
  p.a_w_d = ptrs[i++];
  p.a_w_s = ptrs[i++];
  p.a_w_out = ptrs[i++];
  p.a_b_out = ptrs[i++];
  p.deter_out = ptrs[i++];
  p.logit_out = static_cast<float*>(ptrs[i++]);
  p.stoch_out = ptrs[i++];
  p.action_out = ptrs[i++];
  p.B = dims[0];
  p.H = dims[1];
  p.D = dims[2];
  p.U = dims[3];
  p.S = dims[4];
  p.C = dims[5];
  p.A = dims[6];
  p.n_out = dims[7];
  p.n_act = dims[8];
  if (p.n_out < 1 || p.n_out > MAXL || p.n_act < 1 || p.n_act > MAXL)
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < p.n_out; ++l) {
    p.w_out[l] = ptrs[i++];
    p.ln_out_s[l] = ptrs[i++];
    p.ln_out_b[l] = ptrs[i++];
  }
  for (int l = 0; l < p.n_act; ++l) {
    p.a_ln_s[l] = ptrs[i++];
    p.a_ln_b[l] = ptrs[i++];
  }
  for (int l = 0; l + 1 < p.n_act; ++l) p.a_w_h[l] = ptrs[i++];
  p.unimix = unimix;
  p.act_unimix = act_unimix;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(p, s) : launch<float>(p, s);
}

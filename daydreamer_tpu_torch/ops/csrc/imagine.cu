// Imagination rollout on given actions for Hopper (sm_90a).
//
// Replaces daydreamer_tpu/ops/pallas_rssm.py::_imagine_kernel (entry
// imagine_pallas). For each of B rows and H steps: the RSSM image cell on
// the step's action (split product over stoch and action, LN, ELU; GRU
// with LN and update bias -1; the prior MLP; the prior logits) and a
// Gumbel-max one-hot sample of the prior per group of C classes, which is
// the next step's stoch. It writes deters and stochs in the element type
// and the logits raw in float32 (the caller applies the unimix). The
// Gumbel noise is an input (null: the argmax of the logits); the TPU
// kernel's in-core generator and its literal unimix mixture are replaced by
// argmax(log((1-u) softmax(z) + u/C) + g), which has the same distribution.
//
// Bound: at the xarm proof shape (B = 1024, H = 15, D = U = 512,
// S * C = 1024, A = 5, three prior layers) each row-step is about 2.9 M
// dense multiply-adds plus a gather of S weight rows (dense at the first
// step): about 89 GFLOP in all, 0.090 ms at 989 TFLOP/s bf16, against
// about 0.054 ms for the bytes (7 MB of weights, 110 MB of outputs, 63 MB
// of noise). The operations bound it.
//
// Design. imagine_actor.cu without the actor: rows are independent for the
// whole horizon and plentiful, so a block owns R = 8 rows for all H steps
// and loops over time inside, carries and intermediates in shared memory,
// weights from L2, no grid-wide sync (imagine_common.cuh has the layout,
// the product and the rounding). The step's action is read from global
// memory at its start. mma.sync / wgmma are later work.

#include "imagine_common.cuh"

namespace {

using namespace img;

struct Params {
  const void *stoch0, *deter0, *actions;  // actions [H,B,A].
  const float* g_s;                       // Gumbel noise [H,B,SC], or null.
  void *deter_out, *stoch_out;
  float* logit_out;
  const void *w_in_s, *w_in_a, *ln_in_s, *ln_in_b;
  const void *w_gru_d, *w_gru_x, *ln_gru_s, *ln_gru_b;
  const void *w_st, *b_st;
  const void *w_out[MAXL], *ln_out_s[MAXL], *ln_out_b[MAXL];
  int H, B, A, D, U, S, C, n_out;
  float unimix;
};

template <typename T>
__global__ void __launch_bounds__(NT) imagine_kernel(Params p) {
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
  int* s_idx = reinterpret_cast<int*>(s_hb + U * R);  // [S][R] classes.
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
  for (int t = 0; t < p.H; ++t) {
    // The step's action; the barrier also orders the carries loaded above
    // and the sample of the step before.
    const T* action = static_cast<const T*>(p.actions) + (size_t)t * B * A;
    for (int i = tid; i < R * Ap; i += NT) {
      const int r = i / Ap, j = i % Ap, row = row0 + r;
      s_act[j * R + r] =
          (row < B && j < A) ? to_f(action[(size_t)row * A + j]) : 0.f;
    }
    __syncthreads();
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
  }
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  const int SC = p.S * p.C;
  const int G = 3 * p.D > SC ? 3 * p.D : SC;
  const int Ap = (p.A + 3) / 4 * 4;
  const size_t floats =
      (size_t)R * (SC + p.D + Ap + G + 2 * p.U + p.S);  // + s_idx.
  const size_t bytes = floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      imagine_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (p.B + R - 1) / R;
  imagine_kernel<T><<<blocks, NT, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: stoch0, deter0, actions, g_s (or null), deter_out, logit_out,
//   stoch_out, w_in_s, w_in_a, ln_in_s, ln_in_b, w_gru_d, w_gru_x, ln_gru_s,
//   ln_gru_b, w_st, b_st, then w_out[n_out], ln_out_s[n_out],
//   ln_out_b[n_out].
// dims: H, B, A, D, U, S, C, n_out.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int imagine(int bf16, void* const* ptrs, const int* dims,
                       float unimix, void* stream) {
  Params p = {};
  int i = 0;
  p.stoch0 = ptrs[i++];
  p.deter0 = ptrs[i++];
  p.actions = ptrs[i++];
  p.g_s = static_cast<const float*>(ptrs[i++]);
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
  p.w_st = ptrs[i++];
  p.b_st = ptrs[i++];
  p.H = dims[0];
  p.B = dims[1];
  p.A = dims[2];
  p.D = dims[3];
  p.U = dims[4];
  p.S = dims[5];
  p.C = dims[6];
  p.n_out = dims[7];
  if (p.n_out < 1 || p.n_out > MAXL) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < p.n_out; ++l) p.w_out[l] = ptrs[i++];
  for (int l = 0; l < p.n_out; ++l) p.ln_out_s[l] = ptrs[i++];
  for (int l = 0; l < p.n_out; ++l) p.ln_out_b[l] = ptrs[i++];
  p.unimix = unimix;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(p, s) : launch<float>(p, s);
}

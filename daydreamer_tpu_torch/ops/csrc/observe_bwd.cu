// Fused RSSM observe chain, backward, for Hopper (sm_90a).
//
// Replaces daydreamer_tpu/ops/pallas_rssm_vjp.py::_obs_bwd_kernel (launched
// by _observe_fused_bwd): the sequential part of backpropagation through
// time. Walking t = T-1 .. 0 it recomputes the step's forward from the
// saved carries (the forward's deters and one-hot stochs, shifted by one
// step, with stoch0 and deter0 first), then the adjoints in the
// reference's order: the posterior-logit gradient (direct plus
// straight-through via the softmax), the posterior head, the prior head,
// the GRU and the input layer, and carries ds and dd times the is_first
// mask to the step before. Per step it emits, in float32, the gradient
// after (dz1, dzg, dz2, dq_i) and before (dn1, dng, dn2, dm_i) each
// LayerNorm's backward and the total posterior-logit gradient; at the end
// ds0 and dd0. The weight gradients are batched products over these,
// outside the kernel, as in the reference.
//
// Bound. At the xarm shape a row-step is about 6.8 M dense multiply-adds
// (2.6 M to recompute, 4.2 M transposed) plus a gather, 14.0 GFLOP in all,
// 14.2 us at 989 TFLOP/s; the bytes are 8 MB of bf16 weights once and about
// 61 MB of saved forward, cotangents and emitted adjoints, 20.8 us at
// 3.35 TB/s, so by the roofline the bytes bound it. As in the forward
// kernel the roofline does not describe it: 32 independent rows and 32
// dependent steps of some fifteen dependent layers make it a latency-bound
// chain.
//
// Design. The forward kernel's (observe_common.cuh): a block owns R = 2
// rows for all T steps, everything a step recomputes (the layers' xhat and
// 1/std, the masked inputs, this step's deter) and its adjoints stay in
// shared memory, about 160 KB, and the weights stream from L2. The GRU's
// gates are recomputed from the gates' xhat where the adjoint needs them,
// which saves four vectors per row. A transposed product a @ W^T reads a
// transposed copy of W that the wrapper makes, so it is the same coalesced
// dense() as every other product. From step 1 on the incoming stoch is the
// forward's one-hot, read back as its classes, and its product is a gather.

#include "observe_common.cuh"

namespace {

using namespace obs;

struct Params {
  const void *stoch0, *deter0, *actions, *eproj;
  const float* first;
  const void* deters;
  const float* post_logits;
  const void* stochs;
  const float *dd_out, *dpl, *dprl, *ds_out;
  float *dz1, *dn1, *dzg, *dng, *dz2, *dn2, *dpl_total, *ds0, *dd0;
  const void *w_in_s, *w_in_a, *ln_in_s, *ln_in_b;
  const void *w_gru_d, *w_gru_x, *ln_gru_s, *ln_gru_b;
  const void *w_out[MAXL], *ln_out_s[MAXL], *ln_out_b[MAXL];
  const void *w_obs_d, *ln_obs_s, *ln_obs_b;
  // Transposed copies, [N][K] row-major.
  const void *t_in_s, *t_gru_d, *t_gru_x, *t_st, *t_obs_d, *t_post;
  const void* t_out[MAXL];
  float *dq[MAXL], *dm[MAXL];
  int T, B, A, D, U, S, C, n_out;
  float unimix;
};

// G[i] *= elu'(xhat[i] * scale + bias): the gradient at an ELU's output
// becomes the gradient at the LayerNorm's output under it.
template <typename T>
__device__ __forceinline__ void elu_bwd(float* G, int N, const float* xhat,
                                        const T* scale, const T* bias) {
  for (int i = threadIdx.x; i < N * R; i += NT)
    G[i] *= elu_grad(xhat[i] * to_f(scale[i / R]) + to_f(bias[i / R]));
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(NT) observe_bwd_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.D, U = p.U, A = p.A, S = p.S, C = p.C, B = p.B;
  const int SC = S * C, n_out = p.n_out;
  float* b_big = smem;                  // stoch0; dpl_total; dprl.
  float* b_dm = b_big + SC * R;         // Masked deter input.
  float* b_a = b_dm + D * R;
  float* b_xh1 = b_a + A * R;
  float* b_x1 = b_xh1 + U * R;
  float* b_xhg = b_x1 + U * R;
  float* b_dt = b_xhg + 3 * D * R;
  float* b_xhq = b_dt + D * R;          // n_out buffers of U.
  float* b_p0 = b_xhq + n_out * U * R;  // Prior activations, then dp / dq.
  float* b_p1 = b_p0 + U * R;
  float* b_xh2 = b_p1 + U * R;
  float* b_t1 = b_xh2 + U * R;          // dx2 .. dz2, then dx1 .. dz1.
  float* b_ddt = b_t1 + U * R;
  float* b_dng = b_ddt + D * R;
  float* b_ddm = b_dng + 3 * D * R;
  float* c_ds = b_ddm + D * R;          // The carries.
  float* c_dd = c_ds + SC * R;
  float* s_inv = c_dd + D * R;          // 1/std: in, gru, obs, prior i.
  float* s_keep = s_inv + (3 + MAXL) * R;
  float* s_red = s_keep + R;
  float* s_scratch = s_red + NW * R;
  int* s_idx = reinterpret_cast<int*>(s_scratch + SCRATCH);
  float* inv1 = s_inv;
  float* invg = s_inv + R;
  float* inv2 = s_inv + 2 * R;
  float* invq = s_inv + 3 * R;
  const int tid = threadIdx.x, row0 = blockIdx.x * R;
  const In<T> none = {nullptr, nullptr, nullptr, 0, nullptr};
  auto W = [](const void* w) { return static_cast<const T*>(w); };

  for (int i = tid; i < SC * R; i += NT) c_ds[i] = 0.f;
  for (int i = tid; i < D * R; i += NT) c_dd[i] = 0.f;
  __syncthreads();

  for (int t = p.T - 1; t >= 0; --t) {
    const size_t tb = (size_t)t * B;
    if (tid < R) {
      const int row = row0 + tid;
      s_keep[tid] = row < B ? 1.f - p.first[tb + row] : 0.f;
    }
    __syncthreads();

    // ---- Recompute the step's forward ----------------------------------
    if (t == 0) {
      load_rows(b_big, W(p.stoch0), SC, row0, B, s_keep);
      load_rows(b_dm, W(p.deter0), D, row0, B, s_keep);
    } else {
      // The forward's one-hot of step t-1, as its classes.
      const T* prev = W(p.stochs) + (tb - B) * SC;
      for (int i = tid; i < R * S; i += NT) {
        const int r = i / S, s = i % S, row = row0 + r;
        int best = 0;
        if (row < B) {
          const T* z = prev + (size_t)row * SC + (size_t)s * C;
          for (int c = C - 1; c >= 0; --c)
            if (to_f(z[c]) != 0.f) best = c;
        }
        s_idx[s * R + r] = best;
      }
      load_rows(b_dm, W(p.deters) + (tb - B) * D, D, row0, B, s_keep);
    }
    load_rows(b_a, W(p.actions) + tb * A, A, row0, B, s_keep);
    load_rows(b_xh2, W(p.eproj) + tb * U, U, row0, B, nullptr);
    __syncthreads();
    const In<T> stoch = t == 0
        ? In<T>{b_big, nullptr, nullptr, SC, W(p.w_in_s)}
        : In<T>{nullptr, s_idx, s_keep, SC, W(p.w_in_s)};
    dense<T>(b_xh1, U, stoch, {b_a, nullptr, nullptr, A, W(p.w_in_a)}, C,
             nullptr, nullptr, s_scratch);
    ln_fwd<T>(b_xh1, U, W(p.ln_in_s), W(p.ln_in_b), b_xh1, inv1, true, b_x1,
              s_red);
    dense<T>(b_xhg, 3 * D, {b_dm, nullptr, nullptr, D, W(p.w_gru_d)},
             {b_x1, nullptr, nullptr, U, W(p.w_gru_x)}, C, nullptr, nullptr,
             s_scratch);
    ln_fwd<T>(b_xhg, 3 * D, W(p.ln_gru_s), W(p.ln_gru_b), b_xhg, invg, false,
              nullptr, s_red);
    {
      const T* gs = W(p.ln_gru_s);
      const T* gb = W(p.ln_gru_b);
      for (int i = tid; i < D * R; i += NT) {
        const int d = i / R, r = i % R;
        const float gr = b_xhg[d * R + r] * to_f(gs[d]) + to_f(gb[d]);
        const float gc = b_xhg[(D + d) * R + r] * to_f(gs[D + d]) +
                         to_f(gb[D + d]);
        const float gu = b_xhg[(2 * D + d) * R + r] * to_f(gs[2 * D + d]) +
                         to_f(gb[2 * D + d]);
        const float reset = sigmoid(gr);
        const float cand = tanhf(reset * gc);
        const float update = sigmoid(gu - 1.f);
        b_dt[i] = update * cand + (1.f - update) * b_dm[i];
      }
    }
    __syncthreads();
    {
      const float* h = b_dt;
      int width = D;
      for (int l = 0; l < n_out; ++l) {
        float* xh = b_xhq + (size_t)l * U * R;
        float* act = l + 1 == n_out ? nullptr : (l % 2 == 0 ? b_p0 : b_p1);
        dense<T>(xh, U, {h, nullptr, nullptr, width, W(p.w_out[l])}, none, C,
                 nullptr, nullptr, s_scratch);
        ln_fwd<T>(xh, U, W(p.ln_out_s[l]), W(p.ln_out_b[l]), xh, invq + l * R,
                  true, act, s_red);
        h = act;
        width = U;
      }
    }
    // z2 = d_t @ w_obs_d + e_proj (loaded into b_xh2 above).
    dense<T>(b_xh2, U, {b_dt, nullptr, nullptr, D, W(p.w_obs_d)}, none, C,
             nullptr, b_xh2, s_scratch);
    ln_fwd<T>(b_xh2, U, W(p.ln_obs_s), W(p.ln_obs_b), b_xh2, inv2, false,
              nullptr, s_red);

    // ---- Posterior-logit gradient --------------------------------------
    // ds_total = ds_out + carry (kept in c_ds); b_big = post logits.
    load_rows(b_big, p.post_logits + tb * SC, SC, row0, B, nullptr);
    for (int i = tid; i < R * SC; i += NT) {
      const int r = i / SC, j = i % SC, row = row0 + r;
      if (row < B) c_ds[j * R + r] += p.ds_out[(tb + row) * SC + j];
    }
    __syncthreads();
    for (int i = tid; i < R * S; i += NT) {
      const int r = i / S, s = i % S;
      float* z = b_big + (size_t)s * C * R + r;
      const float* ds = c_ds + (size_t)s * C * R + r;
      float m = -INFINITY;
      for (int c = 0; c < C; ++c) m = fmaxf(m, z[c * R]);
      float sum = 0.f;
      for (int c = 0; c < C; ++c) sum += expf(z[c * R] - m);
      const float f = 1.f - p.unimix;
      float dot = 0.f;
      for (int c = 0; c < C; ++c) {
        const float sm = expf(z[c * R] - m) / sum;
        dot += f * ds[c * R] * sm;
      }
      for (int c = 0; c < C; ++c) {
        const float sm = expf(z[c * R] - m) / sum;
        z[c * R] = sm * (f * ds[c * R] - dot);
      }
    }
    __syncthreads();
    for (int i = tid; i < R * SC; i += NT) {
      const int r = i / SC, j = i % SC, row = row0 + r;
      if (row < B) {
        const float v = b_big[j * R + r] + p.dpl[(tb + row) * SC + j];
        b_big[j * R + r] = v;
        p.dpl_total[(tb + row) * SC + j] = v;
      }
    }
    __syncthreads();

    // ---- Posterior head --------------------------------------------------
    dense<T>(b_t1, U, {b_big, nullptr, nullptr, SC, W(p.t_post)}, none, C,
             nullptr, nullptr, s_scratch);
    elu_bwd<T>(b_t1, U, b_xh2, W(p.ln_obs_s), W(p.ln_obs_b));
    store_rows(p.dn2 + tb * U, b_t1, U, row0, B);
    ln_bwd<T>(b_t1, U, b_xh2, inv2, W(p.ln_obs_s), s_red);
    store_rows(p.dz2 + tb * U, b_t1, U, row0, B);
    // dd_t = dd_out + carry + dz2 @ w_obs_d^T.
    load_rows(b_ddt, p.dd_out + tb * D, D, row0, B, nullptr);
    __syncthreads();
    for (int i = tid; i < D * R; i += NT) b_ddt[i] += c_dd[i];
    __syncthreads();
    dense<T>(b_ddt, D, {b_t1, nullptr, nullptr, U, W(p.t_obs_d)}, none, C,
             nullptr, b_ddt, s_scratch);

    // ---- Prior head ------------------------------------------------------
    load_rows(b_big, p.dprl + tb * SC, SC, row0, B, nullptr);
    __syncthreads();
    {
      float* cur = b_p0;
      float* other = b_p1;
      dense<T>(cur, U, {b_big, nullptr, nullptr, SC, W(p.t_st)}, none, C,
               nullptr, nullptr, s_scratch);
      for (int l = n_out - 1; l >= 0; --l) {
        const float* xh = b_xhq + (size_t)l * U * R;
        elu_bwd<T>(cur, U, xh, W(p.ln_out_s[l]), W(p.ln_out_b[l]));
        store_rows(p.dm[l] + tb * U, cur, U, row0, B);
        ln_bwd<T>(cur, U, xh, invq + l * R, W(p.ln_out_s[l]), s_red);
        store_rows(p.dq[l] + tb * U, cur, U, row0, B);
        if (l > 0) {
          dense<T>(other, U, {cur, nullptr, nullptr, U, W(p.t_out[l])}, none,
                   C, nullptr, nullptr, s_scratch);
          float* swap = cur;
          cur = other;
          other = swap;
        } else {
          dense<T>(b_ddt, D, {cur, nullptr, nullptr, U, W(p.t_out[0])}, none,
                   C, nullptr, b_ddt, s_scratch);
        }
      }
    }

    // ---- GRU -------------------------------------------------------------
    {
      const T* gs = W(p.ln_gru_s);
      const T* gb = W(p.ln_gru_b);
      for (int i = tid; i < D * R; i += NT) {
        const int d = i / R, r = i % R;
        const float gr = b_xhg[d * R + r] * to_f(gs[d]) + to_f(gb[d]);
        const float gc = b_xhg[(D + d) * R + r] * to_f(gs[D + d]) +
                         to_f(gb[D + d]);
        const float gu = b_xhg[(2 * D + d) * R + r] * to_f(gs[2 * D + d]) +
                         to_f(gb[2 * D + d]);
        const float rr = sigmoid(gr);
        const float c = tanhf(rr * gc);
        const float u = sigmoid(gu - 1.f);
        const float ddt = b_ddt[i], dmv = b_dm[i];
        const float du = ddt * (c - dmv);
        const float dc = ddt * u;
        const float dcbar = dc * (1.f - c * c);
        b_ddm[i] = ddt * (1.f - u);
        b_dng[d * R + r] = dcbar * gc * rr * (1.f - rr);
        b_dng[(D + d) * R + r] = dcbar * rr;
        b_dng[(2 * D + d) * R + r] = du * u * (1.f - u);
      }
    }
    __syncthreads();
    store_rows(p.dng + tb * 3 * D, b_dng, 3 * D, row0, B);
    ln_bwd<T>(b_dng, 3 * D, b_xhg, invg, W(p.ln_gru_s), s_red);
    store_rows(p.dzg + tb * 3 * D, b_dng, 3 * D, row0, B);
    dense<T>(b_t1, U, {b_dng, nullptr, nullptr, 3 * D, W(p.t_gru_x)}, none, C,
             nullptr, nullptr, s_scratch);
    dense<T>(b_ddm, D, {b_dng, nullptr, nullptr, 3 * D, W(p.t_gru_d)}, none,
             C, nullptr, b_ddm, s_scratch);

    // ---- Input layer -------------------------------------------------------
    elu_bwd<T>(b_t1, U, b_xh1, W(p.ln_in_s), W(p.ln_in_b));
    store_rows(p.dn1 + tb * U, b_t1, U, row0, B);
    ln_bwd<T>(b_t1, U, b_xh1, inv1, W(p.ln_in_s), s_red);
    store_rows(p.dz1 + tb * U, b_t1, U, row0, B);
    dense<T>(c_ds, SC, {b_t1, nullptr, nullptr, U, W(p.t_in_s)}, none, C,
             nullptr, nullptr, s_scratch);
    for (int i = tid; i < SC * R; i += NT) c_ds[i] *= s_keep[i % R];
    for (int i = tid; i < D * R; i += NT) c_dd[i] = b_ddm[i] * s_keep[i % R];
    __syncthreads();
  }
  store_rows(p.ds0, c_ds, SC, row0, B);
  store_rows(p.dd0, c_dd, D, row0, B);
}

size_t smem_bytes(const Params& p) {
  const int SC = p.S * p.C;
  const size_t floats =
      (size_t)R * (2 * SC + 11 * p.D + p.A + (6 + p.n_out) * p.U +
                   (3 + MAXL) + 1 + NW + SCRATCH / R + p.S);
  return floats * sizeof(float);
}

template <typename T>
int launch(const Params& p, cudaStream_t stream) {
  const size_t bytes = smem_bytes(p);
  cudaError_t err = cudaFuncSetAttribute(
      observe_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (p.B + R - 1) / R;
  observe_bwd_kernel<T><<<blocks, NT, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: stoch0, deter0, actions, eproj, first, deters, post_logits, stochs,
//   dd_out, dpl, dprl, ds_out, dz1, dn1, dzg, dng, dz2, dn2, dpl_total, ds0,
//   dd0, w_in_s, w_in_a, ln_in_s, ln_in_b, w_gru_d, w_gru_x, ln_gru_s,
//   ln_gru_b, w_out[n_out], ln_out_s[n_out], ln_out_b[n_out], w_obs_d,
//   ln_obs_s, ln_obs_b, then the transposed copies of w_in_s, w_gru_d,
//   w_gru_x, w_st, w_obs_d, w_post and w_out[n_out], then dq[n_out],
//   dm[n_out].
// dims: T, B, A, D, U, S, C, n_out.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int observe_bwd(int bf16, void* const* ptrs, const int* dims,
                           float unimix, void* stream) {
  Params p = {};
  int i = 0;
  auto in_f = [&]() { return static_cast<const float*>(ptrs[i++]); };
  auto out_f = [&]() { return static_cast<float*>(ptrs[i++]); };
  p.stoch0 = ptrs[i++];
  p.deter0 = ptrs[i++];
  p.actions = ptrs[i++];
  p.eproj = ptrs[i++];
  p.first = in_f();
  p.deters = ptrs[i++];
  p.post_logits = in_f();
  p.stochs = ptrs[i++];
  p.dd_out = in_f();
  p.dpl = in_f();
  p.dprl = in_f();
  p.ds_out = in_f();
  p.dz1 = out_f();
  p.dn1 = out_f();
  p.dzg = out_f();
  p.dng = out_f();
  p.dz2 = out_f();
  p.dn2 = out_f();
  p.dpl_total = out_f();
  p.ds0 = out_f();
  p.dd0 = out_f();
  p.T = dims[0];
  p.B = dims[1];
  p.A = dims[2];
  p.D = dims[3];
  p.U = dims[4];
  p.S = dims[5];
  p.C = dims[6];
  p.n_out = dims[7];
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
  p.w_obs_d = ptrs[i++];
  p.ln_obs_s = ptrs[i++];
  p.ln_obs_b = ptrs[i++];
  p.t_in_s = ptrs[i++];
  p.t_gru_d = ptrs[i++];
  p.t_gru_x = ptrs[i++];
  p.t_st = ptrs[i++];
  p.t_obs_d = ptrs[i++];
  p.t_post = ptrs[i++];
  for (int l = 0; l < p.n_out; ++l) p.t_out[l] = ptrs[i++];
  for (int l = 0; l < p.n_out; ++l) p.dq[l] = static_cast<float*>(ptrs[i++]);
  for (int l = 0; l < p.n_out; ++l) p.dm[l] = static_cast<float*>(ptrs[i++]);
  p.unimix = unimix;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(p, s) : launch<float>(p, s);
}

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
// 3.35 TB/s, so by the roofline the bytes bound it. The roofline does not
// describe it: 32 independent rows and 32 dependent steps of fifteen
// dependent products make it a chain, and each pair of rows pulls the
// 13.6 MB of weights and transposed copies from L2 in every step: 16 x 32
// x 13.6 MB = 7 GB, about 1.5 ms at the L2's rate, whatever the number of
// SMs that share the pulling. The chain is float32 throughout and its
// gradients are held to 1e-4 of their scale, so bf16 tensor cores are not
// the tool.
//
// Design. With a block for each pair of rows (the parent kernel) 16 SMs
// worked and 116 idled: 8.5 ms (NVIDIA H100 80GB HBM3, 700 W, xarm shape,
// bfloat16), of which 4.9 ms were the products, each SM pulling its
// 13.6 MB a step at 90 GB/s, close to what one SM's port takes in. Here a
// thread block cluster of 4 blocks owns the pair of rows, 16 clusters on 64
// SMs (why not 8 blocks: observe_cluster.cuh). Every rank keeps the step's
// vectors in its own shared memory, about 160 KB, and computes a quarter of
// every product's columns, which it writes into all four shared memories
// before the cluster's barrier; everything between the products every
// rank computes for itself, in the same order, so the ranks never differ
// by a bit. That brings the products to 2.5 ms and the kernel to 6.3 ms.
// What is left is no product: 3.7 ms of LayerNorms, the softmax of the
// posterior gradient, the GRU's elementwise part, loads, stores and some
// 110 block barriers a step, a chain of small dependent phases that a
// cluster does not shorten, because every rank repeats it. Each emitted
// adjoint is stored by one rank, in turns. The GRU's gates are recomputed
// from the gates' xhat where the adjoint needs them, which saves four
// vectors per row. A transposed product a @ W^T reads a transposed copy of
// W that the wrapper makes, so it is the same coalesced product as every
// other. From step 1 on the incoming stoch is the forward's one-hot, read
// back as its classes, and its product is a gather.
//
// Every width the JAX kernel takes. The products read V weights at a time, a
// template argument the wrapper picks from the widths (observe_common.cuh:
// 16-byte loads at the shipped widths, single values where a row is no multiple
// of 16 bytes). The prior head takes any number of layers: with none it reads
// d_t, and its gradient goes to dd_t through w_st^T alone. The shipped path (1
// to MAXL layers, the step's vectors in shared memory) is the instantiation it
// always was. With no layer or past MAXL, or where the vectors outgrow shared
// memory (deter past about 2 300 at xarm's other widths), the wrapper hands
// over a workspace and the wide instantiation runs: parameters that hold MANY
// layers' addresses, and the vectors in the block's copy of the workspace
// (observe_cluster.cuh). Its instantiations are compiled beside this file's, by
// a second nvcc: observe_bwd_wide.cu includes this file with OBSERVE_BWD_WIDE
// defined, and the two objects are linked into one library (ops/build.py,
// `parts`).

#include "observe_cluster.cuh"

namespace {

using namespace obc;

template <int L>
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
  const void *w_out[L], *ln_out_s[L], *ln_out_b[L];
  const void *w_obs_d, *ln_obs_s, *ln_obs_b;
  // Transposed copies, [N][K] row-major.
  const void *t_in_s, *t_gru_d, *t_gru_x, *t_st, *t_obs_d, *t_post;
  const void* t_out[L];
  float *dq[L], *dm[L];
  float* ws;  // The workspace (wide path), or null.
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

// Every rank holds every emitted vector; one of them stores it, in turns.
__device__ __forceinline__ bool my_turn(int& turn, int rank) {
  return turn++ % CL == rank;
}

// The floats of a block's vectors: in shared memory, or in the wide path a
// block's copy in the workspace.
template <int L>
__host__ __device__ size_t vector_floats(const Params<L>& p) {
  return (size_t)R * (2 * p.S * p.C + 11 * p.D + p.A + (6 + p.n_out) * p.U);
}

// WIDE: the wide path (MANY layers, the vectors in the workspace).
template <typename T, int V, bool WIDE>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(NT)
    observe_bwd_kernel(Params<WIDE ? MANY : MAXL> p) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.D, U = p.U, A = p.A, S = p.S, C = p.C, B = p.B;
  const int SC = S * C, n_out = p.n_out;
  const size_t stride = WIDE ? vector_floats(p) : 0;
  // stoch0; dpl_total; dprl.
  float* b_big = WIDE ? p.ws + blockIdx.x * stride : smem;
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
  float* s_inv = WIDE ? smem : c_dd + D * R;  // 1/std: in, gru, obs, prior i.
  float* s_keep = s_inv + (3 + (WIDE ? n_out : MAXL)) * R;
  float* s_red = s_keep + R;
  float* s_scratch = s_red + 2 * NW * R;
  int* s_idx = reinterpret_cast<int*>(s_scratch + SCRATCH);
  float* inv1 = s_inv;
  float* invg = s_inv + R;
  float* inv2 = s_inv + 2 * R;
  float* invq = s_inv + 3 * R;
  const int tid = threadIdx.x, row0 = blockIdx.x / CL * R;
  const int rank = ptx::cluster_rank();
  int turn = 0;  // Counts the emitted vectors, see my_turn().
  const In<T> none = {nullptr, nullptr, nullptr, 0, nullptr};
  auto W = [](const void* w) { return static_cast<const T*>(w); };

  for (int i = tid; i < SC * R; i += NT) c_ds[i] = 0.f;
  for (int i = tid; i < D * R; i += NT) c_dd[i] = 0.f;
  // No rank writes into another's shared memory before all have started.
  ptx::cluster_sync();

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
    // dd_out + carry, which two products of the step add to: set up here,
    // before the barrier ahead of the first of them (see cdense()).
    for (int i = tid; i < R * D; i += NT) {
      const int r = i / D, j = i % D, row = row0 + r;
      b_ddt[j * R + r] =
          (row < B ? p.dd_out[(tb + row) * D + j] : 0.f) + c_dd[j * R + r];
    }
    __syncthreads();
    const In<T> stoch = t == 0
        ? In<T>{b_big, nullptr, nullptr, SC, W(p.w_in_s)}
        : In<T>{nullptr, s_idx, s_keep, SC, W(p.w_in_s)};
    cdense<T, V, WIDE>(b_xh1, U, stoch, {b_a, nullptr, nullptr, A, W(p.w_in_a)},
                       C, nullptr, nullptr, s_scratch, rank, stride);
    ln_forward<T>(b_xh1, U, W(p.ln_in_s), W(p.ln_in_b), b_xh1, inv1, true, b_x1,
              s_red);
    cdense<T, V, WIDE>(b_xhg, 3 * D, {b_dm, nullptr, nullptr, D, W(p.w_gru_d)},
                       {b_x1, nullptr, nullptr, U, W(p.w_gru_x)}, C, nullptr,
                       nullptr, s_scratch, rank, stride);
    ln_forward<T>(b_xhg, 3 * D, W(p.ln_gru_s), W(p.ln_gru_b), b_xhg, invg, false,
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
        cdense<T, V, WIDE>(xh, U, {h, nullptr, nullptr, width, W(p.w_out[l])},
                           none, C, nullptr, nullptr, s_scratch, rank, stride);
        ln_forward<T>(xh, U, W(p.ln_out_s[l]), W(p.ln_out_b[l]), xh, invq + l * R,
                  true, act, s_red);
        h = act;
        width = U;
      }
    }
    // z2 = d_t @ w_obs_d + e_proj (loaded into b_xh2 above).
    cdense<T, V, WIDE>(b_xh2, U, {b_dt, nullptr, nullptr, D, W(p.w_obs_d)},
                       none, C, nullptr, b_xh2, s_scratch, rank, stride);
    ln_forward<T>(b_xh2, U, W(p.ln_obs_s), W(p.ln_obs_b), b_xh2, inv2, false,
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
    const bool emit = my_turn(turn, rank);
    for (int i = tid; i < R * SC; i += NT) {
      const int r = i / SC, j = i % SC, row = row0 + r;
      if (row < B) {
        const float v = b_big[j * R + r] + p.dpl[(tb + row) * SC + j];
        b_big[j * R + r] = v;
        if (emit) p.dpl_total[(tb + row) * SC + j] = v;
      }
    }
    __syncthreads();

    // ---- Posterior head --------------------------------------------------
    cdense<T, V, WIDE>(b_t1, U, {b_big, nullptr, nullptr, SC, W(p.t_post)},
                       none, C, nullptr, nullptr, s_scratch, rank, stride);
    elu_bwd<T>(b_t1, U, b_xh2, W(p.ln_obs_s), W(p.ln_obs_b));
    if (my_turn(turn, rank))
      store_rows(p.dn2 + tb * U, b_t1, U, row0, B);
    ln_backward<T>(b_t1, U, b_xh2, inv2, W(p.ln_obs_s), s_red);
    if (my_turn(turn, rank))
      store_rows(p.dz2 + tb * U, b_t1, U, row0, B);
    // dd_t = dd_out + carry (in b_ddt since the step's start) + dz2 @
    // w_obs_d^T.
    cdense<T, V, WIDE>(b_ddt, D, {b_t1, nullptr, nullptr, U, W(p.t_obs_d)},
                       none, C, nullptr, b_ddt, s_scratch, rank, stride);

    // ---- Prior head ------------------------------------------------------
    load_rows(b_big, p.dprl + tb * SC, SC, row0, B, nullptr);
    __syncthreads();
    if (WIDE && n_out == 0) {
      // No layer (the wide path's): the head reads d_t, and dprl @ w_st^T
      // adds to dd_t.
      cdense<T, V, WIDE>(b_ddt, D, {b_big, nullptr, nullptr, SC, W(p.t_st)},
                         none, C, nullptr, b_ddt, s_scratch, rank, stride);
    } else {
      float* cur = b_p0;
      float* other = b_p1;
      cdense<T, V, WIDE>(cur, U, {b_big, nullptr, nullptr, SC, W(p.t_st)}, none,
                         C, nullptr, nullptr, s_scratch, rank, stride);
      for (int l = n_out - 1; l >= 0; --l) {
        const float* xh = b_xhq + (size_t)l * U * R;
        elu_bwd<T>(cur, U, xh, W(p.ln_out_s[l]), W(p.ln_out_b[l]));
        if (my_turn(turn, rank))
          store_rows(p.dm[l] + tb * U, cur, U, row0, B);
        ln_backward<T>(cur, U, xh, invq + l * R, W(p.ln_out_s[l]), s_red);
        if (my_turn(turn, rank))
          store_rows(p.dq[l] + tb * U, cur, U, row0, B);
        if (l > 0) {
          cdense<T, V, WIDE>(other, U,
                             {cur, nullptr, nullptr, U, W(p.t_out[l])}, none, C,
                             nullptr, nullptr, s_scratch, rank, stride);
          float* swap = cur;
          cur = other;
          other = swap;
        } else {
          cdense<T, V, WIDE>(b_ddt, D,
                             {cur, nullptr, nullptr, U, W(p.t_out[0])}, none, C,
                             nullptr, b_ddt, s_scratch, rank, stride);
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
    if (my_turn(turn, rank))
      store_rows(p.dng + tb * 3 * D, b_dng, 3 * D, row0, B);
    ln_backward<T>(b_dng, 3 * D, b_xhg, invg, W(p.ln_gru_s), s_red);
    if (my_turn(turn, rank))
      store_rows(p.dzg + tb * 3 * D, b_dng, 3 * D, row0, B);
    cdense<T, V, WIDE>(b_t1, U, {b_dng, nullptr, nullptr, 3 * D, W(p.t_gru_x)},
                       none, C, nullptr, nullptr, s_scratch, rank, stride);
    cdense<T, V, WIDE>(b_ddm, D, {b_dng, nullptr, nullptr, 3 * D, W(p.t_gru_d)},
                       none, C, nullptr, b_ddm, s_scratch, rank, stride);

    // ---- Input layer -------------------------------------------------------
    elu_bwd<T>(b_t1, U, b_xh1, W(p.ln_in_s), W(p.ln_in_b));
    if (my_turn(turn, rank))
      store_rows(p.dn1 + tb * U, b_t1, U, row0, B);
    ln_backward<T>(b_t1, U, b_xh1, inv1, W(p.ln_in_s), s_red);
    if (my_turn(turn, rank))
      store_rows(p.dz1 + tb * U, b_t1, U, row0, B);
    cdense<T, V, WIDE>(c_ds, SC, {b_t1, nullptr, nullptr, U, W(p.t_in_s)}, none,
                       C, nullptr, nullptr, s_scratch, rank, stride);
    for (int i = tid; i < SC * R; i += NT) c_ds[i] *= s_keep[i % R];
    for (int i = tid; i < D * R; i += NT) c_dd[i] = b_ddm[i] * s_keep[i % R];
    __syncthreads();
  }
  if (my_turn(turn, rank))
    store_rows(p.ds0, c_ds, SC, row0, B);
  if (my_turn(turn, rank))
    store_rows(p.dd0, c_dd, D, row0, B);
}

template <bool WIDE, int L>
size_t smem_bytes(const Params<L>& p) {
  const size_t floats = (size_t)R * ((3 + (WIDE ? p.n_out : MAXL)) + 1 +
                                     2 * NW + SCRATCH / R + p.S);
  return (floats + (WIDE ? 0 : vector_floats(p))) * sizeof(float);
}

template <typename T, int V, bool WIDE>
int launch(const Params<WIDE ? MANY : MAXL>& p, cudaStream_t stream) {
  const size_t bytes = smem_bytes<WIDE>(p);
  cudaError_t err = cudaFuncSetAttribute(
      observe_bwd_kernel<T, V, WIDE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (p.B + R - 1) / R * CL;  // A cluster a pair of rows.
  observe_bwd_kernel<T, V, WIDE><<<blocks, NT, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

// Reads the pointers and dims into the parameters of a path that holds L
// layers and launches it.
template <int L>
int read_and_launch(int bf16, void* const* ptrs, const int* dims,
                    float unimix, cudaStream_t stream) {
  Params<L> p = {};
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
  p.ws = static_cast<float*>(ptrs[i++]);
  p.unimix = unimix;
  constexpr bool WIDE = L == MANY;
  if (bf16)
    return with_values<__nv_bfloat16>(dims[8], [&](auto v) {
      return launch<__nv_bfloat16, decltype(v)::value, WIDE>(p, stream);
    });
  return with_values<float>(dims[8], [&](auto v) {
    return launch<float, decltype(v)::value, WIDE>(p, stream);
  });
}

}  // namespace

#ifdef OBSERVE_BWD_WIDE
// The wide path, for observe_bwd below (same pointers and dims).
extern "C" int observe_bwd_wide(int bf16, void* const* ptrs, const int* dims,
                                float unimix, void* stream) {
  return read_and_launch<MANY>(bf16, ptrs, dims, unimix,
                               static_cast<cudaStream_t>(stream));
}
#else
extern "C" int observe_bwd_wide(int bf16, void* const* ptrs, const int* dims,
                                float unimix, void* stream);

// ptrs: stoch0, deter0, actions, eproj, first, deters, post_logits, stochs,
//   dd_out, dpl, dprl, ds_out, dz1, dn1, dzg, dng, dz2, dn2, dpl_total, ds0,
//   dd0, w_in_s, w_in_a, ln_in_s, ln_in_b, w_gru_d, w_gru_x, ln_gru_s,
//   ln_gru_b, w_out[n_out], ln_out_s[n_out], ln_out_b[n_out], w_obs_d,
//   ln_obs_s, ln_obs_b, then the transposed copies of w_in_s, w_gru_d,
//   w_gru_x, w_st, w_obs_d, w_post and w_out[n_out], then dq[n_out],
//   dm[n_out], then the workspace (float32, a block's vectors a block of the
//   grid) for the wide path, or null for the shipped one.
// dims: T, B, A, D, U, S, C, n_out (1 to MAXL on the shipped path, 0 to
//   MANY on the wide one), values (the V of every load, see
//   observe_common.cuh).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int observe_bwd(int bf16, void* const* ptrs, const int* dims,
                           float unimix, void* stream) {
  const int n_out = dims[7];
  // The workspace's pointer: after the 21 inputs and outputs, 8 + 3 n_out
  // cell weights, the 3 of the posterior head, 6 + n_out transposed copies
  // and 2 n_out adjoints.
  const bool wide = ptrs[38 + 6 * n_out] != nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_out < (wide ? 0 : 1) || n_out > (wide ? MANY : MAXL))
    return (int)cudaErrorInvalidValue;
  return wide ? observe_bwd_wide(bf16, ptrs, dims, unimix, stream)
              : read_and_launch<MAXL>(bf16, ptrs, dims, unimix, s);
}
#endif

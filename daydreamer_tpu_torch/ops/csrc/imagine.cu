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
// of noise). The operations bound it. This design has a floor of its own
// above that: a block owns R = 8 rows for all H steps, 128 blocks, and
// every block streams a step's dense weights (GRU, prior MLP, w_st, 5.7 MB
// in bf16) from L2 in every step, 128 x 15 x 5.7 MB = 11 GB through the L2.
//
// Design: imagine_actor.cu without the actor (imagine_mma.cuh has the
// product, the ring and their layouts). The block keeps its rows' carries
// (deter, and the stoch as its sampled classes [S][R]) and every
// intermediate in shared memory; the step's action is read from global
// memory at its start. In bfloat16 the dense products run on the tensor
// cores, mma.sync m16n8k16 with the output columns as M and the block's 8
// rows as N, from a ring of 32 x 512 weight tiles that cp.async fills up to
// four stages deep and that runs on across layers and steps. Each mma
// starts from zero and its sums are added by FADD (accumulating in the
// tensor cores, which cut toward zero, moved bf16 roundings and samples in
// imagine_actor). The parent kernel read the weights from L2 inside the k
// loop and multiplied in float FMAs: 10.0 ms (NVIDIA H100 80GB HBM3,
// 700 W, proof shape, bfloat16); this one takes 4.55, 2.5 TB/s of that L2
// stream. The products with the action (K = A) and
// any width that is no multiple of 16 keep an FMA product; the products
// with the rollout's own one-hot sample stay gathers of S weight rows.
// float32 runs the parent kernel itself (imagine_fma_kernel). Values are
// rounded to T exactly where the JAX cell rounds (after each product,
// LayerNorm and ELU), so the kernel differs from its plain PyTorch version
// only in the order of the sums.
//
// Every width the JAX kernel takes, as imagine_actor.cu: the prior MLP may
// have no layer; past MAXL layers, or where the products' float sums
// outgrow shared memory (deter past about 1 900 at a1's other widths), the
// wide instantiation of either kernel runs, its parameters holding MANY
// layers' addresses and the sums (and the ring kernel's schedule) in the
// block's copy of the workspace that the wrapper hands over.

#include "imagine_mma.cuh"

namespace {

using namespace imm;

template <int L>
struct Params {
  const void *stoch0, *deter0, *actions;  // actions [H,B,A].
  const float* g_s;                       // Gumbel noise [H,B,SC], or null.
  void *deter_out, *stoch_out;
  float* logit_out;
  const void *w_in_s, *w_in_a, *ln_in_s, *ln_in_b;
  const void *w_gru_d, *w_gru_x, *ln_gru_s, *ln_gru_b;
  const void *w_st, *b_st;
  const void *w_out[L], *ln_out_s[L], *ln_out_b[L];
  float* ws;  // The wide path's workspace, or null.
  int H, B, A, D, U, S, C, n_out;
  float unimix;
};

// Shared memory of the ring kernel, in this order: Y [G][R] float (every
// product's sum), the sampled classes [S][R] int, then in bf16 the product
// inputs stoch0 [SC][R], deter [D][R], action [Ap][R] and two hidden vectors
// [U][R], the schedule, and the ring's stages. The wide path keeps Y and
// the schedule in its workspace (workspace_floats).
constexpr int WIDE_P = products(MANY);

template <int L>
size_t fixed_bytes(const Params<L>& p, bool wide) {
  const size_t item = sizeof(bf16);
  const int SC = p.S * p.C;
  const int G = 3 * p.D > SC ? 3 * p.D : SC;
  const int Ap = (p.A + 3) / 4 * 4;
  return (size_t)R * (4 * ((wide ? 0 : G) + p.S) +
                      item * (SC + p.D + Ap + 2 * p.U)) +
         (wide ? 0 : sizeof(Schedule<products(L)>));
}

// The floats of a block's copy of the wide path's workspace: Y, then the
// ring kernel's schedule (the wrapper sizes it alike for both kernels).
template <int L>
__host__ __device__ size_t workspace_floats(const Params<L>& p) {
  const int SC = p.S * p.C;
  const int G = 3 * p.D > SC ? 3 * p.D : SC;
  return (size_t)R * G + sizeof(Schedule<WIDE_P>) / sizeof(float);
}

// Y[n][r] = X0 @ W0 (+ X1 @ W1) (+ extra) (+ bias) for product q of the
// schedule: on the tensor cores where the schedule says so (a product with
// the action is then added by FMA), else by FMA. The buffers come as
// arguments, not through a closure: the compiler must go on knowing that
// they point into shared memory.
template <int P>
__device__ __forceinline__ void dense(Ring<P>& ring, const Product& q,
                                      const bf16* X0, const bf16* X1,
                                      const Src<bf16>& extra,
                                      const void* bias_, bool round, int C,
                                      float* Y) {
  const bf16* bias = static_cast<const bf16*>(bias_);
  const Src<bf16> none = {nullptr, nullptr, 0, nullptr};
  if (q.mma) {
    dense_mma(ring, q, X0, X1, extra.W ? nullptr : bias, round && !extra.W,
              Y);
    if (extra.W) dense_fma<bf16>(extra, none, C, q.N, bias, round, Y, Y);
    return;
  }
  const void* w0 = q.W[0];
  const void* w1 = q.W[1];
  const Src<bf16> first = {X0, nullptr, q.K[0],
                           static_cast<const bf16*>(w0)};
  const Src<bf16> second = {X1, nullptr, q.K[1],
                            static_cast<const bf16*>(w1)};
  dense_fma<bf16>(first, X1 ? second : extra, C, q.N, bias, round, Y,
                  nullptr);
}

// WIDE: the wide path (MANY layers, Y and the schedule in the workspace).
template <bool WIDE>
__global__ void __launch_bounds__(NT) imagine_kernel(
    Params<WIDE ? MANY : MAXL> p, int stages) {
  extern __shared__ __align__(16) float smem[];
  constexpr int P = products(WIDE ? MANY : MAXL);
  const int D = p.D, U = p.U, A = p.A, S = p.S, C = p.C, SC = S * C;
  const int B = p.B;
  const int G = max(3 * D, SC);
  const int Ap = (A + 3) / 4 * 4;
  float* ws = WIDE ? p.ws + blockIdx.x * workspace_floats(p) : nullptr;
  float* s_g = WIDE ? ws : smem;
  // [S][R] classes.
  int* s_idx = reinterpret_cast<int*>(WIDE ? smem : s_g + G * R);
  bf16* x_stoch = reinterpret_cast<bf16*>(s_idx + S * R);
  bf16* x_deter = x_stoch + SC * R;
  bf16* x_act = x_deter + D * R;
  bf16* x_ha = x_act + Ap * R;
  bf16* x_hb = x_ha + U * R;
  Schedule<P>* sched = reinterpret_cast<Schedule<P>*>(
      WIDE ? ws + G * R : reinterpret_cast<float*>(x_hb + U * R));
  const int row0 = blockIdx.x * R;
  const int tid = threadIdx.x;
  auto W = [](const void* w) { return static_cast<const bf16*>(w); };
  const Src<bf16> none = {nullptr, nullptr, 0, nullptr};

  // A step's dense products, in the order the step takes them.
  const int J_IN = 0, J_GRU = 1, J_OUT = 2, J_ST = 2 + p.n_out;
  if (tid == 0) {
    auto set = [&](int j, const void* w0, int k0, const void* w1, int k1,
                   int n, bool first_only) {
      Product& q = sched->prod[j];
      q.W[0] = static_cast<const bf16*>(w0);
      q.W[1] = static_cast<const bf16*>(w1);
      q.K[0] = k0;
      q.K[1] = k1;
      q.N = n;
      q.mma = stages >= 2 && k0 % 16 == 0 && k1 % 16 == 0 &&
              n % 16 == 0;
      q.first_only = first_only;
    };
    set(J_IN, p.w_in_s, SC, nullptr, 0, U, true);
    set(J_GRU, p.w_gru_d, D, p.w_gru_x, U, 3 * D, false);
    for (int l = 0; l < p.n_out; ++l)
      set(J_OUT + l, p.w_out[l], l == 0 ? D : U, nullptr, 0, U, false);
    set(J_ST, p.w_st, p.n_out ? U : D, nullptr, 0, SC, false);
    sched->count = J_ST + 1;
  }
  __syncthreads();
  Ring<P> ring;
  ring.base = reinterpret_cast<bf16*>(
      WIDE ? reinterpret_cast<float*>(x_hb + U * R)
           : reinterpret_cast<float*>(sched + 1));
  ring.sched = sched;
  ring.stages = stages;
  ring.steps = p.H;
  if (stages >= 2) start(ring);

  // Carries in: [B, width] in global -> [width][R] in shared.
  for (int i = tid; i < R * SC; i += NT) {
    const int r = i / SC, j = i % SC, row = row0 + r;
    x_stoch[j * R + r] =
        row < B ? W(p.stoch0)[(size_t)row * SC + j] : from_f<bf16>(0.f);
  }
  for (int i = tid; i < R * D; i += NT) {
    const int r = i / D, j = i % D, row = row0 + r;
    x_deter[j * R + r] =
        row < B ? W(p.deter0)[(size_t)row * D + j] : from_f<bf16>(0.f);
  }

  for (int t = 0; t < p.H; ++t) {
    // The step's action; the barrier also orders the carries loaded above
    // and the sample of the step before.
    const bf16* action = W(p.actions) + (size_t)t * B * A;
    for (int i = tid; i < R * Ap; i += NT) {
      const int r = i / Ap, j = i % Ap, row = row0 + r;
      x_act[j * R + r] =
          (row < B && j < A) ? action[(size_t)row * A + j] : from_f<bf16>(0.f);
    }
    __syncthreads();
    // Image cell input: [stoch, action] @ W_in, LN, ELU. From step 1 the
    // stoch is the kernel's own one-hot sample; stoch0 may be any value.
    const Src<bf16> act = {x_act, nullptr, A, W(p.w_in_a)};
    if (t == 0) {
      dense(ring, sched->prod[J_IN], x_stoch, nullptr, act, nullptr, true,
               C, s_g);
    } else {
      const Src<bf16> onehot = {nullptr, s_idx, SC, W(p.w_in_s)};
      dense_fma<bf16>(onehot, act, C, U, nullptr, true, s_g, nullptr);
    }
    ln_act_to<bf16>(s_g, U, W(p.ln_in_s), W(p.ln_in_b), true, x_ha, nullptr);
    // GRU gates: [deter, x] @ W_gru, LN; update bias -1.
    dense(ring, sched->prod[J_GRU], x_deter, x_ha, none, nullptr, true, C,
             s_g);
    ln_act_to<bf16>(s_g, 3 * D, W(p.ln_gru_s), W(p.ln_gru_b), false, nullptr,
                 s_g);
    for (int i = tid; i < D * R; i += NT) {
      const int d = i / R, r = i % R;
      const float reset = sigmoid(s_g[d * R + r]);
      const float cand = tanhf(reset * s_g[(D + d) * R + r]);
      const float update = sigmoid(s_g[(2 * D + d) * R + r] - 1.f);
      x_deter[i] =
          from_f<bf16>(update * cand + (1.f - update) * to_f(x_deter[i]));
    }
    __syncthreads();
    for (int i = tid; i < R * D; i += NT) {
      const int r = i / D, j = i % D, row = row0 + r;
      if (row < B)
        static_cast<bf16*>(p.deter_out)[((size_t)t * B + row) * D + j] =
            x_deter[j * R + r];
    }
    // Prior MLP and the raw prior logits.
    const bf16* h = x_deter;
    for (int l = 0; l < p.n_out; ++l) {
      bf16* out = (l % 2 == 0) ? x_ha : x_hb;
      dense(ring, sched->prod[J_OUT + l], h, nullptr, none, nullptr, true,
               C, s_g);
      ln_act_to<bf16>(s_g, U, W(p.ln_out_s[l]), W(p.ln_out_b[l]), true, out,
                   nullptr);
      h = out;
    }
    dense(ring, sched->prod[J_ST], h, nullptr, none, p.b_st, false, C,
             s_g);
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
          static_cast<bf16*>(p.stoch_out)[((size_t)t * B + row) * SC + s * C +
                                       c] = from_f<bf16>(v);
      }
    }
  }
  if (stages >= 2) ptx::cp_async_wait<0>();
}

// The float32 kernel: imagine_common.cuh's FMA product, every vector float
// in shared memory. The ring kernel built for float32 (its FMA path, the
// products' inputs in the element type) took 21.5 ms where this takes 12.4
// (NVIDIA H100 80GB HBM3, 700 W, proof shape), with 80 registers and
// spills in place of 64.
template <typename T, bool WIDE>
__global__ void __launch_bounds__(NT) imagine_fma_kernel(
    Params<WIDE ? MANY : MAXL> p) {
  extern __shared__ __align__(16) float smem[];
  const int D = p.D, U = p.U, A = p.A, S = p.S, C = p.C, SC = S * C;
  const int B = p.B;
  const int G = max(3 * D, SC);
  const int Ap = (A + 3) / 4 * 4;
  float* s_stoch = smem;
  float* s_deter = s_stoch + SC * R;
  float* s_act = s_deter + D * R;
  float* s_g = WIDE ? p.ws + blockIdx.x * workspace_floats(p) : s_act + Ap * R;
  float* s_ha = WIDE ? s_act + Ap * R : s_g + G * R;
  float* s_hb = s_ha + U * R;
  int* s_idx = reinterpret_cast<int*>(s_hb + U * R);  // [S][R] classes.
  const img::In none = {nullptr, nullptr, 0, nullptr};
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
    img::dense<T>({s_stoch, t > 0 ? s_idx : nullptr, SC, p.w_in_s},
                  {s_act, nullptr, A, p.w_in_a}, C, U, nullptr, true, s_ha);
    img::ln_act<T>(s_ha, U, p.ln_in_s, p.ln_in_b, true);
    // GRU gates: [deter, x] @ W_gru, LN; update bias -1.
    img::dense<T>({s_deter, nullptr, D, p.w_gru_d},
                  {s_ha, nullptr, U, p.w_gru_x}, C, 3 * D, nullptr, true,
                  s_g);
    img::ln_act<T>(s_g, 3 * D, p.ln_gru_s, p.ln_gru_b, false);
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
      img::dense<T>({h, nullptr, width, p.w_out[l]}, none, C, U, nullptr,
                    true, out);
      img::ln_act<T>(out, U, p.ln_out_s[l], p.ln_out_b[l], true);
      h = out;
      width = U;
    }
    img::dense<T>({h, nullptr, width, p.w_st}, none, C, SC, p.b_st, false,
                  s_g);
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

// A block's dynamic shared memory on sm_90a.
constexpr size_t SHARED_LIMIT = 232448;

template <bool WIDE>
int launch_fma(const Params<WIDE ? MANY : MAXL>& p, cudaStream_t stream) {
  const int SC = p.S * p.C;
  const int G = 3 * p.D > SC ? 3 * p.D : SC;
  const int Ap = (p.A + 3) / 4 * 4;
  const size_t floats = (size_t)R * (SC + p.D + Ap + (WIDE ? 0 : G) +
                                     2 * p.U + p.S);  // + s_idx.
  const size_t bytes = floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      imagine_fma_kernel<float, WIDE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (p.B + R - 1) / R;
  imagine_fma_kernel<float, WIDE><<<blocks, NT, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <bool WIDE>
int launch_ring(const Params<WIDE ? MANY : MAXL>& p, cudaStream_t stream) {
  size_t bytes = fixed_bytes(p, WIDE);
  // As many stages as fit, at most MAXSTAGES; under two the products go by
  // FMA too.
  int stages = 0;
  if (bytes < SHARED_LIMIT) {
    const size_t fit = (SHARED_LIMIT - bytes) / (TILE * sizeof(bf16));
    stages = fit >= MAXSTAGES ? MAXSTAGES : (fit >= 2 ? (int)fit : 0);
  }
  bytes += (size_t)stages * TILE * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      imagine_kernel<WIDE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (p.B + R - 1) / R;
  imagine_kernel<WIDE><<<blocks, NT, bytes, stream>>>(p, stages);
  return (int)cudaGetLastError();
}

// Reads the pointers and dims into the parameters of the path that holds
// L layers and launches it.
template <int L>
int read_and_launch(int bf16, void* const* ptrs, const int* dims,
                    float unimix, cudaStream_t stream) {
  Params<L> p = {};
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
  for (int l = 0; l < p.n_out; ++l) p.w_out[l] = ptrs[i++];
  for (int l = 0; l < p.n_out; ++l) p.ln_out_s[l] = ptrs[i++];
  for (int l = 0; l < p.n_out; ++l) p.ln_out_b[l] = ptrs[i++];
  p.ws = static_cast<float*>(ptrs[i++]);
  p.unimix = unimix;
  constexpr bool WIDE = L == MANY;
  return bf16 ? launch_ring<WIDE>(p, stream) : launch_fma<WIDE>(p, stream);
}

}  // namespace

// ptrs: stoch0, deter0, actions, g_s (or null), deter_out, logit_out,
//   stoch_out, w_in_s, w_in_a, ln_in_s, ln_in_b, w_gru_d, w_gru_x, ln_gru_s,
//   ln_gru_b, w_st, b_st, then w_out[n_out], ln_out_s[n_out],
//   ln_out_b[n_out], then the workspace (float32, workspace_floats a
//   block) for the wide path, or null for the shipped one.
// dims: H, B, A, D, U, S, C, n_out (0 to MAXL on the shipped path, to MANY
//   on the wide one).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int imagine(int bf16, void* const* ptrs, const int* dims,
                       float unimix, void* stream) {
  const int n_out = dims[7];
  const bool wide = ptrs[17 + 3 * n_out] != nullptr;
  if (n_out < 0 || n_out > (wide ? MANY : MAXL))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return wide ? read_and_launch<MANY>(bf16, ptrs, dims, unimix, s)
              : read_and_launch<MAXL>(bf16, ptrs, dims, unimix, s);
}

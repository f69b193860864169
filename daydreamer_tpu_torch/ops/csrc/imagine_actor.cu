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
// Bound. At the xarm shape (B=1024, H=15, D=U=512, S*C=1024, A=6, three
// prior layers, a four-layer actor) each row-step is 3.94 M dense
// multiply-adds plus the products with the one-hot stoch, which are sums
// of S = 32 weight rows: 122.5 GFLOP in all, 0.124 ms at 989 TFLOP/s bf16,
// against 0.056 ms for the bytes. So by the roofline the operations bound
// it. This design has a floor of its own well above that: rows are
// independent for the whole horizon, so a block owns R = 8 rows for all H
// steps, 128 blocks, and every block streams all the dense weights of a
// step, 7.9 MB in bf16, from L2 in every step: 128 x 15 x 7.9 MB = 15 GB
// through the L2, 3-4 ms at the few TB/s it delivers, about 1 ms through
// one SM's port. The tensor-core time of the same work is 0.2 ms. Sharing
// each tile among the blocks of a cluster would divide the 15 GB.
//
// Design. The block keeps its rows' carries (deter, action, and the stoch
// as its sampled classes [S][R]) and every intermediate in shared memory.
// In bfloat16 the dense products run on the tensor cores (mma.sync
// m16n8k16 with the operands swapped: the output columns are M, the 8
// rows are N) from a ring of weight tiles that cp.async fills four stages
// deep and that runs on across layers and steps; imagine_mma.cuh has the
// product, the ring and their layouts. The parent kernel read two weights
// a thread from L2 inside the k loop and multiplied in float FMAs: 18.4 ms
// (NVIDIA H100 80GB HBM3, 700 W, xarm shape, bfloat16), paced by L2
// latency; this one takes 6.5 ms there, of which the 15 GB alone are 5 ms
// at the 3 TB/s the blocks draw together. Each mma starts from zero and
// its sums are added by FADD: accumulating in the tensor cores, which
// round toward zero, left only 88.6 % of (step, row) samples equal to the
// plain version's, against 95.1 % so. float32, the products with the action (K or N = A) and any
// width that is no multiple of 16 keep that FMA product, in full
// precision; the products with the rollout's own one-hot sample stay
// gathers of S weight rows. The action logits (N = A columns) split K
// among the threads. Values are rounded to T exactly where the JAX cell
// rounds (after each product, LayerNorm and ELU), so activations lose
// nothing as bf16 operands and the kernel differs from its plain PyTorch
// version only in the order of the sums. An in-kernel Philox generator is
// later work.
//
// Every width the JAX kernel takes. The prior MLP may have no layer (the
// head then reads the deter). The shipped path (up to MAXL prior and actor
// layers, every vector in shared memory) is the instantiation it always
// was. Past MAXL layers, or where the products' float sums Y [3D][R]
// outgrow shared memory (deter past about 1 836 at a1's other widths), the
// wrapper hands over a workspace and the wide instantiation runs: its
// parameters hold MANY layers' addresses, and Y and the schedule lie in
// the block's copy of the workspace (global memory, in L2 at these
// sizes), so the ring of weight tiles keeps what shared memory is left.

#include <type_traits>

#include "imagine_mma.cuh"

namespace {

using namespace imm;

template <int L>
struct Params {
  const void *stoch0, *deter0, *action0;
  const float *g_s, *g_a;  // Gumbel noise [H,B,SC], [H,B,A]; null: argmax.
  const void *w_in_s, *w_in_a, *ln_in_s, *ln_in_b;
  const void *w_gru_d, *w_gru_x, *ln_gru_s, *ln_gru_b;
  const void *w_st, *b_st;
  const void *a_w_d, *a_w_s, *a_w_out, *a_b_out;
  void *deter_out, *stoch_out, *action_out;
  float *logit_out;
  const void *w_out[L], *ln_out_s[L], *ln_out_b[L];
  const void *a_ln_s[L], *a_ln_b[L], *a_w_h[L];
  float* ws;  // The wide path's workspace, or null.
  int B, H, D, U, S, C, A, n_out, n_act;
  float unimix, act_unimix;
};

// The wide path's layers and schedule.
constexpr int WIDE_P = products(MANY);

// Shared memory, in this order: Y [G][R] float (every product's sum), the
// action logits [Ap][R] float, the sampled classes [S][R] int, then in T
// the product inputs stoch0 [SC][R], deter [D][R], action [Ap][R] and two
// hidden vectors [U][R], the schedule, and the ring's stages. The wide
// path keeps Y and the schedule in its workspace (workspace_floats).
template <int L>
size_t fixed_bytes(const Params<L>& p, size_t item, bool wide) {
  const int SC = p.S * p.C;
  const int G = 3 * p.D > SC ? 3 * p.D : SC;
  const int Ap = (p.A + 3) / 4 * 4;
  return (size_t)R * (4 * ((wide ? 0 : G) + Ap + p.S) +
                      item * (SC + p.D + Ap + 2 * p.U)) +
         (wide ? 0 : sizeof(Schedule<products(L)>));
}

// The floats of a block's copy of the wide path's workspace: Y, then the
// schedule.
template <int L>
__host__ __device__ size_t workspace_floats(const Params<L>& p) {
  const int SC = p.S * p.C;
  const int G = 3 * p.D > SC ? 3 * p.D : SC;
  return (size_t)R * G + sizeof(Schedule<WIDE_P>) / sizeof(float);
}

// Y[n][r] = X0 @ W0 (+ X1 @ W1) (+ extra) (+ bias) for product q of the
// schedule: on the tensor cores where the schedule says so (a gather or a
// product with the action is then added by FMA), else by FMA. The buffers
// come as arguments, not through a closure: the compiler must go on
// knowing that they point into shared memory.
template <typename T, int P>
__device__ __forceinline__ void dense(Ring<P>& ring, const Product& q,
                                      const T* X0, const T* X1,
                                      const Src<T>& extra, const void* bias_,
                                      bool round, int C, float* Y) {
  const T* bias = static_cast<const T*>(bias_);
  const Src<T> none = {nullptr, nullptr, 0, nullptr};
  if constexpr (std::is_same<T, bf16>::value) {
    if (q.mma) {
      dense_mma(ring, q, X0, X1, extra.W ? nullptr : bias, round && !extra.W,
                Y);
      if (extra.W) dense_fma<T>(extra, none, C, q.N, bias, round, Y, Y);
      return;
    }
  }
  const void* w0 = q.W[0];
  const void* w1 = q.W[1];
  const Src<T> first = {X0, nullptr, q.K[0], static_cast<const T*>(w0)};
  const Src<T> second = {X1, nullptr, q.K[1], static_cast<const T*>(w1)};
  dense_fma<T>(first, X1 ? second : extra, C, q.N, bias, round, Y, nullptr);
}

// WIDE: the wide path (MANY layers, Y and the schedule in the workspace).
template <typename T, bool WIDE>
__global__ void __launch_bounds__(NT) imagine_actor_kernel(
    Params<WIDE ? MANY : MAXL> p, int stages) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool kBf16 = std::is_same<T, bf16>::value;
  constexpr int P = products(WIDE ? MANY : MAXL);
  const int D = p.D, U = p.U, A = p.A, S = p.S, C = p.C, SC = S * C;
  const int B = p.B;
  const int G = max(3 * D, SC);
  const int Ap = (A + 3) / 4 * 4;
  float* ws = WIDE ? p.ws + blockIdx.x * workspace_floats(p) : nullptr;
  float* s_g = WIDE ? ws : smem;
  float* s_alog = WIDE ? smem : s_g + G * R;
  int* s_idx = reinterpret_cast<int*>(s_alog + Ap * R);  // [S][R] classes.
  T* x_stoch = reinterpret_cast<T*>(s_idx + S * R);
  T* x_deter = x_stoch + SC * R;
  T* x_act = x_deter + D * R;
  T* x_ha = x_act + Ap * R;
  T* x_hb = x_ha + U * R;
  Schedule<P>* sched = reinterpret_cast<Schedule<P>*>(
      WIDE ? ws + G * R : reinterpret_cast<float*>(x_hb + U * R));
  const int row0 = blockIdx.x * R;
  const int tid = threadIdx.x;
  auto W = [](const void* w) { return static_cast<const T*>(w); };
  const Src<T> none = {nullptr, nullptr, 0, nullptr};

  // A step's dense products, in the order the step takes them.
  const int J_IN = 0, J_GRU = 1, J_OUT = 2, J_ST = 2 + p.n_out;
  const int J_AD = J_ST + 1, J_AH = J_AD + 1;
  if (tid == 0) {
    auto set = [&](int j, const void* w0, int k0, const void* w1, int k1,
                   int n, bool first_only) {
      Product& q = sched->prod[j];
      q.W[0] = static_cast<const bf16*>(w0);
      q.W[1] = static_cast<const bf16*>(w1);
      q.K[0] = k0;
      q.K[1] = k1;
      q.N = n;
      q.mma = kBf16 && stages >= 2 && k0 % 16 == 0 && k1 % 16 == 0 &&
              n % 16 == 0;
      q.first_only = first_only;
    };
    set(J_IN, p.w_in_s, SC, nullptr, 0, U, true);
    set(J_GRU, p.w_gru_d, D, p.w_gru_x, U, 3 * D, false);
    for (int l = 0; l < p.n_out; ++l)
      set(J_OUT + l, p.w_out[l], l == 0 ? D : U, nullptr, 0, U, false);
    set(J_ST, p.w_st, p.n_out ? U : D, nullptr, 0, SC, false);
    set(J_AD, p.a_w_d, D, nullptr, 0, U, false);
    for (int l = 0; l + 1 < p.n_act; ++l)
      set(J_AH + l, p.a_w_h[l], U, nullptr, 0, U, false);
    sched->count = J_AH + p.n_act - 1;
  }
  __syncthreads();
  Ring<P> ring;
  ring.base = reinterpret_cast<bf16*>(
      WIDE ? reinterpret_cast<float*>(x_hb + U * R)
           : reinterpret_cast<float*>(sched + 1));
  ring.sched = sched;
  ring.stages = stages;
  ring.steps = p.H;
  if (kBf16 && stages >= 2) start(ring);

  // Carries in: [B, width] in global -> [width][R] in shared.
  for (int i = tid; i < R * SC; i += NT) {
    const int r = i / SC, j = i % SC, row = row0 + r;
    x_stoch[j * R + r] =
        row < B ? W(p.stoch0)[(size_t)row * SC + j] : from_f<T>(0.f);
  }
  for (int i = tid; i < R * D; i += NT) {
    const int r = i / D, j = i % D, row = row0 + r;
    x_deter[j * R + r] =
        row < B ? W(p.deter0)[(size_t)row * D + j] : from_f<T>(0.f);
  }
  for (int i = tid; i < R * Ap; i += NT) {
    const int r = i / Ap, j = i % Ap, row = row0 + r;
    x_act[j * R + r] = (row < B && j < A)
                           ? W(p.action0)[(size_t)row * A + j]
                           : from_f<T>(0.f);
  }
  __syncthreads();

  for (int t = 0; t < p.H; ++t) {
    // Image cell input: [stoch, action] @ W_in, LN, ELU. From step 1 the
    // stoch is the kernel's own one-hot sample; stoch0 may be any value.
    const Src<T> act = {x_act, nullptr, A, W(p.w_in_a)};
    if (t == 0) {
      dense<T, P>(ring, sched->prod[J_IN], x_stoch, nullptr, act, nullptr, true,
                  C, s_g);
    } else {
      const Src<T> onehot = {nullptr, s_idx, SC, W(p.w_in_s)};
      dense_fma<T>(onehot, act, C, U, nullptr, true, s_g, nullptr);
    }
    ln_act_to<T>(s_g, U, W(p.ln_in_s), W(p.ln_in_b), true, x_ha, nullptr);
    // GRU gates: [deter, x] @ W_gru, LN; update bias -1.
    dense<T, P>(ring, sched->prod[J_GRU], x_deter, x_ha, none, nullptr, true, C,
                s_g);
    ln_act_to<T>(s_g, 3 * D, W(p.ln_gru_s), W(p.ln_gru_b), false, nullptr,
                 s_g);
    for (int i = tid; i < D * R; i += NT) {
      const int d = i / R, r = i % R;
      const float reset = sigmoid(s_g[d * R + r]);
      const float cand = tanhf(reset * s_g[(D + d) * R + r]);
      const float update = sigmoid(s_g[(2 * D + d) * R + r] - 1.f);
      x_deter[i] =
          from_f<T>(update * cand + (1.f - update) * to_f(x_deter[i]));
    }
    __syncthreads();
    for (int i = tid; i < R * D; i += NT) {
      const int r = i / D, j = i % D, row = row0 + r;
      if (row < B)
        static_cast<T*>(p.deter_out)[((size_t)t * B + row) * D + j] =
            x_deter[j * R + r];
    }
    // Prior MLP and the raw prior logits.
    const T* h = x_deter;
    for (int l = 0; l < p.n_out; ++l) {
      T* out = (l % 2 == 0) ? x_ha : x_hb;
      dense<T, P>(ring, sched->prod[J_OUT + l], h, nullptr, none, nullptr, true,
                  C, s_g);
      ln_act_to<T>(s_g, U, W(p.ln_out_s[l]), W(p.ln_out_b[l]), true, out,
                   nullptr);
      h = out;
    }
    dense<T, P>(ring, sched->prod[J_ST], h, nullptr, none, p.b_st, false, C,
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
    // Actor MLP over [deter, stoch], then the action logits.
    const Src<T> sampled = {nullptr, s_idx, SC, W(p.a_w_s)};
    dense<T, P>(ring, sched->prod[J_AD], x_deter, nullptr, sampled, nullptr,
                true, C, s_g);
    ln_act_to<T>(s_g, U, W(p.a_ln_s[0]), W(p.a_ln_b[0]), true, x_ha, nullptr);
    h = x_ha;
    for (int l = 1; l < p.n_act; ++l) {
      T* out = (l % 2 == 1) ? x_hb : x_ha;
      dense<T, P>(ring, sched->prod[J_AH + l - 1], h, nullptr, none, nullptr,
                  true, C, s_g);
      ln_act_to<T>(s_g, U, W(p.a_ln_s[l]), W(p.a_ln_b[l]), true, out,
                   nullptr);
      h = out;
    }
    // Y is free now: scratch for the K slices of the A action logits.
    const int slices = min(NT, G) / max(A, 1);
    if (slices >= 2) {
      dense_narrow<T>(h, U, W(p.a_w_out), A, W(p.a_b_out), slices, s_g,
                      s_alog);
    } else {
      const Src<T> last = {h, nullptr, U, W(p.a_w_out)};
      dense_fma<T>(last, none, C, A, W(p.a_b_out), false, s_alog, nullptr);
    }
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
        x_act[a * R + r] = from_f<T>(v);
        if (row < B)
          static_cast<T*>(p.action_out)[((size_t)t * B + row) * A + a] =
              from_f<T>(v);
      }
    }
    __syncthreads();
  }
  if (kBf16 && stages >= 2) ptx::cp_async_wait<0>();
}

// A block's dynamic shared memory on sm_90a.
constexpr size_t SHARED_LIMIT = 232448;

template <typename T, bool WIDE>
int launch(const Params<WIDE ? MANY : MAXL>& p, cudaStream_t stream) {
  size_t bytes = fixed_bytes(p, sizeof(T), WIDE);
  // As many stages as fit, at most MAXSTAGES; under two the bfloat16
  // products go by FMA too.
  int stages = 0;
  if (std::is_same<T, bf16>::value && bytes < SHARED_LIMIT) {
    const size_t fit = (SHARED_LIMIT - bytes) / (TILE * sizeof(bf16));
    stages = fit >= MAXSTAGES ? MAXSTAGES : (fit >= 2 ? (int)fit : 0);
  }
  bytes += (size_t)stages * TILE * sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      imagine_actor_kernel<T, WIDE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (p.B + R - 1) / R;
  imagine_actor_kernel<T, WIDE><<<blocks, NT, bytes, stream>>>(p, stages);
  return (int)cudaGetLastError();
}

// Reads the pointers and dims into the parameters of the path that holds
// L layers and launches it.
template <int L>
int read_and_launch(int bf16, void* const* ptrs, const int* dims,
                    float unimix, float act_unimix, cudaStream_t stream) {
  Params<L> p = {};
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
  p.ws = static_cast<float*>(ptrs[i++]);
  p.unimix = unimix;
  p.act_unimix = act_unimix;
  constexpr bool WIDE = L == MANY;
  return bf16 ? launch<__nv_bfloat16, WIDE>(p, stream)
              : launch<float, WIDE>(p, stream);
}

}  // namespace

// ptrs: stoch0, deter0, action0, g_s, g_a, w_in_s, w_in_a, ln_in_s,
//   ln_in_b, w_gru_d, w_gru_x, ln_gru_s, ln_gru_b, w_st, b_st, a_w_d, a_w_s,
//   a_w_out, a_b_out, deter_out, logit_out, stoch_out, action_out, then
//   (w_out, ln_out_s, ln_out_b) per prior layer, (a_ln_s, a_ln_b) per actor
//   layer, a_w_h per hidden actor layer, then the workspace (float32,
//   workspace_floats a block) for the wide path, or null for the shipped
//   one.
// dims: B, H, D, U, S, C, A, n_out (0 to MAXL on the shipped path, to MANY
//   on the wide one), n_act (1 to MAXL, or to MANY).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int imagine_actor(int bf16, void* const* ptrs, const int* dims,
                             float unimix, float act_unimix, void* stream) {
  const int n_out = dims[7], n_act = dims[8];
  const bool wide = ptrs[22 + 3 * n_out + 3 * n_act] != nullptr;
  const int most = wide ? MANY : MAXL;
  if (n_out < 0 || n_out > most || n_act < 1 || n_act > most)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return wide ? read_and_launch<MANY>(bf16, ptrs, dims, unimix, act_unimix, s)
              : read_and_launch<MAXL>(bf16, ptrs, dims, unimix, act_unimix,
                                      s);
}

// The RSSM's categorical stats head after its product, with its
// straight-through sample, forward and backward, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: it stands for the loop fusion that XLA makes
// of what follows the `img_stats` / `obs_stats` product in the JAX
// package's scan step: `RSSM._unimix_logit` (daydreamer_tpu/models/
// nets.py:289-298), `get_dist`'s `OneHotDist` (log_softmax) and its
// `sample` (daydreamer_tpu/nn/dists.py:39-47), or `mode` for `get_stoch`.
// For each group of C classes of a row, from the raw logits x (T, bfloat16
// or float32):
//   logit = unimix ? round_T(log(keep * softmax(x) + floor)) : x
//     (keep = 1 - unimix and floor = unimix / C, float32, each product and
//     sum rounded on its own, as the eager ops do),
//   lp = log_softmax(logit)                                  (float32),
//   sample: idx = argmax(lp - log(-log(max(u, tiny)))), u the caller's
//     uniform draws; stoch = round_T((onehot(idx) + exp(lp)) - exp(lp)),
//   mode: idx = argmax(lp), stoch = onehot(idx),
// the first index among equal values, a NaN above any number. Eagerly that
// is about 22 kernels a call; here one, reading x (and u) and writing
// logit and stoch.
// Backward, from the gradients of logit and stoch, as autograd of the
// eager chain rounds it: g = dlogit, and with the sample
//   g = round_T(round_T(dstoch * p - p * sum(dstoch * p)) + g), p = exp(lp)
// (the straight-through path: exp, then log_softmax's backward, then the
// cast); with unimix then, in float32 from the recomputed softmax p1 and
// mixture p2,
//   g1 = (g / p2) * keep, dx = round_T(p1 * (g1 - sum(g1 * p1))).
//
// Bound by bytes: 8-10 bytes a bfloat16 value each way against some 30
// operations. Design: one lane a class, a group of C lanes (C a power of
// two up to 32, the group aligned in its warp) a group of the row, so
// every reduction is C / 2 .. 1 shuffles within the warp and nothing goes
// through shared memory; thread t takes the flat element t, so each warp
// reads and writes 32 consecutive values. Every lane of a warp runs the
// shuffles, past the last element too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
constexpr float TINY = 1.17549435e-38f;  // torch.finfo(torch.float32).tiny

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void narrow(float x, float* out) { *out = x; }
__device__ __forceinline__ void narrow(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16(x);
}
template <class T>
__device__ __forceinline__ float rounded(float x) {
  T t;
  narrow(x, &t);
  return widen(t);
}

struct Head {
  long n;           // Elements: rows x S x C.
  int C;            // Classes: lanes of a group.
  int unimix;       // Whether the logit is the mixture's log.
  int sample;       // Whether stoch is a sample (else the mode).
  float keep, floor_;  // 1 - unimix and unimix / C, in float32.
};

__device__ __forceinline__ float group_max(float v, int C) {
  for (int o = C / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float group_sum(float v, int C) {
  for (int o = C / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Whether (a, ia) comes first in torch.argmax's order: a NaN above any
// number, then the larger value, then the smaller index.
__device__ __forceinline__ bool first(float a, int ia, float b, int ib) {
  const bool na = a != a, nb = b != b;
  if (na != nb) return na;
  if (!na && a != b) return a > b;
  return ia < ib;
}

// The index of the group's first largest value.
__device__ __forceinline__ int group_argmax(float v, int k, int C) {
  for (int o = C / 2; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(FULL, v, o);
    const int j = __shfl_xor_sync(FULL, k, o);
    if (first(w, j, v, k)) {
      v = w;
      k = j;
    }
  }
  return k;
}

// softmax(x) mixed with the uniform floor: (p1, p2).
__device__ __forceinline__ void mixture(float x, const Head& h, float* p1,
                                        float* p2) {
  const float e = expf(x - group_max(x, h.C));
  *p1 = e / group_sum(e, h.C);
  *p2 = __fadd_rn(__fmul_rn(*p1, h.keep), h.floor_);
}

// log_softmax of the group's logits.
__device__ __forceinline__ float log_softmax(float l, int C) {
  const float z = l - group_max(l, C);
  return z - logf(group_sum(expf(z), C));
}

template <class T>
__global__ void __launch_bounds__(256)
    onehot_fwd_kernel(const T* __restrict__ x, const float* __restrict__ u,
                      T* __restrict__ logit, T* __restrict__ stoch, Head h) {
  const long t = (long)blockIdx.x * THREADS + threadIdx.x;
  const bool valid = t < h.n;
  const int k = (int)(threadIdx.x % h.C);
  float l = valid ? widen(x[t]) : 0.f;
  if (h.unimix) {
    float p1, p2;
    mixture(l, h, &p1, &p2);
    l = rounded<T>(logf(p2));
  }
  const float lp = log_softmax(l, h.C);
  float v = lp;
  if (h.sample) v = lp + -logf(-logf(fmaxf(valid ? u[t] : 0.5f, TINY)));
  const float one = k == group_argmax(v, k, h.C) ? 1.f : 0.f;
  float st = one;
  if (h.sample) {
    const float p = expf(lp);
    st = __fsub_rn(__fadd_rn(one, p), p);
  }
  if (valid) {
    narrow(l, &logit[t]);
    narrow(st, &stoch[t]);
  }
}

template <class T>
__global__ void __launch_bounds__(256)
    onehot_bwd_kernel(const T* __restrict__ x, const T* __restrict__ logit,
                      const T* __restrict__ dlogit,
                      const T* __restrict__ dstoch, T* __restrict__ dx,
                      Head h) {
  const long t = (long)blockIdx.x * THREADS + threadIdx.x;
  const bool valid = t < h.n;
  float g = valid ? widen(dlogit[t]) : 0.f;
  if (h.sample) {
    const float p = expf(log_softmax(valid ? widen(logit[t]) : 0.f, h.C));
    const float gl = (valid ? widen(dstoch[t]) : 0.f) * p;
    g = rounded<T>(rounded<T>(gl - p * group_sum(gl, h.C)) + g);
  }
  if (h.unimix) {
    float p1, p2;
    mixture(valid ? widen(x[t]) : 0.f, h, &p1, &p2);
    const float g1 = __fmul_rn(g / p2, h.keep);
    g = p1 * (g1 - group_sum(g1 * p1, h.C));
  }
  if (valid) narrow(g, &dx[t]);
}

template <class T>
cudaError_t run(bool backward, void* const* p, Head h, cudaStream_t stream) {
  const int grid = (int)((h.n + THREADS - 1) / THREADS);
  if (backward) {
    auto kernel = onehot_bwd_kernel<T>;
    kernel<<<grid, THREADS, 0, stream>>>(static_cast<const T*>(p[0]), static_cast<const T*>(p[1]), static_cast<const T*>(p[2]), static_cast<const T*>(p[3]), static_cast<T*>(p[4]), h);
  } else {
    auto kernel = onehot_fwd_kernel<T>;
    kernel<<<grid, THREADS, 0, stream>>>(static_cast<const T*>(p[0]), static_cast<const float*>(p[1]), static_cast<T*>(p[2]), static_cast<T*>(p[3]), h);
  }
  return cudaGetLastError();
}

// dims: elements, classes, unimix (0 or 1), sample (0 or 1); scalars: keep,
// floor. Classes a power of two from 2 to 32.
cudaError_t launch(int bf16, bool backward, void* const* ptrs,
                   const int* dims, float keep, float floor_,
                   cudaStream_t stream) {
  Head h;
  h.n = dims[0];
  h.C = dims[1];
  h.unimix = dims[2];
  h.sample = dims[3];
  h.keep = keep;
  h.floor_ = floor_;
  if (h.n <= 0 || h.C < 2 || h.C > 32 || (h.C & (h.C - 1)) || h.n % h.C)
    return cudaErrorInvalidValue;
  return bf16 ? run<__nv_bfloat16>(backward, ptrs, h, stream)
              : run<float>(backward, ptrs, h, stream);
}

}  // namespace

// ptrs: x, u (float32; unread without the sample), logit, stoch, each of
// rows x S x C values.
extern "C" int onehot_head_fwd(int bf16, void* const* ptrs, const int* dims,
                               float keep, float floor_, void* stream) {
  return launch(bf16, false, ptrs, dims, keep, floor_,
                static_cast<cudaStream_t>(stream));
}

// ptrs: x, logit, dlogit, dstoch (unread without the sample), dx.
extern "C" int onehot_head_bwd(int bf16, void* const* ptrs, const int* dims,
                               float keep, float floor_, void* stream) {
  return launch(bf16, true, ptrs, dims, keep, floor_,
                static_cast<cudaStream_t>(stream));
}

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
// operations, if every group quantity is made once.
// Both kernels share one layout: a lane holds K consecutive classes (the
// caller's 2, 4 or 8: 8 where the values fill the card, 16 bytes of
// bfloat16 values a load; 2 where few values leave it idle and a lane's
// chain of work is the call's latency). A group of C classes spans C / K
// lanes (4 at C = 32, K = 8, aligned in the warp) or, where C < K, a lane
// holds K / C whole groups. Each group quantity is taken over the lane's
// values in registers, in class order, then over the group's lanes in
// log2(C / K) shuffles, and made once a lane, while the per-value
// arithmetic and its rounding stay those of the plain version (expf, logf,
// the divides, `__f*_rn` where it rounds). Loads and stores are vectors of
// up to 16 bytes; the grid is bounded and walks the lanes by its stride.
// Forward: the group's max, sum and first arg max (the log of the sum once
// a lane).
// Backward: with the sample, the logit's max, the sum of exp and its log,
// and sum(dstoch * p); with the mixture, raw's max and sum of exp and
// sum(g1 * p1): at C = 32 and K = 8 twelve shuffles for a lane's eight
// values, where a lane a class took about thirty for its one.
// Classes that are no power of two from 2 to 32 take a general path:
// onehot_group_fwd_kernel and onehot_group_bwd_kernel (a lane L
// consecutive classes in registers, a group of lanes a group, read once),
// or past 8 classes a lane on a warp onehot_any_fwd_kernel and
// onehot_any_bwd_kernel (a group of up to a warp's lanes a group of
// classes, walking them in passes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>

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

template <class T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

struct Head {
  long n;           // Elements: rows x S x C.
  int C;            // Classes of a group.
  int unimix;       // Whether the logit is the mixture's log.
  int sample;       // Whether stoch is a sample (else the mode).
  float keep, floor_;  // 1 - unimix and unimix / C, in float32.
};

// Whether (a, ia) comes first in torch.argmax's order: a NaN above any
// number, then the larger value, then the smaller index.
__device__ __forceinline__ bool first(float a, int ia, float b, int ib) {
  const bool na = a != a, nb = b != b;
  if (na != nb) return na;
  if (!na && a != b) return a > b;
  return ia < ib;
}

// The K values of T at p as floats: vectors of up to 16 bytes where all K
// lie below the end (`left` values from p on), else one at a time with
// `missing` past it.
template <int K, class T>
__device__ __forceinline__ void load_k(const T* __restrict__ p, long left,
                                       float missing, float (&out)[K]) {
  constexpr int W = K < 16 / sizeof(T) ? K : 16 / sizeof(T);
  if (left >= K) {
#pragma unroll
    for (int b = 0; b < K / W; ++b) {
      const Pack<T, W> q = reinterpret_cast<const Pack<T, W>*>(p)[b];
#pragma unroll
      for (int w = 0; w < W; ++w) out[b * W + w] = widen(q.v[w]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) out[k] = k < left ? widen(p[k]) : missing;
  }
}

// The K values rounded to T at p, as load_k reads them.
template <int K, class T>
__device__ __forceinline__ void store_k(T* __restrict__ p, long left,
                                        const float (&in)[K]) {
  constexpr int W = K < 16 / sizeof(T) ? K : 16 / sizeof(T);
  if (left >= K) {
#pragma unroll
    for (int b = 0; b < K / W; ++b) {
      Pack<T, W> q;
#pragma unroll
      for (int w = 0; w < W; ++w) narrow(in[b * W + w], &q.v[w]);
      reinterpret_cast<Pack<T, W>*>(p)[b] = q;
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (k < left) narrow(in[k], &p[k]);
  }
}

// Over the G lanes of a group (a power of two, aligned in the warp).
template <int G>
__device__ __forceinline__ float lanes_max(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
template <int G>
__device__ __forceinline__ float lanes_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}
template <int G>
__device__ __forceinline__ int lanes_argmax(float v, int k) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(FULL, v, o);
    const int j = __shfl_xor_sync(FULL, k, o);
    if (first(w, j, v, k)) {
      v = w;
      k = j;
    }
  }
  return k;
}

// The group's max over a lane's L values from `in`, then its G lanes.
template <int L, int G>
__device__ __forceinline__ float segment_max(const float* in) {
  float m = in[0];
#pragma unroll
  for (int k = 1; k < L; ++k) m = fmaxf(m, in[k]);
  return lanes_max<G>(m);
}

template <class T, int C, int K>
__global__ void __launch_bounds__(256)
    onehot_fwd_kernel(const T* __restrict__ x, const float* __restrict__ u,
                      T* __restrict__ logit, T* __restrict__ stoch, Head h) {
  constexpr int L = C < K ? C : K;  // A lane's classes of one group.
  constexpr int G = C / L;          // Lanes of a group.
  const long steps = ((h.n + K - 1) / K + THREADS - 1) / THREADS;
  // Every thread of the block runs the same steps: the lanes of a group
  // shuffle together.
  for (long st = blockIdx.x; st < steps; st += gridDim.x) {
    const long base = (st * THREADS + threadIdx.x) * K;
    const long left = h.n - base;
    // The class of the lane's first value in its group.
    const int at = (int)(base % C);
    float l[K], v[K];
    load_k<K>(x + base, left, 0.f, l);
    if (h.sample) {
      load_k<K>(u + base, left, 0.5f, v);
#pragma unroll
      for (int k = 0; k < K; ++k)
        v[k] = -logf(-logf(fmaxf(v[k], TINY)));
    }
#pragma unroll
    for (int g = 0; g < K; g += L) {
      float* lg = l + g;
      if (h.unimix) {
        // softmax(x) mixed with the uniform floor, its log rounded to T.
        const float m = segment_max<L, G>(lg);
        float e[L], sum = 0.f;
#pragma unroll
        for (int k = 0; k < L; ++k) {
          e[k] = expf(lg[k] - m);
          sum += e[k];
        }
        sum = lanes_sum<G>(sum);
#pragma unroll
        for (int k = 0; k < L; ++k) {
          const float p2 = __fadd_rn(__fmul_rn(e[k] / sum, h.keep), h.floor_);
          lg[k] = rounded<T>(logf(p2));
        }
      }
      // log_softmax of the logits, and the first arg max of it plus the
      // noise (the sample) or of it alone (the mode).
      const float m = segment_max<L, G>(lg);
      float z[L], sum = 0.f;
#pragma unroll
      for (int k = 0; k < L; ++k) {
        z[k] = lg[k] - m;
        sum += expf(z[k]);
      }
      const float lse = logf(lanes_sum<G>(sum));
      float best = 0.f;
      int win = 0;
#pragma unroll
      for (int k = 0; k < L; ++k) {
        const float lp = z[k] - lse;
        const float val = h.sample ? lp + v[g + k] : lp;
        if (k == 0 || first(val, at + k, best, win)) {
          best = val;
          win = at + k;
        }
        z[k] = lp;
      }
      win = lanes_argmax<G>(best, win);
#pragma unroll
      for (int k = 0; k < L; ++k) {
        const float one = at + k == win ? 1.f : 0.f;
        if (h.sample) {
          const float p = expf(z[k]);
          v[g + k] = __fsub_rn(__fadd_rn(one, p), p);
        } else {
          v[g + k] = one;
        }
      }
    }
    if (left > 0) {
      store_k<K>(logit + base, left, l);
      store_k<K>(stoch + base, left, v);
    }
  }
}

template <class T, int C, int K>
__global__ void __launch_bounds__(256)
    onehot_bwd_kernel(const T* __restrict__ x, const T* __restrict__ logit,
                      const T* __restrict__ dlogit,
                      const T* __restrict__ dstoch, T* __restrict__ dx,
                      Head h) {
  constexpr int L = C < K ? C : K;  // A lane's classes of one group.
  constexpr int G = C / L;          // Lanes of a group.
  const long steps = ((h.n + K - 1) / K + THREADS - 1) / THREADS;
  // Every thread of the block runs the same steps: the lanes of a group
  // shuffle together.
  for (long st = blockIdx.x; st < steps; st += gridDim.x) {
    const long base = (st * THREADS + threadIdx.x) * K;
    const long left = h.n - base;
    // All of the lane's loads in flight before its first sum.
    float g[K], l[K], ds[K], r[K];
    load_k<K>(dlogit + base, left, 0.f, g);
    if (h.sample) {
      load_k<K>(logit + base, left, 0.f, l);
      load_k<K>(dstoch + base, left, 0.f, ds);
    }
    if (h.unimix) load_k<K>(x + base, left, 0.f, r);
#pragma unroll
    for (int s = 0; s < K; s += L) {
      if (h.sample) {
        // The straight-through path: p = exp(log_softmax(logit)), then
        // log_softmax's backward and the cast.
        const float m = segment_max<L, G>(l + s);
        float z[L], sum = 0.f;
#pragma unroll
        for (int k = 0; k < L; ++k) {
          z[k] = l[s + k] - m;
          sum += expf(z[k]);
        }
        const float lse = logf(lanes_sum<G>(sum));
        float p[L], gl[L], dot = 0.f;
#pragma unroll
        for (int k = 0; k < L; ++k) {
          p[k] = expf(z[k] - lse);
          gl[k] = ds[s + k] * p[k];
          dot += gl[k];
        }
        dot = lanes_sum<G>(dot);
#pragma unroll
        for (int k = 0; k < L; ++k)
          g[s + k] = rounded<T>(rounded<T>(gl[k] - p[k] * dot) + g[s + k]);
      }
      if (h.unimix) {
        // softmax(x) mixed with the uniform floor (p1, p2), then the log's,
        // the mixture's and the softmax's backward.
        const float m = segment_max<L, G>(r + s);
        float e[L], sum = 0.f;
#pragma unroll
        for (int k = 0; k < L; ++k) {
          e[k] = expf(r[s + k] - m);
          sum += e[k];
        }
        sum = lanes_sum<G>(sum);
        float g1[L], dot = 0.f;
#pragma unroll
        for (int k = 0; k < L; ++k) {
          e[k] = e[k] / sum;  // p1.
          const float p2 = __fadd_rn(__fmul_rn(e[k], h.keep), h.floor_);
          g1[k] = __fmul_rn(g[s + k] / p2, h.keep);
          dot += g1[k] * e[k];
        }
        dot = lanes_sum<G>(dot);
#pragma unroll
        for (int k = 0; k < L; ++k) g[s + k] = e[k] * (g1[k] - dot);
      }
    }
    if (left > 0) store_k<K>(dx + base, left, g);
  }
}

// Groups past 8 classes a lane on a warp's lanes (more than 256 classes
// at L = 8; the group kernels below take the other counts): a group of G
// lanes takes a group of C classes, G = C rounded up to a power of two
// and at most a warp, a lane its classes sub, sub + G, ... in class
// order. Each
// group quantity is a pass over the lane's classes, then over the group's
// lanes in log2(G) shuffles, and the passes re-read the group (from L1),
// so that any C runs; the per-value arithmetic and its rounding are the
// kernels' above. Forward passes: with the mixture raw's max and sum of
// exp; the logit (written, and read back by the same lane), its max; its
// sum of exp; the first arg max; stoch. Written to be right first.

template <class T, int G>
__global__ void __launch_bounds__(256)
    onehot_any_fwd_kernel(const T* __restrict__ x, const float* __restrict__ u,
                          T* __restrict__ logit, T* __restrict__ stoch,
                          Head h) {
  const int C = h.C, sub = threadIdx.x % G, per = THREADS / G;
  const long groups = h.n / C;
  const long steps = (groups + per - 1) / per;
  // Every thread of the block runs the same steps: the lanes of a group
  // shuffle together.
  for (long st = blockIdx.x; st < steps; st += gridDim.x) {
    const long grp = st * per + threadIdx.x / G;
    // A lane past the last group takes no class, and adds nothing.
    const int end = grp < groups ? C : 0;
    const long base = grp * C;
    float m1 = 0.f, s1 = 1.f;
    if (h.unimix) {
      m1 = -INFINITY;
      for (int c = sub; c < end; c += G) m1 = fmaxf(m1, widen(x[base + c]));
      m1 = lanes_max<G>(m1);
      s1 = 0.f;
      for (int c = sub; c < end; c += G) s1 += expf(widen(x[base + c]) - m1);
      s1 = lanes_sum<G>(s1);
    }
    // The logit: softmax(x) mixed with the uniform floor, its log rounded
    // to T; or x itself.
    float m2 = -INFINITY;
    for (int c = sub; c < end; c += G) {
      float l = widen(x[base + c]);
      if (h.unimix) {
        const float p2 =
            __fadd_rn(__fmul_rn(expf(l - m1) / s1, h.keep), h.floor_);
        l = rounded<T>(logf(p2));
      }
      narrow(l, &logit[base + c]);
      m2 = fmaxf(m2, l);
    }
    m2 = lanes_max<G>(m2);
    float s2 = 0.f;
    for (int c = sub; c < end; c += G) s2 += expf(widen(logit[base + c]) - m2);
    const float lse = logf(lanes_sum<G>(s2));
    // The first arg max of log_softmax(logit), plus the noise for the
    // sample.
    float best = -INFINITY;
    int win = 0x7fffffff;
    for (int c = sub; c < end; c += G) {
      float val = (widen(logit[base + c]) - m2) - lse;
      if (h.sample) val += -logf(-logf(fmaxf(u[base + c], TINY)));
      if (first(val, c, best, win)) {
        best = val;
        win = c;
      }
    }
    win = lanes_argmax<G>(best, win);
    for (int c = sub; c < end; c += G) {
      const float one = c == win ? 1.f : 0.f;
      float out = one;
      if (h.sample) {
        const float p = expf((widen(logit[base + c]) - m2) - lse);
        out = __fsub_rn(__fadd_rn(one, p), p);
      }
      narrow(out, &stoch[base + c]);
    }
  }
}

// The backward's passes: with the sample the logit's max, its sum of exp
// and sum(dstoch * p); with the mixture raw's max, its sum of exp and
// sum(g1 * p1); then dx. The gradient g at the logit is recomputed where
// a pass needs it.
template <class T, int G>
__global__ void __launch_bounds__(256)
    onehot_any_bwd_kernel(const T* __restrict__ x, const T* __restrict__ logit,
                          const T* __restrict__ dlogit,
                          const T* __restrict__ dstoch, T* __restrict__ dx,
                          Head h) {
  const int C = h.C, sub = threadIdx.x % G, per = THREADS / G;
  const long groups = h.n / C;
  const long steps = (groups + per - 1) / per;
  for (long st = blockIdx.x; st < steps; st += gridDim.x) {
    const long grp = st * per + threadIdx.x / G;
    const int end = grp < groups ? C : 0;
    const long base = grp * C;
    float ml = 0.f, lse = 0.f, dot = 0.f;
    if (h.sample) {
      ml = -INFINITY;
      for (int c = sub; c < end; c += G)
        ml = fmaxf(ml, widen(logit[base + c]));
      ml = lanes_max<G>(ml);
      float sum = 0.f;
      for (int c = sub; c < end; c += G)
        sum += expf(widen(logit[base + c]) - ml);
      lse = logf(lanes_sum<G>(sum));
      for (int c = sub; c < end; c += G)
        dot += widen(dstoch[base + c]) *
               expf((widen(logit[base + c]) - ml) - lse);
      dot = lanes_sum<G>(dot);
    }
    // The gradient at the logit: the straight-through path's (exp, then
    // log_softmax's backward and the cast) added to dlogit.
    auto grad = [&](int c) {
      float g = widen(dlogit[base + c]);
      if (h.sample) {
        const float p = expf((widen(logit[base + c]) - ml) - lse);
        const float gl = widen(dstoch[base + c]) * p;
        g = rounded<T>(rounded<T>(gl - p * dot) + g);
      }
      return g;
    };
    if (!h.unimix) {
      for (int c = sub; c < end; c += G) narrow(grad(c), &dx[base + c]);
      continue;
    }
    // softmax(x) mixed with the uniform floor (p1, p2), then the log's,
    // the mixture's and the softmax's backward.
    float mr = -INFINITY;
    for (int c = sub; c < end; c += G) mr = fmaxf(mr, widen(x[base + c]));
    mr = lanes_max<G>(mr);
    float sr = 0.f;
    for (int c = sub; c < end; c += G) sr += expf(widen(x[base + c]) - mr);
    sr = lanes_sum<G>(sr);
    auto g1 = [&](int c, float p1) {
      const float p2 = __fadd_rn(__fmul_rn(p1, h.keep), h.floor_);
      return __fmul_rn(grad(c) / p2, h.keep);
    };
    float dot2 = 0.f;
    for (int c = sub; c < end; c += G) {
      const float p1 = expf(widen(x[base + c]) - mr) / sr;
      dot2 += g1(c, p1) * p1;
    }
    dot2 = lanes_sum<G>(dot2);
    for (int c = sub; c < end; c += G) {
      const float p1 = expf(widen(x[base + c]) - mr) / sr;
      narrow(p1 * (g1(c, p1) - dot2), &dx[base + c]);
    }
  }
}

// The general backward, redesigned: a lane holds L consecutive classes
// of a group (the caller's 1, 2, 4 or 8: the widest vector of up to 16
// bytes that C is a multiple of, doubled until a warp's lanes hold the
// group), a group G lanes (C / L rounded up to a power of two, at most a
// warp), so that every value of x, logit, dlogit and dstoch is read from
// memory once, in vectors of K values (the widest of up to L values and 16
// bytes that C is a multiple of, so that each group's vectors are
// aligned), and dx written once. Each exp is made once a value and kept;
// each group quantity (the logit's max, sum of exp and its log,
// sum(dstoch * p); raw's max, sum of exp and sum(g1 * p1)) over the lane's
// classes in class order, then over the group's lanes by log2(G) xor
// shuffles, so that every lane of the group gets the same bits in any
// launch. The per-value arithmetic and its rounding are the kernels'
// above. A lane past the group's classes, or of a group past the last,
// adds nothing and writes nothing.

// A lane's L values of T as loaded, packed in 32-bit words (two bfloat16
// a word), widened where they are used, so that its four inputs stay
// in registers at half the room in bfloat16.
template <class T, int L>
struct Packed {
  uint32_t w[(L * (int)sizeof(T) + 3) / 4];
  __device__ __forceinline__ float at(int k) const {
    uint32_t bits;
    if constexpr (sizeof(T) == 2)
      bits = k & 1 ? w[k / 2] & 0xffff0000u : w[k / 2] << 16;
    else
      bits = w[k];
    float v;
    memcpy(&v, &bits, 4);
    return v;
  }
};

// The lane's `count` values (a multiple of W, at most L) from p, W at a
// time; 0 past them.
template <int W, int L, class T>
__device__ __forceinline__ void load_by(const T* __restrict__ p, int count,
                                        Packed<T, L>& out) {
#pragma unroll
  for (int b = 0; b < L / W; ++b) {
    Pack<T, W> q;
    if (b * W < count)
      q = reinterpret_cast<const Pack<T, W>*>(p)[b];
    else
      memset(&q, 0, sizeof(q));
    memcpy(reinterpret_cast<char*>(out.w) + b * sizeof(q), &q, sizeof(q));
  }
}

// The lane's `count` values rounded to T at p, as load_by reads them.
template <int W, int L, class T>
__device__ __forceinline__ void store_by(T* __restrict__ p, int count,
                                         const float (&in)[L]) {
#pragma unroll
  for (int b = 0; b < L / W; ++b) {
    if (b * W < count) {
      Pack<T, W> q;
#pragma unroll
      for (int w = 0; w < W; ++w) narrow(in[b * W + w], &q.v[w]);
      reinterpret_cast<Pack<T, W>*>(p)[b] = q;
    }
  }
}

// load_by and store_by at the vector of K values (1, 2, 4 or 8, at most L
// and 16 bytes).
template <int L, class T>
__device__ __forceinline__ void load_classes(const T* __restrict__ p,
                                             int count, int K,
                                             Packed<T, L>& out) {
  if constexpr (L >= 8 && sizeof(T) == 2)
    if (K == 8) return load_by<8>(p, count, out);
  if constexpr (L >= 4)
    if (K == 4) return load_by<4>(p, count, out);
  if constexpr (L >= 2)
    if (K == 2) return load_by<2>(p, count, out);
  load_by<1>(p, count, out);
}
template <int L, class T>
__device__ __forceinline__ void store_classes(T* __restrict__ p, int count,
                                              int K, const float (&in)[L]) {
  if constexpr (L >= 8 && sizeof(T) == 2)
    if (K == 8) return store_by<8>(p, count, in);
  if constexpr (L >= 4)
    if (K == 4) return store_by<4>(p, count, in);
  if constexpr (L >= 2)
    if (K == 2) return store_by<2>(p, count, in);
  store_by<1>(p, count, in);
}

// Over the G lanes of a group (G a power of two of at most 32, the group
// aligned in its warp; every lane of the warp calls them).
__device__ __forceinline__ float group_max(float v, int G) {
  for (int o = G / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ float group_sum(float v, int G) {
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}
// The first arg max (v, k) over the G lanes, in torch.argmax's order
// (`first`): every lane of the group gets the same class.
__device__ __forceinline__ int group_argmax(float v, int k, int G) {
  for (int o = G / 2; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(FULL, v, o);
    const int j = __shfl_xor_sync(FULL, k, o);
    if (first(w, j, v, k)) {
      v = w;
      k = j;
    }
  }
  return k;
}

template <class T, int L>
__global__ void __launch_bounds__(256)
    onehot_group_bwd_kernel(const T* __restrict__ x,
                            const T* __restrict__ logit,
                            const T* __restrict__ dlogit,
                            const T* __restrict__ dstoch,
                            T* __restrict__ dx, Head h, int G, int K) {
  const int C = h.C, sub = threadIdx.x % G, per = THREADS / G;
  const long groups = h.n / C;
  const long steps = (groups + per - 1) / per;
  const int lo = sub * L;
  // Every thread of the block runs the same steps: the lanes of a group
  // shuffle together.
  for (long st = blockIdx.x; st < steps; st += gridDim.x) {
    const long grp = st * per + threadIdx.x / G;
    const int count = grp < groups ? max(0, min(L, C - lo)) : 0;
    const long at = grp * C + lo;
    // All of the lane's loads in flight before its first sum.
    Packed<T, L> gr, lr, dr, xr;
    load_classes<L>(dlogit + at, count, K, gr);
    if (h.sample) {
      load_classes<L>(logit + at, count, K, lr);
      load_classes<L>(dstoch + at, count, K, dr);
    }
    if (h.unimix) load_classes<L>(x + at, count, K, xr);
    float g[L];
#pragma unroll
    for (int k = 0; k < L; ++k) g[k] = gr.at(k);
    if (h.sample) {
      // The straight-through path: p = exp(log_softmax(logit)), then
      // log_softmax's backward and the cast.
      float m = -INFINITY;
#pragma unroll
      for (int k = 0; k < L; ++k)
        if (k < count) m = fmaxf(m, lr.at(k));
      m = group_max(m, G);
      float sum = 0.f;
#pragma unroll
      for (int k = 0; k < L; ++k)
        if (k < count) sum += expf(lr.at(k) - m);
      const float lse = logf(group_sum(sum, G));
      float p[L], dot = 0.f;
#pragma unroll
      for (int k = 0; k < L; ++k) {
        p[k] = expf((lr.at(k) - m) - lse);
        if (k < count) dot += dr.at(k) * p[k];
      }
      dot = group_sum(dot, G);
#pragma unroll
      for (int k = 0; k < L; ++k) {
        const float gl = dr.at(k) * p[k];
        g[k] = rounded<T>(rounded<T>(gl - p[k] * dot) + g[k]);
      }
    }
    if (h.unimix) {
      // softmax(x) mixed with the uniform floor (p1, p2), then the log's,
      // the mixture's and the softmax's backward.
      float m = -INFINITY;
#pragma unroll
      for (int k = 0; k < L; ++k)
        if (k < count) m = fmaxf(m, xr.at(k));
      m = group_max(m, G);
      float e[L], sum = 0.f;
#pragma unroll
      for (int k = 0; k < L; ++k) {
        e[k] = expf(xr.at(k) - m);
        if (k < count) sum += e[k];
      }
      sum = group_sum(sum, G);
      float dot = 0.f;
#pragma unroll
      for (int k = 0; k < L; ++k) {
        e[k] = e[k] / sum;  // p1.
        const float p2 = __fadd_rn(__fmul_rn(e[k], h.keep), h.floor_);
        g[k] = __fmul_rn(g[k] / p2, h.keep);  // g1.
        if (k < count) dot += g[k] * e[k];
      }
      dot = group_sum(dot, G);
#pragma unroll
      for (int k = 0; k < L; ++k) g[k] = e[k] * (g[k] - dot);
    }
    if (count > 0) store_classes<L>(dx + at, count, K, g);
  }
}

// The general forward, redesigned in the backward's layout (above) but for L,
// which here is 1, 2, 3, 4, 6 or 8 (the caller's: where the values fill the
// card, the one whose group of lanes leaves the fewest places idle, 6 at 48
// classes, where 8 left 2 of each group's 8 lanes idle; where few values leave
// it idle, the fewest, 2 at 48 and 64, so that a lane's chain of work is
// short): a lane holds L consecutive classes of raw and, with the sample, of u
// in registers, read from memory once (raw in vectors of K values, the widest
// of up to 16 bytes that L and C are multiples of, u in vectors of up to 4
// floats: two 16-byte loads of u beside one of raw at 8 bfloat16 classes), and
// writes its logit and stoch once, never reading them back. Each exp and log is
// made once a value and kept: with the mixture raw's exp, the mixture's log;
// the logit's exp for its sum, the probability exp(lp) for stoch, the noise's
// two logs. Each group quantity (raw's max and sum of exp; the logit's max and
// sum of exp; the first arg max of lp plus the noise, or of lp) is taken over
// the lane's classes in class order, then over the group's lanes by log2(G) xor
// shuffles, so that every lane of the group gets the same bits, and the same
// class, in any launch. The per-value arithmetic and its rounding are
// onehot_any_fwd_kernel's: rounded<T> on the logit, __fadd_rn / __fmul_rn in
// the mixture and in (one + p) - p, logf(-logf(fmaxf(u, TINY))). A lane past
// the group's classes, or of a group past the last, adds nothing, wins nothing
// and writes nothing.
template <class T, int L>
__global__ void __launch_bounds__(256)
    onehot_group_fwd_kernel(const T* __restrict__ x,
                            const float* __restrict__ u,
                            T* __restrict__ logit, T* __restrict__ stoch,
                            Head h, int G, int K) {
  const int C = h.C, sub = threadIdx.x % G, per = THREADS / G;
  const long groups = h.n / C;
  const long steps = (groups + per - 1) / per;
  const int lo = sub * L;
  // Every thread of the block runs the same steps: the lanes of a group
  // shuffle together.
  for (long st = blockIdx.x; st < steps; st += gridDim.x) {
    const long grp = st * per + threadIdx.x / G;
    const int count = grp < groups ? max(0, min(L, C - lo)) : 0;
    const long at = grp * C + lo;
    // Both loads in flight before the first sum.
    Packed<T, L> xr;
    Packed<float, L> ur;
    load_classes<L>(x + at, count, K, xr);
    if (h.sample) load_classes<L>(u + at, count, K < 4 ? K : 4, ur);
    float l[L];
#pragma unroll
    for (int k = 0; k < L; ++k) l[k] = xr.at(k);
    if (h.unimix) {
      // softmax(x) mixed with the uniform floor, its log rounded to T.
      float m = -INFINITY;
#pragma unroll
      for (int k = 0; k < L; ++k)
        if (k < count) m = fmaxf(m, l[k]);
      m = group_max(m, G);
      float e[L], sum = 0.f;
#pragma unroll
      for (int k = 0; k < L; ++k) {
        e[k] = expf(l[k] - m);
        if (k < count) sum += e[k];
      }
      sum = group_sum(sum, G);
#pragma unroll
      for (int k = 0; k < L; ++k) {
        const float p2 = __fadd_rn(__fmul_rn(e[k] / sum, h.keep), h.floor_);
        l[k] = rounded<T>(logf(p2));
      }
    }
    // log_softmax of the logits, and the first arg max of it plus the
    // noise (the sample) or of it alone (the mode).
    float m = -INFINITY;
#pragma unroll
    for (int k = 0; k < L; ++k)
      if (k < count) m = fmaxf(m, l[k]);
    m = group_max(m, G);
    float z[L], sum = 0.f;
#pragma unroll
    for (int k = 0; k < L; ++k) {
      z[k] = l[k] - m;
      if (k < count) sum += expf(z[k]);
    }
    const float lse = logf(group_sum(sum, G));
    float best = -INFINITY;
    int win = 0x7fffffff;
#pragma unroll
    for (int k = 0; k < L; ++k) {
      z[k] = z[k] - lse;  // lp.
      if (k < count) {
        float val = z[k];
        if (h.sample) val += -logf(-logf(fmaxf(ur.at(k), TINY)));
        if (first(val, lo + k, best, win)) {
          best = val;
          win = lo + k;
        }
      }
    }
    win = group_argmax(best, win, G);
    float s[L];
#pragma unroll
    for (int k = 0; k < L; ++k) {
      const float one = lo + k == win ? 1.f : 0.f;
      s[k] = one;
      if (h.sample) {
        const float p = expf(z[k]);
        s[k] = __fsub_rn(__fadd_rn(one, p), p);
      }
    }
    if (count > 0) {
      store_classes<L>(logit + at, count, K, l);
      store_classes<L>(stoch + at, count, K, s);
    }
  }
}

// The general kernels at the caller's classes a lane L (1, 2, 3, 4, 6 or 8
// forward, ops/onehot.py's GROUP_LANES; 1, 2, 4 or 8 backward).
template <class T>
cudaError_t run_group(bool backward, void* const* p, const Head& h, int L,
                      int max_blocks, cudaStream_t stream) {
  int G = 1;
  while (G * L < h.C) G *= 2;
  int K = 16 / (int)sizeof(T);
  while (h.C % K || L % K) K /= 2;
  if (G > 32 || L > 8 || (backward && (L & (L - 1))))
    return cudaErrorInvalidValue;
  const long groups = h.n / h.C, per = THREADS / G;
  const int grid = (int)std::min<long>((groups + per - 1) / per, max_blocks);
#define ONEHOT_GROUP(LL)                                                 \
  if (L == LL) {                                                         \
    if (backward) {                                                      \
      auto kernel = onehot_group_bwd_kernel<T, LL>;                      \
      kernel<<<grid, THREADS, 0, stream>>>(static_cast<const T*>(p[0]), static_cast<const T*>(p[1]), static_cast<const T*>(p[2]), static_cast<const T*>(p[3]), static_cast<T*>(p[4]), h, G, K); \
    } else {                                                             \
      auto kernel = onehot_group_fwd_kernel<T, LL>;                      \
      kernel<<<grid, THREADS, 0, stream>>>(static_cast<const T*>(p[0]), static_cast<const float*>(p[1]), static_cast<T*>(p[2]), static_cast<T*>(p[3]), h, G, K); \
    }                                                                    \
    return cudaGetLastError();                                           \
  }
  ONEHOT_GROUP(1) ONEHOT_GROUP(2) ONEHOT_GROUP(4) ONEHOT_GROUP(8)
#undef ONEHOT_GROUP
#define ONEHOT_GROUP_FWD(LL)                                             \
  if (L == LL) {                                                         \
    auto kernel = onehot_group_fwd_kernel<T, LL>;                        \
    kernel<<<grid, THREADS, 0, stream>>>(static_cast<const T*>(p[0]), static_cast<const float*>(p[1]), static_cast<T*>(p[2]), static_cast<T*>(p[3]), h, G, K); \
    return cudaGetLastError();                                           \
  }
  ONEHOT_GROUP_FWD(3) ONEHOT_GROUP_FWD(6)
#undef ONEHOT_GROUP_FWD
  return cudaErrorInvalidValue;
}

// Any count of classes but the powers of two from 2 to 32: a group of G
// lanes a group.
template <class T, int G>
cudaError_t run_any_g(bool backward, void* const* p, const Head& h,
                      int max_blocks, cudaStream_t stream) {
  const long groups = h.n / h.C, per = THREADS / G;
  const int grid = (int)std::min<long>((groups + per - 1) / per, max_blocks);
  if (backward) {
    auto kernel = onehot_any_bwd_kernel<T, G>;
    kernel<<<grid, THREADS, 0, stream>>>(static_cast<const T*>(p[0]), static_cast<const T*>(p[1]), static_cast<const T*>(p[2]), static_cast<const T*>(p[3]), static_cast<T*>(p[4]), h);
  } else {
    auto kernel = onehot_any_fwd_kernel<T, G>;
    kernel<<<grid, THREADS, 0, stream>>>(static_cast<const T*>(p[0]), static_cast<const float*>(p[1]), static_cast<T*>(p[2]), static_cast<T*>(p[3]), h);
  }
  return cudaGetLastError();
}

template <class T>
cudaError_t run_any(bool backward, void* const* p, const Head& h,
                    int max_blocks, cudaStream_t stream) {
  if (h.C <= 1) return run_any_g<T, 1>(backward, p, h, max_blocks, stream);
  if (h.C <= 2) return run_any_g<T, 2>(backward, p, h, max_blocks, stream);
  if (h.C <= 4) return run_any_g<T, 4>(backward, p, h, max_blocks, stream);
  if (h.C <= 8) return run_any_g<T, 8>(backward, p, h, max_blocks, stream);
  if (h.C <= 16) return run_any_g<T, 16>(backward, p, h, max_blocks, stream);
  return run_any_g<T, 32>(backward, p, h, max_blocks, stream);
}

template <class T, int K>
cudaError_t run_k(bool backward, void* const* p, const Head& h,
                  int max_blocks, cudaStream_t stream) {
  const long steps = ((h.n + K - 1) / K + THREADS - 1) / THREADS;
  const int grid = (int)std::min<long>(steps, max_blocks);
#define ONEHOT_CASE(CC)                                                  \
  if (h.C == CC) {                                                       \
    if (backward) {                                                      \
      auto kernel = onehot_bwd_kernel<T, CC, K>;                         \
      kernel<<<grid, THREADS, 0, stream>>>(static_cast<const T*>(p[0]), static_cast<const T*>(p[1]), static_cast<const T*>(p[2]), static_cast<const T*>(p[3]), static_cast<T*>(p[4]), h); \
    } else {                                                             \
      auto kernel = onehot_fwd_kernel<T, CC, K>;                         \
      kernel<<<grid, THREADS, 0, stream>>>(static_cast<const T*>(p[0]), static_cast<const float*>(p[1]), static_cast<T*>(p[2]), static_cast<T*>(p[3]), h); \
    }                                                                    \
    return cudaGetLastError();                                           \
  }
  ONEHOT_CASE(2) ONEHOT_CASE(4) ONEHOT_CASE(8) ONEHOT_CASE(16) ONEHOT_CASE(32)
#undef ONEHOT_CASE
  return cudaErrorInvalidValue;
}

template <class T>
cudaError_t run(bool backward, void* const* p, Head h, const int* dims,
                cudaStream_t stream) {
  if (h.C > 32 || (h.C & (h.C - 1)) || h.C < 2) {
    if (dims[5] > 0)
      return run_group<T>(backward, p, h, dims[5], dims[4], stream);
    return run_any<T>(backward, p, h, dims[4], stream);
  }
  switch (dims[5]) {
    case 2: return run_k<T, 2>(backward, p, h, dims[4], stream);
    case 4: return run_k<T, 4>(backward, p, h, dims[4], stream);
    case 8: return run_k<T, 8>(backward, p, h, dims[4], stream);
  }
  return cudaErrorInvalidValue;
}

// dims: elements, classes, unimix (0 or 1), sample (0 or 1), blocks at
// most, classes a lane (2, 4 or 8, for classes a power of two from 2 to
// 32; for other counts 1, 2, 3, 4, 6 or 8 forward and 1, 2, 4 or 8
// backward for the group kernels, 0 for the passes); scalars: keep, floor.
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
  if (h.n <= 0 || h.C < 1 || h.n % h.C || dims[4] <= 0)
    return cudaErrorInvalidValue;
  return bf16 ? run<__nv_bfloat16>(backward, ptrs, h, dims, stream)
              : run<float>(backward, ptrs, h, dims, stream);
}

}  // namespace

// ptrs: x, u (float32; unread without the sample), logit, stoch, each of
// rows x S x C values, 16-byte aligned.
extern "C" int onehot_head_fwd(int bf16, void* const* ptrs, const int* dims,
                               float keep, float floor_, void* stream) {
  return launch(bf16, false, ptrs, dims, keep, floor_,
                static_cast<cudaStream_t>(stream));
}

// ptrs: x (unread without the mixture), logit and dstoch (unread without
// the sample), dlogit, dx, as the forward's.
extern "C" int onehot_head_bwd(int bf16, void* const* ptrs, const int* dims,
                               float keep, float floor_, void* stream) {
  return launch(bf16, true, ptrs, dims, keep, floor_,
                static_cast<cudaStream_t>(stream));
}

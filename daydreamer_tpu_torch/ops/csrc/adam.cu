// The optimizer's step over all the tensors of one optimizer, for Hopper
// (sm_90a): the global norm of the gradients, then clip, Adam and decoupled
// weight decay.
//
// Replaces the fused loops that XLA makes of the JAX package's optimizer
// (daydreamer_tpu/nn/opt.py:78-118). Eagerly the port's loop issued some
// twenty elementwise kernels a tensor, each reading and writing whole
// float32 tensors; here a launch covers up to MAXT tensors and an element
// is read once (p, g, m, v) and written once (p, m, v).
//
// adam_sumsq: the sum of g * g over every tensor. Each block sums a chunk
// of one tensor into its own slot of a workspace (the blocks of all
// launches side by side); sumsq_total_kernel then sums the slots in a
// fixed order and writes sqrt of the sum. No atomic add: the same
// gradients give the same bits in any launch. A launch takes up to MAXS
// gradients (the xarm world model's 108 in one).
//
// adam_update, per element, in the order and the rounding of the plain loop
// (ops/adam.py::adam_update_plain, each PyTorch op one float32 rounding):
//   g = g * scale
//   m = beta1 * m + (1 - beta1) * g
//   v = beta2 * v + ((1 - beta2) * g) * g
//   p' = (decayed ? decay * p : p) - (lr * (m / bias1)) / (sqrt(v / bias2) + eps)
// where 1 - beta1 and 1 - beta2 are the float32 values PyTorch takes for
// the Python numbers, and scale, bias1, bias2 (and lr and decay = 1 - wd *
// lr where they are tensors) are read on the device. Every operation is an
// __f*_rn intrinsic, so no multiply and add contract into one rounding.
// A norm that is not finite leaves every tensor as it is.
//
// The tensors' addresses and sizes go by value in the launch's parameters,
// MAXT tensors a launch: a gradient has another address at every eager
// call, and a copy of a pointer table from the host could not be captured
// in a CUDA graph. A block reads and writes 16-byte vectors where all of its
// tensor's arrays start on 16 bytes (a chunk starts on a multiple of 4
// values); a view into the data-parallel gradient bucket may not, and is
// then read one float at a time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAXT = 64;   // Tensors an update launch: 2.8 KB of parameters.
constexpr int MAXS = 192;  // Gradients a sumsq launch: 3.1 KB.
constexpr unsigned FULL = 0xffffffffu;

struct Tensors {
  float* p[MAXT];
  const float* g[MAXT];
  float* m[MAXT];
  float* v[MAXT];
  int n[MAXT];
  int decayed[MAXT];
  int first[MAXT + 1];  // The first block of each tensor; then the total.
  int chunk;            // Elements a block.
};

struct Grads {
  const float* g[MAXS];
  int n[MAXS];
  int first[MAXS + 1];
  int chunk;
};

// The tensor of this block, the last t < size with first[t] <= block (an
// empty tensor shares its first with the next one), by bisection; and its
// range of elements.
template <class List>
__device__ __forceinline__ int locate(const List& ts, int size, int* begin,
                                      int* end) {
  const int block = (int)blockIdx.x;
  int lo = 0, hi = size;
  while (hi - lo > 1) {
    const int mid = (lo + hi) / 2;
    if (ts.first[mid] <= block) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  *begin = (block - ts.first[lo]) * ts.chunk;
  *end = min(*begin + ts.chunk, ts.n[lo]);
  return lo;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__global__ void __launch_bounds__(256)
    sumsq_kernel(Grads ts, float* __restrict__ slots) {
  extern __shared__ __align__(16) float smem[];
  int begin, end;
  const int t = locate(ts, MAXS, &begin, &end);
  const float* g = ts.g[t];
  float s = 0.f;
  int i = begin + (int)threadIdx.x;
  if (aligned16(g)) {
    // Whole vectors of the chunk, four sums a thread; then the rest.
    const float4* g4 = reinterpret_cast<const float4*>(g + begin);
    const int vecs = (end - begin) / 4;
    float a = 0.f, b = 0.f, c = 0.f, d = 0.f;
#pragma unroll 4
    for (int j = threadIdx.x; j < vecs; j += THREADS) {
      const float4 q = g4[j];
      a += q.x * q.x;
      b += q.y * q.y;
      c += q.z * q.z;
      d += q.w * q.w;
    }
    s = (a + b) + (c + d);
    i = begin + 4 * vecs + (int)threadIdx.x;
  }
  for (; i < end; i += THREADS) s += g[i] * g[i];
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  if ((threadIdx.x & 31) == 0) smem[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int w = 0; w < WARPS; ++w) total += smem[w];
    slots[blockIdx.x] = total;
  }
}

// One block: the slots summed in a fixed order, and the norm.
__global__ void __launch_bounds__(256)
    sumsq_total_kernel(const float* __restrict__ slots, int count,
                       float* __restrict__ norm) {
  extern __shared__ __align__(16) float smem[];
  float s = 0.f;
  for (int i = threadIdx.x; i < count; i += THREADS) s += slots[i];
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  if ((threadIdx.x & 31) == 0) smem[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int w = 0; w < WARPS; ++w) total += smem[w];
    *norm = sqrtf(total);
  }
}

struct Scalars {
  const float* norm;
  const float* scale;
  const float* lr;     // Null: lr_value.
  const float* bias1;
  const float* bias2;
  const float* decay;  // Null: decay_value.
  float lr_value, decay_value, beta1, one_minus_beta1, beta2,
      one_minus_beta2, eps;
};

__global__ void __launch_bounds__(256)
    adam_update_kernel(Tensors ts, Scalars k) {
  extern __shared__ __align__(16) float smem[];
  if (!isfinite(*k.norm)) return;
  int begin, end;
  const int t = locate(ts, MAXT, &begin, &end);
  float* __restrict__ p = ts.p[t];
  const float* __restrict__ g = ts.g[t];
  float* __restrict__ m = ts.m[t];
  float* __restrict__ v = ts.v[t];
  const float scale = *k.scale, bias1 = *k.bias1, bias2 = *k.bias2;
  const float lr = k.lr ? *k.lr : k.lr_value;
  const float decay = k.decay ? *k.decay : k.decay_value;
  const bool decayed = ts.decayed[t];
  // One element's p, m and v, in place, from its g.
  auto step = [&](float& pi, float gi, float& mi, float& vi) {
    gi = __fmul_rn(gi, scale);
    mi = __fadd_rn(__fmul_rn(k.beta1, mi), __fmul_rn(k.one_minus_beta1, gi));
    vi = __fadd_rn(__fmul_rn(k.beta2, vi),
                   __fmul_rn(__fmul_rn(k.one_minus_beta2, gi), gi));
    const float base = decayed ? __fmul_rn(decay, pi) : pi;
    pi = __fsub_rn(base, __fdiv_rn(
        __fmul_rn(lr, __fdiv_rn(mi, bias1)),
        __fadd_rn(__fsqrt_rn(__fdiv_rn(vi, bias2)), k.eps)));
  };
  int i = begin + (int)threadIdx.x;
  if (aligned16(p) && aligned16(g) && aligned16(m) && aligned16(v)) {
    const int vecs = (end - begin) / 4;
    float4* p4 = reinterpret_cast<float4*>(p + begin);
    const float4* g4 = reinterpret_cast<const float4*>(g + begin);
    float4* m4 = reinterpret_cast<float4*>(m + begin);
    float4* v4 = reinterpret_cast<float4*>(v + begin);
    for (int j = threadIdx.x; j < vecs; j += THREADS) {
      float4 pj = p4[j], mj = m4[j], vj = v4[j];
      const float4 gj = g4[j];
      step(pj.x, gj.x, mj.x, vj.x);
      step(pj.y, gj.y, mj.y, vj.y);
      step(pj.z, gj.z, mj.z, vj.z);
      step(pj.w, gj.w, mj.w, vj.w);
      p4[j] = pj;
      m4[j] = mj;
      v4[j] = vj;
    }
    i = begin + 4 * vecs + (int)threadIdx.x;
  }
  for (; i < end; i += THREADS) step(p[i], g[i], m[i], v[i]);
}

// Fills `ts` with tensors [from, from + count) of the host's lists and
// returns the launch's blocks. `tensor(i, j)`: list j's pointer of tensor
// i (0 p, 1 g, 2 m, 3 v); n and decayed of each tensor.
template <class Pointer>
int fill(Tensors* ts, int from, int count, int chunk, const int* n,
         const int* decayed, Pointer tensor) {
  ts->chunk = chunk;
  int blocks = 0;
  for (int i = 0; i < count; ++i) {
    ts->p[i] = static_cast<float*>(tensor(from + i, 0));
    ts->g[i] = static_cast<const float*>(tensor(from + i, 1));
    ts->m[i] = static_cast<float*>(tensor(from + i, 2));
    ts->v[i] = static_cast<float*>(tensor(from + i, 3));
    ts->n[i] = n[from + i];
    ts->decayed[i] = decayed[from + i];
    ts->first[i] = blocks;
    blocks += (n[from + i] + chunk - 1) / chunk;
  }
  for (int i = count; i <= MAXT; ++i) ts->first[i] = blocks;
  return blocks;
}

// The same for `adam_sumsq`'s gradients.
int fill_grads(Grads* ts, int from, int count, int chunk, const int* n,
               void* const* grads) {
  ts->chunk = chunk;
  int blocks = 0;
  for (int i = 0; i < count; ++i) {
    ts->g[i] = static_cast<const float*>(grads[from + i]);
    ts->n[i] = n[from + i];
    ts->first[i] = blocks;
    blocks += (n[from + i] + chunk - 1) / chunk;
  }
  for (int i = count; i <= MAXS; ++i) ts->first[i] = blocks;
  return blocks;
}

}  // namespace

// ptrs: norm (out), slots [total blocks], then each gradient. dims: count,
// chunk, then each gradient's size. The slots are the sum over the
// gradients of ceil(size / chunk).
extern "C" int adam_sumsq(int, void* const* ptrs, const int* dims,
                          void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int count = dims[0], chunk = dims[1];
  const int* n = dims + 2;
  float* norm = static_cast<float*>(ptrs[0]);
  float* slots = static_cast<float*>(ptrs[1]);
  void* const* grads = ptrs + 2;
  const size_t bytes = WARPS * sizeof(float);
  int total = 0;
  for (int from = 0; from < count; from += MAXS) {
    Grads ts;
    const int blocks = fill_grads(&ts, from, min(MAXS, count - from), chunk, n, grads);
    float* out = slots + total;
    if (blocks) sumsq_kernel<<<blocks, THREADS, bytes, st>>>(ts, out);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    total += blocks;
  }
  sumsq_total_kernel<<<1, THREADS, bytes, st>>>(slots, total, norm);
  return cudaGetLastError();
}

// ptrs: norm, scale, lr (or null), bias1, bias2, decay (or null), then p,
// g, m, v of each tensor. dims: count, chunk, then each tensor's size and
// whether it is decayed. scalars: lr_value, decay_value (where the
// pointers are null), beta1, 1 - beta1, beta2, 1 - beta2, eps.
extern "C" int adam_update(int, void* const* ptrs, const int* dims,
                           float lr_value, float decay_value, float beta1,
                           float one_minus_beta1, float beta2,
                           float one_minus_beta2, float eps, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int count = dims[0], chunk = dims[1];
  int* n = new int[count > 0 ? count : 1];
  int* decayed = new int[count > 0 ? count : 1];
  for (int i = 0; i < count; ++i) {
    n[i] = dims[2 + 2 * i];
    decayed[i] = dims[3 + 2 * i];
  }
  Scalars k;
  k.norm = static_cast<const float*>(ptrs[0]);
  k.scale = static_cast<const float*>(ptrs[1]);
  k.lr = static_cast<const float*>(ptrs[2]);
  k.bias1 = static_cast<const float*>(ptrs[3]);
  k.bias2 = static_cast<const float*>(ptrs[4]);
  k.decay = static_cast<const float*>(ptrs[5]);
  k.lr_value = lr_value;
  k.decay_value = decay_value;
  k.beta1 = beta1;
  k.one_minus_beta1 = one_minus_beta1;
  k.beta2 = beta2;
  k.one_minus_beta2 = one_minus_beta2;
  k.eps = eps;
  void* const* lists = ptrs + 6;
  auto tensor = [&](int i, int j) { return lists[4 * i + j]; };
  const size_t bytes = WARPS * sizeof(float);
  cudaError_t err = cudaSuccess;
  for (int from = 0; from < count && err == cudaSuccess; from += MAXT) {
    Tensors ts;
    const int blocks = fill(&ts, from, min(MAXT, count - from), chunk, n, decayed, tensor);
    if (blocks) adam_update_kernel<<<blocks, THREADS, bytes, st>>>(ts, k);
    err = cudaGetLastError();
  }
  delete[] n;
  delete[] decayed;
  return err;
}

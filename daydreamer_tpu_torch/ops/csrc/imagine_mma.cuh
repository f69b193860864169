// The tensor-core product of imagine_actor.cu and the ring of weight tiles
// that feeds it, with the FMA products the kernel keeps for float32 and for
// widths the tensor cores do not take. It builds on imagine_common.cuh
// (R = 8 rows a block, NT = 256 threads, the converters, the one-hot
// gather) and leaves that header, which imagine.cu shares, as it is.
//
// Layout. A vector of a step that a product reads lies in shared memory in
// the element type T, transposed: X[k][R], so for bfloat16 one row of X is
// 16 bytes, the row of an 8 x 8 ldmatrix tile. Every product writes its sum
// as float to one buffer Y[n][R]; LayerNorm reads it and writes the next
// product's input.
//
// The product, bfloat16: Y^T = W^T X^T with mma.sync m16n8k16. The output
// columns are the instruction's M and the block's 8 rows are its N, so no
// lane of the tensor cores multiplies padding. A pass covers PASS = 512
// columns: each of the 8 warps owns 4 tiles of 16 columns and keeps their
// sums in 16 registers. Weights are [K][N] row-major, so a tile of KT = 32
// weight rows by 512 columns has the columns contiguous: ldmatrix.trans
// turns it into the A fragment, and the same instruction turns X[k][R] into
// the B fragment. A tile's rows are PITCH = 520 elements apart in shared
// memory, so that the 8 rows of one ldmatrix fall into 8 different groups
// of banks.
//
// The ring. Tiles arrive by cp.async, 16 bytes a thread, into a ring of up
// to 4 stages; all threads issue the copies of the tile that lies
// stages - 1 ahead just before they multiply the tile at hand, one
// commit group a tile. The order of all tiles of all steps is known from
// the start (Schedule: a step's products, and for each its passes, inputs
// and slices of K), so the ring runs on across layers and steps: while a
// LayerNorm, a sample or a gather runs, the next product's first tiles are
// on their way. Only the products on the tensor cores take part; a product
// whose K or N is no multiple of 16, the one-hot gathers and float32 go by
// FMA and read their weights from L2 as the parent kernel did.

#pragma once

#include "hopper_ptx.cuh"
#include "imagine_common.cuh"

namespace imm {

using namespace img;

constexpr int KT = 32;            // Weight rows per tile.
constexpr int PASS = 512;         // Columns per tile: 8 warps x 4 x 16.
constexpr int PITCH = PASS + 8;   // Elements between a tile's rows.
constexpr int TILE = KT * PITCH;  // Elements per stage (33 280 bytes).
constexpr int MAXSTAGES = 4;

// Most products in a step's schedule for L prior and L actor layers.
__host__ __device__ constexpr int products(int L) { return 2 * L + 4; }

static_assert(NT == 256 && R == 8, "8 warps, and 8 rows for the mma's N");

typedef __nv_bfloat16 bf16;

// One product of a step, Y = X0 @ W0 (+ X1 @ W1), N columns wide.
struct Product {
  const bf16* W[2];  // W[1] null: one input.
  int K[2];
  int N;
  short mma;         // On the tensor cores, so the ring streams it.
  short first_only;  // Part of step 0 only.
};
template <int P>
struct Schedule {
  Product prod[P];
  int count;
  int pad[3];
};
static_assert(sizeof(Product) == 32 && sizeof(Schedule<1>) % 16 == 0,
              "layout");

// The ring's state: the same in every thread of the block. P: the
// schedule's room.
template <int P>
struct Ring {
  bf16* base;
  const Schedule<P>* sched;
  int stages, steps;
  int head, tail;           // Slots of the next tile to use, to fill.
  int j, pass, seg, kt, t;  // The next tile to ask for.
};

// Moves the ring's request cursor to a product that step t streams.
template <int P>
__device__ __forceinline__ void settle(Ring<P>& r) {
  while (r.t < r.steps) {
    if (r.j == r.sched->count) {
      r.j = 0;
      ++r.t;
      continue;
    }
    const Product& p = r.sched->prod[r.j];
    if (p.mma && (r.t == 0 || !p.first_only)) return;
    ++r.j;
  }
}

// Asks for the next tile (nothing once all steps are asked for) and closes
// the commit group: one group for each call, so that groups count tiles.
template <int P>
__device__ __forceinline__ void request(Ring<P>& r) {
  if (r.t < r.steps) {
    const Product& p = r.sched->prod[r.j];
    const int N = p.N, K = p.K[r.seg];
    const int rows = min(KT, K - r.kt * KT);
    const int chunks = min(PASS, N - r.pass * PASS) / 8;
    const bf16* src = p.W[r.seg] + (size_t)r.kt * KT * N + r.pass * PASS;
    bf16* dst = r.base + (size_t)r.tail * TILE;
    for (int c = threadIdx.x; c < rows * chunks; c += NT) {
      const int row = c / chunks, col = (c - row * chunks) * 8;
      ptx::cp_async16(dst + row * PITCH + col, src + (size_t)row * N + col);
    }
    r.tail = r.tail + 1 == r.stages ? 0 : r.tail + 1;
    if (++r.kt * KT >= K) {
      r.kt = 0;
      if (++r.seg == 2 || !p.W[r.seg]) {
        r.seg = 0;
        if (++r.pass * PASS >= N) {
          r.pass = 0;
          ++r.j;
          settle(r);
        }
      }
    }
  }
  ptx::cp_async_commit();
}

// Starts the ring: stages - 1 tiles on their way.
template <int P>
__device__ __forceinline__ void start(Ring<P>& r) {
  r.head = r.tail = r.j = r.pass = r.seg = r.kt = r.t = 0;
  settle(r);
  for (int i = 0; i + 1 < r.stages; ++i) request(r);
}

// The next tile, arrived for every thread. Every thread has left the tile
// before it by now, so that one's slot takes the next request.
template <int P>
__device__ __forceinline__ const bf16* acquire(Ring<P>& r) {
  if (r.stages == 2) ptx::cp_async_wait<0>();
  else if (r.stages == 3) ptx::cp_async_wait<1>();
  else ptx::cp_async_wait<2>();
  __syncthreads();
  request(r);
  const bf16* tile = r.base + (size_t)r.head * TILE;
  r.head = r.head + 1 == r.stages ? 0 : r.head + 1;
  return tile;
}

// Y[n][r] = X0 @ W0 (+ X1 @ W1) (+ bias), rounded to bf16 when `round`, on
// the tensor cores from the ring's tiles; p must be the product the ring
// streams next. Ends with a barrier.
template <int P>
__device__ void dense_mma(Ring<P>& ring, const Product& p, const bf16* X0,
                          const bf16* X1, const bf16* bias, bool round,
                          float* Y) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, q = lane % 4;
  // ldmatrix rows: lanes 8i .. 8i+7 address matrix i. A: k 0-7 / 8-15 by
  // lane / 16, columns 0-7 / 8-15 by (lane / 8) % 2. B: k by lane % 16.
  const int a_row = lane % 8 + lane / 16 * 8;
  const int a_col = warp * 64 + lane / 8 % 2 * 8;
  const int N = p.N;
  for (int base = 0; base < N; base += PASS) {
    const int mine = min(PASS, N - base) - warp * 64;  // Columns left to me.
    float acc[4][4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][i] = 0.f;
    for (int seg = 0; seg < 2 && p.W[seg]; ++seg) {
      const bf16* X = seg ? X1 : X0;
      const int K = p.K[seg];
      for (int k0 = 0; k0 < K; k0 += KT) {
        const bf16* tile = acquire(ring);
        const int rows = min(KT, K - k0);
        for (int kk = 0; kk < rows; kk += 16) {
          uint32_t b[2];
          ptx::ldmatrix_x2_trans(b, X + (size_t)(k0 + kk + lane % 16) * R);
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            if (m * 16 < mine) {
              uint32_t a[4];
              ptx::ldmatrix_x4_trans(
                  a, tile + (kk + a_row) * PITCH + a_col + m * 16);
              // Each instruction starts from zero and its sums are
              // added here, rounding to nearest: the tensor cores cut
              // their running sum off toward zero, and over a K of 1024
              // that bias flips bf16 roundings that the FMA chain's and
              // the plain version's sums do not.
              float c[4] = {0.f, 0.f, 0.f, 0.f};
              ptx::mma_bf16_16816(c, a, b);
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[m][i] += c[i];
            }
          }
        }
      }
    }
    // c[0], c[1]: column g of the tile, rows 2q and 2q+1; c[2], c[3]:
    // column g + 8.
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      if (m * 16 >= mine) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = base + warp * 64 + m * 16 + g + 8 * h;
        const float b = bias ? to_f(bias[n]) : 0.f;
        float v0 = acc[m][2 * h] + b, v1 = acc[m][2 * h + 1] + b;
        if (round) {
          v0 = rnd<bf16>(v0);
          v1 = rnd<bf16>(v1);
        }
        *reinterpret_cast<float2*>(Y + n * R + 2 * q) = make_float2(v0, v1);
      }
    }
  }
  __syncthreads();
}

// ---- The FMA products, on inputs X[k][R] of type T ----------------------

__device__ __forceinline__ void load_x(float (&x)[R], const float* X) {
  const float4 a = *reinterpret_cast<const float4*>(X);
  const float4 b = *reinterpret_cast<const float4*>(X + 4);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void load_x(float (&x)[R], const bf16* X) {
  const uint4 raw = *reinterpret_cast<const uint4*>(X);
  const unsigned words[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&words[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// One input of an FMA product: X [K][R], or the one-hot given by its
// classes idx [S][R] (S = K / C groups) when idx is set. W null: no input.
template <typename T>
struct Src {
  const T* X;
  const int* idx;
  int K;
  const T* W;
};

// acc[c][r] += sum_k X[k][r] * W[k][n_c] for the thread's columns n0, n1:
// the parent kernel's product, weights straight from L2.
template <typename T>
__device__ __forceinline__ void mm_x(float (&acc)[2][R], const Src<T>& in,
                                     int C, int N, int n0, int n1) {
  if (in.idx) {
    mm_onehot<T>(acc, in.idx, in.K / C, C, in.W, N, n0, n1);
    return;
  }
  const bool v0 = n0 < N, v1 = n1 < N;
#pragma unroll 4
  for (int k = 0; k < in.K; ++k) {
    const T* row = in.W + (size_t)k * N;
    const float w0 = v0 ? to_f(row[n0]) : 0.f;
    const float w1 = v1 ? to_f(row[n1]) : 0.f;
    float x[R];
    load_x(x, in.X + k * R);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      acc[0][r] = fmaf(x[r], w0, acc[0][r]);
      acc[1][r] = fmaf(x[r], w1, acc[1][r]);
    }
  }
}

// Y[n][r] = in1 (+ in2) (+ bias) (+ addend[n][r]), rounded to T when
// `round`. addend may be Y: a thread reads only what it writes. Ends with
// a barrier.
template <typename T>
__device__ void dense_fma(const Src<T>& in1, const Src<T>& in2, int C, int N,
                          const T* bias, bool round, float* Y,
                          const float* addend) {
  for (int base = 0; base < N; base += 2 * NT) {
    const int n0 = base + threadIdx.x, n1 = n0 + NT;
    float acc[2][R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[0][r] = acc[1][r] = 0.f;
    mm_x<T>(acc, in1, C, N, n0, n1);
    if (in2.W) mm_x<T>(acc, in2, C, N, n0, n1);
    const int ns[2] = {n0, n1};
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (ns[c] >= N) continue;
      const float b = bias ? to_f(bias[ns[c]]) : 0.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float v = acc[c][r] + b;
        if (addend) v += addend[ns[c] * R + r];
        Y[ns[c] * R + r] = round ? rnd<T>(v) : v;
      }
    }
  }
  __syncthreads();
}

// Y[n][r] = X @ W + bias for a few columns (N * slices <= NT): with a
// thread a column, N threads would walk all of K one load after another,
// so the threads split K into `slices` interleaved slices as well, leave
// their partial sums in scratch (slices * N * R floats) and each output
// adds its partials in order. Ends with a barrier.
template <typename T>
__device__ void dense_narrow(const T* X, int K, const T* W, int N,
                             const T* bias, int slices, float* scratch,
                             float* Y) {
  const int n = threadIdx.x % N, slice = threadIdx.x / N;
  if (slice < slices) {
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
#pragma unroll 4
    for (int k = slice; k < K; k += slices) {
      const float w = to_f(W[(size_t)k * N + n]);
      float x[R];
      load_x(x, X + k * R);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = fmaf(x[r], w, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) scratch[(slice * N + n) * R + r] = acc[r];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < N * R; e += NT) {
    float v = 0.f;
    for (int s = 0; s < slices; ++s) v += scratch[s * N * R + e];
    Y[e] = v + to_f(bias[e / R]);
  }
  __syncthreads();
}

// LayerNorm (float, eps 1e-3) over Y [N][R], then ELU when `elu`, rounding
// to T after each as nets.py / pallas_rssm.py do: img::ln_act, writing the
// result as T to X [N][R] and as float to `out` [N][R], where given (out
// may be Y). One warp a row. Ends with a barrier.
template <typename T>
__device__ void ln_act_to(const float* Y, int N, const T* scale,
                          const T* bias, bool elu, T* X, float* out) {
  const int r = threadIdx.x / 32, lane = threadIdx.x % 32;
  float s = 0.f;
  for (int n = lane; n < N; n += 32) s += Y[n * R + r];
  const float mean = warp_sum(s) / N;
  float v = 0.f;
  for (int n = lane; n < N; n += 32) {
    const float d = Y[n * R + r] - mean;
    v += d * d;
  }
  const float inv = rsqrtf(warp_sum(v) / N + 1e-3f);
  for (int n = lane; n < N; n += 32) {
    float y = rnd<T>((Y[n * R + r] - mean) * inv * to_f(scale[n]) +
                     to_f(bias[n]));
    if (elu) y = rnd<T>(y > 0.f ? y : expf(y) - 1.f);
    if (X) X[n * R + r] = from_f<T>(y);
    if (out) out[n * R + r] = y;
  }
  __syncthreads();
}

}  // namespace imm

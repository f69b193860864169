// Rows split over the blocks of a thread-block cluster: what the two
// cluster backwards share (ln_cluster_bwd_kernel in layer_norm.cu,
// gru_cluster_bwd_kernel in gru.cu), for rows too wide for one block's
// lanes to hold in registers.
//
// A cluster of `ranks` blocks takes a run of consecutive rows; lane
// rank * blockDim.x + threadIdx.x of the cluster owns the same columns of
// every row (vectors lane, lane + lanes, ...), so each row is read from
// memory once and kept in registers between the backward's two halves.
// What the ranks must share is each row's two sums (of dn * scale and of
// dn * scale * xhat): `row_totals` sums them over a batch of B rows at a
// time, first over the block's warps, then over the ranks through
// distributed shared memory, one cluster barrier a batch, with the next
// batch's loads already in flight. Every thread of every rank gets the same
// bits: each level sums in a fixed order.
//
// The column sums (dscale, dbias) need no exchange inside the cluster: the
// ranks' columns are disjoint. `flush_sums` writes a thread's sums into its
// cluster's row of `partial`; the clusters' rows meet in two levels of
// tickets (groups of about sqrt(clusters) rows summed side by side, then
// the groups' rows), each counter reset to 0 by the block that draws its
// last ticket, ready for the next launch (a grid of one cluster writes
// dscale and dbias itself). No float atomic: the same inputs give the
// same bits in any launch.

#pragma once

#include <cuda_bf16.h>

#include "hopper_ptx.cuh"

namespace row_cluster {

constexpr unsigned FULL = 0xffffffffu;
// Blocks of a cluster at most (past the portable 8), and warps of a block.
constexpr int MAX_RANKS = 16;
constexpr int MAX_WARPS = 8;

// The P values of v (1 or 2) rounded to T (float, or bfloat16 to nearest
// even, as a cast rounds): in place (round_pair), stored at out
// (store_pair), or both (keep_pair). bfloat16 pairs take one conversion
// instruction for two (the card issues conversions at a quarter of a
// multiply's rate).
template <class T, int P>
__device__ __forceinline__ void round_pair(float (&v)[P]) {
  if constexpr (sizeof(T) == 2 && P == 2) {
    const float2 f = __bfloat1622float2(__floats2bfloat162_rn(v[0], v[1]));
    v[0] = f.x;
    v[1] = f.y;
  } else if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int q = 0; q < P; ++q)
      v[q] = __bfloat162float(__float2bfloat16(v[q]));
  }
}
template <class T, int P>
__device__ __forceinline__ void store_pair(const float (&v)[P], T* out) {
  if constexpr (sizeof(T) == 2 && P == 2) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[0], v[1]);
    out[0] = h.x;
    out[1] = h.y;
  } else {
#pragma unroll
    for (int q = 0; q < P; ++q) {
      if constexpr (sizeof(T) == 2)
        out[q] = __float2bfloat16(v[q]);
      else
        out[q] = v[q];
    }
  }
}
template <class T, int P>
__device__ __forceinline__ void keep_pair(float (&v)[P], T* out) {
  if constexpr (sizeof(T) == 2 && P == 2) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[0], v[1]);
    out[0] = h.x;
    out[1] = h.y;
    const float2 f = __bfloat1622float2(h);
    v[0] = f.x;
    v[1] = f.y;
  } else {
    store_pair<T, P>(v, out);
    round_pair<T, P>(v);
  }
}

// Rows a batch (one cluster barrier) from the bytes of a row's inputs a
// lane keeps: up to 4 rows while their registers stay few.
__host__ __device__ constexpr int rows_at(int bytes) {
  return bytes <= 16 ? 4 : bytes <= 32 ? 2 : 1;
}

// Floats of shared memory `row_totals` and `flush_sums` take at the head
// of a block's: the warps' sums, two buffers of the block's sums, the
// ticket's flag; a multiple of 4, so that what follows is 16-byte aligned.
template <int B>
__host__ __device__ constexpr int head_floats() {
  return (MAX_WARPS * 2 * B + 2 * 2 * B + 1 + 3) / 4 * 4;
}

// a[b] and b[b], a thread's shares of the two sums of the batch's row b,
// become the row's totals over the cluster: the warps' shuffles, the
// block's warps in order (shared memory), then the ranks in a butterfly
// over a warp's lanes, lane l reading rank l's block sums (distributed
// shared memory). `buf` alternates between batches: a rank writes its
// block sums for batch i + 2 only after the barrier of batch i + 1, which
// every rank passes after its reads of batch i. Every thread of every rank
// calls it; it holds the cluster's barrier.
template <int B>
__device__ __forceinline__ void row_totals(float (&a)[B], float (&b)[B],
                                           float* head, int buf, int ranks) {
  float* red = head;
  float* slot = head + MAX_WARPS * 2 * B + buf * 2 * B;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < B; ++r) {
      a[r] += __shfl_xor_sync(FULL, a[r], o);
      b[r] += __shfl_xor_sync(FULL, b[r], o);
    }
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < B; ++r) {
      red[warp * 2 * B + r] = a[r];
      red[warp * 2 * B + B + r] = b[r];
    }
  }
  __syncthreads();
  if ((int)threadIdx.x < 2 * B) {
    float sum = 0.f;
    for (int w = 0; w < (int)blockDim.x / 32; ++w)
      sum += red[w * 2 * B + threadIdx.x];
    slot[threadIdx.x] = sum;
  }
  ptx::cluster_sync();
  float v[2 * B];
#pragma unroll
  for (int t = 0; t < 2 * B; ++t) v[t] = 0.f;
  if (lane < ranks) {
    const float* theirs = ptx::cluster_map(slot, lane);
#pragma unroll
    for (int t = 0; t < 2 * B; ++t) v[t] = theirs[t];
  }
  // Lanes past the ranks add zeros; x + y and y + x are the same bits, so
  // every lane ends with the same totals.
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int t = 0; t < 2 * B; ++t) v[t] += __shfl_xor_sync(FULL, v[t], o);
#pragma unroll
  for (int r = 0; r < B; ++r) {
    a[r] = v[r];
    b[r] = v[B + r];
  }
}

// VEC floats at p (16-byte aligned where VEC is a multiple of 4), read
// past L1 (another block wrote them), and written.
template <int VEC>
__device__ __forceinline__ void load_cg(const float* p, float* out) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int k = 0; k < VEC; k += 4) {
      const float4 q = __ldcg(reinterpret_cast<const float4*>(p + k));
      out[k] = q.x;
      out[k + 1] = q.y;
      out[k + 2] = q.z;
      out[k + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) out[k] = __ldcg(p + k);
  }
}
template <int VEC>
__device__ __forceinline__ void store(float* p, const float* v) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int k = 0; k < VEC; k += 4)
      *reinterpret_cast<float4*>(p + k) =
          make_float4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) p[k] = v[k];
  }
}

// The groups of clusters whose rows of `partial` meet first: ceil(sqrt(
// clusters)) clusters a group, so that neither level sums more than about
// sqrt(clusters) rows. Returns the clusters a group; *groups gets their
// count.
__host__ __device__ inline int group_size(int clusters, int* groups) {
  int size = 1;
  while (size * size < clusters) ++size;
  *groups = (clusters + size - 1) / size;
  return size;
}

// Each of the thread's columns summed over `count` rows of `partial` from
// row `first` (rows P floats apart) in row order, U rows in flight:
// 16 floats of single values, else 32 (more cost the whole kernel
// registers); the sums go to `out` at the same columns.
template <int G, int VEC>
__device__ __forceinline__ void sum_rows(const int (&col)[G], int half,
                                         const float* partial, long P,
                                         int first, int count,
                                         float* __restrict__ out_s,
                                         float* __restrict__ out_b) {
  constexpr int U = VEC == 1 ? 16 : VEC >= 8 ? 4 : 32 / VEC;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (col[g] < 0) continue;
      const float* at = partial + first * P + h * half + col[g];
      float sum[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) sum[k] = 0.f;
      for (int c = 0; c < count; c += U) {
        float v[U][VEC];
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (c + u < count) load_cg<VEC>(at + (c + u) * P, v[u]);
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (c + u < count) {
#pragma unroll
            for (int k = 0; k < VEC; ++k) sum[k] += v[u][k];
          }
      }
      store<VEC>((h ? out_b : out_s) + col[g], sum);
    }
}

// Whether this block draws the last of `count` tickets of *counter (then
// it resets the counter to 0 for the next launch): every thread fences its
// stores first, then one takes the ticket. `flag`: a float of shared
// memory. Every thread of the block calls it.
__device__ __forceinline__ bool last_ticket(unsigned* counter, int count,
                                            float* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    flag[0] = atomicAdd(counter, 1u) == (unsigned)(count - 1) ? 1.f : 0.f;
    __threadfence();
  }
  __syncthreads();
  if (flag[0] == 0.f) return false;
  if (threadIdx.x == 0) *counter = 0;
  return true;
}

// A thread's column sums acc[h][g] (h 0: dscale, 1: dbias), G vectors of
// VEC columns from col[g] (-1: past the row), into dscale and dbias: where
// the grid is one cluster, directly; else through its cluster's row
// `mine` of `partial` (rows of P floats, dbias's columns `half` after
// dscale's) and tickets. With `grouped`, two levels: the block of rank r
// that draws the last ticket of its group's counter r (tickets[MAX_RANKS *
// (1 + group) + r]) sums the group's rows in cluster order; with one group
// into dscale and dbias, else into the group's row (after the clusters'
// rows), and the block of rank r that draws the last ticket of counter r
// sums the groups' rows in group order. Without, one: the block of rank r
// that draws the last ticket of counter r sums the clusters' rows. (The
// second level's ticket costs more than it saves where every cluster
// takes one row and all finish together: PERF.md.) `flag`: a
// float of shared memory. Every thread of the block calls it.
template <int G, int VEC>
__device__ __forceinline__ void flush_sums(
    const float (&acc)[2][G][VEC], const int (&col)[G], int half,
    float* __restrict__ partial, long P, int clusters, bool grouped,
    int mine, unsigned* __restrict__ tickets, int rank,
    float* __restrict__ dscale, float* __restrict__ dbias, float* flag) {
  if (clusters == 1) {
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (col[g] >= 0) {
        store<VEC>(dscale + col[g], acc[0][g]);
        store<VEC>(dbias + col[g], acc[1][g]);
      }
    return;
  }
  float* row = partial + mine * P;
#pragma unroll
  for (int g = 0; g < G; ++g)
    if (col[g] >= 0) {
      store<VEC>(row + col[g], acc[0][g]);
      store<VEC>(row + half + col[g], acc[1][g]);
    }
  if (!grouped) {
    if (last_ticket(tickets + rank, clusters, flag))
      sum_rows<G, VEC>(col, half, partial, P, 0, clusters, dscale, dbias);
    return;
  }
  int groups;
  const int size = group_size(clusters, &groups), group = mine / size;
  const int first = group * size, count = min(size, clusters - first);
  if (!last_ticket(tickets + MAX_RANKS * (1 + group) + rank, count, flag))
    return;
  if (groups == 1) {
    sum_rows<G, VEC>(col, half, partial, P, first, count, dscale, dbias);
    return;
  }
  float* group_row = partial + (clusters + group) * P;
  sum_rows<G, VEC>(col, half, partial, P, first, count, group_row,
                   group_row + half);
  if (!last_ticket(tickets + rank, groups, flag)) return;
  sum_rows<G, VEC>(col, half, partial, P, clusters, groups, dscale, dbias);
}

// The launch of a cluster kernel: `ranks` blocks a cluster (the non-
// portable size allowed past 8), `bytes` of shared memory (allowed past 48
// KB), at most `*clusters` clusters and no more than the card holds at
// once; sets *clusters to that count.
template <class K>
cudaError_t configure(K kernel, int ranks, int threads, size_t bytes,
                      cudaStream_t stream, cudaLaunchAttribute* attr,
                      cudaLaunchConfig_t* config, int* clusters) {
  cudaError_t err = cudaSuccess;
  if (bytes > 48 * 1024)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess && ranks > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = ranks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *config = cudaLaunchConfig_t{};
  config->gridDim = dim3(ranks * *clusters);
  config->blockDim = dim3(threads);
  config->dynamicSmemBytes = bytes;
  config->stream = stream;
  config->attrs = attr;
  config->numAttrs = 1;
  int held = 0;
  err = cudaOccupancyMaxActiveClusters(&held, kernel, config);
  if (err != cudaSuccess) return err;
  if (held <= 0) return cudaErrorInvalidValue;
  if (*clusters > held) {
    *clusters = held;
    config->gridDim = dim3(ranks * held);
  }
  return cudaSuccess;
}

}  // namespace row_cluster

// The PTX operations and cluster intrinsics that the kernels of this
// directory use beyond plain CUDA C++, one small device function each:
// cp.async (16 bytes a thread, commit / wait groups), ldmatrix (x2 and x4,
// transposed), mma.sync m16n8k16 (bf16 in, float accumulate), and a thread
// block cluster's rank, barrier and distributed shared memory.
//
// A compiler that is not nvcc gets the stand-ins of emulate/ptx.h in their
// place: the same functions, the same lane-to-element layouts, computed on
// the CPU, so that a kernel's fragment indices can be checked without a
// card (see ops/emulate.py).
//
// Fragment layouts (PTX ISA, "Matrix Fragments for mma.m16n8k16"), with
// g = lane / 4 and t = lane % 4; a register holds two bf16, the lower
// index in its low half:
//   A (16 x 16, M x K): a[0] = A[g][2t, 2t+1],      a[1] = A[g+8][2t, 2t+1],
//                       a[2] = A[g][2t+8, 2t+9],    a[3] = A[g+8][2t+8, 2t+9]
//   B (16 x 8,  K x N): b[0] = B[2t, 2t+1][g],      b[1] = B[2t+8, 2t+9][g]
//   C (16 x 8,  M x N): c[0], c[1] = C[g][2t, 2t+1],
//                       c[2], c[3] = C[g+8][2t, 2t+1]
// ldmatrix reads 8 x 8 matrices of b16 whose rows are 16 contiguous bytes;
// lanes 8i .. 8i+7 give the row addresses of matrix i. Transposed, lane
// (g, t) receives in r[i] the elements M_i[2t][g] and M_i[2t+1][g].

#pragma once

#include <stdint.h>

#ifdef __CUDACC__

#include <cooperative_groups.h>

namespace ptx {

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, past L1, without a register.
__device__ __forceinline__ void cp_async16(void* shared, const void* global) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   shared_address(shared)),
               "l"(global)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Until at most `pending` of this thread's newest groups are in flight.
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(shared_address(row))
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(shared_address(row))
      : "memory");
}

// c += a @ b on the tensor cores: 16 x 16 by 16 x 8, bf16 in, float out.
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The block's rank in its cluster, the cluster's barrier (every thread of
// every block; stores into another block's shared memory made before it
// are visible after it), and the address of `p`, a pointer into this
// block's shared memory, in the block of rank `rank`.
__device__ __forceinline__ int cluster_rank() {
  return (int)cooperative_groups::this_cluster().block_rank();
}
__device__ __forceinline__ void cluster_sync() {
  cooperative_groups::this_cluster().sync();
}
__device__ __forceinline__ float* cluster_map(float* p, int rank) {
  return cooperative_groups::this_cluster().map_shared_rank(p, rank);
}

}  // namespace ptx

#else
#include "emulate/ptx.h"
#endif

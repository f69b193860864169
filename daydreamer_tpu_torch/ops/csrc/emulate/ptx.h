// Stand-ins for hopper_ptx.cuh on the CPU (see emulate.h): the same
// functions with the same lane-to-element layouts. A copy that is
// asynchronous on the card is made at once here; a warp-wide instruction
// posts each lane's operands in the warp's words, meets the warp at its
// barrier and reads what the other lanes posted.
#pragma once

#include "emulate.h"

namespace ptx {

inline void cp_async16(void* shared, const void* global) {
  memcpy(shared, global, 16);
}
inline void cp_async_commit() {}
template <int pending> inline void cp_async_wait() {}

namespace detail {
inline int lane() { return threadIdx.x % 32; }
inline uint32_t pack(uint16_t low, uint16_t high) {
  return (uint32_t)low | ((uint32_t)high << 16);
}
inline float half_of(uint32_t reg, int high) {
  return __bfloat162float({(uint16_t)(high ? reg >> 16 : reg & 0xffff)});
}
// r[i] of a transposed ldmatrix over `count` matrices.
template <int count>
inline void ldmatrix_trans(uint32_t (&r)[count], const void* row) {
  const int g = lane() / 4, t = lane() % 4;
  emu::lanes[lane() * 8] = (uint64_t)(uintptr_t)row;
  emu::warp_barrier->arrive_and_wait();
  for (int i = 0; i < count; ++i) {
    auto at = [&](int k) {
      return reinterpret_cast<const uint16_t*>(
          (uintptr_t)emu::lanes[(8 * i + k) * 8])[g];
    };
    r[i] = pack(at(2 * t), at(2 * t + 1));
  }
  emu::warp_barrier->arrive_and_wait();
}
}  // namespace detail

inline void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  detail::ldmatrix_trans<4>(r, row);
}
inline void ldmatrix_x2_trans(uint32_t (&r)[2], const void* row) {
  detail::ldmatrix_trans<2>(r, row);
}

inline void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                           const uint32_t (&b)[2]) {
  const int g = detail::lane() / 4, t = detail::lane() % 4;
  uint64_t* mine = emu::lanes + detail::lane() * 8;
  for (int i = 0; i < 4; ++i) mine[i] = a[i];
  for (int i = 0; i < 2; ++i) mine[4 + i] = b[i];
  emu::warp_barrier->arrive_and_wait();
  for (int i = 0; i < 4; ++i) {
    const int m = g + (i >= 2 ? 8 : 0), n = 2 * t + (i & 1);
    float sum = c[i];
    for (int k = 0; k < 16; ++k) {
      const uint64_t* of_a = emu::lanes + ((m % 8) * 4 + (k % 8) / 2) * 8;
      const uint64_t* of_b = emu::lanes + (n * 4 + (k % 8) / 2) * 8;
      const uint32_t ra = (uint32_t)of_a[(m >= 8 ? 1 : 0) + (k >= 8 ? 2 : 0)];
      const uint32_t rb = (uint32_t)of_b[4 + (k >= 8 ? 1 : 0)];
      sum += detail::half_of(ra, k % 2) * detail::half_of(rb, k % 2);
    }
    c[i] = sum;
  }
  emu::warp_barrier->arrive_and_wait();
}

inline int cluster_rank() { return emu::cluster_rank; }
inline void cluster_sync() { emu::cluster_barrier->arrive_and_wait(); }
inline float* cluster_map(float* p, int rank) {
  return emu::cluster_smem[rank] + (p - emu::smem);
}

}  // namespace ptx

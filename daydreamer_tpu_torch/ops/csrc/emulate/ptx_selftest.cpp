// Holds the CPU stand-ins of ptx.h (mma, ldmatrix) to a plain product, so
// that a kernel checked under the emulation is checked against the
// documented fragment layouts of mma and ldmatrix. Built with g++ by
// ops/emulate.py (compile_selftest); one warp of 32 threads.
#include "../hopper_ptx.cuh"

namespace {

struct Args {
  const uint16_t* a;
  const uint16_t* b;
  float* d;
};

// d[16][8] = a[16][16] @ b[16][8], all row-major, the fragments filled
// element by element as the PTX ISA lays them out.
void fragments_kernel(Args p) {
  const int lane = threadIdx.x, g = lane / 4, t = lane % 4;
  auto A = [&](int m, int k) { return (uint32_t)p.a[m * 16 + k]; };
  auto B = [&](int k, int n) { return (uint32_t)p.b[k * 8 + n]; };
  const uint32_t a[4] = {
      A(g, 2 * t) | A(g, 2 * t + 1) << 16,
      A(g + 8, 2 * t) | A(g + 8, 2 * t + 1) << 16,
      A(g, 2 * t + 8) | A(g, 2 * t + 9) << 16,
      A(g + 8, 2 * t + 8) | A(g + 8, 2 * t + 9) << 16};
  const uint32_t b[2] = {B(2 * t, g) | B(2 * t + 1, g) << 16,
                         B(2 * t + 8, g) | B(2 * t + 9, g) << 16};
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  ptx::mma_bf16_16816(c, a, b);
  p.d[g * 8 + 2 * t] = c[0];
  p.d[g * 8 + 2 * t + 1] = c[1];
  p.d[(g + 8) * 8 + 2 * t] = c[2];
  p.d[(g + 8) * 8 + 2 * t + 1] = c[3];
}

// d[n][r] = sum_k w[k][n] * x[k][r] for w [16][16] and x [16][8], both with
// k as the slow axis, as imagine_mma.cuh holds a weight tile and a vector:
// both fragments come from transposed ldmatrix loads.
void ldmatrix_kernel(Args p) {
  const int lane = threadIdx.x, g = lane / 4, t = lane % 4;
  uint32_t a[4], b[2];
  ptx::ldmatrix_x4_trans(
      a, p.a + (lane % 8 + lane / 16 * 8) * 16 + lane / 8 % 2 * 8);
  ptx::ldmatrix_x2_trans(b, p.b + (lane % 16) * 8);
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  ptx::mma_bf16_16816(c, a, b);
  p.d[g * 8 + 2 * t] = c[0];
  p.d[g * 8 + 2 * t + 1] = c[1];
  p.d[(g + 8) * 8 + 2 * t] = c[2];
  p.d[(g + 8) * 8 + 2 * t + 1] = c[3];
}

}  // namespace

extern "C" void mma_fragments(const uint16_t* a, const uint16_t* b, float* d) {
  emu::launch(1, fragments_kernel, 1, 32, 0, nullptr, Args{a, b, d});
}
extern "C" void mma_ldmatrix(const uint16_t* w, const uint16_t* x, float* d) {
  emu::launch(1, ldmatrix_kernel, 1, 32, 0, nullptr, Args{w, x, d});
}

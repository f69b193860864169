// Box-constrained convex QP solver via ADMM, C ABI for ctypes.
//
// Fills the role of the reference's vendored OSQP/qpOASES (reference:
// third_party/osqp, third_party/qpoases), which back the whole-body MPC
// stance controller examples: minimize 0.5 x'Px + q'x  s.t. lo <= x <= hi.
// ADMM with over-relaxation; P must be positive semidefinite. Dense,
// single-threaded: MPC horizon problems here are <100 variables.
//
// Build: g++ -O2 -shared -fPIC -o libqp_solver.so qp_solver.cpp

#include <cmath>
#include <cstring>

#include <vector>

namespace {

// Solve (P + rho I) x = b via Cholesky; factor once per call.
bool cholesky(std::vector<double>& a, int n) {
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j <= i; ++j) {
      double sum = a[i * n + j];
      for (int k = 0; k < j; ++k) sum -= a[i * n + k] * a[j * n + k];
      if (i == j) {
        if (sum <= 0.0) return false;
        a[i * n + i] = std::sqrt(sum);
      } else {
        a[i * n + j] = sum / a[j * n + j];
      }
    }
  }
  return true;
}

void chol_solve(const std::vector<double>& l, const double* b, double* x,
                int n) {
  std::vector<double> y(n);
  for (int i = 0; i < n; ++i) {
    double sum = b[i];
    for (int k = 0; k < i; ++k) sum -= l[i * n + k] * y[k];
    y[i] = sum / l[i * n + i];
  }
  for (int i = n - 1; i >= 0; --i) {
    double sum = y[i];
    for (int k = i + 1; k < n; ++k) sum -= l[k * n + i] * x[k];
    x[i] = sum / l[i * n + i];
  }
}

}  // namespace

extern "C" {

// Returns iterations used on success, -1 on factorization failure.
int qp_solve_box(const double* p_mat, const double* q, const double* lo,
                 const double* hi, int n, double* x_out, int max_iter,
                 double rho, double eps) {
  std::vector<double> kkt(n * n);
  for (int i = 0; i < n * n; ++i) kkt[i] = p_mat[i];
  for (int i = 0; i < n; ++i) kkt[i * n + i] += rho;
  if (!cholesky(kkt, n)) return -1;

  std::vector<double> x(n, 0.0), z(n, 0.0), u(n, 0.0), rhs(n), xz(n);
  const double alpha = 1.6;  // Over-relaxation.
  for (int iter = 0; iter < max_iter; ++iter) {
    // x-update: (P + rho I) x = rho (z - u) - q.
    for (int i = 0; i < n; ++i) rhs[i] = rho * (z[i] - u[i]) - q[i];
    chol_solve(kkt, rhs.data(), x.data(), n);
    // z-update with projection onto the box.
    double primal_res = 0.0, dual_res = 0.0;
    for (int i = 0; i < n; ++i) {
      const double xh = alpha * x[i] + (1 - alpha) * z[i];
      const double z_old = z[i];
      double zi = xh + u[i];
      if (zi < lo[i]) zi = lo[i];
      if (zi > hi[i]) zi = hi[i];
      z[i] = zi;
      u[i] += xh - zi;
      primal_res += (x[i] - z[i]) * (x[i] - z[i]);
      dual_res += rho * rho * (z[i] - z_old) * (z[i] - z_old);
    }
    if (primal_res < eps * eps && dual_res < eps * eps) {
      std::memcpy(x_out, z.data(), n * sizeof(double));
      return iter + 1;
    }
  }
  std::memcpy(x_out, z.data(), n * sizeof(double));
  return max_iter;
}

// General linearly-constrained QP (the OSQP problem class the reference
// vendors for its MPC formulations):
//   minimize 0.5 x'Px + q'x   subject to  l <= A x <= u
// ADMM splitting on z = Ax (OSQP-style):
//   x-step: (P + sigma I + rho A'A) x = sigma x_prev - q + A'(rho z - y)
//   z-step: clip(Ax + y/rho, l, u),  y += rho (Ax - z)
// Dense single-threaded; MPC stance problems are n<=12, m<=30.
// Returns iterations used on success, -1 on factorization failure.
int qp_solve(const double* p_mat, const double* q, const double* a_mat,
             const double* lo, const double* hi, int n, int m,
             double* x_out, int max_iter, double rho, double eps) {
  const double sigma = 1e-6;
  std::vector<double> kkt(n * n);
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < n; ++j) {
      double v = p_mat[i * n + j];
      for (int k = 0; k < m; ++k) {
        v += rho * a_mat[k * n + i] * a_mat[k * n + j];
      }
      kkt[i * n + j] = v;
    }
    kkt[i * n + i] += sigma;
  }
  if (!cholesky(kkt, n)) return -1;

  std::vector<double> x(n, 0.0), z(m, 0.0), y(m, 0.0);
  std::vector<double> rhs(n), ax(m);
  for (int iter = 0; iter < max_iter; ++iter) {
    // x-step.
    for (int i = 0; i < n; ++i) {
      double v = sigma * x[i] - q[i];
      for (int k = 0; k < m; ++k) {
        v += a_mat[k * n + i] * (rho * z[k] - y[k]);
      }
      rhs[i] = v;
    }
    chol_solve(kkt, rhs.data(), x.data(), n);
    // z-step + dual update, with residual tracking.
    double primal_res = 0.0, dual_res = 0.0;
    for (int k = 0; k < m; ++k) {
      double v = 0.0;
      for (int i = 0; i < n; ++i) v += a_mat[k * n + i] * x[i];
      ax[k] = v;
      double zk = v + y[k] / rho;
      if (zk < lo[k]) zk = lo[k];
      if (zk > hi[k]) zk = hi[k];
      const double z_old = z[k];
      z[k] = zk;
      y[k] += rho * (v - zk);
      primal_res += (v - zk) * (v - zk);
      dual_res += rho * rho * (zk - z_old) * (zk - z_old);
    }
    if (primal_res < eps * eps && dual_res < eps * eps) {
      std::memcpy(x_out, x.data(), n * sizeof(double));
      return iter + 1;
    }
  }
  std::memcpy(x_out, x.data(), n * sizeof(double));
  return max_iter;
}

}  // extern "C"

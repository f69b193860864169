"""Python wrapper for the native box-QP solver (MPC stance controller
backend; reference role: third_party/osqp + qpoases)."""

import ctypes

import numpy as np

from .build import load


def solve_box_qp(P, q, lo, hi, max_iter=500, rho=1.0, eps=1e-6):
  """minimize 0.5 x'Px + q'x subject to lo <= x <= hi.

  Returns (x, iterations). P must be symmetric PSD."""
  lib = load('qp_solver')
  P = np.ascontiguousarray(P, np.float64)
  q = np.ascontiguousarray(q, np.float64)
  lo = np.ascontiguousarray(lo, np.float64)
  hi = np.ascontiguousarray(hi, np.float64)
  n = len(q)
  assert P.shape == (n, n), P.shape
  x = np.zeros(n, np.float64)
  dptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
  iters = lib.qp_solve_box(
      dptr(P), dptr(q), dptr(lo), dptr(hi), n, dptr(x), max_iter, rho, eps)
  if iters < 0:
    raise RuntimeError('QP factorization failed (P not PSD?).')
  return x, iters


def solve_qp(P, q, A, lo, hi, max_iter=2000, rho=1.0, eps=1e-7):
  """minimize 0.5 x'Px + q'x subject to lo <= A x <= hi.

  The general OSQP problem class (equality rows: lo == hi). Returns
  (x, iterations). P must be symmetric PSD."""
  lib = load('qp_solver')
  P = np.ascontiguousarray(P, np.float64)
  q = np.ascontiguousarray(q, np.float64)
  A = np.ascontiguousarray(A, np.float64)
  lo = np.ascontiguousarray(lo, np.float64)
  hi = np.ascontiguousarray(hi, np.float64)
  n = len(q)
  m = len(lo)
  assert P.shape == (n, n), P.shape
  assert A.shape == (m, n), (A.shape, m, n)
  assert hi.shape == (m,), hi.shape
  x = np.zeros(n, np.float64)
  dptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
  iters = lib.qp_solve(
      dptr(P), dptr(q), dptr(A), dptr(lo), dptr(hi), n, m, dptr(x),
      max_iter, rho, eps)
  if iters < 0:
    raise RuntimeError('QP factorization failed (P not PSD?).')
  return x, iters

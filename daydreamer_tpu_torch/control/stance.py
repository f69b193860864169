"""Stance-leg torque controller: contact-force QP mapped through leg
Jacobians.

Covers the reference stack's ``torque_stance_leg_controller_quadprog``
role (reference: motion_imitation/examples/whole_body_controller_example.py:
25-27, backed by the vendored QP solvers): a PD law on body height,
attitude, and velocity produces a desired 6-D wrench; a friction-pyramid
QP distributes it over the current stance feet; leg torques follow from
tau = J^T f.  The QP runs in the native ADMM solver
(native/qp_solver.cpp), the TPU-repo counterpart of the
reference's vendored OSQP/qpOASES.
"""

import numpy as np

from . import kinematics

GRAVITY = 9.81


def _skew(v):
  return np.array([
      [0, -v[2], v[1]],
      [v[2], 0, -v[0]],
      [-v[1], v[0], 0]])


class StanceForceController:

  def __init__(self, gait, mass=12.0, inertia=(0.07, 0.26, 0.28),
               desired_height=0.26, friction=0.45, max_normal_force=150.0,
               kp_height=120.0, kd_height=20.0, kp_attitude=80.0,
               kd_attitude=10.0, kd_velocity=12.0):
    self._gait = gait
    self._mass = mass
    self._inertia = np.diag(inertia)
    self._height = desired_height
    self._mu = friction
    self._fmax = max_normal_force
    self._kp_h = kp_height
    self._kd_h = kd_height
    self._kp_a = kp_attitude
    self._kd_a = kd_attitude
    self._kd_v = kd_velocity

  def desired_wrench(self, height, roll, pitch, velocity, angular_velocity,
                     desired_velocity, desired_yaw_rate):
    """PD law -> desired [force; torque] on the trunk, trunk-yaw frame."""
    acc = np.zeros(3)
    acc[0] = self._kd_v * (desired_velocity[0] - velocity[0])
    acc[1] = self._kd_v * (desired_velocity[1] - velocity[1])
    acc[2] = (self._kp_h * (self._height - height)
              + self._kd_h * (0.0 - velocity[2]))
    ang_acc = np.array([
        self._kp_a * (0.0 - roll) + self._kd_a * (0.0 - angular_velocity[0]),
        self._kp_a * (0.0 - pitch) + self._kd_a * (0.0 - angular_velocity[1]),
        self._kd_a * (desired_yaw_rate - angular_velocity[2])])
    force = self._mass * (acc + np.array([0.0, 0.0, GRAVITY]))
    torque = self._inertia @ ang_acc
    return np.concatenate([force, torque])

  def _pyramid(self, n_legs):
    rows = 5 * n_legs
    G = np.zeros((rows, 3 * n_legs))
    lo = np.zeros(rows)
    hi = np.zeros(rows)
    big = 1e20
    for i in range(n_legs):
      r, c = 5 * i, 3 * i
      G[r + 0, c + 0], G[r + 0, c + 2] = 1.0, -self._mu
      G[r + 1, c + 0], G[r + 1, c + 2] = -1.0, -self._mu
      G[r + 2, c + 1], G[r + 2, c + 2] = 1.0, -self._mu
      G[r + 3, c + 1], G[r + 3, c + 2] = -1.0, -self._mu
      G[r + 4, c + 2] = 1.0
      lo[r:r + 4] = -big
      hi[r:r + 4] = 0.0
      lo[r + 4], hi[r + 4] = 0.0, self._fmax
    return G, lo, hi

  def contact_forces(self, wrench, foot_positions, stance_legs,
                     regularization=1e-4):
    """Distribute `wrench` over `stance_legs` ground-reaction forces.

    foot_positions: 4x3 trunk-relative. Returns a dict leg -> 3 forces
    (reaction on the robot, trunk frame)."""
    from ..native.qp import solve_qp
    n = len(stance_legs)
    if not n:
      return {}
    A = np.zeros((6, 3 * n))
    for i, leg in enumerate(stance_legs):
      A[:3, 3 * i: 3 * i + 3] = np.eye(3)
      A[3:, 3 * i: 3 * i + 3] = _skew(foot_positions[leg])
    # Prefer even load sharing: regularize toward weight/n on each fz.
    ref = np.zeros(3 * n)
    ref[2::3] = wrench[2] / n
    P = 2 * (A.T @ A + regularization * np.eye(3 * n))
    q = 2 * (-A.T @ wrench - regularization * ref)
    G, lo, hi = self._pyramid(n)
    forces, _ = solve_qp(P, q, G, lo, hi)
    return {leg: forces[3 * i: 3 * i + 3]
            for i, leg in enumerate(stance_legs)}

  def leg_torques(self, motor_angles, forces):
    """tau = J^T (-f): joint torques exerting -f on the ground so the
    reaction f acts on the trunk. Returns dict leg -> 3 torques."""
    q = np.asarray(motor_angles).reshape(4, 3)
    torques = {}
    for leg, force in forces.items():
      jac = kinematics.foot_jacobian(leg, q[leg])
      torques[leg] = jac.T @ (-np.asarray(force))
    return torques

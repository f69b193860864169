"""Analytic A1 leg kinematics for the whole-body controller.

Hip-relative forward kinematics, closed-form inverse kinematics, and the
3x3 foot Jacobian for one 3-DoF leg (hip roll, thigh pitch, calf pitch),
in the trunk frame (x forward, y left, z up).  Serves the role of the
kinematics inside the reference's robot classes used by its external
``mpc_controller`` stack (reference:
motion_imitation/examples/whole_body_controller_example.py:26-27); the
geometry matches the MuJoCo A1 model in ``envs/a1_model.py`` (vendor
kinematics: thigh offset 0.08505 m, link lengths 0.2 m).
"""

import math

import numpy as np

from ..envs import a1_model

L1 = a1_model.THIGH_LEN
L2 = a1_model.CALF_LEN
D = a1_model.THIGH_OFFSET

# (x, y) signs of each leg's hip on the trunk, in a1_model.LEGS order
# (FR, FL, RR, RL).
LEG_SIGNS = [(sx, sy) for _, sx, sy in a1_model.LEGS]
HIP_OFFSETS = np.array([
    [sx * a1_model.HIP_X, sy * a1_model.HIP_Y, 0.0] for sx, sy in LEG_SIGNS])


def _rx(angle):
  c, s = math.cos(angle), math.sin(angle)
  return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def foot_position(leg, q):
  """Foot position relative to the leg's hip joint, trunk frame.

  `leg` indexes a1_model.LEGS; `q` = (hip roll, thigh pitch, calf pitch).
  """
  q1, q2, q3 = q
  d = LEG_SIGNS[leg][1] * D
  planar = np.array([
      -L1 * math.sin(q2) - L2 * math.sin(q2 + q3),
      d,
      -L1 * math.cos(q2) - L2 * math.cos(q2 + q3)])
  return _rx(q1) @ planar


def foot_ik(leg, target):
  """Joint angles that place the foot at `target` (hip-relative, trunk
  frame). Unreachable targets are projected onto the workspace boundary."""
  px, py, pz = target
  d = LEG_SIGNS[leg][1] * D
  planar_sq = py * py + pz * pz - d * d
  z_p = -math.sqrt(max(planar_sq, 1e-12))
  q1 = math.atan2(pz, py) - math.atan2(z_p, d)
  # Wrap the roll into the joint's working range around zero.
  q1 = (q1 + math.pi) % (2 * math.pi) - math.pi
  # In-plane 2R: u points forward, w points down from the hip.
  u, w = -px, -z_p
  r_sq = u * u + w * w
  cos_inner = (L1 * L1 + L2 * L2 - r_sq) / (2 * L1 * L2)
  q3 = math.acos(min(1.0, max(-1.0, cos_inner))) - math.pi
  q2 = math.atan2(u, w) - math.atan2(
      L2 * math.sin(q3), L1 + L2 * math.cos(q3))
  return np.array([q1, q2, q3])


def foot_jacobian(leg, q):
  """d(foot position)/d(q): 3x3, trunk frame, hip-relative."""
  q1, q2, q3 = q
  d = LEG_SIGNS[leg][1] * D
  s2, c2 = math.sin(q2), math.cos(q2)
  s23, c23 = math.sin(q2 + q3), math.cos(q2 + q3)
  planar = np.array([
      -L1 * s2 - L2 * s23, d, -L1 * c2 - L2 * c23])
  dplanar_dq2 = np.array([-L1 * c2 - L2 * c23, 0.0, L1 * s2 + L2 * s23])
  dplanar_dq3 = np.array([-L2 * c23, 0.0, L2 * s23])
  rot = _rx(q1)
  c1, s1 = math.cos(q1), math.sin(q1)
  drot = np.array([[0, 0, 0], [0, -s1, -c1], [0, c1, -s1]])
  jac = np.empty((3, 3))
  jac[:, 0] = drot @ planar
  jac[:, 1] = rot @ dplanar_dq2
  jac[:, 2] = rot @ dplanar_dq3
  return jac


def all_foot_positions(motor_angles):
  """4x3 foot positions relative to the trunk origin, trunk frame."""
  q = np.asarray(motor_angles).reshape(4, 3)
  return np.stack([
      HIP_OFFSETS[leg] + foot_position(leg, q[leg]) for leg in range(4)])

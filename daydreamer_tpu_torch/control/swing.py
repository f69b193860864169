"""Raibert-style swing-leg controller.

Covers the reference stack's ``raibert_swing_leg_controller`` role
(reference: motion_imitation/examples/whole_body_controller_example.py:24,
117-124: foot placement from stance duration and a velocity feedback gain,
with a ground-clearance swing arc).  At lift-off the controller latches
the foot's current position; during swing it blends that start toward a
Raibert touchdown target

    p_td = p_hip_proj + v * T_stance / 2 + k * (v - v_des)

with a parabolic height profile peaking at ``clearance`` above the
touchdown height.  Targets are converted to joint angles with the
closed-form leg IK.
"""

import numpy as np

from . import kinematics


class RaibertSwingController:

  def __init__(self, gait, desired_height=0.26, clearance=0.04,
               feedback_gain=0.03):
    self._gait = gait
    self._height = desired_height
    self._clearance = clearance
    self._kv = feedback_gain
    self._start = {}     # leg -> hip-relative lift-off foot position.
    self._was_swing = [False] * 4

  def reset(self):
    self._start.clear()
    self._was_swing = [False] * 4

  def touchdown_target(self, leg, velocity, desired_velocity, yaw_rate,
                       desired_yaw_rate):
    """Hip-relative Raibert touchdown point (trunk frame)."""
    # Yaw contributes a tangential velocity at the hip lever arm.
    hip = kinematics.HIP_OFFSETS[leg]
    vel_at_hip = np.array([
        velocity[0] - yaw_rate * hip[1],
        velocity[1] + yaw_rate * hip[0]])
    des_at_hip = np.array([
        desired_velocity[0] - desired_yaw_rate * hip[1],
        desired_velocity[1] + desired_yaw_rate * hip[0]])
    t_stance = self._gait.stance_duration[leg]
    xy = vel_at_hip * t_stance / 2 + self._kv * (vel_at_hip - des_at_hip)
    return np.array([xy[0], xy[1] + kinematics.LEG_SIGNS[leg][1]
                     * kinematics.D, -self._height])

  def joint_targets(self, motor_angles, velocity, desired_velocity,
                    yaw_rate, desired_yaw_rate):
    """(leg index -> 3 joint targets) for every swing leg."""
    q = np.asarray(motor_angles).reshape(4, 3)
    targets = {}
    for leg in self._gait.swing_legs():
      phase = self._gait.legs[leg].phase
      if not self._was_swing[leg] or leg not in self._start:
        self._start[leg] = kinematics.foot_position(leg, q[leg])
      start = self._start[leg]
      end = self.touchdown_target(
          leg, velocity, desired_velocity, yaw_rate, desired_yaw_rate)
      # Faster horizontal motion early in swing (cosine ease), parabolic
      # vertical arc peaking mid-swing at `clearance` above touchdown.
      ease = (1 - np.cos(np.pi * min(phase, 1.0))) / 2
      foot = start + ease * (end - start)
      foot[2] = (start[2] + ease * (end[2] - start[2])
                 + self._clearance * 4 * phase * (1 - phase))
      targets[leg] = kinematics.foot_ik(leg, foot)
    for leg in range(4):
      self._was_swing[leg] = leg in targets
    return targets

"""Clip-tracking imitation task on the MuJoCo A1.

Re-implements the reference's imitation task structure (reference:
motion_imitation/envs/env_wrappers/imitation_task.py:1-1215 — pose /
velocity / root tracking rewards with exponential kernels, phase
observation, and deviation-based early termination from
imitation_terminal_conditions.py) on this framework's MuJoCo A1 robot
(envs/a1_model.py).
"""

import numpy as np

from ..envs import a1_model
from ..envs.a1 import A1
from .motion_clip import synthesize_gait

# Reward mixture weights; same structure as the reference's
# imitation_task.py (pose/velocity/root terms with exp kernels).
WEIGHTS = dict(pose=0.5, velocity=0.1, height=0.15, upright=0.25)
SCALES = dict(pose=2.0, velocity=0.005, height=20.0, upright=5.0)

# A1 joint-space stance the synthetic gait swings around (radians,
# (abduction, thigh, calf) per leg — the clip's per-leg (hold, swing,
# lift) channels land on (abduction, thigh, calf), which is exactly the
# A1 actuation layout).
A1_GAIT_STANCE = np.array([0.0, 0.9, -1.8] * 4)
A1_GAIT_HEIGHT = 0.28


def a1_gait_clip(gait='trot', **kwargs):
  kwargs.setdefault('standing_pose', A1_GAIT_STANCE)
  kwargs.setdefault('height', A1_GAIT_HEIGHT)
  kwargs.setdefault('swing_amp', 0.3)
  kwargs.setdefault('lift_amp', 0.2)
  return synthesize_gait(gait, **kwargs)


class ImitationA1(A1):
  """A1 sim whose reward tracks a reference motion clip.

  The vector observation is the base env's proprio vector extended with
  the clip phase (sin, cos) and the 12 target joint angles at the
  current sim time, mirroring the reference's target-pose observations
  (imitation_task.py builds future target frames into the obs).
  """

  TARGET_FEATURES = 14  # sin/cos phase + 12 target joints.

  def __init__(self, clip=None, gait='trot', repeat=20, length=1000,
               render_images=False, size=(64, 64), terminate_on_fall=True,
               seed=None):
    self._clip = clip or a1_gait_clip(gait)
    self._terminate_on_fall = terminate_on_fall
    super().__init__('sim', repeat=repeat, length=length,
                     render_images=render_images, size=size, seed=seed)
    self._vec_dim += self.TARGET_FEATURES

  def _clip_time(self):
    # Episode time from the env step counter (zero at every reset), like
    # the reference's phase bookkeeping; robot.data.time accumulates
    # across episodes and reset settling.
    return self._step_count * self._repeat * a1_model.SIM_TIMESTEP

  def _target_features(self):
    t = self._clip_time()
    phase = 2 * np.pi * self._clip.phase(t)
    target = self._clip.joints_at(t)
    return np.concatenate([[np.sin(phase), np.cos(phase)], target])

  def _obs(self, vector, reward, **kwargs):
    vector = np.concatenate(
        [np.asarray(vector, np.float32),
         self._target_features().astype(np.float32)])
    return super()._obs(vector, reward, **kwargs)

  def _fallen(self):
    robot = self._robot
    upright = robot.rot_mat[2, 2]
    height = robot.data.qpos[2]
    return upright < 0.0 or height < 0.12

  def _shaped_reward(self):
    robot = self._robot
    t = self._clip_time()
    target_q = self._clip.joints_at(t)
    target_qd = self._clip.joint_velocity_at(t)
    target_h = self._clip.pose_at(t)[2]
    q = robot.motor_angles
    qd = robot.motor_velocities
    r_pose = np.exp(-SCALES['pose'] * np.sum((q - target_q) ** 2))
    r_vel = np.exp(-SCALES['velocity'] * np.sum((qd - target_qd) ** 2))
    height = robot.data.qpos[2]
    r_height = np.exp(-SCALES['height'] * (height - target_h) ** 2)
    upright = robot.rot_mat[2, 2]
    r_upr = np.exp(-SCALES['upright'] * (1.0 - max(upright, 0.0)) ** 2)
    return float(WEIGHTS['pose'] * r_pose + WEIGHTS['velocity'] * r_vel +
                 WEIGHTS['height'] * r_height + WEIGHTS['upright'] * r_upr)

  def step(self, action):
    obs = super().step(action)
    if obs['is_first']:
      return obs
    # Replace the RMA forward-velocity reward with clip tracking.
    obs = dict(obs, reward=np.float32(self._shaped_reward()))
    if (self._terminate_on_fall and not self._done and self._fallen()):
      self._done = True
      obs = dict(obs, is_last=True, is_terminal=True)
    return obs

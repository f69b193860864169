"""A1 quadruped locomotion environment.

Capability parity with the reference A1 stack (reference:
embodied/envs/a1.py:7-38 + motion_imitation env_builder.py:28-90): a
12-actuator quadruped with proprioceptive 'vector' observations (12 motor
angles + IMU roll/pitch/rates), a 64x64 rendered 'image', continuous
12-dim actions mapped to joint-position targets around the usable motor
ranges, and the exact RMA stand+walk reward
(r_upr + r_hip + r_sho + r_kne + 10*(r_vel+1)/2, reference:
motion_imitation/envs/env_wrappers/rma_task.py:6-56, unscaled).

Backend: the reference simulated with PyBullet; this build uses a
MuJoCo-native Unitree A1 model with the same vendor kinematics, PD motor
pipeline, action filter/interpolation, and SafeJointsReset (see
a1_model.py). 'a1_real' hooks a UDP driver with the same surface (see
native/ for the C++ robot interface).
"""

import functools

import numpy as np

from ..core import base
from ..core import space as spacelib

# Proprio dim: 12 motor angles + IMU [roll, pitch, droll, dpitch]
# (reference env_builder.py:62-73 sensor suite).
VECTOR_DIM = 16


class A1(base.Env):

  def __init__(self, task, repeat=1, length=1000, render_images=True,
               size=(64, 64), seed=None, sensor_latency=0.0):
    assert task in ('sim', 'real', 'dummy'), task
    self._task = task
    self._repeat = repeat
    self._length = length
    self._render_images = render_images
    self._size = tuple(size)
    self._step_count = 0
    self._done = True
    self._act_dim = 12
    self._vec_dim = VECTOR_DIM
    if task == 'sim':
      from .a1_model import A1Robot, RMATask
      self._robot = A1Robot(
          action_repeat=repeat, render_size=self._size, seed=seed,
          sensor_latency=sensor_latency)
      self._reward_fn = RMATask()
    elif task == 'real':
      from .drivers.a1_driver import A1Driver
      self._env = A1Driver()
      self._vec_dim = self._env.obs_dim
    else:  # dummy: spaces only, for learner-side construction.
      self._env = None

  @functools.cached_property
  def obs_space(self):
    return {
        'vector': spacelib.Space(np.float32, (self._vec_dim,)),
        'image': spacelib.Space(np.uint8, self._size + (3,)),
        'reward': spacelib.Space(np.float32),
        'is_first': spacelib.Space(bool),
        'is_last': spacelib.Space(bool),
        'is_terminal': spacelib.Space(bool),
    }

  @functools.cached_property
  def act_space(self):
    return {
        'action': spacelib.Space(np.float32, (self._act_dim,), -1.0, 1.0),
        'reset': spacelib.Space(bool),
    }

  def step(self, action):
    if self._task == 'dummy':
      return self._dummy_step(action)
    if action['reset'] or self._done:
      self._done = False
      self._step_count = 0
      if self._task == 'sim':
        self._robot.reset()
        return self._obs(self._robot.observation(), 0.0, is_first=True)
      else:
        obs = self._env.reset()
        return self._obs(obs, 0.0, is_first=True)
    act = np.clip(np.asarray(action['action'], np.float32), -1, 1)
    # Length counts env (driver) steps; `repeat` sub-steps the physics at
    # 1 kHz inside the robot (reference LocomotionGymEnv action repeat).
    if self._task == 'sim':
      self._robot.apply_action(act)
      # Reward accrues ONCE per env step, after the repeat, exactly like
      # the reference task callback (locomotion_gym_env.py:299-330).
      reward = self._reward_fn(self._robot)
      self._step_count += 1
      self._done = self._step_count >= self._length
      return self._obs(
          self._robot.observation(), reward, is_last=self._done,
          is_terminal=False)
    else:
      obs, reward = self._env.apply(act, self._repeat)
      self._step_count += 1
      self._done = self._step_count >= self._length
      return self._obs(obs, reward, is_last=self._done, is_terminal=False)

  def _obs(self, vector, reward, is_first=False, is_last=False,
           is_terminal=False):
    if self._task == 'sim' and self._render_images:
      image = self._robot.render(self._size)
    else:
      image = np.zeros(self._size + (3,), np.uint8)
    return dict(
        vector=np.asarray(vector, np.float32),
        image=np.asarray(image, np.uint8),
        reward=np.float32(reward),
        is_first=is_first,
        is_last=is_last,
        is_terminal=is_terminal,
    )

  def _dummy_step(self, action):
    if action['reset'] or self._done:
      self._done = False
      self._step_count = 0
      return self._zero_obs(is_first=True)
    self._step_count += 1
    self._done = self._step_count >= self._length
    return self._zero_obs(is_last=self._done)

  def _zero_obs(self, is_first=False, is_last=False):
    return dict(
        vector=np.zeros(self._vec_dim, np.float32),
        image=np.zeros(self._size + (3,), np.uint8),
        reward=np.float32(0.0),
        is_first=is_first,
        is_last=is_last,
        is_terminal=False,
    )

  def close(self):
    if self._task == 'sim':
      self._robot.close()
    elif self._task == 'real':
      self._env.close()

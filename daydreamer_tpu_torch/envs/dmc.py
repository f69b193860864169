"""dm_control adapter (reference: embodied/envs/dmc.py:7-110)."""

import functools
import os

import numpy as np

from ..core import base
from ..core import space as spacelib
from . import gym as gymlib


class DMC(base.Env):

  DEFAULT_CAMERAS = dict(
      locom_rodent=1,
      quadruped=2,
  )

  def __init__(self, env, repeat=1, size=(64, 64), camera=-1, render=True):
    os.environ['MUJOCO_GL'] = os.environ.get('MUJOCO_GL', 'egl')
    if isinstance(env, str):
      domain, task = env.split('_', 1)
      if camera == -1:
        camera = self.DEFAULT_CAMERAS.get(domain, 0)
      if domain == 'cup':  # Only domain with multiple words.
        domain = 'ball_in_cup'
      if domain == 'manip':
        from dm_control import manipulation
        env = manipulation.load(task + '_vision')
      elif domain == 'locom':
        from dm_control.locomotion.examples import basic_rodent_2020
        env = getattr(basic_rodent_2020, task)()
      else:
        from dm_control import suite
        env = suite.load(domain, task)
    self._dmenv = env
    self._env = FromDM(self._dmenv)
    from ..core import wrappers
    self._env = wrappers.ActionRepeat(self._env, repeat)
    self._size = size
    self._camera = camera
    # Proprio configs can skip the per-step camera render (software EGL
    # costs ~25ms/frame on CPU-only hosts and the image is unused); the
    # reference renders unconditionally, so render=True stays default.
    self._render = render

  @functools.cached_property
  def obs_space(self):
    spaces = dict(self._env.obs_space)
    if self._render:
      spaces['image'] = spacelib.Space(np.uint8, self._size + (3,))
    return spaces

  @functools.cached_property
  def act_space(self):
    return self._env.act_space

  def step(self, action):
    for key, space in self.act_space.items():
      if not space.discrete:
        assert np.isfinite(action[key]).all(), (key, action[key])
    obs = self._env.step(action)
    if self._render:
      obs['image'] = self.render()
    return obs

  def render(self):
    return self._dmenv.physics.render(*self._size, camera_id=self._camera)


class FromDM(base.Env):

  def __init__(self, env):
    self._env = env
    obs_spec = self._env.observation_spec()
    act_spec = self._env.action_spec()
    self._obs_dict = isinstance(obs_spec, dict)
    self._act_dict = isinstance(act_spec, dict)
    self._obs_key = 'observation' if not self._obs_dict else None
    self._act_key = 'action' if not self._act_dict else None
    self._done = True

  @functools.cached_property
  def obs_space(self):
    spec = self._env.observation_spec()
    if not self._obs_dict:
      spec = {self._obs_key: spec}
    result = {
        'reward': spacelib.Space(np.float32),
        'is_first': spacelib.Space(bool),
        'is_last': spacelib.Space(bool),
        'is_terminal': spacelib.Space(bool),
    }
    for key, value in spec.items():
      result[key] = self._convert(value)
    return result

  @functools.cached_property
  def act_space(self):
    spec = self._env.action_spec()
    if not self._act_dict:
      spec = {self._act_key: spec}
    result = {'reset': spacelib.Space(bool)}
    for key, value in spec.items():
      result[key] = self._convert(value)
    return result

  def step(self, action):
    action = action.copy()
    reset = action.pop('reset')
    if reset or self._done:
      time_step = self._env.reset()
    else:
      if not self._act_dict:
        action = action[self._act_key]
      time_step = self._env.step(action)
    self._done = time_step.last()
    return self._obs(time_step)

  def _obs(self, time_step):
    if not time_step.first():
      assert time_step.discount in (0, 1), time_step.discount
    obs = time_step.observation
    obs = dict(obs) if self._obs_dict else {self._obs_key: obs}
    return dict(
        reward=np.float32(0.0 if time_step.first() else time_step.reward),
        is_first=time_step.first(),
        is_last=time_step.last(),
        is_terminal=False if time_step.first() else time_step.discount == 0,
        **obs,
    )

  def _convert(self, space):
    if hasattr(space, 'num_values'):
      return spacelib.Space(np.int32, (), 0, space.num_values)
    if hasattr(space, 'minimum'):
      assert np.isfinite(space.minimum).all() == np.isfinite(
          space.maximum).all()
      return spacelib.Space(
          space.dtype, space.shape, space.minimum, space.maximum)
    return spacelib.Space(space.dtype, space.shape)

"""Crafter adapter with achievement logging (reference: embodied/envs/crafter.py:5-72)."""

import functools

import numpy as np

from ..core import base
from ..core import space as spacelib


class Crafter(base.Env):

  def __init__(self, task, size=(64, 64), outdir=None):
    assert task in ('reward', 'noreward')
    import crafter
    self._env = crafter.Env(size=size, reward=(task == 'reward'))
    self._logs = None
    if outdir:
      from ..core import path as pathlib
      outdir = pathlib.Path(outdir)
      outdir.mkdirs()
      self._env = crafter.Recorder(
          self._env, str(outdir),
          save_stats=True, save_video=False, save_episode=False)
    self._achievements = crafter.constants.achievements.copy()
    self._done = True

  @functools.cached_property
  def obs_space(self):
    spaces = {
        'image': spacelib.Space(np.uint8, self._env.observation_space.shape),
        'reward': spacelib.Space(np.float32),
        'is_first': spacelib.Space(bool),
        'is_last': spacelib.Space(bool),
        'is_terminal': spacelib.Space(bool),
        'log_reward': spacelib.Space(np.float32),
    }
    spaces.update({
        f'log_achievement_{k}': spacelib.Space(np.int32)
        for k in self._achievements})
    return spaces

  @functools.cached_property
  def act_space(self):
    return {
        'action': spacelib.Space(np.int32, (), 0, self._env.action_space.n),
        'reset': spacelib.Space(bool),
    }

  def step(self, action):
    if action['reset'] or self._done:
      self._done = False
      image = self._env.reset()
      return self._obs(image, 0.0, {})
    image, reward, self._done, info = self._env.step(action['action'])
    return self._obs(
        image, reward, info,
        is_last=self._done,
        is_terminal=info['discount'] == 0)

  def _obs(self, image, reward, info,
           is_first=False, is_last=False, is_terminal=False):
    log_achievements = {
        f'log_achievement_{k}': info['achievements'][k] if info else 0
        for k in self._achievements}
    return dict(
        image=image,
        reward=np.float32(reward),
        is_first=is_first,
        is_last=is_last,
        is_terminal=is_terminal,
        log_reward=np.float32(info['reward'] if info else 0.0),
        **log_achievements,
    )

  def render(self):
    return self._env.render()

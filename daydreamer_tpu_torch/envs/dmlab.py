"""DeepMind Lab adapter (reference: embodied/envs/dmlab.py). Import-gated."""

import functools

import numpy as np

from ..core import base
from ..core import space as spacelib


class DMLab(base.Env):

  ACTION_SET = (
      (0, 0, 0, 1, 0, 0, 0),    # Forward
      (0, 0, 0, -1, 0, 0, 0),   # Backward
      (0, 0, -1, 0, 0, 0, 0),   # Strafe Left
      (0, 0, 1, 0, 0, 0, 0),    # Strafe Right
      (-20, 0, 0, 0, 0, 0, 0),  # Look Left
      (20, 0, 0, 0, 0, 0, 0),   # Look Right
      (-20, 0, 0, 1, 0, 0, 0),  # Look Left + Forward
      (20, 0, 0, 1, 0, 0, 0),   # Look Right + Forward
      (0, 0, 0, 0, 1, 0, 0),    # Fire
  )

  def __init__(self, level, repeat=4, size=(64, 64), mode='train',
               seed=None, episodic=True):
    import deepmind_lab
    self._dmlab = deepmind_lab
    self._level = level
    self._repeat = repeat
    self._size = size
    self._random = np.random.RandomState(seed)
    self._episodic = episodic
    config = dict(
        fps='60', width=str(size[0]), height=str(size[1]),
        logLevelInfo='ERROR', maxAltCameraWidth='0',
        maxAltCameraHeight='0')
    self._env = deepmind_lab.Lab(
        level='contributed/dmlab30/' + level,
        observations=['RGB_INTERLEAVED'],
        config=config)
    self._done = True

  @functools.cached_property
  def obs_space(self):
    return {
        'image': spacelib.Space(np.uint8, self._size + (3,)),
        'reward': spacelib.Space(np.float32),
        'is_first': spacelib.Space(bool),
        'is_last': spacelib.Space(bool),
        'is_terminal': spacelib.Space(bool),
    }

  @functools.cached_property
  def act_space(self):
    return {
        'action': spacelib.Space(np.int32, (), 0, len(self.ACTION_SET)),
        'reset': spacelib.Space(bool),
    }

  def step(self, action):
    if action['reset'] or self._done:
      self._done = False
      self._env.reset(seed=self._random.randint(0, 2 ** 31 - 1))
      return self._obs(0.0, is_first=True)
    raw_action = np.array(self.ACTION_SET[int(action['action'])], np.intc)
    reward = self._env.step(raw_action, num_steps=self._repeat)
    self._done = not self._env.is_running()
    return self._obs(
        reward, is_last=self._done,
        is_terminal=self._done and self._episodic)

  def _obs(self, reward, is_first=False, is_last=False, is_terminal=False):
    if is_last:
      image = np.zeros(self._size + (3,), np.uint8)
    else:
      image = self._env.observations()['RGB_INTERLEAVED']
    return dict(
        image=image,
        reward=np.float32(reward),
        is_first=is_first,
        is_last=is_last,
        is_terminal=is_terminal,
    )

  def close(self):
    self._env.close()

"""Deterministic test env (reference: embodied/envs/dummy.py:5-59).

Zero image/vector observations plus a step-counter key, so tests can assert
exact contents of the episode protocol.
"""

import numpy as np

from ..core import base
from ..core import space as spacelib


class Dummy(base.Env):

  def __init__(self, task, size=(64, 64), length=100):
    assert task in ('continuous', 'discrete')
    self._task = task
    self._size = tuple(size)
    self._length = length
    self._step = 0
    self._done = False

  @property
  def obs_space(self):
    return {
        'image': spacelib.Space(np.uint8, self._size + (3,)),
        'vector': spacelib.Space(np.float32, (7,)),
        'step': spacelib.Space(np.int32, (), 0, self._length),
        'reward': spacelib.Space(np.float32),
        'is_first': spacelib.Space(bool),
        'is_last': spacelib.Space(bool),
        'is_terminal': spacelib.Space(bool),
    }

  @property
  def act_space(self):
    if self._task == 'continuous':
      space = spacelib.Space(np.float32, 6)
    else:
      space = spacelib.Space(np.int32, (), 0, 5)
    return {'action': space, 'reset': spacelib.Space(bool)}

  def step(self, action):
    if action['reset'] or self._done:
      self._step = 0
      self._done = False
      return self._obs(0.0, is_first=True)
    if self._task == 'discrete':
      assert action['action'] in range(5), action
    self._step += 1
    self._done = (self._step >= self._length)
    return self._obs(1.0, is_last=self._done, is_terminal=self._done)

  def _obs(self, reward, is_first=False, is_last=False, is_terminal=False):
    return dict(
        image=np.zeros(self._size + (3,), np.uint8),
        vector=np.zeros(7, np.float32),
        step=self._step,
        reward=np.float32(reward),
        is_first=is_first,
        is_last=is_last,
        is_terminal=is_terminal,
    )

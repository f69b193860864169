"""Toy hierarchical-RL grid world (reference: embodied/envs/hrlgrid.py:5-91).

Agent navigates an NxN grid to a goal; the observation is a rendered 64x64
image; 5 discrete actions (noop, up, down, left, right); +1 on reaching the
goal, which then moves.
"""

import numpy as np

from ..core import base
from ..core import space as spacelib


class HRLGrid(base.Env):

  def __init__(self, size=16, length=1000):
    self._size = size
    self._length = length
    self._random = np.random.RandomState(0)
    self._pos = np.zeros(2, np.int32)
    self._goal = np.zeros(2, np.int32)
    self._step = 0
    self._done = True

  @property
  def obs_space(self):
    return {
        'image': spacelib.Space(np.uint8, (64, 64, 3)),
        'log_position': spacelib.Space(np.int32, (2,)),
        'reward': spacelib.Space(np.float32),
        'is_first': spacelib.Space(bool),
        'is_last': spacelib.Space(bool),
        'is_terminal': spacelib.Space(bool),
    }

  @property
  def act_space(self):
    return {
        'action': spacelib.Space(np.int32, (), 0, 5),
        'reset': spacelib.Space(bool),
    }

  def step(self, action):
    if action['reset'] or self._done:
      self._done = False
      self._step = 0
      self._pos = self._random.randint(0, self._size, 2).astype(np.int32)
      self._respawn_goal()
      return self._obs(0.0, is_first=True)
    moves = {1: (0, -1), 2: (0, 1), 3: (-1, 0), 4: (1, 0)}
    move = moves.get(int(action['action']), (0, 0))
    self._pos = np.clip(self._pos + move, 0, self._size - 1)
    reward = 0.0
    if (self._pos == self._goal).all():
      reward = 1.0
      self._respawn_goal()
    self._step += 1
    self._done = self._step >= self._length
    return self._obs(reward, is_last=self._done)

  def _respawn_goal(self):
    while True:
      goal = self._random.randint(0, self._size, 2).astype(np.int32)
      if not (goal == self._pos).all():
        self._goal = goal
        return

  def _obs(self, reward, is_first=False, is_last=False):
    image = np.zeros((64, 64, 3), np.uint8)
    cell = 64 // self._size
    px, py = self._pos * cell
    gx, gy = self._goal * cell
    image[py:py + cell, px:px + cell] = (255, 255, 255)
    image[gy:gy + cell, gx:gx + cell] = (0, 255, 0)
    return dict(
        image=image,
        log_position=self._pos.copy(),
        reward=np.float32(reward),
        is_first=is_first,
        is_last=is_last,
        is_terminal=False,
    )

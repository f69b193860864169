"""Atari adapter (capability parity with reference embodied/envs/atari.py:5-148).

Decomposed into three parts instead of one monolithic env:

  - `FramePipeline` owns the two-slot screen buffer and turns raw ALE
    frames into the observation image (flicker max-pool over the last two
    frames, resize, optional luma grayscale).
  - `AleSession` owns the emulator handle: serialized construction (ALE's
    ROM loader is not thread-safe), no-op reset randomization, and
    life-loss tracking for the `lives` episode convention.
  - `Atari` composes the two behind the framework Env contract and holds
    only the episode bookkeeping (repeat loop, length cutoff, done flags).
"""

import functools
import threading

import numpy as np

from ..core import base
from ..core import space as spacelib

_CTOR_LOCK = threading.Lock()

# ITU-R BT.601 luma coefficients.
_LUMA = np.array([0.299, 0.587, 0.114])


class FramePipeline:
  """Raw ALE screens -> observation image."""

  def __init__(self, raw_shape, size, gray, resize):
    self._slots = np.zeros((2,) + raw_shape, np.uint8)
    self._size = tuple(size)
    self._gray = gray
    self._backend = resize
    if resize == 'opencv':
      import cv2
      self._scale = lambda img: cv2.resize(
          img, self._size, interpolation=cv2.INTER_AREA)
    elif resize == 'pillow':
      from PIL import Image
      self._scale = lambda img: np.array(
          Image.fromarray(img).resize(self._size, Image.NEAREST))
    else:
      raise NotImplementedError(resize)

  def grab(self, ale, slot):
    """Capture the current screen into one of the two pool slots."""
    ale.getScreenRGB2(self._slots[slot])

  def copy_primary_to_secondary(self):
    self._slots[1][:] = self._slots[0]

  def clear_secondary(self):
    self._slots[1].fill(0)

  def render(self):
    """Max-pool the two slots (in place into slot 0), then scale/gray."""
    np.maximum(self._slots[0], self._slots[1], out=self._slots[0])
    img = self._slots[0]
    if img.shape[:2] != self._size:
      img = self._scale(img)
    if self._gray:
      img = np.tensordot(img, _LUMA, (-1, 0)).astype(np.uint8)[..., None]
    return img


class AleSession:
  """Emulator lifecycle: locked construction, noop resets, lives."""

  def __init__(self, game, sticky, full_actions, noops, seed):
    import gym.envs.atari
    with _CTOR_LOCK:
      self.env = gym.envs.atari.AtariEnv(
          game=game, obs_type='image', frameskip=1,
          repeat_action_probability=0.25 if sticky else 0.0,
          full_action_space=full_actions)
    meanings = self.env.unwrapped.get_action_meanings()
    assert meanings[0] == 'NOOP', meanings
    self.ale = self.env.unwrapped.ale
    self._noops = noops
    self._rng = np.random.RandomState(seed)
    self.lives = 0

  @property
  def n_actions(self):
    return self.env.action_space.n

  def begin_episode(self):
    """Reset; burn a random number of noops; snapshot the life counter."""
    with _CTOR_LOCK:
      self.env.reset()
      for _ in range(self._rng.randint(self._noops) if self._noops else 0):
        _, _, over, _ = self.env.step(0)
        if over:
          self.env.reset()
    self.lives = self.ale.lives()

  def act(self, action):
    _, reward, over, _ = self.env.step(action)
    return reward, over

  def life_lost(self):
    # Snapshot only on losses (matching the reference's lives handling,
    # reference: embodied/envs/atari.py): after an extra-life GAIN the
    # counter keeps its old value, so dropping back to it is not flagged
    # as a death.
    current = self.ale.lives()
    lost = current < self.lives
    if lost:
      self.lives = current
    return lost


class Atari(base.Env):

  def __init__(
      self, name, repeat=4, size=(84, 84), gray=True, noops=0, lives=False,
      sticky=True, actions='all', length=108000, resize='opencv', seed=None):
    self._session = AleSession(name, sticky, actions == 'all', noops, seed)
    raw = self._session.env.observation_space.shape
    self._frames = FramePipeline(raw, size, gray, resize)
    self._repeat = repeat
    self._size = tuple(size)
    self._gray = gray
    self._lives = lives
    self._length = length
    self._needs_reset = True
    self._elapsed = 0

  @functools.cached_property
  def obs_space(self):
    channels = 1 if self._gray else 3
    return {
        'image': spacelib.Space(np.uint8, self._size + (channels,)),
        'reward': spacelib.Space(np.float32),
        'is_first': spacelib.Space(bool),
        'is_last': spacelib.Space(bool),
        'is_terminal': spacelib.Space(bool),
    }

  @functools.cached_property
  def act_space(self):
    return {
        'action': spacelib.Space(np.int32, (), 0, self._session.n_actions),
        'reset': spacelib.Space(bool),
    }

  def step(self, action):
    if action['reset'] or self._needs_reset:
      self._session.begin_episode()
      self._frames.grab(self._session.ale, 0)
      self._frames.clear_secondary()
      self._needs_reset = False
      self._elapsed = 0
      return self._package(0.0, first=True, last=False, terminal=False)

    total = 0.0
    died = False
    over = False
    for k in range(self._repeat):
      reward, over = self._session.act(action['action'])
      self._elapsed += 1
      total += reward
      # The second-to-last emulator frame feeds the flicker pool.
      if k == self._repeat - 2:
        self._frames.grab(self._session.ale, 1)
      if over:
        break
      if self._lives and self._session.life_lost():
        died = True
        break
    if not self._repeat:
      self._frames.copy_primary_to_secondary()
    self._frames.grab(self._session.ale, 0)
    timeout = bool(self._length) and self._elapsed >= self._length
    self._needs_reset = over or died or timeout
    return self._package(
        total, first=False, last=self._needs_reset, terminal=died or over)

  def _package(self, reward, first, last, terminal):
    return dict(
        image=self._frames.render(),
        reward=np.float32(reward),
        is_first=first,
        is_last=last,
        is_terminal=terminal,
    )

  def close(self):
    return self._session.env.close()

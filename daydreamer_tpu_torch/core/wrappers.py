"""Environment wrappers.

Capability parity with the reference wrapper set (reference:
embodied/core/wrappers.py:10-241): TimeLimit, ActionRepeat, NormalizeAction,
OneHotAction, DiscretizeAction, ResizeImage, RenderImage, and
RestartOnException (crash-restart fault tolerance for flaky robot hardware,
rate-limited to ``maxfails`` failures inside a sliding ``window``).
"""

import collections
import functools
import time

import numpy as np

from . import base
from . import space as spacelib


def _categorical_space(shape, sampler):
  """A float32 one-hot space whose sample() draws valid categoricals."""
  space = spacelib.Space(np.float32, shape, 0, 1)
  space.sample = sampler
  space._discrete = True
  return space


class TimeLimit(base.Wrapper):
  """Ends episodes after ``duration`` steps.

  With ``reset=False`` the underlying env is never actually reset at the
  boundary; the wrapper only raises ``is_first`` so the agent's recurrent
  state restarts (used by resets=False robot configs where physical resets
  are expensive or manual).
  """

  def __init__(self, env, duration, reset=True):
    super().__init__(env)
    self._budget = duration
    self._hard_reset = reset
    self._remaining = 0
    self._pending_reset = True

  def step(self, action):
    if action['reset'] or self._pending_reset:
      self._remaining = self._budget
      self._pending_reset = False
      if self._hard_reset:
        return self.env.step({**action, 'reset': True})
      obs = self.env.step({**action, 'reset': False})
      obs['is_first'] = True
      return obs
    obs = self.env.step(action)
    self._remaining -= 1
    if self._budget and self._remaining <= 0:
      obs['is_last'] = True
    self._pending_reset = obs['is_last']
    return obs


class ActionRepeat(base.Wrapper):
  """Applies each action ``repeat`` times, summing rewards."""

  def __init__(self, env, repeat):
    super().__init__(env)
    self._repeat = repeat
    self._pending_reset = False

  def step(self, action):
    if action['reset'] or self._pending_reset:
      obs = self.env.step(action)
      self._pending_reset = obs['is_last']
      return obs
    total = 0.0
    obs = None
    for _ in range(self._repeat):
      obs = self.env.step(action)
      total += obs['reward']
      if obs['is_last'] or obs['is_terminal']:
        break
    obs['reward'] = np.float32(total)
    self._pending_reset = obs['is_last']
    return obs


class NormalizeAction(base.Wrapper):
  """Presents bounded action dims as [-1, 1]; unbounded dims pass through."""

  def __init__(self, env, key='action'):
    super().__init__(env)
    self._key = key
    inner = env.act_space[key]
    self._bounded = np.isfinite(inner.low) & np.isfinite(inner.high)
    lo = np.where(self._bounded, inner.low, -1.0)
    hi = np.where(self._bounded, inner.high, 1.0)
    # action_env = scale * action_agent + center on bounded dims.
    self._scale = (hi - lo) / 2
    self._center = (lo + hi) / 2
    self._lo, self._hi = lo, hi

  @property
  def act_space(self):
    lo = np.where(self._bounded, -1.0, self._lo)
    hi = np.where(self._bounded, 1.0, self._hi)
    outer = spacelib.Space(np.float32, None, lo, hi)
    return {**self.env.act_space, self._key: outer}

  def step(self, action):
    raw = action[self._key]
    mapped = np.where(self._bounded, self._scale * raw + self._center, raw)
    return self.env.step({**action, self._key: mapped})


class OneHotAction(base.Wrapper):
  """Exposes a discrete env action as a one-hot float vector."""

  def __init__(self, env, key='action'):
    super().__init__(env)
    self._key = key
    self._classes = int(env.act_space[key].high)

  @property
  def act_space(self):
    space = _categorical_space(
        (self._classes,),
        functools.partial(_draw_onehot, (self._classes,)))
    return {**self.env.act_space, self._key: space}

  def step(self, action):
    vec = action[self._key]
    if not action['reset']:
      # Straight-through sampling leaves ~1e-7 residue on the one-hot after
      # XLA fusion; validate loosely.
      assert abs(float(vec.sum()) - 1.0) < 1e-3, vec
    return self.env.step({**action, self._key: int(np.argmax(vec))})


class DiscretizeAction(base.Wrapper):
  """Bins each continuous action dim and exposes per-dim one-hots."""

  def __init__(self, env, key='action', bins=5):
    super().__init__(env)
    self._key = key
    self._dims = int(np.squeeze(env.act_space[key].shape).item())
    self._grid = np.linspace(-1, 1, bins)

  @property
  def act_space(self):
    shape = (self._dims, len(self._grid))
    space = _categorical_space(
        shape, functools.partial(_draw_onehot, shape))
    return {**self.env.act_space, self._key: space}

  def step(self, action):
    vec = action[self._key]
    if not action['reset']:
      assert (np.abs(vec.sum(-1) - 1.0) < 1e-3).all(), vec
    continuous = self._grid[np.argmax(vec, axis=-1)]
    return self.env.step({**action, self._key: continuous})


def _draw_onehot(shape):
  """Sample a uniform one-hot (or stack of one-hots) of the given shape."""
  flat = np.zeros(shape, np.float32).reshape(-1, shape[-1])
  flat[np.arange(len(flat)), np.random.randint(0, shape[-1], len(flat))] = 1.0
  return flat.reshape(shape).squeeze() if len(shape) == 1 else flat.reshape(shape)


class ResizeImage(base.Wrapper):
  """Nearest-neighbor resize of any multi-dim obs key to a target size."""

  def __init__(self, env, size=(64, 64)):
    super().__init__(env)
    self._size = tuple(size)
    self._targets = [
        name for name, sp in env.obs_space.items()
        if len(sp.shape) > 1 and sp.shape[:2] != self._size]
    if self._targets:
      from PIL import Image
      self._pil = Image

  @property
  def obs_space(self):
    spaces = dict(self.env.obs_space)
    for name in self._targets:
      tail = spaces[name].shape[2:]
      spaces[name] = spacelib.Space(np.uint8, self._size + tail)
    return spaces

  def step(self, action):
    obs = self.env.step(action)
    for name in self._targets:
      img = self._pil.fromarray(obs[name])
      obs[name] = np.array(img.resize(self._size, self._pil.NEAREST))
    return obs


class RenderImage(base.Wrapper):
  """Adds the env's render frame to the observation dict."""

  def __init__(self, env, key='image'):
    super().__init__(env)
    self._key = key
    self._shape = self.env.render().shape

  @property
  def obs_space(self):
    return {
        **self.env.obs_space,
        self._key: spacelib.Space(np.uint8, self._shape)}

  def step(self, action):
    obs = self.env.step(action)
    obs[self._key] = self.env.render()
    return obs


class RestartOnException(base.Wrapper):
  """Rebuilds a crashing env, tolerating ``maxfails`` per sliding window."""

  def __init__(
      self, ctor, exceptions=(Exception,), window=300, maxfails=2, wait=20):
    if not isinstance(exceptions, (tuple, list)):
      exceptions = [exceptions]
    self._ctor = ctor
    self._exceptions = tuple(exceptions)
    self._window = window
    self._maxfails = maxfails
    self._wait = wait
    self._crashes = collections.deque()
    super().__init__(ctor())

  def step(self, action):
    try:
      return self.env.step(action)
    except self._exceptions as e:
      now = time.time()
      self._crashes.append(now)
      while self._crashes and self._crashes[0] < now - self._window:
        self._crashes.popleft()
      if len(self._crashes) > self._maxfails:
        raise RuntimeError('The env crashed too many times.')
      print(f'Restarting env after crash with {type(e).__name__}: {e}',
            flush=True)
      time.sleep(self._wait)
      self.env = self._ctor()
      return self.env.step(
          {**action, 'reset': np.ones_like(action['reset'])})

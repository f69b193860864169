"""Gym adapter (reference: embodied/envs/gym.py:6-133).

Flattens Dict/Box observation spaces both ways, squeezes scalars, and maps
the gym step API onto the is_first/is_last/is_terminal convention.
"""

import functools

import numpy as np

from ..core import base
from ..core import space as spacelib


class Gym(base.Env):

  def __init__(self, env, obs_key='image', act_key='action'):
    if isinstance(env, str):
      try:
        import gym
      except ModuleNotFoundError:
        # The step/reset handling below covers both API generations
        # (4-tuple and terminated/truncated 5-tuple).
        import gymnasium as gym
      self._env = gym.make(env)
    else:
      self._env = env
    self._obs_dict = hasattr(self._env.observation_space, 'spaces')
    self._act_dict = hasattr(self._env.action_space, 'spaces')
    self._obs_key = obs_key
    self._act_key = act_key
    self._done = True
    self._info = None

  @property
  def info(self):
    return self._info

  @functools.cached_property
  def obs_space(self):
    if self._obs_dict:
      spaces = self._flatten(self._env.observation_space.spaces)
    else:
      spaces = {self._obs_key: self._env.observation_space}
    spaces = {k: self._convert(v) for k, v in spaces.items()}
    return {
        **spaces,
        'reward': spacelib.Space(np.float32),
        'is_first': spacelib.Space(bool),
        'is_last': spacelib.Space(bool),
        'is_terminal': spacelib.Space(bool),
    }

  @functools.cached_property
  def act_space(self):
    if self._act_dict:
      spaces = self._flatten(self._env.action_space.spaces)
    else:
      spaces = {self._act_key: self._env.action_space}
    spaces = {k: self._convert(v) for k, v in spaces.items()}
    spaces['reset'] = spacelib.Space(bool)
    return spaces

  def step(self, action):
    if action['reset'] or self._done:
      self._done = False
      obs = self._env.reset()
      if isinstance(obs, tuple) and len(obs) == 2:
        obs, self._info = obs
      return self._obs(obs, 0.0, is_first=True)
    if self._act_dict:
      action = self._unflatten(action)
    else:
      action = action[self._act_key]
    result = self._env.step(action)
    if len(result) == 5:
      obs, reward, terminated, truncated, self._info = result
      self._done = terminated or truncated
      terminal = terminated
    else:
      obs, reward, self._done, self._info = result
      terminal = self._done and not self._info.get('TimeLimit.truncated', False)
    return self._obs(
        obs, reward, is_last=bool(self._done), is_terminal=bool(terminal))

  def _obs(self, obs, reward, is_first=False, is_last=False,
           is_terminal=False):
    if not self._obs_dict:
      obs = {self._obs_key: obs}
    else:
      obs = self._flatten(obs)
    obs = {k: np.asarray(v) for k, v in obs.items()}
    obs.update(
        reward=np.float32(reward),
        is_first=is_first,
        is_last=is_last,
        is_terminal=is_terminal)
    return obs

  def render(self):
    image = self._env.render('rgb_array')
    assert image is not None
    return image

  def close(self):
    try:
      self._env.close()
    except Exception:
      pass

  def _flatten(self, obs, parent_key='', sep='/'):
    result = {}
    for key, value in obs.items():
      key = parent_key + sep + key if parent_key else key
      if isinstance(value, dict):
        result.update(self._flatten(value, key, sep))
      elif hasattr(value, 'spaces'):
        result.update(self._flatten(value.spaces, key, sep))
      else:
        result[key] = value
    return result

  def _unflatten(self, action, sep='/'):
    result = {}
    for key, value in action.items():
      parts = key.split(sep)
      node = result
      for part in parts[:-1]:
        node = node.setdefault(part, {})
      node[parts[-1]] = value
    return result

  def _convert(self, space):
    if hasattr(space, 'n'):
      return spacelib.Space(np.int32, (), 0, space.n)
    return spacelib.Space(space.dtype, space.shape, space.low, space.high)

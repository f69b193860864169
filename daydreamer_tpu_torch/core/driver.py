"""Policy-environment interaction loop.

Capability parity with the reference driver (embodied/core/driver.py), with a
different decomposition: episode assembly lives in a per-lane ``EpisodeTape``
rather than inside the stepping loop. The episode protocol is pinned by
tests/test_driver.py:

* The driver starts as if every lane just finished an episode, so the first
  action carries ``reset=True`` and is zeroed.
* Whenever a lane reports ``is_last``, the next action for that lane is
  zeroed and its ``reset`` flag raised.
* ``on_step`` callbacks fire once per lane per step with the merged
  observation+action transition; ``on_episode`` callbacks fire with the
  assembled episode dict when a lane finishes.
* Recurrent policy state is threaded across calls and reset via ``reset()``.
"""

import numpy as np

from .convert import convert


class EpisodeTape:
  """Collects the transitions of one lane's current episode."""

  def __init__(self):
    self._columns = {}

  def record(self, transition):
    if transition.get('is_first', False):
      self._columns = {}
    for name, value in transition.items():
      self._columns.setdefault(name, []).append(value)

  def episode(self):
    return {name: convert(column) for name, column in self._columns.items()}


class Driver:

  def __init__(self, env, **kwargs):
    if len(env) < 1:
      raise ValueError('Driver requires a batched env with >= 1 lane.')
    self._env = env
    self._kwargs = kwargs
    self._step_fns = []
    self._episode_fns = []
    self.reset()

  def reset(self):
    lanes = len(self._env)
    # Synthetic "just ended" observation so the first real step resets.
    self._obs = {
        name: convert(np.zeros((lanes,) + space.shape, space.dtype))
        for name, space in self._env.obs_space.items()}
    self._obs['is_last'] = np.ones(lanes, bool)
    self._tapes = [EpisodeTape() for _ in range(lanes)]
    self._state = None

  def on_step(self, fn):
    self._step_fns.append(fn)

  def on_episode(self, fn):
    self._episode_fns.append(fn)

  def __call__(self, policy, steps=0, episodes=0):
    done_steps = 0
    done_episodes = 0
    while done_steps < steps or done_episodes < episodes:
      s, e = self._advance(policy)
      done_steps += s
      done_episodes += e

  def _advance(self, policy):
    lanes = len(self._env)
    acts, self._state = policy(self._obs, self._state, **self._kwargs)
    acts = dict(acts)
    ended = self._obs['is_last']
    if ended.any():
      # Zero out actions on lanes that need a reset; raise the reset flag.
      keep = ~ended
      acts = {
          name: value * keep.reshape((lanes,) + (1,) * (value.ndim - 1))
          for name, value in acts.items()}
      acts['reset'] = ended.copy()
    else:
      acts['reset'] = np.zeros(lanes, bool)
    acts = {name: convert(value) for name, value in acts.items()}
    for name, value in acts.items():
      if len(value) != lanes:
        raise ValueError(f'Action {name!r} is not batched over {lanes} lanes.')
    obs = self._env.step(acts)
    for name, value in obs.items():
      if len(value) != lanes:
        raise ValueError(f'Obs {name!r} is not batched over {lanes} lanes.')
    self._obs = {name: convert(value) for name, value in obs.items()}
    merged = {**self._obs, **acts}
    finished = 0
    for lane in range(lanes):
      transition = {name: value[lane] for name, value in merged.items()}
      self._tapes[lane].record(transition)
      for fn in self._step_fns:
        fn(transition, lane, **self._kwargs)
      if transition['is_last']:
        episode = self._tapes[lane].episode()
        for fn in self._episode_fns:
          fn(dict(episode), lane, **self._kwargs)
        finished += 1
    return lanes, finished

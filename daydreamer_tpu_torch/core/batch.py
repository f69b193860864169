"""Present N single environments as one batched environment.

Capability parity with the reference batched env (embodied/core/batch.py).
The batched API is dict-of-arrays with a leading lane axis. When the child
envs live in worker processes (``parallel=True``), their ``step`` calls
return promises; all lanes are dispatched before any promise is awaited, so
the envs run concurrently.
"""

import numpy as np

from . import base


def _lane(action, index):
  """Select one lane from a batched action dict."""
  return {name: batch[index] for name, batch in action.items()}


def _collate(transitions):
  """Stack a list of per-lane transition dicts into one batched dict."""
  names = transitions[0].keys()
  return {name: np.stack([t[name] for t in transitions]) for name in names}


class BatchEnv(base.Env):

  def __init__(self, envs, parallel):
    if not envs:
      raise ValueError('BatchEnv needs at least one environment.')
    for env in envs:
      if len(env):
        raise ValueError('BatchEnv lanes must be single (unbatched) envs.')
    self._envs = list(envs)
    self._parallel = parallel
    # Spaces are identical across lanes; resolve them once up front (for
    # process-backed lanes each access is an RPC round-trip).
    self._obs_space = self._envs[0].obs_space
    self._act_space = self._envs[0].act_space

  def __len__(self):
    return len(self._envs)

  @property
  def obs_space(self):
    return self._obs_space

  @property
  def act_space(self):
    return self._act_space

  def step(self, action):
    lanes = len(self._envs)
    for name, batch in action.items():
      if len(batch) != lanes:
        raise ValueError(
            f'Action {name!r} has {len(batch)} lanes, expected {lanes}.')
    pending = [env.step(_lane(action, i)) for i, env in enumerate(self._envs)]
    if self._parallel:
      # Resolve promises only after every lane was dispatched.
      pending = [promise() for promise in pending]
    return _collate(pending)

  def render(self):
    frames = [env.render() for env in self._envs]
    return np.stack(frames)

  def close(self):
    errors = []
    for env in self._envs:
      try:
        env.close()
      except Exception as e:
        errors.append(e)  # Close every lane even if one raises.

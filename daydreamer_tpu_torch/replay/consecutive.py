"""Sequential chunk streamer for truncated-BPTT training.

Capability parity with the reference streaming sampler (reference:
embodied/replay/consecutive.py:10-83): chunks walk contiguously through
whole trajectories so recurrent state carried between train calls stays
valid; leftovers at an episode's end are stitched to the start of the next
drawn episode; ``randomize`` starts each episode at a random offset.
"""

import time

import numpy as np

from .sampler import StoreSampler, traj_length


def _concat(left, right):
  return {k: np.concatenate([left[k], right[k]], 0) for k in right}


class Consecutive(StoreSampler):

  def __init__(self, store, chunk=64, randomize=False, sync=0, seed=0):
    super().__init__(store, chunk, sync=sync, seed=seed)
    self.randomize = randomize

  def _min_length(self):
    return 1  # The streamer can stitch arbitrarily short episodes.

  def dataset(self):
    carry = None
    while True:
      data = self._next_traj()
      if carry is not None:
        data = _concat(carry, data)
        carry = None
      total = traj_length(data)
      cursor = 0
      while total - cursor >= self.chunk:
        yield {k: v[cursor:cursor + self.chunk] for k, v in data.items()}
        cursor += self.chunk
      if cursor < total:
        carry = {k: v[cursor:] for k, v in data.items()}

  def _sample(self):
    # Exposed for the profiling hook; the real work happens in dataset().
    return self._next_traj()

  def _next_traj(self):
    while True:
      traj = self._pick_stored()
      if traj is not None:
        break
      print('Waiting for episodes.')
      time.sleep(1)
    if not self.randomize:
      return traj
    steps = traj_length(traj)
    offset = int(self.rng.integers(max(1, steps - self.chunk)))
    traj = {k: v[offset:] for k, v in traj.items()}
    firsts = np.array(traj['is_first'])
    firsts[0] = True
    traj['is_first'] = firsts
    return traj

"""Uniform-episode, random-window replay sampler.

Capability parity with the reference default sampler (reference:
embodied/replay/fixed_length.py:10-87): windows of ``chunk`` steps are cut
from uniformly chosen trajectories, ``prio_starts``/``prio_ends`` bias the
draw toward episode boundaries, every chunk is marked as a fresh sequence
start, and too-short trajectories are rejected at insert time.
"""

import numpy as np

from .sampler import StoreSampler, traj_length


class FixedLength(StoreSampler):

  def __init__(
      self, store, chunk=64, length=0, prio_starts=0.0, prio_ends=1.0,
      sync=0, minlen=0, seed=0):
    super().__init__(store, chunk, length=length, sync=sync, seed=seed)
    self.minlen = minlen
    # Extra virtual window positions hanging off each episode boundary;
    # they clip back onto the first/last valid start, oversampling those.
    self._pad_lo = int(round(chunk * prio_starts))
    self._pad_hi = int(round(chunk * prio_ends))

  def _min_length(self):
    return max(self.chunk, self.minlen)

  def _sample(self):
    traj = self._pick_stored()
    if traj is None:
      return None
    steps = traj_length(traj)
    last_start = steps - self.chunk
    pos = int(self.rng.integers(
        -self._pad_lo, last_start + self._pad_hi + 1))
    start = min(max(pos, 0), last_start)
    return self._window(traj, start, self.chunk)

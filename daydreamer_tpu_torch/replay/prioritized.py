"""Step-level prioritized experience replay.

Capability parity with the reference PER sampler (reference:
embodied/replay/prioritized.py:12-135): per-episode step priorities are
aggregated into window weights via conv(f(prios), ones(chunk)); sampling is
two-level (episode, then window); fresh episodes enter with infinite
priority; sampled windows are put on cooldown; each chunk carries its
encoded (uuid, offset) key and sampling probability so the train step can
importance-weight losses and feed updated priorities back through
``prioritize``.

Deviation from the reference kept from round 1: the reference drew a
prioritized (key, index) but then returned a uniformly random window
(reference prioritized.py:99-112), so priorities never shaped the data; here
the prioritized draw selects the returned chunk.
"""

import uuid as uuidlib

import numpy as np

from . import priorities as priolib
from .sampler import StoreSampler, traj_length


def encode_handle(key, offset):
  """Pack a uuid hex key and window offset into three int64 words."""
  packed = uuidlib.UUID(key).bytes + int(offset).to_bytes(8, 'big')
  return np.frombuffer(packed, np.int64)


def decode_handle(words):
  assert words.dtype == np.int64, words.dtype
  packed = words.tobytes()
  return uuidlib.UUID(bytes=packed[:16]).hex, int.from_bytes(
      packed[16:], 'big')


class Prioritized(StoreSampler):

  def __init__(
      self, store, chunk=64, prio_starts=0.0, prio_ends=1.0, sync=0,
      fraction=0.1, softmax=False, temp=1.0, constant=0.0, exponent=0.5,
      seed=0):
    super().__init__(store, chunk, sync=sync, seed=seed)

    if softmax:
      transform = lambda p: np.maximum(np.exp(p / temp) + constant, 0)
    else:
      transform = lambda p: np.abs(p) ** exponent
    window = np.ones(chunk)
    self.table = priolib.Priorities(
        lambda p: np.convolve(transform(p), window, 'valid'),
        fraction, prio_starts, prio_ends, seed=seed)
    # Priority that parks a just-sampled window at the bottom of the queue.
    self._cooldown = np.full(chunk, -np.inf if softmax else 0.0, np.float64)
    self._issued = set()

  @property
  def stats(self):
    return {**super().stats, **self.table.stats}

  def _on_insert(self, key, traj):
    self.table.add(key, np.full(traj_length(traj), np.inf, np.float64))

  def prioritize(self, keys, priorities):
    handles = np.asarray(keys, np.int64)[:, 0]  # Same handle along time.
    priorities = np.asarray(priorities, np.float64)
    assert priorities.shape == (len(handles), self.chunk), priorities.shape
    for handle, row in zip(handles, priorities):
      assert tuple(handle.tolist()) in self._issued, handle
      key, offset = decode_handle(handle)
      try:
        self.table.update(key, offset, row)
      except KeyError:
        print('Received priorities for an episode that was removed.')

  def _sample(self):
    while len(self.table):
      key, offset, prob = self.table.sample()
      self.table.update(key, offset, self._cooldown)
      try:
        traj = self.store[key]
      except KeyError:
        # The store evicted this episode; retire it from the table too.
        self.table.remove(key)
        continue
      offset = min(max(offset, 0), traj_length(traj) - self.chunk)
      handle = encode_handle(key, offset)
      self._issued.add(tuple(handle.tolist()))
      chunk = self._window(traj, offset, self.chunk)
      chunk['key'] = np.broadcast_to(handle, (self.chunk, 3)).copy()
      chunk['prob'] = np.full(self.chunk, prob, np.float32)
      return chunk
    return None

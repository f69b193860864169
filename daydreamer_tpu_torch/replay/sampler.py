"""Shared machinery for replay samplers.

The reference implements episode assembly, store syncing, and the dataset
retry loop separately inside every sampler (embodied/replay/fixed_length.py,
consecutive.py, prioritized.py). Here that scaffolding lives once in
``StoreSampler``; concrete samplers only implement ``_sample``.
"""

import threading
import time
import uuid

import numpy as np

from ..core import base
from ..core.convert import convert


class EpisodeAssembler:
  """Turns per-worker transition streams into column-major trajectories."""

  def __init__(self):
    self._open = {}

  def feed(self, tran, worker):
    """Append one transition; return the finished trajectory or None."""
    if tran.get('is_first', False) or worker not in self._open:
      self._open[worker] = {k: [v] for k, v in tran.items()}
    else:
      cols = self._open[worker]
      for k, v in tran.items():
        cols.setdefault(k, []).append(v)
    return self._open[worker]

  def take(self, worker):
    return self._open.pop(worker, None)


def clean_traj(traj):
  """Drop logger-only keys and coerce columns to canonical dtypes."""
  return {
      k: convert(v) for k, v in traj.items() if not k.startswith('log_')}


def traj_length(traj):
  return len(next(iter(traj.values())))


def fresh_key():
  return uuid.uuid4().hex


class StoreSampler(base.Replay):
  """Base replay: ingestion into a store plus a sampling loop.

  Subclasses implement ``_sample() -> chunk dict or None`` and may override
  ``_min_length`` (trajectories shorter than this are rejected at insert) and
  ``_on_insert(key, traj)`` (e.g. to register priorities).
  """

  def __init__(self, store, chunk, length=0, sync=0, seed=0):
    self.store = store
    self.chunk = chunk
    self.length = length
    self.rng = np.random.default_rng(seed)
    self._assembler = EpisodeAssembler()
    if sync:
      self._start_sync_thread(sync)

  # --- ingestion ---

  def add(self, tran, worker=0):
    cols = self._assembler.feed(tran, worker)
    full = self.length and len(next(iter(cols.values()))) >= self.length
    if tran.get('is_last', False) or full:
      self.add_traj(self._assembler.take(worker))

  def add_traj(self, traj):
    traj = clean_traj(traj)
    steps = traj_length(traj)
    if steps < self._min_length():
      print(f'Skipping short trajectory of length {steps}.')
      return
    key = fresh_key()
    self.store[key] = traj
    self._on_insert(key, traj)

  def _min_length(self):
    return self.chunk

  def _on_insert(self, key, traj):
    pass

  # --- sampling ---

  def dataset(self):
    while True:
      chunk = self._sample()
      if chunk is None:
        print('Waiting for episodes.')
        time.sleep(1)
      else:
        yield chunk

  def _sample(self):
    raise NotImplementedError

  def _pick_stored(self):
    """Uniformly pick one stored trajectory, or None if the store is empty."""
    keys = self.store.keys()
    if not keys:
      return None
    return self.store[keys[int(self.rng.integers(len(keys)))]]

  @staticmethod
  def _window(traj, start, size):
    """Cut a window and mark it as a chunk start for TBPTT resets."""
    out = {k: v[start:start + size] for k, v in traj.items()}
    firsts = np.zeros(size, bool)
    firsts[0] = True
    out['is_first'] = firsts
    return out

  # --- bookkeeping ---

  def __len__(self):
    return self.store.steps

  @property
  def stats(self):
    return {f'replay_{k}': v for k, v in self.store.stats().items()}

  def _start_sync_thread(self, interval):

    def loop():
      while True:
        time.sleep(interval)
        self.store.sync()

    threading.Thread(target=loop, daemon=True).start()

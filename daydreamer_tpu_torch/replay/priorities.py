"""Two-level priority table for prioritized experience replay.

Capability parity with the reference table (reference:
embodied/replay/prios.py:7-153): episodes are drawn proportionally to their
aggregated window priority and a window index within the episode is drawn
from the per-episode window distribution. Unseen windows carry infinite
priority so they win until first visited; ``fraction`` blends the priority
distribution with a (boundary-biased) uniform floor at both levels.

Decomposition: raw step priorities, per-episode window distributions, and
episode masses live in parallel dicts; the episode-level distribution is
rebuilt lazily behind a dirty flag.
"""

import threading

import numpy as np


class Priorities:

  def __init__(self, aggregate, fraction=0.25, prio_starts=1.0,
               prio_ends=1.0, seed=0):
    self.aggregate = aggregate
    self.fraction = fraction
    self.prio_starts = prio_starts
    self.prio_ends = prio_ends
    self.rng = np.random.default_rng(seed)
    self._raw = {}    # key -> float64 step priorities
    self._dist = {}   # key -> window sampling distribution
    self._mass = {}   # key -> total aggregated priority (pre inf-collapse)
    self._top = None  # cached (keys tuple, probs array)
    self._lock = threading.Lock()
    self._visits = {}
    self._upd_lo = np.inf
    self._upd_hi = -np.inf

  def __len__(self):
    return len(self._raw)

  def __contains__(self, key):
    return key in self._raw

  # --- mutation ---

  def add(self, key, prios):
    assert prios.dtype == np.float64, prios.dtype
    with self._lock:
      self._raw[key] = prios
      self._refresh_episode(key)
      self._top = None

  def update(self, key, index, prios):
    assert prios.dtype == np.float64, prios.dtype
    self._upd_lo = min(self._upd_lo, float(prios.min()))
    self._upd_hi = max(self._upd_hi, float(prios.max()))
    with self._lock:
      if key not in self._raw:
        raise KeyError(key)
      self._raw[key][index:index + len(prios)] = prios
      self._refresh_episode(key)
      self._top = None

  def remove(self, key):
    with self._lock:
      self._raw.pop(key, None)
      self._dist.pop(key, None)
      self._mass.pop(key, None)
      self._visits.pop(key, None)
      self._top = None

  # --- sampling ---

  def sample(self):
    assert len(self)
    with self._lock:
      keys, probs = self._episode_distribution()
      slot = 0 if len(keys) == 1 else int(
          self.rng.choice(len(keys), p=probs))
      key = keys[slot]
      windows = self._dist[key]
      index = int(self.rng.choice(len(windows), p=windows))
      prob = float(probs[slot] * windows[index])
    self._visits[key] = self._visits.get(key, 0) + 1
    return key, index, prob

  # --- diagnostics ---

  @property
  def stats(self):
    if len(self) <= 1:
      return {}
    with self._lock:
      _, probs = self._episode_distribution()
      entropy = float(-(probs @ np.log(probs + 1e-12)))
      limit = float(np.log(len(probs)))
    visits = list(self._visits.values()) or [0]
    return {
        'randomness': entropy / limit,
        'seen_frac': len(self._visits) / len(self._raw),
        'seen_max': max(visits),
        'sample_frac': sum(visits) / len(self._raw),
        'update_min': self._upd_lo,
        'update_max': self._upd_hi,
    }

  # --- persistence ---

  def save(self):
    with self._lock:
      return {
          'raw': {k: v.copy() for k, v in self._raw.items()},
          'visits': dict(self._visits),
          'bounds': (self._upd_lo, self._upd_hi),
      }

  def load(self, data):
    with self._lock:
      self._visits.update(data['visits'])
      self._upd_lo, self._upd_hi = data['bounds']
      for key, raw in data['raw'].items():
        self._raw[key] = raw
        self._refresh_episode(key)
      self._top = None

  # --- internals (lock held) ---

  def _boundary_floor(self, windows, overhang):
    floor = np.ones(windows, np.float64)
    floor[0] += overhang * self.prio_starts
    floor[-1] += overhang * self.prio_ends
    return floor / floor.sum()

  def _refresh_episode(self, key):
    raw = self._raw[key]
    weights = self.aggregate(raw)
    assert (weights >= 0).all(), weights
    self._mass[key] = float(weights.sum())
    infs = np.isposinf(weights)
    if infs.any():
      weights = infs.astype(np.float64)
    floor = self._boundary_floor(len(weights), len(raw) - len(weights))
    total = weights.sum()
    prio_part = floor if total == 0 else weights / total
    self._dist[key] = self.fraction * prio_part + (1 - self.fraction) * floor

  def _episode_distribution(self):
    if self._top is None:
      keys = tuple(self._raw.keys())
      masses = np.array([self._mass[k] for k in keys])
      infs = np.isposinf(masses)
      if infs.any():
        masses = infs.astype(np.float64)
      total = masses.sum()
      sizes = np.array([len(self._dist[k]) for k in keys], np.float64)
      floor = sizes / sizes.sum()
      prio_part = floor if total == 0 else masses / total
      probs = self.fraction * prio_part + (1 - self.fraction) * floor
      self._top = (keys, probs)
    return self._top

"""Wall-clock profiler for the host-side hot loops.

Covers the reference profiler's capability (reference:
embodied/core/timer.py:8-59) with a different mechanism: instead of
keeping per-section duration lists, the timer appends flat
``(section, elapsed)`` events to one log as they happen and folds the log
into summary statistics only when ``stats()`` is called.  Sections come
from explicit ``scope(name)`` context managers or from ``wrap``, which
rebinds an object's hot methods to timed versions.  A ``profile`` scope
additionally captures a torch.profiler trace of host and CUDA work.
"""

import contextlib
import functools
import math
import time


class Timer:

  def __init__(self, columns=('frac', 'avg', 'min', 'max', 'count')):
    known = {'frac', 'avg', 'min', 'max', 'sum', 'count'}
    unknown = set(columns) - known
    assert not unknown, unknown
    self._columns = tuple(columns)
    self._events = []  # Flat append-only log of (section, seconds).
    self._epoch = time.perf_counter()

  @contextlib.contextmanager
  def scope(self, name):
    begin = time.perf_counter()
    try:
      yield
    finally:
      self._events.append((name, time.perf_counter() - begin))

  def wrap(self, prefix, obj, methods):
    """Rebind `obj.<method>` to a version that logs under `prefix.method`."""
    for method in methods:
      inner = getattr(obj, method)

      def timed(*args, __inner=inner, __name=f'{prefix}.{method}', **kwargs):
        begin = time.perf_counter()
        try:
          return __inner(*args, **kwargs)
        finally:
          self._events.append((__name, time.perf_counter() - begin))

      setattr(obj, method, functools.wraps(inner)(timed))

  def stats(self, reset=True, log=False):
    """Fold the event log into per-section summary metrics."""
    elapsed = time.perf_counter() - self._epoch
    folded = {}  # section -> [count, total, lo, hi]
    for section, seconds in self._events:
      acc = folded.get(section)
      if acc is None:
        folded[section] = [1, seconds, seconds, seconds]
      else:
        acc[0] += 1
        acc[1] += seconds
        acc[2] = min(acc[2], seconds)
        acc[3] = max(acc[3], seconds)
    metrics = {'duration': elapsed}
    for section, (count, total, lo, hi) in folded.items():
      values = dict(
          count=count, sum=total, frac=total / elapsed,
          avg=total / count, min=lo, max=hi)
      for column in self._columns:
        metrics[f'{section}_{column}'] = values[column]
    if log:
      self._print(folded, metrics)
    if reset:
      self.reset()
    return metrics

  def reset(self):
    self._events.clear()
    self._epoch = time.perf_counter()

  @contextlib.contextmanager
  def profile(self, logdir):
    """Capture a torch.profiler trace (CPU, plus CUDA when a card is
    present) for the enclosed scope; writes a Chrome trace to logdir."""
    import os
    import torch
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
      activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
      yield
    os.makedirs(str(logdir), exist_ok=True)
    prof.export_chrome_trace(os.path.join(str(logdir), 'trace.json'))

  def _print(self, folded, metrics):
    header = 'Timer:'.ljust(20) + ' '.join(
        column.rjust(8) for column in self._columns)
    print(header)
    by_cost = sorted(folded, key=lambda s: -folded[s][1])
    for section in by_cost:
      cells = []
      for column in self._columns:
        value = metrics.get(f'{section}_{column}', math.nan)
        cells.append(f'{value:8.4f}')
      print(section.ljust(20), ' '.join(cells))


global_timer = Timer()

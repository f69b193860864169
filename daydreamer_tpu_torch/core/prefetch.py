"""Thread-pool batcher over generator sources (reference: embodied/core/prefetch.py:6-67).

N generator sources are drained round-robin by W worker threads into bounded
queues; batches stack source dicts along a new leading dimension. This is the
host-side data loader whose batches the agent moves to its device.
"""

import queue as queuelib
import threading
import time

import numpy as np


class Prefetch:

  def __init__(self, sources, workers=8, prefetch=4):
    self._sources = sources
    self._batch = len(sources)
    self._workers = min(workers, len(sources))
    self._queues = [
        queuelib.Queue(maxsize=prefetch) for _ in range(len(sources))]
    self._threads = []
    self._running = False

  def __iter__(self):
    self._start()
    return self

  def __next__(self):
    self._start()
    elems = [queue.get() for queue in self._queues]
    for elem in elems:
      if isinstance(elem, Exception):
        raise elem
    batch = {
        k: np.stack([elem[k] for elem in elems], 0)
        for k in elems[0].keys()}
    return batch

  def close(self, timeout=10.0):
    """Stop and join the workers. Workers blocked on a full queue observe
    the stop flag through their bounded put; the remaining queued batches
    are discarded."""
    self._running = False
    deadline = time.time() + timeout
    for thread in self._threads:
      while thread.is_alive():
        for queue in self._queues:  # Unblock any worker mid-put.
          try:
            queue.get_nowait()
          except queuelib.Empty:
            pass
        thread.join(0.05)
        if time.time() > deadline:
          return  # Daemon threads; don't hang shutdown forever.
    self._threads.clear()

  def _start(self):
    if self._running:
      return
    self._running = True
    # A close() that hit its timeout may have left not-yet-dead threads in
    # the list; prune them so restart cycles never accumulate stale entries.
    self._threads = [t for t in self._threads if t.is_alive()]
    assignments = [[] for _ in range(self._workers)]
    for index in range(len(self._sources)):
      assignments[index % self._workers].append(index)
    for indices in assignments:
      thread = threading.Thread(
          target=self._worker, args=(indices,), daemon=True)
      thread.start()
      self._threads.append(thread)

  def _put(self, index, item):
    """Bounded put that re-checks the stop flag, so close() cannot leave a
    worker blocked forever on a full queue."""
    while self._running:
      try:
        self._queues[index].put(item, timeout=0.2)
        return True
      except queuelib.Full:
        continue
    return False

  def _worker(self, indices):
    try:
      iterators = [self._sources[i]() for i in indices]
      while self._running:
        for index, iterator in zip(indices, iterators):
          if not self._put(index, next(iterator)):
            return
    except Exception as e:
      for index in indices:
        self._put(index, e)
      raise

"""Native-accelerated batch assembly for the learner's data feed.

Replaces per-sample dict slicing + np.stack with one threaded C++ gather
per batch (native/fastcopy.cpp): the sampler picks (trajectory, start)
windows cheaply in Python, then all window rows are memcpy'd into the
output batch buffers by a thread pool. Falls back to pure numpy when the
native library cannot be built.
"""

import ctypes

import numpy as np


def _load_lib():
  try:
    from ..native import load
    return load('fastcopy')
  except Exception:
    return None


_STACK_LIB = None
_STACK_LIB_TRIED = False


def native_stack(trees, threads=4):
  """np.stack a list of {key: array} dicts along a new leading axis using
  the C++ thread-pool gather (GIL released during the copies).

  Unlike np.stack, which holds the GIL for the whole concatenation, this
  stays responsive when another Python thread is busy (the device-feed
  worker stacks 10s of MB while the learner thread dispatches steps;
  GIL-held np.stack there degraded ~30x under contention). Falls back to
  np.stack when the native library is unavailable.
  """
  global _STACK_LIB, _STACK_LIB_TRIED
  if not _STACK_LIB_TRIED:
    _STACK_LIB = _load_lib()
    _STACK_LIB_TRIED = True
  if _STACK_LIB is None:
    return {k: np.stack([t[k] for t in trees]) for k in trees[0].keys()}
  out = {}
  # One gather call per output buffer: offsets stay relative to a real base
  # pointer (pointer arithmetic on a NULL base is undefined behavior).
  for key in trees[0].keys():
    first = np.asarray(trees[0][key])
    buf = np.empty((len(trees),) + first.shape, first.dtype)
    out[key] = buf
    srcs, offs, sizes = [], [], []
    holders = []  # Keep contiguous views alive until the gather runs.
    for i, tree in enumerate(trees):
      arr = np.ascontiguousarray(tree[key], first.dtype)
      assert arr.nbytes == first.nbytes, (key, arr.shape, first.shape)
      holders.append(arr)
      srcs.append(arr.ctypes.data)
      offs.append(i * first.nbytes)
      sizes.append(first.nbytes)
    n = len(srcs)
    _STACK_LIB.fast_gather(
        (ctypes.c_char_p * n)(*[ctypes.cast(s, ctypes.c_char_p)
                                for s in srcs]),
        (ctypes.c_int64 * n)(*offs),
        (ctypes.c_int64 * n)(*sizes),
        n, ctypes.c_char_p(buf.ctypes.data), threads)
    del holders
  return out


class NativeBatcher:
  """Assembles [B, chunk, ...] batches directly from a FixedLength-style
  replay's store, bypassing the per-sample generator path."""

  def __init__(self, replay, batch_size, threads=4, seed=0):
    self.replay = replay
    self.store = replay.store
    self.chunk = replay.chunk
    self.batch_size = batch_size
    self.threads = threads
    self.random = np.random.RandomState(seed)
    try:
      from ..native import load
      self._lib = load('fastcopy')
    except Exception:
      self._lib = None
    self._out = None

  def __iter__(self):
    return self

  def __next__(self):
    import time
    while True:
      keys = self.store.keys()
      if keys:
        break
      print('Waiting for episodes.')
      time.sleep(1)
    B, L = self.batch_size, self.chunk
    picks = []
    for _ in range(B):
      for _ in range(100):
        traj = self.store[keys[self.random.randint(0, len(keys))]]
        total = len(next(iter(traj.values())))
        if total >= L:
          break
      else:
        raise RuntimeError('No trajectory long enough for chunk.')
      lower = 0
      upper = total - L + 1
      if getattr(self.replay, 'prio_starts', 0):
        lower -= int(L * self.replay.prio_starts)
      if getattr(self.replay, 'prio_ends', 0):
        upper += int(L * self.replay.prio_ends)
      index = int(np.clip(
          self.random.randint(lower, upper), 0, total - L))
      picks.append((traj, index))
    batch = self._assemble(picks)
    batch['is_first'] = np.zeros((B, L), bool)
    batch['is_first'][:, 0] = True
    return batch

  def _assemble(self, picks):
    B, L = self.batch_size, self.chunk
    example = picks[0][0]
    batch = {}
    for key in example.keys():
      if key == 'is_first':
        continue
      value = example[key]
      out = np.empty((B, L) + value.shape[1:], value.dtype)
      batch[key] = out
      row_bytes = int(np.prod(value.shape[1:]) * value.dtype.itemsize) * L
      srcs, offs, sizes = [], [], []
      holders = []  # Keep slices alive until the gather runs.
      for b, (traj, index) in enumerate(picks):
        window = np.ascontiguousarray(traj[key][index: index + L])
        holders.append(window)
        srcs.append(window.ctypes.data)
        offs.append(b * row_bytes)
        sizes.append(row_bytes)
      if self._lib is None:
        base = out.ctypes.data
        for src, off, nbytes in zip(srcs, offs, sizes):
          ctypes.memmove(base + off, src, nbytes)
      else:
        # Offsets are relative to the real output base pointer (NULL-base
        # pointer arithmetic is undefined behavior).
        n = len(srcs)
        self._lib.fast_gather(
            (ctypes.c_char_p * n)(*[
                ctypes.cast(s, ctypes.c_char_p) for s in srcs]),
            (ctypes.c_int64 * n)(*offs),
            (ctypes.c_int64 * n)(*sizes),
            n, ctypes.c_char_p(out.ctypes.data), self.threads)
      del holders
    return batch

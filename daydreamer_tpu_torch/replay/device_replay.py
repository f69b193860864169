"""Device-resident replay: training data lives in the card's memory.

The port of `daydreamer_tpu/replay/device_replay.py` (reference capability:
embodied/replay/fixed_length.py + tf.data feed, agent.py:108-121). The
reference re-feeds every sampled chunk over the host->device link; here
each step crosses the link exactly ONCE when added, and chunk sampling is a
gather on the device, so the learner's updates take no training data from
the host.

Semantics: a flat ring of steps (capacity rows per key). Chunks are uniform
random windows over the step stream; episode boundaries inside a window are
handled by the stored `is_first` flags (the RSSM resets state on is_first),
and `is_first[:, 0]` is forced True like the reference sampler
(fixed_length.py:79-80). Windows never cross the ring's write seam.

Steps are flushed to the device in fixed `block`-row slabs: a slab's keys
are packed into one pinned host buffer and cross the link in one copy
(capacity % block == 0 keeps the cursor aligned; a partial tail stays
staged host-side until it fills). `filled` and `cursor` live on the host,
so neither a flush nor a draw waits for the device, and beside them as
device scalars (`device_state`), which a flush updates in place: a draw
that reads those works out its span on the device, as the JAX package's
jitted sampler does, so a CUDA graph captured over it draws from the rows
added after the capture. The samplers take either form.
"""

import numpy as np
import torch


# Raw priority assigned to steps never yet sampled. The host PER uses
# np.inf (unseen windows sample first); on device a large finite value
# keeps the window weights finite while still dominating sampling.
UNSEEN_PRIORITY = 1e6

_ALIGN = 16  # Bytes; each key's part of a slab starts on a multiple.


class DeviceReplay:

  def __init__(self, capacity, chunk, block=64, device='cuda',
               prioritized=False):
    if capacity % block:
      raise ValueError(f'capacity {capacity} is no multiple of block {block}.')
    if capacity < 2 * max(chunk, block):
      raise ValueError(f'capacity {capacity} is under twice the chunk '
                       f'{chunk} or the block {block}.')
    self.capacity = int(capacity)
    self.chunk = int(chunk)
    self.block = int(block)
    self.device = torch.device(device)
    self.prioritized = bool(prioritized)
    self.buffers = None    # {key: tensor [capacity, ...]} device rings.
    self.prios = None      # tensor [capacity] raw step priorities (PER).
    self.cursor = 0        # Next write row (multiple of block).
    self.filled = 0        # Valid rows (<= capacity).
    # The same two as device scalars, updated in place at every flush.
    self._filled_t = torch.zeros((), dtype=torch.long, device=self.device)
    self._cursor_t = torch.zeros((), dtype=torch.long, device=self.device)
    self._staged = []      # Host-side steps awaiting a full block.
    self._staged_count = 0
    self._layout = None    # {key: (offset, nbytes, numpy dtype, shape)}.
    self._slab = None      # The pinned host buffer of one slab.
    self._copied = None    # Event: the slab's last copy has left the host.

  def __len__(self):
    return self.filled

  def add_steps(self, steps):
    """Append a {key: [n, ...]} dict of steps (host numpy) to the ring."""
    steps = {k: np.asarray(v) for k, v in steps.items()}
    n = len(next(iter(steps.values())))
    if any(len(v) != n for v in steps.values()):
      raise ValueError({k: v.shape for k, v in steps.items()})
    self._staged.append(steps)
    self._staged_count += n
    while self._staged_count >= self.block:
      self._flush_block()

  def _flush_block(self):
    take, rest = [], []
    need = self.block
    for steps in self._staged:
      n = len(next(iter(steps.values())))
      if need <= 0:
        rest.append(steps)
      elif n <= need:
        take.append(steps)
        need -= n
      else:
        take.append({k: v[:need] for k, v in steps.items()})
        rest.append({k: v[need:] for k, v in steps.items()})
        need = 0
    self._staged = rest
    self._staged_count -= self.block
    merged = {
        k: np.concatenate([s[k] for s in take]) if len(take) > 1
        else take[0][k]
        for k in take[0]}
    if self.buffers is None:
      self._allocate(merged)
    if set(merged) != set(self.buffers):
      raise ValueError((sorted(merged), sorted(self.buffers)))
    if self._copied is not None:
      self._copied.synchronize()  # The slab buffer is free to refill.
    for key, (offset, nbytes, dtype, _) in self._layout.items():
      value = np.ascontiguousarray(merged[key], dtype)
      self._slab[offset:offset + nbytes] = torch.from_numpy(
          value.reshape(-1).view(np.uint8))
    # The one host->device crossing of these steps.
    slab = self._slab.to(self.device, non_blocking=True)
    if self.device.type == 'cuda':
      self._copied = torch.cuda.Event()
      self._copied.record(torch.cuda.current_stream(self.device))
    rows = slice(self.cursor, self.cursor + self.block)
    for key, (offset, nbytes, _, shape) in self._layout.items():
      ring = self.buffers[key]
      ring[rows] = slab[offset:offset + nbytes].view(ring.dtype).reshape(
          shape)
    if self.prioritized:
      self.prios[rows] = UNSEEN_PRIORITY
    self.cursor = (self.cursor + self.block) % self.capacity
    self.filled = min(self.filled + self.block, self.capacity)
    self._cursor_t.fill_(self.cursor)
    self._filled_t.fill_(self.filled)

  def _allocate(self, merged):
    """The rings, and the layout of a slab, from the first block's keys."""
    self.buffers, self._layout = {}, {}
    offset = 0
    for key, value in merged.items():
      dtype = torch.from_numpy(value[:0]).dtype
      self.buffers[key] = torch.zeros(
          (self.capacity,) + value.shape[1:], dtype=dtype, device=self.device)
      nbytes = self.block * value.dtype.itemsize * int(
          np.prod(value.shape[1:]))
      self._layout[key] = (
          offset, nbytes, value.dtype, (self.block,) + value.shape[1:])
      offset += (nbytes + _ALIGN - 1) // _ALIGN * _ALIGN
    self._slab = torch.empty(offset, dtype=torch.uint8)
    if self.device.type == 'cuda':
      self._slab = self._slab.pin_memory()
    if self.prioritized:
      self.prios = torch.zeros(
          self.capacity, dtype=torch.float32, device=self.device)

  @property
  def nbytes(self):
    """Bytes the rings hold on the device."""
    tensors = list((self.buffers or {}).values())
    if self.prios is not None:
      tensors.append(self.prios)
    return sum(x.numel() * x.element_size() for x in tensors)

  @property
  def state(self):
    """(buffers, filled, cursor) for `sample` and `sample_prioritized`, the
    counts as host ints."""
    return (self.buffers, self.filled, self.cursor)

  @property
  def device_state(self):
    """The same with the counts as device scalars that every flush updates
    in place: what a captured draw reads."""
    return (self.buffers, self._filled_t, self._cursor_t)


class StoreMirror:
  """Incrementally mirrors a host replay store into a DeviceReplay.

  The host replay stays authoritative (persistence, ZMQ ingest,
  checkpoint/resume); the device ring holds the most recent
  `device.capacity` steps for on-device sampling. Each trajectory's steps
  cross the host->device link once, at mirror time.
  """

  def __init__(self, replay, device):
    self.store = replay.store
    self.device = device
    self._cursor = 0       # Store insertion clock; sync is O(new trajs).
    self._seen = set()     # Fallback only, for stores without added_since.

  def sync(self):
    """Push steps of trajectories not yet mirrored; returns step count."""
    if hasattr(self.store, 'added_since'):
      fresh, self._cursor = self.store.added_since(self._cursor)
    else:
      fresh = [k for k in self.store.keys() if k not in self._seen]
      self._seen.update(fresh)
    added = 0
    for key in fresh:
      try:
        traj = self.store[key]
      except KeyError:
        continue  # Evicted between listing and fetch.
      steps = {k: np.asarray(v) for k, v in traj.items()
               if not k.startswith('log_')}
      self.device.add_steps(steps)
      added += len(next(iter(steps.values())))
    return added


def valid_span(state, chunk):
  """(capacity, span, base) of a ring: window starts are `base + offset`
  (mod capacity) for offset in [0, span].
  - ring not yet full: starts in [0, filled - chunk];
  - ring full: starts at cursor + [0, capacity - chunk], so no window
    crosses the write seam at `cursor`.
  Host ints for host counts; device scalars, worked out on the device
  without a sync, for device counts (`DeviceReplay.device_state`)."""
  buffers, filled, cursor = state
  capacity = len(next(iter(buffers.values())))
  if isinstance(filled, torch.Tensor):
    full = filled >= capacity
    span = torch.where(full, capacity - chunk, (filled - chunk).clamp_min(0))
    base = torch.where(full, cursor, torch.zeros_like(cursor))
    return capacity, span, base
  if filled >= capacity:
    return capacity, capacity - chunk, int(cursor)
  return capacity, max(int(filled) - chunk, 0), 0


def _rolled(x, base):
  """`torch.roll(x, -base)` along the first axis, by index arithmetic
  modulo its length, for a host or a device `base`."""
  index = (base + torch.arange(len(x), device=x.device)) % len(x)
  return x[index]


def gather(state, offset, chunk):
  """The windows that start `offset` [batch] rows after the oldest valid
  row: ({key: [batch, chunk, ...]}, rows [batch, chunk]); `is_first[:, 0]`
  is forced True."""
  buffers = state[0]
  capacity, _, base = valid_span(state, chunk)
  starts = (base + offset) % capacity
  rows = (starts[:, None] + torch.arange(
      chunk, device=offset.device)[None, :]) % capacity
  out = {k: v[rows] for k, v in buffers.items()}
  if 'is_first' in out:
    out['is_first'][:, 0] = True
  return out, rows


def sample(state, generator, batch, chunk, prio_ends=0.0):
  """Draw a [batch, chunk, ...] dict from a DeviceReplay state, uniformly
  over the seam-free window starts (see `valid_span`), with `generator` on
  the ring's device. An offset is a uniform draw scaled by `span + 1`, so
  a span on the device needs no host value.

  ``prio_ends`` reproduces the host FixedLength sampler's episode-boundary
  oversampling (fixed_length.py): each episode end inside the valid span
  contributes ``chunk * prio_ends`` virtual window positions that clip onto
  the window ending exactly at the episode's last step. Implemented as a
  mixture: with the matching probability, a lane samples uniformly among
  end-aligned windows instead of uniformly over all starts.
  """
  buffers = state[0]
  capacity, span, base = valid_span(state, chunk)
  device = next(iter(buffers.values())).device
  uniform = torch.rand(batch, generator=generator, device=device,
                       dtype=torch.float64)
  offset = (uniform * (span + 1)).long().clamp_max(span)
  if prio_ends and 'is_last' in buffers:
    # Offsets are relative to `base`; roll the termination flags so index i
    # corresponds to offset i, then mask window-END offsets that are
    # episode ends and whose window start lies in the valid span.
    flags = _rolled(buffers['is_last'].bool(), base)
    pos = torch.arange(capacity, device=device)
    end_ok = flags & (pos >= chunk - 1) & (pos <= span + chunk - 1)
    n_ends = end_ok.sum()
    # Uniform over the ends; over every row where there is none (those
    # draws are not taken), so that the draw never sees all-zero weights.
    end_pick = torch.multinomial(
        end_ok.float() + (n_ends == 0), batch, replacement=True,
        generator=generator)
    end_offset = (end_pick - (chunk - 1)).clamp_min(0)
    # Host-sampler equivalent mass: every episode end adds chunk*prio_ends
    # virtual positions on top of the span+1 uniform ones.
    extra = n_ends.float() * (chunk * prio_ends)
    gate = extra / (extra + span + 1.0)
    take_end = (n_ends > 0) & (torch.rand(
        batch, generator=generator, device=device) < gate)
    offset = torch.where(take_end, end_offset, offset)
  return gather(state, offset, chunk)[0]


def window_weights(state, prios, chunk, exponent=0.5, constant=0.0):
  """Weight of the window at every offset [capacity - chunk + 1]: the sum
  over the window of |priority|**exponent + constant, by a rolled cumsum;
  zero past the valid span."""
  capacity, span, base = valid_span(state, chunk)
  rolled = _rolled(prios, base)
  stepw = rolled.abs() ** exponent + constant
  csum = torch.cat([stepw.new_zeros(1), torch.cumsum(stepw, 0)])
  weights = csum[chunk:] - csum[:capacity - chunk + 1]
  offsets = torch.arange(capacity - chunk + 1, device=prios.device)
  return torch.where(
      offsets <= span, weights.clamp_min(1e-9), weights.new_zeros(()))


def write_priorities(prios, rows, values):
  """`prios[rows] = values` for the rows [batch, chunk] of a draw, the same
  on every run: where windows overlap, one row is written several times,
  and it keeps the value of the last of those writes in row-major order
  (what a write on the CPU leaves), where an index write on the card would
  keep whichever write lands last. Sync-free: each write first takes the
  value of the last write to its row."""
  rows = rows.reshape(-1)
  values = values.reshape(-1).to(prios.dtype)
  order = torch.arange(len(rows), device=rows.device)
  same = rows[:, None] == rows[None, :]
  last = torch.where(same, order[None, :], -1).amax(1)
  prios[rows] = values[last]


def sample_prioritized(state, prios, generator, batch, chunk,
                       exponent=0.5, constant=0.0):
  """Priority-proportional window sampling on device (fused-path PER).

  Device-side counterpart of the host Prioritized sampler
  (replay/prioritized.py): window weight = sum over the window of
  |priority|**exponent + constant (the host's conv(f(p), ones(chunk))
  aggregation), window start drawn from the categorical over valid
  starts, and `prob` returned for importance correction. Never-sampled
  steps carry UNSEEN_PRIORITY so fresh data is drawn first, mirroring the
  host's inf-priority-for-unseen. Window starts are offsets into the flat
  step ring (episodes back-to-back) rather than the host's two-level
  (episode, offset) table; boundary handling comes from the stored
  is_first flags as in uniform `sample`.

  Returns (chunk_dict incl. 'prob', rows [batch, chunk]) so the caller can
  scatter fresh priorities back into the ring after the train step
  (`write_priorities`).
  """
  weights = window_weights(state, prios, chunk, exponent, constant)
  offset = torch.multinomial(
      weights, batch, replacement=True, generator=generator)
  prob = weights[offset] / weights.sum()
  out, rows = gather(state, offset, chunk)
  out['prob'] = prob.float()[:, None].expand(batch, chunk)
  return out, rows

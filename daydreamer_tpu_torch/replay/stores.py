"""Trajectory stores: RAM, disk, write-through, stats, and network transport.

Capability parity with the reference store family (reference:
embodied/replay/store.py:10-357) in a different shape:

* A single ``TrajectoryStore`` base owns the step ledger and FIFO eviction;
  backends implement only ``_put``/``_fetch``/``_drop``.
* Disk persistence serializes trajectories as npz archives with a sortable
  ``{nanotime}_{key}_{steps}_{reward}.npz`` name so a directory rescan can
  rebuild the ledger without opening files.
* The network transport is a ZMQ ROUTER/DEALER pair speaking multipart
  binary frames with npz-encoded arrays -- no pickle on the wire, and the
  DEALER side pipelines episode pushes without blocking the robot loop.
"""

import io
import time
from concurrent import futures

import numpy as np

from ..core import path as pathlib


def pack_traj(traj):
  """Serialize a dict of arrays into npz bytes."""
  buffer = io.BytesIO()
  np.savez(buffer, **traj)
  return buffer.getvalue()


def unpack_traj(payload):
  arrays = np.load(io.BytesIO(payload))
  return {name: arrays[name] for name in arrays.files}


class TrajectoryStore:
  """Ledger of trajectory lengths with FIFO eviction at a step capacity."""

  def __init__(self, capacity=None):
    self.capacity = capacity
    self._ledger = {}  # Insertion-ordered key -> step count.
    self._stamps = {}  # key -> monotone insertion sequence number.
    self._clock = 0
    self._steps = 0

  # Backend hooks.
  def _put(self, key, traj, steps):
    raise NotImplementedError

  def _fetch(self, key):
    raise NotImplementedError

  def _drop(self, key):
    pass

  @property
  def steps(self):
    return self._steps

  def stats(self):
    return {'steps': self._steps, 'trajs': len(self._ledger)}

  def keys(self):
    return tuple(self._ledger)

  def __len__(self):
    return len(self._ledger)

  def __contains__(self, key):
    return key in self._ledger

  def __getitem__(self, key):
    if key not in self._ledger:
      raise KeyError(key)
    return self._fetch(key)

  def __setitem__(self, key, traj):
    steps = len(next(iter(traj.values())))
    self._put(key, traj, steps)
    self._ledger[key] = steps
    self._stamps[key] = self._clock
    self._clock += 1
    self._steps += steps
    while (self.capacity and self._steps > self.capacity
           and len(self._ledger) > 1):
      del self[next(iter(self._ledger))]

  def __delitem__(self, key):
    self._steps -= self._ledger.pop(key)
    self._stamps.pop(key, None)
    self._drop(key)

  def added_since(self, cursor):
    """Keys inserted at clock >= cursor (oldest first) and the new cursor.

    O(new keys): the ledger is insertion-ordered, so a reverse walk can
    stop at the first key older than the cursor. Lets incremental
    consumers (e.g. the device-replay mirror) avoid rescanning the store.
    """
    fresh = []
    for key in reversed(self._ledger):
      if self._stamps[key] < cursor:
        break
      fresh.append(key)
    fresh.reverse()
    return fresh, self._clock

  def sync(self):
    pass

  def close(self):
    pass


class RAMStore(TrajectoryStore):

  def __init__(self, capacity=None):
    super().__init__(capacity)
    self._data = {}

  def _put(self, key, traj, steps):
    self._data[key] = traj

  def _fetch(self, key):
    return self._data[key]

  def _drop(self, key):
    del self._data[key]


class DiskStore(TrajectoryStore):
  """One npz file per trajectory; the filename carries the ledger entry."""

  def __init__(self, directory, capacity=None, parallel=False):
    super().__init__(capacity)
    self.directory = pathlib.Path(directory)
    self.directory.mkdirs()
    self._files = {}
    self._saver = futures.ThreadPoolExecutor(1) if parallel else None
    self.sync()

  @staticmethod
  def _name(key, traj, steps):
    reward = int(traj['reward'].sum()) if 'reward' in traj else 0
    return f'{time.time_ns():020d}_{key}_{steps}_{reward}.npz'

  @staticmethod
  def _entry(filename):
    stamp, key, steps, reward = filename.stem.rsplit('_', 3)
    return key, int(steps)

  def _put(self, key, traj, steps):
    target = self.directory / self._name(key, traj, steps)
    self._files[key] = target
    payload = pack_traj(traj)
    if self._saver:
      self._saver.submit(self._write, target, payload)
    else:
      self._write(target, payload)

  @staticmethod
  def _write(target, payload):
    pathlib.Path(target).write(payload, mode='wb')

  def _fetch(self, key):
    with pathlib.Path(self._files[key]).open('rb') as handle:
      return unpack_traj(handle.read())

  def _drop(self, key):
    self._files.pop(key, None)

  def sync(self):
    """Rebuild the ledger from the directory, newest first up to capacity."""
    chosen = []
    total = 0
    for filename in sorted(self.directory.glob('*.npz'), reverse=True):
      key, steps = self._entry(filename)
      if self.capacity and total + steps > self.capacity:
        break
      chosen.append((key, filename, steps))
      total += steps
    chosen.reverse()
    self._ledger = {key: steps for key, _, steps in chosen}
    self._files = {key: filename for key, filename, _ in chosen}
    self._steps = total
    # Stamp rescanned keys in ledger order, preserving surviving stamps so
    # added_since cursors held by consumers stay valid.
    stamps = {}
    for key in self._ledger:
      stamp = self._stamps.get(key)
      if stamp is None:
        stamp = self._clock
        self._clock += 1
      stamps[key] = stamp
    self._stamps = stamps

  def close(self):
    if self._saver:
      self._saver.shutdown(wait=True)


class CkptRAMStore:
  """RAM speed with disk durability: reads hit RAM, writes go to both."""

  def __init__(self, directory, capacity=None, parallel=False):
    self.disk = DiskStore(directory, capacity, parallel)
    self.ram = RAMStore(capacity)
    self.sync()

  @property
  def steps(self):
    return self.ram.steps

  def stats(self):
    return self.ram.stats()

  def keys(self):
    return self.ram.keys()

  def __len__(self):
    return len(self.ram)

  def __contains__(self, key):
    return key in self.ram

  def __getitem__(self, key):
    return self.ram[key]

  def __setitem__(self, key, traj):
    self.ram[key] = traj
    self.disk[key] = traj

  def added_since(self, cursor):
    return self.ram.added_since(cursor)

  def sync(self):
    self.disk.sync()
    for key in self.disk.keys():
      if key not in self.ram:
        self.ram[key] = self.disk[key]

  def close(self):
    self.disk.close()


class Stats:
  """Store decorator tracking episode count, return, and length."""

  def __init__(self, store):
    self.store = store
    self._episodes = 0
    self._reward = 0.0
    self._stat_steps = store.steps

  @property
  def steps(self):
    return self.store.steps

  def stats(self):
    merged = dict(self.store.stats())
    merged['episodes'] = self._episodes
    merged['ep_length'] = (
        self._stat_steps / self._episodes if self._episodes else 0)
    merged['ep_return'] = (
        self._reward / self._episodes if self._episodes else 0)
    return merged

  def keys(self):
    return self.store.keys()

  def added_since(self, cursor):
    return self.store.added_since(cursor)

  def sync(self):
    return self.store.sync()

  def close(self):
    return self.store.close()

  def __len__(self):
    return len(self.store)

  def __contains__(self, key):
    return key in self.store

  def __getitem__(self, key):
    return self.store[key]

  def __setitem__(self, key, traj):
    self.store[key] = traj
    self._account(traj, +1)

  def __delitem__(self, key):
    traj = self.store[key]
    del self.store[key]
    self._account(traj, -1)

  def _account(self, traj, sign):
    self._reward += sign * float(traj['reward'].sum())
    self._episodes += sign * int(traj['is_first'].sum())
    self._stat_steps += sign * len(traj['is_first'])


# --- network transport ---
#
# Frame layout (client -> server):  [opcode, *operands]
#   b'put'   key payload   -> ack []
#   b'get'   key           -> [payload]
#   b'keys'                -> [newline-joined utf8 keys]
#   b'steps'               -> [ascii integer]
# Every request gets exactly one (possibly empty) reply, in order, so the
# DEALER client can pipeline fire-and-forget puts and drain acks lazily.


class StoreServer:
  """Serves a local store to remote actors over a ZMQ ROUTER socket."""

  def __init__(self, store, port):
    import threading
    self.store = store
    self._thread = threading.Thread(
        target=self._serve, args=(int(port),), daemon=True)
    self._thread.start()

  # Local protocol passthrough so the learner can keep using the store.
  @property
  def steps(self):
    return self.store.steps

  def stats(self):
    return self.store.stats()

  def keys(self):
    return self.store.keys()

  def sync(self):
    return self.store.sync()

  def close(self):
    return self.store.close()

  def __len__(self):
    return len(self.store)

  def __contains__(self, key):
    return key in self.store

  def __getitem__(self, key):
    return self.store[key]

  def __setitem__(self, key, traj):
    self.store[key] = traj

  def _serve(self, port):
    import zmq
    socket = zmq.Context.instance().socket(zmq.ROUTER)
    socket.bind(f'tcp://*:{port}')
    print(f'Trajectory store serving on tcp://*:{port}')
    while True:
      identity, opcode, *operands = socket.recv_multipart()
      reply = self._dispatch(opcode, operands)
      socket.send_multipart([identity, *reply])

  def _dispatch(self, opcode, operands):
    if opcode == b'put':
      key, payload = operands
      self.store[key.decode()] = unpack_traj(payload)
      return [b'']  # ROUTER drops messages with no body frame.
    if opcode == b'get':
      (key,) = operands
      return [pack_traj(self.store[key.decode()])]
    if opcode == b'keys':
      return ['\n'.join(self.store.keys()).encode()]
    if opcode == b'steps':
      return [str(self.store.steps).encode()]
    raise NotImplementedError(opcode)


class StoreClient:
  """Remote store handle; episode pushes are pipelined, reads block."""

  def __init__(self, address):
    import zmq
    self.address = address
    self._socket = zmq.Context.instance().socket(zmq.DEALER)
    self._socket.connect(f'tcp://{address}')
    self._inflight = 0  # Replies not yet read, all for pipelined puts.
    self._greeted = False
    print(f'Pushing trajectories to remote store at {address}.')

  @property
  def steps(self):
    return int(self._request(b'steps')[0])

  def keys(self):
    text = self._request(b'keys')[0].decode()
    return tuple(text.split('\n')) if text else ()

  def __getitem__(self, key):
    return unpack_traj(self._request(b'get', key.encode())[0])

  def __setitem__(self, key, traj):
    # Fire and forget: collect outstanding acks opportunistically so the
    # actor loop never blocks on the learner.
    self._drain(block=False)
    self._socket.send_multipart([b'put', key.encode(), pack_traj(traj)])
    self._inflight += 1

  def stats(self):
    return {}

  def sync(self):
    pass

  def close(self):
    pass

  def __len__(self):
    raise NotImplementedError(
        'len() would be a remote call per use; fetch keys() once instead.')

  def __contains__(self, key):
    raise NotImplementedError(
        'Membership would be a remote call per use; fetch keys() instead.')

  def _request(self, opcode, *operands):
    self._drain(block=True)
    self._socket.send_multipart([opcode, *operands])
    if not self._greeted:
      print(f'Awaiting first reply from {self.address}...')
    frames = self._socket.recv_multipart()
    if not self._greeted:
      print(f'Remote store at {self.address} is live.')
      self._greeted = True
    return frames

  def _drain(self, block):
    import zmq
    while self._inflight:
      if not block:
        try:
          self._socket.recv_multipart(flags=zmq.NOBLOCK)
        except zmq.Again:
          return
      else:
        self._socket.recv_multipart()
      self._greeted = True
      self._inflight -= 1

"""The port's counterpart of `jax.jit`: an entry point's work captured once
as a CUDA graph and replayed (config key `torch.graphs`).

The JAX package compiles every entry point of its agent into one device
program (`jax.jit: True`, `jaxagent.py:324-366`). Eagerly, PyTorch issues
each of an update's thousands of kernels from Python, and the host's issue
rate, not the card, sets the pace. Here a call of a function on tensors
is captured once into a `torch.cuda.CUDAGraph` and then replayed: one
launch from the host runs all of its kernels.

A `Captured` owns what a graph needs:
- static input buffers, into which each call's inputs are copied;
- the graph and its memory pool, which holds every tensor the capture
  allocated; its outputs live there, so a replay overwrites them and the
  caller gets clones (`Runner.__call__`) or copies them out itself;
- the launches of the port's kernels that the capture recorded, credited
  to their counts at every replay (`ops/build.py`).

The first call on a new key is the warm-up: the function runs eagerly on a
side stream, a real call whose results are returned, so that cuBLAS,
cuDNN, autograd and the lazy `nvcc` build do their first-call work outside
the graph; then the capture follows, in the thread-local error mode (the
run loops keep other threads that touch CUDA). A capture that fails raises
with the entry point and the last operation it dispatched; nothing falls
back to the eager path. The generators named at construction are
registered with every graph, so a replay draws new numbers and advances
them as an eager call does.

On the CPU there is no graph: the same bookkeeping calls the function on
its static buffers every time. The CPU runs only where it was asked for.

The Dreamer agent (`torchagent.py`: `train`, `train_multi`, `train_device`,
`policy`, `report`) and the imitation PPO learner (`imitation/ppo.py`:
`act`, `update`) run through a `Runner`. Under NCCL a captured function's
collectives are captured with it; a warm-up's collectives come first, so
the communicator exists before any capture, and every rank captures in
the order of its calls, which is the same on every rank.
"""

import time

import torch
from torch.utils import _python_dispatch

from ...ops import build


def tree_map(fn, tree):
  if isinstance(tree, dict):
    return {k: tree_map(fn, v) for k, v in tree.items()}
  if isinstance(tree, (tuple, list)):
    return type(tree)(tree_map(fn, v) for v in tree)
  return fn(tree)


def copy_into(static, tree):
  """Copy the tensors of `tree` into those of `static`, a tree of the same
  structure (dicts matched by key)."""
  if isinstance(static, dict):
    for k, v in static.items():
      copy_into(v, tree[k])
  elif isinstance(static, (tuple, list)):
    for v, w in zip(static, tree):
      copy_into(v, w)
  elif isinstance(static, torch.Tensor):
    static.copy_(tree)


def clone(tree):
  """The tensors of `tree` copied out of the graph's pool."""
  return tree_map(
      lambda x: x.clone() if isinstance(x, torch.Tensor) else x, tree)


def signature(tree):
  """What makes a new graph: the tree's structure and each tensor's shape
  and dtype (not its device: the inputs are copied into the static
  buffers wherever they lie)."""
  if isinstance(tree, dict):
    return ('dict',) + tuple(
        (k, signature(v)) for k, v in sorted(tree.items()))
  if isinstance(tree, (tuple, list)):
    return ('seq',) + tuple(signature(v) for v in tree)
  if isinstance(tree, torch.Tensor):
    return (tuple(tree.shape), tree.dtype)
  return ('value', tree)


class _LastOp(_python_dispatch.TorchDispatchMode):
  """Remembers the last operator dispatched under it: what a failed
  capture names."""

  last = None

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    self.last = str(func)
    return func(*args, **(kwargs or {}))


class Captured:
  """One function on one signature of inputs, captured as a CUDA graph on
  the card (see the module docstring)."""

  def __init__(self, name, fn, inputs, device, generators=()):
    self.name = name
    self.fn = fn
    self.device = torch.device(device)
    self.generators = [g for g in generators if g.device.type == 'cuda']
    self.inputs = tree_map(
        lambda x: x.detach().to(self.device, copy=True)
        if isinstance(x, torch.Tensor) else x, inputs)
    self.outputs = None
    self.graph = None
    self.credit = {}       # {kernel: launches} of one replay.
    self.capture_s = None  # Warm-up and capture, seconds.
    self.pool_bytes = None  # Memory the capture reserved for its pool.
    self.replays = 0

  @property
  def on_card(self):
    return self.device.type == 'cuda'

  def load(self, inputs):
    """Copy `inputs` (the signature's tensors, anywhere) into the static
    buffers."""
    with torch.no_grad():
      copy_into(self.inputs, inputs)

  def run(self):
    """One call on the static inputs. Returns the outputs, which the next
    call overwrites."""
    if not self.on_card:
      self.outputs = self.fn(*self.inputs)
      return self.outputs
    if self.graph is None:
      return self._warm_up_and_capture()
    self.graph.replay()
    build.credit(self.credit)
    self.replays += 1
    return self.outputs

  def _warm_up_and_capture(self):
    begin = time.perf_counter()
    current = torch.cuda.current_stream(self.device)
    side = torch.cuda.Stream(self.device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
      outputs = self.fn(*self.inputs)
    current.wait_stream(side)
    torch.cuda.synchronize(self.device)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(self.device)
    graph = torch.cuda.CUDAGraph()
    for generator in self.generators:
      graph.register_generator_state(generator)
    build.take_captured()
    watch = _LastOp()
    try:
      with torch.cuda.graph(graph, capture_error_mode='thread_local'):
        with watch:
          self.outputs = self.fn(*self.inputs)
    except Exception as e:
      build.take_captured()
      cause = e
      while cause.__context__ is not None:
        cause = cause.__context__
      raise RuntimeError(
          f'{self.name}: the CUDA graph capture failed at {watch.last}: '
          f'{cause}') from e
    self.credit = build.take_captured()
    self.graph = graph
    torch.cuda.synchronize(self.device)
    self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
    self.capture_s = time.perf_counter() - begin
    return outputs


class Runner:
  """The captured calls of one agent, one for each entry point, key and
  signature of inputs."""

  def __init__(self, device, generators=()):
    self.device = torch.device(device)
    self.generators = list(generators)
    self.captured = {}

  def get(self, name, key, fn, inputs):
    """The `Captured` of `name` at `key` for inputs like `inputs`, made at
    its first use with `fn`."""
    full = (name, key, signature(inputs))
    if full not in self.captured:
      self.captured[full] = Captured(
          name, fn, inputs, self.device, self.generators)
    return self.captured[full]

  def __call__(self, name, key, fn, inputs):
    """`fn(*inputs)` through its graph; the outputs cloned out."""
    call = self.get(name, key, fn, inputs)
    call.load(inputs)
    return clone(call.run())

  def stats(self):
    """{entry point: {graphs, replays, capture_s, pool_bytes}} of the
    graphs captured so far (sums over an entry point's graphs)."""
    out = {}
    for call in self.captured.values():
      if call.graph is None:
        continue
      row = out.setdefault(call.name, dict(
          graphs=0, replays=0, capture_s=0.0, pool_bytes=0))
      row['graphs'] += 1
      row['replays'] += call.replays
      row['capture_s'] += call.capture_s
      row['pool_bytes'] += call.pool_bytes
    return out

"""The work and the bytes of a PyTorch program, counted as it runs: the
port's counterpart of XLA's cost analysis (`flops`, `bytes accessed`).

`CostMode` is a `TorchDispatchMode`. For each aten op that runs under it,
it adds

- the op's FLOPs, by the formulas of `torch.utils.flop_counter`'s registry
  (products of matmuls and convolutions), decomposing an op first where
  `FlopCounterMode` does, so that the two totals agree exactly;
- the bytes the op accesses: each distinct tensor operand it reads once,
  and each result it writes once, at its dtype's size. An operand counts
  the elements it can reach (a dimension of stride 0, as `expand` makes,
  counts once). An op whose result aliases an input (a view: `t`,
  `expand`, `as_strided`, `slice`, ...; read from the schema's
  `alias_info`, or from a result that shares an operand's storage, as
  `_unsafe_view`'s does) counts nothing. An in-place or `out=` op counts its
  mutated operand as one write, and one read where the op reads it (not
  for `copy_`, the fills and the random fills). An allocation (`empty`)
  moves nothing, and `zeros_like` and its kind write their result and read
  nothing. `_foreach_*` ops count
  every tensor of their lists. A gather (`index`, `index_select`,
  `gather`, `embedding`) reads what it returns and its indices, not the
  whole source; an index write (`index_put_`) writes and reads its
  values and indices, not the whole target: the rules of XLA's own cost
  analysis for gather and scatter.

With `device`, only tensors on that device count, so a copy from the host
is one write on the card and a fetch to the host one read; without it
every tensor counts.

A kernel of `ops/` is a ctypes or Triton launch that the mode cannot see
into, and on the CPU its plain version would be counted op by op. So each
kernel wrapper counts itself by its formula (`kernel`): its operations and
its bytes, operands read once and results written once, the numbers its
bound uses. Nothing it runs inside is counted again.

Two differences from XLA's count of the same program, which the readers of
these numbers should keep in mind: it counts the eager program, where each
aten op is one kernel, so there is no fusion and an intermediate that XLA
keeps in registers is written and read here; and a loop body is counted
every time it runs, where XLA's cost analysis counts a `scan` body once.

Also here: the card's peaks (`H100`) and `bound`, the least time of a piece
of work on the card, which the kernels' checks report.
"""

import collections
import contextlib
import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

# NVIDIA's data sheet, H100 SXM: dense bfloat16 and float32 (outside the
# tensor cores) FLOP/s, HBM3 bytes/s.
H100 = {'bf16_flops': 989e12, 'f32_flops': 67e12, 'hbm_bytes': 3.35e12}

# In-place ops that write their mutated operand without reading it.
_WRITE_ONLY = {
    aten.copy_, aten.fill_, aten.zero_, aten.normal_, aten.uniform_,
    aten.random_, aten.bernoulli_, aten.exponential_, aten.geometric_,
    aten.cauchy_, aten.log_normal_}
# Allocations: they move no data.
_NO_DATA = {aten.empty, aten.empty_strided, aten.empty_like, aten.new_empty,
            aten.new_empty_strided}
# Ops that read only their operand's shape and write their result.
_SHAPE_ONLY = {
    aten.zeros_like, aten.ones_like, aten.full_like, aten.rand_like,
    aten.randn_like, aten.randint_like, aten.new_zeros, aten.new_ones,
    aten.new_full}
# Gathers: the source (argument 0) is read where the result reads it.
_GATHERS = {aten.index, aten.index_select, aten.gather, aten.embedding}
# Index writes: the target (argument 0) is written where the values go.
_INDEX_WRITES = {aten.index_put_, aten._index_put_impl_}

# The counters that are open, innermost last (any thread: the autograd
# engine runs a card's backward on a thread of its own).
_ACTIVE = []


def _tensors(value):
  if isinstance(value, torch.Tensor):
    return [value]
  if isinstance(value, (list, tuple)):
    return [x for x in value if isinstance(x, torch.Tensor)]
  return []


def _key(x):
  try:
    ptr = x.untyped_storage().data_ptr()
  except (RuntimeError, NotImplementedError):
    ptr = id(x)
  return (ptr, x.storage_offset(), tuple(x.shape), tuple(x.stride()),
          x.dtype)


def _reach(x):
  """The elements `x` can reach: a dimension of stride 0 counts once."""
  if x.numel() == 0:
    return 0
  return math.prod(n for n, s in zip(x.shape, x.stride()) if s != 0)


def tensor_bytes(x):
  return _reach(x) * x.element_size()


def op_bytes(func, args, kwargs, out, device=None):
  """The bytes one call of the aten op `func` accesses (see the module
  docstring): operands read, mutated operands and results written."""
  packet = func._overloadpacket
  schema = func._schema
  results = [out] if len(schema.returns) == 1 else list(out or ())
  if packet in _NO_DATA or any(
      r.alias_info is not None and not r.alias_info.is_write
      for r in schema.returns):
    return 0
  reads, writes = {}, {}
  for i, arg in enumerate(schema.arguments):
    value = (kwargs.get(arg.name) if arg.kwarg_only or i >= len(args)
             else args[i])
    tensors = _tensors(value)
    mutated = arg.alias_info is not None and arg.alias_info.is_write
    for x in tensors:
      if mutated:
        writes[_key(x)] = x
      if not (mutated and (arg.is_out or packet in _WRITE_ONLY)
              or packet in _SHAPE_ONLY):
        reads[_key(x)] = x
  # A result that shares an operand's storage is a view, whether or not
  # the schema says so (`_unsafe_view` does not).
  storages = {key[0] for key in reads} | {key[0] for key in writes}
  returned = [x for ret, value in zip(schema.returns, results)
              if ret.alias_info is None for x in _tensors(value)]
  fresh = [x for x in returned if _key(x)[0] not in storages]
  if returned and not fresh and not writes:
    return 0
  for x in fresh:
    writes[_key(x)] = x
  extra = 0
  if packet in _GATHERS:
    source = _tensors(args[0])[0]
    reads.pop(_key(source), None)
    if device is None or source.device == device:
      extra = sum(_reach(x) for x in _tensors(out)) * source.element_size()
  elif packet in _INDEX_WRITES:
    target = _tensors(args[0])[0]
    reads.pop(_key(target), None)
    writes.pop(_key(target), None)
    # The elements written: the values, or the rows the indices pick where
    # the values broadcast.
    indices = [x for x in args[1] if x is not None]
    picked = math.prod(torch.broadcast_shapes(*(x.shape for x in indices)))
    written = max(_reach(args[2]),
                  picked * math.prod(target.shape[len(args[1]):]))
    accumulate = len(args) > 3 and bool(args[3])
    if device is None or target.device == device:
      extra = (1 + accumulate) * written * target.element_size()
  count = lambda xs: sum(tensor_bytes(x) for x in xs.values()
                         if device is None or x.device == device)
  return count(reads) + count(writes) + extra


def op_flops(func, args, kwargs, out):
  """The FLOPs `FlopCounterMode` counts for one call of `func`."""
  formula = flop_registry.get(func._overloadpacket)
  return int(formula(*args, **kwargs, out_val=out)) if formula else 0


class CostMode(TorchDispatchMode):
  """Counts the FLOPs and the bytes of every aten op that runs under it
  (see the module docstring): `flops`, `nbytes`, and `table`, {op or
  kernel name: [calls, flops, bytes]}. `device`: count only the bytes of
  tensors on this device (None: all)."""

  def __init__(self, device=None):
    super().__init__()
    self.device = None if device is None else torch.device(device)
    if self.device is not None and self.device.type == 'cuda' and (
        self.device.index is None):
      self.device = torch.device('cuda', torch.cuda.current_device())
    self.flops = 0
    self.nbytes = 0
    self.table = collections.defaultdict(lambda: [0, 0, 0])
    self._paused = 0
    self._depth = 0  # Entered again to decompose an op.

  def __enter__(self):
    if not self._depth:
      _ACTIVE.append(self)
    self._depth += 1
    return super().__enter__()

  def __exit__(self, *exc):
    self._depth -= 1
    if not self._depth:
      _ACTIVE.remove(self)
    return super().__exit__(*exc)

  def add(self, name, flops, nbytes):
    row = self.table[name]
    row[0] += 1
    row[1] += int(flops)
    row[2] += int(nbytes)
    self.flops += int(flops)
    self.nbytes += int(nbytes)

  def cost(self):
    """{'flops', 'bytes accessed'}, as XLA's cost analysis names them."""
    return {'flops': self.flops, 'bytes accessed': self.nbytes}

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    kwargs = kwargs or {}
    if self._paused:
      return func(*args, **kwargs)
    # As FlopCounterMode: an op with a decomposition is counted as its
    # parts.
    if func is not torch.ops.prim.device.default:
      with self:
        result = func.decompose(*args, **kwargs)
      if result is not NotImplemented:
        return result
    out = func(*args, **kwargs)
    self.add(func._schema.name, op_flops(func, args, kwargs, out),
             op_bytes(func, args, kwargs, out, self.device))
    return out


@contextlib.contextmanager
def kernel(name, work):
  """Inside: one launch of the kernel `name`, whose (flops, bytes) are
  `work`, a function called only while a counter is open. Every open
  counter adds the formula's numbers and counts nothing that runs
  inside."""
  counters = list(_ACTIVE)
  if counters:
    flops, nbytes = work()
    for counter in counters:
      counter.add(name, flops, nbytes)
      counter._paused += 1
  try:
    yield
  finally:
    for counter in counters:
      counter._paused -= 1


def itemsize(dtype):
  return torch.finfo(dtype).bits // 8


def bound(flops, nbytes, dtype):
  """Least time of a piece of work on the card, ms: the larger of its
  operations over the peak for `dtype` (bfloat16 on the tensor cores, else
  float32 outside them) and its bytes over the memory rate."""
  peak = H100['bf16_flops'] if dtype == torch.bfloat16 else H100['f32_flops']
  t_ops, t_bytes = flops / peak * 1e3, nbytes / H100['hbm_bytes'] * 1e3
  return dict(bound_ms=max(t_ops, t_bytes),
              bound_by='operations' if t_ops >= t_bytes else 'bytes',
              flops=flops, nbytes=nbytes)

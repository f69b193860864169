"""State model of the port: `torch.nn.Module`s whose flat state carries the
JAX package's names (the counterpart of `daydreamer_tpu/nn/module.py`).

Every module is built with its full `/`-separated path (`agent/wm/rssm`)
and creates its state lazily, on the creation pass, through `value()`, so
the module tree and the state names are those of the JAX package.
Trainable entries are `torch.nn.Parameter`s registered on their module;
every other entry (controller statistics, counters, optimizer slots) lives
in the module's `values` dict, because its name may hold characters that
PyTorch's buffer names refuse (`m/agent.wm.rssm.img_in.kernel`).

Layouts follow PyTorch's operators where they differ from the JAX package;
`from_jax_state` and `to_jax_state` convert between the two:

- Linear kernels are `[in, out]` on both sides (`x @ kernel`).
- Conv kernels: JAX HWIO, here OIHW (as `F.conv2d` takes them).
- Transposed conv kernels: JAX `(k, k, out, in)`, applied without a flip by
  `lax.conv_transpose`; here `(in, out, k, k)` flipped in space, as
  `F.conv_transpose2d` (the gradient of a convolution) takes them.
- Optimizer slots `m/<param>` and `v/<param>` follow their parameter.

Every entry keeps, after creation, the tensor it was created with: the
optimizer and `write` update entries in place, so a CUDA graph captured
over an update reads and writes the live state at every replay.

A call runs inside `scope(...)`, which carries what `nn.pure` carried in the
JAX package: the compute dtype, the agent's `torch.Generator`, whether this
is the creation pass, and an optional log of the state names read (to find
the entries the policy needs).
"""

import contextlib
import contextvars
import dataclasses
import typing

import numpy as np
import torch


@dataclasses.dataclass
class Scope:
  dtype: torch.dtype = torch.float32
  generator: typing.Optional[torch.Generator] = None
  create: bool = False
  read_log: typing.Optional[set] = None


_SCOPE = contextvars.ContextVar('daydreamer_tpu_torch_scope', default=Scope())


@contextlib.contextmanager
def scope(**kwargs):
  token = _SCOPE.set(Scope(**kwargs))
  try:
    yield
  finally:
    _SCOPE.reset(token)


def creating():
  return _SCOPE.get().create


def compute_dtype():
  return _SCOPE.get().dtype


def rng():
  """The agent's generator (the counterpart of `nn.rng()` in JAX)."""
  return _SCOPE.get().generator


def device():
  gen = _SCOPE.get().generator
  return gen.device if gen is not None else torch.device('cpu')


def tree_map(fn, *trees):
  first = trees[0]
  if isinstance(first, dict):
    return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
  if isinstance(first, (tuple, list)):
    return type(first)(tree_map(fn, *xs) for xs in zip(*trees))
  return fn(*trees)


def cast(values):
  """Floating tensors of a tree to the compute dtype."""
  dtype = compute_dtype()
  return tree_map(
      lambda x: x.to(dtype)
      if isinstance(x, torch.Tensor) and x.is_floating_point() else x,
      values)


def sg(values):
  return tree_map(
      lambda x: x.detach() if isinstance(x, torch.Tensor) else x, values)


def uniform(shape, limit):
  """Uniform(-limit, limit) float32 values from the scope's generator."""
  u = torch.rand(shape, generator=rng(), device=device(), dtype=torch.float32)
  return (2 * u - 1) * limit


def scan(fn, inputs, start, reverse=False):
  """Python loop over the leading axis: fn(carry, inp) -> new carry; returns
  the stacked new carries (the contract of `nn.scan` in JAX)."""
  length = len(inputs[0] if isinstance(inputs, (tuple, list)) else inputs)
  indices = range(length)
  if reverse:
    indices = reversed(indices)
  last, outputs = start, []
  for index in indices:
    inp = tree_map(lambda x: x[index], inputs)
    last = fn(last, inp)
    outputs.append(last)
  if reverse:
    outputs.reverse()
  return tree_map(lambda *xs: torch.stack(xs, 0), *outputs)


class Module(torch.nn.Module):
  """Base class: explicit-name modules forming a `/`-separated path tree."""

  def __init__(self, name):
    super().__init__()
    self._path = name
    self.values = {}

  @property
  def path(self):
    return self._path

  def extra_repr(self):
    return self._path

  def ref(self, name, module):
    """Keep a module created elsewhere as an attribute without making it a
    child, so its state is not counted twice."""
    self.__dict__[name] = module
    return module

  def sub(self, name, ctor=None, *args, **kwargs):
    """Get-or-create a named child module."""
    if name not in self._modules:
      assert ctor is not None, (self._path, name)
      self.add_module(name, ctor(f'{self._path}/{name}', *args, **kwargs))
    return self._modules[name]

  def value(self, name, init, trainable=True, dtype=None):
    """Get-or-create a named state entry. `init` is a tensor, a number, or
    a callable returning the initial tensor."""
    scope_ = _SCOPE.get()
    if name in self._parameters:
      tensor = self._parameters[name]
    elif name in self.values:
      tensor = self.values[name]
    else:
      if not scope_.create:
        raise KeyError(
            f'Unknown state entry {self._path}/{name}. '
            'Run a creation pass first.')
      tensor = init() if callable(init) else torch.as_tensor(init, dtype=dtype)
      tensor = tensor.to(device(), dtype)
      if trainable:
        self.register_parameter(name, torch.nn.Parameter(tensor))
        tensor = self._parameters[name]
      else:
        self.values[name] = tensor
    if scope_.read_log is not None:
      scope_.read_log.add(f'{self._path}/{name}')
    return tensor

  def write(self, name, value):
    """Update a non-trainable state entry in place: the tensor made at
    creation keeps its address, so a captured CUDA graph that writes it
    writes the live entry. Raises on a shape or dtype other than the
    entry's. On the creation pass an entry that does not exist yet is
    made."""
    if name not in self.values:
      if not creating():
        raise KeyError(
            f'Cannot write unknown state entry {self._path}/{name}.')
      self.values[name] = value.detach().clone()
      return value
    target = self.values[name]
    if target.shape != value.shape or target.dtype != value.dtype:
      raise ValueError(
          f'{self._path}/{name}: cannot write {tuple(value.shape)} '
          f'{value.dtype} into {tuple(target.shape)} {target.dtype}.')
    with torch.no_grad():
      target.copy_(value)
    return value

  def named_state(self, trainable=None):
    """Sorted (name, tensor) pairs of this subtree. trainable=True gives the
    parameters, False the other entries, None both."""
    out = {}
    for module in self.modules():
      if not isinstance(module, Module):
        continue
      if trainable in (True, None):
        for key, tensor in module._parameters.items():
          out[f'{module.path}/{key}'] = tensor
      if trainable in (False, None):
        for key, tensor in module.values.items():
          out[f'{module.path}/{key}'] = tensor
    return sorted(out.items())


def state(root):
  """Flat {JAX name: tensor in the port's layout} of every entry."""
  return dict(root.named_state())


def kinds(root):
  """{kernel name: 'conv' | 'convT'} for every convolution kernel."""
  out = {}
  for module in root.modules():
    kind = getattr(module, 'kind', None)
    if kind and 'kernel' in module._parameters:
      out[f'{module.path}/kernel'] = kind
  return out


def _param_of(key):
  """The parameter an entry follows: itself, or the parameter of an
  optimizer slot `.../m/agent.x.kernel`."""
  prefix, last = key.rsplit('/', 1)
  if prefix.endswith(('/m', '/v')) and '.' in last:
    return last.replace('.', '/')
  return key


def _to_port(value, kind):
  if kind == 'conv':
    return value.permute(3, 2, 0, 1)
  if kind == 'convT':
    return value.flip(0, 1).permute(3, 2, 0, 1)
  return value


def _to_jax(value, kind):
  if kind == 'conv':
    return value.permute(2, 3, 1, 0)
  if kind == 'convT':
    return value.permute(2, 3, 1, 0).flip(0, 1)
  return value


def from_jax_state(values, kinds_):
  """{name: array in the JAX package's layout} -> {name: CPU tensor in the
  port's layout}. `kinds_` is `kinds(root)` of the receiving module."""
  out = {}
  for key, value in values.items():
    tensor = torch.as_tensor(np.array(value))
    out[key] = _to_port(tensor, kinds_.get(_param_of(key))).contiguous()
  return out


def to_jax_state(tensors, kinds_):
  """Inverse of `from_jax_state`: numpy arrays in the JAX layout."""
  out = {}
  for key, tensor in tensors.items():
    tensor = _to_jax(tensor.detach().cpu(), kinds_.get(_param_of(key)))
    out[key] = tensor.contiguous().numpy()
  return out


def assign(root, values):
  """Copy {name: tensor in the port's layout} into the live state in place."""
  live = state(root)
  for key, value in values.items():
    target = live[key]
    if tuple(target.shape) != tuple(value.shape):
      raise ValueError(f'{key}: shape {tuple(value.shape)} does not match '
                       f'{tuple(target.shape)}')
    with torch.no_grad():
      target.copy_(value.to(target.device, target.dtype))

"""Layers with the reference's uniform fan-in initialization, the port of
`daydreamer_tpu/nn/layers.py`.

Parameters are stored float32 and cast to the compute dtype at read time,
so matrix products run in bf16 under `precision: bfloat16` while the
optimizer state stays full precision. Images stay NHWC at every public
function, as in the JAX package; a convolution hands cuDNN a channels-last
view of the same memory.

A LayerNorm and the activation after it run as one call of
`ops.norm.layer_norm_act` (one kernel each way on the card, as XLA fuses
them in the JAX program), which takes the activation's name and callable
and decides which activations its kernel applies (`none` and `elu`, the
only ones the configs pair with `norm: layer`).
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import norm as fused
from .module import Module, cast, uniform


def get_act(name):
  if callable(name):
    return name
  elif name == 'none':
    return lambda x: x
  elif name == 'mish':
    return lambda x: x * torch.tanh(F.softplus(x))
  elif name == 'elu':
    return F.elu
  elif name == 'relu':
    return F.relu
  elif name == 'gelu':
    return lambda x: F.gelu(x, approximate='tanh')
  elif name == 'silu' or name == 'swish':
    return F.silu
  elif name == 'tanh':
    return torch.tanh
  elif name == 'sigmoid':
    return torch.sigmoid
  else:
    raise NotImplementedError(name)


class Linear(Module):
  """Dense layer; the kernel is stored [in, out], as in the JAX package."""

  def __init__(self, name, units, act='none', norm='none', bias=True,
               outscale=1.0):
    super().__init__(name)
    self._units = units
    self._act = get_act(act)
    self._actname = act
    self._norm = norm
    self._bias = bias and norm == 'none'
    self._outscale = outscale

  def forward(self, x):
    return norm_act(self, self.product(x))

  def product(self, x):
    """The layer before its norm and activation: x @ kernel, and the bias
    where there is no norm."""
    shape = (x.shape[-1], self._units)
    limit = np.sqrt(3.0 * self._outscale / np.mean(shape))
    kernel = self.value('kernel', lambda: uniform(shape, limit))
    x = cast(x) @ cast(kernel)
    if self._bias:
      x = x + cast(self.value('bias', torch.zeros(self._units)))
    return x

  def norm_affine(self, C):
    """The float32 scale and bias of the layer's norm over C columns, or
    (None, None) under `norm: none`."""
    if self._norm == 'none':
      return None, None
    return self.sub('norm', Norm, self._norm).affine(C)


def norm_act(layer, x):
  """The layer's norm and then its activation: one call of
  `ops.norm.layer_norm_act` under `norm: layer`."""
  if layer._norm == 'none':
    return layer._act(x)
  norm = layer.sub('norm', Norm, layer._norm)
  return fused.layer_norm_act(x, *norm.affine(x.shape[-1]), layer._actname,
                              layer._act)


class Conv2D(Module):
  """NHWC convolution; kernels are stored OIHW, transposed ones (in, out,
  kH, kW) flipped in space, as PyTorch's convolutions take them."""

  def __init__(self, name, depth, kernel, stride=1, transp=False, act='none',
               norm='none', pad='same', bias=True, preact=False):
    super().__init__(name)
    self._depth = depth
    self._kernel = kernel
    self._stride = stride
    self._transp = transp
    self._act = get_act(act)
    self._actname = act
    self._norm = norm
    self._pad = pad.upper()
    self._preact = preact
    self._bias = bias and norm == 'none'
    self.kind = 'convT' if transp else 'conv'

  def forward(self, x):
    if self._preact:
      return self._layer(norm_act(self, x))
    return norm_act(self, self._layer(x))

  def _layer(self, x):
    k, depth, cin = self._kernel, self._depth, x.shape[-1]
    if self._transp:
      limit = np.sqrt(3.0 / (k * k * np.mean([depth, cin])))
      kernel = cast(self.value(
          'kernel', lambda: uniform((cin, depth, k, k), limit)))
      x = cast(x)
      if x.shape[1] == x.shape[2] == 1 and self._pad == 'VALID':
        # A transposed conv over a 1x1 input is a dense layer: output
        # pixel (i, j) reads the single input pixel through its own
        # filter slice (see tests/test_nn.py::test_convT_1x1_dense_path).
        w = kernel.permute(0, 2, 3, 1).reshape(cin, k * k * depth)
        x = (x.reshape(x.shape[0], cin) @ w).reshape(
            x.shape[0], k, k, depth)
      else:
        x = F.conv_transpose2d(
            x.permute(0, 3, 1, 2), kernel, stride=self._stride)
        if self._pad != 'VALID':
          # The full output, (H - 1) * s + k, pads k - 1 on either side of
          # the dilated input; XLA's SAME pads (a, b) of `same_transposed`:
          # crop (or pad with zeros) the difference.
          a, b = same_transposed(k, self._stride)
          x = F.pad(x, [a - (k - 1), b - (k - 1)] * 2)
        x = x.permute(0, 2, 3, 1)
    else:
      limit = np.sqrt(3.0 / np.mean([cin, depth]))
      kernel = cast(self.value(
          'kernel', lambda: uniform((depth, cin, k, k), limit)))
      x = cast(x).permute(0, 3, 1, 2)
      if self._pad != 'VALID':
        (top, bottom), (left, right) = (
            same(n, k, self._stride) for n in x.shape[2:])
        x = F.pad(x, [left, right, top, bottom])
      x = F.conv2d(x, kernel, stride=self._stride)
      x = x.permute(0, 2, 3, 1)
    if self._bias:
      x = x + cast(self.value('bias', torch.zeros(depth)))
    return x


def same(n, k, s):
  """XLA's SAME padding of a convolution along an axis of n: (before,
  after), the smaller half before."""
  total = max((math.ceil(n / s) - 1) * s + k - n, 0)
  return total // 2, total - total // 2


def same_transposed(k, s):
  """`lax.conv_transpose`'s SAME padding of the dilated input (before,
  after), which makes the output n * s (`_conv_transpose_padding`)."""
  total = k + s - 2
  before = k - 1 if s > k - 1 else math.ceil(total / 2)
  return before, total - before


class Norm(Module):
  """LayerNorm over the last axis in float32 with eps 1e-3, rounded to the
  input's dtype."""

  def __init__(self, name, impl):
    super().__init__(name)
    self._impl = impl

  def forward(self, x):
    if self._impl == 'none':
      return x
    return fused.layer_norm_act(x, *self.affine(x.shape[-1]))

  def affine(self, C):
    """The float32 scale and bias over C columns."""
    if self._impl != 'layer':
      raise NotImplementedError(self._impl)
    return (self.value('scale', torch.ones(C)),
            self.value('bias', torch.zeros(C)))


class Input:
  """Gathers, flattens, and concatenates named features in the order of
  `keys` (reference: nets.py:605-626). E.g. Input(['deter', 'stoch'])."""

  def __init__(self, keys=('tensor',), dims=None):
    assert isinstance(keys, (list, tuple)), keys
    self._keys = tuple(keys)
    self._dims = dims or self._keys[0]

  def __call__(self, inputs):
    if not isinstance(inputs, dict):
      inputs = {'tensor': inputs}
    if not all(k in inputs for k in self._keys):
      needs = f'{{{", ".join(self._keys)}}}'
      found = f'{{{", ".join(inputs.keys())}}}'
      raise KeyError(f'Cannot find keys {needs} among inputs {found}.')
    values = [inputs[k] for k in self._keys]
    dims = len(inputs[self._dims].shape)
    for i, value in enumerate(values):
      if len(value.shape) > dims:
        values[i] = value.reshape(value.shape[:dims - 1] + (-1,))
    dtype = inputs[self._dims].dtype
    return torch.cat([x.to(dtype) for x in values], -1)

"""Layers with the reference's uniform fan-in initialization, the port of
`daydreamer_tpu/nn/layers.py`.

Parameters are stored float32 and cast to the compute dtype at read time,
so matrix products run in bf16 under `precision: bfloat16` while the
optimizer state stays full precision. Images stay NHWC at every public
function, as in the JAX package; a convolution hands cuDNN a channels-last
view of the same memory.
"""

import numpy as np
import torch
import torch.nn.functional as F

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
    self._norm = norm
    self._bias = bias and norm == 'none'
    self._outscale = outscale

  def forward(self, x):
    shape = (x.shape[-1], self._units)
    limit = np.sqrt(3.0 * self._outscale / np.mean(shape))
    kernel = self.value('kernel', lambda: uniform(shape, limit))
    x = cast(x) @ cast(kernel)
    if self._bias:
      x = x + cast(self.value('bias', torch.zeros(self._units)))
    if self._norm != 'none':
      x = self.sub('norm', Norm, self._norm)(x)
    return self._act(x)


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
    self._norm = norm
    self._pad = pad.upper()
    self._preact = preact
    self._bias = bias and norm == 'none'
    self.kind = 'convT' if transp else 'conv'

  def forward(self, x):
    if self._preact:
      x = self.sub('norm', Norm, self._norm)(x)
      x = self._act(x)
      return self._layer(x)
    x = self._layer(x)
    x = self.sub('norm', Norm, self._norm)(x)
    return self._act(x)

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
        if self._pad != 'VALID':
          raise NotImplementedError('Transposed conv with same padding.')
        x = F.conv_transpose2d(
            x.permute(0, 3, 1, 2), kernel, stride=self._stride)
        x = x.permute(0, 2, 3, 1)
    else:
      limit = np.sqrt(3.0 / np.mean([cin, depth]))
      kernel = cast(self.value(
          'kernel', lambda: uniform((depth, cin, k, k), limit)))
      if self._pad == 'VALID':
        padding = 0
      elif self._stride == 1 and k % 2 == 1:
        padding = k // 2
      else:
        raise NotImplementedError((self._pad, self._stride, k))
      x = F.conv2d(cast(x).permute(0, 3, 1, 2), kernel,
                   stride=self._stride, padding=padding)
      x = x.permute(0, 2, 3, 1)
    if self._bias:
      x = x + cast(self.value('bias', torch.zeros(depth)))
    return x


class Norm(Module):
  """LayerNorm over the last axis in float32 with eps 1e-3."""

  def __init__(self, name, impl):
    super().__init__(name)
    self._impl = impl

  def forward(self, x):
    if self._impl == 'none':
      return x
    elif self._impl == 'layer':
      scale = self.value('scale', torch.ones(x.shape[-1]))
      bias = self.value('bias', torch.zeros(x.shape[-1]))
      y = F.layer_norm(x.float(), (x.shape[-1],), scale, bias, eps=1e-3)
      return y.to(x.dtype)
    else:
      raise NotImplementedError(self._impl)


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

"""World-model networks: RSSM, multi-modal encoders/decoders, dist heads.

The port of `daydreamer_tpu/models/nets.py`. Observe and imagine run the
RSSM cell in a Python loop over the time axis (`rssm.impl: scan`), or
observe runs the whole chunk as the fused chain of `ops/rssm_vjp.py`
(`rssm.impl: pallas`, the name the JAX package's configs use; here a pair
of CUDA kernels). All dense/conv compute runs in the compute dtype;
distribution statistics are float32. Images are NHWC at every public
function, as in the JAX package.
"""

import re

import numpy as np
import torch
import torch.nn.functional as F

from .. import nn
from ..nn import Module, Linear, Conv2D, Input
from ..nn import dists as distslib

cast = nn.cast
sg = nn.sg


def _swap(x):
  return x.transpose(0, 1)


class RSSM(Module):
  """Discrete-latent recurrent state-space model (reference: nets.py:11-183).

  State: {deter, logit, stoch[stoch x classes]} (or Gaussian {mean, std,
  stoch} when classes=0). Learned initial state variants zeros/learned/
  learned2; `unimix` uniform-mixture logits; KL balancing.
  """

  def __init__(self, name, deter=1024, stoch=32, classes=32, unroll=1,
               initial='zeros', unimix=0.0, prior_layers=1, post_layers=1,
               gru_layers=1, impl='scan', **kw):
    super().__init__(name)
    self._deter = deter
    self._stoch = stoch
    self._classes = classes
    self._initial = initial
    self._unimix = unimix
    self._prior_layers = prior_layers
    self._post_layers = post_layers
    self._gru_layers = gru_layers
    self._impl = impl
    self._kw = kw
    del unroll  # A compile-time knob of the JAX scan; a loop here.

  def state_keys(self):
    return ('deter', 'logit', 'stoch') if self._classes else (
        'deter', 'mean', 'std', 'stoch')

  def initial(self, batch_size):
    dev = nn.device()
    zeros = lambda *shape: torch.zeros(shape, device=dev)
    if self._classes:
      state = dict(
          deter=zeros(batch_size, self._deter),
          logit=zeros(batch_size, self._stoch, self._classes),
          stoch=zeros(batch_size, self._stoch, self._classes))
    else:
      state = dict(
          deter=zeros(batch_size, self._deter),
          mean=zeros(batch_size, self._stoch),
          std=torch.ones((batch_size, self._stoch), device=dev),
          stoch=zeros(batch_size, self._stoch))
    state = cast(state)
    if self._initial == 'zeros':
      return state
    elif self._initial == 'learned':
      deter = self.value('initial_deter', lambda: torch.zeros(self._deter))
      stoch = self.value(
          'initial_stoch', lambda: torch.zeros(state['stoch'].shape[1:]))
      state['deter'] = cast(deter)[None].repeat(batch_size, 1)
      state['stoch'] = cast(stoch)[None].repeat(
          (batch_size,) + (1,) * stoch.dim())
      return state
    elif self._initial == 'learned2':
      deter = self.value('initial_deter', lambda: torch.zeros(self._deter))
      state['deter'] = cast(torch.tanh(deter))[None].repeat(batch_size, 1)
      state['stoch'] = self.get_stoch(state['deter'])
      return state
    else:
      raise NotImplementedError(self._initial)

  def observe(self, embed, action, is_first, state=None):
    if state is None:
      state = self.initial(action.shape[0])
    if self._impl == 'pallas' and not nn.creating():
      return self._observe_fused(embed, action, is_first, state)
    step = lambda prev, inputs: self.obs_step(prev[0], *inputs)
    inputs = (_swap(action), _swap(embed), _swap(is_first))
    post, prior = nn.scan(step, inputs, (state, state))
    post = {k: _swap(v) for k, v in post.items()}
    prior = {k: _swap(v) for k, v in prior.items()}
    return post, prior

  @property
  def fused_compatible(self):
    """Whether the fused kernels can express this RSSM: discrete latents
    with power-of-two classes and single post/GRU layers."""
    return bool(
        self._classes and (self._classes & (self._classes - 1)) == 0
        and self._post_layers == 1 and self._gru_layers == 1)

  def fused_img_params(self):
    """img_step cell weights for the fused kernels, sliced from the SAME
    named state entries the loop path creates; concat kernels split into
    their two operands (concat(a,b) @ W == a @ W[:n] + b @ W[n:]). The
    row slices of an [in, out] kernel are contiguous views."""
    assert self.fused_compatible, (
        self._classes, self._post_layers, self._gru_layers)
    get = lambda path, key: cast(self.get_submodule(path).value(key, None))
    SC = self._stoch * self._classes
    D = self._deter
    w_img_in = get('img_in', 'kernel')
    w_gru = get('gru_out', 'kernel')
    n = range(self._prior_layers)
    return {
        'w_in_s': w_img_in[:SC], 'w_in_a': w_img_in[SC:],
        'ln_in_scale': get('img_in.norm', 'scale'),
        'ln_in_bias': get('img_in.norm', 'bias'),
        'w_gru_d': w_gru[:D], 'w_gru_x': w_gru[D:],
        'ln_gru_scale': get('gru_out.norm', 'scale'),
        'ln_gru_bias': get('gru_out.norm', 'bias'),
        'w_out': [get(f'img_out_{i}', 'kernel') for i in n],
        'ln_out_scale': [get(f'img_out_{i}.norm', 'scale') for i in n],
        'ln_out_bias': [get(f'img_out_{i}.norm', 'bias') for i in n],
        'w_st': get('img_stats', 'kernel'), 'b_st': get('img_stats', 'bias'),
        'stoch_n': self._stoch, 'classes': self._classes,
    }

  def _observe_fused(self, embed, action, is_first, state):
    """The whole chunk's posterior chain as one forward and one backward
    kernel (`ops/rssm_vjp.py`), chosen by `rssm.impl: pallas`.

    The creation pass always runs the loop path, so this path reads the
    SAME named state entries; the concat kernels are sliced into their two
    operands inside the graph, so each slice's gradient reaches its master
    weight. It differs from the loop as the JAX package's fused path does:
    one Gumbel draw for the whole chunk, the prior's unused stoch is its
    mode, and `is_first` zeroes the incoming state instead of replacing it
    by the initial state."""
    from ..ops import rssm_vjp
    get = lambda path, key: cast(self.get_submodule(path).value(key, None))
    SC = self._stoch * self._classes
    D = self._deter
    w_obs = get('obs_out', 'kernel')
    params = {
        **self.fused_img_params(),
        'w_obs_d': w_obs[:D], 'w_obs_e': w_obs[D:],
        'ln_obs_scale': get('obs_out.norm', 'scale'),
        'ln_obs_bias': get('obs_out.norm', 'bias'),
        'w_post': get('obs_stats', 'kernel'),
        'b_post': get('obs_stats', 'bias'),
    }
    B = action.shape[0]
    stoch0 = cast(state['stoch']).reshape(B, SC).contiguous()
    deter0 = cast(state['deter']).contiguous()
    acts = cast(_swap(action))
    if acts.dim() > 3:  # 2D (onehot-matrix) actions flatten like img_step.
      acts = acts.reshape(tuple(acts.shape[:2]) + (-1,))
    deters, post_logits, prior_logits, stochs = rssm_vjp.observe_fused(
        params, stoch0, deter0, acts.contiguous(),
        cast(_swap(embed)).contiguous(), _swap(is_first).contiguous(),
        generator=nn.rng(), unimix=self._unimix, sample=True)
    shape = lambda x: x.reshape(
        tuple(x.shape[:2]) + (self._stoch, self._classes))
    dtype = stoch0.dtype
    # The kernel returns RAW stats-layer logits; the loop path stores unimix
    # log-probs (see _stats_layer), which get_dist and kl_loss consume.
    post_logit = self._unimix_logit(_swap(shape(post_logits)))
    post = {
        'stoch': _swap(shape(stochs)).to(dtype),
        'deter': _swap(deters).to(dtype),
        'logit': post_logit.to(dtype)}
    prior_logit = self._unimix_logit(_swap(shape(prior_logits)))
    prior_mode = F.one_hot(prior_logit.argmax(-1), self._classes)
    prior = {
        'stoch': prior_mode.to(dtype),
        'deter': post['deter'],
        'logit': prior_logit.to(dtype)}
    return post, prior

  def imagine(self, action, state=None):
    if state is None:
      state = self.initial(action.shape[0])
    assert isinstance(state, dict), state
    prior = nn.scan(self.img_step, _swap(action), state)
    return {k: _swap(v) for k, v in prior.items()}

  def get_dist(self, state):
    if self._classes:
      logit = state['logit'].float()
      return distslib.Independent(distslib.OneHotDist(logit), 1)
    else:
      return distslib.MultivariateNormalDiag(
          state['mean'].float(), state['std'].float())

  def obs_step(self, prev_state, prev_action, embed, is_first):
    prev_state, prev_action = cast((prev_state, prev_action))
    is_first = cast(is_first)
    mask = lambda x, m: x * m.reshape(m.shape + (1,) * (x.dim() - 1))
    prev_state = nn.tree_map(lambda x: mask(x, 1.0 - is_first), prev_state)
    prev_action = mask(prev_action, 1.0 - is_first)
    init = self.initial(is_first.shape[0])
    prev_state = nn.tree_map(
        lambda x, y: x + mask(cast(y), is_first), prev_state, init)
    prior = self.img_step(prev_state, prev_action)
    x = torch.cat([prior['deter'], embed.to(prior['deter'].dtype)], -1)
    for i in range(self._post_layers - 1):
      x = self.sub(f'obs_out_{i}', Linear, **self._kw)(x)
    x = self.sub('obs_out', Linear, **self._kw)(x)
    stats = self._stats_layer('obs_stats', x)
    dist = self.get_dist(stats)
    stoch = cast(dist.sample(nn.rng()))
    post = {'stoch': stoch, 'deter': prior['deter'], **stats}
    return post, prior

  def img_step(self, prev_state, prev_action):
    prev_stoch = cast(prev_state['stoch'])
    prev_action = cast(prev_action)
    if self._classes:
      prev_stoch = prev_stoch.reshape(
          prev_stoch.shape[:-2] + (self._stoch * self._classes,))
    if len(prev_action.shape) > len(prev_stoch.shape):  # 2D actions.
      prev_action = prev_action.reshape(prev_action.shape[:-2] + (-1,))
    x = torch.cat([prev_stoch, prev_action], -1)
    x = self.sub('img_in', Linear, **self._kw)(x)
    x, deter = self._gru(x, prev_state['deter'])
    for i in range(self._prior_layers):
      x = self.sub(f'img_out_{i}', Linear, **self._kw)(x)
    stats = self._stats_layer('img_stats', x)
    dist = self.get_dist(stats)
    stoch = cast(dist.sample(nn.rng()))
    return {'stoch': stoch, 'deter': deter, **stats}

  def get_stoch(self, deter):
    x = deter
    for i in range(self._prior_layers):
      x = self.sub(f'img_out_{i}', Linear, **self._kw)(x)
    stats = self._stats_layer('img_stats', x)
    return cast(self.get_dist(stats).mode())

  def _gru(self, x, deter):
    """Custom GRU with update-bias -1 (reference: nets.py:149-160); one
    fused 3*deter matmul over [deter, x]."""
    x = torch.cat([cast(deter), x], -1)
    for i in range(self._gru_layers - 1):
      x = self.sub(f'gru_{i}', Linear, **self._kw)(x)
    kw = {**self._kw, 'act': 'none', 'units': 3 * self._deter}
    x = self.sub('gru_out', Linear, **kw)(x)
    reset, cand, update = torch.chunk(x, 3, -1)
    reset = torch.sigmoid(reset)
    cand = torch.tanh(reset * cand)
    update = torch.sigmoid(update - 1)
    deter = update * cand + (1 - update) * cast(deter)
    return deter, deter

  def _unimix_logit(self, logit):
    # Mix the categorical with a uniform floor and store log-probs, so
    # every consumer (KL, entropy, sampling) sees the same distribution.
    if not self._unimix:
      return logit
    probs = torch.softmax(logit.float(), -1)
    probs = (1 - self._unimix) * probs + self._unimix / probs.shape[-1]
    return torch.log(probs).to(logit.dtype)

  def _stats_layer(self, name, x):
    # Stats stay in the compute dtype so the carry has a uniform dtype;
    # get_dist casts to float32 for the distribution math.
    if self._classes:
      x = self.sub(name, Linear, self._stoch * self._classes)(x)
      logit = x.reshape(x.shape[:-1] + (self._stoch, self._classes))
      return {'logit': self._unimix_logit(logit)}
    else:
      x = self.sub(name, Linear, 2 * self._stoch)(x)
      mean, std = torch.chunk(x, 2, -1)
      std = 2 * torch.sigmoid(std.float() / 2) + 0.1
      return {'mean': mean, 'std': std.to(x.dtype)}

  def kl_loss(self, post, prior, balance=0.8):
    """KL balancing (reference: nets.py:178-183)."""
    lhs = self.get_dist(sg(post)).kl(self.get_dist(prior))
    rhs = self.get_dist(post).kl(self.get_dist(sg(prior)))
    return balance * lhs + (1 - balance) * rhs


class MultiEncoder(Module):
  """Regex-keyed fusion of image (CNN) + proprio (MLP) observations
  (reference: nets.py:186-232)."""

  def __init__(self, name, shapes, cnn_keys=r'.*', mlp_keys=r'.*',
               mlp_layers=4, mlp_units=512, cnn='simple', cnn_depth=48,
               cnn_kernels=(4, 4, 4, 4), cnn_blocks=2, **kw):
    super().__init__(name)
    excluded = ('is_first', 'is_last')
    shapes = {k: v for k, v in shapes.items() if k not in excluded}
    self.cnn_shapes = {
        k: v for k, v in shapes.items()
        if re.match(cnn_keys, k) and len(v) == 3}
    self.mlp_shapes = {
        k: v for k, v in shapes.items()
        if re.match(mlp_keys, k) and len(v) in (0, 1)}
    self.shapes = {**self.cnn_shapes, **self.mlp_shapes}
    assert self.shapes, (shapes, cnn_keys, mlp_keys)
    if self.cnn_shapes:
      if cnn == 'simple':
        self.sub('cnn', ImageEncoderSimple, cnn_depth, cnn_kernels, **kw)
      elif cnn == 'resnet':
        self.sub('cnn', ImageEncoderResnet, cnn_depth, cnn_blocks, **kw)
      else:
        raise NotImplementedError(cnn)
    if self.mlp_shapes:
      self.sub('mlp', MLP, None, mlp_layers, mlp_units, dist='none', **kw)

  def forward(self, data):
    some_key, some_shape = list(self.shapes.items())[0]
    batch_dims = tuple(data[some_key].shape[
        :len(data[some_key].shape) - len(some_shape)])
    data = {
        k: v.reshape((-1,) + tuple(v.shape[len(batch_dims):]))
        for k, v in data.items() if k in self.shapes}
    outputs = []
    if self.cnn_shapes:
      inputs = torch.cat([data[k] for k in self.cnn_shapes], -1)
      output = self.sub('cnn')(inputs)
      outputs.append(output.reshape(output.shape[0], -1))
    if self.mlp_shapes:
      inputs = [
          data[k][..., None] if len(self.shapes[k]) == 0 else data[k]
          for k in self.mlp_shapes]
      inputs = torch.cat([cast(x.float()) for x in inputs], -1)
      outputs.append(self.sub('mlp')(inputs))
    outputs = torch.cat(outputs, -1)
    return outputs.reshape(batch_dims + tuple(outputs.shape[1:]))


class MultiDecoder(Module):
  """Splits CNN output channels back per image key; MLP heads for vectors
  (reference: nets.py:235-288)."""

  def __init__(self, name, shapes, inputs=('tensor',), cnn_keys=r'.*',
               mlp_keys=r'.*', mlp_layers=4, mlp_units=512, cnn='simple',
               cnn_depth=48, cnn_kernels=(5, 5, 6, 6), cnn_blocks=2,
               image_dist='mse', **kw):
    super().__init__(name)
    excluded = ('is_first', 'is_last', 'is_terminal', 'reward')
    shapes = {k: v for k, v in shapes.items() if k not in excluded}
    self.cnn_shapes = {
        k: v for k, v in shapes.items()
        if re.match(cnn_keys, k) and len(v) == 3}
    self.mlp_shapes = {
        k: v for k, v in shapes.items()
        if re.match(mlp_keys, k) and len(v) == 1}
    self.shapes = {**self.cnn_shapes, **self.mlp_shapes}
    if self.cnn_shapes:
      merged_shapes = list(self.cnn_shapes.values())
      assert all(x[:-1] == merged_shapes[0][:-1] for x in merged_shapes)
      merged = merged_shapes[0][:-1] + (
          sum(x[-1] for x in merged_shapes),)
      if cnn == 'simple':
        self.sub('cnn', ImageDecoderSimple, merged, cnn_depth, cnn_kernels,
                 **kw)
      elif cnn == 'resnet':
        self.sub('cnn', ImageDecoderResnet, merged, cnn_depth, cnn_blocks,
                 **kw)
      else:
        raise NotImplementedError(cnn)
    if self.mlp_shapes:
      self.sub('mlp', MLP, self.mlp_shapes, mlp_layers, mlp_units, **kw)
    self._inputs = Input(inputs)
    self._image_dist = image_dist

  def forward(self, inputs):
    features = self._inputs(inputs)
    dists = {}
    if self.cnn_shapes:
      flat = features.reshape(-1, features.shape[-1])
      output = self.sub('cnn')(flat)
      output = output.reshape(tuple(features.shape[:-1]) + output.shape[1:])
      split_sizes = [v[-1] for v in self.cnn_shapes.values()]
      means = torch.split(output, split_sizes, -1)
      dists.update({
          key: self._make_image_dist(mean)
          for key, mean in zip(self.cnn_shapes, means)})
    if self.mlp_shapes:
      dists.update(self.sub('mlp')(features))
    return dists

  def _make_image_dist(self, mean):
    mean = mean.float()
    if self._image_dist == 'normal':
      return distslib.Independent(distslib.Normal(mean, 1.0), 3)
    if self._image_dist == 'mse':
      return distslib.MSEDist(mean, 3, 'sum')
    raise NotImplementedError(self._image_dist)


class ImageEncoderSimple(Module):
  """Stride-2 valid convs with doubling depth (reference: nets.py:291-305)."""

  def __init__(self, name, depth, kernels, **kw):
    super().__init__(name)
    self._depth = depth
    self._kernels = kernels
    self._kw = kw

  def forward(self, x):
    x = cast(x.float())
    depth = self._depth
    for i, kernel in enumerate(self._kernels):
      x = self.sub(
          f'conv{i}', Conv2D, depth, kernel, stride=2, pad='valid',
          **self._kw)(x)
      depth *= 2
    return x


class ImageDecoderSimple(Module):
  """Transposed convs, sigmoid output (reference: nets.py:308-327)."""

  def __init__(self, name, shape, depth, kernels, **kw):
    super().__init__(name)
    self._shape = tuple(shape)
    self._depth = depth
    self._kernels = kernels
    self._kw = kw

  def forward(self, features):
    x = cast(features)
    x = x.reshape(-1, 1, 1, x.shape[-1])
    depth = self._depth * 2 ** (len(self._kernels) - 2)
    for i, kernel in enumerate(self._kernels[:-1]):
      x = self.sub(
          f'conv{i}', Conv2D, depth, kernel, transp=True, stride=2,
          pad='valid', **self._kw)(x)
      depth //= 2
    x = self.sub(
        'out', Conv2D, self._shape[-1], self._kernels[-1], transp=True,
        stride=2, pad='valid')(x)
    x = torch.sigmoid(x)
    assert tuple(x.shape[-3:]) == self._shape, (x.shape, self._shape)
    return x


class ImageEncoderResnet(Module):
  """Preact residual blocks, x0.1 residual scale (reference: nets.py:330-358)."""

  def __init__(self, name, depth, blocks, **kw):
    super().__init__(name)
    self._depth = depth
    self._blocks = blocks
    self._kw = {**kw, 'preact': True}

  def forward(self, image):
    x = cast(image.float())
    stages = int(np.log2(image.shape[-2])) - 2
    depth = self._depth
    x = self.sub('in', Conv2D, depth, 3)(x)
    for i in range(stages):
      # 2x2 mean pool, stride 2 (sizes are powers of two).
      x = F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
      for j in range(self._blocks):
        x = self._block(f's{i}b{j}', depth, x)
      depth *= 2
    x = x.reshape(x.shape[0], -1)
    return self.sub('out', Linear, 1024)(x)

  def _block(self, name, depth, x):
    skip = x
    if skip.shape[-1] != depth:
      skip = self.sub(f'{name}s', Conv2D, depth, 1, bias=False)(skip)
    x = self.sub(f'{name}a', Conv2D, depth, 3, **self._kw)(x)
    x = self.sub(f'{name}b', Conv2D, depth, 3, **self._kw)(x)
    return skip + 0.1 * x


class ImageDecoderResnet(Module):
  """Residual upsampling decoder (reference: nets.py:361-391)."""

  def __init__(self, name, shape, depth, blocks, **kw):
    super().__init__(name)
    self._shape = tuple(shape)
    self._depth = depth
    self._blocks = blocks
    self._kw = {**kw, 'preact': True}

  def forward(self, features):
    x = cast(features)
    stages = int(np.log2(self._shape[0])) - 2
    depth = 2 ** stages * self._depth
    x = self.sub('in', Linear, 16 * depth)(x)
    x = x.reshape(-1, 4, 4, depth)
    for i in range(stages):
      for j in range(self._blocks):
        x = self._block(f's{i}b{j}', depth, x)
      x = x.repeat_interleave(2, 1).repeat_interleave(2, 2)  # Upsample.
      depth //= 2
    x = self.sub('out', Conv2D, self._shape[-1], 3)(x)
    return torch.sigmoid(x)

  def _block(self, name, depth, x):
    skip = x
    if skip.shape[-1] != depth:
      skip = self.sub(f'{name}s', Conv2D, depth, 1, bias=False)(skip)
    x = self.sub(f'{name}a', Conv2D, depth, 3, **self._kw)(x)
    x = self.sub(f'{name}b', Conv2D, depth, 3, **self._kw)(x)
    return skip + 0.1 * x


class MLP(Module):
  """Shape-dict-aware MLP with distribution heads (reference: nets.py:394-425)."""

  def __init__(self, name, shape, layers, units, inputs=('tensor',),
               dims=None, **kw):
    super().__init__(name)
    assert shape is None or isinstance(shape, (int, tuple, dict)), shape
    if isinstance(shape, int):
      shape = (shape,)
    self._shape = shape
    self._layers = layers
    self._units = units
    self._inputs = Input(inputs, dims=dims)
    distkeys = ('dist', 'outscale', 'minstd', 'maxstd', 'outnorm', 'unimix')
    self._dense = {k: v for k, v in kw.items() if k not in distkeys}
    self._dist = {k: v for k, v in kw.items() if k in distkeys}
    if self._dist.get('dist') == 'none':
      self._dist.pop('dist')

  def forward(self, inputs):
    x = cast(self._inputs(inputs))
    for i in range(self._layers):
      x = self.sub(f'dense{i}', Linear, self._units, **self._dense)(x)
    if self._shape is None:
      return x
    elif isinstance(self._shape, tuple):
      return self._out('out', self._shape, x)
    elif isinstance(self._shape, dict):
      return {k: self._out(k, v, x) for k, v in self._shape.items()}
    else:
      raise ValueError(self._shape)

  def _out(self, name, shape, x):
    return self.sub(f'dist_{name}', DistLayer, shape, **self._dist)(x)


class DistLayer(Module):
  """Output head producing a distribution (reference: nets.py:428-492)."""

  def __init__(self, name, shape, dist='mse', outscale=0.1, minstd=0.1,
               maxstd=1.0, unimix=0.0):
    super().__init__(name)
    assert all(isinstance(dim, int) for dim in shape), shape
    self._shape = tuple(shape)
    self._dist = dist
    self._minstd = minstd
    self._maxstd = maxstd
    self._unimix = unimix
    self._outscale = outscale

  def _head(self, name, inputs, **kw):
    out = self.sub(name, Linear, int(np.prod(self._shape)) or 1, **kw)(inputs)
    if not self._shape:
      out = out[..., 0]
    else:
      out = out.reshape(tuple(inputs.shape[:-1]) + self._shape)
    return out.float()

  def forward(self, inputs):
    out = self._head('out', inputs, outscale=self._outscale)
    if self._dist in ('normal', 'trunc_normal'):
      std = self._head('std', inputs)
    if self._dist == 'symlog':
      return distslib.SymlogDist(out, len(self._shape), 'sum')
    if self._dist == 'mse':
      return distslib.MSEDist(out, len(self._shape), 'sum')
    if self._dist in ('normal', 'trunc_normal'):
      lo, hi = self._minstd, self._maxstd
      std = (hi - lo) * torch.sigmoid(std) + lo
      if self._dist == 'normal':
        dist = distslib.Independent(
            distslib.Normal(torch.tanh(out), std), len(self._shape))
      else:
        dist = distslib.Independent(
            distslib.TruncNormal(torch.tanh(out), std, -1, 1), 1)
      dist.minent = float(
          np.prod(self._shape) * (0.5 * np.log(2 * np.pi * np.e)
                                  + np.log(lo)))
      dist.maxent = float(
          np.prod(self._shape) * (0.5 * np.log(2 * np.pi * np.e)
                                  + np.log(hi)))
      return dist
    if self._dist == 'binary':
      return distslib.Independent(
          distslib.Bernoulli(out), len(self._shape))
    if self._dist == 'onehot':
      if self._unimix:
        probs = torch.softmax(out, -1)
        probs = (1 - self._unimix) * probs + self._unimix / probs.shape[-1]
        out = torch.log(probs)
      dist = distslib.OneHotDist(out)
      if len(self._shape) > 1:
        dist = distslib.Independent(dist, len(self._shape) - 1)
      dist.minent = 0.0
      dist.maxent = float(
          np.prod(self._shape[:-1]) * np.log(self._shape[-1]))
      return dist
    raise NotImplementedError(self._dist)

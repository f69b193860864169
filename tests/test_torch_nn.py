"""Each module of the port against its JAX counterpart, in float32, on the
JAX module's weights carried across by `from_jax_state`.

Tolerance 1e-5 (atol and rtol): the same float32 arithmetic, summed in
another order.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daydreamer_tpu import nn as jnn
from daydreamer_tpu.models import nets as jnets
from daydreamer_tpu_torch import nn as pnn
from daydreamer_tpu_torch.models import nets as pnets
from daydreamer_tpu_torch.ops import onehot as ponehot

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)


def _np(tree):
  if isinstance(tree, dict):
    return {k: _np(v) for k, v in tree.items()}
  if isinstance(tree, (tuple, list)):
    return type(tree)(_np(v) for v in tree)
  if isinstance(tree, torch.Tensor):
    return tree.detach().numpy()
  return np.asarray(tree)


def _torch(tree):
  if isinstance(tree, dict):
    return {k: _torch(v) for k, v in tree.items()}
  if isinstance(tree, (tuple, list)):
    return type(tree)(_torch(v) for v in tree)
  return torch.as_tensor(np.array(tree))


def carry(jmod, pmod, call, *inputs, seed=0):
  """Create both modules on `inputs`, carry the JAX weights (perturbed, so
  zero-initialized biases and unit scales matter) into the port, and
  return (jax output, port output, jax state, port module)."""
  jfn = jnn.pure(lambda *a: call(jmod, *a))
  _, state = jfn({}, seed, *inputs, create=True)
  rng = np.random.default_rng(seed)
  state = {k: np.asarray(v) + 0.1 * rng.standard_normal(v.shape).astype(
      np.float32) if jnp.issubdtype(v.dtype, jnp.floating) else np.asarray(v)
      for k, v in state.items()}
  tinputs = _torch(inputs)
  with pnn.scope(create=True):
    call(pmod, *tinputs)
  assert set(pnn.state(pmod)) == set(state)
  pnn.assign(pmod, pnn.from_jax_state(state, pnn.kinds(pmod)))
  jout, _ = jfn(state, seed, *inputs)
  with pnn.scope():
    pout = call(pmod, *tinputs)
  return jout, pout, state, pmod


def data(*shape, seed=0):
  return np.random.default_rng(seed).standard_normal(shape).astype(
      np.float32)


@pytest.mark.parametrize('kw', [
    dict(units=6), dict(units=6, act='elu', norm='layer'),
    dict(units=6, outscale=0.1, bias=False)])
def test_linear(kw):
  jout, pout, _, _ = carry(jnn.Linear('lin', **kw), pnn.Linear('lin', **kw),
                           lambda m, x: m(x), data(3, 5, 7))
  np.testing.assert_allclose(_np(pout), jout, **TOL)


@pytest.mark.parametrize('kw,shape', [
    (dict(depth=4, kernel=4, stride=2, pad='valid'), (2, 16, 16, 3)),
    (dict(depth=4, kernel=3, norm='layer', act='elu'), (2, 8, 8, 3)),
    (dict(depth=4, kernel=3, norm='layer', act='elu', preact=True),
     (2, 8, 8, 3)),
    (dict(depth=4, kernel=1, bias=False), (2, 8, 8, 3)),
    (dict(depth=4, kernel=5, stride=2, transp=True, pad='valid'),
     (2, 6, 6, 3)),
    (dict(depth=4, kernel=5, stride=2, transp=True, pad='valid'),
     (2, 1, 1, 9)),  # The dense path of a 1x1 transposed conv.
    # SAME padding at any stride and kernel, as XLA pads it: forward
    # convs whose padding is uneven or strided, transposed convs whose
    # output is H * stride.
    (dict(depth=4, kernel=4, stride=2), (2, 7, 7, 3)),
    (dict(depth=4, kernel=4, stride=1), (2, 6, 6, 3)),
    (dict(depth=4, kernel=3, stride=2), (2, 8, 8, 3)),
    (dict(depth=4, kernel=4, stride=2, transp=True), (2, 5, 5, 3)),
    (dict(depth=4, kernel=5, stride=2, transp=True), (2, 4, 4, 3)),
])
def test_conv(kw, shape):
  jout, pout, state, pmod = carry(
      jnn.Conv2D('conv', **kw), pnn.Conv2D('conv', **kw),
      lambda m, x: m(x), data(*shape))
  np.testing.assert_allclose(_np(pout), jout, **TOL)
  # The layout round trip is exact.
  back = pnn.to_jax_state(pnn.state(pmod), pnn.kinds(pmod))
  for key, value in state.items():
    np.testing.assert_array_equal(back[key], value)


def test_norm():
  jout, pout, _, _ = carry(jnn.Norm('n', 'layer'), pnn.Norm('n', 'layer'),
                           lambda m, x: m(x), 3 * data(4, 9) + 1)
  np.testing.assert_allclose(_np(pout), jout, **TOL)


def test_input_order():
  inputs = {'b': data(2, 3, 4), 'a': data(2, 3, 2, 2)}
  jout = jnn.Input(['a', 'b'], dims='b')(inputs)
  pout = pnn.Input(['a', 'b'], dims='b')(_torch(inputs))
  np.testing.assert_array_equal(_np(pout), jout)


def _dist_pairs():
  x, y = data(4, 6, seed=1), data(4, 6, seed=2)
  s = np.abs(data(4, 6, seed=3)) + 0.2
  return [
      ('onehot', lambda d: d.OneHotDist(x), lambda d: d.OneHotDist(y)),
      ('normal', lambda d: d.Independent(d.Normal(x, s), 1),
       lambda d: d.Independent(d.Normal(y, s), 1)),
      ('mvn', lambda d: d.MultivariateNormalDiag(x, s),
       lambda d: d.MultivariateNormalDiag(y, s)),
      ('trunc', lambda d: d.TruncNormal(np.tanh(x), s), None),
      ('bernoulli', lambda d: d.Independent(d.Bernoulli(x), 1), None),
      ('mse', lambda d: d.MSEDist(x, 1), None),
      ('symlog', lambda d: d.SymlogDist(x, 1), None),
  ]


@pytest.mark.parametrize('name,make,other', _dist_pairs(),
                         ids=[p[0] for p in _dist_pairs()])
def test_dists(name, make, other):
  jd = make(jnn.dists)
  pd = make(_TorchDists)
  value = np.clip(data(4, 6, seed=4), -0.9, 0.9)
  if name == 'onehot':
    value = np.eye(6, dtype=np.float32)[[0, 3, 5, 1]]
  if name == 'bernoulli':
    value = (value > 0).astype(np.float32)
  np.testing.assert_allclose(
      _np(pd.log_prob(torch.as_tensor(value))), jd.log_prob(value), **TOL)
  np.testing.assert_allclose(_np(pd.mode()), jd.mode(), **TOL)
  if hasattr(jd, 'entropy'):
    np.testing.assert_allclose(_np(pd.entropy()), jd.entropy(), **TOL)
  if hasattr(jd, 'mean'):
    np.testing.assert_allclose(_np(pd.mean()), jd.mean(), **TOL)
  if other is not None:
    np.testing.assert_allclose(
        _np(pnn.kl_divergence(pd, other(_TorchDists))),
        jnn.kl_divergence(jd, other(jnn.dists)), **TOL)


class _TorchDists:
  """pnn.dists with numpy arguments turned into tensors."""

  def __getattr__(self, name):
    cls = getattr(pnn.dists, name)
    wrap = lambda x: torch.as_tensor(x) if isinstance(x, np.ndarray) else x
    return lambda *args, **kw: cls(*map(wrap, args), **kw)


_TorchDists = _TorchDists()


def test_onehot_sample_straight_through():
  logits = torch.tensor(data(5, 4), requires_grad=True)
  dist = pnn.OneHotDist(logits)
  sample = dist.sample(torch.Generator().manual_seed(0))
  assert torch.allclose(sample.sum(-1), torch.ones(5))
  (sample * torch.arange(4.0)).sum().backward()
  assert logits.grad is not None and logits.grad.abs().sum() > 0


def test_utils():
  x = 2 * data(8, 3) + 1
  np.testing.assert_allclose(
      _np(pnn.symlog(torch.as_tensor(x))), jnn.symlog(x), **TOL)
  video = data(2, 3, 4, 5, 1)
  np.testing.assert_array_equal(
      _np(pnn.video_grid(torch.as_tensor(video))), jnn.video_grid(video))
  target = (data(8) > 0).astype(np.float32)
  jstats = jnn.balance_stats(jnn.dists.Bernoulli(x[:, 0]), target, 0.5)
  pstats = pnn.balance_stats(pnn.dists.Bernoulli(torch.as_tensor(x[:, 0])),
                             torch.as_tensor(target), 0.5)
  for key in jstats:
    np.testing.assert_allclose(_np(pstats[key]), jstats[key], **TOL)


@pytest.mark.parametrize('impl', ['mult', 'prop'])
def test_autoadapt(impl):
  kw = dict(shape=(3,), impl=impl, scale=0.1, target=0.5, min=1e-3, max=1.0)
  reg = data(4, 3) ** 2
  call = lambda m, r: [m(r) for _ in range(3)][-1]
  jout, pout, _, pmod = carry(
      jnn.AutoAdapt('aa', **kw), pnn.AutoAdapt('aa', **kw), call, reg)
  np.testing.assert_allclose(_np(pout[0]), jout[0], **TOL)
  for key in jout[1]:
    np.testing.assert_allclose(_np(pout[1][key]), jout[1][key], **TOL)


def test_normalize():
  call = lambda m, x: [m(x * (i + 1)) for i in range(3)][-1]
  jout, pout, _, _ = carry(
      jnn.Normalize('norm', decay=0.9), pnn.Normalize('norm', decay=0.9),
      call, data(5, 4))
  np.testing.assert_allclose(_np(pout), jout, **TOL)


@pytest.mark.parametrize('kw', [
    dict(lr=1e-2, clip=100.0, wd=1e-2, eps=1e-6),
    dict(lr=1e-2, clip=0.1, warmup=10)])
def test_optimizer(kw):
  """Three updates of clip -> Adam -> decoupled weight decay."""
  x, y = data(8, 5), data(8, 3, seed=1)

  def call(mods, x, y):
    lin, opt = mods
    loss = lambda: ((lin(x) - y) ** 2).mean()
    mets = [opt(loss, lin)[0] for _ in range(3)]
    return mets[-1]

  jmods = (jnn.Linear('agent/lin', 3, norm='layer'),
           jnn.Optimizer('agent/opt', **kw))
  pmods = (pnn.Linear('agent/lin', 3, norm='layer'),
           pnn.Optimizer('agent/opt', **kw))
  # The creation pass runs the loss once; the updates run after.
  jfn = jnn.pure(lambda x, y: call(jmods, x, y))
  _, state = jfn({}, 0, x, y, create=True)
  with pnn.scope(create=True):
    call(pmods, *_torch((x, y)))
  pstate = {k: v for m in pmods for k, v in pnn.state(m).items()}
  assert set(pstate) == set(state)
  for m in pmods:
    pnn.assign(m, pnn.from_jax_state(
        {k: v for k, v in state.items() if k in pnn.state(m)}, {}))
  jmets, jstate = jfn(state, 0, x, y)
  with pnn.scope():
    pmets = call(pmods, *_torch((x, y)))
  for key in jmets:
    np.testing.assert_allclose(_np(pmets[key]), jmets[key], **TOL)
  pstate = {k: v for m in pmods for k, v in pnn.state(m).items()}
  for key, value in jstate.items():
    np.testing.assert_allclose(_np(pstate[key]), value, **TOL,
                               err_msg=key)


def test_optimizer_skips_nonfinite():
  lin = pnn.Linear('agent/lin', 3)
  opt = pnn.Optimizer('agent/opt', lr=1e-2)
  x = torch.as_tensor(data(4, 5))
  with pnn.scope(create=True):
    opt(lambda: lin(x).sum(), lin)
  before = {k: v.clone() for k, v in pnn.state(lin).items()}
  with pnn.scope():
    mets, _ = opt(lambda: lin(x).sum() * float('nan'), lin)
  assert float(mets['opt_overflow']) == 1.0
  assert int(opt.values['step']) == 0
  for key, value in pnn.state(lin).items():
    assert torch.equal(value, before[key])


RSSM_KW = dict(deter=16, stoch=4, classes=4, units=16, act='elu',
               norm='layer', initial='learned2', unimix=0.01,
               prior_layers=2)


def _rssm_call(m, action, embed, is_first):
  """initial, obs_step and img_step with sampling set to the mode."""
  state = m.initial(action.shape[0])
  post, prior = m.obs_step(state, action, embed, is_first)
  img = m.img_step(post, action)
  return state, post, prior, img


def test_rssm(monkeypatch):
  monkeypatch.setattr(jnn.dists.OneHotDist, 'sample',
                      lambda self, key: self.mode())
  # The port's RSSM step samples in its head from uniform draws u: e^-1
  # everywhere makes the Gumbel noise zero, so it samples the mode.
  monkeypatch.setattr(ponehot, 'uniform', lambda shape, generator, device: (
      torch.full(shape, math.exp(-1), device=device)))
  B = 3
  is_first = np.array([1.0, 0.0, 1.0], np.float32)
  jout, pout, _, pmod = carry(
      jnets.RSSM('rssm', **RSSM_KW), pnets.RSSM('rssm', **RSSM_KW),
      _rssm_call, data(B, 5), data(B, 7, seed=1), is_first)
  for j, p in zip(jout, pout):
    for key in j:
      np.testing.assert_allclose(_np(p[key]), j[key], **TOL, err_msg=key)
  # kl_loss on the two states.
  post, prior = jout[1], jout[2]
  kl = jnets.RSSM('rssm', **RSSM_KW).kl_loss(post, prior, 0.8)
  np.testing.assert_allclose(
      _np(pmod.kl_loss(_torch(post), _torch(prior), 0.8)), kl, **TOL)


def test_rssm_fused_params_slice_the_same_entries():
  pmod = pnets.RSSM('rssm', **RSSM_KW)
  with pnn.scope(create=True):
    _rssm_call(pmod, *_torch((data(2, 5), data(2, 7), np.zeros(2, 'f4'))))
  with pnn.scope():
    params = pmod.fused_img_params()
  state = pnn.state(pmod)
  SC, D = 16, 16
  assert torch.equal(params['w_in_s'], state['rssm/img_in/kernel'][:SC])
  assert torch.equal(params['w_gru_d'], state['rssm/gru_out/kernel'][:D])
  assert torch.equal(params['w_gru_x'], state['rssm/gru_out/kernel'][D:])
  assert len(params['w_out']) == 2 and pmod.fused_compatible


ENC_KW = dict(mlp_keys='vec', cnn_keys='image', act='elu', norm='layer',
              mlp_layers=2, mlp_units=8, cnn_depth=4)
SHAPES = {'image': (16, 16, 3), 'vec': (5,), 'is_first': ()}


@pytest.mark.parametrize('cnn,kernels', [
    ('simple', (4, 4)), ('resnet', None)])
def test_encoder(cnn, kernels):
  kw = dict(ENC_KW, cnn=cnn, cnn_blocks=1)
  if kernels:
    kw['cnn_kernels'] = kernels
  inputs = {'image': data(2, 3, 16, 16, 3), 'vec': data(2, 3, 5),
            'is_first': np.zeros((2, 3), np.float32)}
  jout, pout, _, _ = carry(
      jnets.MultiEncoder('enc', SHAPES, **kw),
      pnets.MultiEncoder('enc', SHAPES, **kw), lambda m, x: m(x), inputs)
  np.testing.assert_allclose(_np(pout), jout, **TOL)


@pytest.mark.parametrize('cnn,kernels', [
    ('simple', (5, 5, 6)), ('resnet', None)])
def test_decoder(cnn, kernels):
  kw = dict(ENC_KW, cnn=cnn, cnn_blocks=1, inputs=['deter', 'stoch'])
  if kernels:
    kw['cnn_kernels'] = kernels
  shapes = {'image': (30, 30, 3) if kernels else (16, 16, 3), 'vec': (5,)}
  inputs = {'deter': data(2, 3, 6), 'stoch': data(2, 3, 2, 2, seed=1)}
  image = data(2, 3, *shapes['image'], seed=2)
  call = lambda m, x: {k: (d.mode(), d.log_prob(
      image if k == 'image' else x['deter'][..., :5]))
      for k, d in m(x).items()}
  jout, pout, _, _ = carry(
      jnets.MultiDecoder('dec', shapes, **kw),
      pnets.MultiDecoder('dec', shapes, **kw), call, inputs)
  for key in jout:
    for j, p in zip(jout[key], pout[key]):
      np.testing.assert_allclose(_np(p), j, atol=1e-4, rtol=1e-5,
                                 err_msg=key)


@pytest.mark.parametrize('kw,shape', [
    (dict(dist='symlog'), ()), (dict(dist='binary'), ()),
    (dict(dist='mse'), (3,)), (dict(dist='onehot', unimix=0.1), (5,)),
    (dict(dist='normal', minstd=0.1), (3,)),
    (dict(dist='trunc_normal', minstd=0.1), (3,))])
def test_mlp_heads(kw, shape):
  kw = dict(kw, act='elu', norm='layer', inputs=['deter', 'stoch'])
  inputs = {'deter': data(4, 6), 'stoch': data(4, 2, 2, seed=1)}
  target = np.clip(data(4, *shape, seed=2), -0.9, 0.9)
  if kw['dist'] == 'onehot':
    target = np.eye(5, dtype=np.float32)[[1, 0, 4, 2]]
  if kw['dist'] == 'binary':
    target = (target > 0).astype(np.float32)
  call = lambda m, x: (lambda d: (d.mode(), d.log_prob(target)))(m(x))
  jout, pout, _, _ = carry(
      jnets.MLP('mlp', shape, 2, 8, **kw), pnets.MLP('mlp', shape, 2, 8, **kw),
      call, inputs)
  for j, p in zip(jout, pout):
    np.testing.assert_allclose(_np(p), j, **TOL)

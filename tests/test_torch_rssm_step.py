"""The RSSM's scan step on its two fused ops, on the CPU: `ops/gru.py` (the
GRU cell after its product) and `ops/onehot.py` (the categorical stats head
with its straight-through sample), whose wrappers run their plain versions
here, against the JAX package, from numpy inputs made from a seed, in
float32. The CUDA sources themselves are held to the plain versions in
`tests/test_torch_emulate_gru.py` and `tests/test_torch_emulate_onehot.py`
and on the card by `chip_smoke.py`.

- `gru_cell` and its gradients in the product, deter, scale and bias
  against `jax.vjp` of the JAX `RSSM._gru` whose `gru_out` kernel is
  [0; I]: the product of [deter, x] with it is x itself, so the JAX cell
  runs on the same product and norm parameters.
- `onehot_head`'s logit and its gradient against the JAX `_unimix_logit`,
  with unimix 0.01 and 0.
- Its sample, on shared uniform draws, against the JAX `OneHotDist.sample`
  with `jax.random.categorical` set to the arg max of its log-probs plus the
  same Gumbel noise, and its straight-through gradient against `jax.vjp` of
  that estimator at the same one-hot.
- A JAX RSSM's `obs_step` and `img_step` over 3 steps, its weights carried
  into the port by `from_jax_state`, both sides drawing the same noise:
  every state, and the gradients of a loss over them in every weight; and
  the same at `norm: none`, deter 2 049 and classes 3, 48 and 64 (the
  gradients' atol there scaled by each tensor's largest magnitude).

Tolerance 1e-5 (atol and rtol), as the RSSM's parity tests in
`tests/test_torch_nn.py`: the same float32 arithmetic, summed in another
order. The samples must choose the same classes exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daydreamer_tpu import nn as jnn
from daydreamer_tpu.models import nets as jnets
from daydreamer_tpu.nn import dists as jdists
from daydreamer_tpu_torch import nn as pnn
from daydreamer_tpu_torch.models import nets as pnets
from daydreamer_tpu_torch.ops import gru, onehot

torch.set_num_threads(1)
TOL = dict(atol=1e-5, rtol=1e-5)
TINY = np.finfo(np.float32).tiny


def _np(x):
  return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _normal(rng, *shape):
  return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize('D', [16, 20, 32])
def test_gru_cell_against_jax(D):
  """The new deter and its gradients in the product, the previous deter and
  the norm's scale and bias."""
  rng = np.random.default_rng(D)
  B = 5
  x = 2 * _normal(rng, B, 3 * D) + 0.5
  deter = np.tanh(_normal(rng, B, D))
  scale = 1 + 0.2 * _normal(rng, 3 * D)
  bias = 0.3 * _normal(rng, 3 * D)
  dout = _normal(rng, B, D)
  jmod = jnets.RSSM('rssm', deter=D, stoch=4, classes=4, act='elu',
                    norm='layer')
  fn = jnn.pure(lambda x, deter: jmod._gru(x, deter)[0])
  _, state = fn({}, 0, x, deter, create=True)
  # [deter, x] @ [0; I] = x: the JAX cell's product is x itself.
  kernel = np.concatenate([np.zeros((D, 3 * D)), np.eye(3 * D)])
  state = {**state, 'rssm/gru_out/kernel': jnp.asarray(kernel, jnp.float32)}

  def jax_cell(x, deter, scale, bias):
    values = {**state, 'rssm/gru_out/norm/scale': scale,
              'rssm/gru_out/norm/bias': bias}
    return fn(values, 0, x, deter)[0]

  want, vjp = jax.vjp(jax_cell, x, deter, scale, bias)
  wants = vjp(jnp.asarray(dout))
  leaves = [torch.as_tensor(v).requires_grad_()
            for v in (x, deter, scale, bias)]
  out = gru.gru_cell(*leaves)
  out.backward(torch.as_tensor(dout))
  np.testing.assert_allclose(_np(out), np.asarray(want), **TOL)
  for name, leaf, grad in zip(('x', 'deter', 'scale', 'bias'), leaves,
                              wants):
    np.testing.assert_allclose(_np(leaf.grad), np.asarray(grad), **TOL,
                               err_msg=name)


@pytest.mark.parametrize('unimix', [0.01, 0.0])
def test_onehot_head_logit_against_jax(unimix):
  """The state's logit (the unimix log-probs, or the raw logits) and its
  gradient against the JAX `_unimix_logit`."""
  rng = np.random.default_rng(1)
  raw = 2 * _normal(rng, 3, 4, 8)
  dlogit = _normal(rng, 3, 4, 8)
  jmod = jnets.RSSM('rssm', deter=16, stoch=4, classes=8, unimix=unimix)
  want, vjp = jax.vjp(jmod._unimix_logit, jnp.asarray(raw))
  leaf = torch.as_tensor(raw).requires_grad_()
  logit, _ = onehot.onehot_head(leaf, None, unimix)
  logit.backward(torch.as_tensor(dlogit))
  np.testing.assert_allclose(_np(logit), np.asarray(want), **TOL)
  np.testing.assert_allclose(_np(leaf.grad),
                             np.asarray(vjp(jnp.asarray(dlogit))[0]), **TOL)


def _jax_gumbel(u):
  return -jnp.log(-jnp.log(jnp.maximum(jnp.asarray(u), TINY)))


@pytest.mark.parametrize('unimix', [0.01, 0.0])
def test_onehot_head_sample_against_jax(unimix, monkeypatch):
  """The sample on shared uniform draws: the same classes as the JAX
  `OneHotDist.sample` choosing the arg max of its log-probs plus the same
  noise, and its straight-through gradient (with the logit's) against
  `jax.vjp` of the JAX estimator at that one-hot."""
  rng = np.random.default_rng(2)
  raw = 2 * _normal(rng, 6, 4, 8)
  u = rng.uniform(size=raw.shape).astype(np.float32)
  dlogit, dstoch = _normal(rng, *raw.shape), _normal(rng, *raw.shape)
  monkeypatch.setattr(jax.random, 'categorical', lambda key, logits: (
      jnp.argmax(logits + _jax_gumbel(u), -1)))
  jmod = jnets.RSSM('rssm', deter=16, stoch=4, classes=8, unimix=unimix)

  def jax_head(raw):
    logit = jmod._unimix_logit(raw)
    dist = jdists.OneHotDist(logit.astype(jnp.float32))
    return logit, dist.sample(jax.random.PRNGKey(0))

  (jlogit, jstoch), vjp = jax.vjp(jax_head, jnp.asarray(raw))
  want, = vjp((jnp.asarray(dlogit), jnp.asarray(dstoch)))
  leaf = torch.as_tensor(raw).requires_grad_()
  logit, stoch = onehot.onehot_head(leaf, torch.as_tensor(u), unimix)
  ((logit * torch.as_tensor(dlogit)).sum()
   + (stoch * torch.as_tensor(dstoch)).sum()).backward()
  np.testing.assert_array_equal(_np(stoch).argmax(-1),
                                np.asarray(jstoch).argmax(-1))
  np.testing.assert_allclose(_np(logit), np.asarray(jlogit), **TOL)
  np.testing.assert_allclose(_np(stoch), np.asarray(jstoch), **TOL)
  np.testing.assert_allclose(_np(leaf.grad), np.asarray(want), **TOL)


class SharedNoise:
  """The same uniform draws for both sides, in the order the steps sample:
  the port's `onehot.uniform` and the JAX `jax.random.categorical` (the arg
  max of the log-probs plus their Gumbel noise) take the next one each."""

  def __init__(self, draws):
    self.draws, self.taken = draws, 0

  def _next(self, shape):
    u = self.draws[self.taken]
    self.taken += 1
    assert u.shape == tuple(shape), (u.shape, shape)
    return u

  def uniform(self, shape, generator, device):
    return torch.as_tensor(self._next(shape), device=device)

  def categorical(self, key, logits):
    return jnp.argmax(logits + _jax_gumbel(self._next(logits.shape)), -1)


RSSM_KW = dict(deter=24, stoch=4, classes=8, units=16, act='elu',
               norm='layer', initial='learned2', unimix=0.01,
               prior_layers=2)
STEPS, B, A, E = 3, 3, 5, 7


def _steps(m, actions, embeds, firsts):
  """obs_step over the steps from the initial state, then img_step from the
  last posterior over the same actions: every state on the way."""
  post = m.initial(B)
  states = []
  for t in range(STEPS):
    post, prior = m.obs_step(post, actions[t], embeds[t], firsts[t])
    states += [post, prior]
  img = post
  for t in range(STEPS):
    img = m.img_step(img, actions[t])
    states.append(img)
  return states


def _loss(states, weights, sum_):
  """sum over states and keys of <state[key], weight>."""
  return sum_([(state[k] * w[k]).sum() for state, w in zip(states, weights)
               for k in sorted(state)])


def test_rssm_steps_against_jax(monkeypatch):
  """A JAX RSSM's obs_step and img_step over 3 steps, and the port's RSSM
  with its weights (perturbed, so that unit scales and zero biases matter)
  carried by `from_jax_state`, on the same inputs and noise: every state,
  and the gradients of a weighted sum of them in every weight."""
  _check_steps(monkeypatch, RSSM_KW)


# Widths past the kernels' first layouts, each of which the JAX package
# trains: no norm (the GRU cell without one), a deter past the 2 048 that a
# group of lanes holds (3 x 2 049 values a row, no multiple of a vector),
# and class counts that are no power of two from 2 to 32.
WIDTHS = {
    'norm none': dict(norm='none'),
    'deter 2049': dict(deter=2049),
    'classes 3': dict(classes=3),
    'classes 48': dict(classes=48),
    'classes 64': dict(classes=64),
}


@pytest.mark.parametrize('width', list(WIDTHS))
def test_rssm_steps_widths_against_jax(monkeypatch, width):
  """`test_rssm_steps_against_jax` at each of WIDTHS (on the CPU the
  wrappers run their plain versions, to which the emulated cases hold the
  kernels' new paths). The states within 1e-5 as there; a weight's
  gradient within rtol 1e-5 and an atol of 1e-5 of the tensor's largest
  magnitude (at least 1e-5): its sums, of up to 6 147 terms at deter
  2 049, run in another order, and a gradient entry near zero beside
  entries of 20 misses a fixed atol of 1e-5 by its rounding."""
  _check_steps(monkeypatch, {**RSSM_KW, **WIDTHS[width]}, scaled=True)


def _check_steps(monkeypatch, kw, scaled=False):
  rng = np.random.default_rng(3)
  actions = _normal(rng, STEPS, B, A)
  embeds = _normal(rng, STEPS, B, E)
  firsts = np.zeros((STEPS, B), np.float32)
  firsts[0] = 1.0
  firsts[2, 1] = 1.0
  S, C = kw['stoch'], kw['classes']
  # Two draws a step of obs_step (prior, posterior), one of img_step.
  draws = [rng.uniform(size=(B, S, C)).astype(np.float32)
           for _ in range(3 * STEPS)]
  noise = SharedNoise(draws)
  monkeypatch.setattr(jax.random, 'categorical', noise.categorical)
  monkeypatch.setattr(onehot, 'uniform', noise.uniform)

  jmod = jnets.RSSM('rssm', **kw)
  jfn = jnn.pure(lambda *a: _steps(jmod, *a))
  inputs = (actions, embeds, firsts)
  noise.taken = 0
  _, state = jfn({}, 0, *inputs, create=True)
  state = {k: np.asarray(v) + 0.1 * _normal(rng, *v.shape)
           for k, v in state.items()}
  pmod = pnets.RSSM('rssm', **kw)
  tinputs = [torch.as_tensor(v) for v in inputs]
  noise.taken = 0
  with pnn.scope(create=True):
    _steps(pmod, *tinputs)
  assert set(pnn.state(pmod)) == set(state)
  pnn.assign(pmod, pnn.from_jax_state(state, pnn.kinds(pmod)))

  noise.taken = 0
  jstates, _ = jfn(state, 0, *inputs)
  assert noise.taken == len(draws)
  weights = [{k: _normal(rng, *np.shape(v)) for k, v in s.items()}
             for s in jstates]
  noise.taken = 0
  jgrads = jax.grad(lambda st: _loss(
      jfn(st, 0, *inputs)[0], weights, lambda xs: sum(xs)))(state)

  noise.taken = 0
  with pnn.scope():
    pstates = _steps(pmod, *tinputs)
  assert noise.taken == len(draws)
  for t, (j, p) in enumerate(zip(jstates, pstates)):
    assert sorted(j) == sorted(p)
    for key in j:
      np.testing.assert_allclose(_np(p[key]), np.asarray(j[key]), **TOL,
                                 err_msg=f'state {t}, {key}')
  tweights = [{k: torch.as_tensor(v) for k, v in w.items()} for w in weights]
  _loss(pstates, tweights, lambda xs: torch.stack(xs).sum()).backward()
  grads = pnn.to_jax_state(
      {k: v.grad for k, v in pnn.state(pmod).items()}, pnn.kinds(pmod))
  for key, value in jgrads.items():
    value = np.asarray(value)
    tol = dict(rtol=1e-5, atol=1e-5 * max(1.0, float(np.abs(value).max()))
               ) if scaled else TOL
    np.testing.assert_allclose(grads[key], value, **tol, err_msg=key)

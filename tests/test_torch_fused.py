"""The counterparts of XLA's fusions on the learner's update, on the CPU:
`ops/norm.py` (LayerNorm with its casts and the activation after it) and
`ops/adam.py` (the optimizer's global norm and step), as the layers and the
optimizer use them, against the JAX package, from numpy inputs made from a
seed. On the CPU the wrappers run their plain versions; the CUDA sources
themselves are held to those in `tests/test_torch_emulate_update.py` and
on the card by `chip_smoke.py`.

Tolerances: float32, 1e-5 (atol and rtol), the same arithmetic summed in
another order. bfloat16: outputs within 2^-7 relative and absolute (one
unit in the last place of a value in [1, 2): a sum on the other side of a
rounding); gradients within 2e-2 of each tensor's largest magnitude (a
rounding of the norm's output or of the ELU's gradient that falls the
other way moves the row sums after it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daydreamer_tpu import nn as jnn
from daydreamer_tpu_torch import nn as pnn
from daydreamer_tpu_torch.nn import cost
from daydreamer_tpu_torch.ops import adam, build, norm

torch.set_num_threads(1)
F32, BF16 = torch.float32, torch.bfloat16
JAX_DTYPE = {F32: jnp.float32, BF16: jnp.bfloat16}
TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=2 ** -7, rtol=2 ** -7)


def _np(x):
  return np.asarray(x.detach().float().numpy() if isinstance(
      x, torch.Tensor) else np.asarray(x, np.float32))


def _scaled(got, want):
  got, want = _np(got), np.asarray(want, np.float32)
  return float(np.abs(got - want).max() / max(1e-6, np.abs(want).max()))


def _inputs(rows, C, seed=0):
  rng = np.random.default_rng(seed)
  x = (3 * rng.standard_normal((rows, C)) + 1).astype(np.float32)
  scale = (1 + 0.2 * rng.standard_normal(C)).astype(np.float32)
  bias = (0.3 * rng.standard_normal(C)).astype(np.float32)
  dy = rng.standard_normal((rows, C)).astype(np.float32)
  return x, scale, bias, dy


def _jax_norm_act(x, scale, bias, act, dy):
  """The JAX `Norm` with `jax.nn.elu` (or nothing) after it: the output,
  and the gradients of sum(y * dy) in x, scale and bias."""
  jnorm = jnn.Norm('n', 'layer')
  fn = jnn.pure(lambda x: jnn.get_act(act)(jnorm(x)))
  state = {'n/scale': jnp.asarray(scale), 'n/bias': jnp.asarray(bias)}

  def loss(state, x):
    return (fn(state, 0, x)[0].astype(jnp.float32) * dy).sum()

  out = fn(state, 0, x)[0]
  dstate, dx = jax.grad(loss, argnums=(0, 1))(state, x)
  return out, dx, dstate['n/scale'], dstate['n/bias']


@pytest.mark.parametrize('C', [9, 64, 130])
@pytest.mark.parametrize('dtype', [F32, BF16], ids=['float32', 'bfloat16'])
@pytest.mark.parametrize('act', ['none', 'elu'])
def test_layer_norm_act_against_jax(C, dtype, act):
  """`layer_norm_act` (its plain version on the CPU) and its autograd
  gradients against the JAX Norm with and without the ELU after it."""
  x, scale, bias, dy = _inputs(11, C)
  jx = jnp.asarray(x).astype(JAX_DTYPE[dtype])
  jout, jdx, jdscale, jdbias = _jax_norm_act(jx, scale, bias, act, dy)
  leaves = [torch.as_tensor(x).to(dtype).requires_grad_(),
            torch.as_tensor(scale).requires_grad_(),
            torch.as_tensor(bias).requires_grad_()]
  out = norm.layer_norm_act(*leaves, act)
  assert out.dtype == dtype
  (out.float() * torch.as_tensor(dy)).sum().backward()
  tol = TOL if dtype == F32 else BF16_TOL
  np.testing.assert_allclose(_np(out), np.asarray(jout, np.float32), **tol)
  limit = 1e-5 if dtype == F32 else 2e-2
  for got, want in zip(leaves, (jdx, jdscale, jdbias)):
    assert got.grad.dtype == got.dtype
    assert _scaled(got.grad, want) <= limit


@pytest.mark.parametrize('dtype', [F32, BF16], ids=['float32', 'bfloat16'])
def test_layer_norm_act_function_is_its_plain_version(dtype):
  """On the CPU the wrapper's autograd.Function gives the plain version's
  output and autograd gradients bit for bit, and counts its formula's
  bytes alone; inside `build.plain_versions()` the counter sees the plain
  ops instead."""
  x, scale, bias, dy = _inputs(7, 64, seed=1)
  results = []
  for plain in (False, True):
    leaves = [torch.as_tensor(v).to(d).requires_grad_()
              for v, d in ((x, dtype), (scale, F32), (bias, F32))]
    with cost.CostMode() as counter:
      if plain:
        with build.plain_versions():
          out = norm.layer_norm_act(*leaves, 'elu')
      else:
        out = norm.layer_norm_act(*leaves, 'elu')
      (out.float() * torch.as_tensor(dy)).sum().backward()
    results.append((out, *[v.grad for v in leaves]))
    table = dict(counter.table)
    if plain:
      assert 'layer_norm_act_fwd' not in table
      assert 'aten::native_layer_norm' in table
    else:
      fwd = norm.layer_norm_act_work(7, 64, dtype, 'elu')[1]
      bwd = norm.layer_norm_act_work(7, 64, dtype, 'elu', backward=True)[1]
      assert table['layer_norm_act_fwd'] == [1, 0, fwd]
      assert table['layer_norm_act_bwd'] == [1, 0, bwd]
      assert 'aten::native_layer_norm' not in table
  for a, b in zip(*results):
    assert torch.equal(a, b)


def _perturbed(state, seed):
  rng = np.random.default_rng(seed)
  return {k: np.asarray(v) + 0.1 * rng.standard_normal(v.shape).astype(
      np.float32) for k, v in state.items()}


LAYERS = [
    ('linear_elu', lambda m: m.Linear('lay', 6, act='elu', norm='layer'),
     (3, 5, 7)),
    ('linear_none', lambda m: m.Linear('lay', 6, norm='layer'), (3, 5, 7)),
    # An activation the kernel does not apply: the norm, then the layer's.
    ('linear_silu', lambda m: m.Linear('lay', 6, act='silu', norm='layer'),
     (3, 5, 7)),
    ('conv_post', lambda m: m.Conv2D('lay', 4, 3, act='elu', norm='layer'),
     (2, 6, 6, 3)),
    ('conv_preact', lambda m: m.Conv2D('lay', 4, 3, act='elu', norm='layer',
                                       preact=True), (2, 6, 6, 3)),
]


@pytest.mark.parametrize('name,make,shape', LAYERS,
                         ids=[layer[0] for layer in LAYERS])
def test_layers_with_norm_against_jax(name, make, shape):
  """`Linear` and `Conv2D` (post-norm and `preact`) with `norm='layer'`
  against the JAX layers in float32: outputs, and gradients in the input
  and every parameter, on the JAX weights perturbed."""
  rng = np.random.default_rng(0)
  x = rng.standard_normal(shape).astype(np.float32)
  jmod, pmod = make(jnn), make(pnn)
  fn = jnn.pure(lambda x: jmod(x))
  _, state = fn({}, 0, x, create=True)
  state = _perturbed(state, 1)
  jout = np.asarray(fn(state, 0, x)[0])
  dy = rng.standard_normal(jout.shape).astype(np.float32)
  dstate, dx = jax.grad(
      lambda st, x: (fn(st, 0, x)[0] * dy).sum(), argnums=(0, 1))(state, x)
  xt = torch.as_tensor(x).requires_grad_()
  with pnn.scope(create=True):
    pmod(xt)
  assert set(pnn.state(pmod)) == set(state)
  assert {'lay/norm/scale', 'lay/norm/bias'} <= set(state)
  pnn.assign(pmod, pnn.from_jax_state(state, pnn.kinds(pmod)))
  with pnn.scope():
    out = pmod(xt)
  (out * torch.as_tensor(dy)).sum().backward()
  np.testing.assert_allclose(_np(out), jout, **TOL)
  np.testing.assert_allclose(_np(xt.grad), np.asarray(dx), **TOL)
  grads = pnn.to_jax_state(
      {k: v.grad for k, v in pnn.state(pmod).items()}, pnn.kinds(pmod))
  for key, value in dstate.items():
    np.testing.assert_allclose(grads[key], np.asarray(value), **TOL,
                               err_msg=key)


def _two_layers(m):
  return (m.Linear('agent/a', 5, act='elu', norm='layer'),
          m.Linear('agent/b', 3))


def test_optimizer_steps_against_jax():
  """Five updates of the moved optimizer against the JAX one: clip, a
  warmup (lr a tensor), weight decay on the tensors `wd_pattern` matches
  (the kernels, not the norm's scale and bias nor the bias), and at the
  third step a gradient that is not finite, which must leave every
  parameter, moment and the step as they were. Metrics after each step and
  the whole state after the last."""
  rng = np.random.default_rng(0)
  x = rng.standard_normal((8, 4)).astype(np.float32)
  y = rng.standard_normal((8, 3)).astype(np.float32)
  kw = dict(lr=1e-2, clip=1.0, warmup=4, wd=0.1, wd_pattern='kernel')

  def call(mods, x, y, poison):
    a, b, opt = mods
    loss = lambda: ((b(a(x)) - y) ** 2).mean() * poison
    return opt(loss, [a, b])[0]

  jmods = (*_two_layers(jnn), jnn.Optimizer('agent/opt', **kw))
  pmods = (*_two_layers(pnn), pnn.Optimizer('agent/opt', **kw))
  jfn = jnn.pure(lambda x, y, p: call(jmods, x, y, p))
  _, state = jfn({}, 0, x, y, np.float32(1), create=True)
  with pnn.scope(create=True):
    call(pmods, torch.as_tensor(x), torch.as_tensor(y), 1.0)
  state = {k: np.asarray(v) for k, v in state.items()}
  live = {k: v for m in pmods for k, v in pnn.state(m).items()}
  assert set(live) == set(state)
  for m in pmods:
    pnn.assign(m, pnn.from_jax_state(
        {k: v for k, v in state.items() if k in pnn.state(m)}, {}))
  decayed = [k for k in live if k.startswith('agent/') and '/m/' not in k
             and '/v/' not in k and k.endswith('kernel')]
  assert decayed and any(k.endswith(('scale', 'bias')) for k in live)
  for step in range(5):
    poison = np.float32(np.nan if step == 2 else 1.0)
    before = {k: v.clone() for k, v in live.items()}
    jmets, state = jfn(state, 0, x, y, poison)
    with pnn.scope():
      pmets = call(pmods, torch.as_tensor(x), torch.as_tensor(y),
                   float(poison))
    for key in jmets:
      np.testing.assert_allclose(_np(pmets[key]), np.asarray(jmets[key]),
                                 **TOL, err_msg=f'{key} at step {step}')
    if step == 2:
      assert float(pmets['opt_overflow']) == 1.0
      for key, value in live.items():
        assert torch.equal(value, before[key]), key
  for key, value in state.items():
    np.testing.assert_allclose(_np(live[key]), np.asarray(value), **TOL,
                               err_msg=key)
  assert int(live['agent/opt/step']) == 4


@pytest.mark.parametrize('rows,C,dtype,act,fwd,bwd', [
    (1024 * 961, 64, BF16, 'elu', (629800960, 259793408),
     (1133641728, 385754112)),
    (1024, 1536, F32, 'none', (12582912, 12603392), (25165824, 18907136)),
    (32, 768, BF16, 'none', (196608, 104704), (393216, 160000)),
    (4096, 130, F32, 'elu', (5324800, 4293648), (9584640, 6424608)),
])
def test_layer_norm_act_work_is_its_formula(rows, C, dtype, act, fwd, bwd):
  """`layer_norm_act_work`, the bounds that `chip_smoke.py` and PERF.md
  print, counts each input read once and each output written once, and
  nothing of how the kernels reach them (the backward's partial sums and
  counters are scratch): 8 operations a value forward and 16 backward, 2
  more with the ELU; forward x in and y out, scale, bias, mean and rstd
  in float32; backward x and dy in and dx out, mean, rstd, scale and bias
  in, dscale and dbias out. The numbers are those of the kernels that
  took two backward launches, whose work the one-launch backward leaves
  as it was."""
  item, n, elu = dtype.itemsize, rows * C, 2 * (act == 'elu')
  assert norm.layer_norm_act_work(rows, C, dtype, act) == fwd == (
      (8 + elu) * n, 2 * item * n + 4 * 2 * C + 4 * 2 * rows)
  assert norm.layer_norm_act_work(rows, C, dtype, act, backward=True) == (
      bwd) == ((16 + elu) * n, 3 * item * n + 4 * 2 * rows + 4 * 4 * C)


def test_optimizer_counts_its_kernels_by_formula():
  """One update on the CPU counts `adam_sumsq` and `adam_update` once each,
  by their formulas' bytes, and no elementwise op of the plain loop; inside
  `build.plain_versions()` the loop's ops are counted instead."""
  lin = pnn.Linear('agent/lin', 3, norm='layer')
  opt = pnn.Optimizer('agent/opt', lr=1e-2, wd=0.1)
  x = torch.as_tensor(np.random.default_rng(0).standard_normal(
      (4, 5)).astype(np.float32))
  with pnn.scope(create=True):
    opt(lambda: lin(x).sum(), lin)
  sizes = [v.numel() for _, v in lin.named_state(trainable=True)]
  flags = [k.endswith('kernel') for k, _ in lin.named_state(trainable=True)]
  with pnn.scope(), cost.CostMode() as counter:
    opt(lambda: lin(x).square().sum(), lin)
  table = dict(counter.table)
  assert table['adam_sumsq'] == [1, 0, adam.global_norm_work(sizes)[1]]
  assert table['adam_update'] == [
      1, 0, adam.adam_update_work(sizes, flags)[1]]
  assert 'aten::sqrt' not in table
  with pnn.scope(), cost.CostMode() as counter, build.plain_versions():
    opt(lambda: lin(x).square().sum(), lin)
  assert 'adam_update' not in counter.table
  assert counter.table['aten::sqrt'][0] == len(sizes) + 1

"""The port's fused observe chain against the JAX package's, on the CPU.

The JAX side runs as its own tests run it (tests/test_pallas_rssm_vjp.py):
the Pallas forward and backward kernels in interpret mode. The port's
`ObserveFused` runs its plain versions here (`observe_fwd_plain`, the
adjoint chain `observe_bwd_plain`, the shared epilogue), because its
tensors lie on the CPU. Inputs are made with numpy from a seed, float32.

Tolerances. Forward: stochs equal, deters and logits within 2e-4 (the JAX
test's own). Gradients and per-step adjoints: each tensor scaled by its
maximum, within 1e-4. The JAX test's own bound is 5e-3, but a missing
(1 - unimix) factor in the straight-through gradient moves a gradient by
only 3e-3 of its scale and passes that bound (checked on a broken copy), so
these tests hold the routes to 1e-4. Not tighter: the gradient passes
through softmaxes and five steps of LayerNorm backward in float32, and the
three routes (adjoint chain, autograd of a plain loop, the interpret
kernels) sum the T*B rows of each weight gradient in different orders; they
agree to about 1e-6 here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daydreamer_tpu.ops import pallas_rssm as pr
from daydreamer_tpu.ops import pallas_rssm_vjp as prv
from daydreamer_tpu_torch import nn as pnn
from daydreamer_tpu_torch.ops import rssm_vjp as ops

torch.set_num_threads(1)

D, U, S, C, A, E = 128, 128, 8, 16, 12, 64
B, T = 8, 5
SC = S * C
UNIMIX = 0.01
NAMES = ('deters', 'post_logits', 'prior_logits', 'stochs')


def _torch(tree):
  if isinstance(tree, dict):
    return {k: _torch(v) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return [_torch(v) for v in tree]
  if isinstance(tree, int):
    return tree
  return torch.as_tensor(np.array(tree))


def make_setup(D=D, U=U, S=S, C=C, prior_layers=2):
  """Weights from the JAX package's `make_params` and one chunk, from a
  seed. With no prior layer the head reads the deter: its kernel is made
  [D, S*C]."""
  SC = S * C
  rng = np.random.default_rng(3)
  params = pr.make_params(jax.random.PRNGKey(3), D, U, S, C, A, E,
                          prior_layers=prior_layers)
  if not prior_layers:
    params['w_st'] = jnp.asarray(
        rng.uniform(-0.3, 0.3, (D, SC)), jnp.float32)
  # Non-trivial norm parameters and biases, so a wrong wiring shows.
  for key, value in list(params.items()):
    if isinstance(value, list):
      if key.startswith('ln_'):
        params[key] = [jnp.asarray(
            (1 if 'scale' in key else 0) + 0.1 * rng.standard_normal(v.shape),
            jnp.float32) for v in value]
    elif key.startswith(('ln_', 'b_')):
      params[key] = jnp.asarray(
          (1 if 'scale' in key else 0) + 0.1 * rng.standard_normal(
              value.shape), jnp.float32)
  stoch0 = np.eye(C, dtype=np.float32)[rng.integers(0, C, (B, S))]
  stoch0 = stoch0.reshape(B, SC)
  deter0 = (0.1 * rng.standard_normal((B, D))).astype(np.float32)
  actions = rng.standard_normal((T, B, A)).astype(np.float32)
  embeds = rng.standard_normal((T, B, E)).astype(np.float32)
  is_first = np.zeros((T, B), bool)
  is_first[0, :6] = True  # Rows 6, 7 continue from stoch0 and deter0.
  is_first[3, :3] = True
  gumbel = rng.gumbel(size=(T, B, SC)).astype(np.float32)
  mix = [rng.standard_normal((T, B, n)).astype(np.float32)
         for n in (D, SC, SC, SC)]
  return params, (stoch0, deter0, actions, embeds), is_first, gumbel, mix


@pytest.fixture(scope='module')
def setup():
  return make_setup()


def _jax_fused(params, data, is_first, gumbel, sample, C=C):
  flat, _ = prv._flatten_params(params)
  cfg = (UNIMIX, sample, True, C)
  noise = jnp.asarray(gumbel) if sample else jnp.zeros_like(gumbel)
  return prv._observe_fused(cfg, flat, *map(jnp.asarray, data),
                            jnp.asarray(is_first), noise)


@pytest.mark.parametrize('sample', [False, True])
@pytest.mark.parametrize('entry', ['observe_fwd_plain', 'observe_fused'])
def test_forward_matches_jax(setup, sample, entry):
  params, data, is_first, gumbel, _ = setup
  ref = _jax_fused(params, data, is_first, gumbel, sample)
  args = (_torch(params), *_torch(data), torch.as_tensor(is_first))
  kw = dict(noise=torch.as_tensor(gumbel), unimix=UNIMIX, sample=sample)
  out = getattr(ops, entry)(*args, **kw)
  for name, r, o in zip(NAMES, ref, out):
    r, o = np.asarray(r), o.numpy()
    if name == 'stochs':
      assert (r == o).all()
      assert (o.reshape(T, B, S, C).sum(-1) == 1).all()
    else:
      np.testing.assert_allclose(o, r, rtol=2e-4, atol=2e-4, err_msg=name)
  if sample:  # The noise made a difference.
    mode = getattr(ops, entry)(*args, unimix=UNIMIX, sample=False)
    assert (mode[3] != out[3]).any()


def test_forward_jax_public_entry_agrees(setup):
  """The JAX package's public `observe_fused(interpret=True)` (modes) gives
  what the private entry used above gives; the port is held to both."""
  params, data, is_first, gumbel, _ = setup
  ref = prv.observe_fused(params, *map(jnp.asarray, data),
                          jnp.asarray(is_first), 0, unimix=UNIMIX,
                          sample=False, interpret=True)
  out = ops.observe_fused(_torch(params), *_torch(data),
                          torch.as_tensor(is_first), unimix=UNIMIX,
                          sample=False)
  assert (np.asarray(ref[3]) == out[3].numpy()).all()
  for r, o in zip(ref[:3], out[:3]):
    np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=2e-4,
                               atol=2e-4)


def _leaves(params, data):
  """The differentiable leaves in one fixed order, with names."""
  flat, n_out = ops.flatten_params(params)
  names = [f'weight{i}' for i in range(len(flat))]
  return flat + list(data), names + ['stoch0', 'deter0', 'actions', 'embeds']


def _port_grads(fn, setup, sample):
  params, data, is_first, gumbel, mix = setup
  params, data = _torch(params), _torch(data)
  leaves, names = _leaves(params, data)
  for x in leaves:
    x.requires_grad_(True)
  outs = fn(params, *data, torch.as_tensor(is_first),
            noise=torch.as_tensor(gumbel), unimix=UNIMIX, sample=sample)
  loss = sum((o * torch.as_tensor(m)).sum() for o, m in zip(outs, mix))
  grads = torch.autograd.grad(loss, leaves)
  return dict(zip(names, (g.numpy() for g in grads)))


def _jax_grads(setup, sample, C=C):
  params, data, is_first, gumbel, mix = setup
  flat, _ = prv._flatten_params(params)
  cfg = (UNIMIX, sample, True, C)
  noise = jnp.asarray(gumbel) if sample else jnp.zeros_like(gumbel)

  def loss(flat, *data):
    outs = prv._observe_fused(cfg, flat, *data, jnp.asarray(is_first), noise)
    return sum(jnp.sum(o * m) for o, m in zip(outs, mix))

  grads = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
      flat, *map(jnp.asarray, data))
  # The port's flat order: cell, kernels, scales, biases, heads.
  g = grads[0]
  ordered = [*g[:8], *g[8], *g[9], *g[10], *g[11:]]
  _, names = _leaves(_torch(params), _torch(data))
  return dict(zip(names, (np.asarray(x) for x in [*ordered, *grads[1:]])))


def _assert_close_by_scale(got, want, what):
  assert set(got) == set(want)
  for name in want:
    scale = max(1e-3, float(np.abs(want[name]).max()))
    np.testing.assert_allclose(
        got[name] / scale, want[name] / scale, rtol=1e-4, atol=1e-4,
        err_msg=f'{what}: grad leaf {name}')


@pytest.mark.parametrize('sample', [False, True])
def test_gradients_match_autograd_of_plain_scan(setup, sample):
  """(a) the adjoint chain + epilogue vs (b) autograd of the plain loop."""
  fused = _port_grads(ops.observe_fused, setup, sample)
  scan = _port_grads(ops.observe_scan_full, setup, sample)
  assert all(np.abs(g).max() > 0 for g in fused.values())
  _assert_close_by_scale(fused, scan, 'fused vs scan')


@pytest.mark.parametrize('sample', [False, True])
def test_gradients_match_jax(setup, sample):
  """(a) vs (c) jax.grad of the JAX package's fused path (interpret)."""
  fused = _port_grads(ops.observe_fused, setup, sample)
  _assert_close_by_scale(fused, _jax_grads(setup, sample), 'fused vs jax')


# Widths past the kernels' first layouts, each of which the JAX package's
# fused chain takes: the audit's deter 20, units 12, 3 x 4 latents; no
# prior layer (the head reads the deter, D 24 against U 16); 9 prior
# layers. As (D, U, S, C, prior layers).
WIDTHS = {'d20_u12_3x4': (20, 12, 3, 4, 2), 'prior0': (24, 16, 4, 8, 0),
          'prior9': (16, 16, 4, 4, 9)}


@pytest.fixture(scope='module', params=sorted(WIDTHS))
def widths(request):
  return WIDTHS[request.param], make_setup(*WIDTHS[request.param])


def test_forward_and_gradients_match_jax_at_widths(widths):
  """The plain forward (sampled) and the fused chain's gradients, through
  the adjoint chain and the epilogue, against the JAX package's fused path
  (interpret) at each width of WIDTHS, to the tolerances above."""
  (_, _, S_, C_, n_out), setup = widths
  params, data, is_first, gumbel, _ = setup
  assert len(params['w_out']) == n_out
  ref = _jax_fused(params, data, is_first, gumbel, True, C_)
  out = ops.observe_fwd_plain(
      _torch(params), *_torch(data), torch.as_tensor(is_first),
      noise=torch.as_tensor(gumbel), unimix=UNIMIX, sample=True)
  for name, r, o in zip(NAMES, ref, out):
    r, o = np.asarray(r), o.numpy()
    if name == 'stochs':
      assert (r == o).all()
      assert (o.reshape(T, B, S_, C_).sum(-1) == 1).all()
    else:
      np.testing.assert_allclose(o, r, rtol=2e-4, atol=2e-4, err_msg=name)
  fused = _port_grads(ops.observe_fused, setup, True)
  assert all(np.abs(g).max() > 0 for g in fused.values())
  _assert_close_by_scale(fused, _jax_grads(setup, True, C_), 'fused vs jax')


def test_adjoints_match_autograd_taps(setup):
  """Each per-step adjoint the backward route emits equals the gradient
  autograd leaves at the same pre-activation of the plain loop."""
  params, data, is_first, gumbel, mix = setup
  params, data = _torch(params), _torch(data)
  first = torch.as_tensor(is_first)
  noise = torch.as_tensor(gumbel)
  stoch0, deter0, actions, embeds = data
  for x in (stoch0, deter0):
    x.requires_grad_(True)
  taps = []
  outs = ops.observe_scan_full(params, *data, first, noise=noise,
                               unimix=UNIMIX, sample=True, taps=taps)
  loss = sum((o * torch.as_tensor(m)).sum() for o, m in zip(outs, mix))
  loss.backward()
  with torch.no_grad():
    fwd = ops.observe_fwd_plain(params, *data, first, noise=noise,
                                unimix=UNIMIX, sample=True)
    e_proj = embeds @ params['w_obs_e']
    cts = [torch.as_tensor(m) for m in mix]
    got = ops.observe_bwd_plain(
        params, stoch0, deter0, actions, e_proj, first, fwd[0], fwd[1],
        fwd[3], cts, unimix=UNIMIX)
  dz1, dn1, dzg, dng, dz2, dn2, dqs, dms, dpl_total, ds0, dd0 = got
  stack = lambda fn: torch.stack([fn(tap).grad for tap in taps], 0)
  want = {
      'dz1': stack(lambda t: t['z1']), 'dn1': stack(lambda t: t['n1']),
      'dzg': stack(lambda t: t['zg']), 'dng': stack(lambda t: t['ng']),
      'dz2': stack(lambda t: t['z2']), 'dn2': stack(lambda t: t['n2']),
      'dpl_total': stack(lambda t: t['post_logit']),
      'ds0': stoch0.grad, 'dd0': deter0.grad}
  have = dict(dz1=dz1, dn1=dn1, dzg=dzg, dng=dng, dz2=dz2, dn2=dn2,
              dpl_total=dpl_total, ds0=ds0, dd0=dd0)
  for i in range(len(dqs)):
    want[f'dq{i}'] = stack(lambda t: t['qs'][i])
    want[f'dm{i}'] = stack(lambda t: t['ms'][i])
    have[f'dq{i}'], have[f'dm{i}'] = dqs[i], dms[i]
  for name, value in want.items():
    scale = max(1e-3, float(value.abs().max()))
    np.testing.assert_allclose(
        have[name].numpy() / scale, value.numpy() / scale, rtol=1e-4,
        atol=1e-4, err_msg=name)


def test_none_cotangents_and_bf16_cotangents(setup):
  """A loss that reads only some outputs, through a bf16 cast, still
  differentiates: absent cotangents are zeros, others are widened."""
  params, data, is_first, gumbel, _ = setup
  params, data = _torch(params), _torch(data)
  params['w_post'].requires_grad_(True)
  params['w_st'].requires_grad_(True)
  outs = ops.observe_fused(params, *data, torch.as_tensor(is_first),
                           unimix=UNIMIX, sample=False)
  loss = outs[1].to(torch.bfloat16).float().square().mean()
  g_post, g_st = torch.autograd.grad(
      loss, [params['w_post'], params['w_st']], allow_unused=True)
  assert torch.isfinite(g_post).all() and g_post.abs().max() > 0
  assert g_st is None or (g_st == 0).all()  # Prior logits were not read.


def test_cuda_wrappers_refuse_cpu_tensors(setup):
  """The kernel wrappers never fall back: CPU tensors are refused, and no
  launch is counted."""
  params, data, is_first, gumbel, mix = setup
  params, data = _torch(params), _torch(data)
  first = torch.as_tensor(is_first)
  before = (ops.OBSERVE_FWD.launches, ops.OBSERVE_BWD.launches)
  with pytest.raises(ValueError):
    ops.observe_fwd_cuda(params, *data, first, sample=False)
  fwd = ops.observe_fwd_plain(params, *data, first, sample=False)
  stoch0, deter0, actions, embeds = data
  with pytest.raises(ValueError):
    ops.observe_bwd_cuda(
        params, stoch0, deter0, actions, embeds @ params['w_obs_e'], first,
        fwd[0], fwd[1], fwd[3], [torch.as_tensor(m) for m in mix])
  assert (ops.OBSERVE_FWD.launches, ops.OBSERVE_BWD.launches) == before


def test_library_name_follows_source_and_headers(tmp_path):
  """An edit of a kernel's source or of a header it includes gives the
  library another name, so it builds anew."""
  from daydreamer_tpu_torch.ops import build
  source, header = tmp_path / 'k.cu', tmp_path / 'k.cuh'
  source.write_text('#include "k.cuh"\n')
  header.write_text('// one\n')
  kernel = build.Kernel('k', str(source), 'none', {}, headers=(str(header),))
  first = kernel.library
  header.write_text('// two\n')
  second = kernel.library
  source.write_text('#include "k.cuh"\n// edited\n')
  assert len({first, second, kernel.library}) == 3
  # The forward and the backward include the same headers, and an edit of
  # any of them renames both libraries (checked on copies).
  headers = ops.OBSERVE_FWD.headers
  assert set(headers) == set(ops.OBSERVE_BWD.headers)
  copies = {}
  for path in (*headers, ops.OBSERVE_FWD.source, ops.OBSERVE_BWD.source):
    copies[path] = tmp_path / path.name
    copies[path].write_bytes(path.read_bytes())
  pair = [build.Kernel(k.name, str(copies[k.source]), 'none', {},
                       headers=[str(copies[h]) for h in k.headers])
          for k in (ops.OBSERVE_FWD, ops.OBSERVE_BWD)]
  for header in headers:
    before = [k.library for k in pair]
    copies[header].write_text(copies[header].read_text() + '\n// edited\n')
    assert all(k.library != name for k, name in zip(pair, before)), header


def test_registered_headers_are_what_sources_include():
  """Each CUDA kernel names as its headers exactly the files of `csrc/` its
  source includes, directly or through another header, so that an edit of
  any of them builds it anew."""
  import re
  from daydreamer_tpu_torch.ops import build
  from daydreamer_tpu_torch.ops import rssm  # noqa: F401 (registers)
  include = re.compile(r'^#include "([^"/]+)"', re.M)
  for kernel in build.KERNELS:
    if kernel.route != 'cuda':
      continue
    found, todo = set(), [kernel.source]
    while todo:
      for name in include.findall(todo.pop().read_text()):
        if name not in found:
          found.add(name)
          todo.append(build.CSRC / name)
    assert {h.name for h in kernel.headers} == found, kernel.name


def test_observe_fwd_pointers_keep_the_parent_order(setup, monkeypatch):
  """`observe_fwd_cuda` hands the kernel the pointers in the order of the
  kernel's parent design, which reads them one after another, and adds its
  two float32 scratch tensors (the embed product, the chain's float32
  deter) and the workspace's pointer at the end only (and a dim past the
  parent's, the values a load): so a parent's source still runs under the
  tree's wrapper (`chip_smoke.py --compare`)."""
  from daydreamer_tpu_torch.ops import build
  params, data, is_first, gumbel, _ = setup
  params, data = _torch(params), _torch(data)
  calls = []
  monkeypatch.setattr(build, 'check', lambda *args: None)
  monkeypatch.setattr(build, 'launch', lambda *args: calls.append(args))
  outs = ops.observe_fwd_cuda(params, *data, torch.as_tensor(is_first),
                              noise=torch.as_tensor(gumbel), unimix=UNIMIX)
  (kernel, fn, dtype, ptrs, dims, scalars, _), = calls
  assert (kernel, fn, dtype) == (ops.OBSERVE_FWD, 'observe_fwd', torch.float32)
  assert dims == [T, B, A, E, D, U, S, C, 2, 4] and scalars == [UNIMIX]
  flat, _ = ops.flatten_params(params)
  parent = [*data, None, None, *outs, *flat]
  assert len(ptrs) == len(parent) + 3
  for i, (got, want) in enumerate(zip(ptrs, parent)):
    if want is not None:
      assert got is want, i
  first, noise = ptrs[4:6]
  assert torch.equal(first, torch.as_tensor(is_first).float())
  assert torch.equal(noise, torch.as_tensor(gumbel))
  e_proj, d_t, workspace = ptrs[len(parent):]
  assert e_proj.dtype == d_t.dtype == torch.float32
  assert e_proj.shape == (T, B, U) and d_t.shape == (T, B, D)
  assert workspace is None  # The chain's vectors fit shared memory.


# ---------------------------------------------------------------------------
# RSSM.observe with impl='pallas' on both sides.


def _rssm_pair(initial, seed=0):
  """A JAX RSSM (impl pallas) and the port's, on the same weights; returns
  functions running `observe` on each with the modes as samples."""
  from daydreamer_tpu import nn as jnn
  from daydreamer_tpu.models.nets import RSSM as JRSSM
  from daydreamer_tpu_torch.models.nets import RSSM as PRSSM
  kw = dict(deter=32, stoch=4, classes=8, unimix=UNIMIX, units=32,
            act='elu', norm='layer', initial=initial, prior_layers=2)
  rng = np.random.default_rng(seed)
  Bn, Tn, An, En = 3, 6, 5, 16
  embed = rng.standard_normal((Bn, Tn, En)).astype(np.float32)
  action = rng.standard_normal((Bn, Tn, An)).astype(np.float32)
  is_first = np.zeros((Bn, Tn), bool)
  is_first[:2, 0] = True  # Row 2 continues from the initial state.
  is_first[1, 3] = True  # Inside the chunk: pins the zero mask.

  def jrun(impl, state, create):
    model = JRSSM('rssm', impl=impl, **kw)
    fn = jnn.pure(lambda: model.observe(
        jnp.asarray(embed), jnp.asarray(action), jnp.asarray(is_first)))
    (post, prior), state = fn(state, 0, create=create)
    return post, prior, state

  _, _, state = jrun('scan', {}, True)
  # Move the weights off their initial values (norm scales 1, biases and
  # the learned initial deter 0), so each one's wiring shows.
  state = {k: v + 0.1 * jnp.asarray(rng.standard_normal(v.shape), v.dtype)
           for k, v in state.items()}

  model = PRSSM('rssm', impl='pallas', **kw)
  gen = torch.Generator().manual_seed(0)
  targs = (torch.as_tensor(embed), torch.as_tensor(action),
           torch.as_tensor(is_first).float())
  with pnn.scope(generator=gen, create=True), torch.no_grad():
    model.observe(*targs)
  pnn.assign(model, pnn.from_jax_state(state, pnn.kinds(model)))

  def prun():
    with pnn.scope(generator=gen):
      return model.observe(*targs)

  return lambda: jrun('pallas', state, False)[:2], prun, model


@pytest.mark.parametrize('initial', ['zeros', 'learned2'])
def test_rssm_observe_pallas_matches_jax(initial, monkeypatch):
  jrun, prun, model = _rssm_pair(initial)
  # Modes on both sides, in the test only: the JAX caller's fused call runs
  # with sample=False, the port draws zero noise.
  fused = prv.observe_fused
  monkeypatch.setattr(prv, 'observe_fused', lambda *a, **k: fused(
      *a, **{**k, 'sample': False}))
  monkeypatch.setattr(ops, 'gumbel', lambda shape, generator, device: (
      torch.zeros(shape, device=device)))
  calls = []
  plain = ops.observe_fwd_plain
  monkeypatch.setattr(ops, 'observe_fwd_plain', lambda *a, **k: (
      calls.append(1) or plain(*a, **k)))
  jpost, jprior = jrun()
  ppost, pprior = prun()
  assert calls, 'The fused chain did not run.'
  for name, jst, pst in (('post', jpost, ppost), ('prior', jprior, pprior)):
    assert set(jst) == set(pst) == {'stoch', 'deter', 'logit'}
    for key in jst:
      j, p = np.asarray(jst[key], np.float32), pst[key].detach().numpy()
      assert j.shape == p.shape, (name, key)
      if key == 'stoch':
        assert (j == p).all(), (name, key)
      else:
        np.testing.assert_allclose(p, j, rtol=2e-4, atol=2e-4,
                                   err_msg=f'{name} {key}')
    probs = np.exp(pst['logit'].detach().numpy())
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-4)
    assert probs.min() >= UNIMIX / 8 * 0.98
  # The prior's stoch is the mode of its logits.
  mode = pprior['logit'].argmax(-1)
  assert (pprior['stoch'].argmax(-1) == mode).all()
  assert (pprior['stoch'].sum(-1) == 1).all()
  assert pprior['deter'] is ppost['deter'] or torch.equal(
      pprior['deter'], ppost['deter'])


def test_rssm_observe_pallas_gradients_reach_every_master(monkeypatch):
  """Gradients of the fused path flow through the slices and casts to each
  master weight, with `learned2` also to `initial_deter`; each concat
  kernel gets the gradient of BOTH its slices."""
  _, prun, model = _rssm_pair('learned2')
  monkeypatch.setattr(ops, 'gumbel', lambda shape, generator, device: (
      torch.zeros(shape, device=device)))
  calls = []
  plain = ops.observe_bwd_plain
  monkeypatch.setattr(ops, 'observe_bwd_plain', lambda *a, **k: (
      calls.append(1) or plain(*a, **k)))
  # Start from a given state so that stoch0/deter0 depend on no first flag.
  with pnn.scope(generator=torch.Generator().manual_seed(0)):
    post, prior = prun()
    loss = model.kl_loss(post, prior).mean() + post['deter'].square().mean()
    loss = loss + (post['stoch'] * torch.arange(8.0)).mean()
  named = dict(model.named_state(trainable=True))
  grads = torch.autograd.grad(loss, list(named.values()), allow_unused=True)
  assert calls, 'The plain adjoint chain did not run.'
  grads = dict(zip(named, grads))
  for key, grad in grads.items():
    assert grad is not None and torch.isfinite(grad).all(), key
    assert grad.abs().max() > 0, key
  SCn, Dn = 4 * 8, 32
  for key, split in (('rssm/img_in/kernel', SCn), ('rssm/gru_out/kernel', Dn),
                     ('rssm/obs_out/kernel', Dn)):
    assert grads[key][:split].abs().max() > 0, key
    assert grads[key][split:].abs().max() > 0, key

"""The port's `imagine`, `observe` and `gve` (plain routes, on the CPU)
against the JAX package's Pallas kernels in interpret mode, its scan
references and its λ-return scan, and the proof entry point at a tiny shape.

Weights and inputs are made with numpy from a seed (the port's
`make_params`) and handed to both sides. float32: one-hots equal, deters
within 1e-5, logits within 1e-4 (the bounds of tests/test_pallas_rssm.py:
the same float32 arithmetic summed in another order). Sampling: the key
chain of `imagine_scan` / `observe_scan` is replayed in JAX and its Gumbel
noise handed to the port as numpy.
"""

import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daydreamer_tpu.ops import lambda_returns as jlr
from daydreamer_tpu.ops import pallas_rssm as pr
from daydreamer_tpu_torch.ops import lambda_returns as lr
from daydreamer_tpu_torch.ops import rssm as ops
from daydreamer_tpu_torch.scripts import pallas_proof

torch.set_num_threads(1)

D, U, S, C, A, E = 128, 128, 8, 16, 12, 64
B, H = 8, 4
ROOT = pathlib.Path(__file__).resolve().parent.parent


def _jax(tree, dtype=None):
  if isinstance(tree, dict):
    return {k: _jax(v, dtype) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return [_jax(v, dtype) for v in tree]
  if isinstance(tree, int):
    return tree
  value = jnp.asarray(tree.float().numpy())
  return value if dtype is None else value.astype(dtype)


def make_setup(dtype=torch.float32, D=D, U=U, S=S, C=C, prior_layers=2):
  """Weights with non-trivial norm scales and biases, so that a wrong
  wiring shows, and one sequence whose `is_first` has first steps inside."""
  rng = np.random.default_rng(0)
  params = ops.make_params(0, D, U, S, C, A, E, prior_layers=prior_layers)
  t = lambda x: torch.as_tensor(np.asarray(x, np.float32))
  for key, value in params.items():
    if key.startswith('ln_') and key.endswith('_scale'):
      scale = lambda v: t(1 + 0.1 * rng.standard_normal(v.shape))
      params[key] = ([scale(v) for v in value] if isinstance(value, list)
                     else scale(value))
    if key.startswith('b_') or (key.startswith('ln_')
                                and key.endswith('_bias')):
      bias = lambda v: t(0.1 * rng.standard_normal(v.shape))
      params[key] = ([bias(v) for v in value] if isinstance(value, list)
                     else bias(value))
  stoch0 = t(np.eye(C)[rng.integers(0, C, (B, S))].reshape(B, S * C))
  deter0 = t(0.1 * rng.standard_normal((B, D)))
  actions = t(rng.standard_normal((H, B, A)))
  embeds = t(rng.standard_normal((H, B, E)))
  is_first = np.zeros((H, B), bool)
  is_first[0] = True
  is_first[2, :3] = True
  cast = lambda tree: (
      {k: cast(v) for k, v in tree.items()} if isinstance(tree, dict)
      else [cast(v) for v in tree] if isinstance(tree, list)
      else tree if isinstance(tree, int) else tree.to(dtype))
  return (cast(params), cast(stoch0), cast(deter0), cast(actions),
          cast(embeds), torch.as_tensor(is_first))


@pytest.fixture(scope='module')
def setup():
  return make_setup()


def _compare(ref, out):
  d1, l1, s1 = (np.asarray(x) for x in ref)
  d2, l2, s2 = (x.numpy() for x in out)
  assert (s1 == s2).all()
  np.testing.assert_allclose(d2, d1, atol=1e-5, rtol=0)
  np.testing.assert_allclose(l2, l1, atol=1e-4, rtol=0)


def _scan_noise(seed, steps):
  """The Gumbel noise that `imagine_scan` and `observe_scan` draw: per step
  `key, sub = split(key)` and `gumbel(sub, [B, S, C])`."""
  key = jax.random.PRNGKey(seed)
  noise = []
  for _ in range(steps):
    key, sub = jax.random.split(key)
    noise.append(np.asarray(
        jax.random.gumbel(sub, (B, S, C), jnp.float32)).reshape(B, S * C))
  return torch.as_tensor(np.stack(noise))


@pytest.mark.parametrize('unimix', [0.01, 0.0])
def test_imagine_matches_pallas_kernel(setup, unimix):
  params, stoch0, deter0, actions, _, _ = setup
  ref = pr.imagine_pallas(
      _jax(params), _jax(stoch0), _jax(deter0), _jax(actions), 0,
      unimix=unimix, sample=False, interpret=True)
  out = ops.imagine(params, stoch0, deter0, actions, unimix=unimix,
                    sample=False)
  _compare(ref, out)


@pytest.mark.parametrize('unimix', [0.01, 0.0])
def test_observe_matches_pallas_kernel(setup, unimix):
  params, stoch0, deter0, actions, embeds, is_first = setup
  assert is_first[2, :3].all() and not is_first[2, 3:].any()
  ref = pr.observe_pallas(
      _jax(params), _jax(stoch0), _jax(deter0), _jax(actions), _jax(embeds),
      jnp.asarray(is_first.numpy()), 0, unimix=unimix, sample=False,
      interpret=True)
  out = ops.observe(params, stoch0, deter0, actions, embeds, is_first,
                    unimix=unimix, sample=False)
  _compare(ref, out)


# Widths past the kernels' first layouts, each of which the JAX package's
# kernels take: the audit's deter 20, units 12, 3 x 4 latents; no prior
# layer (the head reads the deter, D 24 against U 16); 9 prior layers. As
# (D, U, S, C, prior layers).
WIDTHS = {'d20_u12_3x4': (20, 12, 3, 4, 2), 'prior0': (24, 16, 4, 8, 0),
          'prior9': (16, 16, 4, 4, 9)}


@pytest.mark.parametrize('widths', sorted(WIDTHS))
def test_imagine_and_observe_match_pallas_kernels_at_widths(widths):
  """`imagine` and `observe` (plain, on the CPU) against the Pallas
  kernels in interpret mode at each width of WIDTHS, the modes (the
  kernels' in-core generator has no CPU rule)."""
  params, stoch0, deter0, actions, embeds, is_first = make_setup(
      torch.float32, *WIDTHS[widths])
  ref = pr.imagine_pallas(
      _jax(params), _jax(stoch0), _jax(deter0), _jax(actions), 0,
      unimix=0.01, sample=False, interpret=True)
  _compare(ref, ops.imagine(params, stoch0, deter0, actions, unimix=0.01,
                            sample=False))
  ref = pr.observe_pallas(
      _jax(params), _jax(stoch0), _jax(deter0), _jax(actions),
      _jax(embeds), jnp.asarray(is_first.numpy()), 0, unimix=0.01,
      sample=False, interpret=True)
  _compare(ref, ops.observe(params, stoch0, deter0, actions, embeds,
                            is_first, unimix=0.01, sample=False))


@pytest.mark.parametrize('seed', [3, 5])
def test_imagine_sampled_matches_scan(setup, seed):
  params, stoch0, deter0, actions, _, _ = setup
  ref = pr.imagine_scan(
      _jax(params), _jax(stoch0), _jax(deter0), _jax(actions), seed,
      sample=True)
  out = ops.imagine(params, stoch0, deter0, actions,
                    noise=_scan_noise(seed, H))
  _compare(ref, out)
  assert (out[2].reshape(H, B, S, C).sum(-1) == 1).all()
  assert (out[2][0] != out[2][1]).any()


@pytest.mark.parametrize('seed', [3, 5])
def test_observe_sampled_matches_scan(setup, seed):
  params, stoch0, deter0, actions, embeds, is_first = setup
  ref = pr.observe_scan(
      _jax(params), _jax(stoch0), _jax(deter0), _jax(actions), _jax(embeds),
      jnp.asarray(is_first.numpy()), seed, sample=True)
  out = ops.observe(params, stoch0, deter0, actions, embeds, is_first,
                    noise=_scan_noise(seed, H))
  _compare(ref, out)


def test_sampling_draws_from_the_generator(setup):
  """Without given noise the wrapper draws it from the caller's generator:
  the same seed gives the same rollout, another seed another."""
  params, stoch0, deter0, actions, embeds, is_first = setup
  gen = lambda seed: torch.Generator().manual_seed(seed)
  a = ops.imagine(params, stoch0, deter0, actions, generator=gen(1))
  b = ops.imagine(params, stoch0, deter0, actions, generator=gen(1))
  c = ops.imagine(params, stoch0, deter0, actions, generator=gen(2))
  assert (a[2] == b[2]).all() and (a[2] != c[2]).any()
  args = (params, stoch0, deter0, actions, embeds, is_first)
  a = ops.observe(*args, generator=gen(1))
  b = ops.observe(*args, generator=gen(1))
  c = ops.observe(*args, generator=gen(2))
  assert (a[2] == b[2]).all() and (a[2] != c[2]).any()


@pytest.mark.parametrize('cell', ['imagine', 'observe'])
def test_bfloat16_close_to_pallas_kernel(cell):
  """bfloat16 on both sides, without sampling. Both round every product,
  norm and ELU to bfloat16, but sum in another order, so a value may land
  on the neighbouring bfloat16 (2^-8 of its size) and an argmax between
  two close logits may flip. Tolerance: at step 0, where the inputs are
  equal, deters within 8e-3 (a unit in the last place at 1) and logits
  within 5e-2; over all steps at least 90 % of (step, row) one-hots equal."""
  params, stoch0, deter0, actions, embeds, is_first = make_setup(
      torch.bfloat16)
  bf = jnp.bfloat16
  if cell == 'imagine':
    ref = pr.imagine_pallas(
        _jax(params, bf), _jax(stoch0, bf), _jax(deter0, bf),
        _jax(actions, bf), 0, sample=False, interpret=True)
    out = ops.imagine(params, stoch0, deter0, actions, sample=False)
  else:
    ref = pr.observe_pallas(
        _jax(params, bf), _jax(stoch0, bf), _jax(deter0, bf),
        _jax(actions, bf), _jax(embeds, bf), jnp.asarray(is_first.numpy()),
        0, sample=False, interpret=True)
    out = ops.observe(params, stoch0, deter0, actions, embeds, is_first,
                      sample=False)
  d1, l1, s1 = (np.asarray(x.astype(jnp.float32)) for x in ref)
  d2, l2, s2 = (x.float().numpy() for x in out)
  assert out[0].dtype == torch.bfloat16 and out[1].dtype == torch.float32
  np.testing.assert_allclose(d2[0], d1[0], atol=8e-3, rtol=0)
  np.testing.assert_allclose(l2[0], l1[0], atol=5e-2, rtol=0)
  assert (s1 == s2).all(-1).mean() >= 0.9


def test_make_params_layout_matches_jax():
  ours = ops.make_params(0, D, U, S, C, A, E, prior_layers=2)
  theirs = pr.make_params(jax.random.PRNGKey(0), D, U, S, C, A, E,
                          prior_layers=2)
  assert set(ours) == set(theirs)
  shape = lambda v: ([tuple(x.shape) for x in v] if isinstance(v, list)
                     else v if isinstance(v, int) else tuple(v.shape))
  assert {k: shape(v) for k, v in ours.items()} == {
      k: shape(v) for k, v in theirs.items()}
  ours = ops.make_actor_params(7, D, U, S, C, A)
  theirs = pr.make_actor_params(jax.random.PRNGKey(7), D, U, S, C, A)
  assert {k: shape(v) for k, v in ours.items()} == {
      k: shape(v) for k, v in theirs.items()}


def test_cuda_routes_refuse_cpu_tensors(setup):
  """On the CPU the wrappers run the plain versions and launch nothing; a
  CUDA route handed CPU tensors raises: it never falls back."""
  params, stoch0, deter0, actions, embeds, is_first = setup
  before = (ops.IMAGINE.launches, ops.OBSERVE.launches, lr.GVE.launches)
  ops.imagine(params, stoch0, deter0, actions, sample=False)
  ops.observe(params, stoch0, deter0, actions, embeds, is_first,
              sample=False)
  lr.gve(torch.ones(3, 4), torch.ones(3, 4), torch.ones(4), 0.95)
  assert (ops.IMAGINE.launches, ops.OBSERVE.launches,
          lr.GVE.launches) == before
  with pytest.raises(ValueError, match='not on a card'):
    ops.imagine_cuda(params, stoch0, deter0, actions)
  with pytest.raises(ValueError, match='not on a card'):
    ops.observe_cuda(params, stoch0, deter0, actions, embeds, is_first)
  with pytest.raises(ValueError, match='lies on cpu'):
    lr.gve_triton(torch.ones(3, 4), torch.ones(3, 4), torch.ones(4), 0.95)


def test_wrappers_refuse_shapes_the_kernels_cannot_take(setup, monkeypatch):
  """The wrappers refuse a wrong dtype and inconsistent shapes, and take
  every width the JAX package's kernels take: deters whose vectors outgrow
  shared memory (through a workspace), widths that are no multiple of 8
  (narrower loads). The launches are recorded here, on the CPU."""
  from daydreamer_tpu_torch.ops import build
  params, stoch0, deter0, actions, embeds, is_first = setup
  with pytest.raises(ValueError, match='has shape'):
    ops.observe_cuda(params, stoch0, deter0, actions[..., :5], embeds,
                     is_first)
  with pytest.raises(TypeError):
    ops.imagine_cuda(params, stoch0.double(), deter0, actions)
  calls = []
  monkeypatch.setattr(build, 'check', lambda *args, **kwargs: None)
  monkeypatch.setattr(build, 'launch', lambda *args: calls.append(args))
  # imagine's products' sums at D 2 048 outgrow shared memory.
  wide = ops.make_params(0, 2048, 2048, 32, 32, A, E)
  ops.imagine_cuda(wide, torch.zeros(B, 1024), torch.zeros(B, 2048),
                   actions)
  workspace = calls[-1][3][-1]
  assert workspace is not None and workspace.dtype == torch.float32
  # observe at widths that are no multiple of 8 reads fewer values a load:
  # 4 float32 values where each width is a multiple of 4, else 1.
  for d, u, s, c, values in ((12, U, S, C, 4), (D, 20, S, C, 4),
                             (D, U, 3, 5, 1)):
    narrow = ops.make_params(0, d, u, s, c, A, E)
    ops.observe_cuda(narrow, torch.zeros(B, s * c), torch.zeros(B, d),
                     actions, embeds, is_first)
    dims, ptrs = calls[-1][4], calls[-1][3]
    assert dims == [H, B, A, E, d, u, s, c, values] and ptrs[-1] is None
  # observe's chain at D 4 096 keeps its vectors in a workspace.
  wide = ops.make_params(0, 4096, 512, 32, 32, A, E)
  ops.observe_cuda(wide, torch.zeros(B, 1024), torch.zeros(B, 4096),
                   actions, embeds, is_first)
  assert calls[-1][3][-1] is not None


def test_observe_pointers_keep_the_parent_order(setup, monkeypatch):
  """`observe_cuda` hands the kernel the pointers in the order of the
  kernel's parent design, which reads them one after another, and adds its
  float32 scratch (the prologue's embed product) and the workspace's
  pointer at the end only (and a dim past the parent's, the values a
  load): so a parent's source still runs under the tree's wrapper
  (`chip_smoke.py --compare`)."""
  from daydreamer_tpu_torch.ops import build
  params, stoch0, deter0, actions, embeds, is_first = setup
  noise = torch.as_tensor(np.random.default_rng(1).gumbel(
      size=(H, B, S * C)).astype(np.float32))
  calls = []
  monkeypatch.setattr(build, 'check', lambda *args: None)
  monkeypatch.setattr(build, 'launch', lambda *args: calls.append(args))
  outs = ops.observe_cuda(params, stoch0, deter0, actions, embeds, is_first,
                          noise=noise, unimix=0.01)
  (kernel, fn, dtype, ptrs, dims, scalars, _), = calls
  assert (kernel, fn, dtype) == (ops.OBSERVE, 'observe', torch.float32)
  assert dims == [H, B, A, E, D, U, S, C, 4] and scalars == [0.01]
  weights = [params[k] for k in (
      'w_in_s', 'w_in_a', 'ln_in_scale', 'ln_in_bias', 'w_gru_d', 'w_gru_x',
      'ln_gru_scale', 'ln_gru_bias', 'w_obs_d', 'w_obs_e', 'ln_obs_scale',
      'ln_obs_bias', 'w_post', 'b_post')]
  parent = [stoch0, deter0, actions, embeds, None, None, *outs, *weights]
  assert len(parent) == 23 and len(ptrs) == len(parent) + 2
  for i, (got, want) in enumerate(zip(ptrs, parent)):
    if want is not None:
      assert got is want, i
  first, noise_ptr = ptrs[4:6]
  assert torch.equal(first, is_first.float())
  assert torch.equal(noise_ptr, noise)
  e_proj, workspace = ptrs[len(parent):]
  assert e_proj.dtype == torch.float32 and e_proj.shape == (H, B, U)
  assert workspace is None  # The vectors fit shared memory.


# ---------------------------------------------------------------------------
# λ-returns.


def _gve_pallas():
  spec = importlib.util.spec_from_file_location(
      'jax_pallas_proof', ROOT / 'scripts' / 'pallas_proof.py')
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module.gve_pallas


@pytest.mark.parametrize('horizon,lanes', [(15, 64), (15, 256), (15, 2048)])
def test_gve_plain_matches_scan_and_pallas(horizon, lanes):
  rng = np.random.default_rng(0)
  interm = rng.normal(size=(horizon, lanes)).astype(np.float32)
  disc = rng.uniform(0.9, 1.0, size=(horizon, lanes)).astype(np.float32)
  boot = rng.normal(size=(lanes,)).astype(np.float32)
  # rtol 1e-6 as the JAX package holds its kernel to its scan, plus atol
  # 1e-6: XLA contracts the multiply and the add into one fused operation
  # and PyTorch does not, which moves a value by a unit in the last place
  # of its terms (of order 1 to 10), more than 1e-6 of a sum near zero.
  tol = dict(rtol=1e-6, atol=1e-6)
  out = lr.gve(*(torch.as_tensor(x) for x in (interm, disc, boot)), 0.95)
  scan = jlr.gve_scan(*(jnp.asarray(x) for x in (interm, disc, boot)), 0.95)
  np.testing.assert_allclose(out.numpy(), np.asarray(scan), **tol)
  pallas = _gve_pallas()(
      *(jnp.asarray(x) for x in (interm, disc, boot)), 0.95, interpret=True)
  np.testing.assert_allclose(out.numpy(), np.asarray(pallas), **tol)


def test_gve_keeps_trailing_shape():
  rng = np.random.default_rng(1)
  interm = torch.as_tensor(rng.normal(size=(5, 3, 4)).astype(np.float32))
  disc = torch.full((5, 3, 4), 0.9)
  boot = torch.zeros(3, 4)
  out = lr.gve(interm, disc, boot, 0.95)
  assert out.shape == (5, 3, 4)
  np.testing.assert_allclose(out[-1].numpy(), interm[-1].numpy())


# ---------------------------------------------------------------------------
# The proof entry point.


def test_proof_entry_point_on_cpu(tmp_path, capsys):
  out_file = tmp_path / 'proof.json'
  tiny = (('tiny', 'observe', 4, 3, 32, 32, 4, 8, 5, 16),
          ('tiny', 'imagine', 8, 3, 32, 32, 4, 8, 5, 16))
  result = pallas_proof.main(
      ['--which', 'all', '--device', 'cpu', '--out', str(out_file)],
      cases=tiny, correctness=(4, 3, 32, 32, 4, 8, 5, 16),
      returns=((5, 16),))
  lines = capsys.readouterr().out.strip().splitlines()
  assert json.loads(lines[-1]) == result == json.loads(out_file.read_text())
  assert result['backend'] == 'cpu'
  assert set(result) == {'backend', 'rssm_correctness', 'rssm_cells',
                         'lambda_returns_standalone'}
  assert result['rssm_correctness'] == {
      'imagine_deter_maxdiff': 0.0, 'imagine_stoch_agree': 1.0,
      'observe_deter_maxdiff': 0.0, 'observe_stoch_agree': 1.0}
  assert [row['cell'] for row in result['rssm_cells']] == [
      'observe', 'imagine']
  for row in result['rssm_cells']:
    assert set(row) == {'cell', 'shape', 'dtype', 'B', 'T', 'deter', 'units',
                        'stoch', 'plain_us', 'kernel_us', 'speedup_vs_plain'}
    # No card, no time: a CPU run states no device metric.
    assert row['kernel_us'] is None and row['dtype'] == 'bfloat16'
  assert result['lambda_returns_standalone'] == [{
      'horizon': 5, 'lanes': 16, 'plain_us': None, 'kernel_us': None,
      'speedup': None}]
  assert sum(line.startswith('rssm ') for line in lines) == 2
  assert sum(line.startswith('returns ') for line in lines) == 1


def test_proof_entry_point_needs_a_card_by_default():
  with pytest.raises(RuntimeError, match='--device cpu'):
    pallas_proof.main(['--which', 'returns'])

"""The port's plain `imagine_actor` against the JAX package's Pallas kernel
in interpret mode (its own CPU route, as tests/test_pallas_rssm.py runs it).

One-hots must be equal; deters agree within 1e-5 and logits within 1e-4:
the same float32 arithmetic, summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daydreamer_tpu.ops import pallas_rssm as pr
from daydreamer_tpu_torch.ops import rssm as ops

torch.set_num_threads(1)

D, U, S, C, A = 64, 64, 8, 16, 6
B, H = 8, 4


def _torch(tree):
  if isinstance(tree, dict):
    return {k: _torch(v) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return [_torch(v) for v in tree]
  if isinstance(tree, int):
    return tree
  return torch.as_tensor(np.array(tree))


@pytest.fixture(scope='module')
def setup():
  rng = np.random.default_rng(0)
  params = pr.make_params(jax.random.PRNGKey(0), D, U, S, C, A, 32,
                          prior_layers=2)
  actor = pr.make_actor_params(jax.random.PRNGKey(7), D, U, S, C, A)
  # Non-trivial norm parameters, so a wrong LN wiring shows.
  for tree in (params, actor):
    for key in ('ln_in_scale', 'ln_gru_scale', 'ln_in_bias', 'ln_gru_bias'):
      if key in tree:
        tree[key] = jnp.asarray(
            1 + 0.1 * rng.standard_normal(tree[key].shape), jnp.float32)
  actor['ln_bias'] = [jnp.asarray(0.1 * rng.standard_normal(b.shape),
                                  jnp.float32) for b in actor['ln_bias']]
  actor['b_out'] = jnp.asarray(rng.standard_normal(A), jnp.float32)
  stoch0 = np.eye(C, dtype=np.float32)[rng.integers(0, C, (B, S))]
  stoch0 = stoch0.reshape(B, S * C)
  deter0 = (0.1 * rng.standard_normal((B, D))).astype(np.float32)
  action0 = np.eye(A, dtype=np.float32)[rng.integers(0, A, B)]
  return params, actor, stoch0, deter0, action0


def _compare(ref, out):
  d1, l1, s1, a1 = (np.asarray(x) for x in ref)
  d2, l2, s2, a2 = (x.numpy() for x in out)
  assert (s1 == s2).all()
  assert (a1 == a2).all()
  np.testing.assert_allclose(d2, d1, atol=1e-5, rtol=0)
  np.testing.assert_allclose(l2, l1, atol=1e-4, rtol=0)


@pytest.mark.parametrize('unimix,act_unimix', [(0.01, 0.1), (0.0, 0.0)])
def test_imagine_actor_plain_matches_jax_argmax(setup, unimix, act_unimix):
  params, actor, stoch0, deter0, action0 = setup
  ref = pr.imagine_actor_pallas(
      params, actor, jnp.asarray(stoch0), jnp.asarray(deter0),
      jnp.asarray(action0), H, 0, unimix=unimix, act_unimix=act_unimix,
      sample=False, interpret=True)
  out = ops.imagine_actor(
      _torch(params), _torch(actor), torch.as_tensor(stoch0),
      torch.as_tensor(deter0), torch.as_tensor(action0), H,
      unimix=unimix, act_unimix=act_unimix, sample=False)
  _compare(ref, out)


def test_imagine_actor_plain_matches_jax_sampled(setup):
  """Sampling on the same Gumbel noise, made as pallas_rssm.py:589-591
  makes it, is held to the interpret kernel bit for bit in its choices."""
  params, actor, stoch0, deter0, action0 = setup
  seed = 3
  ref = pr.imagine_actor_pallas(
      params, actor, jnp.asarray(stoch0), jnp.asarray(deter0),
      jnp.asarray(action0), H, seed, unimix=0.01, act_unimix=0.3,
      sample=True, interpret=True)
  k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
  noise = (torch.as_tensor(np.array(
               jax.random.gumbel(k1, (H, B, S * C), jnp.float32))),
           torch.as_tensor(np.array(
               jax.random.gumbel(k2, (H, B, A), jnp.float32))))
  out = ops.imagine_actor(
      _torch(params), _torch(actor), torch.as_tensor(stoch0),
      torch.as_tensor(deter0), torch.as_tensor(action0), H,
      unimix=0.01, act_unimix=0.3, sample=True, noise=noise)
  _compare(ref, out)
  # The noise made a difference: some latent differs from the argmax.
  mode = ops.imagine_actor(
      _torch(params), _torch(actor), torch.as_tensor(stoch0),
      torch.as_tensor(deter0), torch.as_tensor(action0), H,
      unimix=0.01, act_unimix=0.3, sample=False)
  assert (mode[2] != out[2]).any()


def test_imagine_actor_draws_from_generator(setup):
  """Without noise given, the wrapper draws it from the generator: the
  same seed gives the same rollout, valid one-hots throughout."""
  params, actor, stoch0, deter0, action0 = setup
  args = (_torch(params), _torch(actor), torch.as_tensor(stoch0),
          torch.as_tensor(deter0), torch.as_tensor(action0), H)
  outs = [ops.imagine_actor(*args, generator=torch.Generator().manual_seed(5))
          for _ in range(2)]
  for x, y in zip(*outs):
    assert torch.equal(x, y)
  _, _, stochs, actions = outs[0]
  assert (stochs.reshape(H, B, S, C).sum(-1) == 1).all()
  assert (actions.sum(-1) == 1).all()


def test_imagine_actor_cuda_wrapper_refuses_cpu_tensors(setup):
  """The kernel wrapper never falls back: CPU tensors are refused."""
  params, actor, stoch0, deter0, action0 = setup
  with pytest.raises(ValueError):
    ops.imagine_actor_cuda(
        _torch(params), _torch(actor), torch.as_tensor(stoch0),
        torch.as_tensor(deter0), torch.as_tensor(action0), H)


# Widths past the kernel's first layouts, each of which the JAX package's
# kernel takes: the audit's deter 20, units 12, 3 x 4 latents; no prior
# layer (the head reads the deter, D 24 against U 16); 9 prior layers; 9
# actor layers. As (D, U, S, C, prior layers, actor layers).
WIDTHS = {'d20_u12_3x4': (20, 12, 3, 4, 2, 4), 'prior0': (24, 16, 4, 8, 0, 2),
          'prior9': (16, 16, 4, 4, 9, 2), 'actor9': (16, 16, 4, 4, 1, 9)}


@pytest.mark.parametrize('widths', sorted(WIDTHS))
def test_imagine_actor_plain_matches_jax_at_widths(widths):
  """The plain rollout against the interpret kernel at each width of
  WIDTHS, argmax latents and actions, at the tolerances above."""
  D_, U_, S_, C_, n_out, n_act = WIDTHS[widths]
  B_, H_ = 4, 3
  rng = np.random.default_rng(1)
  params = pr.make_params(jax.random.PRNGKey(1), D_, U_, S_, C_, A, 32,
                          prior_layers=n_out)
  if not n_out:
    params['w_st'] = jnp.asarray(
        rng.uniform(-0.3, 0.3, (D_, S_ * C_)), jnp.float32)
  actor = pr.make_actor_params(jax.random.PRNGKey(8), D_, U_, S_, C_, A,
                               layers=n_act)
  actor['ln_bias'] = [jnp.asarray(0.1 * rng.standard_normal(b.shape),
                                  jnp.float32) for b in actor['ln_bias']]
  stoch0 = np.eye(C_, dtype=np.float32)[rng.integers(0, C_, (B_, S_))]
  stoch0 = stoch0.reshape(B_, S_ * C_)
  deter0 = (0.1 * rng.standard_normal((B_, D_))).astype(np.float32)
  action0 = np.eye(A, dtype=np.float32)[rng.integers(0, A, B_)]
  ref = pr.imagine_actor_pallas(
      params, actor, jnp.asarray(stoch0), jnp.asarray(deter0),
      jnp.asarray(action0), H_, 0, unimix=0.01, act_unimix=0.1,
      sample=False, interpret=True)
  out = ops.imagine_actor(
      _torch(params), _torch(actor), torch.as_tensor(stoch0),
      torch.as_tensor(deter0), torch.as_tensor(action0), H_,
      unimix=0.01, act_unimix=0.1, sample=False)
  _compare(ref, out)

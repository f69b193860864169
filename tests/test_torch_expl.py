"""The port's intrinsic reward modules (`agents/dreamer/expl.py`) against
the JAX package's, one module at a time, in float32.

Both sides build the module on the same numpy inputs; the JAX module's
state, its trainable entries perturbed so that zero biases and unit scales
matter, is carried into the port by `from_jax_state`. Each test compares
the reward before a train step, the train step's metrics, the whole state
after it and the reward after it. OneHot sampling returns the mode on both
sides (with the same straight-through gradient), as in
`test_torch_agent.py`.

Tolerances: rewards and metrics rtol 1e-4, atol 1e-5 (float32 on both
sides, summed in another order). The state after one update atol 1e-3,
a tenth of the learning rate, which is raised to 1e-2 here: an update in
another direction moves a weight by about 2e-2, twenty times that. Adam's
first step moves each weight by lr * g / (|g| + 1e-6), so where a
gradient is a near cancellation of about that eps, the rounding of the
sum moves the weight by up to about 2e-4 (one weight in 4096 here).
"""

import collections
import math

import jax
import numpy as np
import pytest
import torch

import daydreamer_tpu as ddt
import daydreamer_tpu_torch as ddp
from daydreamer_tpu import nn as jnn
from daydreamer_tpu.agents.dreamer import expl as jexpl
from daydreamer_tpu.nn import dists as jdists
from daydreamer_tpu_torch import nn as pnn
from daydreamer_tpu_torch.agents.dreamer import expl as pexpl
from daydreamer_tpu_torch.nn import dists as pdists
from daydreamer_tpu_torch.ops import onehot as ponehot

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-5)
STATE_TOL = dict(rtol=0, atol=1e-3)
T, B, H, N = 4, 3, 3, 6  # Replay chunk, batch; horizon, imagined starts.
D, S, C, A = 64, 8, 8, 3  # The debug config's RSSM; actions.
Space = collections.namedtuple('Space', 'shape discrete')

OVERRIDES = {
    'disag_models': 2, 'pbe_knn': 4,
    'expl_opt.lr': 1e-2, 'ctrl_opt.lr': 1e-2}


def configs(**kw):
  from daydreamer_tpu.agents.dreamer import Agent as JAXAgent
  from daydreamer_tpu_torch.agents.dreamer import Agent as PortAgent
  out = []
  for lib, agent in ((ddt, JAXAgent), (ddp, PortAgent)):
    config = lib.Config(agent.configs['defaults']).update(
        agent.configs['debug'])
    out.append(config.update({**OVERRIDES, **kw}))
  return out


def latents(lead, seed):
  rng = np.random.default_rng(seed)
  return {
      'deter': rng.standard_normal(lead + (D,)).astype(np.float32),
      'stoch': np.eye(S * C, dtype=np.float32)[
          rng.integers(0, S * C, lead)].reshape(lead + (S, C)),
      'action': np.eye(A, dtype=np.float32)[rng.integers(0, A, lead)],
  }


@pytest.fixture
def mode_sampling(monkeypatch):
  sg = jax.lax.stop_gradient
  monkeypatch.setattr(
      jdists.OneHotDist, 'sample',
      lambda self, key: sg(self.mode()) + self.probs - sg(self.probs))
  monkeypatch.setattr(
      pdists.OneHotDist, 'sample',
      lambda self, generator=None: (
          self.mode() + self.probs - self.probs.detach()))
  # The RSSM step's head (`ops/onehot.py`) samples with zero Gumbel noise.
  monkeypatch.setattr(ponehot, 'uniform', lambda shape, generator, device: (
      torch.full(shape, math.exp(-1), device=device)))


def _torch(tree):
  return {k: torch.as_tensor(v) for k, v in tree.items()}


def _np(x):
  return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def both(jmod, pmod, call, *inputs):
  """Create both modules by `call(module, *inputs)`, carry the JAX state
  (trainable entries perturbed) into the port, run `call` on both and
  return (jax out, port out, jax state after, port state after)."""
  jfn = jnn.pure(lambda *a: call(jmod, *a))
  _, state = jfn({}, 0, *inputs, create=True)
  tinputs = [_torch(x) for x in inputs]
  with pnn.scope(create=True):
    call(pmod, *tinputs)
  assert set(pnn.state(pmod)) == set(state)
  trainable = dict(pmod.named_state(trainable=True))
  assert trainable
  rng = np.random.default_rng(1)
  state = {k: np.asarray(v) + (
      0.1 * rng.standard_normal(v.shape).astype(np.float32)
      if k in trainable else 0) for k, v in state.items()}
  pnn.assign(pmod, pnn.from_jax_state(state, {}))
  jout, jstate = jfn(state, 0, *inputs)
  with pnn.scope():
    pout = call(pmod, *tinputs)
  return jout, pout, jstate, pnn.state(pmod)


def check(jout, pout, jstate, pstate):
  jrew, jmets, jrew2 = jout
  prew, pmets, prew2 = pout
  np.testing.assert_allclose(_np(prew), jrew, **TOL)
  assert set(pmets) == set(jmets)
  for key in jmets:
    np.testing.assert_allclose(_np(pmets[key]), jmets[key], **TOL,
                               err_msg=key)
  assert set(pstate) == set(jstate)
  for key, value in jstate.items():
    np.testing.assert_allclose(_np(pstate[key]), value, **STATE_TOL,
                               err_msg=key)
  np.testing.assert_allclose(_np(prew2), jrew2, **TOL)
  assert not np.allclose(jrew, jrew2)  # The update moved the reward.


def reward_and_train(module, traj, data):
  return module(traj), module.train(data), module(traj)


@pytest.mark.parametrize('inputs', [
    ('deter', 'stoch', 'action'), ('deter',)])
def test_disag(inputs):
  """Ensemble disagreement over two heads: the population std across
  the heads (jnp.std), one update of both heads on the next stoch."""
  jconfig, pconfig = configs(**{'disag_head.inputs': list(inputs)})
  space = Space((A,), True)
  jmod = jexpl.Disag('agent/disag', None, space, jconfig)
  pmod = pexpl.Disag('agent/disag', None, space, pconfig)
  traj, data = latents((H + 1, N), 2), latents((B, T), 3)
  out = both(jmod, pmod, reward_and_train, traj, data)
  assert out[0][0].shape == (H, N)
  assert [k for k in out[3] if '/head' in k and k.endswith('dense0/kernel')]
  check(*out)


def test_latent_vae(mode_sampling):
  """The ELBO surprise reward: an [8, 8] one-hot code of deter, the
  decoder's log-likelihood, the KL controller, one update."""
  jconfig, pconfig = configs(**{'expl_vae_elbo': True})
  space = Space((A,), True)
  jmod = jexpl.LatentVAE('agent/vae', None, space, jconfig)
  pmod = pexpl.LatentVAE('agent/vae', None, space, pconfig)
  traj, data = latents((H + 1, N), 4), latents((B, T), 5)
  out = both(jmod, pmod, reward_and_train, traj, data)
  assert pmod._shape == (8, 8)
  check(*out)


def test_ctrl_disag():
  """Disagreement in the inverse-dynamics embedding: the embedding and
  head update, then the ensemble's update on the new embedding."""
  jconfig, pconfig = configs()
  space = Space((A,), True)
  jmod = jexpl.CtrlDisag('agent/ctrl', None, space, jconfig)
  pmod = pexpl.CtrlDisag('agent/ctrl', None, space, pconfig)
  traj, data = latents((H + 1, N), 6), latents((B, T), 7)
  out = both(jmod, pmod, reward_and_train, traj, data)
  assert out[0][0].shape == (H, N)
  check(*out)


def test_pbe():
  """Particle-based entropy: the mean distance to the k nearest of all
  (H + 1) * N states, the state itself included at distance 0. Its
  reward has H + 1 rows, one more than a critic takes (the reference
  behavior that `test_torch_critics.py` holds)."""
  jconfig, pconfig = configs()
  space = Space((A,), True)
  jmod = jexpl.PBE('agent/pbe', None, space, jconfig)
  pmod = pexpl.PBE('agent/pbe', None, space, pconfig)
  traj = latents((H + 1, N), 8)
  traj['deter'][1, 2] = traj['deter'][0, 0]  # A duplicate: distance 0.
  jrew, _ = jnn.pure(lambda t: jmod(t))({}, 0, traj)
  with pnn.scope():
    prew = pmod(_torch(traj))
  assert prew.shape == (H + 1, N) and prew.dtype == torch.float32
  np.testing.assert_allclose(_np(prew), jrew, **TOL)
  with pnn.scope():
    assert pmod.train(_torch(traj)) == {}

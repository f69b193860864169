"""The port's Q critics (`QFunction`, `TwinQFunction`) against the JAX
package's, and the two configurations that the JAX package cannot train,
which must fail alike in the port.

The critics are held at the module level on a synthetic imagined
trajectory that carries `action`, under a config that satisfies their
asserts (`actor_grad_disc: backprop`, `action` among the actor's inputs):
no JAX test covers them, and no agent of either package reaches them (see
`test_qfunction_agent_fails_alike`). OneHot sampling returns the mode on
both sides, so the actor's sampled actions agree.

Tolerances as in `test_torch_expl.py`: outputs and metrics rtol 1e-4,
atol 1e-5; the state after one update (learning rate 1e-2) atol 1e-3.
"""

import collections

import numpy as np
import pytest
import torch

import daydreamer_tpu as ddt
import daydreamer_tpu_torch as ddp
from daydreamer_tpu import nn as jnn
from daydreamer_tpu.agents.dreamer import agent as jagent
from daydreamer_tpu.models import nets as jnets
from daydreamer_tpu_torch import nn as pnn
from daydreamer_tpu_torch.agents.dreamer import agent as pagent
from daydreamer_tpu_torch.models import nets as pnets

from test_torch_agent import _jax_run, env, make_batch, port_agent  # noqa: F401
from test_torch_expl import TOL, STATE_TOL, latents, mode_sampling  # noqa: F401

torch.set_num_threads(1)
H, N, A = 3, 6, 3
Space = collections.namedtuple('Space', 'shape discrete')

CRITIC = {
    'actor_grad_disc': 'backprop',
    'actor.inputs': ['deter', 'stoch', 'action'],
    'critic.inputs': ['deter', 'stoch', 'action'],
    'critic_opt.lr': 1e-2,
    'slow_target_update': 1, 'slow_target_fraction': 0.5}


def configs(**kw):
  from daydreamer_tpu.agents.dreamer import Agent as JAXAgent
  from daydreamer_tpu_torch.agents.dreamer import Agent as PortAgent
  out = []
  for lib, agent in ((ddt, JAXAgent), (ddp, PortAgent)):
    config = lib.Config(agent.configs['defaults']).update(
        agent.configs['debug'])
    out.append(config.update({**CRITIC, **kw}))
  return out


def trajectory(seed):
  traj = latents((H + 1, N), seed)
  rng = np.random.default_rng(seed + 100)
  traj['cont'] = (rng.uniform(0, 1, (H + 1, N)) > 0.2).astype(np.float32)
  traj['weight'] = np.cumprod(0.99 * traj['cont'], 0) / 0.99
  return traj


def rewfn(traj):
  return traj['deter'][1:].mean(-1)


def _np(tree):
  if isinstance(tree, dict):
    return {k: _np(v) for k, v in tree.items()}
  if isinstance(tree, (tuple, list)):
    return type(tree)(_np(v) for v in tree)
  if isinstance(tree, torch.Tensor):
    return tree.detach().numpy()
  return np.asarray(tree)


def score_train_score(critic, actor, traj):
  return (critic.score(traj, actor), critic.train(traj, actor),
          critic.score(traj, actor))


@pytest.mark.parametrize('pengs', [False, True])
@pytest.mark.parametrize('name', ['QFunction', 'TwinQFunction'])
def test_q_critic(name, pengs, mode_sampling):
  """score, one train step (one-step or Peng's Q(λ) targets from the slow
  target nets, the twin's minimum), the slow update, score again."""
  jconfig, pconfig = configs(pengs_qlambda=pengs)
  space = Space((A,), True)
  actor_kw = dict(jconfig.actor, inputs=['deter', 'stoch'], dist='onehot')
  jcritic = getattr(jagent, name)('agent/critic', rewfn, jconfig)
  pcritic = getattr(pagent, name)('agent/critic', rewfn, pconfig)
  jactor = jnets.MLP('agent/actor', space.shape, **actor_kw)
  pactor = pnets.MLP('agent/actor', space.shape, **actor_kw)
  traj = trajectory(3)
  call = lambda critic, actor, t: score_train_score(critic, actor, t)
  jfn = jnn.pure(lambda t: call(jcritic, jactor, t))
  _, state = jfn({}, 0, traj, create=True)
  ttraj = {k: torch.as_tensor(v) for k, v in traj.items()}
  with pnn.scope(create=True):
    call(pcritic, pactor, ttraj)
  pstate = {**pnn.state(pcritic), **pnn.state(pactor)}
  assert set(pstate) == set(state)
  rng = np.random.default_rng(1)
  trainable = {k for m in (pcritic, pactor)
               for k, _ in m.named_state(trainable=True)}
  state = {k: np.asarray(v) + (
      0.1 * rng.standard_normal(v.shape).astype(np.float32)
      if k in trainable else 0) for k, v in state.items()}
  for module in (pcritic, pactor):
    pnn.assign(module, pnn.from_jax_state(
        {k: v for k, v in state.items() if k in pnn.state(module)}, {}))
  (jscore, jmets, jscore2), jstate = jfn(state, 0, traj)
  with pnn.scope():
    pscore, pmets, pscore2 = _np(call(pcritic, pactor, ttraj))
  for got, want in zip(pscore + pscore2, jscore + jscore2):
    np.testing.assert_allclose(got, want, **TOL)
  assert set(pmets) == set(jmets)
  for key in jmets:
    np.testing.assert_allclose(pmets[key], jmets[key], **TOL, err_msg=key)
  pstate = {**pnn.state(pcritic), **pnn.state(pactor)}
  for key, value in jstate.items():
    np.testing.assert_allclose(_np(pstate[key]), value, **STATE_TOL,
                               err_msg=key)
  # Each slow target has a counter of its own and mixed in its net.
  nets = ['net'] if name == 'QFunction' else ['net1', 'net2']
  for net in nets:
    kernel = f'agent/critic/target_{net}/dense0/kernel'
    assert f'agent/critic/updates_target_{net}' in pstate
    assert not np.allclose(_np(pstate[kernel]), state[kernel])
  assert not np.allclose(pscore2[0], pscore[0])  # The update moved Q.


@pytest.mark.parametrize('name', ['QFunction', 'TwinQFunction'])
def test_q_critic_asserts(name):
  """Under the default config (`actor_grad_disc: reinforce`, no `action`
  among the actor's inputs) both packages refuse to build a Q critic."""
  from daydreamer_tpu.agents.dreamer import Agent as JAXAgent
  from daydreamer_tpu_torch.agents.dreamer import Agent as PortAgent
  for lib, agent, module in ((ddt, JAXAgent, jagent),
                             (ddp, PortAgent, pagent)):
    config = lib.Config(agent.configs['defaults']).update(
        agent.configs['debug'])
    with pytest.raises(AssertionError):
      getattr(module, name)('agent/critic', rewfn, config)


def _fails_alike(env, expect, **kw):
  """Both packages' agents on one train step raise `expect`."""
  with pytest.raises(expect) as jerr:
    _jax_run(env, **kw)
  with pytest.raises(expect) as perr:
    port_agent(env, **kw).train(make_batch(env, 4, 8))
  return str(jerr.value), str(perr.value)


@pytest.mark.parametrize('overrides, expect', [
    ({}, AssertionError),
    ({'actor_grad_disc': 'backprop',
      'actor.inputs': ['deter', 'stoch', 'action']}, KeyError),
], ids=['default', 'asserts_met'])
@pytest.mark.parametrize('critic_type', ['qfunction', 'qtwin'])
def test_qfunction_agent_fails_alike(env, critic_type, overrides, expect):
  """`critic_type: qfunction` (and `qtwin`) builds no agent that trains,
  in either package (reference behavior, ROADMAP queue 3). As the config
  file has it, the critic's first assert stops the build; with the
  overrides that its asserts ask for, the imagination's first policy call
  gets a latent without `action`."""
  kw = {'critic_type': critic_type, **overrides}
  jmsg, pmsg = _fails_alike(env, expect, **kw)
  if expect is KeyError:
    assert 'Cannot find keys {deter, stoch, action}' in jmsg
    assert 'Cannot find keys {deter, stoch, action}' in pmsg


def test_pbe_agent_fails_alike(env):
  """Explore with `expl_rewards.pbe > 0` cannot train, in either package
  (reference behavior, ROADMAP queue 3): PBE returns H + 1 rewards where
  the critic's λ-return takes H."""
  jmsg, pmsg = _fails_alike(
      env, AssertionError, expl_behavior='Explore',
      **{'expl_rewards.pbe': 1.0})
  assert 'Should provide rewards for all but last action' in jmsg
  assert 'Should provide rewards for all but last action' in pmsg

"""The port's agent against the JAX package's, on one train step.

Both agents start from the same state (the JAX agent's, carried across by
`load`) and train on the same batch. Sampling is made deterministic on
both sides for the test only: `OneHotDist.sample` returns the mode (with
the same straight-through gradient), and the port's fused rollout draws
zero Gumbel noise, which makes its samples the modes too. The JAX side runs
the loop rollout (`imag_impl: scan`); the port runs it both ways. With the
fused observe chain (`rssm.impl: pallas` on both sides) the JAX package's
kernels run in interpret mode with `sample=False`, set in the test only,
and the port's chain draws zero Gumbel noise.

Tolerances: losses rtol 1e-4 (float32 on both sides, summed in another
order). The state after the update atol 3e-4: Adam's first step moves each
weight by about lr = 1e-4 whatever the gradient's size, so a near-zero
gradient whose sign differs between the two sides can move a weight by up
to 2 lr.
"""

import jax
import numpy as np
import pytest
import torch

import daydreamer_tpu as ddt
import daydreamer_tpu_torch as ddp
from daydreamer_tpu import envs as jenvs
from daydreamer_tpu.nn import dists as jdists
from daydreamer_tpu_torch.nn import dists as pdists
from daydreamer_tpu.ops import pallas_rssm_vjp as jvjp
from daydreamer_tpu_torch.ops import rssm as pops
from daydreamer_tpu_torch.ops import rssm_vjp as pvjp

torch.set_num_threads(1)

OVERRIDES = {
    'batch_size': 4, 'replay_chunk': 8, 'imag_horizon': 3,
    'env.amount': 1, 'env.length': 10}


def jax_config(**kw):
  from daydreamer_tpu.agents.dreamer import Agent
  config = ddt.Config(Agent.configs['defaults'])
  config = config.update(Agent.configs['debug'])
  return config.update({'jax.platform': 'cpu', **OVERRIDES, **kw})


def port_config(**kw):
  from daydreamer_tpu_torch.agents.dreamer import Agent
  config = ddp.Config(Agent.configs['defaults'])
  config = config.update(Agent.configs['debug'])
  return config.update({'torch.device': 'cpu', **OVERRIDES, **kw})


def make_batch(env, B, T, seed=0):
  rng = np.random.default_rng(seed)
  data = {}
  for key, space in env.obs_space.items():
    if key.startswith('log_'):
      continue
    if space.dtype == np.uint8:
      data[key] = rng.integers(0, 256, (B, T) + space.shape, np.uint8)
    elif space.dtype == bool:
      data[key] = np.zeros((B, T) + space.shape, bool)
    else:
      data[key] = rng.standard_normal((B, T) + space.shape).astype(
          space.dtype)
  A = env.act_space['action'].shape[0]
  data['action'] = np.eye(A, dtype=np.float32)[rng.integers(0, A, (B, T))]
  data['reward'] = rng.uniform(0, 1, (B, T)).astype(np.float32)
  data['is_first'][:, 0] = True
  data['is_terminal'][1, -1] = True
  return data


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
  zeros = lambda shape, generator, device: torch.zeros(shape, device=device)
  monkeypatch.setattr(pops, 'gumbel', zeros)
  monkeypatch.setattr(pvjp, 'gumbel', zeros)


@pytest.fixture(scope='module')
def env():
  env = jenvs.load_env('dummy_discrete', amount=1, parallel='none',
                       length=10)
  yield env
  env.close()


def _jax_run(env, **kw):
  from daydreamer_tpu.agents.dreamer import Agent
  mp = pytest.MonkeyPatch()
  sg = jax.lax.stop_gradient
  mp.setattr(jdists.OneHotDist, 'sample',
             lambda self, key: sg(self.mode()) + self.probs - sg(self.probs))
  fused = jvjp.observe_fused
  mp.setattr(jvjp, 'observe_fused',
             lambda *a, **k: fused(*a, **{**k, 'sample': False}))
  try:
    agent = Agent(env.obs_space, env.act_space, ddt.Counter(),
                  jax_config(**kw))
    before = agent.save()
    data = make_batch(env, 4, 8)
    _, _, mets = agent.train(data)
    mets = dict(mets)
    after = agent.save()
  finally:
    mp.undo()
  return before, after, data, mets


@pytest.fixture(scope='module')
def jax_run(env):
  """The JAX agent's state before and after one train step, and its
  metrics (computed once for the module; sampling set to the modes)."""
  return _jax_run(env)


@pytest.fixture(scope='module')
def jax_run_fused(env):
  """The same with the fused observe chain (`rssm.impl: pallas`)."""
  return _jax_run(env, **{'rssm.impl': 'pallas'})


def port_agent(env, **kw):
  from daydreamer_tpu_torch.agents.dreamer import Agent
  return Agent(env.obs_space, env.act_space, ddp.Counter(), port_config(**kw))


@pytest.mark.parametrize('imag_impl', ['scan', 'pallas'])
def test_train_step_matches_jax(env, jax_run, mode_sampling, imag_impl):
  before, after, data, jmets = jax_run
  agent = port_agent(env, imag_impl=imag_impl)
  agent.load(before)
  if imag_impl == 'pallas':
    launches = pops.IMAGINE_ACTOR.launches
    calls = []
    plain = pops.imagine_actor_plain
    pops_fn = lambda *a, **k: calls.append(1) or plain(*a, **k)
    with pytest.MonkeyPatch.context() as mp:
      mp.setattr(pops, 'imagine_actor_plain', pops_fn)
      _, _, pmets = agent.train(data)
      pmets = dict(pmets)
    assert calls, 'The fused rollout did not run.'
    assert pops.IMAGINE_ACTOR.launches == launches  # CPU: no kernel.
  else:
    _, _, pmets = agent.train(data)
    pmets = dict(pmets)
  assert set(pmets) == set(jmets)
  for key in sorted(jmets):
    np.testing.assert_allclose(pmets[key], jmets[key], rtol=1e-4,
                               atol=1e-5, err_msg=key)
  state = agent.save()
  assert set(state) == set(after)
  for key, value in after.items():
    np.testing.assert_allclose(
        state[key], np.asarray(value), atol=3e-4, rtol=0, err_msg=key)


def test_train_step_matches_jax_fused_observe(env, jax_run_fused,
                                              mode_sampling):
  """One whole train step with `rssm.impl: pallas` on both sides: the
  port's fused observe chain (its plain forward and its plain adjoint
  chain here on the CPU) against the JAX package's kernels."""
  before, after, data, jmets = jax_run_fused
  agent = port_agent(env, **{'rssm.impl': 'pallas', 'imag_impl': 'pallas'})
  agent.load(before)
  kernels = (pops.IMAGINE_ACTOR, pvjp.OBSERVE_FWD, pvjp.OBSERVE_BWD)
  launches = [k.launches for k in kernels]
  calls = {'observe_fwd_plain': 0, 'observe_bwd_plain': 0}
  with pytest.MonkeyPatch.context() as mp:
    for name in calls:
      def counted(*a, _name=name, _fn=getattr(pvjp, name), **k):
        calls[_name] += 1
        return _fn(*a, **k)
      mp.setattr(pvjp, name, counted)
    _, _, pmets = agent.train(data)
    pmets = dict(pmets)
  assert calls['observe_fwd_plain'] and calls['observe_bwd_plain'], calls
  assert [k.launches for k in kernels] == launches  # CPU: no kernel.
  assert set(pmets) == set(jmets)
  for key in sorted(jmets):
    np.testing.assert_allclose(pmets[key], jmets[key], rtol=1e-4,
                               atol=1e-5, err_msg=key)
  state = agent.save()
  assert set(state) == set(after)
  for key, value in after.items():
    np.testing.assert_allclose(
        state[key], np.asarray(value), atol=3e-4, rtol=0, err_msg=key)


def test_save_load_round_trip(env, jax_run):
  """save() -> load() between the packages in the three forms of
  jaxagent.py:765-788: exact names, a strict subset, a name-sorted zip."""
  from daydreamer_tpu.agents.dreamer import Agent as JAXAgent
  before, after, _, _ = jax_run
  agent = port_agent(env)
  # Exact names, both ways.
  agent.load(after)
  saved = agent.save()
  assert set(saved) == set(after)
  for key in after:
    np.testing.assert_array_equal(saved[key], np.asarray(after[key]), key)
  jagent = JAXAgent(env.obs_space, env.act_space, ddt.Counter(),
                    jax_config())
  jagent.load(saved)
  for key, value in jagent.save().items():
    np.testing.assert_array_equal(np.asarray(value), saved[key], key)
  # A strict subset: the policy snapshot merges into the live state.
  agent.load(before)
  policy = jagent.save_policy()
  assert set(policy) < set(after)
  agent.load(policy)
  saved = agent.save()
  for key in after:
    expect = policy[key] if key in policy else before[key]
    np.testing.assert_array_equal(saved[key], np.asarray(expect), key)
  assert set(agent.save_policy()) == set(policy)
  # A name-sorted zip from other names.
  renamed = {f'old/{k}': np.asarray(v) for k, v in after.items()}
  agent.load(renamed)
  saved = agent.save()
  for key in after:
    np.testing.assert_array_equal(saved[key], np.asarray(after[key]), key)


def test_policy_steps(env):
  agent = port_agent(env)
  data = make_batch(env, 4, 8)
  obs = {k: v[:, 0] for k, v in data.items() if k != 'action'}
  for mode in ('train', 'eval', 'explore'):
    outs, state = agent.policy(obs, mode=mode)
    assert outs['action'].shape == (4, env.act_space['action'].shape[0])
    np.testing.assert_allclose(outs['action'].sum(-1), 1, atol=1e-6)
    outs, state = agent.policy(obs, state, mode=mode)
    assert np.isfinite(outs['action']).all()


def test_cuda_requested_without_card_raises(env):
  if torch.cuda.is_available():
    pytest.skip('A card is present.')
  with pytest.raises(RuntimeError):
    port_agent(env, **{'torch.device': 'cuda'})


def test_train_continuous_backprop():
  """Continuous actions train the actor by backprop through the learned
  dynamics (the rollout runs inside the actor's loss)."""
  env = jenvs.load_env('dummy_continuous', amount=1, parallel='none',
                       length=10)
  try:
    agent = port_agent(env)
    data = make_batch(env, 4, 8)
    data['action'] = np.random.default_rng(1).uniform(
        -1, 1, data['action'].shape).astype(np.float32)
    _, state, mets = agent.train(data)
    _, _, mets = agent.train(data, state)
    assert mets['actor_opt_grad_steps'] == 2
    assert mets['actor_opt_grad_norm'] > 0
    for key in ('model_opt_loss', 'actor_opt_loss', 'extr_critic_opt_loss'):
      assert np.isfinite(mets[key]), key
  finally:
    env.close()

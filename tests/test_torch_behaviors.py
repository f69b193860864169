"""The port's behaviors against the JAX package's, on one whole
`Agent.train` step, through the harness of `test_torch_agent.py`: both
agents start from the JAX agent's state (carried by `load`), train on the
same batch with sampling set to the modes, and every metric and the whole
updated state are compared. The port runs the fused rollout
(`imag_impl: pallas`, its plain version on the CPU) for every actor-critic
that admits it; the JAX side runs the loop.

- Explore with all four rewards that train (`extr`, `disag`, `vae`,
  `ctrl`) beside the Greedy task behavior, in one JAX build.
- DisagWhen (`expl_when_buffer` 16) as the task behavior: the achiever,
  the explorer on the ensemble's disagreement, and the buffer's merge.
- Random and KnownReward train and act on the port.

Tolerances as in `test_torch_agent.py`: losses rtol 1e-4, state atol 3e-4
(Adam's first step moves each weight by about lr = 1e-4 whatever the
gradient's size, so a near-zero gradient whose sign differs between the
two sides can move a weight by up to 2 lr).
"""

import numpy as np
import pytest
import torch

from daydreamer_tpu_torch.ops import rssm as pops

from test_torch_agent import (  # noqa: F401
    _jax_run, env, make_batch, mode_sampling, port_agent)

torch.set_num_threads(1)

EXPLORE = {
    'expl_behavior': 'Explore', 'disag_models': 2,
    'expl_rewards.extr': 1.0, 'expl_rewards.disag': 0.1,
    'expl_rewards.vae': 0.1, 'expl_rewards.ctrl': 0.1}
DISAG_WHEN = {
    'task_behavior': 'DisagWhen', 'disag_models': 2,
    'expl_when_buffer': 16}


def _matches_jax(env, kw, rollouts):
  """One train step of the port (fused rollout) against the JAX agent's
  (loop); `rollouts` fused rollouts must have run."""
  before, after, data, jmets = _jax_run(env, **kw)
  agent = port_agent(env, imag_impl='pallas', **kw)
  agent.load(before)
  calls = []
  plain = pops.imagine_actor_plain
  launches = pops.IMAGINE_ACTOR.launches
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(pops, 'imagine_actor_plain',
               lambda *a, **k: calls.append(1) or plain(*a, **k))
    _, _, pmets = agent.train(data)
    pmets = dict(pmets)
  assert len(calls) == rollouts, calls
  assert pops.IMAGINE_ACTOR.launches == launches  # CPU: no kernel.
  assert set(pmets) == set(jmets)
  for key in sorted(jmets):
    np.testing.assert_allclose(pmets[key], jmets[key], rtol=1e-4,
                               atol=1e-5, err_msg=key)
  state = agent.save()
  assert set(state) == set(after)
  for key, value in after.items():
    np.testing.assert_allclose(
        state[key], np.asarray(value), atol=3e-4, rtol=0, err_msg=key)
  return agent, data, pmets, state


def test_explore_train_step_matches_jax(env, mode_sampling):
  """plan2explore's Explore with extr + disag + vae + ctrl: the task
  behavior's and Explore's fused rollouts, three intrinsic reward
  modules' updates, four critics, Explore's actor."""
  agent, data, mets, state = _matches_jax(env, EXPLORE, rollouts=2)
  for key in ('expl_actor_opt_loss', 'expl_extr_critic_opt_loss',
              'expl_disag_critic_opt_loss', 'expl_vae_critic_opt_loss',
              'expl_ctrl_critic_opt_loss', 'expl_vae_kl', 'expl_opt_loss'):
    assert np.isfinite(mets[key]), key
  for name in ('reward_disag/head1', 'reward_vae/enc', 'reward_ctrl/embed',
               'reward_ctrl/disag/head0', 'critic_ctrl/target_net'):
    assert any(k.startswith(f'agent/expl_behavior/{name}/') for k in state)
  obs = {k: v[:, 0] for k, v in data.items() if k != 'action'}
  outs, pstate = agent.policy(obs, mode='explore')
  outs, _ = agent.policy(obs, pstate, mode='explore')
  np.testing.assert_allclose(outs['action'].sum(-1), 1, atol=1e-6)


def test_disag_when_train_step_matches_jax(env, mode_sampling):
  """DisagWhen: the ensemble's update, the explorer's and the achiever's
  fused rollouts and updates, and the buffer's stable top-k merge."""
  agent, data, mets, state = _matches_jax(env, DISAG_WHEN, rollouts=2)
  buffer = state['agent/task_behavior/buffer']
  disags = state['agent/task_behavior/disags']
  assert buffer.shape == (16, 64) and disags.shape == (16,)
  # Kept sorted by disagreement; the creation pass's 2 states and this
  # step's 4 fill the top rows, zeros the rest.
  assert (np.diff(disags) >= 0).all()
  assert (disags[:10] == 0).all() and (disags[10:] > 0).all()
  assert (buffer[:10] == 0).all() and (buffer[10:] != 0).any(-1).all()
  obs = {k: v[:, 0] for k, v in data.items() if k != 'action'}
  outs, pstate = agent.policy(obs)
  assert pstate[1]['counter'].tolist() == [1] * 4
  outs, pstate = agent.policy(obs, pstate)
  assert pstate[1]['counter'].tolist() == [2] * 4
  np.testing.assert_allclose(outs['action'].sum(-1), 1, atol=1e-6)


@pytest.mark.parametrize('behavior', ['Random', 'KnownReward'])
def test_other_behaviors_train_and_act(env, behavior):
  agent = port_agent(env, task_behavior=behavior)
  data = make_batch(env, 4, 8)
  _, state, mets = agent.train(data)
  _, _, mets = agent.train(data, state)
  assert np.isfinite(mets['model_loss_mean'])
  if behavior == 'KnownReward':
    # The known reward 'none' is zero everywhere.
    assert mets['manual_imag_reward_mean'] == 0
    assert mets['actor_opt_grad_steps'] == 2
  else:
    assert not any(k.startswith('actor_') for k in mets)
  obs = {k: v[:, 0] for k, v in data.items() if k != 'action'}
  for mode in ('train', 'eval', 'explore'):
    outs, pstate = agent.policy(obs, mode=mode)
    outs, _ = agent.policy(obs, pstate, mode=mode)
    assert outs['action'].shape == (4, env.act_space['action'].shape[0])
    np.testing.assert_allclose(outs['action'].sum(-1), 1, atol=1e-6)


def test_random_uniform_continuous():
  """Random's continuous policy: U(-1, 1) draws from the agent's
  generator, the mode zero, the entropy A log 2."""
  from daydreamer_tpu_torch import nn
  from daydreamer_tpu_torch.agents.dreamer import behaviors
  dist = behaviors._Uniform((5000, 3))
  generator = torch.Generator().manual_seed(0)
  with nn.scope(generator=generator):
    sample = dist.sample(generator)
    assert sample.min() >= -1 and sample.max() <= 1
    assert abs(float(sample.mean())) < 0.05
    assert (dist.mode() == 0).all()
    np.testing.assert_allclose(dist.entropy(), 3 * np.log(2.0))

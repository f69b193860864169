"""`torch.debug_nans` against the JAX package's `jax.debug_nans`.

Both agents start from the same state (the JAX agent's, carried across by
`load`) and train on the same small batch with one NaN injected into an
observation: with the key set, both raise FloatingPointError; with the key
off, the port raises nothing. On the batch without the NaN every metric of
the JAX update is finite, and the port with the key raises nothing.

`jax_debug_nans` is turned on (what the JAX key does) after the JAX agent's
creation pass and before its first jitted update, which is the NaN one:
JAX checks a jitted function on its first call only (later calls take its
C++ dispatch), and with the key set from the start the creation pass itself
raises (its zero batch has no positive reward, so `balance_stats` divides 0
by 0). The port checks every update and policy call but no creation pass,
and passes the balance diagnostics, which are NaN by design. The flag is
global to the process, so it is reset in a `finally`.
"""

import jax
import numpy as np
import pytest
import torch

import daydreamer_tpu as ddt
from daydreamer_tpu_torch.agents.dreamer import torchagent

from test_torch_agent import env, jax_config, make_batch, port_agent  # noqa: F401

torch.set_num_threads(1)


def nan_batch(env):
  data = make_batch(env, 4, 8)
  data['vector'][1, 3, 0] = np.nan
  return data


@pytest.fixture(scope='module')
def jax_agent(env):
  """The JAX agent's state before any update, what its first update (on
  the NaN batch, `jax_debug_nans` on) raised, and the metrics of an update
  on the clean batch from the same state."""
  from daydreamer_tpu.agents.dreamer import Agent
  agent = Agent(env.obs_space, env.act_space, ddt.Counter(), jax_config())
  state = agent.save()
  raised = None
  try:
    jax.config.update('jax_debug_nans', True)
    try:
      agent.train(nan_batch(env))
    except FloatingPointError as e:
      raised = str(e)
  finally:
    jax.config.update('jax_debug_nans', False)
  agent.load(state)
  _, _, mets = agent.train(make_batch(env, 4, 8))
  return state, raised, dict(mets)


def test_config_accepts_the_key():
  import daydreamer_tpu_torch as ddp
  from daydreamer_tpu_torch.agents.dreamer import Agent
  config = ddp.Config(Agent.configs['defaults'])
  assert config.torch.debug_nans is False
  config = ddp.Flags(config).parse(['--torch.debug_nans', 'True'])
  assert config.torch.debug_nans is True


def test_nan_raises_in_both(env, jax_agent):
  state, raised, jax_mets = jax_agent
  assert raised is not None and 'nan' in raised
  assert all(np.isfinite(v) for v in jax_mets.values())
  agent = port_agent(env, **{'torch.debug_nans': True})
  agent.load(state)
  _, _, mets = agent.train(make_batch(env, 4, 8))
  assert all(np.isfinite(v) for v in mets.values())
  agent.load(state)
  with pytest.raises(FloatingPointError, match='nan'):
    agent.train(nan_batch(env))


def test_nan_passes_without_the_key(env, jax_agent):
  state = jax_agent[0]
  agent = port_agent(env)
  agent.load(state)
  _, _, mets = agent.train(nan_batch(env))
  assert np.isnan(mets['model_loss_mean'])


def test_balance_diagnostics_pass(env, jax_agent):
  """A batch with no positive reward: `reward_pos_loss` is NaN by design,
  every loss is finite, and the port with the key raises nothing."""
  state = jax_agent[0]
  agent = port_agent(env, **{'torch.debug_nans': True})
  agent.load(state)
  data = make_batch(env, 4, 8)
  data['reward'][:] = 0
  _, _, mets = agent.train(data)
  assert np.isnan(mets['reward_pos_loss'])
  assert np.isfinite(mets['model_loss_mean'])


def test_train_multi_and_policy_raise(env, jax_agent):
  state = jax_agent[0]
  agent = port_agent(env, **{'torch.debug_nans': True})
  agent.load(state)
  with pytest.raises(FloatingPointError, match='in train'):
    agent.train_multi([make_batch(env, 4, 8), nan_batch(env)])
  agent.load(state)
  obs = {k: v[:, 0] for k, v in make_batch(env, 4, 8).items()
         if k != 'action'}
  outs, _ = agent.policy(obs)
  assert np.isfinite(outs['action']).all()
  obs['vector'][2, 0] = np.nan
  with pytest.raises(FloatingPointError, match='in policy'):
    agent.policy(obs)


def test_nan_paths_flag_nan_not_inf():
  trees = {'outs': {'a': torch.tensor([1.0, float('inf')]),
                    'b': torch.tensor([float('nan')])},
           'state': (torch.zeros(2), torch.tensor([-float('inf')]),
                     torch.tensor([1, 2])),
           'metrics': {'loss': 0.5}}
  assert torchagent._nan_paths(trees) == ['outs/b']
  assert torchagent._nan_paths({'x': [torch.ones(3)]}) == []

"""The rest of `torch.graphs` on the CPU: the agent's `report`, the PPO
learner's `act` and `update`, and several ranks with graphs on.

On the CPU there is no graph to capture, so the runner's bookkeeping (the
static buffers, the copies in and out, the keys) calls each function
eagerly; these tests hold what a capture on the card relies on, at the
sizes of `test_torch_graphs.py` (`debug`, `dummy_discrete`, batch 4 x
chunk 6) and `test_torch_imitation.py` (30 observations, 12 actions):
(a) `report` through the runner equals the eager `report` bit for bit
    (default agent, the fused observe chain, plan2explore), and its
    scalars match the JAX agent's `report` on the same state and batch
    (sampling set to the modes on both sides, as in `test_torch_agent.py`)
    within rtol 1e-4, atol 1e-5, the tolerance of the losses there;
(b) PPO's `act` and `update` through the runner equal the eager calls bit
    for bit (outputs, metrics, every state entry after two updates), and
    two graphed updates of one minibatch, where the permutation cannot
    change the result, match the JAX updates within rtol 1e-4, atol 1e-5
    (`test_torch_imitation.py`'s tolerance for a few Adam steps);
(c) nothing in the captured `report`, `act` or `update` syncs with the host
    (`test_torch_graphs.NoSync`);
(d) two gloo ranks with graphs on make the same updates, reports and
    policy steps as with graphs off, bit for bit, and equal states on
    both ranks, with no host sync in the captured functions, their
    reductions over the ranks included (this file's `__main__` is the rank
    entry);
(e) on a faked card with two ranks the agent refuses graphs under gloo
    and builds under NCCL.
"""

import json
import pathlib
import sys

import numpy as np
import pytest
import torch

import daydreamer_tpu_torch as ddp
from daydreamer_tpu_torch.agents.dreamer import graphs
from daydreamer_tpu_torch.envs import load_env
from daydreamer_tpu_torch.imitation import ppo as pppo
from daydreamer_tpu_torch.parallel import distributed

import test_torch_graphs as ttg

torch.set_num_threads(1)

OBS, ACT, N = 30, 12, 32  # test_torch_imitation.py's sizes.


@pytest.fixture(scope='module')
def env():
  env = load_env('dummy_discrete', amount=1, parallel='none', length=10)
  yield env
  env.close()


def assert_trees_equal(a, b):
  """Two {name: array} bit for bit, NaN equal to NaN."""
  assert set(a) == set(b)
  for key in a:
    x, y = np.asarray(a[key]), np.asarray(b[key])
    assert x.dtype == y.dtype and x.shape == y.shape, key
    assert np.array_equal(x, y, equal_nan=x.dtype.kind == 'f'), key


def agent_pair(env, configs=('debug',), **kw):
  """An eager and a graphed agent from one state and generator state."""
  agents = {flag: ttg.make_agent(env, configs, **{'torch.graphs': flag, **kw})
            for flag in (False, True)}
  for agent in agents.values():
    agent._create()
  ddp.nn.assign(agents[True].agent, ddp.nn.state(agents[False].agent))
  agents[True].generator.set_state(agents[False].generator.get_state())
  return agents


# ---------------------------------------------------------------------------
# (a) `report`.


@pytest.mark.parametrize('configs,kw', [
    (('debug',), {}),
    (('debug',), {'rssm.impl': 'pallas', 'imag_impl': 'pallas'}),
    (('debug', 'plan2explore'), {}),
], ids=['greedy', 'fused_observe', 'plan2explore'])
def test_report_graphed_equals_eager(env, configs, kw):
  agents = agent_pair(env, configs, **kw)
  reports = {flag: [agent.report(ttg.make_batch(env, seed=seed))
                    for seed in range(3)]
             for flag, agent in agents.items()}
  for eager, graphed in zip(reports[False], reports[True]):
    assert_trees_equal(eager, graphed)
    assert any(k.startswith('openl_') and v.ndim == 4
               for k, v in graphed.items())
  # Later calls drew other noise and saw other batches.
  assert reports[True][0]['model_loss_mean'] != reports[True][1][
      'model_loss_mean']
  (name, _, _), = agents[True].graphs.captured
  assert name == 'report' and not agents[False].graphs.captured
  assert_trees_equal(agents[False].save(), agents[True].save())


def test_report_matches_jax(env):
  import jax
  import daydreamer_tpu as ddt
  from daydreamer_tpu.agents.dreamer import Agent as JaxAgent
  import test_torch_agent as tta
  sg = jax.lax.stop_gradient
  data = tta.make_batch(env, 4, 8)
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(tta.jdists.OneHotDist, 'sample',
               lambda self, key: sg(self.mode()) + self.probs
               - sg(self.probs))
    mp.setattr(tta.pdists.OneHotDist, 'sample',
               lambda self, generator=None: (
                   self.mode() + self.probs - self.probs.detach()))
    mp.setattr(tta.ponehot, 'uniform', tta.zero_noise)
    jagent = JaxAgent(env.obs_space, env.act_space, ddt.Counter(),
                      tta.jax_config())
    want = jagent.report(data)
    pagent = tta.port_agent(env, **{'torch.graphs': True})
    pagent.load(jagent.save())
    got = pagent.report(data)
  assert pagent.graphs.captured
  scalars = sorted(k for k, v in want.items() if np.ndim(v) == 0)
  assert scalars == sorted(k for k, v in got.items() if not v.ndim)
  assert 'model_loss_mean' in scalars
  for key in scalars:
    np.testing.assert_allclose(got[key], np.asarray(want[key]), rtol=1e-4,
                               atol=1e-5, err_msg=key)


# ---------------------------------------------------------------------------
# (b) PPO's `act` and `update`.


def ppo_rollout(seed=3, n=N):
  rng = np.random.default_rng(seed)
  return dict(
      obs=rng.standard_normal((n, OBS)).astype(np.float32),
      action=rng.uniform(-1, 1, (n, ACT)).astype(np.float32),
      logp=rng.normal(-12, 1, n).astype(np.float32),
      adv=rng.standard_normal(n).astype(np.float32),
      ret=rng.standard_normal(n).astype(np.float32))


def drive_ppo(agent):
  """Batch-1 `act` calls, one at the rollout's rows, two updates of 2
  epochs x 4 minibatches and an `act` after them."""
  rollout = ppo_rollout()
  acts = [agent.act(rollout['obs'][i:i + 1]) for i in range(4)]
  acts.append(agent.act(rollout['obs']))
  mets = [agent.update(rollout), agent.update(ppo_rollout(seed=4))]
  acts.append(agent.act(rollout['obs'][:1]))
  return acts, mets


def test_ppo_graphed_equals_eager():
  results = {}
  for flag in (False, True):
    agent = pppo.PPOImitation(OBS, ACT, seed=1, epochs=2, device='cpu',
                              graphs=flag)
    results[flag] = (*drive_ppo(agent), agent.save())
    assert sorted(name for name, _, _ in agent.graphs.captured) == (
        ['act', 'act', 'update'] if flag else [])
  (eager_acts, eager_mets, eager_state), (acts, mets, state) = (
      results[False], results[True])
  for eager, graphed in zip(eager_acts, acts):
    for x, y in zip(eager, graphed):
      assert np.array_equal(x, y)
  assert eager_mets == mets
  assert mets[1]['ppo_opt_grad_steps'] == 16
  assert mets[0]['ppo_opt_loss'] != mets[1]['ppo_opt_loss']
  assert_trees_equal(eager_state, state)


def test_ppo_graphed_update_matches_jax():
  """Two updates of one epoch and one minibatch, the second through the
  runner's entry a replay would use; `test_torch_imitation.py`'s
  tolerance for a few Adam steps."""
  import test_torch_imitation as tti
  tol = dict(rtol=1e-4, atol=1e-5)
  jagent, pagent = tti._agents(epochs=1, minibatches=1)
  assert pagent._use_graphs  # Graphs are the default.
  for seed in (3, 4):
    batch = tti._rollout(seed=seed)
    jmets, pmets = jagent.update(batch), pagent.update(batch)
    assert set(pmets) == set(jmets)
    for key in jmets:
      np.testing.assert_allclose(pmets[key], jmets[key], err_msg=key, **tol)
  assert [name for name, _, _ in pagent.graphs.captured] == ['update']
  assert pmets['ppo_opt_grad_steps'] == 2
  jstate, pstate = jagent.save(), pagent.save()
  assert set(pstate) == set(jstate)
  for key in jstate:
    np.testing.assert_allclose(pstate[key], jstate[key], err_msg=key, **tol)


# ---------------------------------------------------------------------------
# (c) No host sync inside the captured functions.


def test_captured_functions_do_not_sync(env, monkeypatch):
  ran = []
  original = graphs.Captured.run

  def run(self):
    ran.append(self.name)
    with ttg.NoSync():
      return original(self)

  monkeypatch.setattr(graphs.Captured, 'run', run)
  for configs in (('debug',), ('debug', 'plan2explore')):
    agent = ttg.make_agent(env, configs)
    agent._create()
    agent.report(ttg.make_batch(env))
  drive_ppo(pppo.PPOImitation(OBS, ACT, seed=1, epochs=2, device='cpu'))
  assert sorted(set(ran)) == ['act', 'report', 'update']
  assert ran.count('report') == 2 and ran.count('update') == 2


# ---------------------------------------------------------------------------
# (d) Two gloo ranks with graphs on.


def test_two_gloo_ranks_graphed_equal_eager(tmp_path):
  import test_torch_multihost as ttm
  job = tmp_path / 'job.json'
  job.write_text(json.dumps({'address': (tmp_path / 'store').as_uri()}))
  ttm._spawn([[__file__, str(job), str(rank)] for rank in range(2)],
             tmp_path)
  ranks = [{flag: dict(np.load(tmp_path / f'rank{rank}_{flag}.npz'))
            for flag in ('eager', 'graphed')} for rank in range(2)]
  for rank in ranks:
    assert_trees_equal(rank['eager'], rank['graphed'])
    assert any(k.startswith('report:openl_') for k in rank['graphed'])
  # The replicas' states, the reduced metrics and report scalars; the
  # videos show each rank's own rows.
  shared = lambda arrays: {
      k: v for k, v in arrays.items() if k.startswith(('state:', 'mets:'))
      or k.startswith('report:') and not v.ndim}
  assert_trees_equal(shared(ranks[0]['graphed']),
                     shared(ranks[1]['graphed']))


def _rank_main(job, rank):
  """One rank: an eager and a graphed agent, each two updates (the second
  with a carry, so through the runner), a report and two policy steps on
  this rank's rows; writes each arm's results to `rank<r>_<arm>.npz`."""
  from daydreamer_tpu_torch.parallel import mesh as meshlib
  job = pathlib.Path(job)
  spec = json.loads(job.read_text())
  distributed.initialize(spec['address'], 2, rank, 'gloo')
  # The reductions over the ranks inside a captured function sync with
  # the host nowhere either.
  original = graphs.Captured.run

  def run(self):
    with ttg.NoSync():
      return original(self)

  graphs.Captured.run = run
  env = load_env('dummy_discrete', amount=1, parallel='none', length=10)
  try:
    for flag, arm in ((False, 'eager'), (True, 'graphed')):
      agent = ttg.make_agent(env, **{'torch.graphs': flag})
      local = lambda seed: meshlib.shard_batch(
          ttg.make_batch(env, seed=seed), agent.mesh)
      _, carry, _ = agent.train(local(0))
      _, carry, mets = agent.train(local(1), carry)
      report = agent.report(local(2))
      obs = ttg.observation(env)
      outs, state = agent.policy(obs)
      outs, _ = agent.policy(ttg.observation(env, seed=1), state)
      assert bool(agent.graphs.captured) == flag
      np.savez(job.parent / f'rank{rank}_{arm}.npz',
               **{f'state:{k}': v for k, v in agent.save().items()},
               **{f'mets:{k}': np.asarray(v) for k, v in dict(mets).items()},
               **{f'report:{k}': v for k, v in report.items()},
               **{f'carry:{k}': v.numpy() for k, v in carry.items()},
               **{f'policy:{k}': v for k, v in outs.items()})
  finally:
    env.close()
  torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# (e) Several ranks on a faked card.


@pytest.mark.parametrize('backend', ['gloo', 'nccl'])
def test_ranks_on_the_card_need_nccl_for_graphs(env, backend, monkeypatch):
  """World 2 on a `cuda` device (faked: a CPU generator stands in for the
  card's): graphs on raise under gloo, whose collectives a CUDA graph
  cannot capture, and the agent builds under NCCL; graphs off build under
  either."""
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
  monkeypatch.setattr(distributed, 'world_size', lambda: 2)
  monkeypatch.setattr(torch.distributed, 'get_backend',
                      lambda group=None: backend)
  generator = torch.Generator
  monkeypatch.setattr(torch, 'Generator',
                      lambda device='cpu': generator(device='cpu'))
  cuda = {'torch.device': 'cuda'}
  eager = ttg.make_agent(env, **cuda, **{'torch.graphs': False})
  assert eager.device.type == 'cuda' and not eager._use_graphs
  if backend == 'gloo':
    with pytest.raises(ValueError, match='over gloo'):
      ttg.make_agent(env, **cuda)
  else:
    agent = ttg.make_agent(env, **cuda)
    assert agent._use_graphs and agent.graphs.device.type == 'cuda'


if __name__ == '__main__':
  torch.set_num_threads(1)
  _rank_main(sys.argv[1], int(sys.argv[2]))

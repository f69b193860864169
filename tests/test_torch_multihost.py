"""The port's data-parallel update as two gloo ranks on the CPU, against
the JAX package's sharded update (the counterpart of `test_multihost.py`,
which runs the JAX worker and is marked slow; these run in tier 1).

Each case starts both ranks from the JAX agent's state (carried across by
`load` through an `.npz`), gives each its half of the B = 4 batch of
`test_torch_agent.py` (`shard_batch` over the agent's mesh) and makes one
update. The JAX agent makes the same update on the whole batch, on a mesh
of 4 virtual CPU devices (`conftest.py`). Sampling is set to the modes on
both sides, as in `test_torch_agent.py`; the ranks apply the port's side
of those patches in this file's rank entry (`python
tests/test_torch_multihost.py JOB RANK`).

Checks: the two ranks' whole states after the update are equal and so are
their metrics and their report's scalars, bit for bit; rank 0's metrics and state match the JAX
agent's within the tolerances of `test_torch_agent.py` (losses rtol 1e-4,
state atol 3e-4). The cases exercise the gradient average and the
controllers' statistics (the default agent), the importance weights'
maximum (`priority_correct` with a `prob` key), and DisagWhen's buffer
merge. The port's `multihost_worker --tiny` runs as two processes too.
"""

import json
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from daydreamer_tpu_torch.parallel import distributed

ROOT = pathlib.Path(__file__).resolve().parent.parent
TIMEOUT = 300  # Seconds, for each rank process.

CASES = {
    'default': {},
    'priority_correct': {'priority_correct': 1.0},
    # The DisagWhen setting of test_torch_behaviors.py.
    'disag_when': {'task_behavior': 'DisagWhen', 'disag_models': 2,
                   'expl_when_buffer': 16},
}


def _spawn(args, tmp_path):
  """Start one process per argument list (one thread each, at nice 10 so
  that the suite's other workers keep their cores) and wait for all;
  returns their outputs. Fails on a nonzero exit or the timeout."""
  env = dict(os.environ, OMP_NUM_THREADS='1',
             PYTHONPATH=os.pathsep.join(
                 [str(ROOT), os.environ.get('PYTHONPATH', '')]))
  procs = [subprocess.Popen(
      ['nice', '-n', '10', sys.executable, *a], cwd=tmp_path, env=env,
      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
      for a in args]
  outs = []
  try:
    for proc in procs:
      out, _ = proc.communicate(timeout=TIMEOUT)
      outs.append(out)
      assert proc.returncode == 0, out[-4000:]
  finally:
    for proc in procs:
      if proc.poll() is None:
        proc.kill()
        proc.wait()
  return outs


@pytest.fixture(scope='module')
def jax_side():
  """The JAX half of the harness (imported here so that the rank
  processes, which run this file, import no JAX)."""
  import test_torch_agent
  env = test_torch_agent.jenvs.load_env(
      'dummy_discrete', amount=1, parallel='none', length=10)
  yield test_torch_agent, env
  env.close()


def _jax_update(tta, env, data, **kw):
  """The JAX agent's state before and after one update on `data`, and its
  metrics, with the sampling patches of `test_torch_agent._jax_run`."""
  import jax
  import daydreamer_tpu as ddt
  from daydreamer_tpu.agents.dreamer import Agent
  sg = jax.lax.stop_gradient
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(tta.jdists.OneHotDist, 'sample',
               lambda self, key: sg(self.mode()) + self.probs
               - sg(self.probs))
    mp.setattr(tta.jdists.Normal, 'sample', lambda self, key: self._mean)
    agent = Agent(env.obs_space, env.act_space, ddt.Counter(),
                  tta.jax_config(**kw))
    assert agent.mesh.devices.size == 4, agent.mesh
    before = agent.save()
    _, _, mets = agent.train(data)
    mets = dict(mets)
    after = agent.save()
  return before, after, mets


@pytest.mark.parametrize('case', list(CASES))
def test_two_ranks_match_jax(jax_side, case, tmp_path):
  tta, env = jax_side
  kw = CASES[case]
  data = tta.make_batch(env, 4, 8)
  if 'priority_correct' in kw:
    data['prob'] = np.random.default_rng(1).uniform(
        0.05, 1.0, (4, 8)).astype(np.float32)
  before, after, jmets = _jax_update(tta, env, data, **kw)
  np.savez(tmp_path / 'inputs.npz',
           **{f'state:{k}': np.asarray(v) for k, v in before.items()},
           **{f'data:{k}': v for k, v in data.items()})
  job = tmp_path / 'job.json'
  job.write_text(json.dumps({
      'address': (tmp_path / 'store').as_uri(),
      'config': {'torch.device': 'cpu', 'torch.precision': 'float32',
                 **tta.OVERRIDES, **kw}}))
  _spawn([[__file__, str(job), str(rank)] for rank in range(2)], tmp_path)
  ranks = [dict(np.load(tmp_path / f'rank{rank}.npz')) for rank in range(2)]
  for key, value in ranks[0].items():
    # NaN only where the JAX agent's metric is NaN too (checked below).
    assert np.array_equal(value, ranks[1][key], equal_nan=True), key
  # The report's scalars are reduced over the ranks too.
  assert any(k.startswith('report:') for k in ranks[0]), list(ranks[0])
  state = {k[6:]: v for k, v in ranks[0].items() if k.startswith('state:')}
  mets = {k[5:]: v for k, v in ranks[0].items() if k.startswith('mets:')}
  assert set(mets) == set(jmets)
  for key in sorted(jmets):
    np.testing.assert_allclose(mets[key], jmets[key], rtol=1e-4, atol=1e-5,
                               err_msg=key)
  assert set(state) == set(after)
  for key, value in after.items():
    np.testing.assert_allclose(state[key], np.asarray(value), atol=3e-4,
                               rtol=0, err_msg=key)
  if case == 'disag_when':
    key = 'agent/task_behavior/disags'
    assert not np.array_equal(state[key], before[key]), key


def test_worker_two_processes(tmp_path):
  """The port's multihost_worker, `--tiny` on the CPU, as two gloo ranks:
  both print the same loss and the same state checksum."""
  address = (tmp_path / 'store').as_uri()
  module = str(ROOT / 'daydreamer_tpu_torch' / 'scripts' /
               'multihost_worker.py')
  outs = _spawn([[module, address, '2', str(rank), '--tiny', '--device',
                  'cpu', '--steps', '2'] for rank in range(2)], tmp_path)
  results = {}
  for out in outs:
    line, = [x for x in out.splitlines() if x.startswith('RESULT ')]
    _, rank, loss, rate, checksum = line.split()
    results[int(rank)] = (float(loss), float(rate), checksum)
  assert set(results) == {0, 1}, results
  assert results[0][0] == results[1][0], results
  assert results[0][2] == results[1][2], results
  assert np.isfinite(results[0][0]) and results[0][1] > 0, results


def test_world_must_divide_batch(jax_side, monkeypatch):
  """A world that does not divide batch_size raises; the JAX agent drops
  devices until the count divides, a rank cannot be dropped."""
  tta, env = jax_side
  monkeypatch.setattr(distributed, 'world_size', lambda: 3)
  with pytest.raises(ValueError, match='does not split over 3 ranks'):
    tta.port_agent(env)


def _rank_main(job, rank):
  """One rank of a case: the port's side of the sampling patches, the
  group, the JAX agent's state, this rank's rows, one update; writes its
  state and metrics to `rank<r>.npz` beside the job."""
  torch.set_num_threads(1)
  import daydreamer_tpu_torch as ddp
  from daydreamer_tpu_torch import envs
  from daydreamer_tpu_torch.agents.dreamer import Agent
  from daydreamer_tpu_torch.nn import dists
  from daydreamer_tpu_torch.ops import onehot, rssm, rssm_vjp
  from daydreamer_tpu_torch.parallel import mesh as meshlib
  dists.OneHotDist.sample = lambda self, generator=None: (
      self.mode() + self.probs - self.probs.detach())
  dists.Normal.sample = lambda self, generator=None: self._mean
  zeros = lambda shape, generator, device: torch.zeros(shape, device=device)
  rssm.gumbel = rssm_vjp.gumbel = zeros
  # Uniform draws of e^-1: the RSSM step's head samples with zero noise.
  onehot.uniform = lambda shape, generator, device: torch.full(
      shape, math.exp(-1), device=device)
  job = pathlib.Path(job)
  spec = json.loads(job.read_text())
  distributed.initialize(spec['address'], 2, rank, 'gloo')
  config = ddp.Config(Agent.configs['defaults']).update(
      Agent.configs['debug']).update(spec['config'])
  env = envs.load_env('dummy_discrete', amount=1, parallel='none',
                      length=10)
  agent = Agent(env.obs_space, env.act_space, ddp.Counter(), config)
  env.close()
  inputs = np.load(job.parent / 'inputs.npz')
  agent.load({k[6:]: inputs[k] for k in inputs if k.startswith('state:')})
  data = meshlib.shard_batch(
      {k[5:]: inputs[k] for k in inputs if k.startswith('data:')},
      agent.mesh)
  assert len(data['is_first']) == 2
  _, _, mets = agent.train(data)
  report = {k: v for k, v in agent.report(data).items() if not v.ndim}
  np.savez(job.parent / f'rank{rank}.npz',
           **{f'state:{k}': v for k, v in agent.save().items()},
           **{f'mets:{k}': np.asarray(v) for k, v in dict(mets).items()},
           **{f'report:{k}': v for k, v in report.items()})
  torch.distributed.destroy_process_group()


if __name__ == '__main__':
  _rank_main(sys.argv[1], int(sys.argv[2]))

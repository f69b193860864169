"""The port's run scripts on the CPU: `scripts/scores.py` against the
repository's own copy on a synthetic `metrics.jsonl`, and
`scripts/async_soak.py` as the two-process pair (the learner asked onto
the CPU, the actor on its default MuJoCo `a1_sim`) at the small nets, with
the cadences cut so that the learner trains and logs twice within the
soak. The curve scripts are in tests/test_torch_curves.py."""

import argparse
import importlib.util
import json
import pathlib

import numpy as np
import torch

from daydreamer_tpu_torch.scripts import async_soak
from daydreamer_tpu_torch.scripts import scores as port_scores

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def root_scores():
  spec = importlib.util.spec_from_file_location(
      'root_scores', ROOT / 'scripts' / 'scores.py')
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


def synthetic_logdir(path, seed=0):
  """A `metrics.jsonl` with episode rows among other rows, a torn last
  line, and steps that the logger multiplied by a repeat of 5."""
  rng = np.random.default_rng(seed)
  path.mkdir()
  lines = []
  for i in range(57):
    lines.append(json.dumps({'step': 5 * 37 * (i + 1),
                             'train/model_loss_mean': float(rng.normal())}))
    if rng.uniform() < 0.8:
      lines.append(json.dumps({'step': 5 * (37 * (i + 1) + 3),
                               'episode/score': float(rng.normal(10, 4)),
                               'episode/length': 37.0}))
  lines.append('{"step": 9999, "episode/sc')
  (path / 'metrics.jsonl').write_text('\n'.join(lines) + '\n')
  return path


def test_scores_export_matches_root(tmp_path):
  logdir = synthetic_logdir(tmp_path / 'run')
  outs = {}
  for name, module in (('root', root_scores()), ('port', port_scores)):
    outs[name] = tmp_path / f'{name}.json'
    module.cmd_export(argparse.Namespace(
        logdir=[str(logdir)], task='xarm_pickplace_dummy',
        method='dreamer_torch', out=str(outs[name]), xdiv=5, ydiv=2))
  root, port = (json.loads(outs[k].read_text()) for k in ('root', 'port'))
  assert port == root
  assert set(port[0]) == {'task', 'method', 'seed', 'xs', 'ys'}
  assert len(port[0]['xs']) > 30
  ys = port[0]['ys']
  assert port_scores.final_mean(ys) == root_scores().final_mean(ys)
  assert port_scores.final_mean(ys, 0.25) == root_scores().final_mean(ys, 0.25)
  assert np.isnan(port_scores.final_mean([]))


def test_scores_main_export(tmp_path):
  logdir = synthetic_logdir(tmp_path / 'run', seed=1)
  out = tmp_path / 'sub' / 'curve.json'
  port_scores.main(['export', '--logdir', str(logdir), '--task', 't',
                    '--out', str(out)])
  run, = json.loads(out.read_text())
  assert run['method'] == 'dreamer_tpu' and run['seed'] == '0'


def test_provenance_bins():
  from daydreamer_tpu_torch.scripts import provenance
  run = {'xs': [100, 900, 1100, 3500], 'ys': [0.0, 2.0, 5.0, 7.0]}
  assert provenance.bins(run, 1000) == [1.0, 5.0, None, 7.0]
  assert provenance.bins({'xs': [], 'ys': []}) == []


def snapshot(*paths):
  """Sizes and times of `paths` and of every file under them."""
  out = {}
  for path in paths:
    for p in [path, *(path.rglob('*') if path.is_dir() else [])]:
      if p.exists():
        out[p] = (p.stat().st_size, p.stat().st_mtime_ns)
  return out


def test_async_soak_pair_on_cpu(tmp_path, monkeypatch):
  monkeypatch.setenv('OMP_NUM_THREADS', '1')
  monkeypatch.chdir(tmp_path)
  # The script's default outputs, and the scores (other tests may write
  # elsewhere in the repository at the same time).
  watched = (ROOT / 'ASYNC_SOAK_TORCH.json', ROOT / 'ASYNC_SOAK.json',
             ROOT / 'runs' / 'async_soak_torch', ROOT / 'scores')
  before = snapshot(*watched)
  out = tmp_path / 'soak.json'
  result = async_soak.main([
      '--small', '--learner-device', 'cpu', '--minutes', '0.75',
      '--logdir', str(tmp_path / 'logdir'), '--out', str(out),
      '--train.train_fill', '50', '--train.sync_every', '5',
      '--train.train_fused', '2'])
  assert json.loads(out.read_text()) == result
  gates, summary = result['gates'], result['summary']
  logs = {name: (tmp_path / 'logdir' / f'{name}.log').read_text()[-3000:]
          for name in ('learner', 'actor')}
  assert gates['replay_grew'], (summary, logs)
  assert gates['learner_trained'], (summary, logs)
  assert gates['clean_shutdown'], (summary, logs)
  reference = json.loads((ROOT / 'ASYNC_SOAK.json').read_text())
  assert set(summary) == set(reference['summary'])
  assert set(summary['agent_cp_age_s']) == set(
      reference['summary']['agent_cp_age_s'])
  assert set(gates) == set(reference['gates'])
  assert result['passed'] == all(gates.values())
  assert summary['sync_every_s'] == 5
  assert result['learner_device'] == 'cpu'
  assert result['actor_task'] == 'a1_sim'
  assert result['extra_args'][:2] == ['--train.train_fill', '50']
  # The learner's launches at its end: its updates, and no kernel launch,
  # since on the CPU every wrapper runs its plain version.
  launches = result['learner_launches']
  assert launches['updates'] > 0, logs
  names = set(launches) - {'updates'}
  assert {'observe_fwd', 'observe_bwd'} <= names, launches
  assert not any(launches[name] for name in names), launches
  assert snapshot(*watched) == before
  config = (tmp_path / 'logdir' / 'config.yaml').read_text()
  assert 'device: cpu' in config

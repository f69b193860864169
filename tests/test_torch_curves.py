"""The port's curve scripts on the CPU, in this process, at the small nets
and a few hundred steps, into a scores directory under `tmp_path`:
`train_a1_curve.py` (MuJoCo a1_sim) and `train_dmc_curve.py` (dm_control
walker_walk) export a curve with the JAX package's keys and write their
provenance, RUN.json recording the overrides; no file of the repository's
`scores/` changes. `train_short_a1.py` trains 45 updates on a1_sim, over
the file's time budget on this CPU, so it is marked slow."""

import json
import pathlib

import numpy as np
import pytest
import torch

from daydreamer_tpu_torch.scripts import (
    train_a1_curve, train_dmc_curve, train_short_a1)

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent

SMALL = [
    '--torch.device', 'cpu', '--torch.precision', 'float32',
    '--batch_size', '4', '--replay_chunk', '8', '--imag_horizon', '3',
    '--rssm.deter', '32', '--rssm.units', '32', '--rssm.stoch', '4',
    '--rssm.classes', '4', r'--.*\.layers', '1', r'--.*\.units', '32',
    '--encoder.mlp_layers', '1', '--encoder.mlp_units', '32',
    '--decoder.mlp_layers', '1', '--decoder.mlp_units', '32']


def tree(path):
  return {p: (p.stat().st_size, p.stat().st_mtime_ns)
          for p in sorted(path.rglob('*'))}


@pytest.fixture
def repo_scores_unchanged(monkeypatch):
  monkeypatch.setenv('OMP_NUM_THREADS', '1')
  before = tree(ROOT / 'scores')
  yield
  assert tree(ROOT / 'scores') == before


def check_curve(out, prov, task, extra):
  reference = json.loads((ROOT / 'scores' / 'a1_dreamer_tpu.json').read_text())
  run, = json.loads(out.read_text())
  assert set(run) == set(reference[0]) == {'task', 'method', 'seed', 'xs',
                                           'ys'}
  assert (run['task'], run['method'], run['seed']) == (
      task, 'dreamer_torch', '0')
  assert len(run['xs']) == len(run['ys']) >= 2
  assert np.isfinite(run['ys']).all()
  assert sorted(p.name for p in prov.iterdir()) == [
      'RUN.json', 'config.yaml', 'metrics.jsonl', 'scores.jsonl']
  record = json.loads((prov / 'RUN.json').read_text())
  assert record['extra_overrides'] == extra
  assert record['argv'][-len(extra):] == extra
  assert record['device'] == 'cpu' and record['card'] is None
  assert record['duration_s'] >= 0
  return run, record


def test_a1_curve(tmp_path, repo_scores_unchanged):
  extra = [*SMALL, '--env.length', '50', '--train.train_fill', '100',
           '--train.train_every', '25', '--train.log_every', '100',
           '--train.eval_every', '100']
  scores = tmp_path / 'scores'
  train_a1_curve.main(['--seed', '0', '--steps', '250', '--logdir',
                       str(tmp_path / 'run'), '--scores', str(scores),
                       *extra])
  run, record = check_curve(
      scores / 'a1_dreamer_torch.json',
      scores / 'provenance' / 'a1_torch_seed0', 'a1_walk', extra)
  assert record['script'] == 'daydreamer_tpu_torch/scripts/train_a1_curve.py'
  # Env steps (the logger's repeat of 50 undone): 51 per episode of 50.
  assert run['xs'][:2] == [51, 102]
  assert '--torch.policy_devices' in record['argv']


def test_dmc_curve(tmp_path, repo_scores_unchanged):
  extra = [*SMALL, '--train.train_fill', '100', '--train.train_every',
           '200', '--train.log_every', '500', '--train.eval_every', '500']
  scores = tmp_path / 'scores'
  train_dmc_curve.main(['--seed', '0', '--steps', '1100', '--logdir',
                        str(tmp_path / 'run'), '--scores', str(scores),
                        *extra])
  _, record = check_curve(
      scores / 'dmc_walker_walk_torch.json',
      scores / 'provenance' / 'dmc_walker_walk_torch_seed0',
      'dmc_walker_walk', extra)
  assert 'DreamerV2' in record['external_anchor']


@pytest.mark.slow
def test_short_a1_learns(repo_scores_unchanged):
  losses, scores = train_short_a1.main(['--torch.device', 'cpu'])
  assert len(losses) >= 2 and losses[-1] < losses[0]
  assert scores and np.isfinite(scores).all()

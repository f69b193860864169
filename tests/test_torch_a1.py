"""The paper's A1 config through the port's CLI on the CPU: `--configs a1
--task a1_dummy` at the debug widths (two layers, 64 units), a few
updates, every logged loss finite; once as the config file has it (the
loop-path observe), once through the native batcher (`--data_loader
native`) and once with the fused observe chain (`--rssm.impl pallas`, its
plain versions on the CPU)."""

import json

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _run_a1(tmp_path, *extra):
  from daydreamer_tpu_torch.agents.dreamer import train
  train.main([
      '--configs', 'a1', 'debug', '--task', 'a1_dummy', '--run', 'train',
      '--torch.device', 'cpu', '--logdir', str(tmp_path),
      '--env.amount', '1', '--env.length', '50', '--train.train_fill', '60',
      '--train.steps', '200', '--train.log_every', '60',
      '--train.eval_every', '1000', *extra])
  rows = [json.loads(line) for line in
          (tmp_path / 'metrics.jsonl').read_text().splitlines()]
  losses = [(k, v) for row in rows for k, v in row.items()
            if k.startswith('train/')
            and k.endswith(('_opt_loss', '_loss_mean'))]
  assert {'train/model_opt_loss', 'train/actor_opt_loss',
          'train/extr_critic_opt_loss'} <= {k for k, _ in losses}
  assert all(np.isfinite(v) for _, v in losses), losses
  # The proprio vector is decoded; the image is neither encoded nor decoded.
  keys = {k for row in rows for k in row}
  assert 'train/vector_loss_mean' in keys
  assert not any(k.startswith('train/image') for k in keys)
  assert (tmp_path / 'checkpoint.pkl').exists()
  return rows


@pytest.fixture
def datasets(monkeypatch):
  """The loaders that `TorchAgent.dataset` returns during the run."""
  from daydreamer_tpu_torch.agents.dreamer import torchagent
  made = []
  inner = torchagent.TorchAgent.dataset
  monkeypatch.setattr(torchagent.TorchAgent, 'dataset',
                      lambda self, gen: made.append(inner(self, gen)) or
                      made[-1])
  return made


def test_a1_run_train(tmp_path, datasets):
  from daydreamer_tpu_torch.core import Prefetch
  _run_a1(tmp_path)
  assert datasets and all(isinstance(d, Prefetch) for d in datasets)


def test_a1_run_train_native_batcher(tmp_path, datasets):
  from daydreamer_tpu_torch.replay import batcher
  _run_a1(tmp_path, '--data_loader', 'native')
  assert datasets
  assert all(isinstance(d, batcher.NativeBatcher) for d in datasets)
  assert all(d._lib is not None for d in datasets)


def test_a1_run_train_fused_observe(tmp_path):
  from daydreamer_tpu_torch.ops import rssm_vjp
  calls = []
  with pytest.MonkeyPatch.context() as mp:
    plain = rssm_vjp.observe_bwd_plain
    mp.setattr(rssm_vjp, 'observe_bwd_plain',
               lambda *a, **k: calls.append(1) or plain(*a, **k))
    _run_a1(tmp_path, '--rssm.impl', 'pallas')
  assert len(calls) >= 3, 'The fused observe chain took no update.'

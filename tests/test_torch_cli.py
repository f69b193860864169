"""The port's CLI end to end on the CPU: `run=train` on dummy_discrete at
the debug widths, with every logged loss finite, on the loop-path observe
and on the fused observe chain (`--rssm.impl pallas`)."""

import json

import numpy as np
import pytest
import torch

torch.set_num_threads(1)


def _run_train(tmp_path, *extra):
  from daydreamer_tpu_torch.agents.dreamer import train
  train.main([
      '--configs', 'debug', '--task', 'dummy_discrete', '--run', 'train',
      '--torch.device', 'cpu', '--logdir', str(tmp_path),
      '--env.length', '50', '--train.train_fill', '60',
      '--train.steps', '200', '--train.log_every', '60',
      '--train.eval_every', '1000', *extra])
  rows = [json.loads(line) for line in
          (tmp_path / 'metrics.jsonl').read_text().splitlines()]
  # The training losses; balance diagnostics such as `reward_neg_loss` are
  # NaN by design when a batch holds no example of a class.
  losses = [(k, v) for row in rows for k, v in row.items()
            if k.startswith('train/')
            and k.endswith(('_opt_loss', '_loss_mean'))]
  assert {'train/model_opt_loss', 'train/actor_opt_loss',
          'train/extr_critic_opt_loss'} <= {k for k, _ in losses}
  assert all(np.isfinite(v) for _, v in losses), losses
  assert (tmp_path / 'checkpoint.pkl').exists()


def test_cli_run_train(tmp_path):
  _run_train(tmp_path)


def test_cli_run_train_fused_observe(tmp_path):
  from daydreamer_tpu_torch.ops import rssm_vjp
  calls = []
  with pytest.MonkeyPatch.context() as mp:
    plain = rssm_vjp.observe_bwd_plain
    mp.setattr(rssm_vjp, 'observe_bwd_plain',
               lambda *a, **k: calls.append(1) or plain(*a, **k))
    _run_train(tmp_path, '--rssm.impl', 'pallas')
  assert len(calls) >= 3, 'The fused observe chain took no update.'

"""Short a1_sim training smoke run of the port (real MuJoCo physics, tiny
nets; the counterpart of the repository's `scripts/train_short_a1.py`).

Verifies the full pipeline learns on the flagship robot task: world-model
losses must decrease and episodes must collect reward. The learner runs on
the card; any argument is passed on to the CLI after the pinned ones, so
`--torch.device cpu` runs it on the CPU. Returns the logged model losses
and episode scores.

Usage: python -m daydreamer_tpu_torch.scripts.train_short_a1 \\
    [--torch.device cpu] [OVERRIDES...]
"""

import json
import pathlib
import sys
import tempfile
import time


def main(argv=None):
  extra = list(sys.argv[1:] if argv is None else argv)
  from daydreamer_tpu_torch.agents.dreamer.train import main as train_main
  with tempfile.TemporaryDirectory() as logdir:
    flags = {
        'logdir': logdir, 'run': 'train', 'configs': 'a1',
        'task': 'a1_sim',
        'torch.precision': 'float32',
        'batch_size': 8, 'replay_chunk': 12, 'imag_horizon': 5,
        'rssm.deter': 64, 'rssm.units': 64, 'rssm.stoch': 8,
        'rssm.classes': 8, 'rssm.unroll': 1, 'imag_unroll': 1,
        'encoder.mlp_layers': 2, 'encoder.mlp_units': 64,
        'decoder.mlp_layers': 2, 'decoder.mlp_units': 64,
        'reward_head.layers': 2, 'reward_head.units': 64,
        'cont_head.layers': 2, 'cont_head.units': 64,
        'actor.layers': 2, 'actor.units': 64,
        'critic.layers': 2, 'critic.units': 64,
        'env.repeat': 10, 'env.length': 50, 'env.parallel': 'process',
        'train.steps': 600, 'train.train_fill': 150,
        'train.train_every': 10, 'train.log_every': 200,
        'train.eval_every': 1000,
    }
    cli = []
    for k, v in flags.items():
      cli += [f'--{k}', str(v)]
    cli += extra
    start = time.time()
    train_main(cli)
    print('A1 SIM RUN DURATION:', time.time() - start, flush=True)
    lines = (pathlib.Path(logdir) / 'metrics.jsonl').read_text()
    metrics = [json.loads(line) for line in lines.splitlines()]
    losses = [m['train/model_loss_mean'] for m in metrics
              if 'train/model_loss_mean' in m]
    scores = [m.get('episode/score') for m in metrics
              if 'episode/score' in m]
    print('model losses over time:',
          [round(x, 2) for x in losses], flush=True)
    print('episode scores:',
          [round(float(x), 2) for x in scores][:20], flush=True)
    return losses, scores


if __name__ == '__main__':
  main()

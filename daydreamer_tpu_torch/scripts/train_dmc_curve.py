"""Externally-anchored Dreamer curve of the port: dmc_proprio walker_walk
(the counterpart of the repository's `scripts/train_dmc_curve.py`).

Unlike the in-house A1/xarm sim curves, walker_walk has publicly known
Dreamer performance to compare against: the DreamerV2 paper (Hafner et
al. 2021, arxiv 2010.02193) reports walker_walk reaching ~900 within
~0.5M env frames (proprio variants converge faster than vision), and the
reference's dmc_proprio config block targets exactly this suite
(reference: embodied/agents/dreamerv2plus/configs.yaml dmc_proprio --
default model size, env.repeat 2, train_every 2).

This run pins `--configs dmc_proprio --task dmc_walker_walk --run train`
with the reference hyperparameters (default-size nets, deter 1024), the
learner on the card. The only intended degrees of freedom are --seed and
--steps (frame budget); any other argument is passed on to the CLI after
the pinned ones (`--torch.device cpu` runs it on the CPU) and recorded in
RUN.json as an extra override. env.render=False skips the unused 64x64
camera render (proprio encoder) -- an execution-speed knob only,
observations and training are unchanged.

Writes <scores>/dmc_walker_walk_torch.json (x = env frames, y = episode
return) + provenance under <scores>/provenance/dmc_walker_walk_torch_seed{N}/.
`--scores` defaults to the repository's `scores/`.

Usage: python -m daydreamer_tpu_torch.scripts.train_dmc_curve --seed 0 \\
    [--steps 400000] [--scores DIR]
"""

import argparse
import pathlib

from . import provenance

ROOT = pathlib.Path(__file__).resolve().parent.parent.parent


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument('--seed', type=int, default=0)
  parser.add_argument('--steps', type=int, default=400000,
                      help='env frames (logger steps; repeat-2 included)')
  parser.add_argument('--logdir', default='')
  parser.add_argument('--scores', default=str(ROOT / 'scores'))
  parser.add_argument('--export', action='store_true', default=True)
  parser.add_argument('--no-export', dest='export', action='store_false')
  args, extra = parser.parse_known_args(argv)
  if extra:
    print('train_dmc_curve EXTRA OVERRIDES:', extra, flush=True)

  logdir = pathlib.Path(
      args.logdir or (ROOT / 'runs' / f'dmc_walker_torch_seed{args.seed}'))
  scores = pathlib.Path(args.scores)
  suffix = '' if args.seed == 0 else f'_s{args.seed}'
  flags = {
      'configs': 'dmc_proprio',
      'task': 'dmc_walker_walk',
      'run': 'train',
      'logdir': logdir,
      'seed': args.seed,
      'env.render': 'False',
      'env.parallel': 'process',
      'torch.policy_devices': 'cpu',
      'train.steps': args.steps,
      'train.log_every': 2000,
      'train.eval_every': 25000,
  }
  # Logger steps already count env frames (multiplier env.repeat=2 over
  # wrapped driver steps); episode score is the raw return, directly
  # comparable to published walker_walk curves (0-1000 scale).
  provenance.run_curve(
      flags, extra,
      scores / 'provenance' / f'dmc_walker_walk_torch_seed{args.seed}',
      scores / f'dmc_walker_walk_torch{suffix}.json',
      task='dmc_walker_walk', seed=args.seed,
      script='daydreamer_tpu_torch/scripts/train_dmc_curve.py',
      export=args.export, external_anchor=(
          'DreamerV2 (arxiv 2010.02193) walker_walk: ~900 by ~0.5M '
          'frames; ~600+ typical by ~200-300k frames'))


if __name__ == '__main__':
  main()

"""Full-scale A1 walking curve run of the port with pinned, reproducible
provenance (the counterpart of the repository's `scripts/train_a1_curve.py`).

`--configs a1 --task a1_sim --run train` (MuJoCo A1, RMA stand+walk reward,
proprio-only world model per the a1 config block), the learner on the card
with the host-CPU policy mirror, env render off, 105k env steps (the
reference's a1_dreamer.json spans ~94k; BASELINE.md). The ONLY intended
degree of freedom between runs is --seed. Any other argument is passed on
to the CLI after the pinned ones (`--torch.device cpu` runs it on the CPU)
and recorded in RUN.json as an extra override.

After the run finishes this script copies the provenance the curve needs
to be reproducible -- the resolved config.yaml, metrics.jsonl, and
scores.jsonl -- into <scores>/provenance/a1_torch_seed{N}/, and exports the
curve to <scores>/a1_dreamer_torch{_sN}.json in the reference format
(per-step reward vs env steps; reference: scores/a1_dreamer.json).
`--scores` defaults to the repository's `scores/`.

Usage: python -m daydreamer_tpu_torch.scripts.train_a1_curve --seed 1 \\
    [--steps 105000] [--scores DIR]
"""

import argparse
import pathlib

from . import provenance

ROOT = pathlib.Path(__file__).resolve().parent.parent.parent


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument('--seed', type=int, required=True)
  parser.add_argument('--steps', type=int, default=105000)
  parser.add_argument('--logdir', default='')
  parser.add_argument('--scores', default=str(ROOT / 'scores'))
  parser.add_argument('--export', action='store_true', default=True)
  parser.add_argument('--no-export', dest='export', action='store_false')
  args, extra = parser.parse_known_args(argv)
  if extra:
    # Extra flags (smoke tests shrink the nets); RUN.json records them so
    # a curve produced with overrides can never masquerade as pinned.
    print('train_a1_curve EXTRA OVERRIDES:', extra, flush=True)

  logdir = pathlib.Path(
      args.logdir or (ROOT / 'runs' / f'a1_torch_seed{args.seed}'))
  scores = pathlib.Path(args.scores)
  suffix = '' if args.seed == 0 else f'_s{args.seed}'
  flags = {
      'configs': 'a1',
      'task': 'a1_sim',
      'run': 'train',
      'logdir': logdir,
      # train.py derives env.seed from (seed, worker), so this one flag
      # pins both the agent and environment seed streams.
      'seed': args.seed,
      'env.render': 'False',
      'env.parallel': 'process',
      # Robot-actor policy path: the policy runs on the host CPU against
      # the tracked mirror of the entries it reads, as the JAX script pins
      # it (`jax.policy_devices: cpu`).
      'torch.policy_devices': 'cpu',
      'train.steps': args.steps,
      'train.log_every': 250,
      'train.eval_every': 5000,
  }
  # Provenance: resolved config + raw metric streams, committed verbatim.
  # xdiv undoes the logger's env.repeat=50 frame multiplier (curve x-axis
  # is env steps, matching reference scores/a1_dreamer.json: ~251/episode);
  # ydiv converts episode score to per-step reward (env.length=250).
  provenance.run_curve(
      flags, extra, scores / 'provenance' / f'a1_torch_seed{args.seed}',
      scores / f'a1_dreamer_torch{suffix}.json', task='a1_walk',
      seed=args.seed, script='daydreamer_tpu_torch/scripts/train_a1_curve.py',
      xdiv=50, ydiv=250, export=args.export)


if __name__ == '__main__':
  main()

"""Score-curve export and comparison plotting.

Counterpart of the reference's scores/ workflow (reference:
scores/*.json hold per-run curves as
[{"task", "method", "seed", "xs": [...], "ys": [...]}] used for the
paper's comparison plots). Two subcommands:

  export  — convert one or more run logdirs (metrics.jsonl with
            episode/score entries) into a reference-format scores JSON.
  plot    — overlay any number of scores JSONs (ours or the
            reference's own files) into a PNG with final-10% means.

The port's copy of the repository's `scripts/scores.py`, changed only in
its imports; the port's curve scripts export through it.

Run:
  python -m daydreamer_tpu_torch.scripts.scores export --logdir ~/logdir/a1 \
      --task a1_walk --method dreamer_torch --out scores/a1_dreamer_torch.json
  python -m daydreamer_tpu_torch.scripts.scores plot --files scores/*.json \
      --out curves.png
"""

import argparse
import json
import pathlib

import numpy as np


def load_metrics(logdir, xdiv=1, ydiv=1):
  """Episode curve from metrics.jsonl. `xdiv` undoes the logger's env
  repeat multiplier on steps; `ydiv` converts episode score to per-step
  reward (the reference's a1 curves use env steps and score/length)."""
  xs, ys = [], []
  logdir = pathlib.Path(logdir).expanduser()
  path = logdir / 'metrics.jsonl'
  if not path.exists():  # Baselines log episodes to scores.jsonl only.
    path = logdir / 'scores.jsonl'
  for line in path.read_text().splitlines():
    try:
      row = json.loads(line)
    except json.JSONDecodeError:
      continue
    if 'episode/score' in row:
      xs.append(int(row.get('step', len(xs))) // max(1, xdiv))
      ys.append(float(row['episode/score']) / max(1, ydiv))
  return xs, ys


def final_mean(ys, frac=0.1):
  """Mean of the final `frac` of points (the reference's summary stat)."""
  n = max(1, int(len(ys) * frac))
  return float(np.mean(ys[-n:])) if ys else float('nan')


def cmd_export(args):
  runs = []
  for i, logdir in enumerate(args.logdir):
    xs, ys = load_metrics(logdir, args.xdiv, args.ydiv)
    runs.append({'task': args.task, 'method': args.method,
                 'seed': str(i), 'xs': xs, 'ys': ys})
    print(f'{logdir}: {len(xs)} episodes, '
          f'final-10% mean {final_mean(ys):.2f}')
  out = pathlib.Path(args.out)
  out.parent.mkdir(parents=True, exist_ok=True)
  out.write_text(json.dumps(runs))
  print(f'wrote {out}')


def cmd_plot(args):
  import matplotlib
  matplotlib.use('Agg')
  import matplotlib.pyplot as plt
  fig, ax = plt.subplots(figsize=(7, 4), dpi=120)
  for path in args.files:
    runs = json.loads(pathlib.Path(path).read_text())
    for run in runs:
      xs, ys = np.asarray(run['xs']), np.asarray(run['ys'], np.float64)
      if args.smooth > 1 and len(ys) >= args.smooth:
        kernel = np.ones(args.smooth) / args.smooth
        ys = np.convolve(ys, kernel, mode='valid')
        xs = xs[:len(ys)]
      label = (f"{run.get('method', '?')} "
               f"({final_mean(list(ys)):.2f})")
      ax.plot(xs, ys, label=label, linewidth=1.2)
  ax.set_xlabel('env steps')
  ax.set_ylabel('episode score')
  ax.legend(fontsize=8)
  ax.grid(alpha=0.3)
  fig.tight_layout()
  fig.savefig(args.out)
  print(f'wrote {args.out}')


def main(argv=None):
  parser = argparse.ArgumentParser()
  sub = parser.add_subparsers(dest='cmd', required=True)
  p = sub.add_parser('export')
  p.add_argument('--logdir', nargs='+', required=True)
  p.add_argument('--task', required=True)
  p.add_argument('--method', default='dreamer_tpu')
  p.add_argument('--out', required=True)
  p.add_argument('--xdiv', type=int, default=1,
                 help='divide steps by this (undo env.repeat multiplier)')
  p.add_argument('--ydiv', type=int, default=1,
                 help='divide scores by this (e.g. episode length for '
                      'per-step reward, matching the reference a1 curves)')
  p.set_defaults(fn=cmd_export)
  p = sub.add_parser('plot')
  p.add_argument('--files', nargs='+', required=True)
  p.add_argument('--out', default='curves.png')
  p.add_argument('--smooth', type=int, default=5)
  p.set_defaults(fn=cmd_plot)
  args = parser.parse_args(argv)
  args.fn(args)


if __name__ == '__main__':
  main()

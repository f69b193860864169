"""A curve run of the port and what it keeps beside its curve, shared by the
curve scripts (`train_a1_curve.py`, `train_dmc_curve.py`) and
`chip_smoke.py`'s `curve` phase, as the repository's curve scripts keep it:
`run_curve` trains through the CLI, then keeps the resolved `config.yaml`,
the raw `metrics.jsonl` and `scores.jsonl` and a `RUN.json`, and exports
the curve in the reference format through the port's `scores.py`; and, to
set two curves side by side, `bins` gives the mean return of each window
of env steps.
"""

import argparse
import json
import pathlib
import shutil
import time

import numpy as np

from . import scores


def run_curve(flags, extra, prov, out, task, seed, script, xdiv=1, ydiv=1,
              export=True, record=dict, **run):
  """Trains `python -m daydreamer_tpu_torch.agents.dreamer.train` in this
  process on `flags` ({key: value}, the pinned settings, `logdir` among
  them) followed by the arguments `extra`. Then, unless `export` is false,
  writes `RUN.json` with the run's argv, `extra`, `script`, its duration,
  the entries of `record()` (called first, after the run, so that it may
  check the run and raise before anything is written) and of `run`, keeps
  the provenance in `prov`, and exports the curve to `out` (`xdiv` and
  `ydiv` divide its steps and returns). Returns the curve's entry, or None
  without `export`."""
  from ..agents.dreamer.train import main as train_main
  argv = []
  for key, value in flags.items():
    argv += [f'--{key}', str(value)]
  argv += list(extra)
  print(f'{script} argv: {argv}', flush=True)
  start = time.time()
  train_main(argv)
  duration = time.time() - start
  print(f'{script}: the run (seed {seed}) finished in {duration:.0f}s',
        flush=True)
  if not export:
    return None
  run = {**record(), **run}
  logdir = pathlib.Path(flags['logdir'])
  entry = export_curve(logdir, out, task=task, method='dreamer_torch',
                       seed=seed, xdiv=xdiv, ydiv=ydiv)
  keep(logdir, prov, argv=argv, extra_overrides=list(extra), script=script,
       duration_s=round(duration), **run)
  return entry


def keep(logdir, prov, **run):
  """Copies the run's config and metric streams from `logdir` into `prov`
  and writes `RUN.json` there: the entries of `run`, and the card's name
  and power limit (nvidia-smi) when the run's device was the card."""
  logdir, prov = pathlib.Path(logdir), pathlib.Path(prov)
  prov.mkdir(parents=True, exist_ok=True)
  for name in ('config.yaml', 'metrics.jsonl', 'scores.jsonl'):
    src = logdir / name
    if src.exists():
      shutil.copy2(src, prov / name)
  from ..core import Config
  device = str(Config.load(logdir / 'config.yaml').torch.device)
  card = None
  if device.startswith('cuda'):
    from .profile_train import card as query
    card = query()
  (prov / 'RUN.json').write_text(json.dumps(
      {**run, 'device': device, 'card': card}, indent=2))


def export_curve(logdir, out, task, method, seed, xdiv=1, ydiv=1):
  """The episode curve of `logdir` into the scores JSON `out` (one run,
  stamped with `seed`; `cmd_export` numbers runs by position). Returns the
  run's entry."""
  ns = argparse.Namespace(logdir=[str(logdir)], task=task, method=method,
                          out=str(out), xdiv=xdiv, ydiv=ydiv)
  scores.cmd_export(ns)
  runs = json.loads(pathlib.Path(out).read_text())
  for run in runs:
    run['seed'] = str(seed)
  pathlib.Path(out).write_text(json.dumps(runs))
  print(f'exported {out}')
  return runs[0]


def bins(run, width=2000):
  """The mean episode return of a curve entry (`xs`, `ys`) in each window
  of `width` env steps, from 0 to its last step (None where a window holds
  no episode)."""
  xs, ys = np.asarray(run['xs']), np.asarray(run['ys'], np.float64)
  means = []
  for start in range(0, int(xs.max()) if len(xs) else 0, width):
    inside = ys[(xs > start) & (xs <= start + width)]
    means.append(round(float(inside.mean()), 3) if len(inside) else None)
  return means

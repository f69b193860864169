"""Scaling across processes: the port of `scripts/multihost_bench.py`
(the BASELINE target is at least 80 % env-steps/s scaling from 1 host to
N).

Two measurements:

1. Actors (host only, as in the JAX script): N independent processes, each
   pinned to its own core (real hosts do not share cores, so unpinned runs
   on one box would measure core contention, not the framework), each
   driving 4 `dummy_discrete` envs through the port's `Driver` with a
   random policy for `--seconds`. Efficiency = rate(N) / (N x rate(1))
   against the core-bound ideal: with more processes than cores the ideal
   is capped at `cores` single rates, and the oversubscription is stated.

2. The learner's weak scaling: the port's `scripts/multihost_worker.py`
   at `--configs debug` (4 rows a rank, chunk 8, imag_horizon 3: rows per
   rank fixed) as 1 rank, then as N = max(2, min(hosts, 4)) ranks; the
   fused updates (`train_multi`, 4 a dispatch) with the gradients and batch
   statistics reduced over the ranks in each update. The slowest rank paces
   the group, so each run reports the least of its ranks' updates/s, and
   the efficiency is updates/s(N) / updates/s(1). On the card each rank
   takes a card of its own over NCCL, and the phase raises unless there
   are N cards: two ranks that share a card measure the sharing, not the
   scaling. With `--device cpu` the ranks run over gloo, each pinned to a
   core with one thread.

Usage:
  python -m daydreamer_tpu_torch.scripts.multihost_bench [--hosts 2] \\
      [--seconds 10] [--phase all|actors|learner] [--device cuda|cpu] \\
      [--tiny]

Prints one JSON line per measurement.
"""

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]


def actor_main(seconds):
  """One collection host: a batch of envs, the driver, a random policy.
  Prints `ACTOR_RATE <env steps/s>`."""
  import daydreamer_tpu_torch as ddp
  from daydreamer_tpu_torch.envs import load_env
  env = load_env('dummy_discrete', amount=4, parallel='none', length=100)
  agent = ddp.RandomAgent(env.act_space)
  counter = {'steps': 0}
  driver = ddp.Driver(env)
  driver.on_step(lambda tran, worker: counter.update(
      steps=counter['steps'] + 1))
  deadline = time.time() + seconds
  start = time.time()
  while time.time() < deadline:
    driver(agent.policy, steps=400)
  rate = counter['steps'] / (time.time() - start)
  env.close()
  print(f'ACTOR_RATE {rate:.1f}', flush=True)


def _popen(args, core, env=None):
  """`python -m args` from the repository's root, pinned to `core`."""
  env = dict(os.environ if env is None else env)
  env['PYTHONPATH'] = str(ROOT) + os.pathsep + env.get('PYTHONPATH', '')
  proc = subprocess.Popen(
      [sys.executable, '-m', *args], stdout=subprocess.PIPE,
      stderr=subprocess.STDOUT, text=True, env=env, cwd=str(ROOT))
  os.sched_setaffinity(proc.pid, {core})
  return proc


def _collect(procs, prefix, field, timeout):
  """The `field`-th number of each process's line that starts with
  `prefix`; raises if a process fails or prints none."""
  values = []
  for proc in procs:
    out, _ = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
      raise RuntimeError(f'exited {proc.returncode}:\n{out[-4000:]}')
    values += [float(line.split()[field]) for line in out.splitlines()
               if line.startswith(prefix)]
  if len(values) != len(procs):
    raise RuntimeError(f'{len(procs)} processes printed {values}')
  return values


def measure_actors(n, seconds):
  cores = sorted(os.sched_getaffinity(0))
  procs = [_popen(['daydreamer_tpu_torch.scripts.multihost_bench', '--actor',
                   '--seconds', str(seconds)], cores[i % len(cores)])
           for i in range(n)]
  return sum(_collect(procs, 'ACTOR_RATE ', 1, seconds * 10 + 120))


def measure_learner(ranks, device, tiny=False):
  """The least updates/s over the ranks of one run of the worker: 8 timed
  dispatches of 4 updates."""
  cores = sorted(os.sched_getaffinity(0))
  with tempfile.TemporaryDirectory() as tmp:
    address = f'file://{tmp}/store'
    procs = []
    for rank in range(ranks):
      env = dict(os.environ, LOCAL_RANK=str(rank))
      if device == 'cpu':
        env['OMP_NUM_THREADS'] = '1'
      procs.append(_popen(
          ['daydreamer_tpu_torch.scripts.multihost_worker', address,
           str(ranks), str(rank), '--configs', 'debug', '--steps', '8',
           '--fused', '4', '--device', device,
           *(['--tiny'] if tiny else [])], cores[rank % len(cores)], env))
    # The slowest rank paces the group.
    return min(_collect(procs, 'RESULT ', 3, 1200))


def _measure_actor_phase(args, cores):
  one = measure_actors(1, args.seconds)
  many = measure_actors(args.hosts, args.seconds)
  # With more processes than cores each gets cores/hosts of a core, so the
  # share-nothing ideal is `cores` single rates; the ratio against hosts x
  # single would measure the oversubscription, not the framework.
  ideal = one * min(args.hosts, cores)
  oversub = max(1.0, args.hosts / cores)
  result = {
      'metric': 'env_steps_per_s_scaling_efficiency',
      'value': many / ideal,
      'unit': (f'ratio ({args.hosts} hosts vs cpu-bound ideal of '
               f'{min(args.hosts, cores)}x single; oversubscription '
               f'{oversub:.1f} hosts/core)'),
      'detail': {'rate_1host': one, f'rate_{args.hosts}hosts': many,
                 'cores': cores,
                 'raw_ratio_vs_nx_single': many / (args.hosts * one)},
  }
  print(json.dumps(result), flush=True)
  return result


def _measure_learner_phase(args, cores):
  import torch
  ranks = max(2, min(args.hosts, 4))
  about = {'name': 'cpu', 'backend': 'gloo'}
  if args.device == 'cuda':
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < ranks:
      raise RuntimeError(
          f'The learner phase needs {ranks} cards for {ranks} ranks, one '
          f'each; {cards} visible. Two ranks that share a card are no '
          f'scaling figure; pass --device cpu to run over gloo.')
    about = {'name': torch.cuda.get_device_name(0), 'backend': 'nccl',
             'cards': cards}
  single = measure_learner(1, args.device, args.tiny)
  multi = measure_learner(ranks, args.device, args.tiny)
  # Only CPU ranks share cores; on the card each rank has its own.
  oversub = max(1.0, ranks / cores) if args.device == 'cpu' else 1.0
  result = {
      'metric': 'learner_updates_per_s_multiprocess_efficiency',
      'value': multi * oversub / single,
      'unit': (f'weak-scaling ratio ({ranks}-rank {about["backend"]} vs '
               '1-rank, 4 rows a rank, fused multi-update learner path, '
               f'adjusted for {oversub:.1f} ranks/core oversubscription)'),
      'detail': {'updates_1rank': single, f'updates_{ranks}ranks': multi,
                 'cores': cores, 'raw_ratio': multi / single,
                 'device': about, 'tiny': args.tiny},
  }
  print(json.dumps(result), flush=True)
  return result


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  parser.add_argument('--actor', action='store_true')
  parser.add_argument('--hosts', type=int, default=2)
  parser.add_argument('--seconds', type=float, default=10.0)
  parser.add_argument('--phase', default='all',
                      choices=['all', 'actors', 'learner'],
                      help='run one phase (each is sensitive to the '
                           'host\'s load; run it again if polluted)')
  parser.add_argument('--device', default='cuda', choices=['cuda', 'cpu'],
                      help='the learner ranks\' device')
  parser.add_argument('--tiny', action='store_true',
                      help='the worker\'s smallest model (a test of the '
                           'path, not a scaling figure)')
  args = parser.parse_args(argv)
  if args.actor:
    actor_main(args.seconds)
    return None
  cores = len(os.sched_getaffinity(0))
  results = []
  if args.phase in ('all', 'actors'):
    results.append(_measure_actor_phase(args, cores))
  if args.phase in ('all', 'learner'):
    results.append(_measure_learner_phase(args, cores))
  return results


if __name__ == '__main__':
  main()

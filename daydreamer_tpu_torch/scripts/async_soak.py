"""Async actor/learner soak: the REAL two-process pair for N minutes, on
the port (the counterpart of the repository's `scripts/async_soak.py`).

Runs `run=learning` (the learner on the card, ZMQ store server, checkpoint
publisher) and `run=acting` (CPU actor driving the MuJoCo a1_sim, ZMQ
episode push, checkpoint polling) as separate OS processes of
`python -m daydreamer_tpu_torch.agents.dreamer.train` against one logdir
-- the deployment topology of the reference (reference: embodied/run/
learning.py:75-77 + acting.py:82-96) -- then audits the artifact trail:

  - actor env-steps/s and policy/env latency sections (timer stats),
  - checkpoint sync-age distribution (the `agent_cp_age` metric),
  - learner update progress and replay growth,
  - shutdown cleanliness (SIGINT -> both processes exit promptly).

Writes ASYNC_SOAK_TORCH.json with pass/fail gates:
  policy_avg <= 50 ms (robot budget, reference robot_interface.py:293),
  max sync age <= 2x sync_every, replay grew, learner trained, exits ok.

`--learner-device` is the learner's `torch.device` (the card by default;
`cpu` smoke-tests the pair off the card); the actor always asks for the
CPU and one operator thread (`--torch.threads 1`): its batch-1 policy
shares the host with the learner, and with a thread a core one of its
threads waits on a core that the learner holds. `--actor-task` is the actor's task (`a1_dummy` where MuJoCo is
missing). Any other argument goes to both processes after the pinned ones
(for example `--rssm.impl pallas`, the fused observe chain for the
learner) and is recorded in the output as `extra_args`. The output's
`learner_launches` is what the learner printed at its end: each kernel
wrapper's launches and the updates it made (None if it printed nothing).

`--until-events` ends the soak once the learner's metrics show both
events that the replay and training gates read (the replay grew past its
first reading, a train loss was logged), with `--minutes` as the time
limit: on a crowded machine the actor may take longer than a fixed wall to
finish the episode that grows the learner's replay.

Usage: python -m daydreamer_tpu_torch.scripts.async_soak [--minutes 10] \\
    [--out ASYNC_SOAK_TORCH.json] [--learner-device cuda|cpu] \\
    [--actor-task a1_sim] [--small] [--until-events] [OVERRIDES...]
"""

import argparse
import json
import os
import pathlib
import shutil
import signal
import socket
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent.parent


def free_port():
  with socket.socket() as s:
    s.bind(('', 0))
    return s.getsockname()[1]


def launch(args_list, log_path):
  log = open(log_path, 'w')
  return subprocess.Popen(
      [sys.executable, '-m', 'daydreamer_tpu_torch.agents.dreamer.train']
      + args_list,
      cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
      start_new_session=True), log


def read_metrics(path):
  rows = []
  try:
    with open(path) as f:
      for line in f:
        line = line.strip()
        if line:
          try:
            rows.append(json.loads(line))
          except ValueError:
            pass  # Mid-write tail line.
  except OSError:
    pass
  return rows


def learner_launches(path):
  """The learner's `LAUNCHES <json>` line in its log `path`, parsed; None
  where it printed none."""
  found = None
  for line in pathlib.Path(path).read_text().splitlines():
    if line.startswith('LAUNCHES '):
      found = json.loads(line[len('LAUNCHES '):])
  return found


def sync_every_of(extra, default=20):
  """The learner's and actor's `train.sync_every`: the a1 config block's
  value, or the last one that `extra` overrides it with."""
  value = default
  for flag, arg in zip(extra, extra[1:]):
    if flag == '--train.sync_every':
      value = float(arg)
  return value


def events(rows):
  """(the replay grew past its first reading, the learner logged a train
  loss) in the learner's metrics rows: what the gates replay_grew and
  learner_trained read."""
  steps = [r['replay/replay_steps'] for r in rows
           if 'replay/replay_steps' in r]
  grew = len(steps) >= 2 and steps[-1] > steps[0]
  return grew, any('train/model_loss_mean' in r for r in rows)


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument('--minutes', type=float, default=10.0)
  parser.add_argument('--out', default='ASYNC_SOAK_TORCH.json')
  parser.add_argument('--logdir', default='')
  parser.add_argument('--learner-device', default='cuda',
                      help="the learner's torch.device; 'cpu' smoke-tests "
                           'the pair off the card')
  parser.add_argument('--actor-task', default='a1_sim',
                      help="the actor's task; 'a1_dummy' needs no MuJoCo")
  parser.add_argument('--small', action='store_true',
                      help='shrink nets for wiring smoke tests')
  parser.add_argument('--until-events', action='store_true',
                      help='end once the replay grew and the learner '
                           'trained, --minutes at most')
  args, extra = parser.parse_known_args(argv)
  if extra:
    print('async_soak EXTRA ARGS:', extra, flush=True)

  logdir = pathlib.Path(
      args.logdir or (ROOT / 'runs' / 'async_soak_torch'))
  if logdir.exists():
    shutil.rmtree(logdir)
  logdir.mkdir(parents=True)
  port = free_port()
  sync_every = sync_every_of(extra)  # a1 config block value by default.

  common = [
      '--configs', 'a1',
      '--logdir', str(logdir),
      '--learner_addr', f'localhost:{port}',
      '--train.sync_every', '20',
      '--train.train_fill', '500',
      '--train.log_every', '2000',
      '--train.eval_every', '1e9',
      '--env.render', 'False',
  ]
  if args.small:
    common += [r'--.*\.units', '64', r'--.*\.layers', '2',
               '--rssm.deter', '64', '--rssm.units', '64',
               '--batch_size', '8', '--replay_chunk', '8',
               '--imag_horizon', '3', '--torch.precision', 'float32']
  learner, llog = launch(
      common + ['--task', 'a1_dummy', '--run', 'learning',
                '--torch.device', args.learner_device] + extra,
      logdir / 'learner.log')
  actor, alog = launch(
      common + ['--task', args.actor_task, '--run', 'acting',
                '--torch.device', 'cpu', '--torch.threads', '1',
                '--env.parallel', 'none'] + extra,
      logdir / 'actor.log')
  print(f'learner pid={learner.pid} actor pid={actor.pid} port={port} '
        f'logdir={logdir}', flush=True)

  start = time.time()
  deadline = start + 60 * args.minutes
  while time.time() < deadline:
    if learner.poll() is not None or actor.poll() is not None:
      print('A process exited early!', learner.poll(), actor.poll())
      break
    if args.until_events and all(events(read_metrics(
        logdir / 'metrics.jsonl'))):
      break
    time.sleep(min(2 if args.until_events else 10,
                   max(0, deadline - time.time())))
  soak_s = time.time() - start

  # Graceful shutdown: actor first (stops pushing), then learner.
  exits = {}
  for name, proc in (('actor', actor), ('learner', learner)):
    if proc.poll() is None:
      os.killpg(proc.pid, signal.SIGINT)
  shutdown_start = time.time()
  for name, proc in (('actor', actor), ('learner', learner)):
    try:
      proc.wait(timeout=90)
    except subprocess.TimeoutExpired:
      os.killpg(proc.pid, signal.SIGKILL)
      proc.wait(timeout=10)
    exits[name] = proc.returncode
  shutdown_s = time.time() - shutdown_start
  llog.close()
  alog.close()

  rows = read_metrics(logdir / 'metrics.jsonl')
  pick = lambda key: [r[key] for r in rows if key in r]
  ages = pick('agent_cp_age')
  # Ages during learner warmup (creation, prefill wait) are large by
  # construction; the steady-state gate looks at the second half.
  steady_ages = ages[len(ages) // 2:]
  pol_avg = pick('timer/agent.policy_avg')
  pol_max = pick('timer/agent.policy_max')
  env_avg = pick('timer/env.step_avg')
  fps = [v for v in pick('fps') if v > 0]
  scores = pick('episode/score')
  replay_steps = pick('replay/replay_steps')
  train_loss = [r for r in rows if 'train/model_loss_mean' in r]
  grew, trained = events(rows)

  summary = {
      'soak_minutes': round(soak_s / 60, 2),
      'sync_every_s': sync_every,
      'exit_codes': exits,
      'shutdown_s': round(shutdown_s, 1),
      'episodes': len(scores),
      'score_first_last': ([round(scores[0], 2), round(scores[-1], 2)]
                           if scores else None),
      'actor_fps_frames': ([round(min(fps), 1), round(max(fps), 1)]
                           if fps else None),
      'policy_avg_s': ([round(min(pol_avg), 4), round(max(pol_avg), 4)]
                       if pol_avg else None),
      'policy_max_s': round(max(pol_max), 4) if pol_max else None,
      'env_step_avg_s': round(sum(env_avg) / len(env_avg), 4)
                        if env_avg else None,
      'agent_cp_age_s': {
          'count': len(ages),
          'min': round(min(ages), 1) if ages else None,
          'max': round(max(ages), 1) if ages else None,
          'steady_max': (round(max(steady_ages), 1)
                         if steady_ages else None),
      },
      'replay_steps_first_last': (
          [int(replay_steps[0]), int(replay_steps[-1])]
          if replay_steps else None),
      'learner_log_rows_with_train_loss': len(train_loss),
  }
  gates = {
      'policy_avg_le_50ms': bool(pol_avg) and max(pol_avg) <= 0.050,
      # Warmup ages (creation, prefill wait) excluded; the gate is on the
      # steady half of the run.
      'steady_sync_age_le_2x_sync_every': (
          bool(steady_ages) and max(steady_ages) <= 2 * sync_every),
      'replay_grew': grew,
      'learner_trained': trained,
      'clean_shutdown': shutdown_s < 90 and all(
          c is not None for c in exits.values()),
  }
  result = {'summary': summary, 'gates': gates,
            'passed': all(gates.values()),
            'learner_device': args.learner_device,
            'actor_task': args.actor_task, 'extra_args': extra,
            'learner_launches': learner_launches(logdir / 'learner.log')}
  text = json.dumps(result, indent=1)
  print(text)
  pathlib.Path(args.out).write_text(text + '\n')
  return result


if __name__ == '__main__':
  main()

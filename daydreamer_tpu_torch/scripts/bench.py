"""Learner updates/s at three shapes, the work of an update and the card's
share of it, and the policy's latency: the port of the root `bench.py`.

Three shapes (`profile_train.SHAPES`, with their K fused updates a
dispatch), all on the `run=learning` hot path: K gradient updates a
dispatch, each sampled from a device-resident ring of 4096 steps.

  1. test: the reference's TEST_CONFIG (batch 8, chunk 8, layers 2, units
     128, cnn_depth 16), K = 256. The reference asserts 0.02 s an update
     (50 updates/s) on one GPU at this shape
     (embodied/agents/dreamerv2plus/tests.py:26-71). Headline metric.
  2. a1: the a1 training shape (proprio only, deter = units = 256, batch
     32 x chunk 32), K = 64.
  3. xarm: the xarm training shape (64x64 image and depth with a CNN of
     depth 64, deter = units = 512, batch 32 x chunk 32, `rssm.impl:
     pallas`), K = 16.

Updates/s is the median over windows of `calls` dispatches, each dispatch
ended by a fetch of its last update's model loss (`profile_train._dispatch`),
with the JAX bench's early stop and its pause after a congested window. The
first dispatch creates the state and is timed apart (`first_dispatch_s`): it
takes the place of the JAX bench's compile time, as nothing compiles here
but the kernels, which are built before the first shape (`kernel_build`).
Each kernel's launches in the timed windows are reported beside them.

The work of an update is counted from the program, not from XLA
(`train_cost`): one gradient update under `nn.cost.CostMode`, on a twin of
the agent that takes the loop path (`rssm.impl: scan`, `imag_impl: scan`)
eagerly, one pass for both counts. `flops_per_update` is its matmul and
convolution FLOPs, the formulas of `torch.utils.flop_counter` (equal to
`train_flops`, `FlopCounterMode`'s count); `bytes_per_update` the bytes its
aten ops access on the device, each op's operands read once and results
written once. It is the same work whatever implements it, so it is the
count for every `impl` and both graphs arms of a config: the numerator
stays fixed. This deliberately differs from the JAX bench's XLA count,
which is taken after fusion: here every op of the eager loop path is one
kernel, so an intermediate is written and read where XLA's fused program
keeps it on chip, and every step of a loop counts. `mfu` is the FLOPs times
updates/s over the card's dense bfloat16 peak, `hbm_bw_util` the bytes
times updates/s over its memory rate (`PEAKS`, keyed by
`torch.cuda.get_device_name`); on a card the table lacks, and on the CPU,
both are null. At xarm the configured agent's own count of an update
(`TorchAgent.train_device_cost`, the fused observe kernels by their
formulas) is printed beside the twin's, under `own_cost`. Where the timed
program's own count is smaller than the twin's, as there, `hbm_bw_util`
reads high by the ratio of the two: it is the twin's bytes at the timed
program's rate, and a share over 1 says that the twin's count exceeds what
the card could have moved in the timed program's time.

The policy (`measure_policy`): batch-1 `agent.policy` calls on the card and
on the host-CPU mirror (`torch.policy_devices: cpu`), which must run, and
the card's null round trip, each a median of window medians with the JAX
bench's congestion guard. Two gates are reported as booleans, not raised:
the mirror within 50 ms (the robot's 20 Hz budget, reference
robot_interface.py:293), and the card's call minus the null round trip
within 10 ms.

`--graphs-arms` runs each shape twice instead, as `fused_impl_bench` runs
its two arms: eagerly (`torch.graphs: False`) and with each update replayed
as a CUDA graph (`True`, the default, the counterpart of `jax.jit`),
reporting each arm's updates/s, first dispatch (the capture included),
MFU, launches, the graph's capture seconds and pool bytes, graphed over
eager, and the batch-1 policy on the card both ways at the test shape.
Every other measurement runs with the config's default, graphed.

`--sweep PATH` runs the batch sweep of the JAX bench instead (updates/s,
replayed steps/s and MFU against the batch at a1 and xarm) and writes it to
PATH; a row that runs out of the card's memory records the error.

Runs on the card unless `--device cpu`; without a card it raises. On the
card it prints the card's name and power limit before its result.

Usage:
  python -m daydreamer_tpu_torch.scripts.bench [--shape all|test|a1|xarm] \\
      [--graphs-arms] [--sweep PATH] [--device cuda|cpu]

The last line printed is one JSON object.
"""

import argparse
import gc
import json
import pathlib
import time

import numpy as np

from . import profile_train
from ..nn import cost
from .profile_train import card, resolve_device

BASELINE_UPDATES_PER_S = 1.0 / 0.02  # Reference tests.py:70-71.

# Dense bfloat16 FLOP/s and HBM bytes/s of a card, keyed by
# torch.cuda.get_device_name.
PEAKS = {'NVIDIA H100 80GB HBM3': cost.H100}

SHAPES = profile_train.SHAPES
build_agent = profile_train.build_agent

# Each shape's window budget in seconds and dispatches a window in the full
# run, as the JAX bench has them.
BUDGETS = {'test': (300.0, 2), 'a1': (120.0, 1), 'xarm': (120.0, 1)}
UNITS = {
    'test': ('updates/s median (batch8,chunk8 TEST_CONFIG, device-replay '
             'fused x256, last-step metrics, 1 card)'),
    'a1': ('updates/s median (a1 shape: proprio deter256, batch32,chunk32, '
           'fused x64, 1 card)'),
    'xarm': ('updates/s median (xarm shape: image cnn64 + proprio, '
             'deter512, batch32,chunk32, fused x16, 1 card)'),
}
# The twin whose update `train_cost` counts: no custom kernel, and eager,
# so that the counter sees the update once (a graph's first call runs it
# and then captures it, and the counter would see both).
LOOP_PATH = {'rssm.impl': 'scan', 'imag_impl': 'scan', 'torch.graphs': False}


def device_name(device):
  import torch
  return torch.cuda.get_device_name(device) if device.type == 'cuda' else (
      'cpu')


def kernels():
  """Every kernel wrapper of the port, each with its launch count."""
  from ..ops import build, lambda_returns, rssm, rssm_vjp
  del lambda_returns, rssm, rssm_vjp  # Imported to register their kernels.
  return build.KERNELS


def free_memory(device):
  import torch
  gc.collect()
  if device.type == 'cuda':
    torch.cuda.empty_cache()


def _twin_update(task, overrides, device, mode):
  """One gradient update at (task, overrides), `agent.train` on the
  shape's batch, under `mode`, on a twin that takes the loop path, after one
  update that creates its state. The twin is freed before this returns."""
  device = resolve_device(device)
  twin, data = build_agent(task, {**overrides, **LOOP_PATH}, device)
  _, state, _ = twin.train(data)
  with mode:
    twin.train(data, state)
  del twin, state
  free_memory(device)
  return mode


def train_flops(task, overrides, device):
  """The matmul and convolution FLOPs of one gradient update at (task,
  overrides) under `torch.utils.flop_counter.FlopCounterMode`: the count
  that `train_cost`'s FLOPs are held to."""
  from torch.utils.flop_counter import FlopCounterMode
  counter = _twin_update(task, overrides, device,
                         FlopCounterMode(display=False))
  return int(counter.get_total_flops())


def train_cost(task, overrides, device):
  """The work of one gradient update at (task, overrides), one pass of
  `nn.cost.CostMode` on the device over the loop-path twin: {'flops',
  'bytes', 'table'} ({op: [calls, flops, bytes]})."""
  device = resolve_device(device)
  counter = _twin_update(task, overrides, device, cost.CostMode(device))
  return {'flops': counter.flops, 'bytes': counter.nbytes,
          'table': dict(counter.table)}


def measure_updates(agent, data, K, sample_budget_s, windows=60, calls=2,
                    flops=None, nbytes=None, own_cost=False):
  """Median steady-state updates/s of `agent.train_device` from a ring of
  4096 steps, K updates a dispatch, over windows of `calls` dispatches that
  stop once `sample_budget_s` has passed. `flops` and `nbytes` are the
  work of an update (`train_cost`); with them and a card of `PEAKS`, `mfu`
  and `hbm_bw_util`. With `own_cost`, after the windows, the agent's own
  count of one update from the same ring (`train_device_cost`) under
  `own_cost`. Returns (result, state)."""
  replay = profile_train.fill_ring(agent, data)
  begin = time.perf_counter()
  state, loss = profile_train._dispatch(agent, replay, K, None)
  first_dispatch_s = time.perf_counter() - begin

  for kernel in kernels():
    kernel.launches = 0
  rates = []
  deadline = time.perf_counter() + sample_budget_s
  for _ in range(windows):
    begin = time.perf_counter()
    for _ in range(calls):
      state, loss = profile_train._dispatch(agent, replay, K, state)
    duration = time.perf_counter() - begin
    rates.append(calls * K / duration)
    if time.perf_counter() > deadline or (
        len(rates) >= 12
        and np.median(rates) > 20 * BASELINE_UPDATES_PER_S):
      break
    if duration > 4.0 * calls * K / max(rates):
      time.sleep(2.0)  # A congested window; give the host air.
  launches = {k.name: k.launches for k in kernels()}
  updates_per_s = float(np.median(rates))
  name = device_name(agent.device)
  peaks = PEAKS.get(name, {})
  rate = lambda work, key: (work * updates_per_s / peaks[key]
                            if work and key in peaks else None)
  own = None
  if own_cost:
    own = agent.train_device_cost(replay, 1, state)
    own = {k: own[k] for k in ('flops', 'bytes accessed')}
  return {
      'updates_per_s': updates_per_s,
      'first_dispatch_s': first_dispatch_s,
      'rate_windows': rates,
      'updates_timed': calls * K * len(rates),
      'launches': launches,
      'model_loss': loss,
      'flops_per_update': flops,
      'bytes_per_update': nbytes,
      'mfu': rate(flops, 'bf16_flops'),
      'hbm_bw_util': rate(nbytes, 'hbm_bytes'),
      'own_cost': own,
      'device': name,
  }, state


def measure_shape(shape, device, sample_budget_s=None, calls=None,
                  windows=60, K=None):
  """`measure_updates` at one of SHAPES with its work counted, by default
  with the full run's budget, calls and K. Returns (agent, data, result)."""
  task, overrides, shape_k = SHAPES[shape]
  K = K or shape_k
  budget, shape_calls = BUDGETS[shape]
  work = train_cost(task, overrides, device)
  agent, data = build_agent(task, overrides, device)
  result, _ = measure_updates(
      agent, data, K, budget if sample_budget_s is None else sample_budget_s,
      windows, calls or shape_calls, flops=work['flops'],
      nbytes=work['bytes'], own_cost=shape == 'xarm')
  print_own_cost(shape, result)
  return agent, data, result


def print_own_cost(shape, result):
  """The line that puts the agent's own count of an update beside the
  loop-path twin's, where the bench took it."""
  own = result.get('own_cost')
  if own:
    print(f'{shape}: bytes an update, loop-path twin '
          f'{result["bytes_per_update"]}, configured agent '
          f'{own["bytes accessed"]} (train_device_cost); FLOPs '
          f'{result["flops_per_update"]} and {own["flops"]}', flush=True)


def measure_latency(fn, warmup=2, calls=25, max_windows=8, budget_s=90.0):
  """Median of window medians of `fn`'s wall time. Windows whose median
  exceeds 5x the best window's are dropped as congestion and counted, so an
  outlier window cannot become the steady-state number."""
  for _ in range(warmup):
    fn()
  window_medians = []
  deadline = time.perf_counter() + budget_s
  for _ in range(max_windows):
    samples = []
    for _ in range(calls):
      begin = time.perf_counter()
      fn()
      samples.append(time.perf_counter() - begin)
    window_medians.append(float(np.median(samples)))
    if time.perf_counter() > deadline:
      break
    time.sleep(0.2)
  best = min(window_medians)
  kept = [m for m in window_medians if m <= 5 * best]
  return {
      'median_s': float(np.median(kept)),
      'best_window_s': best,
      'windows': window_medians,
      'congested_windows_dropped': len(window_medians) - len(kept),
  }


def policy_fn(agent, obs):
  """A batch-1 `agent.policy` call in mode eval that carries its state
  from call to call (the first call starts it)."""
  state = [None]

  def call():
    _, state[0] = agent.policy(obs, state[0], mode='eval')
  return call


def measure_policy(agent, data, budget_s=60.0, max_windows=8):
  """Batch-1 policy latency on the agent's device and on the host-CPU
  mirror, and the device's null round trip (an add of 8 values and its
  fetch). The robot actor's budget is 50 ms at 20 Hz (reference
  robot_interface.py:293); the reference asserts 0.007 s on its training
  device (tests.py:87-89). The mirror must run: an error there raises."""
  import torch
  obs = {k: v[:1, 0] for k, v in data.items() if k != 'action'}
  x = torch.zeros(8, device=agent.device)
  (x + 1).cpu()
  rtt = measure_latency(lambda: (x + 1).cpu(), calls=25,
                        max_windows=min(4, max_windows),
                        budget_s=budget_s / 3)

  devices = agent._policy_devices
  try:
    agent._policy_devices = 'all'
    device = measure_latency(policy_fn(agent, obs), max_windows=max_windows,
                             budget_s=budget_s)
    agent._policy_devices, agent._mirror = 'cpu', None
    mirror = measure_latency(policy_fn(agent, obs), max_windows=max_windows,
                             budget_s=budget_s)
    mirror_on = str(agent._policy_agent()[1].device)
  finally:
    agent._policy_devices = devices
  if mirror_on != 'cpu':
    raise RuntimeError(f'The policy mirror ran on {mirror_on}.')
  return {'null_rtt': rtt, 'device': device, 'cpu_mirror': mirror,
          'device_on': str(agent.device), 'mirror_on': mirror_on}


def gates(policy):
  """The robot budgets, as booleans."""
  return {
      'policy_mirror_le_50ms':
          bool(policy['cpu_mirror']['median_s'] <= 0.050),
      'policy_device_minus_null_rtt_le_10ms':
          bool(policy['device']['median_s']
               - policy['null_rtt']['median_s'] <= 0.010),
  }


def kernel_build(device):
  """The state of the kernel build: its directory, whether every CUDA
  kernel's library was there before this run (`warm`), and the seconds that
  building them took (on the card; null on the CPU, where none is
  built)."""
  from ..ops import build
  warm = all(k.library.exists() for k in kernels() if k.route == 'cuda')
  seconds = None
  if device.type == 'cuda':
    begin = time.perf_counter()
    build.build_all()
    seconds = time.perf_counter() - begin
  return {'dir': str(build.BUILD), 'warm': warm, 'build_s': seconds}


def compare_impls(label, key, task, overrides, K, budget_s, device, names):
  """The config `key` at scan, then at pallas, at (task, overrides):
  updates/s, first dispatch and MFU of each arm (both divided by one count
  of the update's work) and pallas over scan. On the card each kernel of
  `names` must launch once a timed update in the pallas arm and never in
  the scan arm; on the CPU the wrappers run their plain versions, which
  launch nothing."""
  device = resolve_device(device)
  work = train_cost(task, overrides, device)
  rows = {}
  for impl in ('scan', 'pallas'):
    agent, data = build_agent(task, {**overrides, key: impl}, device)
    result, _ = measure_updates(agent, data, K, budget_s, calls=1,
                                flops=work['flops'], nbytes=work['bytes'])
    del agent, data
    free_memory(device)
    on_card = impl == 'pallas' and device.type == 'cuda'
    expect = result['updates_timed'] if on_card else 0
    launched = {k: result['launches'][k] for k in names}
    if any(n != expect for n in launched.values()):
      raise AssertionError(
          f'{label} {key}={impl}: launches {launched} in '
          f'{result["updates_timed"]} timed updates; expected {expect} each')
    rows[impl] = {k: result[k] for k in (
        'updates_per_s', 'first_dispatch_s', 'mfu', 'hbm_bw_util',
        'rate_windows', 'updates_timed')}
    rows[impl]['launches'] = launched
    print(label, key, impl, json.dumps(rows[impl]), flush=True)
  rows['flops_per_update'] = work['flops']
  rows['bytes_per_update'] = work['bytes']
  rows['speedup'] = (rows['pallas']['updates_per_s']
                     / rows['scan']['updates_per_s'])
  return rows


def compare_graphs(shape, device, budget_s, K=None, calls=1,
                   policy_budget_s=None):
  """`shape` eagerly, then graphed (`torch.graphs` False, True): each
  arm's updates/s, first dispatch, MFU, HBM share and launches (divided by
  one count of the update's work; at xarm the eager arm also takes the
  agent's own count, `own_cost`), the graphed arm's capture seconds and
  pool bytes, and
  graphed over eager. With `policy_budget_s`, each arm's batch-1 policy on
  the agent's device too. On the card observe_fwd and observe_bwd must
  launch once a timed update in both arms where the shape takes the fused
  observe chain (`rssm.impl: pallas`), the graphed arm's launches credited
  at each replay."""
  device = resolve_device(device)
  task, overrides, shape_k = SHAPES[shape]
  K = K or shape_k
  work = train_cost(task, overrides, device)
  rows = {}
  for arm, flag in (('eager', False), ('graphed', True)):
    agent, data = build_agent(
        task, {**overrides, 'torch.graphs': flag}, device)
    result, _ = measure_updates(
        agent, data, K, budget_s, calls=calls, flops=work['flops'],
        nbytes=work['bytes'], own_cost=shape == 'xarm' and not flag)
    print_own_cost(shape, result)
    row = {k: result[k] for k in (
        'updates_per_s', 'first_dispatch_s', 'mfu', 'hbm_bw_util',
        'rate_windows', 'updates_timed', 'launches', 'model_loss',
        'device')}
    if result['own_cost']:
      rows['own_cost'] = result['own_cost']
    stats = agent.graphs.stats().get('train_device', {})
    row['capture_s'] = stats.get('capture_s')
    row['pool_bytes'] = stats.get('pool_bytes')
    if policy_budget_s:
      obs = {k: v[:1, 0] for k, v in data.items() if k != 'action'}
      row['policy'] = measure_latency(policy_fn(agent, obs), max_windows=4,
                                      budget_s=policy_budget_s)
    del agent, data
    free_memory(device)
    expect = result['updates_timed'] if device.type == 'cuda' else 0
    fused = overrides.get('rssm.impl') == 'pallas'
    for name in ('observe_fwd', 'observe_bwd') if fused else ():
      if result['launches'][name] != expect:
        raise AssertionError(
            f'{shape} {arm}: launches {result["launches"]} in '
            f'{result["updates_timed"]} timed updates; expected {expect} of '
            f'{name}')
    rows[arm] = row
    print(shape, arm, json.dumps(row), flush=True)
  rows['flops_per_update'] = work['flops']
  rows['bytes_per_update'] = work['bytes']
  rows['speedup'] = (rows['graphed']['updates_per_s']
                     / rows['eager']['updates_per_s'])
  if policy_budget_s:
    rows['policy_speedup'] = (rows['eager']['policy']['median_s']
                              / rows['graphed']['policy']['median_s'])
  return rows


SWEEP_SHAPES = {
    'a1': ('a1_dummy', {
        'replay_chunk': 32,
        'rssm.deter': 256, 'rssm.units': 256,
        'encoder.cnn_keys': '$^', 'decoder.cnn_keys': '$^',
        'encoder.mlp_keys': 'vector', 'decoder.mlp_keys': 'vector'},
     (32, 256, 1024)),
    'xarm': ('xarm_dummy', {
        'replay_chunk': 32,
        'rssm.deter': 512, 'rssm.units': 512,
        'encoder.cnn_keys': 'image|depth', 'decoder.cnn_keys': 'image|depth',
        'encoder.mlp_keys': 'cartesian|joint|gripper|grasped',
        'decoder.mlp_keys': 'cartesian|joint|gripper|grasped',
        'rssm.impl': 'pallas'},
     (32, 64, 128, 256)),
}


def sweep(device, budget_s=45.0):
  """Updates/s, replayed steps/s and MFU against the batch at the a1 and
  xarm shapes. K shrinks as the batch grows, by the JAX bench's rule. A row
  that runs out of the card's memory records the error and the sweep goes
  on; any other error ends it."""
  import torch
  out = {}
  for name, (task, overrides, batches) in SWEEP_SHAPES.items():
    rows = []
    for batch in batches:
      K = max(2, min(64, 512 // batch if name == 'xarm' else 2048 // batch))
      shape = {**overrides, 'batch_size': batch}
      agent = data = None
      try:
        work = train_cost(task, shape, device)
        agent, data = build_agent(task, shape, device)
        result, _ = measure_updates(
            agent, data, K, budget_s, windows=20, calls=1,
            flops=work['flops'], nbytes=work['bytes'])
      except torch.cuda.OutOfMemoryError as e:
        rows.append({'batch': batch, 'fused_K': K,
                     'error': f'{type(e).__name__}: {e}'[:300]})
        print(name, batch, 'FAILED:', type(e).__name__, flush=True)
        continue
      finally:
        agent = data = None
        free_memory(device)
      row = {
          'batch': batch, 'fused_K': K,
          'updates_per_s': result['updates_per_s'],
          'replay_steps_per_s': result['updates_per_s'] * batch * int(
              shape['replay_chunk']),
          'first_dispatch_s': result['first_dispatch_s'],
          'flops_per_update': work['flops'],
          'bytes_per_update': work['bytes'],
          'mfu': result['mfu'],
          'hbm_bw_util': result['hbm_bw_util'],
      }
      rows.append(row)
      print(name, json.dumps(row), flush=True)
    out[name] = rows
  return out


def describe(device):
  """The device as the result line names it."""
  import torch
  if device.type != 'cuda':
    return {'name': 'cpu', 'power_limit': None, 'count': 0}
  name, limit = card().rsplit(', ', 1)
  return {'name': name, 'power_limit': limit,
          'count': torch.cuda.device_count()}


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  parser.add_argument('--shape', default='all',
                      choices=['all', 'test', 'a1', 'xarm'],
                      help='measure one shape alone, 180 s of windows')
  parser.add_argument('--sweep', default='',
                      help='run the batch sweep instead and write it to '
                           'this path')
  parser.add_argument('--graphs-arms', action='store_true',
                      help='run each shape eagerly and graphed instead')
  parser.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
  args = parser.parse_args(argv)
  device = resolve_device(args.device)
  built = kernel_build(device)
  about = describe(device)
  if device.type == 'cuda':
    print(card(), flush=True)

  if args.sweep:
    result = {'sweep': sweep(device), 'device': about,
              'kernel_build': built}
    text = json.dumps(result, indent=1)
    pathlib.Path(args.sweep).write_text(text + '\n')
    print(json.dumps(result), flush=True)
    return result

  if args.graphs_arms:
    shapes = ('test', 'a1', 'xarm') if args.shape == 'all' else (
        args.shape,)
    result = {name: compare_graphs(
        name, device, BUDGETS[name][0], calls=BUDGETS[name][1],
        policy_budget_s=60.0 if name == 'test' else None)
        for name in shapes}
    result.update(device=about, kernel_build=built)
    print(json.dumps(result), flush=True)
    return result

  if args.shape != 'all':
    _, _, res = measure_shape(args.shape, device, sample_budget_s=180.0,
                              calls=1)
    result = {'metric': f'{args.shape}_updates_per_s',
              'value': res['updates_per_s'], **res, 'device': about,
              'kernel_build': built}
    print(json.dumps(result), flush=True)
    return result

  # 1. The TEST_CONFIG shape (headline; the reference's 50 updates/s), and
  # the policy on its agent (comparable to the reference's policy budget).
  agent, data, test_res = measure_shape('test', device)
  policy = measure_policy(agent, data)
  del agent, data
  free_memory(device)
  # 2. a1 and 3. xarm.
  shapes = {'test_config': {**test_res, 'unit': UNITS['test']}}
  for shape in ('a1', 'xarm'):
    agent, data, res = measure_shape(shape, device)
    del agent, data
    free_memory(device)
    shapes[shape] = {**res, 'unit': UNITS[shape]}

  result = {
      'metric': 'train_gradient_updates_per_s',
      'value': test_res['updates_per_s'],
      'unit': UNITS['test'],
      'vs_baseline': test_res['updates_per_s'] / BASELINE_UPDATES_PER_S,
      'first_dispatch_s': test_res['first_dispatch_s'],
      'kernel_build': built,
      'policy_device_s': policy['device']['median_s'],
      'policy_device_best_window_s': policy['device']['best_window_s'],
      'policy_cpu_mirror_s': policy['cpu_mirror']['median_s'],
      'policy_null_rtt_s': policy['null_rtt']['median_s'],
      'policy_congested_windows_dropped':
          policy['device']['congested_windows_dropped']
          + policy['cpu_mirror']['congested_windows_dropped'],
      'policy': policy,
      'gates': gates(policy),
      'shapes': shapes,
      'device': about,
      'reference_default_note': (
          'reference default-size budget 0.115s/step (test_xla_auto.py:'
          '19-20) is measured at sequence length 0 (helpers.py make_data '
          'with replay_fixed.length=0) - an empty-scan program; the a1/'
          'xarm rows above run real chunk-32 sequences'),
  }
  print(json.dumps(result), flush=True)
  return result


if __name__ == '__main__':
  main()

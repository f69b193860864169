"""Where an update of the learner's device-ring dispatches spends its time
on the card: the port of `scripts/profile_train.py`.

Builds the agent at one of the JAX script's shapes (`test`, `a1`, `xarm`,
with its overrides and its K fused updates a dispatch), fills a device ring
of 4096 steps (block 64), runs one dispatch of `agent.train_device(replay,
K)` that creates the state and two warm ones (timed, untraced), then traces
`--dispatches` more with `torch.profiler` (CPU and CUDA activities), each
window ending in a fetch of the last update's model loss. The report ranks
the CUDA kernels by device time per update with their launches per update,
sorts them into categories by kernel name (the port's six kernels and the
eight that stand for XLA's fusions, each its own, GEMM,
convolution, LayerNorm, casts and copies, elementwise, reductions,
host-to-device copies, other) and gives the device's busy ms, the wall ms
and the idle share per update (against the traced wall time, and against
the untraced dispatches' pace, since the profiler slows the host but not
the device), and the launches that each of the port's kernel wrappers
counted in the traced window. On the card it also counts the RSSM's
`initial()` calls in one eager update and the device kernels launched
inside them (`initial_launches`): the loop path's observe rebuilds the
initial state at every step.

`--set KEY=VALUE` (repeats) overrides a config key after the shape's own
overrides, the value read as a Python literal where it is one, else as a
string: `--shape a1 --set rssm.deter=4096 --set rssm.classes=64 --set
reward_head.units=4100` profiles the a1 update at the widths past the
kernels' first layouts that `chip_smoke.py`'s graphs phase trains.

`--graphs True` (the config's default) replays each update as a CUDA graph
(`torch.graphs`), `False` runs it eagerly. Launches an update come two
ways: `launches_per_update` counts the kernels, copies and sets that the
device executed (the trace's device events, whether a graph or the host
launched them), `host_launches_per_update` the launch calls that the host
made (the trace's CUDA API calls, `cuda*` and `cu*`, that launch a kernel,
a copy, a set or a graph). Eagerly the two are about equal; under graphs
the second is about one an update. The wrappers' counts include the
launches that replays of a graph credit (`ops/build.py`).

With `--device cpu` there is no device timeline: the rows are the CPU
operators by self time, and the device metrics are null.

After the trace it counts the bytes an update accesses
(`nn.cost.CostMode`): one update of the loop-path twin
(`bench.train_cost`, the bench's `bytes_per_update`) and one of the
profiled agent itself (`TorchAgent.train_device_cost`, its kernels by their
formulas), each sorted into the same categories (an aten op by its name,
a kernel by its own). Beside each category's device ms it gives the
achieved GB/s: the profiled agent's bytes over that time, since the two
describe the same program.

Usage:
  python -m daydreamer_tpu_torch.scripts.profile_train --shape xarm \\
      [--dispatches 8] [--graphs True|False] [--out FILE] \\
      [--device cuda|cpu] [--set KEY=VALUE ...]

The last line printed is the report as JSON.
"""

import argparse
import ast
import collections
import json
import pathlib
import re
import subprocess
import time

import numpy as np

# The JAX script's shapes: (task, overrides, K).
SHAPES = {
    'test': ('dummy_discrete', {
        'replay_chunk': 8, 'batch_size': 8,
        r'.*\.layers': 2, r'.*\.units': 128,
        r'.*\.cnn_depth': 16}, 256),
    'a1': ('a1_dummy', {
        'replay_chunk': 32, 'batch_size': 32,
        'rssm.deter': 256, 'rssm.units': 256,
        'encoder.cnn_keys': '$^', 'decoder.cnn_keys': '$^',
        'encoder.mlp_keys': 'vector', 'decoder.mlp_keys': 'vector'}, 64),
    'xarm': ('xarm_dummy', {
        'replay_chunk': 32, 'batch_size': 32,
        'rssm.deter': 512, 'rssm.units': 512,
        'encoder.cnn_keys': 'image|depth',
        'decoder.cnn_keys': 'image|depth',
        'encoder.mlp_keys': 'cartesian|joint|gripper|grasped',
        'decoder.mlp_keys': 'cartesian|joint|gripper|grasped',
        'rssm.impl': 'pallas'}, 16),
}
RING, BLOCK = 4096, 64

# The port's kernels by the name of their device function. observe_fwd's
# and observe's `embed_kernel` and `chain_kernel` lie in anonymous
# namespaces of two libraries and carry the same name, so a trace cannot
# tell them apart; the wrappers' launch counts of the same window can.
OWN = {
    'observe_bwd_kernel': 'observe_bwd',
    'prior_kernel': 'observe_fwd',
    'embed_kernel': 'observe_fwd|observe',
    'chain_kernel': 'observe_fwd|observe',
    'imagine_actor_kernel': 'imagine_actor',
    'imagine_kernel': 'imagine',
    'imagine_fma_kernel': 'imagine',
    # The counterparts of XLA's fusions on the update (ops/norm.py,
    # ops/adam.py). The backward is one kernel: its blocks sum dscale and
    # dbias across the grid themselves.
    'ln_fwd_kernel': 'layer_norm_act_fwd',
    'ln_bwd_kernel': 'layer_norm_act_bwd',
    'sumsq_kernel': 'adam_sumsq',
    'sumsq_total_kernel': 'adam_sumsq',
    'adam_update_kernel': 'adam_update',
    # The counterparts of XLA's fusions of the RSSM's scan step
    # (ops/gru.py, ops/onehot.py). The GRU cell's backward is one kernel;
    # builds before it summed its clusters' rows itself had a second,
    # `gru_sum_kernel`, kept here so that their traces read the same.
    'gru_fwd_kernel': 'gru_cell_fwd',
    'gru_bwd_kernel': 'gru_cell_bwd',
    'gru_sum_kernel': 'gru_cell_bwd',
    'onehot_fwd_kernel': 'onehot_head_fwd',
    'onehot_bwd_kernel': 'onehot_head_bwd',
    # Their paths past the first layouts: the GRU cell without a norm and
    # past D = 2 048, the head at other class counts, and rows of the norm
    # that the streaming kernels take.
    'gru_bare_fwd_kernel': 'gru_cell_fwd',
    'gru_bare_bwd_kernel': 'gru_cell_bwd',
    'gru_wide_fwd_kernel': 'gru_cell_fwd',
    'gru_wide_bwd_kernel': 'gru_cell_bwd',
    'onehot_any_fwd_kernel': 'onehot_head_fwd',
    'onehot_any_bwd_kernel': 'onehot_head_bwd',
    'ln_stream_fwd_kernel': 'layer_norm_act_fwd',
    'ln_stream_bwd_kernel': 'layer_norm_act_bwd',
    # The wide rows a block or a cluster a row (the GRU cell's forward and
    # both backwards), their LayerNorm's forward staged in shared memory,
    # and the head at other class counts with a lane's classes in
    # registers.
    'gru_block_fwd_kernel': 'gru_cell_fwd',
    'gru_cluster_bwd_kernel': 'gru_cell_bwd',
    'ln_cluster_bwd_kernel': 'layer_norm_act_bwd',
    'ln_staged_fwd_kernel': 'layer_norm_act_fwd',
    'onehot_group_fwd_kernel': 'onehot_head_fwd',
    'onehot_group_bwd_kernel': 'onehot_head_bwd',
}
# The other categories: the first pattern that matches the lowercased name.
CATEGORIES = (
    ('host_to_device', r'memcpy htod'),
    ('cast_copy', r'memcpy|memset|copy|aten::_?to\b|aten::_to_copy'),
    ('convolution', r'conv|cudnn|fprop|dgrad|wgrad|implicit|nchw|nhwc'),
    ('gemm', r'gemm|gemv|nvjet|cutlass|cublas|splitk|xmma'
             r'|aten::(addmm|mm|bmm|matmul|linear)\b'),
    ('layernorm', r'layer_?norm|gammabeta'),
    ('reduction', r'reduce|aten::(sum|mean|amax|amin|max|min|std|var|norm)\b'),
    ('elementwise', r'elementwise|aten::(add|sub|mul|div|neg|exp|log|tanh'
                    r'|sigmoid|elu|silu|relu|where|clamp|sqrt|pow|abs)_?\b'),
)


def categorize(name):
  """The category of a kernel (or, on the CPU, an operator) by its name:
  one of the port's kernels by the name of its wrapper, or one of
  CATEGORIES, or 'other'."""
  if name.startswith('gve_kernel'):  # Triton names the kernel after its
    return 'gve'                     # function.
  if '(anonymous namespace)::' in name:
    for function, kernel in OWN.items():
      if re.search(rf'::{function}\b', name):
        return kernel
  lowered = name.lower()
  for category, pattern in CATEGORIES:
    if re.search(pattern, lowered):
      return category
  return 'other'


OWN_NAMES = (*OWN.values(), 'gve')


def _totals(prof, on_card):
  """{name: (microseconds, count)} of a finished `torch.profiler` run. On
  the card: every kernel, copy and set on the device, read from the raw
  events (the profiler's own event tree takes minutes to build for a
  million launches). On the CPU: each operator's self time, which needs
  that tree."""
  import torch
  if not on_card:
    return {e.key: (e.self_cpu_time_total, e.count)
            for e in prof.key_averages() if e.self_cpu_time_total > 0}
  totals = collections.defaultdict(lambda: [0, 0])
  for event in prof.profiler.kineto_results.events():
    if (event.device_type() == torch.autograd.DeviceType.CUDA
        and not event.is_user_annotation()):
      total = totals[event.name()]
      total[0] += event.duration_ns() / 1e3
      total[1] += 1
  return totals


# The host's calls that put work on the device: a kernel, a copy, a set or
# a whole graph.
HOST_LAUNCH = re.compile(
    r'^(cuda|cu)(LaunchKernel\w*|LaunchCooperativeKernel\w*|GraphLaunch\w*'
    r'|Memcpy\w*Async\w*|Memset\w*Async\w*)$')


def host_launches(prof):
  """The launch calls the host made in a finished `torch.profiler` run on
  the card (CUDA API calls, `HOST_LAUNCH`)."""
  import torch
  return sum(
      1 for event in prof.profiler.kineto_results.events()
      if event.device_type() != torch.autograd.DeviceType.CUDA
      and HOST_LAUNCH.match(event.name()))


def summarize(prof, updates, on_card):
  """From a finished `torch.profiler` run over `updates` updates: the
  rows (each kernel, or on the CPU each operator, with its category, ms and
  launches per update, the most time first), the categories' sums in the
  same units, and the busy ms per update."""
  rows = sorted(({
      'name': name[:200], 'category': categorize(name),
      'ms_per_update': us / 1e3 / updates,
      'launches_per_update': count / updates}
      for name, (us, count) in _totals(prof, on_card).items()),
      key=lambda r: -r['ms_per_update'])
  busy = sum(r['ms_per_update'] for r in rows)
  sums = collections.defaultdict(lambda: [0.0, 0.0])
  for row in rows:
    sums[row['category']][0] += row['ms_per_update']
    sums[row['category']][1] += row['launches_per_update']
  categories = sorted(({
      'category': c, 'ms_per_update': ms, 'launches_per_update': n,
      'share': ms / busy if busy else None} for c, (ms, n) in sums.items()),
      key=lambda r: -r['ms_per_update'])
  return rows, categories, busy


def card():
  """The card's name and power limit as nvidia-smi gives them."""
  return subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True).stdout.strip().splitlines(
      )[0]


def resolve_device(device):
  import torch
  device = torch.device(device)
  if device.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError('No CUDA device is available; pass --device cpu to '
                       'run on the CPU.')
  return device


def build_agent(task, overrides, device):
  """The agent and a batch of one chunk per row, with the settings of the
  root `bench.py::build_agent` that mean something here: no weight decay,
  and only the last fused update's metrics packed. `overrides` may set
  `torch.graphs`."""
  import daydreamer_tpu_torch as ddp
  from daydreamer_tpu_torch.agents.dreamer import Agent
  from daydreamer_tpu_torch.envs import load_env
  config = ddp.Config(Agent.configs['defaults']).update({
      'env.parallel': 'none', r'.*\.wd$': 0.0,
      'torch.fused_metrics': 'last', 'torch.device': str(device),
      **overrides})
  env = load_env(task, amount=1, parallel='none', length=10)
  agent = Agent(env.obs_space, env.act_space, ddp.Counter(), config)
  B, T = config.batch_size, config.replay_chunk
  rng = np.random.default_rng(0)
  data = {}
  for key, space in env.obs_space.items():
    if key.startswith('log_'):
      continue
    if space.dtype == np.uint8:
      data[key] = rng.integers(0, 255, (B, T) + space.shape, np.uint8)
    else:
      data[key] = np.zeros((B, T) + space.shape, space.dtype)
  data['action'] = np.zeros((B, T) + env.act_space['action'].shape,
                            np.float32)
  data['is_first'][:, 0] = True
  data['reward'] = rng.uniform(0, 1, (B, T)).astype(np.float32)
  env.close()
  return agent, data


def fill_ring(agent, data):
  """A device ring of RING steps (blocks of BLOCK) filled with `data`'s
  rows, one after another, as often as it takes."""
  replay = agent.make_device_replay(capacity=RING, block=BLOCK)
  episode = {k: v.reshape((-1,) + v.shape[2:]) for k, v in data.items()}
  for _ in range(RING // len(episode['reward']) + 1):
    replay.add_steps(episode)
  assert replay.filled == RING, replay.filled
  return replay


def _dispatch(agent, replay, K, state):
  """One dispatch of K updates, ended by a fetch of the last model loss."""
  _, state, mets = agent.train_device(replay, K, state)
  loss = float(np.asarray(mets['model_loss_mean']).ravel()[-1])
  return state, loss


# Where an aten op's name and its kernel's name fall into different
# categories, the op takes its kernel's: a concatenation runs a copy
# kernel, an argmax a reduction, and the pointwise ops that CATEGORIES
# does not name (backward functions, comparisons, fills, random draws,
# indexing) run elementwise kernels. Only the ops that match none of
# these stay 'other', as their kernels do.
OP_CATEGORIES = (
    ('cast_copy', r'aten::(cat|stack|_local_scalar_dense)\b'),
    ('reduction', r'aten::(argmax|argmin|any|all|prod|logsumexp)\b'),
    ('other', r'aten::\w*(softmax|cumsum|cumprod|sort|topk|multinomial'
              r'|embedding|unique|nonzero)'),
)


def op_category(name):
  """The category of a row of a `CostMode` table: a kernel of the port by
  its own name, an aten op by the category of the kernel it launches."""
  if name in OWN_NAMES:
    return name
  category = categorize(name)
  if category != 'other' or not name.startswith('aten::'):
    return category
  for category, pattern in OP_CATEGORIES:
    if re.search(pattern, name):
      return category
  return 'elementwise'


def category_bytes(table):
  """{category: bytes} of a `CostMode` table, by `op_category`."""
  out = collections.Counter()
  for name, (_, _, nbytes) in table.items():
    out[op_category(name)] += nbytes
  return out


def bytes_report(agent, replay, state, task, overrides, categories):
  """The bytes of one update by category, the loop-path twin's and the
  profiled agent's, with the GB/s that the agent's bytes make over the
  device time of each of `categories` (None where there is none)."""
  from . import bench
  twin = bench.train_cost(task, overrides, agent.device)
  own = agent.train_device_cost(replay, 1, state)
  twin_bytes = category_bytes(twin['table'])
  own_bytes = category_bytes(own['table'])
  device_ms = {r['category']: r['ms_per_update'] for r in categories}
  rows = sorted(({
      'category': c, 'bytes_per_update': own_bytes.get(c, 0),
      'twin_bytes_per_update': twin_bytes.get(c, 0),
      'device_ms_per_update': device_ms.get(c),
      'gb_per_s': own_bytes.get(c, 0) / device_ms[c] / 1e6
      if device_ms.get(c) else None}
      for c in set(own_bytes) | set(twin_bytes) | set(device_ms)),
      key=lambda r: -r['bytes_per_update'])
  top = sorted(own['table'].items(), key=lambda x: -x[1][2])[:25]
  return {'bytes_per_update': own['bytes accessed'],
          'twin_bytes_per_update': twin['bytes'],
          'flops_per_update': own['flops'], 'twin_flops_per_update':
          twin['flops'], 'categories': rows,
          'top': [{'name': name, 'category': op_category(name),
                   'calls': calls, 'bytes': nbytes}
                  for name, (calls, _, nbytes) in top]}


def initial_launches(agent, replay, state):
  """Where the RSSM rebuilds its initial state at every step (`obs_step`
  calls `initial()`; XLA hoists it out of the JAX program's scan): its calls
  in one eager update (`train_device_cost`'s, which leaves the agent and
  the ring as they were) and the device kernels launched from inside them,
  each call in a `torch.profiler` range of its own. The backward of what
  they compute runs outside the ranges and is not counted. On the card."""
  import torch
  from torch.profiler import ProfilerActivity, profile, record_function
  from daydreamer_tpu_torch.models import nets
  inner, calls = nets.RSSM.initial, [0]

  def initial(self, *args, **kwargs):
    calls[0] += 1
    with record_function('rssm.initial'):
      return inner(self, *args, **kwargs)

  nets.RSSM.initial = initial
  try:
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      agent.train_device_cost(replay, 1, state)
      torch.cuda.synchronize()
  finally:
    nets.RSSM.initial = inner
  # A device event carries the id of the host operator that launched it.
  cuda = torch.autograd.DeviceType.CUDA
  events = list(prof.profiler.kineto_results.events())
  ranges = [(e.start_ns(), e.end_ns()) for e in events
            if e.device_type() != cuda and e.name() == 'rssm.initial']
  started = {e.correlation_id(): e.start_ns() for e in events
             if e.device_type() != cuda and e.linked_correlation_id() == 0}
  inside = sum(
      1 for e in events
      if e.device_type() == cuda and not e.is_user_annotation()
      and any(a <= started.get(e.linked_correlation_id(), -1) <= b
              for a, b in ranges))
  return {'calls_per_update': calls[0], 'launches_per_update': inside}


def parse_sets(pairs):
  """{key: value} of `--set KEY=VALUE` pairs: each value a Python literal
  where it reads as one (4096, 0.5, True), else the string."""
  sets = {}
  for pair in pairs:
    key, sep, value = pair.partition('=')
    if not sep or not key:
      raise ValueError(f'--set takes KEY=VALUE, not {pair!r}.')
    try:
      sets[key] = ast.literal_eval(value)
    except (ValueError, SyntaxError):
      sets[key] = value
  return sets


def profile_shape(shape, dispatches, K=None, device='cuda', graphs=True,
                  sets=None):
  """Trace `dispatches` warm dispatches at `shape`, graphed or eager;
  returns the report, with the bytes of an update under `bytes`
  (`bytes_report`). `K` replaces the shape's fused updates (the
  tests pass a small one); `sets` overrides config keys after the shape's
  own."""
  import torch
  from torch.profiler import ProfilerActivity, profile
  from daydreamer_tpu_torch.ops import build, lambda_returns
  del lambda_returns  # Imported to register its kernel's count.
  device = resolve_device(device)
  task, overrides, shape_k = SHAPES[shape]
  overrides = {**overrides, **(sets or {})}
  K = shape_k if K is None else K
  agent, data = build_agent(
      task, {**overrides, 'torch.graphs': bool(graphs)}, device)
  replay = fill_ring(agent, data)

  begin = time.perf_counter()
  state, _ = _dispatch(agent, replay, K, None)
  creation_s = time.perf_counter() - begin
  begin = time.perf_counter()
  for _ in range(2):
    state, _ = _dispatch(agent, replay, K, state)
  untraced_s = time.perf_counter() - begin

  on_card = device.type == 'cuda'
  activities = [ProfilerActivity.CPU] + (
      [ProfilerActivity.CUDA] if on_card else [])
  for kernel in build.KERNELS:
    kernel.launches = 0
  with profile(activities=activities) as prof:
    begin = time.perf_counter()
    for _ in range(dispatches):
      state, loss = _dispatch(agent, replay, K, state)
    wall_s = time.perf_counter() - begin
  launches = {k.name: k.launches for k in build.KERNELS}
  updates = dispatches * K
  rows, categories, busy = summarize(prof, updates, on_card)
  graph = agent.graphs.stats().get('train_device', {})
  wall = 1e3 * wall_s / updates
  untraced = 1e3 * untraced_s / (2 * K)
  counted = bytes_report(agent, replay, state, task, overrides,
                         categories if on_card else [])
  initial = initial_launches(agent, replay, state) if on_card else None
  return {
      'shape': shape, 'sets': sets or {}, 'fused_K': K,
      'dispatches': dispatches,
      'graphs': bool(graphs),
      'capture_s': graph.get('capture_s'),
      'pool_bytes': graph.get('pool_bytes'),
      'updates_traced': updates,
      'device': torch.cuda.get_device_name(device) if on_card else 'cpu',
      'card': card() if on_card else None,
      'timeline': 'cuda kernels, device time' if on_card else (
          'cpu operators, self time'),
      'creation_s': creation_s,
      'untraced_wall_ms_per_update': untraced,
      'wall_ms_per_update': wall,
      'device_busy_ms_per_update': busy if on_card else None,
      'idle_share': 1 - busy / wall if on_card else None,
      # The profiler slows the host and not the device: the device's idle
      # share at the untraced dispatches' pace.
      'idle_share_untraced': 1 - busy / untraced if on_card else None,
      # Device work executed, whoever launched it.
      'launches_per_update': sum(
          r['launches_per_update'] for r in rows) if on_card else None,
      # Launch calls from the host.
      'host_launches_per_update': host_launches(prof) / updates
      if on_card else None,
      'model_loss': loss,
      'wrapper_launches': launches,
      'categories': categories,
      'own_kernels': [r for r in rows if r['category'] in OWN_NAMES],
      'top': rows[:30],
      'bytes': counted,
      # The RSSM's initial state, rebuilt at each step of the loop path's
      # observe: its calls and the device kernels they launch an update.
      'initial': initial,
  }


def print_report(report):
  unit = 'device' if report['device_busy_ms_per_update'] is not None else (
      'cpu self')
  print(f"{report['shape']} {report['sets']} (K = {report['fused_K']}, "
        f"graphs "
        f"{report['graphs']}, "
        f"{report['updates_traced']} updates traced) on {report['device']} "
        f"({report['card']}): wall {report['wall_ms_per_update']:.3f} ms per "
        f"update traced, {report['untraced_wall_ms_per_update']:.3f} "
        f"untraced; device busy {report['device_busy_ms_per_update']} ms, "
        f"idle share {report['idle_share']} (untraced "
        f"{report['idle_share_untraced']}), launches "
        f"{report['launches_per_update']} per update executed on the device, "
        f"{report['host_launches_per_update']} launch calls from the host; "
        f"capture {report['capture_s']} s, pool {report['pool_bytes']} "
        f"bytes; wrapper launches "
        f"{report['wrapper_launches']}", flush=True)
  for row in report['categories']:
    print(f"  {row['ms_per_update']:9.3f} ms/update {unit} "
          f"{row['launches_per_update']:9.2f} launches/update  "
          f"{row['category']}", flush=True)
  for row in report['top']:
    print(f"  {row['ms_per_update']:9.3f} ms/update "
          f"{row['launches_per_update']:7.2f}/update  {row['category']:14s} "
          f"{row['name'][:90]}", flush=True)
  if report['initial'] is not None:
    print(f"RSSM.initial: {report['initial']['calls_per_update']} calls an "
          f"update, {report['initial']['launches_per_update']} device "
          f"kernels launched inside them (one eager update)", flush=True)
  counted = report['bytes']
  print(f"bytes an update: {counted['bytes_per_update']} (this agent, "
        f"train_device_cost), {counted['twin_bytes_per_update']} (the "
        f"loop-path twin, the bench's bytes_per_update)", flush=True)
  for row in counted['categories']:
    rate = row['gb_per_s']
    print(f"  {row['bytes_per_update'] / 1e9:10.4f} GB/update "
          f"{row['twin_bytes_per_update'] / 1e9:10.4f} GB twin  "
          f"{row['device_ms_per_update'] or 0:9.3f} ms  "
          f"{'-' if rate is None else f'{rate:9.1f}'} GB/s  "
          f"{row['category']}", flush=True)
  for row in counted['top']:
    print(f"  {row['bytes'] / 1e9:10.4f} GB/update {row['calls']:6d} "
          f"calls  {row['category']:14s} {row['name']}", flush=True)


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  parser.add_argument('--shape', default='xarm', choices=sorted(SHAPES))
  parser.add_argument('--dispatches', type=int, default=8)
  parser.add_argument('--graphs', default='True', choices=['True', 'False'])
  parser.add_argument('--out', default='')
  parser.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
  parser.add_argument('--set', action='append', default=[],
                      metavar='KEY=VALUE')
  args = parser.parse_args(argv)
  report = profile_shape(args.shape, args.dispatches, device=args.device,
                         graphs=args.graphs == 'True',
                         sets=parse_sets(args.set))
  print_report(report)
  if args.out:
    pathlib.Path(args.out).write_text(json.dumps(report, indent=1) + '\n')
  print(json.dumps(report), flush=True)
  return report


if __name__ == '__main__':
  main()

#!/usr/bin/env python3
"""Drive the PyTorch port (daydreamer_tpu_torch) on one NVIDIA GPU.

Run from the root of the repository with no arguments:

    python3 chip_smoke.py

Phases, each of which must pass:
  1. device  - print the card, and its name and power limit from nvidia-smi.
  2. build   - build every CUDA kernel from ops/csrc/ with nvcc (sm_90a).
  3. kernel  - hold each kernel against its plain PyTorch version at the
               xarm shape, in float32 and in bfloat16, and time both.
  4. slice   - the main path: the xarm `run=train` CLI in this process
               (`--rssm.impl scan --imag_impl pallas`), a few dozen updates,
               with every kernel's launch count set to 0 just before and
               read just after; every logged loss must be finite.
The line before the last lists the kernels as JSON; the last line is
{"ok": true, "device": {...}}. Without a card, or outside the repository,
the script exits non-zero and prints no result. `--phases` runs a subset.
"""

import argparse
import contextlib
import json
import math
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
PEAK_BF16 = 989e12   # H100 SXM dense bf16 FLOP/s (NVIDIA data sheet).
PEAK_F32 = 67e12     # H100 SXM float32 FLOP/s outside the tensor cores.
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s.

# The xarm configuration (agents/dreamer/configs.yaml): B*T = 32*32 rows,
# imag_horizon 15, deter = units = 512, 32x32 latents, 6 actions, three
# prior layers and a four-layer actor.
XARM = dict(B=1024, H=15, D=512, U=512, S=32, C=32, A=6, n_out=3, n_act=4)


def log(*args):
  print(*args, flush=True)


def cuda_time(fn, reps=10, warmup=2):
  import torch
  for _ in range(warmup):
    fn()
  begin = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  torch.cuda.synchronize()
  begin.record()
  for _ in range(reps):
    fn()
  end.record()
  torch.cuda.synchronize()
  return begin.elapsed_time(end) / reps


# --------------------------------------------------------------------------
# imagine_actor: inputs, bound, comparison.


def imagine_inputs(dtype, seed=0, **shape):
  """Random xarm-shaped weights and carries, made with numpy from a seed,
  uniform fan-in like the layers' initialization."""
  import torch
  s = dict(XARM, **shape)
  B, D, U, S, C, A = (s[k] for k in 'BDUSCA')
  SC = S * C
  rng = np.random.default_rng(seed)
  dev = torch.device('cuda')

  def t(x):
    return torch.as_tensor(np.asarray(x, np.float32)).to(dev, dtype)

  def w(k, n):
    lim = math.sqrt(3.0 / ((k + n) / 2))
    return t(rng.uniform(-lim, lim, (k, n)))

  def ln(n):
    return t(1 + 0.1 * rng.standard_normal(n)), t(0.1 * rng.standard_normal(n))

  params = {'stoch_n': S, 'classes': C}
  params['w_in_s'], params['w_in_a'] = w(SC, U), w(A, U)
  params['ln_in_scale'], params['ln_in_bias'] = ln(U)
  params['w_gru_d'], params['w_gru_x'] = w(D, 3 * D), w(U, 3 * D)
  params['ln_gru_scale'], params['ln_gru_bias'] = ln(3 * D)
  params['w_out'] = [w(D if i == 0 else U, U) for i in range(s['n_out'])]
  lns = [ln(U) for _ in range(s['n_out'])]
  params['ln_out_scale'] = [x[0] for x in lns]
  params['ln_out_bias'] = [x[1] for x in lns]
  params['w_st'], params['b_st'] = w(U, SC), t(rng.standard_normal(SC) * .1)
  lns = [ln(U) for _ in range(s['n_act'])]
  actor = {
      'w_d': w(D, U), 'w_s': w(SC, U),
      'w_h': [w(U, U) for _ in range(s['n_act'] - 1)],
      'ln_scale': [x[0] for x in lns], 'ln_bias': [x[1] for x in lns],
      'w_out': w(U, A), 'b_out': t(rng.standard_normal(A) * .1)}
  stoch0 = t(np.eye(C)[rng.integers(0, C, (B, S))].reshape(B, SC))
  deter0 = t(np.tanh(rng.standard_normal((B, D))))
  action0 = t(np.eye(A)[rng.integers(0, A, B)])
  gen = torch.Generator(device=dev).manual_seed(seed)
  return params, actor, stoch0, deter0, action0, gen


def imagine_bound(params, actor, stoch0, deter0, action0, H, dtype):
  """Least time for the rollout: the larger of its operations over the
  card's peak for the type and its bytes (inputs read once, outputs
  written once) over the memory rate."""
  import torch
  B, SC = stoch0.shape
  D, A = deter0.shape[1], action0.shape[1]
  S, U = params['stoch_n'], params['w_in_s'].shape[1]
  products = [params['w_in_a'], params['w_gru_d'], params['w_gru_x'],
              *params['w_out'], params['w_st'], actor['w_d'], *actor['w_h'],
              actor['w_out']]
  weights = products + [params['w_in_s'], actor['w_s']]
  # The stoch that the actor's w_s takes, and that w_in_s takes from step 1
  # on, is the rollout's own one-hot sample: a sum of S weight rows (S * U
  # adds), not a product. stoch0 @ w_in_s at step 0 is a product.
  flops = B * (2.0 * H * sum(x.numel() for x in products)
               + 2.0 * SC * U + (2 * H - 1) * S * U)
  vectors = [params['ln_in_scale'], params['ln_in_bias'],
             params['ln_gru_scale'], params['ln_gru_bias'], params['b_st'],
             *params['ln_out_scale'], *params['ln_out_bias'],
             *actor['ln_scale'], *actor['ln_bias'], actor['b_out']]
  item = torch.finfo(dtype).bits // 8
  bytes_in = item * sum(x.numel() for x in weights + vectors)
  bytes_in += item * (stoch0.numel() + deter0.numel() + action0.numel())
  bytes_in += 4 * H * B * (SC + A)                       # Gumbel noise.
  bytes_out = H * B * (item * (D + SC + A) + 4 * SC)  # Carries, logits.
  peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
  t_ops = flops / peak * 1e3
  t_bytes = (bytes_in + bytes_out) / PEAK_BYTES * 1e3
  bound_by = 'operations' if t_ops >= t_bytes else 'bytes'
  return max(t_ops, t_bytes), bound_by, flops, bytes_in + bytes_out


def phase_kernel():
  import torch
  from daydreamer_tpu_torch.ops import rssm
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  H = XARM['H']
  results = {}
  for dtype in (torch.float32, torch.bfloat16):
    params, actor, stoch0, deter0, action0, gen = imagine_inputs(dtype)
    B, SC = stoch0.shape
    noise = (rssm.gumbel((H, B, SC), gen, stoch0.device),
             rssm.gumbel((H, B, XARM['A']), gen, stoch0.device))
    args = (params, actor, stoch0, deter0, action0, H)
    kw = dict(noise=noise, unimix=0.01, act_unimix=0.1)
    out = rssm.imagine_actor_cuda(*args, **kw)
    torch.cuda.synchronize()
    ref = rssm.imagine_actor_plain(*args, **kw)
    d1, l1, s1, a1 = out
    d2, l2, s2, a2 = ref
    S, C, A = XARM['S'], XARM['C'], XARM['A']
    valid = bool((s1.float().reshape(H, B, S, C).sum(-1) == 1).all()
                 and (a1.float().sum(-1) == 1).all())
    same = (s1 == s2).all(-1) & (a1 == a2).all(-1)          # [H, B]
    agree = float(same.float().mean())
    # Rows whose whole history agrees so far take the same inputs.
    alive = torch.cumprod(same.int(), 0).bool()
    prev = torch.cat([torch.ones_like(alive[:1]), alive[:-1]], 0)
    err_d = float(((d1.float() - d2.float()).abs().amax(-1))[prev].max())
    err_l = float(((l1 - l2).abs().amax(-1))[prev].max())
    err0 = max(float((d1[0].float() - d2[0].float()).abs().max()),
               float((l1[0] - l2[0]).abs().max()))
    ms = cuda_time(lambda: rssm.imagine_actor_cuda(*args, **kw))
    plain_ms = cuda_time(lambda: rssm.imagine_actor_plain(*args, **kw),
                         reps=3, warmup=1)
    bound_ms, bound_by, flops, nbytes = imagine_bound(
        params, actor, stoch0, deter0, action0, H, dtype)
    name = str(dtype).split('.')[-1]
    if dtype == torch.float32:
      # The same float32 arithmetic summed in another order: a near tie in
      # a Gumbel-max choice may flip, then that row's history differs.
      tolerance = ('valid one-hots, >= 99.9 % of pairs agree, deters and '
                   'logits within 1e-3 on agreeing rows')
      ok = valid and agree >= 0.999 and err_d <= 1e-3 and err_l <= 1e-3
      max_err = max(err_d, err_l)
    else:
      # bf16 rounds each product and norm, so a rounding that differs can
      # flip a choice and the rows drift apart over the steps.
      tolerance = ('valid one-hots, step 0 within 5e-2, >= 90 % of pairs '
                   'agree, deters and logits within 5e-2 on agreeing rows')
      ok = (valid and err0 <= 5e-2 and agree >= 0.9 and err_d <= 5e-2
            and err_l <= 5e-2)
      max_err = max(err0, err_d, err_l)
    log(f'imagine_actor {name}: valid one-hots {valid}, agreeing '
        f'(step, row) pairs {agree:.6f}, max |d deter| {err_d:.3g}, '
        f'max |d logit| {err_l:.3g} on agreeing rows, step-0 error '
        f'{err0:.3g} (tolerance: {tolerance}); kernel {ms:.4f} ms, plain '
        f'{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; '
        f'{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)')
    if not ok:
      raise AssertionError(f'imagine_actor disagrees with its plain version '
                           f'in {name}.')
    results[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, max_abs_err=max_err)
  return results


# --------------------------------------------------------------------------


def phase_device():
  import torch
  if not torch.cuda.is_available():
    raise SystemExit('chip_smoke: no CUDA device; the port is measured on '
                     'the card only.')
  name = torch.cuda.get_device_name(0)
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True, check=True)
  log(f'device: {name}, {torch.cuda.device_count()} visible; torch '
      f'{torch.__version__}, CUDA {torch.version.cuda}')
  log(smi.stdout.strip().splitlines()[0])
  return name


def phase_build():
  from daydreamer_tpu_torch.ops import build
  begin = time.perf_counter()
  build.build_all()
  log(f'built {len(build.KERNELS)} kernel(s) in '
      f'{time.perf_counter() - begin:.1f} s')
  for kernel in build.KERNELS:
    for line in kernel.build_log().splitlines():
      if 'registers' in line or 'spill' in line:
        log(f'  {kernel.name}: {line.strip()}')


def phase_profile(updates=5):
  """Where an xarm update's time goes: torch.profiler over `updates`
  train steps (after three warm-up steps) on a random batch. Prints the
  wall time per update, the device's busy and idle share, and the kernels
  with the most device time. Not part of the default phases."""
  import torch
  from torch.profiler import ProfilerActivity, profile
  import daydreamer_tpu_torch as ddp
  from daydreamer_tpu_torch import envs
  from daydreamer_tpu_torch.agents.dreamer import Agent
  config = ddp.Config(Agent.configs['defaults']).update(
      Agent.configs['xarm']).update(
          {'rssm.impl': 'scan', 'imag_impl': 'pallas'})
  env = envs.load_env(config.task, **config.env)
  agent = Agent(env.obs_space, env.act_space, ddp.Counter(), config)
  rng = np.random.default_rng(0)
  B, T = config.batch_size, config.replay_chunk
  data = {}
  for key, space in env.obs_space.items():
    shape = (B, T) + space.shape
    if space.dtype == np.uint8:
      data[key] = rng.integers(0, 256, shape, np.uint8)
    elif space.dtype == bool:
      data[key] = np.zeros(shape, bool)
    else:
      data[key] = rng.standard_normal(shape).astype(space.dtype)
  A = env.act_space['action'].shape[0]
  data['action'] = np.eye(A, dtype=np.float32)[rng.integers(0, A, (B, T))]
  data['is_first'][:, 0] = True
  state = None
  for _ in range(3):
    _, state, mets = agent.train(data, state)
  torch.cuda.synchronize()
  activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
  with profile(activities=activities) as prof:
    begin = time.perf_counter()
    for _ in range(updates):
      _, state, mets = agent.train(data, state)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - begin) / updates
  env.close()
  # Kernel events only (the operators' rows would count their kernels
  # twice).
  kernels = [e for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
  device = lambda e: e.self_device_time_total
  busy = sum(device(e) for e in kernels) / 1e3 / updates
  log(f'profile: {wall * 1e3:.3f} ms wall per update, {busy:.3f} ms device '
      f'busy per update, idle share {1 - busy / (wall * 1e3):.3f}, '
      f'{sum(e.count for e in kernels) // updates} kernel launches per '
      f'update')
  for e in sorted(kernels, key=device, reverse=True)[:15]:
    log(f'  {device(e) / 1e3 / updates:9.3f} ms/update {e.count // updates:6d}'
        f' calls/update  {e.key[:90]}')


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument('--phases', default='device,build,kernel,slice')
  args = parser.parse_args(argv)
  phases = args.phases.split(',')
  import torch
  if not torch.cuda.is_available():
    print('chip_smoke: torch.cuda.is_available() is false.', file=sys.stderr)
    return 1
  sys.path.insert(0, str(ROOT))
  try:
    import daydreamer_tpu_torch  # noqa: F401
  except ImportError as e:
    print(f'chip_smoke: the port is not here ({e}).', file=sys.stderr)
    return 1
  from daydreamer_tpu_torch.ops import build
  name = phase_device()
  if 'build' in phases:
    phase_build()
  kernel = phase_kernel() if 'kernel' in phases else {}
  launches = {}
  if 'slice' in phases:
    launches = phase_slice()
  if 'profile' in phases:
    phase_profile()
  entries = []
  for k in build.KERNELS:
    timing = kernel.get('bfloat16', {})
    entries.append(dict(
        name=k.name, route='cuda',
        source=str(k.source.relative_to(ROOT)), replaces=k.replaces,
        launches=launches.get(k.name, 0),
        max_abs_err=timing.get('max_abs_err'), ms=timing.get('ms'),
        plain_ms=timing.get('plain_ms'), bound_ms=timing.get('bound_ms'),
        bound_by=timing.get('bound_by'), library_ms=None))
  log(json.dumps({'kernels': entries}))
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': name,
      'count': torch.cuda.device_count()}}), flush=True)
  return 0


SLICE_ARGS = [
    '--configs', 'xarm', '--rssm.impl', 'scan', '--imag_impl', 'pallas',
    '--run', 'train', '--train.train_fill', '200', '--train.steps', '400',
    '--train.eval_every', '200', '--train.log_every', '100']


def phase_slice(extra=()):
  """The main path: the xarm run=train CLI in this process. Returns the
  launches of every kernel in this run."""
  import torch
  from daydreamer_tpu_torch.agents.dreamer import torchagent, train
  from daydreamer_tpu_torch.ops import build
  times = {'train': [], 'policy': []}
  originals = {}

  def timed(name):
    inner = getattr(torchagent.TorchAgent, name)
    originals[name] = inner

    def call(self, *args, **kwargs):
      begin = time.perf_counter()
      out = inner(self, *args, **kwargs)
      if self.device.type == 'cuda':
        torch.cuda.synchronize()
      times[name].append(time.perf_counter() - begin)
      return out
    setattr(torchagent.TorchAgent, name, call)

  logdir = ROOT / 'runs' / f'chip_smoke_{time.strftime("%Y%m%d_%H%M%S")}'
  for name in times:
    timed(name)
  for kernel in build.KERNELS:
    kernel.launches = 0
  logdir.mkdir(parents=True)
  log(f'slice: the CLI writes its output to {logdir / "cli.log"}')
  try:
    with open(logdir / 'cli.log', 'w') as out, (
        contextlib.redirect_stdout(out)):
      train.main([*SLICE_ARGS, '--logdir', str(logdir), *extra])
  finally:
    for name, inner in originals.items():
      setattr(torchagent.TorchAgent, name, inner)
  launches = {k.name: k.launches for k in build.KERNELS}
  # The training losses; the balance diagnostics (`reward_neg_loss`, ...)
  # are NaN by design when a batch holds no example of a class.
  rows = [json.loads(line) for line in
          (logdir / 'metrics.jsonl').read_text().splitlines()]
  losses = [(k, v) for row in rows for k, v in row.items()
            if k.startswith('train/')
            and k.endswith(('_opt_loss', '_loss_mean'))]
  log(f'slice: {len(times["train"])} updates, {len(times["policy"])} '
      f'policy steps, launches {launches}, last logged losses '
      f'{dict(losses)}')
  bad = [(k, v) for k, v in losses if not math.isfinite(v)]
  if not losses or bad:
    raise AssertionError(f'slice: no loss logged, or one not finite: {bad}')
  for name, count in launches.items():
    if not count:
      raise AssertionError(f'slice: kernel {name} was never launched.')
  # The first call of each entry point carries the creation pass.
  train_s, policy_s = times['train'][1:], times['policy'][1:]
  log(f'slice: {len(train_s) / sum(train_s):.3f} updates/s over '
      f'{len(train_s)} updates, policy step {1e3 * np.mean(policy_s):.3f} ms '
      f'mean over {len(policy_s)} steps')
  return launches


if __name__ == '__main__':
  sys.exit(main())

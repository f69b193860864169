#!/usr/bin/env python3
"""Drive the PyTorch port (daydreamer_tpu_torch) on one NVIDIA GPU.

Run from the root of the repository with no arguments:

    python3 chip_smoke.py

Phases, each of which must pass:
  1. device  - print the card, and its name and power limit from nvidia-smi.
  2. build   - build every CUDA kernel from ops/csrc/ with nvcc (sm_90a),
               all at once.
  3. kernel  - hold each kernel (imagine_actor, observe_fwd, observe_bwd,
               imagine, observe, gve) against its plain PyTorch version at
               the xarm shape, in float32 and in bfloat16 (gve: float32),
               and time both; in float32 also the whole fused observe
               gradient against autograd of a plain loop. It prints how
               many thread block clusters of observe_fwd's and observe's
               chains fit the card at once, and the device time of each
               CUDA kernel that a call of observe and of gve launches
               (torch.profiler).
  4. slice   - the training path: the xarm `run=train` CLI in this process
               at its default config (`rssm.impl: pallas`) with `--imag_impl
               pallas`, a few dozen updates, with every kernel's launch
               count set to 0 just before and read just after; every logged
               loss must be finite. Then the same run with `--rssm.impl
               scan`, the loop path, for its updates/s beside the first.
  5. proof   - the proof path: `scripts/pallas_proof.py --which all` in
               this process, which runs imagine, observe and gve at the a1
               and xarm shapes; counts set to 0 before and read after.
  6. learner - the learner path: `run.learning` on xarm at its default
               config from a replay prefilled in this process, 48 updates in
               three dispatches of `train_fused: 16` from a device-resident
               ring of 2e4 steps; then the same with `replay: prio`, the
               prioritized ring. Counts set to 0 before each and read after.
  7. a1      - the paper's A1 config (`--configs a1 --task a1_dummy`,
               `run=train`, cut in length as the xarm slice is) through the
               CLI three times, counts set to 0 before each and read after:
               as the config file has it, the loop path, where no kernel may
               launch; with `--rssm.impl pallas`, where observe_fwd and
               observe_bwd must launch once an update; and with
               `--data_loader native`, where the native batcher must run on
               the library that g++ builds into native/_build/. Each logs
               its updates/s, its policy step at batch 1 and its last
               losses, which must be finite.
  8. explore - the rest of the agent at xarm's full width, through the CLI
               as the slice (200 steps of fill, then 200 policy steps, about
               50 updates), counts set to 0 before each run and read after:
               `--configs xarm plan2explore` (Explore with the extrinsic
               reward and an ensemble of 8 disagreement heads beside the
               Greedy task behavior), where imagine_actor must launch twice
               an update, observe_fwd and observe_bwd once, every `expl_`
               loss must be finite and every policy step must run
               Explore's actor; `--task_behavior DisagWhen`, where
               imagine_actor must launch twice an update and the
               disagreement buffer must lie on the card and hold states;
               and `--torch.policy_devices cpu --torch.policy_sync 20`,
               where the kernels launch on the card while the policy runs
               on the host-CPU mirror, which must have refreshed more than
               once. Each logs its updates/s and policy step; the mirror's
               host policy step is logged beside the card's from the slice.
  9. parallel - data-parallel training: two ranks of the port's
               `scripts/multihost_worker.py` share the card over gloo at
               xarm's full width (global batch 32, 16 rows a rank, chunk
               32, imag_horizon 15, `rssm.impl: pallas`, `--imag_impl
               pallas`, bfloat16), 3 timed dispatches of 4 fused updates
               after one that creates the state; then one rank over NCCL
               (world 1) with the same settings. Each rank must exit 0,
               the two ranks' losses must be finite and equal and their
               state checksums equal, and each rank must have launched
               observe_bwd and imagine_actor once an update and observe_fwd
               at least once. Each rank's launches go on the kernels line
               under `launches_parallel`, apart from the slice's and the
               proof's under `launches`. On the card only the replicas'
               agreement is checked: that the update's reductions combine
               the ranks as the JAX program's global batch does is checked
               against the JAX package on the CPU
               (tests/test_torch_multihost.py). Neither rate is a scaling
               figure: two ranks share one card.
 10. imitation - the imitation trainer's PPO learner (imitation/ppo.py) at
               imitation/train.py's defaults on the card: observations of
               30 (A1's 16 proprio values and the task's 14 target
               features), 12 actions, a rollout of 2048 batch-1 `act`
               calls, then `gae` and two `update`s of 10 epochs x 4
               minibatches of 512 (the first and a warm one); each timed.
               The card's machine has no MuJoCo, so the proprio part comes
               from a generator seeded by `--seed` and the targets from the
               trot clip at the sim's times. The update's metrics must be
               finite; the loss and its gradients on one minibatch must
               agree with a CPU agent loaded from the card's `save()`
               within 1e-4 of the largest magnitude, and so must that
               agent's values.
 11. tooling - the port's two instruments, as subprocesses:
               `scripts/profile_train.py --shape xarm --dispatches 2` (80
               updates from the device ring, 32 traced), whose trace must
               show observe_fwd's three device functions and observe_bwd's
               one launched once an update and a device busy time under
               the wall time; its wrappers' launches go on the kernels line
               under `launches_profile`. Then `scripts/policy_latency.py`
               at `--shape a1` and `--shape test`, on the card and on the
               host mirror; the card's whole policy call at a1 must take
               under 50 ms.
 12. soak    - the paper's deployment: the port's `scripts/async_soak.py`
               as a subprocess for 2 minutes, `run=learning` on the card
               (`--configs a1 --rssm.impl pallas` on a1_dummy, so the
               learner trains through observe_fwd and observe_bwd) and
               `run=acting` on the CPU (a1_dummy: the card's machine has no
               MuJoCo) as two OS processes over ZMQ. All five gates of its
               summary must pass (the actor's policy step within 50 ms, the
               steady sync age within 2 x sync_every, replay growth, a
               trained learner, a clean SIGINT shutdown within 90 s), the
               learner's resolved config, as its log prints it, must read
               `rssm.impl: pallas` and `torch.device: cuda`, and the
               launches that the learner process prints at its end must
               hold observe_fwd and observe_bwd at least once for each of
               its updates; they go on the kernels line under
               `launches_soak`.
The kernel phase also holds observe_fwd and observe_bwd at the a1 training
shape (T = B = 32, D = U = 256, E = 512, 12 continuous actions), and
observe_fwd, observe_bwd and imagine_actor at the rows of one rank of the
parallel phase (xarm, T x B = 32 x 16, so 512 rows start the rollout),
against their plain versions.
The line before the last lists the kernels as JSON; the last line is
{"ok": true, "device": {...}}. Without a card, or outside the repository,
the script exits non-zero and prints no result. `--phases` runs a subset;
the extra phase `profile` (not run by default) prints where an update's
device time goes, its launches and the device's idle share, and
`profile_explore` the same for `--configs xarm plan2explore`; the extra
phase `sphero` (not run by default) trains `--configs sphero` (its dummy
task, whose tracker and resize need OpenCV) as the slice trains xarm; the
extra phase `imitation_sim` (not run by default) runs the imitation
trainer on the card with its MuJoCo sim, 4096 steps in rollouts of 2048,
and fails where MuJoCo is missing; the extra phase `curve` (not run by
default) trains a robot config block as its file has it, `--configs NAME
--task NAME_dummy --run train --seed 0` for `--curve-steps` env steps
(21 400 by default: the span of the JAX package's xarm curve), NAME from
`--curve-config` (xarm, ur5 or sphero). observe_fwd and observe_bwd must
launch once an update (the kernels line's `launches_curve`) and every
logged loss must be finite. It exports the episode returns through the
port's `scripts/scores.py` to `scores/NAME_dreamer_torch.json` with the
provenance in `scores/provenance/NAME_torch_seed0/` (config.yaml,
metrics.jsonl, scores.jsonl, RUN.json), and prints the final-10 % mean
beside that of the JAX package's curve `scores/NAME_dreamer_tpu.json`.

`--compare NAME=SOURCE` (NAME one of imagine_actor, imagine, observe,
observe_fwd, observe_bwd; the option may be given several times) runs no
phase and prints no result line: it builds the kernel's source in the tree
and the other version of it in the file SOURCE (its includes beside it),
runs both on the xarm inputs of the kernel check, says whether their
outputs are equal bit for bit, and times them in turns (tree, other, other,
tree) in bfloat16 and float32 (observe at the xarm and a1 shapes of the proof
entry point): how a change to a kernel is held against its parent inside one
run.
"""

import argparse
import contextlib
import json
import math
import pathlib
import re
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
XARM_OBSERVE = dict(D=512, U=512, S=32, C=32, A=6, n_out=3, discrete=True)
XARM_OBSERVE_RANK = 16  # xarm's batch of 32 over the parallel phase's ranks.
# The rollout's start rows in one rank of the parallel phase: T x B.
XARM_IMAGINE_RANK = 32 * XARM_OBSERVE_RANK


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


def first_flips(out, ref, noise, actor, unimix, act_unimix):
  """Where each row's choices first differ from the plain version's, and
  by how much the plain version's Gumbel-perturbed scores there prefer its
  own choice over the kernel's: (steps, gaps), one entry per row whose
  choices differ. Until that step the row took the same inputs in both,
  so a gap near 0 is a near tie, which another order of summation flips."""
  from daydreamer_tpu_torch.ops import rssm
  _, l1, s1, a1 = out
  d2, l2, s2, a2 = ref
  S, C = XARM['S'], XARM['C']
  same = (s1 == s2).all(-1) & (a1 == a2).all(-1)          # [H, B]
  alogits = {}  # The plain actor's scores at a step, over all rows.
  steps, gaps = [], []
  for b in (~same).any(0).nonzero().flatten().tolist():
    t = int((~same[:, b]).nonzero()[0])
    if not bool((s1[t, b] == s2[t, b]).all()):
      scores = (rssm._mixed_logprobs(l2[t, b].reshape(S, C), unimix)
                + noise[0][t, b].reshape(S, C))
      mine = s2[t, b].reshape(S, C).argmax(-1, keepdim=True)
      theirs = s1[t, b].reshape(S, C).argmax(-1, keepdim=True)
      gap = (scores.gather(-1, mine) - scores.gather(-1, theirs)).max()
    else:
      if t not in alogits:
        alogits[t] = rssm._mixed_logprobs(
            rssm._actor_cell(s2[t], d2[t], actor), act_unimix) + noise[1][t]
      scores = alogits[t][b]
      gap = scores[a2[t, b].argmax()] - scores[a1[t, b].argmax()]
    steps.append(t)
    gaps.append(float(gap))
  return steps, gaps


def check_imagine_actor(at='xarm', **shape):
  """imagine_actor against its plain version at xarm's widths (`shape`
  overrides, e.g. the rows B), in float32 and bfloat16."""
  import torch
  from daydreamer_tpu_torch.ops import rssm
  H = XARM['H']
  results = {}
  for dtype in (torch.float32, torch.bfloat16):
    params, actor, stoch0, deter0, action0, gen = imagine_inputs(
        dtype, **shape)
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
    steps, gaps = first_flips(out, ref, noise, actor, kw['unimix'],
                              kw['act_unimix'])
    flips = (f'{len(steps)} rows diverge, first at steps {steps[:8]}, where '
             f'the plain scores differ by at most '
             f'{max(gaps, default=0):.3g}')
    if dtype == torch.float32:
      # The same float32 arithmetic summed in another order: a near tie in
      # a Gumbel-max choice may flip, then that row's history differs. Each
      # flip must be such a tie, and at most one choice in a thousand may
      # flip. At xarm's 1024 rows also >= 99.9 % of the (step, row) pairs
      # must agree; at fewer rows one tie flipped early in the horizon
      # makes more than 0.1 % of the pairs differ by itself.
      tolerance = ('valid one-hots, every row that diverges first differs '
                   'where the plain scores of the two choices lie within '
                   '1e-4, at most 0.1 % of the choices flip, '
                   + ('>= 99.9 % of pairs agree, ' if B == XARM['B'] else '')
                   + 'deters and logits within 1e-3 on agreeing rows')
      ok = (valid and max(gaps, default=0) <= 1e-4
            and len(steps) <= 1e-3 * same.numel()
            and (agree >= 0.999 or B != XARM['B'])
            and err_d <= 1e-3 and err_l <= 1e-3)
      max_err = max(err_d, err_l)
    else:
      # bf16 rounds each product and norm, so a rounding that differs can
      # flip a choice and the rows drift apart over the steps.
      tolerance = ('valid one-hots, step 0 within 5e-2, >= 90 % of pairs '
                   'agree, deters and logits within 5e-2 on agreeing rows')
      ok = (valid and err0 <= 5e-2 and agree >= 0.9 and err_d <= 5e-2
            and err_l <= 5e-2)
      max_err = max(err0, err_d, err_l)
    log(f'imagine_actor {at} (B = {B}) {name}: valid one-hots {valid}, '
        f'agreeing '
        f'(step, row) pairs {agree:.6f}, max |d deter| {err_d:.3g}, '
        f'max |d logit| {err_l:.3g} on agreeing rows, step-0 error '
        f'{err0:.3g}; {flips} (tolerance: {tolerance}); kernel '
        f'{ms:.4f} ms, plain '
        f'{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; '
        f'{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)')
    if not ok:
      raise AssertionError(f'imagine_actor disagrees with its plain version '
                           f'in {name} at {at} (B = {B}).')
    results[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, max_abs_err=max_err)
  return results


# --------------------------------------------------------------------------
# The fused observe chain: shape, inputs, bounds, comparison.


# The a1 configuration's world-model update with `rssm.impl: pallas`: T x B
# = 32 x 32 rows of the replay chunk, deter = units = 256, 32x32 latents,
# 12 continuous actions, and E = 512, the MLP encoder's width over the
# proprio vector.
A1_OBSERVE = dict(T=32, B=32, D=256, U=256, S=32, C=32, A=12, E=512,
                  n_out=3, discrete=False)


def observe_shape(name, expect, **update):
  """The widths of the world-model update's observe chain, read from an
  agent of the config block `name` (with `update`) with the fused observe
  chain: T x B rows of the replay chunk, the RSSM's widths, E, the
  encoder's output width, and whether the actions are one-hots. Each of
  `expect` must match."""
  import daydreamer_tpu_torch as ddp
  from daydreamer_tpu_torch import envs
  from daydreamer_tpu_torch.agents.dreamer import Agent
  config = ddp.Config(Agent.configs['defaults']).update(
      Agent.configs[name]).update(update)
  env = envs.load_env(config.task, **config.env)
  try:
    agent = Agent(env.obs_space, env.act_space, ddp.Counter(), config)
    agent._create()
  finally:
    env.close()
  rssm = agent.agent.wm.rssm
  kernel = lambda path: tuple(
      rssm.get_submodule(path)._parameters['kernel'].shape)
  D, S, C = rssm._deter, rssm._stoch, rssm._classes
  shape = dict(
      T=config.replay_chunk, B=config.batch_size, D=D,
      U=kernel('img_in')[1], S=S, C=C, A=kernel('img_in')[0] - S * C,
      E=kernel('obs_out')[0] - D, n_out=rssm._prior_layers,
      discrete=bool(env.act_space['action'].discrete), unimix=rssm._unimix)
  for key, value in expect.items():
    assert shape[key] == value, (key, shape, expect)
  assert rssm._impl == 'pallas', shape
  return shape


def observe_inputs(dtype, shape, seed=0):
  """Random weights and one chunk of inputs at `shape`, made with numpy
  from a seed: uniform fan-in weights, one-hot stoch0, one-hot actions or
  (`shape['discrete']` false) continuous ones uniform in [-1, 1], unit
  normal embeds, is_first on most rows at step 0 and on a few inside the
  chunk, Gumbel noise, and four cotangents."""
  import torch
  T, B, D, U, S, C, A, E = (shape[k] for k in 'TBDUSCAE')
  SC = S * C
  params, _, stoch0, deter0, _, _ = imagine_inputs(
      dtype, seed, B=B, D=D, U=U, S=S, C=C, A=A, n_out=shape['n_out'])
  rng = np.random.default_rng(seed + 1)
  dev = torch.device('cuda')

  def t(x, dtype=dtype):
    return torch.as_tensor(np.asarray(x, np.float32)).to(dev, dtype)

  def w(k, n):
    lim = math.sqrt(3.0 / ((k + n) / 2))
    return t(rng.uniform(-lim, lim, (k, n)))

  params['w_obs_d'], params['w_obs_e'] = w(D, U), w(E, U)
  params['ln_obs_scale'] = t(1 + 0.1 * rng.standard_normal(U))
  params['ln_obs_bias'] = t(0.1 * rng.standard_normal(U))
  params['w_post'], params['b_post'] = w(U, SC), t(rng.standard_normal(SC) * .1)
  if shape.get('discrete', True):
    actions = t(np.eye(A)[rng.integers(0, A, (T, B))])
  else:
    actions = t(rng.uniform(-1, 1, (T, B, A)))
  embeds = t(rng.standard_normal((T, B, E)))
  first = np.zeros((T, B), bool)
  first[0, :B - B // 4] = True
  first[rng.integers(1, T, B // 4), rng.integers(0, B, B // 4)] = True
  is_first = torch.as_tensor(first).to(dev)
  noise = t(rng.gumbel(size=(T, B, SC)), torch.float32)
  # Cotangents of the size a mean loss over the chunk hands down.
  cts = [t(rng.standard_normal((T, B, n)) / (T * B), torch.float32)
         for n in (D, SC, SC, SC)]
  return params, (stoch0, deter0, actions, embeds), is_first, noise, cts


def _numel(xs):
  return sum(x.numel() for x in xs)


def observe_bounds(params, data, is_first, dtype):
  """Least times of the forward and the backward chain: the larger of the
  operations over the card's peak for the type and the bytes (each input
  read once, each output written once) over the memory rate. The product
  of `w_in_s` with the chain's own one-hot (steps 1 .. T-1) is a gather of
  S rows, S * U adds; with stoch0 (step 0) it is a product."""
  import torch
  stoch0, deter0, actions, embeds = data
  T, B, A = actions.shape
  SC, U = params['w_in_s'].shape
  D, S, E = deter0.shape[1], params['stoch_n'], embeds.shape[-1]
  n_out = len(params['w_out'])
  item = torch.finfo(dtype).bits // 8
  peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
  cell = [params['w_in_a'], params['w_gru_d'], params['w_gru_x'],
          *params['w_out']]
  cell_vectors = [params['ln_in_scale'], params['ln_in_bias'],
                  params['ln_gru_scale'], params['ln_gru_bias'],
                  *params['ln_out_scale'], *params['ln_out_bias']]
  obs_vectors = [params['ln_obs_scale'], params['ln_obs_bias']]
  stoch_ops = B * (2.0 * SC * U + (T - 1) * S * U)
  bounds = {}
  # Forward.
  products = cell + [params['w_st'], params['w_obs_d'], params['w_obs_e'],
                     params['w_post']]
  flops = 2.0 * T * B * _numel(products) + stoch_ops
  weights = products + [params['w_in_s']] + cell_vectors + obs_vectors + [
      params['b_st'], params['b_post']]
  nbytes = item * (_numel(weights) + _numel(data))
  nbytes += 4 * T * B + 4 * T * B * SC                    # is_first, noise.
  nbytes += T * B * (item * (D + SC) + 2 * 4 * SC)        # The four outputs.
  bounds['observe_fwd'] = (flops, nbytes)
  # Backward: the recomputed cell and z2's deter half, then every
  # transposed product.
  recomputed = cell + [params['w_obs_d']]
  transposed = [params['w_post'], params['w_obs_d'], params['w_st'],
                *params['w_out'], params['w_gru_x'], params['w_gru_d'],
                params['w_in_s']]
  flops = 2.0 * T * B * (_numel(recomputed) + _numel(transposed)) + stoch_ops
  weights = cell + [params['w_in_s'], params['w_st'], params['w_obs_d'],
                    params['w_post']] + cell_vectors + obs_vectors
  nbytes = item * (_numel(weights) + _numel([stoch0, deter0, actions]))
  nbytes += 4 * T * B                                      # is_first.
  nbytes += T * B * (item * (U + D + SC) + 4 * SC)  # e_proj, saved forward.
  nbytes += 4 * T * B * (D + 3 * SC)                       # Cotangents.
  nbytes += 4 * T * B * ((4 + 2 * n_out) * U + 6 * D + SC)  # Adjoints.
  nbytes += 4 * B * (SC + D)                               # ds0, dd0.
  bounds['observe_bwd'] = (flops, nbytes)
  out = {}
  for name, (flops, nbytes) in bounds.items():
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    out[name] = dict(
        bound_ms=max(t_ops, t_bytes),
        bound_by='operations' if t_ops >= t_bytes else 'bytes',
        flops=flops, nbytes=nbytes)
  return out


def _scaled_errors(got, want):
  """Largest |got - want| over the largest |want|, per tensor."""
  errs = []
  for g, w in zip(got, want):
    pairs = zip(g, w) if isinstance(g, (list, tuple)) else [(g, w)]
    for gi, wi in pairs:
      scale = max(1e-12, float(wi.float().abs().max()))
      errs.append(float((gi.float() - wi.float()).abs().max()) / scale)
  return errs


ADJOINTS = ('dz1', 'dn1', 'dzg', 'dng', 'dz2', 'dn2', 'dq', 'dm',
            'dpl_total', 'ds0', 'dd0')


def check_observe(shape, at='xarm'):
  """observe_fwd and observe_bwd against their plain versions at `shape`
  (its name `at` on every line), in float32 and bfloat16; in float32 also
  the whole gradient through ObserveFused."""
  import torch
  from daydreamer_tpu_torch.ops import rssm_vjp as ops
  T, B, S, C = (shape[k] for k in 'TBSC')
  unimix = shape['unimix']
  results = {'observe_fwd': {}, 'observe_bwd': {}}
  dims = [shape[k] for k in ('T', 'B', 'A', 'E', 'D', 'U', 'S', 'C', 'n_out')]
  fit = ops.observe_fwd_clusters(torch.bfloat16, *dims)
  log(f'observe_fwd {at}: one call launches 3 CUDA kernels (embed product, '
      f'chain, prior head); clusters of the chain that fit the card at once '
      f'(cudaOccupancyMaxActiveClusters, bfloat16): {fit[0]} of 4 blocks, '
      f'{fit[1]} of 8; it needs {(B + 1) // 2}, one per pair of rows')
  for dtype in (torch.float32, torch.bfloat16):
    name = str(dtype).split('.')[-1]
    params, data, is_first, noise, cts = observe_inputs(dtype, shape)
    bounds = observe_bounds(params, data, is_first, dtype)
    args = (params, *data, is_first)
    kw = dict(noise=noise, unimix=unimix, sample=True)

    # ---- Forward: kernel against observe_fwd_plain on shared noise.
    out = ops.observe_fwd_cuda(*args, **kw)
    torch.cuda.synchronize()
    ref = ops.observe_fwd_plain(*args, **kw)
    d1, po1, pr1, s1 = out
    d2, po2, pr2, s2 = ref
    valid = bool((s1.float().reshape(T, B, S, C).sum(-1) == 1).all()
                 and (s1.float().amax(-1) == 1).all())
    same = (s1 == s2).all(-1)                                # [T, B]
    agree = float(same.float().mean())
    # Rows whose whole history agrees so far take the same inputs.
    alive = torch.cumprod(same.int(), 0).bool()
    prev = torch.cat([torch.ones_like(alive[:1]), alive[:-1]], 0)
    err_d = float((d1.float() - d2.float()).abs().amax(-1)[prev].max())
    err_l = float(torch.maximum(
        (po1 - po2).abs().amax(-1), (pr1 - pr2).abs().amax(-1))[prev].max())
    err0 = max(float((d1[0].float() - d2[0].float()).abs().max()),
               float((po1[0] - po2[0]).abs().max()),
               float((pr1[0] - pr2[0]).abs().max()))
    if dtype == torch.float32:
      # The same float32 arithmetic summed in another order: a near tie in
      # a Gumbel-max choice may flip, then that row's history differs.
      tolerance = ('valid one-hots, >= 99.9 % of pairs agree, deters and '
                   'logits within 1e-3 on agreeing rows')
      ok = valid and agree >= 0.999 and max(err_d, err_l, err0) <= 1e-3
    else:
      # Both sides compute in float32 from the same bf16 weights, but a
      # deter that lands on the other side of a bf16 rounding boundary
      # (one unit in the last place, 2^-8 below 1) enters the next step's
      # products and moves its logits.
      tolerance = ('valid one-hots, step 0 within 1e-3, >= 98 % of pairs '
                   'agree, deters within 8e-3 (two bf16 units) and logits '
                   'within 2e-2 on agreeing rows')
      ok = (valid and err0 <= 1e-3 and agree >= 0.98 and err_d <= 8e-3
            and err_l <= 2e-2)
    ms = cuda_time(lambda: ops.observe_fwd_cuda(*args, **kw))
    plain_ms = cuda_time(lambda: ops.observe_fwd_plain(*args, **kw),
                         reps=3, warmup=1)
    bound = bounds['observe_fwd']
    log(f'observe_fwd {at} {name}: valid one-hots {valid}, agreeing (step, '
        f'row) pairs {agree:.6f}, max |d deter| {err_d:.3g}, max |d logit| '
        f'{err_l:.3g} on agreeing rows, step-0 error {err0:.3g} (tolerance: '
        f'{tolerance}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound '
        f'{bound["bound_ms"]:.4f} ms ({bound["bound_by"]}; '
        f'{bound["flops"] / 1e9:.2f} GFLOP, {bound["nbytes"] / 1e6:.1f} MB)')
    if not ok:
      raise AssertionError(f'observe_fwd disagrees with its plain version '
                           f'at {at} in {name}.')
    results['observe_fwd'][name] = dict(
        ms=ms, plain_ms=plain_ms, bound_ms=bound['bound_ms'],
        bound_by=bound['bound_by'], max_abs_err=max(err0, err_d, err_l))

    # ---- Backward: kernel against observe_bwd_plain on the SAME saved
    # forward (the kernel's), so the samples cannot differ.
    stoch0, deter0, actions, embeds = data
    e_proj = (embeds.float() @ params['w_obs_e'].float()).to(dtype)
    bargs = (params, stoch0, deter0, actions, e_proj, is_first, d1, po1, s1,
             cts)
    got = ops.observe_bwd_cuda(*bargs, unimix=unimix)
    torch.cuda.synchronize()
    want = ops.observe_bwd_plain(*bargs, unimix=unimix)
    errs = _scaled_errors(got, want)
    finite = all(bool(torch.isfinite(x).all()) for g in got
                 for x in (g if isinstance(g, list) else [g]))
    worst = max(errs)
    abs_err = max(
        float((gi - wi).abs().max()) for g, w in zip(got, want)
        for gi, wi in (zip(g, w) if isinstance(g, list) else [(g, w)]))
    # Both routes take the same inputs and compute in float32, in another
    # order of summation, through up to 32 steps of carried gradients. A
    # dropped (1 - unimix) factor moves an adjoint by 3e-3 of its scale, so
    # the limit lies well under that.
    limit = 1e-4
    tolerance = (f'every emitted adjoint, ds0 and dd0 finite and within '
                 f'{limit:g} of its largest entry')
    ok = finite and worst <= limit
    ms = cuda_time(lambda: ops.observe_bwd_cuda(*bargs, unimix=unimix))
    plain_ms = cuda_time(
        lambda: ops.observe_bwd_plain(*bargs, unimix=unimix), reps=3,
        warmup=1)
    bound = bounds['observe_bwd']
    log(f'observe_bwd {at} {name}: finite {finite}, worst scaled error '
        f'{worst:.3g} over {len(errs)} tensors ({ADJOINTS}), largest '
        f'absolute error {abs_err:.3g} (tolerance: {tolerance}); kernel '
        f'{ms:.4f} ms, plain {plain_ms:.4f} ms, bound '
        f'{bound["bound_ms"]:.4f} ms ({bound["bound_by"]}; '
        f'{bound["flops"] / 1e9:.2f} GFLOP, {bound["nbytes"] / 1e6:.1f} MB)')
    if not ok:
      raise AssertionError(f'observe_bwd disagrees with its plain version '
                           f'at {at} in {name}: {errs}')
    results['observe_bwd'][name] = dict(
        ms=ms, plain_ms=plain_ms, bound_ms=bound['bound_ms'],
        bound_by=bound['bound_by'], max_abs_err=abs_err)

    # ---- float32 only: the whole gradient through ObserveFused (both
    # kernels and the epilogue) against autograd of the plain loop, modes
    # for samples, for every weight and input.
    if dtype == torch.float32:
      def grads(fn):
        flat, _ = ops.flatten_params(params)
        leaves = [x.detach().clone().requires_grad_(True)
                  for x in (*flat, *data)]
        n = len(flat)
        p = ops.unflatten_params(leaves[:n], shape['n_out'], S, C)
        outs = fn(p, *leaves[n:], is_first, unimix=unimix, sample=False)
        loss = sum((o.float() * c).sum() for o, c in zip(outs, cts))
        return torch.autograd.grad(loss, leaves)
      fused = grads(ops.observe_fused)
      torch.cuda.synchronize()
      scan = grads(ops.observe_scan_full)
      errs = _scaled_errors(fused, scan)
      log(f'observe_fused {at} float32: gradient of {len(errs)} leaves (19 '
          f'weight groups, stoch0, deter0, actions, embeds) on the card '
          f'against autograd of observe_scan_full, worst scaled error '
          f'{max(errs):.3g} (tolerance: each leaf within 1e-4 of its '
          f'largest entry)')
      if not max(errs) <= 1e-4:
        raise AssertionError(f'ObserveFused gradient disagrees at {at}: '
                             f'{errs}')
  return results


# --------------------------------------------------------------------------
# The proof path's kernels: imagine, observe (forward only), gve.

# The xarm shapes of the proof entry point (scripts/pallas_proof.py CASES),
# and its a1 shape of `observe`.
PROOF_IMAGINE = dict(B=1024, H=15, D=512, U=512, S=32, C=32, A=5, n_out=3)
PROOF_OBSERVE = dict(T=32, B=32, D=512, U=512, S=32, C=32, A=5, E=512,
                     n_out=3)
PROOF_OBSERVE_A1 = dict(PROOF_OBSERVE, D=256, U=256, A=12)
PROOF_GVE = (15, 2048)  # (horizon, lanes), the largest of its sizes.


def _bound(flops, nbytes, dtype):
  import torch
  peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
  t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
  return dict(bound_ms=max(t_ops, t_bytes),
              bound_by='operations' if t_ops >= t_bytes else 'bytes',
              flops=flops, nbytes=nbytes)


def rollout_bounds(params, stoch0, deter0, actions, embeds, dtype):
  """Least time of `imagine` (embeds None) or of the forward-only `observe`
  on these inputs, by the method of `imagine_bound`: every product dense
  but the one with the chain's own one-hot stoch (steps 1 .. T-1), which is
  a gather of S weight rows. `observe` reads no prior head, so none of
  `w_out*`, `w_st`, `b_st` is counted for it."""
  import torch
  T, B, A = actions.shape
  SC, U = params['w_in_s'].shape
  D, S = deter0.shape[1], params['stoch_n']
  item = torch.finfo(dtype).bits // 8
  products = [params['w_in_a'], params['w_gru_d'], params['w_gru_x']]
  vectors = [params['ln_in_scale'], params['ln_in_bias'],
             params['ln_gru_scale'], params['ln_gru_bias']]
  data = [stoch0, deter0, actions]
  if embeds is None:
    products += [*params['w_out'], params['w_st']]
    vectors += [*params['ln_out_scale'], *params['ln_out_bias'],
                params['b_st']]
  else:
    products += [params['w_obs_d'], params['w_obs_e'], params['w_post']]
    vectors += [params['ln_obs_scale'], params['ln_obs_bias'],
                params['b_post']]
    data.append(embeds)
  flops = (2.0 * T * B * _numel(products)
           + B * (2.0 * SC * U + (T - 1) * S * U))
  nbytes = item * (_numel(products) + _numel([params['w_in_s']])
                   + _numel(vectors) + _numel(data))
  nbytes += 4 * T * B * SC                              # Gumbel noise.
  if embeds is not None:
    nbytes += 4 * T * B                                 # is_first.
  nbytes += T * B * (item * (D + SC) + 4 * SC)          # The three outputs.
  return _bound(flops, nbytes, dtype)


def _compare_rollout(label, kernel, plain, args, kw, dims, dtype, bound):
  """One rollout kernel against its plain version on shared noise (kw), and
  again without noise. Returns its entry of the result."""
  import torch
  from daydreamer_tpu_torch.ops import rssm as rssm_ops
  T, B, S, C = dims
  name = str(dtype).split('.')[-1]
  worst = 0.0
  for mode, kwargs in (('sampled', kw), ('unsampled', dict(kw, noise=None))):
    d1, l1, s1 = kernel(*args, **kwargs)
    torch.cuda.synchronize()
    d2, l2, s2 = plain(*args, **kwargs)
    valid = bool((s1.float().reshape(T, B, S, C).sum(-1) == 1).all()
                 and (s1.float().reshape(T, B, S, C).amax(-1) == 1).all())
    same = (s1 == s2).all(-1)                                # [T, B]
    agree = float(same.float().mean())
    # Rows whose whole history agrees so far take the same inputs.
    alive = torch.cumprod(same.int(), 0).bool()
    prev = torch.cat([torch.ones_like(alive[:1]), alive[:-1]], 0)
    err_d = float((d1.float() - d2.float()).abs().amax(-1)[prev].max())
    err_l = float((l1 - l2).abs().amax(-1)[prev].max())
    err0 = max(float((d1[0].float() - d2[0].float()).abs().max()),
               float((l1[0] - l2[0]).abs().max()))
    # A row's first differing one-hot must be a near tie: both routes took
    # the same inputs up to it, so the plain version's scores of that step
    # may put the kernel's choice below its own by twice the logits'
    # tolerance at most.
    first = prev & ~same
    gap = 0.0
    if bool(first.any()):
      scores = l2[first].reshape(-1, S, C)
      if kwargs['noise'] is not None:
        scores = rssm_ops._mixed_logprobs(scores, kwargs['unimix']) + (
            kwargs['noise'][first].reshape(-1, S, C))
      chosen = s1[first].float().reshape(-1, S, C).argmax(-1, keepdim=True)
      gap = float((scores.amax(-1, keepdim=True)
                   - scores.gather(-1, chosen)).max())
    if dtype == torch.float32:
      # The same float32 arithmetic summed in another order (the bounds of
      # the JAX package's own test of its kernels). Among half a million
      # draws a near tie may flip; that row's history differs from then on.
      tolerance = ('valid one-hots, >= 99.9 % of (step, row) one-hots '
                   'equal, a first difference only within 2e-4 of a tie, '
                   'deters within 1e-5 and logits within 1e-4 on rows that '
                   'agree so far')
      ok = (valid and agree >= 0.999 and gap <= 2e-4 and err_d <= 1e-5
            and err_l <= 1e-4)
    else:
      # bf16 rounds each product and norm, so a sum that rounds the other
      # way can flip a choice and the rows drift apart over the steps;
      # without noise the scores of a group lie closer, so more flip.
      tolerance = ('valid one-hots, step 0 within 5e-2, >= 80 % of (step, '
                   'row) one-hots equal, a first difference only within '
                   '1e-1 of a tie, deters and logits within 5e-2 on rows '
                   'that agree so far')
      ok = (valid and err0 <= 5e-2 and agree >= 0.8 and gap <= 1e-1
            and err_d <= 5e-2 and err_l <= 5e-2)
    log(f'{label} {name} {mode}: valid one-hots {valid}, equal (step, row) '
        f'one-hots {100 * agree:.4f} %, widest gap at a first difference '
        f'{gap:.3g}, max |d deter| {err_d:.3g}, max '
        f'|d logit| {err_l:.3g} on rows that agree so far, step-0 error '
        f'{err0:.3g} (tolerance: {tolerance})')
    if not ok:
      raise AssertionError(f'{label} disagrees with its plain version in '
                           f'{name}, {mode}.')
    worst = max(worst, err0, err_d, err_l)
  ms = cuda_time(lambda: kernel(*args, **kw))
  plain_ms = cuda_time(lambda: plain(*args, **kw), reps=3, warmup=1)
  log(f'{label} {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound '
      f'{bound["bound_ms"]:.4f} ms ({bound["bound_by"]}; '
      f'{bound["flops"] / 1e9:.2f} GFLOP, {bound["nbytes"] / 1e6:.1f} MB)')
  return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound['bound_ms'],
              bound_by=bound['bound_by'], max_abs_err=worst)


def device_times(fn, calls=20):
  """Device time and launches per call of `fn` of each CUDA kernel it
  launches, from torch.profiler over `calls` calls after one more: {kernel
  name: (ms, launches)}. Empty where the profiler saw no device time."""
  import torch
  from torch.profiler import ProfilerActivity, profile
  fn()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    for _ in range(calls):
      fn()
    torch.cuda.synchronize()
  return {e.key: (e.self_device_time_total / 1e3 / calls, e.count / calls)
          for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and e.self_device_time_total > 0}


def log_device_times(label, times):
  if not times:
    log(f'{label}: device time per call not measured (the profiler saw no '
        f'device time)')
  for key, (ms, count) in sorted(times.items(), key=lambda x: -x[1][0]):
    log(f'{label}: device {ms:.5f} ms per call in {count:g} launch(es) of '
        f'{key[:100]}')


def check_proof_kernels():
  """`imagine`, `observe` and `gve` against their plain versions at the
  xarm shapes of the proof entry point."""
  import torch
  from daydreamer_tpu_torch.ops import lambda_returns as lr
  from daydreamer_tpu_torch.ops import rssm
  results = {'imagine': {}, 'observe': {}, 'gve': {}}
  for label, s in (('xarm', PROOF_OBSERVE), ('a1', PROOF_OBSERVE_A1)):
    fit = rssm.observe_clusters(torch.bfloat16, *(s[k] for k in 'TBAEDUSC'))
    log(f'observe ({label} proof shape): one call launches 2 CUDA kernels '
        f'(embed product, chain); clusters of the chain that fit the card '
        f'at once (cudaOccupancyMaxActiveClusters, bfloat16): {fit[0]} of 4 '
        f'blocks, {fit[1]} of 8; it needs {(s["B"] + 1) // 2}, one per pair '
        f'of rows')
  for dtype in (torch.float32, torch.bfloat16):
    name = str(dtype).split('.')[-1]
    # imagine: the rollout's weights and carries, unit normal actions.
    s = PROOF_IMAGINE
    params, _, stoch0, deter0, _, _ = imagine_inputs(
        dtype, A=s['A'], B=s['B'], n_out=s['n_out'])
    rng = np.random.default_rng(2)
    dev = stoch0.device
    actions = torch.as_tensor(rng.standard_normal(
        (s['H'], s['B'], s['A'])).astype(np.float32)).to(dev, dtype)
    noise = torch.as_tensor(rng.gumbel(
        size=(s['H'], s['B'], s['S'] * s['C'])).astype(np.float32)).to(dev)
    results['imagine'][name] = _compare_rollout(
        'imagine', rssm.imagine_cuda, rssm.imagine_plain,
        (params, stoch0, deter0, actions), dict(noise=noise, unimix=0.01),
        (s['H'], s['B'], s['S'], s['C']), dtype,
        rollout_bounds(params, stoch0, deter0, actions, None, dtype))
    # observe: a chunk with first steps at step 0 and inside it.
    s = PROOF_OBSERVE
    params, data, is_first, noise, _ = observe_inputs(dtype, s)
    assert bool(is_first[1:].any()) and bool(is_first[0].any())
    results['observe'][name] = _compare_rollout(
        'observe', rssm.observe_cuda, rssm.observe_plain,
        (params, *data, is_first), dict(noise=noise, unimix=0.01),
        (s['T'], s['B'], s['S'], s['C']), dtype,
        rollout_bounds(params, *data, dtype))
    # The prologue's and the chain's device times apart.
    log_device_times(f'observe {name}', device_times(
        lambda: rssm.observe_cuda(params, *data, is_first, noise=noise)))
  # gve: float32 only.
  H, n = PROOF_GVE
  rng = np.random.default_rng(0)
  t = lambda x: torch.as_tensor(x.astype(np.float32)).cuda()
  interm = t(rng.normal(size=(H, n)))
  disc = t(rng.uniform(0.9, 1.0, size=(H, n)))
  boot = t(rng.normal(size=(n,)))
  out = lr.gve_triton(interm, disc, boot, 0.95)
  torch.cuda.synchronize()
  ref = lr.gve_plain(interm, disc, boot, 0.95)
  err = float((out - ref).abs().max())
  # A compiler may contract the multiply and the add into one fused
  # operation: a unit in the last place per step, carried over 15 steps.
  log(f'gve float32 ({H} x {n}): max |difference| {err:.3g} (tolerance: '
      f'1e-5, values of order 10)')
  if not err <= 1e-5:
    raise AssertionError('gve disagrees with its plain version.')
  ms = cuda_time(lambda: lr.gve_triton(interm, disc, boot, 0.95), reps=200)
  plain_ms = cuda_time(lambda: lr.gve_plain(interm, disc, boot, 0.95),
                       reps=50)
  bound = _bound(2.0 * H * n, 4 * (3 * H * n + n), torch.float32)
  # The call time above is CUDA events around back-to-back calls, so for a
  # kernel of 0.1 us of work it is the host's launch rate; the profiler
  # reads the kernel's own time on the device.
  times = device_times(lambda: lr.gve_triton(interm, disc, boot, 0.95),
                       calls=200)
  device_ms = sum(ms for key, (ms, _) in times.items() if 'gve' in key)
  log(f'gve float32: kernel {ms:.5f} ms a call (CUDA events around 200 '
      f'calls), device {device_ms:.5f} ms a launch (torch.profiler; 0: not '
      f'measured), plain {plain_ms:.5f} ms, bound '
      f'{bound["bound_ms"]:.6f} ms ({bound["bound_by"]}; '
      f'{bound["nbytes"] / 1e3:.1f} kB)')
  log_device_times('gve float32', times)
  entry = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound['bound_ms'],
               bound_by=bound['bound_by'], max_abs_err=err)
  # The kernels line reads each kernel's bfloat16 entry, the main path's
  # type; gve has one type only.
  results['gve'] = {'float32': entry, 'bfloat16': entry}
  return results


def phase_compare(spec):
  """The tree's build of a CUDA kernel against another version of its
  source (see the module docstring)."""
  import torch
  from daydreamer_tpu_torch.ops import build, rssm, rssm_vjp
  name, _, source = spec.partition('=')
  modules = {'imagine_actor': rssm, 'imagine': rssm, 'observe': rssm,
             'observe_fwd': rssm_vjp, 'observe_bwd': rssm_vjp}
  if name not in modules or not source:
    raise SystemExit(f'--compare takes NAME=SOURCE, not {spec!r}.')
  module = modules[name]
  tree = getattr(module, name.upper())
  # The other version exports the launch function, the tree may export
  # more (observe_fwd_clusters).
  other = build.Kernel(f'{name}_other', str(pathlib.Path(source).resolve()),
                       'another version', {name: tree.signature[name]})
  build.build_all([tree, other])
  for kernel in (tree, other):
    for line in kernel.build_log().splitlines():
      if 'registers' in line or 'spill' in line:
        log(f'  {kernel.name}: {line.strip()}')
  rng = np.random.default_rng(2)
  # observe at both shapes of the proof entry point, the others at one.
  shapes = ((' xarm', PROOF_OBSERVE), (' a1', PROOF_OBSERVE_A1)) if (
      name == 'observe') else (('', None),)
  for dtype, at, proof_shape in [(dtype, *shape) for dtype in (
      torch.bfloat16, torch.float32) for shape in shapes]:
    if name == 'observe':
      params, data, is_first, noise, _ = observe_inputs(dtype, proof_shape)
      call = lambda: rssm.observe_cuda(params, *data, is_first, noise=noise)
    elif module is rssm_vjp:
      # The inputs of `check_observe`; the backward runs on the saved
      # forward of the tree's forward kernel.
      shape = observe_shape('xarm', XARM_OBSERVE)
      params, data, is_first, noise, cts = observe_inputs(dtype, shape)
      kw = dict(noise=noise, unimix=shape['unimix'], sample=True)
      if name == 'observe_fwd':
        call = lambda: rssm_vjp.observe_fwd_cuda(params, *data, is_first, **kw)
      else:
        deters, post, _, stochs = rssm_vjp.observe_fwd_cuda(
            params, *data, is_first, **kw)
        stoch0, deter0, actions, embeds = data
        e_proj = (embeds.float() @ params['w_obs_e'].float()).to(dtype)
        flat = lambda out: [x for o in out
                            for x in (o if isinstance(o, list) else [o])]
        call = lambda: flat(rssm_vjp.observe_bwd_cuda(
            params, stoch0, deter0, actions, e_proj, is_first, deters, post,
            stochs, cts, unimix=shape['unimix']))
    else:
      shape = XARM if name == 'imagine_actor' else PROOF_IMAGINE
      params, actor, stoch0, deter0, action0, gen = imagine_inputs(
          dtype, **{k: shape[k] for k in ('A', 'B', 'n_out')})
      H, B, SC = shape['H'], shape['B'], shape['S'] * shape['C']
      noise = rssm.gumbel((H, B, SC), gen, stoch0.device)
      if name == 'imagine_actor':
        g_a = rssm.gumbel((H, B, shape['A']), gen, stoch0.device)
        call = lambda: rssm.imagine_actor_cuda(
            params, actor, stoch0, deter0, action0, H, noise=(noise, g_a),
            unimix=0.01, act_unimix=0.1)
      else:
        actions = torch.as_tensor(rng.standard_normal(
            (H, B, shape['A'])).astype(np.float32)).to(stoch0.device, dtype)
        call = lambda: rssm.imagine_cuda(
            params, stoch0, deter0, actions, noise=noise)

    def run(kernel):
      setattr(module, name.upper(), kernel)
      try:
        return call()
      finally:
        setattr(module, name.upper(), tree)

    a, b = run(tree), run(other)
    torch.cuda.synchronize()
    equal = all(bool((x == y).all()) for x, y in zip(a, b))
    worst = max(float((x.float() - y.float()).abs().max())
                for x, y in zip(a, b))
    log(f'compare {name}{at} {dtype}: outputs equal bit for bit: {equal} '
        f'(largest difference {worst:.3g})')
    for label, kernel in (('tree', tree), ('other', other), ('other', other),
                          ('tree', tree)):
      log(f'compare {name}{at} {dtype}: {label} '
          f'{cuda_time(lambda: run(kernel)):.4f} ms')


def phase_kernel():
  import torch
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  shape = observe_shape('xarm', XARM_OBSERVE)
  log(f'xarm observe shape: {shape}')
  results = {'imagine_actor': check_imagine_actor()}
  results.update(check_observe(shape))
  # The a1 training shape, whose rows go on earlier lines only: the kernels
  # line carries the xarm rows.
  shape = observe_shape('a1', A1_OBSERVE, task='a1_dummy',
                        **{'rssm.impl': 'pallas'})
  log(f'a1 observe shape: {shape}')
  check_observe(shape, 'a1')
  # One rank's rows in the parallel phase: xarm's batch over two ranks.
  shape = dict(observe_shape('xarm', XARM_OBSERVE), B=XARM_OBSERVE_RANK)
  check_observe(shape, 'xarm per rank (B = 16)')
  check_imagine_actor('xarm per rank', B=XARM_IMAGINE_RANK)
  results.update(check_proof_kernels())
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


def phase_profile(configs=('xarm',), updates=5):
  """Where an update's time goes at the named config blocks (xarm by
  default): torch.profiler over `updates` train steps (after three warm-up
  steps) on a random batch. Prints the wall time per update, the device's
  busy and idle share, the device time of each category of kernel (those
  of `scripts/profile_train.py`) and the kernels with the most device time.
  Not part of the default phases."""
  import torch
  from torch.profiler import ProfilerActivity, profile
  import daydreamer_tpu_torch as ddp
  from daydreamer_tpu_torch import envs
  from daydreamer_tpu_torch.agents.dreamer import Agent
  from daydreamer_tpu_torch.scripts import profile_train
  config = ddp.Config(Agent.configs['defaults'])
  for name in configs:
    config = config.update(Agent.configs[name])
  config = config.update({'imag_impl': 'pallas'})
  label = f'profile ({" ".join(configs)})'
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
  rows, categories, busy = profile_train.summarize(prof, updates, True)
  log(f'{label}: {wall * 1e3:.3f} ms wall per update, {busy:.3f} ms device '
      f'busy per update, idle share {1 - busy / (wall * 1e3):.3f}, '
      f'{sum(r["launches_per_update"] for r in rows):.0f} kernel launches '
      f'per update')
  for row in categories:
    log(f'  {row["ms_per_update"]:9.3f} ms/update '
        f'{row["launches_per_update"]:8.1f} calls/update  {row["category"]}')
  # The most device time, then the port's own kernels below those.
  own = [r for r in rows[15:] if r['category'] in profile_train.OWN_NAMES]
  for row in rows[:15] + own:
    log(f'  {row["ms_per_update"]:9.3f} ms/update '
        f'{row["launches_per_update"]:6.0f} calls/update  '
        f'{row["category"]:14s} {row["name"][:90]}')


def main(argv=None):
  parser = argparse.ArgumentParser()
  parser.add_argument(
      '--phases',
      default='device,build,kernel,slice,proof,learner,a1,explore,parallel,'
              'imitation,tooling,soak')
  parser.add_argument('--compare', action='append', default=[],
                      metavar='NAME=SOURCE')
  parser.add_argument('--seed', type=int, default=0)
  parser.add_argument('--curve-config', default='xarm', choices=CURVES)
  parser.add_argument('--curve-steps', type=int, default=21400)
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
  from daydreamer_tpu_torch.ops import build, lambda_returns, rssm, rssm_vjp
  del lambda_returns, rssm, rssm_vjp  # Imported to register their kernels.
  device_name = phase_device()
  if args.compare:
    for spec in args.compare:
      phase_compare(spec)
    return 0
  if 'build' in phases:
    phase_build()
  kernel = phase_kernel() if 'kernel' in phases else {}
  launches, parallel = {}, {}
  slice_run = None
  if 'slice' in phases:
    counts, slice_run = phase_slice('slice', SLICE_ARGS, TRAIN_KERNELS)
    launches.update({k: counts[k] for k in TRAIN_KERNELS})
    phase_slice('slice (rssm.impl scan)', SCAN_SLICE_ARGS, (
        'imagine_actor',))
  if 'proof' in phases:
    launches.update(phase_proof())
  if 'learner' in phases:
    phase_learner('learner (uniform ring)', 'fixed')
    phase_learner('learner (prioritized ring)', 'prio')
  if 'a1' in phases:
    phase_a1()
  if 'explore' in phases:
    phase_explore(slice_run)
  if 'parallel' in phases:
    parallel = phase_parallel()
  if 'imitation' in phases:
    phase_imitation(args.seed)
  if 'imitation_sim' in phases:
    phase_imitation_sim()
  profiled = phase_tooling() if 'tooling' in phases else {}
  soak = phase_soak() if 'soak' in phases else {}
  curve = {}
  if 'curve' in phases:
    curve = phase_curve(args.curve_config, args.curve_steps)
  if 'sphero' in phases:
    phase_slice('sphero', SPHERO_ARGS, OBSERVE_KERNELS)
  if 'profile' in phases:
    phase_profile()
  if 'profile_explore' in phases:
    phase_profile(('xarm', 'plan2explore'))
  entries = []
  for k in build.KERNELS:
    # The main path computes in bfloat16; each kernel's own result. The
    # launches are those of the kernel's own path: the training slice for
    # the first three, the proof for the others; beside them, each rank's
    # of the parallel phase, those of the tooling phase's profile of the
    # learner's ring dispatches, those of the soak's learner process and
    # those of the curve phase's run.
    timing = kernel.get(k.name, {}).get('bfloat16', {})
    entries.append(dict(
        name=k.name, route=k.route,
        source=str(k.source.relative_to(ROOT)), replaces=k.replaces,
        launches=launches.get(k.name, 0),
        launches_parallel={rank: counts.get(k.name, 0)
                           for rank, counts in parallel.items()},
        launches_profile=profiled.get(k.name, 0),
        launches_soak=soak.get(k.name, 0),
        launches_curve=curve.get(k.name, 0),
        max_abs_err=timing.get('max_abs_err'), ms=timing.get('ms'),
        plain_ms=timing.get('plain_ms'), bound_ms=timing.get('bound_ms'),
        bound_by=timing.get('bound_by'), library_ms=None))
  log(json.dumps({'kernels': entries}))
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': device_name,
      'count': torch.cuda.device_count()}}), flush=True)
  return 0


# The training path: xarm at its default config (rssm.impl: pallas, the
# fused observe chain) with the fused rollout. Then the loop-path observe at
# the same length, for its updates/s beside the first.
SLICE_ARGS = [
    '--configs', 'xarm', '--imag_impl', 'pallas',
    '--run', 'train', '--train.train_fill', '200', '--train.steps', '400',
    '--train.eval_every', '200', '--train.log_every', '100']
SCAN_SLICE_ARGS = [*SLICE_ARGS, '--rssm.impl', 'scan']
TRAIN_KERNELS = ('observe_fwd', 'observe_bwd', 'imagine_actor')
PROOF_KERNELS = ('imagine', 'observe', 'gve')


def reset_launches():
  from daydreamer_tpu_torch.ops import build
  for kernel in build.KERNELS:
    kernel.launches = 0


def read_launches(label, expect):
  """Every kernel's count; raises if one of `expect` is still 0."""
  from daydreamer_tpu_torch.ops import build
  launches = {k.name: k.launches for k in build.KERNELS}
  for name in expect:
    if not launches[name]:
      raise AssertionError(f'{label}: kernel {name} was never launched.')
  return launches


def finite_losses(label, logdir):
  """The training losses logged to `metrics.jsonl`; raises if there is
  none or one is not finite. The balance diagnostics (`reward_neg_loss`,
  ...) are NaN by design when a batch holds no example of a class."""
  rows = [json.loads(line) for line in
          (logdir / 'metrics.jsonl').read_text().splitlines()]
  losses = [(k, v) for row in rows for k, v in row.items()
            if k.startswith('train/')
            and k.endswith(('_opt_loss', '_loss_mean'))]
  bad = [(k, v) for k, v in losses if not math.isfinite(v)]
  if not losses or bad:
    raise AssertionError(f'{label}: no loss logged, or one not finite: {bad}')
  return dict(losses)


@contextlib.contextmanager
def timed_calls(names):
  """Within the block, each named TorchAgent method ends with a device
  sync and its wall time is appended to the dict this yields."""
  import torch
  from daydreamer_tpu_torch.agents.dreamer import torchagent
  times = {name: [] for name in names}
  originals = {name: getattr(torchagent.TorchAgent, name) for name in names}

  def timed(name, inner):
    def call(self, *args, **kwargs):
      begin = time.perf_counter()
      out = inner(self, *args, **kwargs)
      if self.device.type == 'cuda':
        torch.cuda.synchronize()
      times[name].append(time.perf_counter() - begin)
      return out
    return call

  for name, inner in originals.items():
    setattr(torchagent.TorchAgent, name, timed(name, inner))
  try:
    yield times
  finally:
    for name, inner in originals.items():
      setattr(torchagent.TorchAgent, name, inner)


def new_logdir(tag):
  stamp = time.strftime('%Y%m%d_%H%M%S')
  logdir = ROOT / 'runs' / f'chip_smoke_{stamp}_{tag}'
  logdir.mkdir(parents=True)
  return logdir


def phase_proof():
  """The port's proof entry point in this process; its rows go on earlier
  lines. Returns the launches of the proof's kernels."""
  from daydreamer_tpu_torch.scripts import pallas_proof
  reset_launches()
  result = pallas_proof.main(['--which', 'all'])
  launches = read_launches('proof', PROOF_KERNELS)
  check = result['rssm_correctness']
  ok = (check['imagine_deter_maxdiff'] <= 1e-5
        and check['observe_deter_maxdiff'] <= 1e-5
        and check['imagine_stoch_agree'] == 1.0
        and check['observe_stoch_agree'] == 1.0
        and check['sample_onehot_ok'] and check['sample_steps_differ'])
  log(f'proof: launches {({k: launches[k] for k in PROOF_KERNELS})}; float32 '
      f'agreement {check} (tolerance: deters within 1e-5, every one-hot '
      f'equal, sampled one-hots exact and differing between steps)')
  if not ok:
    raise AssertionError(f'proof: the float32 agreement check failed: {check}')
  return {k: launches[k] for k in PROOF_KERNELS}


def phase_learner(label, replay_kind, updates=48, prefill=2048,
                  ring_steps=20000):
  """`run.learning` on xarm at its default config (plus `imag_impl:
  pallas`) from a replay prefilled here with random actions: `updates`
  updates in dispatches of `train_fused` from a device ring of `ring_steps`
  steps, uniform (`fixed`) or prioritized (`prio`)."""
  import torch
  import daydreamer_tpu_torch as ddp
  from daydreamer_tpu_torch import envs
  from daydreamer_tpu_torch import replay as replaylib
  from daydreamer_tpu_torch.agents.dreamer import Agent, torchagent
  from daydreamer_tpu_torch.replay.device_replay import UNSEEN_PRIORITY
  logdir = new_logdir(f'learner_{replay_kind}')
  config = ddp.Config(Agent.configs['defaults']).update(
      Agent.configs['xarm']).update({
          'imag_impl': 'pallas', 'replay': replay_kind,
          'logdir': str(logdir)})
  # A log, a report and a weight publish after every dispatch (the clocks
  # are wall clocks), so the last dispatch's losses are logged too.
  args = ddp.Config(
      logdir=str(logdir), **config.train, batch_size=config.batch_size,
      replay_chunk=config.replay_chunk).update(
      steps=updates, sync_every=1, device_replay_steps=ring_steps)
  fused = int(args.train_fused)
  assert args.device_replay and fused == 16 and prefill >= args.train_fill
  step = ddp.Counter()
  logger = ddp.Logger(step, [ddp.JSONLOutput(str(logdir))])
  env = envs.load_env(config.task, mode='train', **config.env)
  rings = []
  make_ring = torchagent.TorchAgent.make_device_replay
  try:
    agent = Agent(env.obs_space, env.act_space, step, config)
    store = replaylib.Stats(replaylib.RAMStore(int(config.replay_size)))
    if replay_kind == 'prio':
      train_replay = replaylib.Prioritized(
          store, config.replay_chunk, **config.replay_prio)
    else:
      train_replay = replaylib.FixedLength(
          store, config.replay_chunk, **config.replay_fixed)
    eval_replay = replaylib.FixedLength(
        replaylib.RAMStore(int(config.replay_size) // 10),
        config.replay_chunk, **config.replay_fixed)
    driver = ddp.Driver(env)
    driver.on_step(train_replay.add)
    begin = time.perf_counter()
    driver(ddp.RandomAgent(env.act_space).policy, steps=prefill)
    log(f'{label}: prefilled {len(train_replay)} steps in '
        f'{time.perf_counter() - begin:.1f} s; the loop writes its output '
        f'to {logdir / "learning.log"}')

    def capture(self, *a, **kw):
      rings.append(make_ring(self, *a, **kw))
      return rings[-1]
    torchagent.TorchAgent.make_device_replay = capture
    reset_launches()
    with timed_calls(['train_device']) as times, open(
        logdir / 'learning.log', 'w') as out, contextlib.redirect_stdout(out):
      ddp.run.learning(agent, train_replay, eval_replay, logger, args)
  finally:
    torchagent.TorchAgent.make_device_replay = make_ring
    env.close()
  launches = read_launches(label, TRAIN_KERNELS)
  printed = (logdir / 'learning.log').read_text()
  if 'Device-resident replay engaged' not in printed or (
      'falling back to host sampling' in printed):
    raise AssertionError(f'{label}: the device ring did not engage.')
  if replay_kind == 'prio' and 'runs DEVICE-SIDE' not in printed:
    raise AssertionError(f'{label}: the prioritized ring did not engage.')
  ring, = rings
  tensors = list(ring.buffers.values()) + (
      [ring.prios] if ring.prioritized else [])
  if not all(x.device.type == 'cuda' for x in tensors) or (
      ring.prioritized != (replay_kind == 'prio')):
    raise AssertionError(f'{label}: the ring does not lie on the card.')
  if replay_kind == 'prio':
    seen = int((ring.prios[:ring.filled] != UNSEEN_PRIORITY).sum())
    if not seen or not bool(torch.isfinite(ring.prios).all()):
      raise AssertionError(f'{label}: no priority was written back.')
    log(f'{label}: {seen} of {ring.filled} steps carry a priority written '
        f'back by an update')
  losses = finite_losses(label, logdir)
  for name in ('agent.pkl', 'policy.pkl'):
    if not (logdir / name).exists():
      raise AssertionError(f'{label}: {name} was not written.')
  dispatches = times['train_device']
  done = fused * len(dispatches)
  if int(step) < updates or done < updates or any(
      launches[k] < done for k in TRAIN_KERNELS):
    raise AssertionError(
        f'{label}: {done} updates in {len(dispatches)} dispatches, step '
        f'{int(step)}, launches {launches}: fewer than one launch of each '
        f'kernel per update.')
  # The first dispatch carries the creation pass.
  rate = fused * len(dispatches[1:]) / sum(dispatches[1:])
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True).stdout.strip()
  log(f'{label}: {done} updates in {len(dispatches)} dispatches of {fused}, '
      f'launches {({k: launches[k] for k in TRAIN_KERNELS})}, last logged '
      f'losses {losses}')
  log(f'{label}: {rate:.3f} updates/s over {done - fused} updates (the '
      f'first dispatch excluded; dispatches took '
      f'{[round(t, 3) for t in dispatches]} s), ring of {ring.capacity} '
      f'steps holding {ring.filled}, {ring.nbytes} bytes on the card '
      f'({smi})')


def phase_slice(label, cli_args, expect):
  """The xarm run=train CLI in this process with `cli_args`. Every kernel's
  launch count is set to 0 just before and read just after; the kernels
  named in `expect` must have been launched. Returns their launches."""
  from daydreamer_tpu_torch.agents.dreamer import train
  logdir = new_logdir(re.sub(r'\W+', '_', label))
  reset_launches()
  log(f'{label}: the CLI writes its output to {logdir / "cli.log"}')
  with timed_calls(['train', 'policy']) as times, open(
      logdir / 'cli.log', 'w') as out, contextlib.redirect_stdout(out):
    train.main([*cli_args, '--logdir', str(logdir)])
  launches = read_launches(label, expect)
  losses = finite_losses(label, logdir)
  log(f'{label}: {len(times["train"])} updates, {len(times["policy"])} '
      f'policy steps, launches {launches}, last logged losses {losses}')
  if launches['observe_bwd'] and launches['observe_bwd'] < len(
      times['train']) - 1:
    raise AssertionError(f'{label}: fewer observe_bwd launches than '
                         f'world-model updates.')
  # The first call of each entry point carries the creation pass.
  train_s, policy_s = times['train'][1:], times['policy'][1:]
  run = dict(updates=len(times['train']), policy_steps=len(times['policy']),
             rate=len(train_s) / sum(train_s),
             policy_ms=1e3 * float(np.mean(policy_s)), losses=losses)
  log(f'{label}: {run["rate"]:.3f} updates/s over {len(train_s)} updates, '
      f'policy step {run["policy_ms"]:.3f} ms mean over {len(policy_s)} '
      f'steps')
  return launches, run


# The paper's A1 config as its file has it (proprio only: the MLP encoder
# over the 16-wide vector, deter = units = 256, 12 continuous actions), on
# the env's dummy task, which needs no simulator. The length is cut as the
# xarm slice's is: 200 steps of fill, then 50 updates, one every 4 steps.
A1_ARGS = [
    '--configs', 'a1', '--task', 'a1_dummy',
    '--run', 'train', '--train.train_fill', '200', '--train.steps', '400',
    '--train.eval_every', '200', '--train.log_every', '100']
OBSERVE_KERNELS = ('observe_fwd', 'observe_bwd')
# The sphero config as its file has it (`rssm.impl: pallas`), cut alike.
SPHERO_ARGS = [
    '--configs', 'sphero', '--run', 'train', '--train.train_fill', '200',
    '--train.steps', '400', '--train.eval_every', '200',
    '--train.log_every', '100']


def phase_a1():
  """a1 through the CLI three times: as the config file has it (the loop
  path: no kernel may launch), with the fused observe chain (`--rssm.impl
  pallas`: observe_fwd and observe_bwd at D = U = 256, E = 512, A = 12),
  and through the native batcher (`--data_loader native`), whose library
  g++ must have built into native/_build/ and loaded."""
  from daydreamer_tpu_torch.agents.dreamer import torchagent
  from daydreamer_tpu_torch.native.build import BUILD
  from daydreamer_tpu_torch.replay import batcher
  library = BUILD / 'libfastcopy.so'
  built_before = library.exists()
  launches, _ = phase_slice('a1', A1_ARGS, ())
  if any(launches.values()):
    raise AssertionError(f'a1: a kernel launched on the loop path: '
                         f'{launches}')
  phase_slice('a1 (rssm.impl pallas)', [*A1_ARGS, '--rssm.impl', 'pallas'],
              OBSERVE_KERNELS)
  made = []
  dataset = torchagent.TorchAgent.dataset
  torchagent.TorchAgent.dataset = lambda self, generator: made.append(
      dataset(self, generator)) or made[-1]
  try:
    phase_slice('a1 (data_loader native)',
                [*A1_ARGS, '--data_loader', 'native'], ())
  finally:
    torchagent.TorchAgent.dataset = dataset
  if not made or not all(
      isinstance(d, batcher.NativeBatcher) and d._lib is not None
      for d in made) or not library.exists():
    raise AssertionError(f'a1 (data_loader native): the native batcher did '
                         f'not run on its library: {made}, {library}')
  origin = 'found from an earlier run' if built_before else (
      'built by g++ in this run')
  log(f'a1 (data_loader native): {len(made)} NativeBatcher(s) on '
      f'{pathlib.Path(made[0]._lib._name).relative_to(ROOT)}, {origin}')


# The rest of the agent at xarm's full width (deter = units = 512, 32x32
# latents, 64x64 image and depth, batch 32 x chunk 32; the disagreement
# ensemble of 8 heads of 4 x 512), cut in length only, as the slice is.
PLAN2EXPLORE_ARGS = ['--configs', 'xarm', 'plan2explore', *SLICE_ARGS[2:]]
DISAG_WHEN_ARGS = [*SLICE_ARGS, '--task_behavior', 'DisagWhen']
MIRROR_ARGS = [*SLICE_ARGS, '--torch.policy_devices', 'cpu',
               '--torch.policy_sync', '20']


def _leaves(tree):
  if isinstance(tree, dict):
    return [x for v in tree.values() for x in _leaves(v)]
  if isinstance(tree, (tuple, list)):
    return [x for v in tree for x in _leaves(v)]
  return [tree]


@contextlib.contextmanager
def policy_probe():
  """Within the block, records each TorchAgent whose policy runs and the
  device types of the tensors in each policy state it returns."""
  from daydreamer_tpu_torch.agents.dreamer import torchagent
  seen = {'agents': [], 'devices': set()}
  inner = torchagent.TorchAgent.policy

  def policy(self, *args, **kwargs):
    outs, state = inner(self, *args, **kwargs)
    if self not in seen['agents']:
      seen['agents'].append(self)
    seen['devices'].update(x.device.type for x in _leaves(state))
    return outs, state

  torchagent.TorchAgent.policy = policy
  try:
    yield seen
  finally:
    torchagent.TorchAgent.policy = inner


def _twice_per_update(label, launches, run):
  updates = run['updates']
  if launches['imagine_actor'] < 2 * (updates - 1) or any(
      launches[k] < updates - 1 for k in OBSERVE_KERNELS):
    raise AssertionError(
        f'{label}: launches {launches} in {updates} updates: imagine_actor '
        f'not twice an update, or observe_fwd/observe_bwd not once.')
  log(f'{label}: launches per update: ' + ', '.join(
      f'{k} {launches[k] / updates:.2f}' for k in TRAIN_KERNELS))


def phase_explore(slice_run):
  """plan2explore, DisagWhen and the host-CPU policy mirror through the
  CLI at xarm's full width (see the module's docstring, phase 8)."""
  from daydreamer_tpu_torch import nn
  from daydreamer_tpu_torch.agents.dreamer import behaviors
  explore_calls = []
  explore_policy = behaviors.Explore.policy
  behaviors.Explore.policy = lambda self, *a: (
      explore_calls.append(1) or explore_policy(self, *a))
  try:
    label = 'explore (plan2explore)'
    launches, run = phase_slice(label, PLAN2EXPLORE_ARGS, TRAIN_KERNELS)
  finally:
    behaviors.Explore.policy = explore_policy
  _twice_per_update(label, launches, run)
  expl = {k: v for k, v in run['losses'].items()
          if k.startswith('train/expl_')}
  if not expl:
    raise AssertionError(f'{label}: no expl_ loss was logged.')
  # `train.expl_until: 0`: every policy step runs in mode 'explore'.
  if len(explore_calls) < run['policy_steps']:
    raise AssertionError(
        f'{label}: Explore acted {len(explore_calls)} times in '
        f'{run["policy_steps"]} policy steps.')
  log(f'{label}: Explore\'s actor in {len(explore_calls)} policy calls; '
      f'last logged expl_ losses {expl}')

  label = 'explore (DisagWhen)'
  with policy_probe() as seen:
    launches, run = phase_slice(label, DISAG_WHEN_ARGS, TRAIN_KERNELS)
  _twice_per_update(label, launches, run)
  agent, = seen['agents']
  buffers = {k: v for k, v in nn.state(agent.agent).items()
             if k.endswith(('/buffer', '/disags'))}
  if len(buffers) != 2 or not all(
      v.device.type == 'cuda' and bool((v != 0).any())
      for v in buffers.values()):
    raise AssertionError(f'{label}: the disagreement buffer is not on the '
                         f'card, or holds nothing: {list(buffers)}')
  disags = buffers['agent/task_behavior/disags']
  log(f'{label}: buffer of {len(disags)} states on the card, '
      f'{int((disags != 0).sum())} held, disagreement '
      f'{float(disags.max()):.4f} at most')

  label = 'explore (policy mirror)'
  with policy_probe() as seen:
    launches, run = phase_slice(label, MIRROR_ARGS, TRAIN_KERNELS)
  agent, = seen['agents']
  mirror = nn.state(agent._mirror)
  if agent.device.type != 'cuda' or seen['devices'] != {'cpu'} or not all(
      v.device.type == 'cpu' for v in mirror.values()):
    raise AssertionError(
        f'{label}: the agent is on {agent.device}, the policy states on '
        f'{seen["devices"]}: the policy did not run on the host mirror.')
  if agent._mirror_syncs < 2:
    raise AssertionError(f'{label}: the mirror refreshed '
                         f'{agent._mirror_syncs} times.')
  card = (f'{slice_run["policy_ms"]:.3f} ms on the card (slice phase)'
          if slice_run else 'the card\'s not measured in this call')
  log(f'{label}: {len(mirror)} of {len(nn.state(agent.agent))} entries on '
      f'the host, refreshed {agent._mirror_syncs} times in '
      f'{agent._train_steps} updates; host policy step '
      f'{run["policy_ms"]:.3f} ms beside {card}')



# The parallel phase: xarm at full width through the port's worker, its
# batch of 32 over the ranks (the xarm block's widths and `rssm.impl:
# pallas`; bfloat16, the defaults' precision), 3 timed dispatches of 4.
PARALLEL_ARGS = ['--configs', 'xarm', '--imag_impl', 'pallas', '--steps', '3',
                 '--fused', '4', '--device', 'cuda']
RANK_TIMEOUT = 240  # Seconds, for each rank process.


def run_ranks(label, world, backend, rundir):
  """`world` ranks of the worker on the card with `backend`, through a
  `file://` store in `rundir`; each rank's output goes to a file there.
  Returns, per rank, its INFO, LAUNCHES and RESULT lines, parsed."""
  import os
  store = (rundir / f'store_{backend}_{world}').as_uri()
  env = dict(os.environ, PYTHONPATH=str(ROOT))
  env.pop('LOCAL_RANK', None)  # Every rank on card 0.
  outs, procs = [], []
  for rank in range(world):
    out = open(rundir / f'{backend}_{world}_rank{rank}.log', 'w')
    outs.append(out)
    procs.append(subprocess.Popen(
        [sys.executable, '-m', 'daydreamer_tpu_torch.scripts.multihost_worker',
         store, str(world), str(rank), '--backend', backend, *PARALLEL_ARGS],
        cwd=ROOT, env=env, stdout=out, stderr=subprocess.STDOUT))
  try:
    codes = [proc.wait(timeout=RANK_TIMEOUT) for proc in procs]
  finally:
    for proc in procs:
      if proc.poll() is None:
        proc.kill()
        proc.wait()
    for out in outs:
      out.close()
  ranks = []
  for rank, code in enumerate(codes):
    text = (rundir / f'{backend}_{world}_rank{rank}.log').read_text()
    if code != 0:
      raise AssertionError(f'{label}: rank {rank} exited {code}:\n'
                           f'{text[-3000:]}')
    lines = {line.split(' ', 1)[0]: line.split(' ', 1)[1]
             for line in text.splitlines()
             if line.startswith(('INFO ', 'LAUNCHES ', 'RESULT '))}
    _, loss, rate, checksum = lines['RESULT'].split()
    ranks.append(dict(info=json.loads(lines['INFO']),
                      launches=json.loads(lines['LAUNCHES']),
                      loss=float(loss), rate=float(rate), checksum=checksum))
  for rank in ranks:
    launches, updates = rank['launches'], rank['launches']['updates']
    if (launches['observe_bwd'] != updates
        or launches['imagine_actor'] != updates
        or launches['observe_fwd'] < 1 or not math.isfinite(rank['loss'])):
      raise AssertionError(
          f'{label}: launches {launches} in {updates} updates (observe_bwd '
          f'and imagine_actor once an update, observe_fwd at least once), '
          f'loss {rank["loss"]}')
  for rank, result in enumerate(ranks):
    log(f'{label}: rank {rank}: {result["rate"]:.3f} updates/s over '
        f'{result["launches"]["updates"]} updates, model loss '
        f'{result["loss"]!r}, state checksum {result["checksum"]}, launches '
        f'{({k: result["launches"][k] for k in TRAIN_KERNELS})}, '
        f'{result["info"]}')
  return ranks


def phase_parallel():
  """Two ranks on the card over gloo, then one over NCCL (see the module
  docstring, phase 9). Returns each rank's launches of every kernel, by
  rank (`gloo_rank0`, `gloo_rank1`, `nccl_rank0`)."""
  import torch
  begin = time.perf_counter()
  torch.cuda.empty_cache()  # The earlier phases' cached blocks.
  rundir = new_logdir('parallel')
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True).stdout.strip()
  pair = run_ranks('parallel (2 ranks, gloo)', 2, 'gloo', rundir)
  if pair[0]['loss'] != pair[1]['loss'] or (
      pair[0]['checksum'] != pair[1]['checksum']):
    raise AssertionError(f'parallel (2 ranks, gloo): the replicas differ: '
                         f'{[(r["loss"], r["checksum"]) for r in pair]}')
  single = run_ranks('parallel (1 rank, nccl)', 1, 'nccl', rundir)
  grad_bytes = pair[0]['info']['grad_bytes']
  log(f'parallel: the two ranks agree (loss {pair[0]["loss"]!r}, checksum '
      f'{pair[0]["checksum"]}); {grad_bytes} bytes of gradients averaged '
      f'over the ranks an update; updates/s of each rank of the pair '
      f'{[r["rate"] for r in pair]} against one rank over NCCL '
      f'{single[0]["rate"]} (a correctness run on one shared card, not a '
      f'scaling figure; {smi}); phase {time.perf_counter() - begin:.1f} s')
  ranks = {f'gloo_rank{i}': r for i, r in enumerate(pair)}
  ranks['nccl_rank0'] = single[0]
  return {name: {k: v for k, v in r['launches'].items() if k != 'updates'}
          for name, r in ranks.items()}


def phase_imitation(seed):
  """The imitation trainer's PPO learner at its defaults on the card. The
  card's machine has no MuJoCo, so the rollout's observations are made
  here: the proprio part from a NumPy generator seeded by `seed`, the
  target features from `task.a1_gait_clip('trot')` at the sim times that
  `ImitationA1._clip_time` gives (episode step x repeat x the physics
  step). Times 2048 `act` calls at batch 1 (their launches from
  torch.profiler over ten), `gae` and two `update`s (the first pays the
  first launch of each kernel), whose metrics must be finite; then holds
  `_loss` and its gradients on one minibatch against a CPU agent loaded
  from the card's `save()` (within 1e-4 of the largest magnitude), and
  that agent's values on the same observations."""
  import torch
  from torch.profiler import ProfilerActivity, profile
  from daydreamer_tpu_torch.envs import a1, a1_model
  from daydreamer_tpu_torch.imitation import PPOImitation, task
  from daydreamer_tpu_torch.scripts import profile_train
  # imitation/train.py's defaults: a rollout of 2048 steps in episodes of
  # 500 env steps of 2 physics steps each, 12 actions.
  horizon, length, repeat, act_dim = 2048, 500, 2, 12
  obs_dim = a1.VECTOR_DIM + task.ImitationA1.TARGET_FEATURES
  rng = np.random.default_rng(seed)
  clip = task.a1_gait_clip('trot')
  times = (np.arange(horizon) % length) * repeat * a1_model.SIM_TIMESTEP
  phase = 2 * np.pi * np.array([clip.phase(t) for t in times])
  obs = np.concatenate([
      rng.standard_normal((horizon, a1.VECTOR_DIM)),
      np.sin(phase)[:, None], np.cos(phase)[:, None],
      np.stack([clip.joints_at(t) for t in times])], 1).astype(np.float32)
  agent = PPOImitation(obs_dim, act_dim, horizon=horizon, seed=seed)
  assert agent.device.type == 'cuda', agent.device
  agent.act(obs[:1])  # Warm.
  activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
  with profile(activities=activities) as prof:
    for i in range(10):
      agent.act(obs[i:i + 1])
  rows, _, busy = profile_train.summarize(prof, 10, True)
  act_launches = sum(r['launches_per_update'] for r in rows)
  seg = {k: [] for k in ('action', 'logp', 'value')}
  act_s = []
  for i in range(horizon):
    begin = time.perf_counter()
    action, logp, value = agent.act(obs[i:i + 1])
    act_s.append(time.perf_counter() - begin)
    for key, x in zip(seg, (action, logp, value)):
      seg[key].append(x[0])
  seg = {k: np.asarray(v, np.float32) for k, v in seg.items()}
  rewards = rng.uniform(0, 1, horizon).astype(np.float32)
  conts = (rng.uniform(size=horizon) > 0.002).astype(np.float32)
  begin = time.perf_counter()
  adv, ret = agent.gae(rewards, seg['value'], conts, seg['value'][-1])
  gae_s = time.perf_counter() - begin
  rollout = dict(obs=obs, action=seg['action'], logp=seg['logp'], adv=adv,
                 ret=ret)
  update_s = []  # The first update, then a warm one on the same rollout.
  for _ in range(2):
    begin = time.perf_counter()
    metrics = agent.update(rollout)
    update_s.append(time.perf_counter() - begin)
  bad = {k: v for k, v in metrics.items() if not math.isfinite(v)}
  if bad or metrics['ppo_opt_grad_steps'] != 80:
    raise AssertionError(f'imitation: update metrics {metrics}')
  # The same weights on the CPU: the loss and its gradients on one
  # minibatch, and the values of the first rows.
  host = PPOImitation(obs_dim, act_dim, horizon=horizon, seed=seed,
                      device='cpu')
  host.load(agent.save())
  batch = {k: v[:horizon // agent.minibatches] for k, v in rollout.items()}
  outs = []
  for side in (agent, host):
    params = dict(side.net.named_state(trainable=True))
    loss, aux = side._loss(side._to_device(batch))
    grads = torch.autograd.grad(loss, list(params.values()))
    value = torch.as_tensor(side.act(obs[:64])[2])
    names = ['loss', *aux, *params, 'value']
    outs.append([x.detach().cpu() for x in (
        loss, *aux.values(), *grads, value)])
  errors = dict(zip(names, _scaled_errors(*outs)))
  worst = max(errors, key=errors.get)
  if errors[worst] > 1e-4:
    raise AssertionError(f'imitation: card and CPU differ at {worst}: '
                         f'{errors}')
  act_ms = 1e3 * np.asarray(act_s)
  log(f'imitation: PPO at obs {obs_dim}, {act_dim} actions, horizon '
      f'{horizon}, {agent.epochs} x {agent.minibatches} minibatches of '
      f'{horizon // agent.minibatches} on {torch.cuda.get_device_name(0)} '
      f'({profile_train.card()}): act at batch 1 {act_ms.mean():.4f} ms mean, '
      f'{np.median(act_ms):.4f} median over {horizon} calls '
      f'({act_launches:.1f} launches and {busy:.4f} ms device busy a call, '
      f'torch.profiler over 10); gae {1e3 * gae_s:.3f} ms; an update of '
      f'{agent.epochs * agent.minibatches} Adam steps {1e3 * update_s[0]:.3f}'
      f' ms the first, {1e3 * update_s[1]:.3f} ms the next; metrics '
      f'{metrics}; card against CPU, worst scaled error '
      f'{errors[worst]:.3g} ({worst}), loss {outs[0][0].item()!r} / '
      f'{outs[1][0].item()!r}')


def phase_imitation_sim():
  """The imitation trainer end to end on the card, MuJoCo's A1 included
  (not run by default: the card's machine has no MuJoCo, and then the
  trainer's first env step raises its ImportError, which fails the run)."""
  from daydreamer_tpu_torch.imitation import train
  logdir = new_logdir('imitation_sim')
  begin = time.perf_counter()
  returns = train.main(['--steps', '4096', '--horizon', '2048', '--length',
                        '500', '--logdir', str(logdir)])
  rows = [json.loads(line) for line in
          (logdir / 'metrics.jsonl').read_text().splitlines()]
  losses = [row['ppo_opt_loss'] for row in rows if 'ppo_opt_loss' in row]
  if len(losses) != 2 or not all(map(math.isfinite, losses)):
    raise AssertionError(f'imitation_sim: losses {losses}')
  log(f'imitation_sim: 4096 steps in {time.perf_counter() - begin:.1f} s, '
      f'{len(returns)} episodes, returns {returns}, losses {losses}')


def run_tool(label, module, args, rundir):
  """`python -m module args` from the repository's root; its output goes to
  a file in `rundir`. Returns its last line, parsed as JSON."""
  import os
  path = rundir / f'{label}.log'
  begin = time.perf_counter()
  with open(path, 'w') as out:
    code = subprocess.run(
        [sys.executable, '-m', module, *args], cwd=ROOT, stdout=out,
        stderr=subprocess.STDOUT, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(ROOT))).returncode
  text = path.read_text()
  if code != 0:
    raise AssertionError(f'{label}: exited {code}:\n{text[-3000:]}')
  log(f'{label}: {time.perf_counter() - begin:.1f} s; output in {path}')
  return json.loads(text.strip().splitlines()[-1])


# observe_fwd's three device functions and observe_bwd's one.
PROFILED_OBSERVE = ('embed_kernel', 'chain_kernel', 'prior_kernel',
                    'observe_bwd_kernel')


def phase_tooling():
  """The port's two instruments as a user runs them. First
  `scripts/profile_train.py --shape xarm --dispatches 2` (K = 16: one
  dispatch that creates the state, two warm, two traced, so 80 updates):
  its wrappers must count observe_fwd and observe_bwd once a traced update
  and `observe` never, its trace must show observe_fwd's three device
  functions and observe_bwd's one launched once an update, and the
  device's busy time must be under the wall time. Then
  `scripts/policy_latency.py` at `--shape a1` and `--shape test`, the card
  and the host mirror: each must print its result, and the card's whole
  policy call at a1 must take under 50 ms. Returns the profile's launches
  of each kernel."""
  rundir = new_logdir('tooling')
  report = run_tool('profile_train (xarm)',
                    'daydreamer_tpu_torch.scripts.profile_train',
                    ['--shape', 'xarm', '--dispatches', '2', '--out',
                     str(rundir / 'profile_xarm.json')], rundir)
  updates, launches = report['updates_traced'], report['wrapper_launches']
  traced = {}
  for row in report['own_kernels']:
    for function in PROFILED_OBSERVE:
      if f'::{function}' in row['name']:
        traced[function] = traced.get(function, 0) + row[
            'launches_per_update']
  if (launches['observe_fwd'] != updates or launches['observe_bwd'] != updates
      or launches['observe'] or any(
          traced.get(f) != 1 for f in PROFILED_OBSERVE)
      or not report['device_busy_ms_per_update'] < report[
          'wall_ms_per_update']):
    raise AssertionError(
        f'profile_train: {updates} updates, wrapper launches {launches}, '
        f'device functions a traced update {traced}, busy '
        f'{report["device_busy_ms_per_update"]} against wall '
        f'{report["wall_ms_per_update"]} ms')
  log(f'profile_train (xarm): {report["wall_ms_per_update"]:.3f} ms wall '
      f'per update traced ({report["untraced_wall_ms_per_update"]:.3f} '
      f'untraced), {report["device_busy_ms_per_update"]:.3f} ms device '
      f'busy, idle share {report["idle_share"]:.3f} (untraced '
      f'{report["idle_share_untraced"]:.3f}), '
      f'{report["launches_per_update"]:.1f} launches an update; by '
      f'category (ms, launches an update): ' + ', '.join(
          f'{r["category"]} {r["ms_per_update"]:.3f} / '
          f'{r["launches_per_update"]:.1f}' for r in report['categories']))
  for shape in ('a1', 'test'):
    result = run_tool(f'policy_latency ({shape})',
                      'daydreamer_tpu_torch.scripts.policy_latency',
                      ['--shape', shape, '--out',
                       str(rundir / f'policy_latency_{shape}.json')], rundir)
    device, mirror = result['device'], result['cpu_mirror']
    if not device['on'].startswith('cuda') or mirror['on'] != 'cpu':
      raise AssertionError(f'policy_latency ({shape}): {result}')
    if shape == 'a1' and not device['whole_ms'] < 50:
      raise AssertionError(f'policy_latency (a1): the card took '
                           f'{device["whole_ms"]} ms a call')
    log(f'policy_latency ({shape}): card {device}, host mirror {mirror}, '
        f'null round trip {result["null_rtt_ms"]:.4f} / '
        f'{result["null_rtt_after_ms"]:.4f} ms ({result["card"]})')
  return launches


# Two minutes of the deployment pair; the learner on the card with the fused
# observe chain, the actor on a1_dummy (no MuJoCo on the card's machine).
SOAK_ARGS = ['--minutes', '2', '--learner-device', 'cuda', '--actor-task',
             'a1_dummy', '--rssm.impl', 'pallas']


def printed_config(text):
  """The resolved config that the CLI prints at its start: {key: value}."""
  return dict(re.findall(r'^(\S+):\s+(\S+)\s+\(\w+\)$', text, re.M))


def phase_soak():
  """The port's `scripts/async_soak.py` as a subprocess (see the module's
  docstring, phase 12). Both processes write `config.yaml` into the one
  logdir, so the learner's resolved config is read where its log prints
  it."""
  import os
  rundir = new_logdir('soak')
  out, logdir = rundir / 'soak.json', rundir / 'pair'
  begin = time.perf_counter()
  with open(rundir / 'soak.log', 'w') as log_file:
    code = subprocess.run(
        [sys.executable, '-m', 'daydreamer_tpu_torch.scripts.async_soak',
         *SOAK_ARGS, '--out', str(out), '--logdir', str(logdir)],
        cwd=ROOT, stdout=log_file, stderr=subprocess.STDOUT, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(ROOT))).returncode
  if code != 0 or not out.exists():
    raise AssertionError(f'soak: exited {code}:\n'
                         f'{(rundir / "soak.log").read_text()[-3000:]}')
  result = json.loads(out.read_text())
  config = printed_config((logdir / 'learner.log').read_text())
  log(f'soak: {time.perf_counter() - begin:.1f} s; summary '
      f'{json.dumps(result["summary"])}')
  launches = result['learner_launches'] or {}
  updates = launches.get('updates', 0)
  log(f'soak: gates {json.dumps(result["gates"])}; learner '
      f'torch.device {config.get("torch.device")}, rssm.impl '
      f'{config.get("rssm.impl")}, launches {json.dumps(launches)}; logs '
      f'in {logdir}')
  if not result['passed'] or config.get('torch.device') != 'cuda' or (
      config.get('rssm.impl') != 'pallas'):
    raise AssertionError(f'soak: gates {result["gates"]}, learner config '
                         f'{config.get("torch.device")} / '
                         f'{config.get("rssm.impl")}')
  # At least one launch of each an update: an update cut short by the
  # SIGINT may have launched without being counted.
  if not updates or any(launches.get(k, 0) < updates
                        for k in OBSERVE_KERNELS):
    raise AssertionError(f'soak: the learner launched {launches}, not '
                         f'each of {OBSERVE_KERNELS} once an update.')
  return {k: v for k, v in launches.items() if k != 'updates'}


# The robot config blocks with a JAX curve on their dummy task: the task's
# label in the curve files.
CURVES = {'xarm': 'xarm_pickplace_dummy', 'ur5': 'ur5_pickplace_dummy',
          'sphero': 'sphero_navigate_dummy'}


def phase_curve(name, steps, seed=0):
  """A return curve of the config block `name` as its file has it (see the
  module's docstring, the extra phase `curve`). Returns the run's launches
  of every kernel."""
  from daydreamer_tpu_torch.scripts import provenance, scores
  label = f'curve ({name})'
  logdir = new_logdir(f'curve_{name}')
  flags = {'configs': name, 'task': f'{name}_dummy', 'run': 'train',
           'train.steps': steps, 'seed': seed, 'logdir': logdir}
  log(f'{label}: {flags}; the CLI writes its output to {logdir / "cli.log"}')

  def record():
    """The run's launches and counts, checked before anything is kept."""
    launches = read_launches(label, OBSERVE_KERNELS)
    finite_losses(label, logdir)
    updates = len(times['train'])
    # The creation pass adds one launch of each; the reports more forwards.
    if not (updates <= launches['observe_bwd'] <= updates + 1
            and launches['observe_fwd'] >= updates):
      raise AssertionError(f'{label}: launches {launches} in {updates} '
                           f'updates, not one of each an update.')
    return dict(steps=steps, updates=updates,
                policy_steps=len(times['policy']),
                launches={k: launches[k] for k in OBSERVE_KERNELS})

  out = ROOT / 'scores' / f'{name}_dreamer_torch.json'
  prov = ROOT / 'scores' / 'provenance' / f'{name}_torch_seed{seed}'
  reset_launches()
  begin = time.perf_counter()
  with timed_calls(['train', 'policy']) as times, open(
      logdir / 'cli.log', 'w') as cli, contextlib.redirect_stdout(cli):
    run = provenance.run_curve(
        flags, [], prov, out, task=CURVES[name], seed=seed,
        script='chip_smoke.py --phases curve', record=record)
  wall = time.perf_counter() - begin
  launches = read_launches(label, OBSERVE_KERNELS)
  losses = finite_losses(label, logdir)
  updates = len(times['train'])
  reference = json.loads(
      (ROOT / 'scores' / f'{name}_dreamer_tpu.json').read_text())[0]
  ys = run['ys']
  tenth = max(1, len(ys) // 10)
  train_s, policy_s = times['train'][1:], times['policy'][1:]
  log(f'{label}: {steps} env steps in {wall:.1f} s, {updates} updates '
      f'({len(train_s) / sum(train_s):.3f} updates/s, the first '
      f'excluded), {len(times["policy"])} policy steps '
      f'({1e3 * float(np.mean(policy_s)):.3f} ms mean), launches '
      f'{({k: launches[k] for k in OBSERVE_KERNELS})}, last logged losses '
      f'{losses}')
  log(f'{label}: {len(ys)} episodes to {run["xs"][-1] if ys else 0} env '
      f'steps; return over the first tenth {np.mean(ys[:tenth]):.3f}, '
      f'final-10 % mean {scores.final_mean(ys):.3f} (the JAX curve '
      f'{reference["method"]}: {scores.final_mean(reference["ys"]):.3f} '
      f'over {len(reference["ys"])} episodes to {reference["xs"][-1]} env '
      f'steps); the curve in {out.relative_to(ROOT)}')
  log(f'{label}: mean return a window of 2000 env steps, the port '
      f'{provenance.bins(run)}, the JAX curve {provenance.bins(reference)}')
  return launches


if __name__ == '__main__':
  sys.exit(main())


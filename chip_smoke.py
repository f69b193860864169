#!/usr/bin/env python3
"""Drive the PyTorch port (daydreamer_tpu_torch) on one NVIDIA GPU.

Run from the root of the repository with no arguments:

    python3 chip_smoke.py

Phases, each of which must pass:
  1. device  - print the card, and its name and power limit from nvidia-smi.
  2. build   - build every CUDA kernel from ops/csrc/ with nvcc (sm_90a),
               all at once (the six RSSM kernels' sources, layer_norm.cu,
               adam.cu, gru.cu and onehot.cu).
  3. kernel  - hold each kernel (imagine_actor, observe_fwd, observe_bwd,
               imagine, observe, gve) against its plain PyTorch version at
               the xarm shape, in float32 and in bfloat16 (gve: float32),
               and time both; in float32 also the whole fused observe
               gradient against autograd of a plain loop. It prints how
               many thread block clusters of observe_fwd's and observe's
               chains fit the card at once, and the device time of each
               CUDA kernel that a call of observe and of gve launches
               (torch.profiler). Then the five RSSM kernels at widths past
               their first layouts (WIDTH_*_SITES: deter, units and
               latents off multiples of 8, 0 and 9 prior layers, 9 actor
               layers, deters whose vectors outgrow shared memory), each
               held the same way; `--phases device,build,rssm_widths`
               runs these sites alone, `graphs_widths` the graphs phase's
               updates at GRAPHS_WIDTHS alone.
  4. slice   - the training path: the xarm `run=train` CLI in this process
               at its default config (`rssm.impl: pallas`) with `--imag_impl
               pallas`, a few dozen updates, with every kernel's launch
               count set to 0 just before and read just after; every logged
               loss must be finite, and the policy steps must launch the
               RSSM step's forward kernels (gru_cell_fwd, onehot_head_fwd).
               Then the same run with `--rssm.impl scan`, the loop path,
               for its updates/s beside the first, where the RSSM step's
               four kernels (forward and backward) must launch.
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
               as the config file has it, the loop path, where no RSSM
               kernel may launch and the RSSM step's four (the GRU cell and
               the stats head, forward and backward) must launch once an
               update at least; with `--rssm.impl pallas`, where observe_fwd and
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
               pallas`, bfloat16), eagerly (`--torch.graphs False`: a CUDA
               graph cannot capture gloo), 3 timed dispatches of 4 fused
               updates after one that creates the state; then one rank
               over NCCL (world 1) with the same settings, graphed (each
               update a replay of one CUDA graph, its collectives inside;
               the graph must have replayed once a timed update at least)
               and eagerly, which must end with the same loss, state
               checksum and checksum of a report's scalars. Each rank must
               exit 0, the two ranks' losses must be finite and equal and
               their state checksums and their reports' equal (each worker
               reports on its rows after its updates, the scalars reduced
               over the ranks), and each rank must have launched
               observe_bwd and imagine_actor once an update and observe_fwd
               at least once. Each rank's launches go on the kernels line
               under `launches_parallel`, apart from the slice's and the
               proof's under `launches`. On the card only the replicas'
               agreement is checked: that the update's reductions combine
               the ranks as the JAX program's global batch does is checked
               against the JAX package on the CPU
               (tests/test_torch_multihost.py). Neither rate is a scaling
               figure: two ranks share one card. One card cannot hold two
               NCCL ranks, so no collective is captured here: at world 1
               each reduction is the identity (the extra phase
               `parallel_cards` captures them, one rank a card).
 10. imitation - the imitation trainer's PPO learner (imitation/ppo.py) at
               imitation/train.py's defaults on the card: observations of
               30 (A1's 16 proprio values and the task's 14 target
               features), 12 actions, a rollout of 2048 batch-1 `act`
               calls, then `gae` and two `update`s of 10 epochs x 4
               minibatches of 512 (the first and a warm one); each timed,
               for the default agent (`act` and `update` replay CUDA
               graphs) and for an eager twin (`graphs=False`) loaded from
               its `save()` with its generator state: every `act` output,
               both updates' metrics and the state after them must be
               equal bit for bit in the two arms.
               The card's machine has no MuJoCo, so the proprio part comes
               from a generator seeded by `--seed` and the targets from the
               trot clip at the sim's times. The update's metrics must be
               finite; the loss and its gradients on one minibatch must
               agree with a CPU agent loaded from the card's `save()`
               within 1e-4 of the largest magnitude, and so must that
               agent's values.
 11. tooling - the port's two instruments, as subprocesses:
               `scripts/profile_train.py --shape xarm --dispatches 1` (64
               updates from the device ring, 16 traced), whose trace must
               show observe_fwd's three device functions and observe_bwd's
               one launched once an update and a device busy time under
               the wall time; its wrappers' launches go on the kernels line
               under `launches_profile`. Then the same at `--shape a1`, the
               loop path, where no RSSM kernel may launch and the RSSM
               step's four must, each under its own name in the trace
               (`launches_profile_a1`). Then `scripts/policy_latency.py`
               at `--shape a1` and `--shape test`, on the card and on the
               host mirror; the card's whole policy call at a1 must take
               under 50 ms.
 12. soak    - the paper's deployment: the port's `scripts/async_soak.py`
               as a subprocess for 1.5 minutes, `run=learning` on the card
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
 13. bench   - the port's `scripts/bench.py` in this process at its three
               shapes (test, a1, xarm; from a device ring of 4096 steps),
               each eagerly and graphed (`torch.graphs` False and True,
               `bench.compare_graphs`), with short budgets: 3 s of
               windows an arm, one dispatch a window of 32 updates at
               test and 16 at a1 and xarm, each arm's batch-1 policy on
               the card at the test shape, then two windows of the
               (graphed) policy on the card and on the host mirror there.
               Every rate must be finite and positive, the update's work
               (`bench.train_cost`, FLOPs and bytes counted on the loop
               path by `nn.cost.CostMode`) above 0, the device named the
               card, every arm's share of the card's memory rate
               (`hbm_bw_util`) in (0, 1], and at xarm the MFU between 0
               and 1 and observe_fwd and observe_bwd launched once a timed
               update; those launches go on the kernels line under
               `launches_bench`. At xarm it also prints the configured
               agent's own count of an update (`train_device_cost`, the
               fused observe kernels by their formulas) beside the loop
               path's. The policy gates are printed, not asserted.
 14. graphs  - `torch.graphs` (on by default: every phase above and below
               runs its updates and policy steps as CUDA graphs but where
               it says otherwise) held to the eager path. For xarm (the
               fused observe chain and the fused rollout, so observe_fwd,
               observe_bwd and imagine_actor run inside the graph) and a1
               (the loop path), each with a uniform and a prioritized
               ring of 8192 steps half filled: an eager and a graphed agent
               from one state and one generator state make two dispatches
               of 4 updates each from the same ring; every state entry,
               every update's packed metrics, the carry and the priorities
               must be equal bit for bit, the kernels must be counted once
               an update (the graphed arm's launches credited at each
               replay), and each update's model loss must differ from the
               one before (replays draw other windows and other noise).
               After the capture, 1024 steps are added to the prioritized
               ring and a graphed dispatch must draw some of them. A
               registered generator must draw under replay what eager
               calls draw in turn. The xarm policy at batch 1 in each mode,
               eager and graphed, must give equal actions and states; the
               xarm `report` at the config's batch (32 x 32), four calls
               an arm from one generator state, must give every scalar and
               video equal bit for bit, and launch observe_fwd as often in
               each arm, at least once a call. It
               prints each arm's updates/s (the second dispatch), its
               first dispatch, the capture's seconds and the graph pool's
               bytes, and the policy's and the report's ms a call both
               ways. It runs after the kernel phase (`--phases
               device,build,graphs` alone). The parallel phase's gloo pair
               passes `--torch.graphs False`: its ranks share the card
               over gloo, which a graph cannot capture. Every update
               launches the four kernels of phase 15 as well: each must be
               counted in both arms, as often in each. Then two a1 updates
               the same way (uniform ring) at widths past those kernels'
               first layouts (GRAPHS_WIDTHS): `--rssm.classes 48
               --rssm.norm none`, and `--rssm.deter 4096 --rssm.classes 64
               --reward_head.units 4100`; the eager arm must hand the
               kernels those widths (no norm, D 4 096, 48 or 64 classes,
               rows of 4 100) and neither arm may call a plain version.
               Then two updates past the RSSM kernels' first layouts: a1
               with `--rssm.impl pallas --rssm.deter 20
               --rssm.prior_layers 9` (observe_fwd and observe_bwd at D 20
               on single values, the backward's wide path) and xarm with
               `--rssm.deter 2048 --rssm.prior_layers 0` (imagine_actor
               and observe_bwd on their workspaces, no prior layer).
 15. fused   - the kernels that stand for XLA's fusions on the update
               (ops/norm.py, ops/adam.py; run after the kernel phase,
               `--phases device,build,fused` alone). layer_norm_act's
               forward and backward against the plain version (the
               layer's F.layer_norm on the upcast input, its two casts and
               F.elu) and its autograd at each norm site of the xarm
               update (rows x C: 984 064 x 64, 921 600 x 64, 200 704 x
               128, 36 864 x 256, 4 096 x 512, 16 384 x 512, 1 024 x 1 536,
               the a1 GRU's 1 024 x 768, and 4 096 x 130) and of the a1
               update (32 x 256 and 32 x 768, a step of observe; 1 024 x
               256 and 1 024 x 512, a step of the rollout), in float32 and
               bfloat16, within the tolerances it prints, a second
               launch each way equal to the first bit for bit, with the
               times of kernel, plain version, F.layer_norm alone where it
               is the same function (float32, no activation) and the
               bound; first each instantiation's registers and spills from
               the build log; then rows past the layout that holds a row in
               registers (timed on the kernels the wrapper picks each
               way and held untimed on the other two: the staged or the
               streaming forward, the clusters' or the streaming
               backward, each by name in the trace): bfloat16 1 024 x
               4 100 and 1 024 x
               16 392, float32 1 024 x 12 292, each with the ELU and
               without (the extra phase `layer_norm`, not run by default,
               runs this part alone).
               Then the RSSM step's kernels (ops/gru.py, ops/onehot.py;
               the extra phase `rssm_step` runs this part alone): gru_cell
               forward and backward against the plain version (the norm of
               the gru_out product and the gates) and its autograd at a1's
               D = 256 and xarm's D = 512 on 1, 32 and 1 024 rows (a policy
               step, a step of the observe loop, a step of the rollout),
               and onehot_head (S = C = 32, unimix 0.01) on 1, 32 and 1 024
               rows with the sample and on 32 with the mode, on the same
               uniform draws, in float32 and bfloat16, within the
               tolerances they print: the samples must choose the same
               classes but at ties (counted), a second launch each way
               must equal the first bit for bit, the GRU backward must be
               one device kernel a call; with the times of kernel
               and plain version and the bound (no PyTorch call computes
               either: library none). Then the same checks at widths past
               their first layouts: the GRU cell without a norm (32 and
               1 024 rows of 256) and past D = 2 048 (1 x 2 049, 32 and
               1 024 rows of 4 096; timed on the kernels the wrapper picks
               each way, the block forward (the streaming one for float32's
               1 024 rows) and the clusters' backward, and held untimed on
               the streaming ones, each by name in the trace),
               the head at 3, 48, 64 and 256 classes (32 and 1 024 rows,
               sampled and the mode; both ways on the group kernels, by
               name in the trace). Each kernel's trace
               must hold one device kernel a call, or it is taken again.
               Then one xarm update with the kernels and one with the plain
               versions (`build.plain_versions()`) from one state and one
               generator state (eager, after two updates), in bfloat16 and
               in float32, and one a1 update the same way, each from
               `--fused-seeds` seeds (1 by default): the losses, the grad
               norms and each optimizer's update must agree within
               FUSED_TOLERANCE. At xarm the plain arm trains on the
               kernels' arm's imagined rollout, whose sampled choices may
               flip on a near tie, and the choices in which the two arms'
               own rollouts differ are counted. The optimizer's kernels on the tensors of
               that xarm update's three optimizers (recorded as it ran):
               adam_sumsq against the plain norm within 1e-5 relative,
               adam_update equal to the plain loop bit for bit from the same
               norm and state, and a NaN gradient that must give a NaN norm
               and change nothing; times of each, of the plain versions and
               of `torch._fused_adamw_` (a library kernel whose rounding
               order differs). Last, an optimizer module on the card fed a
               NaN loss must leave its parameters, moments and step as they
               were. The slice, a1, tooling and bench phases check that the
               four launch in every update and show their launches an
               update; the tooling phase's trace gives each its own row.
The kernel phase also holds observe_fwd and observe_bwd at the a1 training
shape (T = B = 32, D = U = 256, E = 512, 12 continuous actions), and
observe_fwd, observe_bwd and imagine_actor at the rows of one rank of the
parallel phase (xarm, T x B = 32 x 16, so 512 rows start the rollout),
against their plain versions.
The line before the last lists the kernels as JSON; the last line is
{"ok": true, "device": {...}}. Without a card, or outside the repository,
the script exits non-zero and prints no result. `--phases` runs a subset;
the extra phase `wide_paths` (not run by default) times both backwards
of rows past the plan, the clusters' and the streaming one, at a sweep of
widths and row counts of layer_norm_act and the GRU cell, the
forwards of LayerNorm rows past the plan (staged as the wrapper plans it,
staged at other block sizes and buffers, streaming) at the same widths
and rows, and the GRU cell's forwards past D = 2 048 (a block a row and
streaming)
(`--wide-paths forward`, `backward` or `gru_forward` sweeps those only),
and writes the
times to wide_paths.json in its run directory under runs/ (each time is
also logged); the extra phase `parallel_cards` (not run by default; it
needs two cards or more) runs one rank of the worker on each card over
NCCL at the parallel phase's settings, graphed and eagerly (on a machine
of four cards), so that the collectives captured in the graphs reduce
over real ranks: the ranks of each arm, and the two arms, must agree
exactly in the loss, the state's checksum and the report's; its ranks'
launches go under
`launches_parallel` as `cards_*`; the extra phase `profile` (not run by default) prints where an update's
device time goes, its launches and the device's idle share, at xarm (with
the fused rollout) and at a1 (the loop path), and
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
beside that of the JAX package's curve `scores/NAME_dreamer_tpu.json`; the
extra phase `impl_bench` (not run by default) runs the port's
`scripts/fused_impl_bench.py` (`rssm.impl` pallas against scan at a1 and
xarm) and `scripts/imag_impl_bench.py` (`imag_impl` at xarm) in this process
at their own budgets, 90 s of windows an arm, and writes their results under
`runs/chip_smoke_*_impl_bench/`.

The kernels line lists the six RSSM kernels, then the eight of XLA's
fusions (their `launches` those of the training slice, the RSSM step's
four those of its `--rssm.impl scan` run, `launches_a1` each kernel's in
the a1 phase's loop path; `library_ms`
`torch.nn.utils.get_total_norm` for adam_sumsq, `torch._fused_adamw_` for
adam_update, null for layer_norm_act, whose bfloat16 row no single call
computes, and for the GRU cell and the stats head). With
`--seed N` other than 0 the curve phase writes
`scores/NAME_dreamer_torch_sN.json`, so that seed 0's file stays.

`--compare NAME=SOURCE` (NAME one of imagine_actor, imagine, observe,
observe_fwd, observe_bwd, layer_norm, gru, onehot; the option may be given
several times) runs no
phase and prints no result line: it builds the kernel's source in the tree
and the other version of it in the file SOURCE (its includes beside it),
runs both on the xarm inputs of the kernel check, says whether their
outputs are equal bit for bit, and times them in turns (tree, other, other,
tree) in bfloat16 and float32 (observe at the xarm and a1 shapes of the proof
entry point; layer_norm at each site of LAYER_NORM_SITES and
WIDE_LAYER_NORM_SITES, forward and backward, after each version's
registers and spills, autograd of F.layer_norm beside the float32 sites
without an activation and F.layer_norm's forward beside the bfloat16
ones; gru at each site of GRU_SITES, in bfloat16
GRU_LARGE_SITES, and GRU_WIDE_SITES, onehot at each site of
HEAD_SITES, forward and backward, after each instantiation's registers and
spills, with the tree's own variants beside them: the GRU forward's
group of lanes a row, the head's classes a lane each way; the GRU's
forward at GRU_WIDE_SITES beside its bound; then the head at
HEAD_CLASSES, the times of both ways beside their bounds): how a change
to
a kernel is held against its parent inside one run.
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
  params['w_st'] = w(U if s['n_out'] else D, SC)
  params['b_st'] = t(rng.standard_normal(SC) * .1)
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


def check_imagine_actor(at='xarm', bf16_agree=0.9, **shape):
  """imagine_actor against its plain version at xarm's widths (`shape`
  overrides, e.g. the rows B), in float32 and bfloat16. `bf16_agree`: the
  share of (step, row) pairs that must agree in bfloat16; under 0.9 every
  row's first difference must also lie within 1e-1 of a tie."""
  import torch
  from daydreamer_tpu_torch.nn import cost
  from daydreamer_tpu_torch.ops import rssm
  H = XARM['H']
  widths = dict(XARM, **shape)
  results = {}
  for dtype in (torch.float32, torch.bfloat16):
    params, actor, stoch0, deter0, action0, gen = imagine_inputs(
        dtype, **shape)
    B, SC = stoch0.shape
    noise = (rssm.gumbel((H, B, SC), gen, stoch0.device),
             rssm.gumbel((H, B, widths['A']), gen, stoch0.device))
    args = (params, actor, stoch0, deter0, action0, H)
    kw = dict(noise=noise, unimix=0.01, act_unimix=0.1)
    out = rssm.imagine_actor_cuda(*args, **kw)
    torch.cuda.synchronize()
    ref = rssm.imagine_actor_plain(*args, **kw)
    d1, l1, s1, a1 = out
    d2, l2, s2, a2 = ref
    S, C, A = widths['S'], widths['C'], widths['A']
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
    bound = cost.bound(*rssm.imagine_actor_work(
        B, H, widths['D'], widths['U'], widths['S'], widths['C'],
        widths['A'], widths['n_out'], widths['n_act'], dtype), dtype)
    bound_ms, bound_by = bound['bound_ms'], bound['bound_by']
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
      ties = bf16_agree < 0.9
      tolerance = (f'valid one-hots, step 0 within 5e-2, >= '
                   f'{100 * bf16_agree:g} % of pairs agree, '
                   + ('every row that diverges first differs where the '
                      'plain scores lie within 1e-1, ' if ties else '')
                   + 'deters and logits within 5e-2 on agreeing rows')
      ok = (valid and err0 <= 5e-2 and agree >= bf16_agree
            and (not ties or max(gaps, default=0) <= 1e-1)
            and err_d <= 5e-2 and err_l <= 5e-2)
      max_err = max(err0, err_d, err_l)
    log(f'imagine_actor {at} (B = {B}) {name}: valid one-hots {valid}, '
        f'agreeing '
        f'(step, row) pairs {agree:.6f}, max |d deter| {err_d:.3g}, '
        f'max |d logit| {err_l:.3g} on agreeing rows, step-0 error '
        f'{err0:.3g}; {flips} (tolerance: {tolerance}); kernel '
        f'{ms:.4f} ms, plain '
        f'{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; '
        f'{bound["flops"] / 1e9:.1f} GFLOP, {bound["nbytes"] / 1e6:.1f} MB)')
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


def check_observe(shape, at='xarm', bf16_agree=0.98):
  """observe_fwd and observe_bwd against their plain versions at `shape`
  (its name `at` on every line), in float32 and bfloat16; in float32 also
  the whole gradient through ObserveFused. `bf16_agree`: the share of
  (step, row) samples that must agree in bfloat16."""
  import torch
  from daydreamer_tpu_torch.nn import cost
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
    dims = dict(T=T, B=B, A=shape['A'], D=shape['D'], U=shape['U'], S=S,
                C=C, n_out=shape['n_out'], dtype=dtype)
    bounds = {
        'observe_fwd': cost.bound(*ops.observe_fwd_work(
            E=shape['E'], **dims), dtype),
        'observe_bwd': cost.bound(*ops.observe_bwd_work(**dims), dtype)}
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
      tolerance = (f'valid one-hots, step 0 within 1e-3, >= '
                   f'{100 * bf16_agree:g} % of pairs agree, deters within '
                   f'8e-3 (two bf16 units) and logits within 2e-2 on '
                   f'agreeing rows')
      ok = (valid and err0 <= 1e-3 and agree >= bf16_agree
            and err_d <= 8e-3 and err_l <= 2e-2)
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


def _compare_rollout(label, kernel, plain, args, kw, dims, dtype, bound,
                     agree=(0.999, 0.8)):
  """One rollout kernel against its plain version on shared noise (kw), and
  again without noise. `agree`: the shares of (step, row) one-hots that
  must be equal in float32 and in bfloat16. Returns its entry of the
  result."""
  f32_agree, bf16_agree = agree
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
      tolerance = (f'valid one-hots, >= {100 * f32_agree:g} % of (step, '
                   f'row) one-hots equal, a first difference only within '
                   f'2e-4 of a tie, deters within 1e-5 and logits within '
                   f'1e-4 on rows that agree so far')
      ok = (valid and agree >= f32_agree and gap <= 2e-4 and err_d <= 1e-5
            and err_l <= 1e-4)
    else:
      # bf16 rounds each product and norm, so a sum that rounds the other
      # way can flip a choice and the rows drift apart over the steps;
      # without noise the scores of a group lie closer, so more flip.
      tolerance = (f'valid one-hots, step 0 within 5e-2, >= '
                   f'{100 * bf16_agree:g} % of (step, row) one-hots equal, '
                   f'a first difference only within 1e-1 of a tie, deters '
                   f'and logits within 5e-2 on rows that agree so far')
      ok = (valid and err0 <= 5e-2 and agree >= bf16_agree and gap <= 1e-1
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
  from daydreamer_tpu_torch.nn import cost
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
        cost.bound(*rssm.rollout_work(
            s['H'], s['B'], s['A'], s['D'], s['U'], s['S'], s['C'],
            s['n_out'], dtype), dtype))
    # observe: a chunk with first steps at step 0 and inside it.
    s = PROOF_OBSERVE
    params, data, is_first, noise, _ = observe_inputs(dtype, s)
    assert bool(is_first[1:].any()) and bool(is_first[0].any())
    results['observe'][name] = _compare_rollout(
        'observe', rssm.observe_cuda, rssm.observe_plain,
        (params, *data, is_first), dict(noise=noise, unimix=0.01),
        (s['T'], s['B'], s['S'], s['C']), dtype,
        cost.bound(*rssm.rollout_work(
            s['T'], s['B'], s['A'], s['D'], s['U'], s['S'], s['C'],
            s['n_out'], dtype, E=s['E']), dtype))
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
  bound = cost.bound(*lr.gve_work(H, n), torch.float32)
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


def compare_layer_norm(source):
  """`--compare layer_norm=SOURCE`: the tree's layer_norm.cu against
  another version of it with the same C interface, at each site of
  LAYER_NORM_SITES and WIDE_LAYER_NORM_SITES in its type (both types for
  the first): whether the two give the same bits (forward and backward;
  else their largest difference), and their device times in turns (tree,
  other, other, tree), with autograd of F.layer_norm beside them where it
  is the same function (float32, no activation). The other version gets
  `partial` as the wrappers sized it before they counted a launch's rows
  (a row a block of up to BWD_BLOCKS), which an older source may write,
  and the tree's parts that lie beside SOURCE (`layer_norm_cluster.cu`,
  `layer_norm_staged.cu`). Beside the bfloat16 sites without an activation
  F.layer_norm's forward on the bfloat16 row with the float32 scale and
  bias, where the installed PyTorch takes them, else with them cast to
  bfloat16 (logged which)."""
  import torch
  import torch.nn.functional as F
  from daydreamer_tpu_torch.nn import cost
  from daydreamer_tpu_torch.ops import build, norm
  tree = norm.LAYER_NORM_ACT_FWD
  source = pathlib.Path(source).resolve()
  other = build.Kernel('layer_norm_other', str(source), 'another version',
                       tree.signature, parts=[
                           str(source.parent / part.name)
                           for part in tree.parts
                           if (source.parent / part.name).exists()])
  build.build_all([tree, other])
  for kernel in (tree, other):
    layer_norm_registers(kernel)
  names = ('LAYER_NORM_ACT_FWD', 'LAYER_NORM_ACT_BWD')

  def run(kernel, fn):
    settings = {} if kernel is tree else {
        '_partial_rows': lambda rows, *_: min(norm.BWD_BLOCKS, rows)}
    with _swapped(norm, names, kernel, **settings):
      return fn()

  sites = [(torch.bfloat16, site) for site in LAYER_NORM_SITES] + [
      (torch.float32, site) for site in LAYER_NORM_SITES] + [
          (getattr(torch, name), site)
          for name, wide in WIDE_LAYER_NORM_SITES.items() for site in wide]
  for dtype, (rows, C, act) in sites:
    x, scale, bias, dy = _layer_norm_inputs(rows, C, dtype)
    fwd = lambda: norm.layer_norm_act_fwd_cuda(x, scale, bias, act)
    y, mean, rstd = fwd()
    bwd = lambda: norm.layer_norm_act_bwd_cuda(x, scale, bias, mean, rstd,
                                               dy, act)
    outs = [run(k, fwd) + run(k, bwd) for k in (tree, other)]
    equal, worst = _differ(*outs)
    times = [(label, run(k, lambda: device_ms(fwd, expect=1)),
              run(k, lambda: device_ms(bwd, expect=1)))
             for label, k in (('tree', tree), ('other', other),
                              ('other', other), ('tree', tree))]
    bound = cost.bound(*norm.layer_norm_act_work(
        rows, C, dtype, act, backward=True), dtype)
    library = ''
    if dtype == torch.float32 and act == 'none':
      leaves = [v.clone().requires_grad_() for v in (x, scale, bias)]
      lib = F.layer_norm(leaves[0], (C,), leaves[1], leaves[2], eps=norm.EPS)
      ms = device_ms(lambda: torch.autograd.grad(lib, leaves, dy,
                                                 retain_graph=True))
      library = f'; autograd of F.layer_norm backward {ms:.4f}'
      del lib, leaves
    if dtype == torch.bfloat16 and act == 'none':
      try:
        F.layer_norm(x, (C,), scale, bias, eps=norm.EPS)
        params, how = (scale, bias), 'float32 scale and bias'
      except RuntimeError:
        params = (scale.to(dtype), bias.to(dtype))
        how = 'scale and bias cast to bfloat16'
      ms = device_ms(lambda: F.layer_norm(x, (C,), *params, eps=norm.EPS))
      library = f'; F.layer_norm forward ({how}) {ms:.4f}'
    log(f'compare layer_norm {str(dtype).split(".")[-1]} rows {rows} x C '
        f'{C} ({act}): outputs equal bit for bit: {equal} (largest '
        f'difference {worst:.3g}); device ms forward / backward: '
        + ', '.join(f'{label} {f:.4f} / {b:.4f}' for label, f, b in times)
        + f'; backward bound {bound["bound_ms"]:.4f} {bound["bound_by"]}'
        + library)
    del x, dy, y, outs


def log_registers(kernel, functions):
  """Each instantiation of the kernels named in `functions` in `kernel`'s
  build log (ptxas -v) with its registers and spill bytes, logged."""
  found, function = {}, None
  for line in kernel.build_log().splitlines():
    match = _PTXAS_FUNCTION.search(line)
    if match:
      function = match[1]
      continue
    name = re.search(rf'({"|".join(functions)})I(\w*?)EEv', function or '')
    if name is None:
      continue
    row = found.setdefault(f'{name[1]}<{name[2]}>', [None, None, None])
    if _PTXAS_SPILLS.search(line):
      row[1:] = [int(v) for v in _PTXAS_SPILLS.search(line).groups()]
    if _PTXAS_REGISTERS.search(line):
      row[0] = int(_PTXAS_REGISTERS.search(line)[1])
  for name, (regs, stores, loads) in sorted(found.items()):
    log(f'{kernel.source.name} ({kernel.name}) {name}: {regs} registers, '
        f'spill stores {stores} bytes, spill loads {loads} bytes')
  if not found:
    raise AssertionError(f'the build log of {kernel.source.name} names no '
                         f'kernel of {functions}')


# The GRU backward past a1's and xarm's largest call, bfloat16 (2 048 x
# 1 024: the default config's rollout, batch 32 x chunk 64).
GRU_LARGE_SITES = ((2048, 256), (2048, 512), (2048, 1024), (4096, 512))


@contextlib.contextmanager
def _swapped(module, names, kernel, **settings):
  """Within the block the wrappers of `module` launch `kernel` for each of
  `names` (attributes of `module`) with the module's other `settings`."""
  saved = {n: getattr(module, n) for n in (*names, *settings)}
  for n in names:
    setattr(module, n, kernel)
  for n, value in settings.items():
    setattr(module, n, value)
  try:
    yield
  finally:
    for n, value in saved.items():
      setattr(module, n, value)


def _turns(label, runs):
  """Device ms of each (name, fn) in `runs` in turns: tree, other, other,
  tree for two, logged under `label`."""
  order = runs + runs[::-1]
  times = [(name, step_ms(fn, expect=1)) for name, fn in order]
  log(f"{label}: device ms " + ", ".join(f"{n} {ms:.5f}" for n, ms in times))


def _differ(a, b):
  """Whether two lists of tensors are equal bit for bit, and their largest
  difference."""
  import torch
  equal = all(torch.equal(x, y) for x, y in zip(a, b))
  worst = max(float((x.float() - y.float()).abs().max()) for x, y in zip(a, b))
  return equal, worst


def compare_gru(source):
  """`--compare gru=SOURCE`: the tree's gru.cu against another version of
  it with the same C interface, at each site of GRU_SITES in both types,
  forward and backward: each instantiation's registers and spills, whether
  the two give the same bits (else their largest difference), the
  backward's device kernels a call, and their device times in turns
  (tree, other, other, tree), the forward with the tree at a group of 32,
  64, 128 and 256 lanes a row beside them (`FWD_LANES` of rows x G); then,
  in bfloat16, the backward at GRU_LARGE_SITES, and in both types at
  GRU_WIDE_SITES (deters past MAX_D), with its bound, and there the
  forward too, with its bound, the tree's block forward on its 1 024
  threads' instantiation (FWD_BOUND 0) beside them. Both backwards read
  the tree's forward's mean and rstd, so that they take the same inputs
  where the two forwards sum a row in another order. The other version
  is built with the tree's parts that lie beside SOURCE (`gru_cluster.cu`,
  `gru_block_fwd.cu`) and gets the tree's wrappers' dims and `partial`,
  which the parent's source reads as it did."""
  import torch
  from daydreamer_tpu_torch.nn import cost
  from daydreamer_tpu_torch.ops import build, gru
  tree = gru.GRU_CELL_FWD
  source = pathlib.Path(source).resolve()
  other = build.Kernel('gru_other', str(source), 'another version',
                       tree.signature, parts=[
                           str(source.parent / part.name)
                           for part in tree.parts
                           if (source.parent / part.name).exists()])
  build.build_all([tree, other])
  for kernel in (tree, other):
    log_registers(kernel, ('gru_fwd_kernel', 'gru_bwd_kernel',
                           'gru_cluster_bwd_kernel', 'gru_block_fwd_kernel',
                           'gru_wide_fwd_kernel'))
  names = ('GRU_CELL_FWD', 'GRU_CELL_BWD')

  def under(kernel, fn, **settings):
    def call():
      with _swapped(gru, names, kernel, **settings):
        return fn()
    return call

  for dtype in (torch.bfloat16, torch.float32):
    name = str(dtype).split('.')[-1]
    for rows, D in GRU_SITES + (GRU_LARGE_SITES if name == 'bfloat16'
                                else ()) + GRU_WIDE_SITES:
      x, deter, scale, bias, dout = _gru_inputs(rows, D, dtype)
      fwd = lambda: gru.gru_cell_fwd_cuda(x, deter, scale, bias)
      out, mean, rstd = under(tree, fwd)()
      bwd = lambda: gru.gru_cell_bwd_cuda(x, deter, scale, bias, mean, rstd,
                                          dout)
      tree_bwd, other_bwd = under(tree, bwd), under(other, bwd)
      fwd_equal, fwd_worst = _differ(under(tree, fwd)(), under(other, fwd)())
      bwd_equal, bwd_worst = _differ(tree_bwd(), other_bwd())
      _, kernels = step_ms(tree_bwd, kernels=True)
      _, other_kernels = step_ms(other_bwd, kernels=True)
      label = f'compare gru {name} rows {rows} x D {D}'
      log(f'{label}: forward equal bit for bit {fwd_equal} (largest '
          f'difference {fwd_worst:.3g}); backward equal bit for bit '
          f'{bwd_equal} (largest difference {bwd_worst:.3g}); backward device'
          f' kernels a call: tree {kernels:g}, other {other_kernels:g}')
      if (rows, D) in GRU_SITES:
        _turns(f'{label} forward', [
            ('tree', under(tree, fwd)), ('other', under(other, fwd)),
            *[(f'G {G}', under(tree, fwd, FWD_LANES=rows * G))
              for G in (32, 64, 128, 256)]])
      if (rows, D) in GRU_WIDE_SITES:
        bound = cost.bound(*gru.gru_cell_work(rows, D, dtype), dtype)
        _turns(f'{label} forward (bound {bound["bound_ms"]:.4f} '
               f'{bound["bound_by"]}; tree {gru.fwd_plan(rows, D, dtype)})',
               [('tree', under(tree, fwd)), ('other', under(other, fwd)),
                ('tree at the 1 024 bound', under(tree, fwd, FWD_BOUND=0))])
      bound = cost.bound(*gru.gru_cell_work(rows, D, dtype, backward=True),
                         dtype)
      _turns(f'{label} backward (bound {bound["bound_ms"]:.4f} '
             f'{bound["bound_by"]})', [('tree', tree_bwd),
                                       ('other', other_bwd)])
      del x, deter, dout


def compare_onehot(source):
  """`--compare onehot=SOURCE`: the tree's onehot.cu against another
  version of it with the same C interface, at each site of HEAD_SITES in
  both types, forward and backward (both backwards on the tree's forward's
  logit, so that they take the same inputs): each instantiation's
  registers and spills, whether the two give the same bits (else the
  largest difference of the logits and the groups whose sample differs),
  and their device times in turns (tree, other, other, tree), the tree at
  2 and 8 classes a lane forward and at 2, 4 and 8 backward beside
  them; then at each of HEAD_CLASSES (the general path) on 32 and 1 024
  rows, sampled and the mode, both types, the bits of both ways and the
  times of both ways in turns, each beside its bound, the forward with
  the tree at its other rule of classes a lane beside them."""
  import torch
  from daydreamer_tpu_torch.nn import cost
  from daydreamer_tpu_torch.ops import build, onehot
  tree = onehot.ONEHOT_HEAD_FWD
  other = build.Kernel('onehot_other', str(pathlib.Path(source).resolve()),
                       'another version', tree.signature)
  build.build_all([tree, other])
  for kernel in (tree, other):
    log_registers(kernel, ('onehot_fwd_kernel', 'onehot_bwd_kernel',
                           'onehot_any_fwd_kernel', 'onehot_any_bwd_kernel',
                           'onehot_group_fwd_kernel',
                           'onehot_group_bwd_kernel'))
  names = ('ONEHOT_HEAD_FWD', 'ONEHOT_HEAD_BWD')

  def under(kernel, fn, **settings):
    def call():
      with _swapped(onehot, names, kernel, **settings):
        return fn()
    return call

  unimix = HEAD_UNIMIX
  for dtype in (torch.bfloat16, torch.float32):
    name = str(dtype).split('.')[-1]
    for rows, sample in HEAD_SITES:
      raw, u, dlogit, dstoch = _head_inputs(rows, sample, dtype)
      fwd = lambda: onehot.onehot_head_fwd_cuda(raw, u, unimix)
      logit, stoch = under(tree, fwd)()
      bwd = lambda: onehot.onehot_head_bwd_cuda(raw, logit, dlogit, dstoch,
                                                unimix, sample)
      theirs = under(other, fwd)()
      fwd_equal, fwd_worst = _differ((logit, stoch), theirs)
      choices = int((stoch.argmax(-1) != theirs[1].argmax(-1)).sum())
      bwd_equal, bwd_worst = _differ([under(tree, bwd)()],
                                     [under(other, bwd)()])
      label = (f'compare onehot {name} rows {rows} x {HEAD_S} x {HEAD_C} '
               f'({"sample" if sample else "mode"})')
      log(f'{label}: forward equal bit for bit {fwd_equal} (largest '
          f'difference {fwd_worst:.3g}, {choices} of {rows * HEAD_S} groups '
          f'choose another class); backward equal bit for bit {bwd_equal} '
          f'(largest difference {bwd_worst:.3g})')
      _turns(f'{label} forward', [
          ('tree', under(tree, fwd)), ('other', under(other, fwd)),
          *[(f'{k} a lane', under(tree, fwd, LANE_CLASSES=k))
            for k in (2, 8)]])
      _turns(f'{label} backward', [
          ('tree', under(tree, bwd)), ('other', under(other, bwd)),
          *[(f'{k} a lane', under(tree, bwd, BWD_LANE_CLASSES=k))
            for k in (2, 4, 8)]])
    for C in HEAD_CLASSES:
      for rows, sample in HEAD_CLASS_SITES:
        raw, u, dlogit, dstoch = _head_inputs(rows, sample, dtype, C=C)
        fwd = lambda: onehot.onehot_head_fwd_cuda(raw, u, unimix)
        logit, stoch = under(tree, fwd)()
        fwd_equal, fwd_worst = _differ((logit, stoch), under(other, fwd)())
        bwd = lambda: onehot.onehot_head_bwd_cuda(raw, logit, dlogit, dstoch,
                                                  unimix, sample)
        bwd_equal, bwd_worst = _differ([under(tree, bwd)()],
                                       [under(other, bwd)()])
        fwd_bound, bound = [cost.bound(*onehot.onehot_head_work(
            rows, HEAD_S, C, dtype, unimix, sample, backward=b), dtype)
                            for b in (False, True)]
        label = (f'compare onehot {name} rows {rows} x {HEAD_S} x {C} '
                 f'({"sample" if sample else "mode"})')
        log(f'{label}: forward equal bit for bit {fwd_equal} (largest '
            f'difference {fwd_worst:.3g}); backward equal bit for bit '
            f'{bwd_equal} (largest difference {bwd_worst:.3g})')
        # The tree at the other rule of its classes a lane
        # (`onehot.fwd_lane_classes`: few values' or many values').
        few = onehot.fwd_lane_classes(C, dtype, rows * HEAD_S * C) != (
            onehot.fwd_lane_classes(C, dtype, 1 << 62))
        _turns(f'{label} forward (bound {fwd_bound["bound_ms"]:.4f} '
               f'{fwd_bound["bound_by"]})',
               [('tree', under(tree, fwd)), ('other', under(other, fwd)),
                (f'{"many" if few else "few"} values\' classes a lane',
                 under(tree, fwd,
                       GROUP_WIDE_LANES=0 if few else 1 << 62))])
        _turns(f'{label} backward (bound {bound["bound_ms"]:.4f} '
               f'{bound["bound_by"]})',
               [('tree', under(tree, bwd)), ('other', under(other, bwd))])
        del raw, u, dlogit, dstoch, logit, stoch


def phase_compare(spec):
  """The tree's build of a CUDA kernel against another version of its
  source (see the module docstring)."""
  import torch
  from daydreamer_tpu_torch.ops import build, rssm, rssm_vjp
  name, _, source = spec.partition('=')
  own = {'layer_norm': compare_layer_norm, 'gru': compare_gru,
         'onehot': compare_onehot}
  if name in own and source:
    return own[name](source)
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
  check_rssm_widths(observe_shape('xarm', XARM_OBSERVE))
  return results


# The RSSM kernels at widths past their first layouts, each of which the
# JAX package's kernels take: (label, widths) on a1's (or xarm's) shapes.
# The fused observe chain (observe_fwd, observe_bwd) at a1's training
# shape: the audit's deter 20, units 12, 3 x 4 latents (4 bfloat16 values
# a load, the float32 loads whole), no prior layer, 9 prior layers (the
# backward's wide path); at xarm's with a deter of 2 048 (the backward's
# workspace). In bfloat16 a deter four times xarm's carries four times the
# roundings a step, each of which may land on the other side and move a
# near tie of the sample: the first run there agreed on 97.56 % of the
# (step, row) samples (float32: all), every logit within the tolerance up
# to a row's first difference; that site is held to 95 %.
WIDTH_OBSERVE_SITES = (
    ('a1 D 20 U 12 3x4', dict(D=20, U=12, S=3, C=4)),
    ('a1 0 prior layers', dict(n_out=0)),
    ('a1 9 prior layers', dict(n_out=9)),
)
# imagine_actor on xarm's 1 024 rows: deters of 2 048 and 4 096 at U 256,
# 32 x 32 latents and 12 actions (the products' sums in the workspace);
# 9 actor layers and no prior layer at xarm's widths. In bfloat16 the wide
# deters carry four and eight times xarm's roundings a step (the first run
# at 2 048 agreed on 89.59 % of the pairs, every first difference within
# 0.0135 of a tie; float32 on all): they are held to the rule of the proof
# kernels' bfloat16 rows (`_compare_rollout`), >= 80 % and every first
# difference within 1e-1 of a tie. As (label, bfloat16 agreement, widths).
WIDTH_ACTOR_SITES = (
    ('D 2048', 0.8, dict(D=2048, U=256, A=12)),
    ('D 4096', 0.8, dict(D=4096, U=256, A=12)),
    ('9 actor layers', 0.9, dict(n_act=9)),
    ('0 prior layers', 0.9, dict(n_out=0)),
)
# imagine and observe (the proof kernels) at the proof entry point's xarm
# shapes with: a deter of 2 048 at U 256 and 12 actions, no prior layer, 9
# prior layers (imagine); a deter of 4 096 at U 512, the audit's D 20, U
# 12, 3 x 4 (observe). A wide deter's sums, and 9 layers each rounded to
# bfloat16, meet more near ties of the argmax, and a row's history differs
# from its first flip on (the first runs, unsampled: imagine at 2 048
# 99.83 % equal in float32, every first difference within 1.2e-7 of a tie,
# 63.72 % in bfloat16, within 0.0108; with 9 prior layers 72.21 % in
# bfloat16, within 0.0199): those sites hold 99.5 % and 50 %, each first
# difference still within 2e-4 (float32) or 1e-1 (bfloat16) of a tie. As
# (label, (float32, bfloat16) agreement, widths).
WIDE_AGREE = (0.995, 0.5)
WIDTH_IMAGINE_SITES = (
    ('D 2048', WIDE_AGREE, dict(D=2048, U=256, A=12)),
    ('0 prior layers', (0.999, 0.8), dict(n_out=0)),
    ('9 prior layers', WIDE_AGREE, dict(n_out=9)),
)
WIDTH_PROOF_OBSERVE_SITES = (
    ('D 4096 U 512', WIDE_AGREE, dict(D=4096)),
    ('D 20 U 12 3x4', (0.999, 0.8), dict(D=20, U=12, S=3, C=4)),
)


def check_rssm_widths(xarm_shape):
  """The RSSM kernels at WIDTH_*_SITES against their plain versions, in
  float32 and bfloat16, with the checks, tolerances, times and bounds of
  their shipped sites. Returns {kernel: {site: {dtype: entry}}}."""
  import torch
  from daydreamer_tpu_torch.nn import cost
  from daydreamer_tpu_torch.ops import rssm
  results = {}
  a1 = dict(A1_OBSERVE, unimix=0.01)
  for label, widths in WIDTH_OBSERVE_SITES + (
      ('xarm D 2048', dict(xarm_shape, D=2048)),):
    base = xarm_shape if label.startswith('xarm') else a1
    checked = check_observe(dict(base, **widths), label,
                            0.95 if label.startswith('xarm') else 0.98)
    for kernel, rows in checked.items():
      results.setdefault(kernel, {})[label] = rows
  for label, agree, widths in WIDTH_ACTOR_SITES:
    results.setdefault('imagine_actor', {})[label] = check_imagine_actor(
        label, agree, **widths)
  for label, agree, widths in WIDTH_IMAGINE_SITES:
    s = dict(PROOF_IMAGINE, **widths)
    for dtype in (torch.float32, torch.bfloat16):
      params, _, stoch0, deter0, _, _ = imagine_inputs(
          dtype, **{k: s[k] for k in ('A', 'B', 'D', 'U', 'n_out')})
      rng = np.random.default_rng(2)
      dev = stoch0.device
      actions = torch.as_tensor(rng.standard_normal(
          (s['H'], s['B'], s['A'])).astype(np.float32)).to(dev, dtype)
      noise = torch.as_tensor(rng.gumbel(
          size=(s['H'], s['B'], s['S'] * s['C'])).astype(np.float32)).to(dev)
      results.setdefault('imagine', {}).setdefault(label, {})[
          str(dtype).split('.')[-1]] = _compare_rollout(
              f'imagine {label}', rssm.imagine_cuda, rssm.imagine_plain,
              (params, stoch0, deter0, actions),
              dict(noise=noise, unimix=0.01),
              (s['H'], s['B'], s['S'], s['C']), dtype,
              cost.bound(*rssm.rollout_work(
                  s['H'], s['B'], s['A'], s['D'], s['U'], s['S'], s['C'],
                  s['n_out'], dtype), dtype), agree)
  for label, agree, widths in WIDTH_PROOF_OBSERVE_SITES:
    s = dict(PROOF_OBSERVE, **widths)
    for dtype in (torch.float32, torch.bfloat16):
      params, data, is_first, noise, _ = observe_inputs(dtype, s)
      results.setdefault('observe', {}).setdefault(label, {})[
          str(dtype).split('.')[-1]] = _compare_rollout(
              f'observe {label}', rssm.observe_cuda, rssm.observe_plain,
              (params, *data, is_first), dict(noise=noise, unimix=0.01),
              (s['T'], s['B'], s['S'], s['C']), dtype,
              cost.bound(*rssm.rollout_work(
                  s['T'], s['B'], s['A'], s['D'], s['U'], s['S'], s['C'],
                  s['n_out'], dtype, E=s['E']), dtype), agree)
  log(f'rssm widths: {json.dumps(results)}')
  return results


# --------------------------------------------------------------------------
# The counterparts of XLA's fusions on the learner's update: layer_norm_act
# (forward and backward) and the optimizer's two kernels.


# (rows, C, act) of the norms of the xarm update, largest first: the image
# encoder's four stages (1024 frames x 31 x 31, 14 x 14, 6 x 6, 2 x 2
# positions), the decoder's last stage (30 x 30), the MLPs and heads over
# the 16 x B x T rows of the imagined trajectories, the GRU's norm over
# 3 x 512 columns (a1: 3 x 256) without an activation, and a width that is
# no multiple of 32 (nor of a vector). Then a1's: a step of the observe
# loop (B = 32 rows: the RSSM's layers at 256 with the ELU, the GRU's norm
# at 768 without) and of the imagined rollout (1 024 rows at 256 and 512).
LAYER_NORM_SITES = (
    (1024 * 961, 64, 'elu'), (1024 * 900, 64, 'elu'), (1024 * 196, 128, 'elu'),
    (1024 * 36, 256, 'elu'), (1024 * 4, 512, 'elu'), (16 * 1024, 512, 'elu'),
    (1024, 1536, 'none'), (1024, 768, 'none'), (4096, 130, 'elu'),
    (32, 256, 'elu'), (32, 768, 'none'), (1024, 256, 'elu'),
    (1024, 512, 'elu'))


# ptxas -v's lines in a build log: the function it compiles, then its
# stack and spills, then its registers.
_PTXAS_FUNCTION = re.compile(r"(?:Compiling entry function|Function "
                             r"properties for) '?(\w+)'?")
_PTXAS_SPILLS = re.compile(r'(\d+) bytes spill stores, (\d+) bytes spill '
                           r'loads')
_PTXAS_REGISTERS = re.compile(r'Used (\d+) registers')
# A layer_norm.cu kernel's mangled name: kernel, T, VEC and N where the
# kernel has one.
_LN_MANGLED = re.compile(r'(ln_\w+?_kernel)I(13__nv_bfloat16|f)Li(\d+)E'
                         r'(?:Li(\d+)E)?')


def layer_norm_registers(kernel=None):
  """Each instantiation of layer_norm.cu's kernels with its registers and
  spill bytes, from ptxas -v in the build log (of `kernel`, by default the
  tree's layer_norm.cu): rows of (kernel, type, VEC, N, registers, spill
  stores, spill loads), logged; N is 0 where the kernel has none."""
  from daydreamer_tpu_torch.ops import norm
  kernel = kernel or norm.LAYER_NORM_ACT_FWD
  found, function = {}, None
  for line in kernel.build_log().splitlines():
    match = _PTXAS_FUNCTION.search(line)
    if match:
      function = match[1]
      continue
    name = _LN_MANGLED.search(function or '')
    if name is None:
      continue
    kernel_name, dtype, vec, n = name.groups()
    row = found.setdefault((kernel_name, dtype, vec, n or '0'),
                           [None, None, None])
    if _PTXAS_SPILLS.search(line):
      row[1:] = [int(v) for v in _PTXAS_SPILLS.search(line).groups()]
    if _PTXAS_REGISTERS.search(line):
      row[0] = int(_PTXAS_REGISTERS.search(line)[1])
  rows, source = [], kernel.source.name
  for (kernel, dtype, vec, n), (regs, stores, loads) in sorted(
      found.items(), key=lambda kv: (kv[0][0], kv[0][1], int(kv[0][2]),
                                     int(kv[0][3]))):
    dtype = 'bfloat16' if 'bfloat16' in dtype else 'float32'
    rows.append((kernel, dtype, int(vec), int(n), regs, stores, loads))
    log(f'{source} {kernel}<{dtype}, VEC {vec}, N {n}>: {regs} '
        f'registers, spill stores {stores} bytes, spill loads {loads} bytes')
  if not rows:
    raise AssertionError('the build log of layer_norm.cu names no kernel')
  return rows


def device_ms(fn, calls=10, tries=3, kernels=False, expect=None):
  """Device time of one call of `fn`, ms: the sum over the CUDA kernels
  it launches (torch.profiler, `device_times`), without the host's time
  between them, as a replay of a CUDA graph runs them; with `kernels`,
  (ms, device kernels a call). The profiler now and then loses some or
  all of a trace's kernels (at a few microseconds a launch, often one of
  a window of 100). A trace that holds no device time is taken again,
  `tries` times in all, and then it raises. Where `expect` gives the
  device kernels a call, the time is that of the launches the trace
  holds, times `expect`, and a trace that lost more than one launch of the
  window is taken again too; if every one of the `tries` did, the one
  that held the most launches is used (logged), and one that held more
  than the window's launches raises."""
  best = None
  for attempt in range(tries):
    times = device_times(fn, calls)
    count = sum(n for _, n in times.values())
    if times and expect is not None and round((count - expect) * calls) > 1:
      raise AssertionError(f'device_ms: {count:g} device kernels a call, '
                           f'not {expect:g}')
    if times and (expect is None or round((expect - count) * calls) <= 1):
      best = times
      break
    held = (f'{count:g} device kernels a call, not {expect:g}' if times
            else 'no device time')
    log(f'device_ms: trace {attempt + 1} of {tries} held {held}')
    if times and (best is None or count > sum(
        n for _, n in best.values())):
      best = times
  else:
    if best is None:
      raise AssertionError(f'the profiler saw no device time in {tries} '
                           'traces')
    log(f'device_ms: timed from the trace of '
        f'{sum(n for _, n in best.values()):g} device kernels a call, the '
        'most of the tries')
  ms = sum(ms for ms, _ in best.values())
  count = sum(n for _, n in best.values())
  if expect is not None:
    ms *= expect / count
  return (ms, count) if kernels else ms


def _layer_norm_inputs(rows, C, dtype, seed=0, device='cuda'):
  import torch
  gen = torch.Generator(device=device).manual_seed(seed)
  rand = lambda *shape: torch.randn(*shape, generator=gen, device=device)
  x = (3 * rand(rows, C) + 1).to(dtype)
  return x, 1 + 0.2 * rand(C), 0.3 * rand(C), rand(rows, C).to(dtype)


def check_layer_norm(sites=LAYER_NORM_SITES, device='cuda',
                     dtypes=('float32', 'bfloat16'), backward_kernel=None,
                     timed=True, forward_kernel=None):
  """layer_norm_act's two kernels against the plain version (the layer's
  F.layer_norm on the upcast input, its two casts and the F.elu) and its
  autograd at each site of LAYER_NORM_SITES, in float32 and bfloat16, with
  the times of both and the bound. The plain version is the library's
  composition; `library_ms` times one library call where one computes the
  same function, F.layer_norm itself in float32 without an activation,
  and is None elsewhere: no call fuses the norm with the ELU, nor in
  bfloat16 with its casts (F.layer_norm takes scale and bias in x's dtype
  there). Each kernel's trace must hold one device kernel a call
  (`device_ms`'s `expect`), and where `backward_kernel` (`forward_kernel`)
  names one, the backward's (forward's) must be that kernel. `dtypes`
  names the types to check;
  without `timed` nothing is timed. Returns the rows of the largest site,
  the encoder's first stage."""
  import torch
  import torch.nn.functional as F
  from daydreamer_tpu_torch.nn import cost
  from daydreamer_tpu_torch.ops import norm
  results = {}
  for dtype in [getattr(torch, name) for name in dtypes]:
    name = str(dtype).split('.')[-1]
    for rows, C, act in sites:
      x, scale, bias, dy = _layer_norm_inputs(rows, C, dtype, device=device)
      y, mean, rstd = norm.layer_norm_act_fwd_cuda(x, scale, bias, act)
      got = norm.layer_norm_act_bwd_cuda(x, scale, bias, mean, rstd, dy, act)
      # A second launch on the same inputs: the same bits (the sums over
      # blocks in a fixed order, the counters reset by the first).
      same = all(torch.equal(a, b) for a, b in zip(got, (
          norm.layer_norm_act_bwd_cuda(x, scale, bias, mean, rstd, dy, act))))
      # A second forward launch: the same bits.
      same &= all(torch.equal(a, b) for a, b in zip(
          (y, mean, rstd), norm.layer_norm_act_fwd_cuda(x, scale, bias, act)))
      if forward_kernel is not None:
        _expect_kernel(forward_kernel, lambda: norm.layer_norm_act_fwd_cuda(
            x, scale, bias, act), 'forward')
      if backward_kernel is not None:
        _expect_kernel(backward_kernel, lambda: norm.layer_norm_act_bwd_cuda(
            x, scale, bias, mean, rstd, dy, act))
      leaves = [v.clone().requires_grad_() for v in (x, scale, bias)]
      ref = norm.layer_norm_act_plain(*leaves, act)
      want = torch.autograd.grad(ref, leaves, dy, retain_graph=True)
      ref = ref.detach()
      # Forward: float32 the same arithmetic in another order; bfloat16 a
      # value may round to the other side: one unit in the last place.
      fwd = float(((y.float() - ref.float()).abs()
                   / ref.float().abs().clamp_min(1)).max())
      # Backward, scaled by each tensor's largest magnitude: dx within 1e-4
      # in float32, dscale and dbias (sums over up to 984 064 rows in
      # another order) within 1e-3; in bfloat16 a rounding of y or of the
      # ELU's gradient that falls the other way moves the row sums: 2e-2.
      scaled = [float((g.float() - w.float()).abs().max())
                / max(1e-6, float(w.float().abs().max()))
                for g, w in zip(got, want)]
      limits = ((1e-5, (1e-4, 1e-3, 1e-3)) if dtype == torch.float32
                else (2 ** -7, (2e-2, 2e-2, 2e-2)))
      ok = (fwd <= limits[0] and same
            and all(e <= lim for e, lim in zip(scaled, limits[1]))
            and all(bool(torch.isfinite(g).all()) for g in got))
      timings, again = '', None
      if timed:
        work = [cost.bound(*norm.layer_norm_act_work(
            rows, C, dtype, act, backward=b), dtype) for b in (False, True)]
        # Device times (`device_ms`); the call's time with the host's
        # (`cuda_time`) beside the kernel's.
        fwd_call = lambda: norm.layer_norm_act_fwd_cuda(x, scale, bias, act)
        bwd_call = lambda: norm.layer_norm_act_bwd_cuda(
            x, scale, bias, mean, rstd, dy, act)
        ms, bwd_ms = device_ms(fwd_call, expect=1), device_ms(bwd_call,
                                                                expect=1)
        call_ms, bwd_call_ms = cuda_time(fwd_call), cuda_time(bwd_call)
        plain_ms = device_ms(lambda: norm.layer_norm_act_plain(
            x, scale, bias, act))
        again = norm.layer_norm_act_plain(*leaves, act)
        plain_bwd_ms = device_ms(lambda: torch.autograd.grad(
            again, leaves, dy, retain_graph=True))
        library_ms = library_bwd_ms = None
        if dtype == torch.float32 and act == 'none':
          library_ms = device_ms(lambda: F.layer_norm(
              x, (C,), scale, bias, eps=norm.EPS))
          lib = F.layer_norm(leaves[0], (C,), leaves[1], leaves[2],
                             eps=norm.EPS)
          library_bwd_ms = device_ms(lambda: torch.autograd.grad(
              lib, leaves, dy, retain_graph=True))
          del lib
        library = lambda ms: 'none' if ms is None else f'{ms:.4f}'
        timings = (
            f'; device ms: forward {ms:.4f} (a call with the host '
            f'{call_ms:.4f}; plain {plain_ms:.4f}, library '
            f'{library(library_ms)}, bound {work[0]["bound_ms"]:.4f} '
            f'{work[0]["bound_by"]}), backward {bwd_ms:.4f} (a call '
            f'{bwd_call_ms:.4f}; plain {plain_bwd_ms:.4f}, library '
            f'{library(library_bwd_ms)}, bound {work[1]["bound_ms"]:.4f} '
            f'{work[1]["bound_by"]})')
      log(f'layer_norm_act {name} rows {rows} x C {C} ({act}): forward '
          f'error {fwd:.3g} (tolerance {limits[0]:g} of max(|y|, 1)), '
          f'backward scaled errors dx {scaled[0]:.3g}, dscale '
          f'{scaled[1]:.3g}, dbias {scaled[2]:.3g} (tolerances '
          f'{limits[1]}), two launches each way equal {same}' + timings)
      if not ok:
        raise AssertionError(f'layer_norm_act disagrees with its plain '
                             f'version in {name} at rows {rows} x C {C}.')
      if timed and (rows, C) == sites[0][:2]:
        results.setdefault('layer_norm_act_fwd', {})[name] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=work[0]['bound_ms'], bound_by=work[0]['bound_by'],
            max_abs_err=float((y.float() - ref.float()).abs().max()))
        results.setdefault('layer_norm_act_bwd', {})[name] = dict(
            ms=bwd_ms, plain_ms=plain_bwd_ms, library_ms=library_bwd_ms,
            bound_ms=work[1]['bound_ms'], bound_by=work[1]['bound_by'],
            max_abs_err=max(float((g.float() - w.float()).abs().max())
                            for g, w in zip(got, want)))
      del x, y, got, want, leaves, ref, again
  return results


# (rows, D) of the GRU cell's calls (`RSSM._gru` after its product): a1
# (D = 256) and xarm (D = 512) at a policy step (1 row), a step of the
# observe loop (B = 32 rows) and a step of the imagined rollout (1 024 rows,
# B x T start states). The largest, xarm's rollout, goes on the kernels
# line.
GRU_SITES = ((1, 256), (32, 256), (1024, 256), (1, 512), (32, 512),
             (1024, 512))
# (rows, sample) of the categorical stats head, S = C = 32 and the configs'
# unimix 0.01: a policy step, a step of the observe loop (its two samples,
# and the mode of `initial()`'s `get_stoch` at the same rows), a step of the
# rollout. The rollout's goes on the kernels line.
HEAD_SITES = ((1, True), (32, True), (32, False), (1024, True))
HEAD_S = HEAD_C = 32
HEAD_UNIMIX = 0.01


def step_ms(fn, kernels=False, expect=None):
  """`device_ms` over 100 calls: the RSSM step's kernels take 2-20 us a
  call, and the profiler has lost every kernel of a 10-call window of such
  kernels, three traces running."""
  return device_ms(fn, calls=100, kernels=kernels, expect=expect)


def _scaled_max(got, want):
  """The largest |got - want| of each pair over the pair's largest |want|."""
  return [float((g.float() - w.float()).abs().max())
          / max(1e-6, float(w.float().abs().max())) for g, w in zip(got, want)]


def _gru_inputs(rows, D, dtype, device='cuda'):
  """x, deter, scale, bias and the new deter's gradient of a GRU site,
  from a seed."""
  import torch
  gen = torch.Generator(device=device).manual_seed(rows + D)
  rand = lambda *shape: torch.randn(*shape, generator=gen, device=device)
  x = (2 * rand(rows, 3 * D) + 0.5).to(dtype)
  deter = torch.tanh(rand(rows, D)).to(dtype)
  scale, bias = 1 + 0.2 * rand(3 * D), 0.3 * rand(3 * D)
  return x, deter, scale, bias, rand(rows, D).to(dtype)


def _head_inputs(rows, sample, dtype, device='cuda', C=HEAD_C):
  """raw, the uniform draws (None for the mode), and the gradients of
  logit and stoch of a stats head site of C classes, from a seed."""
  import torch
  S = HEAD_S
  gen = torch.Generator(device=device).manual_seed(
      rows + sample + (C != HEAD_C) * C)
  rand = lambda *shape: torch.randn(*shape, generator=gen, device=device)
  raw = (2 * rand(rows, S, C)).to(dtype)
  u = torch.rand(rows, S, C, generator=gen, device=device) if sample else (
      None)
  return raw, u, rand(rows, S, C).to(dtype), rand(rows, S, C).to(dtype)


def check_gru_cell(sites=GRU_SITES, device='cuda', normed=True,
                   backward_kernel=None, timed=True, forward_kernel=None):
  """gru_cell's two kernels against the plain version (the RSSM's norm of
  the product and its gates, `gru.gru_cell_plain`; without `normed`, the
  gates on the product itself, `norm: none`) and its autograd at each
  site of GRU_SITES, in float32 and bfloat16, with the times of both and
  the bound; each kernel's trace must hold one device kernel a call. No
  PyTorch call computes the cell: `torch.nn.GRUCell` applies the reset
  inside its product and has no update bias of -1 nor a norm, so
  `library_ms` is None. Where `backward_kernel` (`forward_kernel`) gives
  a kernel (a name, or a function of rows, D and dtype that returns it),
  the backward's (forward's) trace must hold it; without `timed` nothing
  is timed. Returns the rows of the largest site."""
  import torch
  from daydreamer_tpu_torch.nn import cost
  from daydreamer_tpu_torch.ops import gru
  results = {}
  for dtype in (torch.float32, torch.bfloat16):
    name = str(dtype).split('.')[-1]
    for rows, D in sites:
      x, deter, scale, bias, dout = _gru_inputs(rows, D, dtype, device)
      if not normed:
        scale = bias = None
      out, mean, rstd = gru.gru_cell_fwd_cuda(x, deter, scale, bias)
      args = (x, deter, scale, bias, mean, rstd, dout)
      got = gru.gru_cell_bwd_cuda(*args)
      # A second launch on the same inputs: the same bits (the blocks' sums
      # in a fixed order).
      same = all(a is None or torch.equal(a, b)
                 for a, b in zip(got, gru.gru_cell_bwd_cuda(*args)))
      # A second forward launch: the same bits.
      same &= all(a is None or torch.equal(a, b) for a, b in zip(
          (out, mean, rstd), gru.gru_cell_fwd_cuda(x, deter, scale, bias)))
      if forward_kernel is not None:
        _expect_kernel(
            forward_kernel(rows, D, dtype) if callable(forward_kernel)
            else forward_kernel,
            lambda: gru.gru_cell_fwd_cuda(x, deter, scale, bias), 'forward')
      if backward_kernel is not None:
        _expect_kernel(
            backward_kernel(rows, D, dtype) if callable(backward_kernel)
            else backward_kernel, lambda: gru.gru_cell_bwd_cuda(*args))
      got = [g for g in got if g is not None]
      leaves = [v.clone().requires_grad_() for v in (x, deter, scale, bias)
                if v is not None]
      ref = gru.gru_cell_plain(*leaves)
      want = torch.autograd.grad(ref, leaves, dout, retain_graph=True)
      ref = ref.detach()
      # Forward: float32 the same arithmetic in another order; bfloat16 a
      # norm output or a gate may round to the other side (one unit in the
      # last place) and the chain carries it on. Backward, scaled by each
      # tensor's largest magnitude: float32 dx and ddeter within 1e-4,
      # dscale and dbias (sums over rows in another order) 1e-3; bfloat16
      # 2e-2, as layer_norm_act's (a rounding that falls the other way
      # moves the row sums after it).
      fwd = float(((out.float() - ref.float()).abs()
                   / ref.float().abs().clamp_min(1)).max())
      scaled = _scaled_max(got, want)
      limits = ((1e-5, (1e-4, 1e-4, 1e-3, 1e-3)) if dtype == torch.float32
                else (2 ** -7, (2e-2,) * 4))
      ok = (fwd <= limits[0] and same
            and all(e <= lim for e, lim in zip(scaled, limits[1]))
            and all(bool(torch.isfinite(g).all()) for g in got))
      timings, one, again = '', True, None
      if timed:
        work = [cost.bound(*gru.gru_cell_work(rows, D, dtype, backward=b,
                                              normed=normed), dtype)
                for b in (False, True)]
        ms = step_ms(lambda: gru.gru_cell_fwd_cuda(x, deter, scale, bias),
                     expect=1)
        bwd_ms, bwd_kernels = step_ms(lambda: gru.gru_cell_bwd_cuda(*args),
                                      kernels=True, expect=1)
        # The backward is one device kernel a call (a trace that lost a
        # kernel reads fewer, never more; `device_ms` allows one launch
        # over its window).
        one = bwd_kernels <= 1.01
        plain_ms = step_ms(lambda: gru.gru_cell_plain(x, deter, scale,
                                                      bias))
        again = gru.gru_cell_plain(*leaves)
        plain_bwd_ms = step_ms(lambda: torch.autograd.grad(
            again, leaves, dout, retain_graph=True))
        timings = (
            f'; device ms: forward {ms:.4f} (plain {plain_ms:.4f}, library '
            f'none, bound {work[0]["bound_ms"]:.4f} {work[0]["bound_by"]}), '
            f'backward {bwd_ms:.4f} in {bwd_kernels:g} device kernel(s) a '
            f'call (plain {plain_bwd_ms:.4f}, library none, bound '
            f'{work[1]["bound_ms"]:.4f} {work[1]["bound_by"]})')
      log(f'gru_cell {name} rows {rows} x D {D}'
          f'{"" if normed else " (norm none)"}: forward error {fwd:.3g} '
          f'(tolerance {limits[0]:g} of max(|y|, 1)), backward scaled errors'
          f' dx, ddeter[, dscale, dbias] '
          f'{", ".join(f"{e:.3g}" for e in scaled)} (tolerances '
          f'{limits[1]}), two launches each way equal {same}' + timings)
      if not ok:
        raise AssertionError(f'gru_cell disagrees with its plain version in '
                             f'{name} at rows {rows} x D {D}.')
      if not one:
        raise AssertionError(f'gru_cell_bwd took {bwd_kernels:g} device '
                             f'kernels a call at rows {rows} x D {D}, not '
                             'one.')
      if timed and (rows, D) == max(sites):
        results.setdefault('gru_cell_fwd', {})[name] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=None,
            bound_ms=work[0]['bound_ms'], bound_by=work[0]['bound_by'],
            max_abs_err=float((out.float() - ref.float()).abs().max()))
        results.setdefault('gru_cell_bwd', {})[name] = dict(
            ms=bwd_ms, plain_ms=plain_bwd_ms, library_ms=None,
            bound_ms=work[1]['bound_ms'], bound_by=work[1]['bound_by'],
            max_abs_err=max(float((g.float() - w.float()).abs().max())
                            for g, w in zip(got, want)))
      del x, out, got, want, leaves, ref, again
  return results


def _head_ties(stoch, ref_stoch, logit, ref_logit, u):
  """(groups whose chosen class differs between the kernel's and the plain
  version's stoch, whether each is a tie): the plain version's values of
  the two classes (log_softmax of its logit, plus the noise of `u`) lie
  apart by no more than twice the group's largest difference between the
  values made from either logit, plus 1e-5 of max(their size, 1) for the
  card's own exp and log."""
  import torch
  from daydreamer_tpu_torch.nn import dists
  noise = dists.gumbel_noise(u) if u is not None else 0.0
  value = lambda l: torch.log_softmax(l.float(), -1) + noise
  ours, theirs = value(logit), value(ref_logit)
  got, want = stoch.argmax(-1), ref_stoch.argmax(-1)
  differ = got != want
  a = theirs.gather(-1, got[..., None])[..., 0][differ]
  b = theirs.gather(-1, want[..., None])[..., 0][differ]
  slack = (ours - theirs).abs().amax(-1)[differ]
  ties = (a - b).abs() <= 2 * slack + 1e-5 * torch.maximum(
      a.abs(), torch.ones_like(a))
  return int(differ.sum()), bool(ties.all())


def check_onehot_head(sites=HEAD_SITES, device='cuda', C=HEAD_C,
                      backward_kernel=None, forward_kernel=None, timed=True):
  """onehot_head's two kernels against the plain version (the unimix
  logit, `OneHotDist` and its straight-through Gumbel-max sample or its
  mode, `onehot.onehot_head_plain`) and its autograd at each site of
  HEAD_SITES (S = 32 groups of C classes), in float32 and bfloat16, on the
  same uniform draws: the samples must choose the same classes but at ties
  (counted), with the times of both and the bound; each kernel's trace
  must hold one device kernel a call. No PyTorch call computes the head
  (none mixes in a uniform floor, nor samples with the straight-through
  estimator), so `library_ms` is None. Where `backward_kernel`
  (`forward_kernel`) names one, the backward's (forward's) device kernel
  must be that kernel; without `timed` nothing is timed. Returns the rows
  of the rollout's site."""
  import torch
  from daydreamer_tpu_torch.nn import cost
  from daydreamer_tpu_torch.ops import onehot
  results = {}
  S, unimix = HEAD_S, HEAD_UNIMIX
  for dtype in (torch.float32, torch.bfloat16):
    name = str(dtype).split('.')[-1]
    for rows, sample in sites:
      raw, u, dlogit, dstoch = _head_inputs(rows, sample, dtype, device, C)
      logit, stoch = onehot.onehot_head_fwd_cuda(raw, u, unimix)
      args = (raw, logit, dlogit, dstoch, unimix, sample)
      draw = onehot.onehot_head_bwd_cuda(*args)
      same = torch.equal(draw, onehot.onehot_head_bwd_cuda(*args))
      # A second forward launch: the same bits.
      same &= all(torch.equal(a, b) for a, b in zip(
          (logit, stoch), onehot.onehot_head_fwd_cuda(raw, u, unimix)))
      if forward_kernel is not None:
        _expect_kernel(forward_kernel,
                       lambda: onehot.onehot_head_fwd_cuda(raw, u, unimix),
                       'forward')
      if backward_kernel is not None:
        _expect_kernel(backward_kernel,
                       lambda: onehot.onehot_head_bwd_cuda(*args))
      leaf = raw.clone().requires_grad_()
      ref_logit, ref_stoch = onehot.onehot_head_plain(leaf, u, unimix)
      outs = [ref_logit, ref_stoch] if sample else [ref_logit]
      grads = [dlogit, dstoch] if sample else [dlogit]
      want, = torch.autograd.grad(outs, leaf, grads, retain_graph=True)
      ref_logit, ref_stoch = ref_logit.detach(), ref_stoch.detach()
      flips, ties = _head_ties(stoch, ref_stoch, logit, ref_logit, u)
      kept = (stoch.argmax(-1) == ref_stoch.argmax(-1))[..., None]
      # The logit: float32 the same arithmetic, the card's exp and log in
      # another order; bfloat16 a value may round to the other side (one
      # unit in the last place). stoch where the choice is the same:
      # (onehot + p) - p in float32, rounded to 1 or 0 in bfloat16. The
      # gradient, scaled by its largest magnitude: float32 1e-4; bfloat16
      # 2e-2, where a rounding falls the other way.
      fwd = float(((logit.float() - ref_logit.float()).abs()
                   / ref_logit.float().abs().clamp_min(1)).max())
      stoch_err = float((stoch.float() * kept - ref_stoch.float() * kept)
                        .abs().max())
      grad_err, = _scaled_max([draw], [want])
      limits = (1e-5, 1e-6, 1e-4) if dtype == torch.float32 else (
          2 ** -7, 2 ** -8, 2e-2)
      ok = (fwd <= limits[0] and ties and stoch_err <= limits[1]
            and grad_err <= limits[2] and same
            and bool(torch.isfinite(draw).all()))
      timings, again = '', None
      if timed:
        work = [cost.bound(*onehot.onehot_head_work(
            rows, S, C, dtype, unimix, sample, backward=b), dtype)
                for b in (False, True)]
        ms = step_ms(lambda: onehot.onehot_head_fwd_cuda(raw, u, unimix),
                     expect=1)
        bwd_ms = step_ms(lambda: onehot.onehot_head_bwd_cuda(*args),
                         expect=1)
        plain_ms = step_ms(lambda: onehot.onehot_head_plain(raw, u, unimix))
        again = onehot.onehot_head_plain(leaf, u, unimix)[:len(outs)]
        plain_bwd_ms = step_ms(lambda: torch.autograd.grad(
            again, leaf, grads, retain_graph=True))
        timings = (
            f'; device ms: forward {ms:.4f} (plain {plain_ms:.4f}, library '
            f'none, bound {work[0]["bound_ms"]:.4f} {work[0]["bound_by"]}), '
            f'backward {bwd_ms:.4f} (plain {plain_bwd_ms:.4f}, library none, '
            f'bound {work[1]["bound_ms"]:.4f} {work[1]["bound_by"]})')
      log(f'onehot_head {name} rows {rows} x {S} x {C} '
          f'({"sample" if sample else "mode"}, unimix {unimix}): logit '
          f'error {fwd:.3g} (tolerance {limits[0]:g} of max(|logit|, 1)), '
          f'{flips} of {rows * S} groups choose another class, all ties '
          f'{ties}, stoch error elsewhere {stoch_err:.3g} (tolerance '
          f'{limits[1]:g}), scaled gradient error {grad_err:.3g} (tolerance '
          f'{limits[2]:g}), two launches each way equal {same}' + timings)
      if not ok:
        raise AssertionError(f'onehot_head disagrees with its plain version '
                             f'in {name} at rows {rows} (sample {sample}).')
      if timed and (rows, sample) == max(sites):
        results.setdefault('onehot_head_fwd', {})[name] = dict(
            ms=ms, plain_ms=plain_ms, library_ms=None,
            bound_ms=work[0]['bound_ms'], bound_by=work[0]['bound_by'],
            max_abs_err=float((logit.float() - ref_logit.float()).abs()
                              .max()), ties=flips)
        results.setdefault('onehot_head_bwd', {})[name] = dict(
            ms=bwd_ms, plain_ms=plain_bwd_ms, library_ms=None,
            bound_ms=work[1]['bound_ms'], bound_by=work[1]['bound_by'],
            max_abs_err=float((draw.float() - want.float()).abs().max()))
      del raw, logit, stoch, draw, want, leaf, again
  return results


# Widths past the kernels' first layouts, each of which the JAX package
# trains (`norm: none`, a deter past 2 048, class counts that are no power
# of two from 2 to 32, `norm: layer` rows past the plan): (rows, C, act)
# of layer_norm_act by type; (rows, D) of the GRU cell without a norm and
# past MAX_D; the head's class counts at 32 and 1 024 rows, sampled and
# the mode.
WIDE_LAYER_NORM_SITES = {
    'bfloat16': ((1024, 4100, 'elu'), (1024, 4100, 'none'),
                 (1024, 16392, 'elu'), (1024, 16392, 'none')),
    'float32': ((1024, 12292, 'elu'), (1024, 12292, 'none')),
}
GRU_BARE_SITES = ((32, 256), (1024, 256))
GRU_WIDE_SITES = ((1, 2049), (32, 4096), (1024, 4096))
HEAD_CLASSES = (3, 48, 64, 256)
HEAD_CLASS_SITES = ((32, True), (32, False), (1024, True), (1024, False))


# The two backwards of rows past the plan, by the name of their device
# kernel, and the wrappers' settings that send every wide site to each:
# the cluster backward (LayerNorm: no row too narrow for it; the GRU's
# takes every deter past MAX_D that fits) and PR 21's streaming backward
# (no lane may keep a byte of a row, so no cluster plan fits). Each site
# is held, and timed, on the kernel the wrapper picks (`cluster_plan`),
# and held once more, untimed, on the other.
LAYER_NORM_WIDE_PATHS = (('ln_cluster_bwd_kernel', {'CLUSTER_LEAST': 0}),
                         ('ln_stream_bwd_kernel', {'CLUSTER_BYTES': 0}))
GRU_WIDE_PATHS = (('gru_cluster_bwd_kernel', {}),
                  ('gru_wide_bwd_kernel', {'CLUSTER_BYTES': 0}))
# The GRU forwards of deters past MAX_D, by the sweep's label: their device
# kernel and the settings of `gru` that send such rows there: the block
# forward at any count of rows (FWD_MANY_VALUES 0; the streaming kernel
# where no block holds a row), the streaming kernel (FWD_BYTES 0: no
# thread may keep a byte of a part).
GRU_WIDE_FORWARDS = (
    ('block', 'gru_block_fwd_kernel', {'FWD_MANY_VALUES': 0}),
    ('stream', 'gru_wide_fwd_kernel', {'FWD_BYTES': 0}))
# The sweep's GRU forwards: those above, and the block forward with every
# block on the instantiation built for 1 024 threads (64 registers a
# thread; FWD_BOUND 0).
GRU_FORWARD_PATHS = GRU_WIDE_FORWARDS + (
    ('block_1024', 'gru_block_fwd_kernel',
     {'FWD_MANY_VALUES': 0, 'FWD_BOUND': 0}),)


def _gru_forward_kernel(rows, D, dtype):
  """The device kernel of the GRU forward the wrapper picks for rows of a
  deter of D past MAX_D under the settings in force."""
  from daydreamer_tpu_torch.ops import gru
  return GRU_WIDE_FORWARDS[int(gru.fwd_plan(rows, D, dtype) is None)][1]


def _gru_backward_kernel(rows, D, dtype):
  """The device kernel of the GRU backward the wrapper picks for rows of a
  deter of D past MAX_D under the settings in force."""
  from daydreamer_tpu_torch.ops import gru
  return GRU_WIDE_PATHS[int(gru.cluster_plan(rows, D, dtype) is None)][0]


def _staged(rows, C, dtype, act):
  """`norm.stage_plan` sending every row whose buffers fit to the staged
  forward."""
  from daydreamer_tpu_torch.ops import norm
  return norm.stage_buffers(C, dtype)


# The forwards of rows past the plan with the settings of `norm` that
# force each, the staged one first; and the head backward's kernel at
# every site of HEAD_CLASSES, each way.
LAYER_NORM_WIDE_FORWARDS = (('ln_staged_fwd_kernel', {'stage_plan': _staged}),
                            ('ln_stream_fwd_kernel',
                             {'stage_plan': lambda *_: 0}))
HEAD_CLASS_FORWARD = 'onehot_group_fwd_kernel'
HEAD_CLASS_BACKWARD = 'onehot_group_bwd_kernel'
# The head's general path in passes (a group's lanes walking its classes),
# each way, and the setting of `onehot` that sends every class count there
# (no classes a lane allowed).
HEAD_CLASS_PASSES = ('onehot_any_fwd_kernel', 'onehot_any_bwd_kernel',
                     {'GROUP_MOST': 0})


def _expect_kernel(name, fn, way='backward', tries=5):
  """Raises unless the device kernels of a call of `fn` (torch.profiler
  over 20 calls, taken again where it saw none) include one whose name
  holds `name`; logs it as the kernel of `way`."""
  for _ in range(tries):
    names = list(device_times(fn, calls=20))
    if names:
      break
  if not any(name in key for key in names):
    raise AssertionError(f'{name} did not run: the trace held {names}.')
  log(f'  {way} kernel: {name}')


def check_layer_norm_widths(device='cuda'):
  """check_layer_norm at WIDE_LAYER_NORM_SITES: rows too wide for a
  block's lanes to hold, once timed on the kernels the wrapper picks each
  way and once, untimed, on the other two (the other of
  LAYER_NORM_WIDE_FORWARDS and of LAYER_NORM_WIDE_PATHS), each kernel by
  name in the trace."""
  import torch
  from daydreamer_tpu_torch.ops import norm
  for name, sites in WIDE_LAYER_NORM_SITES.items():
    dtype = getattr(torch, name)
    for site in sites:
      rows, C, act = site
      picked = norm.cluster_plan(rows, C, dtype) is None
      forward = int(norm.stage_plan(rows, C, dtype, act) == 0)
      for i, (kernel, settings) in enumerate(LAYER_NORM_WIDE_PATHS):
        timed = i == picked
        fwd_kernel, fwd_settings = LAYER_NORM_WIDE_FORWARDS[
            forward if timed else 1 - forward]
        how = ("the wrapper's picks" if timed
               else {**settings, **fwd_settings})
        log(f'layer_norm_act past the plan, the forward on {fwd_kernel}, '
            f'the backward on {kernel} ({how}):')
        with _swapped(norm, (), None,
                      **({} if timed else {**settings, **fwd_settings})):
          check_layer_norm((site,), device, dtypes=(name,),
                           backward_kernel=kernel, timed=timed,
                           forward_kernel=fwd_kernel)


def check_rssm_step_widths(device='cuda'):
  """check_gru_cell without a norm at GRU_BARE_SITES and with one past
  MAX_D at GRU_WIDE_SITES, timed on the kernels the wrapper picks each way
  and held once more, untimed, on the streaming forward and backward
  (GRU_WIDE_FORWARDS, GRU_WIDE_PATHS), each by name in the trace; and
  check_onehot_head at each of HEAD_CLASSES (its general path) at
  HEAD_CLASS_SITES, each way on its group kernel, and held once more,
  untimed, on the passes (HEAD_CLASS_PASSES), which the wrapper keeps
  for groups past GROUP_MOST classes a lane on a warp."""
  from daydreamer_tpu_torch.ops import gru, onehot
  check_gru_cell(GRU_BARE_SITES, device, normed=False)
  for i, settings in enumerate((
      {}, {**GRU_WIDE_FORWARDS[1][2], **GRU_WIDE_PATHS[1][1]})):
    how = settings if i else "the wrapper's picks"
    log(f'gru_cell past MAX_D ({how}):')
    with _swapped(gru, (), None, **settings):
      check_gru_cell(GRU_WIDE_SITES, device,
                     backward_kernel=_gru_backward_kernel, timed=i == 0,
                     forward_kernel=_gru_forward_kernel)
  for C in HEAD_CLASSES:
    check_onehot_head(HEAD_CLASS_SITES, device, C, HEAD_CLASS_BACKWARD,
                      HEAD_CLASS_FORWARD)
  forward, backward, settings = HEAD_CLASS_PASSES
  log(f'onehot_head on the passes ({settings}):')
  with _swapped(onehot, (), None, **settings):
    for C in HEAD_CLASSES:
      check_onehot_head(HEAD_CLASS_SITES, device, C, backward, forward,
                        timed=False)


# The sweep of `--phases device,build,wide_paths` (not run by default):
# rows, and the widths of layer_norm_act by type and the GRU's deters,
# past the plan, at which both backwards of such rows, and the forwards of
# LayerNorm rows (LAYER_NORM_FORWARD_PATHS), are timed.
WIDE_PATH_ROWS = (1, 32, 1024, 16384)
WIDE_PATH_LAYER_NORM = {
    'bfloat16': (4097, 4100, 6148, 8196, 12292, 16385, 16392, 24580),
    'float32': (4097, 4098, 6146, 8194, 12290, 12292, 16388),
}
WIDE_PATH_GRU = (2049, 2056, 3076, 4096, 6144)
# The forwards of LayerNorm rows past the plan, by label: their device
# kernel and the settings of `norm` they run under: the staged forward at
# every site, its blocks as the kernel picks them; staged in blocks of 256
# threads with 2 and with 3 buffers and of 128 threads with 2, as many
# blocks as fit; and the streaming forward (`stage_plan` giving no
# buffers). The wrapper's `stage_plan` is picked from their times.
LAYER_NORM_FORWARD_PATHS = (
    ('staged', 'ln_staged_fwd_kernel', {'stage_plan': _staged}),
    ('staged_256x2', 'ln_staged_fwd_kernel',
     {'stage_plan': _staged, 'STAGE_THREADS': 256, 'STAGE_BLOCKS': 1 << 16,
      'STAGES': 2}),
    ('staged_256x3', 'ln_staged_fwd_kernel',
     {'stage_plan': _staged, 'STAGE_THREADS': 256, 'STAGE_BLOCKS': 1 << 16,
      'STAGES': 3}),
    ('staged_128x2', 'ln_staged_fwd_kernel',
     {'stage_plan': _staged, 'STAGE_THREADS': 128, 'STAGE_BLOCKS': 1 << 16,
      'STAGES': 2}),
    ('stream', 'ln_stream_fwd_kernel', {'stage_plan': lambda *_: 0}))


def _path_ms(kernel, fn, tries=5):
  """Device ms of a call of `fn` (torch.profiler over 20 calls), which
  must launch one device kernel whose name holds `kernel`."""
  for _ in range(tries):
    times = device_times(fn, calls=20)
    if times:
      break
  if not any(kernel in key for key in times):
    raise AssertionError(f'{kernel} did not run: the trace held '
                         f'{list(times)}.')
  return sum(ms for ms, _ in times.values())


def phase_wide_paths(ways=('forward', 'backward', 'gru_forward')):
  """Both backwards of rows past the plan timed in turns (cluster, stream,
  stream, cluster) at every site of the sweep above, each with the ELU and
  without for layer_norm_act, to show where each is the faster (the
  wrappers' CLUSTER_LEAST); and the forwards of LayerNorm rows past the
  plan (LAYER_NORM_FORWARD_PATHS) in turns (each in order, then in the
  reverse order) at the same sites, each held to the staged forward's
  output; and the GRU cell's forwards past MAX_D (GRU_FORWARD_PATHS) in
  the same turns at WIDE_PATH_GRU x WIDE_PATH_ROWS, each held to the
  streaming forward's output (their times set `fwd_plan`).
  `ways` picks the LayerNorm forwards, the backwards and the GRU
  forwards. Writes the times to wide_paths.json in a run directory of its
  own."""
  import torch
  from daydreamer_tpu_torch.ops import gru, norm
  rows_of = []
  if 'forward' in ways:
    for name, widths in WIDE_PATH_LAYER_NORM.items():
      dtype = getattr(torch, name)
      for C in widths:
        for rows in WIDE_PATH_ROWS:
          x, scale, bias, _ = _layer_norm_inputs(rows, C, dtype)
          for act in ('elu', 'none'):
            fwd = lambda: norm.layer_norm_act_fwd_cuda(x, scale, bias, act)
            times, outs = {}, {}
            for label, kernel, settings in (LAYER_NORM_FORWARD_PATHS
                                            + LAYER_NORM_FORWARD_PATHS[::-1]):
              with _swapped(norm, (), None, **settings):
                times.setdefault(label, []).append(_path_ms(kernel, fwd))
                outs.setdefault(label, fwd())
            # They sum a row in other orders: y within a unit in the last
            # place of bfloat16, float32's forward tolerance.
            ref = outs['staged']
            worst = max(float(((a.float() - b.float()).abs()
                               / b.float().abs().clamp_min(1)).max())
                        for out in outs.values() for a, b in zip(out, ref))
            if not worst <= (2 ** -7 if name == 'bfloat16' else 1e-5):
              raise AssertionError(f'the forwards of rows {rows} x {C} '
                                   f'({name}, {act}) disagree: {worst:.3g}')
            faster = min(times, key=lambda k: sum(times[k]))
            site = dict(kind='layer_norm_fwd', dtype=name, rows=rows,
                        width=C, act=act)
            log(f'wide_paths {site}: forward device ms '
                + ', '.join(f'{k} {v[0]:.4f} / {v[1]:.4f}'
                            for k, v in times.items())
                + f'; faster {faster}; largest difference from staged '
                f'{worst:.3g} of max(|value|, 1)')
            rows_of.append(dict(site, ms=times, faster=faster,
                                difference=worst))
            del outs, ref
          del x

  def turns(module, paths, fn, **site):
    times = {}
    for kernel, settings in (paths[0], paths[1], paths[1], paths[0]):
      with _swapped(module, (), None, **settings):
        times.setdefault(kernel, []).append(_path_ms(kernel, fn))
    faster = min(times, key=lambda k: sum(times[k]))
    log(f'wide_paths {site}: backward device ms '
        + ', '.join(f'{k} {v[0]:.4f} / {v[1]:.4f}' for k, v in times.items())
        + f'; faster {faster}')
    rows_of.append(dict(site, ms=times, faster=faster))

  if 'gru_forward' in ways:
    for name in ('bfloat16', 'float32'):
      dtype = getattr(torch, name)
      for D in WIDE_PATH_GRU:
        for rows in WIDE_PATH_ROWS:
          x, deter, scale, bias, _ = _gru_inputs(rows, D, dtype)
          fwd = lambda: gru.gru_cell_fwd_cuda(x, deter, scale, bias)
          times, outs, plans = {}, {}, {}
          for label, _, settings in (GRU_FORWARD_PATHS
                                     + GRU_FORWARD_PATHS[::-1]):
            with _swapped(gru, (), None, **settings):
              kernel = _gru_forward_kernel(rows, D, dtype)
              times.setdefault(label, []).append(_path_ms(kernel, fwd))
              outs.setdefault(label, fwd())
              plans[label] = (kernel, gru.fwd_plan(rows, D, dtype),
                              gru.FWD_BOUND)
          picked = _gru_forward_kernel(rows, D, dtype)
          # They sum a row in other orders: the new deter within a unit in
          # the last place of bfloat16, float32's forward tolerance.
          ref = outs['stream']
          worst = max(float(((a.float() - b.float()).abs()
                             / b.float().abs().clamp_min(1)).max())
                      for out in outs.values() for a, b in zip(out, ref))
          if not worst <= (2 ** -7 if name == 'bfloat16' else 1e-5):
            raise AssertionError(f'the GRU forwards of rows {rows} x {D} '
                                 f'({name}) disagree: {worst:.3g}')
          faster = min(times, key=lambda k: sum(times[k]))
          site = dict(kind='gru_fwd', dtype=name, rows=rows, width=D)
          log(f'wide_paths {site}: forward device ms '
              + ', '.join(f'{k} {v[0]:.4f} / {v[1]:.4f}'
                          for k, v in times.items())
              + f'; faster {faster}; the wrapper picks {picked}; plans '
              f'{plans}; largest difference from stream {worst:.3g} of '
              'max(|value|, 1)')
          rows_of.append(dict(site, ms=times, faster=faster, plans=plans,
                              picked=picked, difference=worst))
          del x, deter, outs, ref
  if 'backward' in ways:
    for name, widths in WIDE_PATH_LAYER_NORM.items():
      dtype = getattr(torch, name)
      for C in widths:
        for rows in WIDE_PATH_ROWS:
          x, scale, bias, dy = _layer_norm_inputs(rows, C, dtype)
          for act in ('elu', 'none'):
            _, mean, rstd = norm.layer_norm_act_fwd_cuda(x, scale, bias, act)
            turns(norm, LAYER_NORM_WIDE_PATHS,
                  lambda: norm.layer_norm_act_bwd_cuda(
                      x, scale, bias, mean, rstd, dy, act),
                  kind='layer_norm', dtype=name, rows=rows, width=C, act=act)
          del x, dy
    for name in ('bfloat16', 'float32'):
      dtype = getattr(torch, name)
      for D in WIDE_PATH_GRU:
        for rows in WIDE_PATH_ROWS:
          x, deter, scale, bias, dout = _gru_inputs(rows, D, dtype)
          _, mean, rstd = gru.gru_cell_fwd_cuda(x, deter, scale, bias)
          turns(gru, GRU_WIDE_PATHS,
                lambda: gru.gru_cell_bwd_cuda(x, deter, scale, bias, mean,
                                              rstd, dout),
                kind='gru', dtype=name, rows=rows, width=D)
          del x, deter, dout
  out = new_logdir('wide_paths') / 'wide_paths.json'
  out.write_text(json.dumps(rows_of, indent=1))
  log(f'wide_paths: the times in {out}')


@contextlib.contextmanager
def recorded_adam():
  """Within the block every call of `ops.adam.adam_update` is recorded
  with copies of its inputs, taken before it runs, into the list this
  yields."""
  from daydreamer_tpu_torch.ops import adam
  calls, inner = [], adam.adam_update
  copy = lambda xs: [x.detach().clone() for x in xs]

  def record(params, grads, ms, vs, decayed, norm, finite, scale, lr, bias1,
             bias2, wd, beta1, beta2, eps):
    calls.append(dict(
        params=copy(params), grads=copy(grads), ms=copy(ms), vs=copy(vs),
        decayed=list(decayed), norm=norm.clone(), finite=finite.clone(),
        scale=scale.clone(), lr=lr.clone() if hasattr(lr, 'clone') else lr,
        bias1=bias1.clone(), bias2=bias2.clone(), wd=wd, beta1=beta1,
        beta2=beta2, eps=eps))
    return inner(params, grads, ms, vs, decayed, norm, finite, scale, lr,
                 bias1, bias2, wd, beta1, beta2, eps)

  adam.adam_update = record
  try:
    yield calls
  finally:
    adam.adam_update = inner


def _adam_args(call, state=None):
  state = state or [[x.clone() for x in call[k]] for k in ('params', 'ms',
                                                            'vs')]
  params, ms, vs = state
  return (params, call['grads'], ms, vs, call['decayed'], call['norm'],
          call['finite'], call['scale'], call['lr'], call['bias1'],
          call['bias2'], call['wd'], call['beta1'], call['beta2'],
          call['eps']), state


def _without_norm(args):
  """`adam_update`'s arguments as `adam_update_plain` takes them."""
  return args[:5] + args[6:]


def check_adam(calls):
  """The optimizer's kernels on the tensors of the xarm update's three
  optimizers (`recorded_adam`): adam_sumsq against the plain norm within
  1e-5 relative (float32 sums of up to 29.5 M squares in another order),
  adam_update equal to the plain loop bit for bit from the same norm and
  state, and a NaN gradient, whose norm must come out NaN, leaving every
  tensor as it was. Times of each, of the plain versions and, for the step,
  of `torch._fused_adamw_` over the same tensors (a library kernel whose
  order of operations and roundings differ: Adam with the decay folded in,
  no clip) and, for the norm, of `torch.nn.utils.get_total_norm` (the
  same function in one library call: per-tensor norms of a multi-tensor
  kernel, then their norm). Returns the rows of the world model's
  optimizer."""
  import torch
  from daydreamer_tpu_torch.nn import cost
  from daydreamer_tpu_torch.ops import adam
  results = {}
  names = ('model', 'actor', 'critic')
  for label, call in zip(names, calls):
    sizes = [p.numel() for p in call['params']]
    flags = [bool(call['wd'] and d) for d in call['decayed']]
    norm = adam.global_norm(call['grads'])
    want = adam.global_norm_plain(call['grads'])
    rel = abs(float(norm) - float(want)) / float(want)
    args, state = _adam_args(call)
    adam.adam_update(*args)
    plain_args, plain = _adam_args(call)
    adam.adam_update_plain(*_without_norm(plain_args))
    same = all(torch.equal(a, b) for xs, ys in zip(state, plain)
               for a, b in zip(xs, ys))
    poisoned = dict(call, grads=[g.clone() for g in call['grads']])
    poisoned['grads'][0].view(-1)[0] = float('nan')
    bad = adam.global_norm(poisoned['grads'])
    poisoned.update(norm=bad, finite=torch.isfinite(bad))
    args, state = _adam_args(poisoned)
    adam.adam_update(*args)
    kept = not bool(torch.isfinite(bad)) and all(
        torch.equal(a, b) for xs, key in zip(state, ('params', 'ms', 'vs'))
        for a, b in zip(xs, call[key]))
    # Device times (`device_ms`); a call's time with the host's beside.
    # Timed on contiguous gradients: a convolution's comes in the
    # channels-last layout of cuDNN, which the wrappers copy first (and
    # `torch._fused_adamw_`'s lists must share strides), and the copy is
    # not the kernels' work.
    timed = dict(call, grads=[g.contiguous() for g in call['grads']])
    grads = timed['grads']
    sum_call = lambda: adam.global_norm(grads)
    sum_ms, sum_call_ms = device_ms(sum_call), cuda_time(sum_call)
    sum_plain_ms = device_ms(lambda: adam.global_norm_plain(grads))
    sum_library_ms = device_ms(lambda: torch.nn.utils.get_total_norm(grads))
    args, _ = _adam_args(timed)
    step_call = lambda: adam.adam_update(*args)
    step_ms, step_call_ms = device_ms(step_call), cuda_time(step_call)
    plain_args = _without_norm(_adam_args(timed)[0])
    step_plain_ms = device_ms(lambda: adam.adam_update_plain(*plain_args))
    params, ms, vs = [[x.clone() for x in call[k]]
                      for k in ('params', 'ms', 'vs')]
    steps = [torch.ones((), device=params[0].device) for _ in params]
    lr = float(call['lr'])
    library_ms = device_ms(lambda: torch._fused_adamw_(
        params, grads, ms, vs, [], steps, lr=lr,
        beta1=call['beta1'], beta2=call['beta2'], weight_decay=call['wd'],
        eps=call['eps'], amsgrad=False, maximize=False))
    sum_bound = cost.bound(*adam.global_norm_work(sizes), torch.float32)
    step_bound = cost.bound(*adam.adam_update_work(sizes, flags),
                            torch.float32)
    log(f'adam ({label} optimizer, {len(sizes)} tensors, {sum(sizes)} '
        f'values, {sum(flags)} decayed): adam_sumsq relative error '
        f'{rel:.3g} (tolerance 1e-5), device {sum_ms:.4f} ms (a call '
        f'{sum_call_ms:.4f}; plain '
        f'{sum_plain_ms:.4f}, torch.nn.utils.get_total_norm '
        f'{sum_library_ms:.4f}, bound {sum_bound["bound_ms"]:.4f} '
        f'{sum_bound["bound_by"]}); adam_update equal to the plain loop bit '
        f'for bit {same}, a NaN gradient gives a NaN norm and changes '
        f'nothing {kept}; device {step_ms:.4f} ms (a call '
        f'{step_call_ms:.4f}; plain {step_plain_ms:.4f}, '
        f'torch._fused_adamw_ {library_ms:.4f}, bound '
        f'{step_bound["bound_ms"]:.4f} {step_bound["bound_by"]})')
    if not (rel <= 1e-5 and same and kept):
      raise AssertionError(f'adam ({label}): the kernels disagree with '
                           f'their plain versions.')
    if label == 'model':
      results['adam_sumsq'] = {'float32': dict(
          ms=sum_ms, plain_ms=sum_plain_ms, library_ms=sum_library_ms,
          bound_ms=sum_bound['bound_ms'], bound_by=sum_bound['bound_by'],
          max_abs_err=abs(float(norm) - float(want)))}
      results['adam_update'] = {'float32': dict(
          ms=step_ms, plain_ms=step_plain_ms, library_ms=library_ms,
          bound_ms=step_bound['bound_ms'], bound_by=step_bound['bound_by'],
          max_abs_err=0.0)}
  return results


def check_optimizer_skip(device='cuda'):
  """A gradient that is not finite on the card: the optimizer module's
  update leaves the parameters, the moments and `step` as they were."""
  import torch
  from daydreamer_tpu_torch import nn
  gen = torch.Generator(device=device).manual_seed(0)
  lin = nn.Linear('agent/lin', 64, act='elu', norm='layer')
  opt = nn.Optimizer('agent/opt', lr=1e-2, wd=1e-2, clip=100.0)
  x = torch.randn(32, 48, device=device, generator=gen)
  with nn.scope(create=True, generator=gen):
    opt(lambda: lin(x).sum(), lin)
  with nn.scope(generator=gen):
    opt(lambda: lin(x).square().sum(), lin)
  before = {k: v.clone() for m in (lin, opt) for k, v in nn.state(m).items()}
  with nn.scope(generator=gen):
    mets, _ = opt(lambda: lin(x).sum() * float('nan'), lin)
  after = {k: v for m in (lin, opt) for k, v in nn.state(m).items()}
  kept = all(torch.equal(after[k], v) for k, v in before.items())
  log(f'optimizer on the card, a NaN loss: overflow '
      f'{float(mets["opt_overflow"])}, step {int(after["agent/opt/step"])}, '
      f'every parameter, moment and the step unchanged {kept}')
  if not kept or float(mets['opt_overflow']) != 1.0:
    raise AssertionError('optimizer: a NaN gradient changed the state.')


@contextlib.contextmanager
def rollouts(agent, replay=None):
  """Within the block each fused imagined rollout of `agent` (the
  `_imagine_fused` of an ImagActorCritic: ops/rssm.imagine_actor) runs, and
  a copy of its output goes to the list this yields; with `replay`, such a
  list, each call then returns the next output of `replay` instead of its
  own, having drawn the same random numbers."""
  from daydreamer_tpu_torch.agents.dreamer.agent import ImagActorCritic
  kept, patched = [], []
  for module in agent.modules():
    if isinstance(module, ImagActorCritic):
      def run(start, horizon, inner=module._imagine_fused):
        traj = inner(start, horizon)
        kept.append({k: v.detach().clone() for k, v in traj.items()})
        if replay is None:
          return traj
        return {k: v.clone() for k, v in replay[len(kept) - 1].items()}
      module._imagine_fused = run
      patched.append(module)
  try:
    yield kept
  finally:
    for module in patched:
      del module._imagine_fused


def sampled_differences(ours, theirs):
  """(actions, latents) of two lists of rollouts that differ in their
  sampled choice (the arg max of a one-hot sample), each as (differing,
  all) over the imagined steps."""
  count = lambda key, a, b: (
      int((a[key][1:].argmax(-1) != b[key][1:].argmax(-1)).sum()),
      a[key][1:].argmax(-1).numel())
  totals = []
  for key in ('action', 'stoch'):
    pairs = [count(key, a, b) for a, b in zip(ours, theirs)]
    totals.append(tuple(sum(x) for x in zip(*pairs)) if pairs else (0, 0))
  return tuple(totals)


# Tolerances of one update with the kernels against one with the plain
# versions from the same state, the same generator state and, at xarm, the
# same imagined rollout: differences of the losses relative to max(|the
# plain arm's|, 1) (the actor's loss, a mean of normalized advantages times
# log-probabilities, lies near 0, where a relative difference says
# nothing), relative differences of the optimizers' global norms, and of
# the whole update of each optimizer's parameters, |u_kernels - u_plain| /
# |u_plain|, the largest over the seeds (`--fused-seeds`).
# The rollout is shared because it samples: its kernel (imagine_actor, run
# in both arms) draws each action and latent as the arg max of logits plus
# noise, and where two choices lie closer than the arms' last-place
# difference in the start states the sample flips, the rollout differs
# from that step on, and the actor's and critic's updates with it (one run
# of a tuning taken back flipped one and moved the actor's update 7.6e-3 in
# float32). So the plain arm draws its own rollout, which is only counted
# against the kernels' (`sampled_differences`), and trains on the kernels'
# arm's: what remains is the arithmetic of the kernels against that of the
# plain versions. a1 samples its continuous actions with no such choice.
# float32: the same arithmetic in another order; the largest readings over
# four seeds (losses 1.1e-7, norms 1.5e-7, updates 2.8e-6, 5.2e-6, 3.5e-6)
# lie 19 to 90 times below the limits. bfloat16: the norms' and ELUs'
# outputs round to the other side here and there (one unit in the last
# place) and every layer after carries it on; the largest readings over
# four seeds of xarm and a1 (losses 2.1e-3, norms 7.2e-3, model 0.033,
# actor 0.025, critic 0.013) lie 1.5 to 5 times below (PERF.md, section 6).
FUSED_TOLERANCE = {
    'float32': dict(losses=1e-5, norms=1e-5, model=1e-4, actor=1e-4,
                    critic=1e-4),
    'bfloat16': dict(losses=1e-2, norms=2e-2, model=5e-2, actor=0.1,
                     critic=5e-2)}


def _update_arms(name, precision, seed=0):
  """One update of the `name` block (eager) with the kernels and one with
  the plain versions, from one state after two updates and one generator
  state, from one ring made from `seed` (the agent's seed too); at xarm the
  plain arm trains on the kernels' arm's imagined rollout (`rollouts`).
  Returns {plain: (metrics, state after, launches)}, the state before, the
  adam calls recorded in the kernels' arm and the sampled choices of the
  two arms' own rollouts that differ (`sampled_differences`)."""
  import torch
  import daydreamer_tpu_torch as ddp
  from daydreamer_tpu_torch import envs, nn
  from daydreamer_tpu_torch.agents.dreamer import Agent
  from daydreamer_tpu_torch.ops import build
  env = envs.load_env(f'{name}_dummy', amount=1, parallel='none')
  config = _graphs_config(name, False).update({
      'torch.precision': precision, 'seed': seed})
  try:
    agent = Agent(env.obs_space, env.act_space, ddp.Counter(), config)
    agent._create()
    ring = agent.make_device_replay(capacity=4096, block=64)
    ring.add_steps(_random_steps(env, 2048, seed=seed))
    _, carry, _ = agent.train_device(ring, 2, None)
    start = {k: v.detach().clone() for k, v in nn.state(agent.agent).items()}
    generator = agent.generator.get_state()
    carry = {k: v.clone() for k, v in carry.items()}
    arms, calls, drawn = {}, [], {}
    for plain in (False, True):
      nn.assign(agent.agent, start)
      agent.generator.set_state(generator)
      reset_launches()
      with contextlib.ExitStack() as stack:
        if plain:
          stack.enter_context(build.plain_versions())
        else:
          calls = stack.enter_context(recorded_adam())
        drawn[plain] = stack.enter_context(rollouts(
            agent.agent, drawn[False] if plain else None))
        _, _, mets = agent.train_device(
            ring, 1, {k: v.clone() for k, v in carry.items()})
      launches = read_launches(f'{name} update', () if plain else (
          'layer_norm_act_fwd', 'layer_norm_act_bwd', 'adam_sumsq',
          'adam_update'))
      values = dict(zip(agent._metric_names, mets._packed[-1].tolist()))
      after = {k: v.detach().clone() for k, v in nn.state(
          agent.agent).items()}
      arms[plain] = (values, after, launches)
  finally:
    env.close()
  differ = sampled_differences(drawn[False], drawn[True])
  del agent, ring, drawn
  return arms, start, calls, differ


def compare_updates(name, precision, seeds=1):
  """`_update_arms` from each of `seeds` seeds, held to FUSED_TOLERANCE.
  Returns the adam calls of the first."""
  import torch
  from daydreamer_tpu_torch.ops import build
  limits = FUSED_TOLERANCE[precision]
  fusions = [k.name for k in build.KERNELS if k.name in FUSION_KERNELS]
  rel = lambda a, b: abs(a - b) / max(abs(b), 1e-8)
  first, worst_all = None, {}
  for seed in range(seeds):
    arms, start, calls, differ = _update_arms(name, precision, seed)
    first = first if first is not None else calls
    (kmets, kstate, klaunches), (pmets, pstate, plaunches) = (
        arms[False], arms[True])
    if any(plaunches[k] for k in fusions):
      raise AssertionError(f'{name}: a kernel launched with the plain '
                           f'versions: {plaunches}')
    losses = {k: abs(kmets[k] - pmets[k]) / max(abs(pmets[k]), 1.0)
              for k in kmets
              if k.endswith('_loss_mean') or k.endswith('_opt_loss')}
    norms = {k: rel(kmets[k], pmets[k]) for k in kmets
             if k.endswith('_grad_norm')}
    updates = {}
    for opt in ('model', 'actor', 'critic'):
      slot = f'/{opt}_opt/m/'
      keys = [k.split(slot, 1)[1].replace('.', '/') for k in start
              if slot in k]
      du_k = torch.cat([(kstate[k] - start[k]).reshape(-1) for k in keys])
      du_p = torch.cat([(pstate[k] - start[k]).reshape(-1) for k in keys])
      updates[opt] = float((du_k - du_p).norm() / du_p.norm())
    worst = dict(losses=max(losses.values()), norms=max(norms.values()),
                 **updates)
    (actions, all_actions), (latents, all_latents) = differ
    shared = (f'the arms\' own imagined rollouts differ in {actions} of '
              f'{all_actions} sampled actions and {latents} of {all_latents} '
              f'sampled latents (the plain arm trained on the kernels\' '
              f'rollout)' if all_actions else 'no fused rollout')
    log(f'update ({name}, {precision}, seed {seed}), kernels against plain '
        f'versions from one state: launches '
        f'{({k: klaunches[k] for k in fusions})}; {shared}; largest '
        f'difference of the losses over max(|plain|, 1) '
        f'{worst["losses"]:.3g} ({max(losses, key=losses.get)}), relative '
        f'of the grad norms {worst["norms"]:.3g} '
        f'({ {k: float(f"{v:.3g}") for k, v in norms.items()} }), of each '
        f'optimizer\'s update '
        f'{({k: float(f"{v:.3g}") for k, v in updates.items()})} '
        f'(tolerances {limits})')
    compared = [v for m in (kmets, pmets) for k, v in m.items()
                if k in losses or k in norms]
    if any(worst[k] > limits[k] for k in limits) or not all(
        math.isfinite(v) for v in compared):
      raise AssertionError(f'update ({name}, {precision}, seed {seed}): '
                           f'kernels and plain versions differ beyond '
                           f'{limits}: {worst}')
    worst_all = {k: max(v, worst_all.get(k, 0.0)) for k, v in worst.items()}
  log(f'update ({name}, {precision}): the largest over {seeds} seed(s) '
      f'{({k: float(f"{v:.3g}") for k, v in worst_all.items()})}')
  return first


def phase_fused(seeds=1):
  """The counterparts of XLA's fusions (see the module's docstring, phase
  15), the updates compared from `seeds` seeds. Returns the kernels' rows
  for the kernels line."""
  import gc
  import torch
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  layer_norm_registers()
  results = check_layer_norm()
  check_layer_norm_widths()
  results.update(check_gru_cell())
  results.update(check_onehot_head())
  check_rssm_step_widths()
  compare_updates('xarm', 'float32', seeds)
  calls = compare_updates('xarm', 'bfloat16', seeds)
  results.update(check_adam(calls))
  del calls
  gc.collect()
  compare_updates('a1', 'bfloat16', seeds)
  check_optimizer_skip()
  gc.collect()
  torch.cuda.empty_cache()
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
  # One nvcc a source, all started together; each one's seconds.
  procs = [(k, k.start_build()) for k in build.KERNELS]
  seconds = {}
  while len(seconds) < len(procs):
    for kernel, proc in procs:
      if kernel.name not in seconds and (proc is None
                                         or proc.poll() is not None):
        seconds[kernel.name] = time.perf_counter() - begin
    time.sleep(0.1)
  for _, proc in procs:
    build.Kernel.finish_build(proc)
  build.build_all()
  log(f'built {len(build.KERNELS)} kernel(s) in '
      f'{time.perf_counter() - begin:.1f} s; each source\'s nvcc: '
      + ', '.join(f'{k} {v:.1f} s' for k, v in sorted(
          seconds.items(), key=lambda x: -x[1])))
  for kernel in build.KERNELS:
    for line in kernel.build_log().splitlines():
      if 'registers' in line or 'spill' in line:
        log(f'  {kernel.name}: {line.strip()}')


def phase_profile(configs=('xarm',), updates=5, overrides=None):
  """Where an update's time goes at the named config blocks (xarm by
  default, with the fused rollout; `overrides` replace that): torch.profiler
  over `updates` train steps (after three warm-up steps) on a random
  batch. Prints the wall time per update, the device's
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
  config = config.update(
      {'imag_impl': 'pallas'} if overrides is None else overrides)
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
      default='device,build,kernel,fused,graphs,slice,proof,learner,a1,'
              'explore,parallel,imitation,tooling,soak,bench')
  parser.add_argument('--compare', action='append', default=[],
                      metavar='NAME=SOURCE')
  parser.add_argument('--wide-paths', default='forward,backward,gru_forward',
                      help='The ways the wide_paths phase sweeps.')
  parser.add_argument('--seed', type=int, default=0)
  parser.add_argument('--fused-seeds', type=int, default=1)
  parser.add_argument('--curve-config', default='xarm', choices=CURVES)
  parser.add_argument('--curve-steps', type=int, default=21400)
  args = parser.parse_args(argv)
  phases = args.phases.split(',')
  begin = time.perf_counter()
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
  from daydreamer_tpu_torch.ops import (build, gru, lambda_returns, onehot,
                                        rssm, rssm_vjp)
  # Imported to register their kernels.
  del gru, lambda_returns, onehot, rssm, rssm_vjp
  device_name = phase_device()
  # Where the run's seconds go: each phase's start, from the run's.
  mark = lambda name: log(f'chip_smoke: {name} from '
                          f'{time.perf_counter() - begin:.1f} s')
  if args.compare:
    for spec in args.compare:
      phase_compare(spec)
    return 0
  if 'build' in phases:
    phase_build()
  mark('kernel')
  kernel = phase_kernel() if 'kernel' in phases else {}
  mark('fused')
  if 'fused' in phases:
    kernel.update(phase_fused(args.fused_seeds))
  else:
    if 'layer_norm' in phases:
      layer_norm_registers()
      kernel.update(check_layer_norm())
      check_layer_norm_widths()
    if 'rssm_step' in phases:
      kernel.update(check_gru_cell())
      kernel.update(check_onehot_head())
      check_rssm_step_widths()
  if 'wide_paths' in phases:
    phase_wide_paths(args.wide_paths.split(','))
  if 'rssm_widths' in phases and 'kernel' not in phases:
    check_rssm_widths(observe_shape('xarm', XARM_OBSERVE))
  mark('graphs')
  if 'graphs' in phases:
    phase_graphs()
  elif 'graphs_widths' in phases:
    for key, name, overrides, paths in GRAPHS_WIDTHS:
      _graphs_learner(name, 'fixed', overrides, paths)
  launches, parallel = {}, {}
  slice_run = None
  mark('slice')
  if 'slice' in phases:
    counts, slice_run = phase_slice('slice', SLICE_ARGS,
                                    TRAIN_KERNELS + FUSION_KERNELS + STEP_FWD)
    launches.update({k: counts[k] for k in TRAIN_KERNELS + FUSION_KERNELS})
    # The RSSM step's kernels: the loop path's observe, forward and
    # backward.
    counts, _ = phase_slice('slice (rssm.impl scan)', SCAN_SLICE_ARGS, (
        'imagine_actor',) + STEP_KERNELS)
    launches.update({k: counts[k] for k in STEP_KERNELS})
  mark('proof')
  if 'proof' in phases:
    launches.update(phase_proof())
  mark('learner')
  if 'learner' in phases:
    phase_learner('learner (uniform ring)', 'fixed')
    phase_learner('learner (prioritized ring)', 'prio')
  mark('a1')
  a1 = phase_a1() if 'a1' in phases else {}
  mark('explore')
  if 'explore' in phases:
    phase_explore(slice_run)
  mark('parallel')
  if 'parallel' in phases:
    parallel = phase_parallel()
  if 'parallel_cards' in phases:
    parallel.update(phase_parallel_cards())
  mark('imitation')
  if 'imitation' in phases:
    phase_imitation(args.seed)
  if 'imitation_sim' in phases:
    phase_imitation_sim()
  mark('tooling')
  profiled, profiled_a1 = phase_tooling() if 'tooling' in phases else ({},
                                                                       {})
  mark('soak')
  soak = phase_soak() if 'soak' in phases else {}
  mark('bench')
  benched = phase_bench(device_name) if 'bench' in phases else {}
  if 'impl_bench' in phases:
    phase_impl_bench()
  curve = {}
  if 'curve' in phases:
    curve = phase_curve(args.curve_config, args.curve_steps, args.seed)
  if 'sphero' in phases:
    phase_slice('sphero', SPHERO_ARGS, OBSERVE_KERNELS)
  if 'profile' in phases:
    phase_profile()
    phase_profile(('a1',), overrides={'task': 'a1_dummy'})
  if 'profile_explore' in phases:
    phase_profile(('xarm', 'plan2explore'))
  entries = []
  # The six counterparts of the TPU kernels, then the eight of XLA's
  # fusions.
  ordered = sorted(build.KERNELS,
                   key=lambda k: k.name in FUSION_KERNELS + STEP_KERNELS)
  for k in ordered:
    # The main path computes in bfloat16 (the optimizer in float32); each
    # kernel's own result. The launches are those of the kernel's own path:
    # the training slice for the first three and the fusions' four, its
    # loop-path run (`--rssm.impl scan`) for the RSSM step's four, the
    # proof for the others; beside them, those of the a1 phase's loop path
    # (the paper's config as its file has it), each rank's
    # of the parallel phase, those of the tooling phase's profile of the
    # learner's ring dispatches, those of the soak's learner process and
    # those of the curve phase's run and those of the bench phase's timed
    # windows at xarm.
    timing = kernel.get(k.name, {})
    timing = timing.get('bfloat16', timing.get('float32', {}))
    entries.append(dict(
        name=k.name, route=k.route,
        source=str(k.source.relative_to(ROOT)), replaces=k.replaces,
        launches=launches.get(k.name, 0),
        launches_parallel={rank: counts.get(k.name, 0)
                           for rank, counts in parallel.items()},
        launches_a1=a1.get(k.name, 0),
        launches_profile=profiled.get(k.name, 0),
        launches_profile_a1=profiled_a1.get(k.name, 0),
        launches_soak=soak.get(k.name, 0),
        launches_curve=curve.get(k.name, 0),
        launches_bench=benched.get(k.name, 0),
        max_abs_err=timing.get('max_abs_err'), ms=timing.get('ms'),
        plain_ms=timing.get('plain_ms'), bound_ms=timing.get('bound_ms'),
        bound_by=timing.get('bound_by'),
        library_ms=timing.get('library_ms')))
  log(f'chip_smoke: phases {",".join(phases)} in '
      f'{time.perf_counter() - begin:.1f} s')
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
# The counterparts of XLA's fusions, which every gradient update launches.
FUSION_KERNELS = ('layer_norm_act_fwd', 'layer_norm_act_bwd', 'adam_sumsq',
                  'adam_update')
# The counterparts of XLA's fusions of the RSSM's scan step: every step of
# the loop paths (observe with `rssm.impl: scan`, the rollout with
# `imag_impl: scan`, the policy step) launches the forward pair, a step
# under autograd the backward pair too.
STEP_KERNELS = ('gru_cell_fwd', 'gru_cell_bwd', 'onehot_head_fwd',
                'onehot_head_bwd')
STEP_FWD = ('gru_cell_fwd', 'onehot_head_fwd')
RSSM_KERNELS = TRAIN_KERNELS + PROOF_KERNELS


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
  smi = smi_cards()
  log(f'{label}: {done} updates in {len(dispatches)} dispatches of {fused}, '
      f'launches {({k: launches[k] for k in TRAIN_KERNELS})}, last logged '
      f'losses {losses}')
  log(f'{label}: {rate:.3f} updates/s over {done - fused} updates (the '
      f'first dispatch excluded; dispatches took '
      f'{[round(t, 3) for t in dispatches]} s), ring of {ring.capacity} '
      f'steps holding {ring.filled}, {ring.nbytes} bytes on the card '
      f'({smi})')


# The graphs phase: K updates a dispatch, two dispatches an arm.
GRAPHS_K = 4
GRAPHS_RING = 8192      # Steps the ring holds; half of it filled first.
GRAPHS_POLICY_STEPS = 8  # Batch-1 policy steps a mode and arm.
GRAPHS_REPORTS = 4  # Report calls an arm, at the config's batch.


def _graphs_config(name, graphs, replay_kind='fixed', overrides=None):
  """The `name` config block as its file has it (xarm with the fused
  rollout too), on its dummy task, with `torch.graphs` set and then
  `overrides`."""
  import daydreamer_tpu_torch as ddp
  from daydreamer_tpu_torch.agents.dreamer import Agent
  config = ddp.Config(Agent.configs['defaults']).update(Agent.configs[name])
  config = config.update({
      'task': f'{name}_dummy', 'env.parallel': 'none', 'env.amount': 1,
      'torch.graphs': graphs, 'replay': replay_kind,
      'torch.fused_metrics': 'all'})
  if name == 'xarm':
    config = config.update({'imag_impl': 'pallas'})
  return config.update(overrides or {})


@contextlib.contextmanager
def _path_probe():
  """Within the block every kernel launch is recorded as (C function,
  dims) and every call of a fusion's plain version is counted: yields
  (launches, plain calls by name)."""
  import collections
  from daydreamer_tpu_torch.ops import build, gru, norm, onehot
  launches, plain = [], collections.Counter()
  launch = build.launch

  def recorded(kernel, fn, dtype, ptrs, dims, scalars, device):
    launches.append((fn, tuple(dims)))
    return launch(kernel, fn, dtype, ptrs, dims, scalars, device)

  def counted(module, name):
    inner = getattr(module, name)
    def call(*args, **kwargs):
      plain[name] += 1
      return inner(*args, **kwargs)
    return call

  saved = [(build, 'launch', launch)] + [
      (m, n, getattr(m, n)) for m, n in (
          (gru, 'gru_cell_plain'), (onehot, 'onehot_head_plain'),
          (norm, 'layer_norm_act_plain'))]
  for module, name, _ in saved[1:]:
    setattr(module, name, counted(module, name))
  build.launch = recorded
  try:
    yield launches, plain
  finally:
    for module, name, value in saved:
      setattr(module, name, value)


# Updates at widths past the kernels' first layouts, graphed and eager
# (phase 14): (label, config block, overrides, and the launches that show
# the new paths ran as (C function, index into its dims, value)). Two a1
# updates past the fusion kernels' first layouts; a1 with the fused
# observe chain at a deter of 20 (single values a load) and 9 prior
# layers (the backward's wide path); xarm, whose discrete actions take
# the fused rollout, at a deter of 2 048 with no prior layer (the
# rollout's and the backward's workspaces).
GRAPHS_WIDTHS = (
    ('a1_classes48_norm_none', 'a1',
     {'rssm.classes': 48, 'rssm.norm': 'none'},
     (('gru_cell_fwd', 4, 0), ('gru_cell_bwd', 7, 0),
      ('onehot_head_fwd', 1, 48), ('onehot_head_bwd', 1, 48))),
    ('a1_deter4096_classes64_reward4100', 'a1',
     {'rssm.deter': 4096, 'rssm.classes': 64, 'reward_head.units': 4100},
     (('gru_cell_fwd', 1, 4096), ('gru_cell_bwd', 1, 4096),
      ('onehot_head_fwd', 1, 64), ('onehot_head_bwd', 1, 64),
      ('layer_norm_act_fwd', 1, 4100), ('layer_norm_act_bwd', 1, 4100))),
    ('a1_pallas_deter20_prior9', 'a1',
     {'rssm.impl': 'pallas', 'rssm.deter': 20, 'rssm.prior_layers': 9},
     (('observe_fwd', 4, 20), ('observe_fwd', 8, 9), ('observe_fwd', 9, 1),
      ('observe_bwd', 3, 20), ('observe_bwd', 7, 9), ('observe_bwd', 8, 1))),
    ('xarm_deter2048_prior0', 'xarm',
     {'rssm.deter': 2048, 'rssm.prior_layers': 0},
     (('imagine_actor', 2, 2048), ('imagine_actor', 7, 0),
      ('observe_fwd', 4, 2048), ('observe_fwd', 8, 0),
      ('observe_bwd', 3, 2048), ('observe_bwd', 7, 0))),
)


def _random_steps(env, rows, seed):
  """`rows` steps of random observations and actions from `seed`, in
  episodes of 100 steps."""
  rng = np.random.default_rng(seed)
  steps = {}
  for key, space in env.obs_space.items():
    if key.startswith('log_'):
      continue
    shape = (rows,) + space.shape
    if space.dtype == np.uint8:
      steps[key] = rng.integers(0, 256, shape, np.uint8)
    elif space.dtype == bool:
      steps[key] = np.zeros(shape, bool)
    else:
      steps[key] = rng.standard_normal(shape).astype(space.dtype)
  space = env.act_space['action']
  if space.discrete:
    steps['action'] = np.eye(space.shape[0], dtype=np.float32)[
        rng.integers(0, space.shape[0], rows)]
  else:
    steps['action'] = rng.uniform(-1, 1, (rows,) + space.shape).astype(
        np.float32)
  steps['reward'] = rng.uniform(0, 1, rows).astype(np.float32)
  steps['is_first'][::100] = True
  steps['is_last'][99::100] = True
  return steps


def _snapshot(agent, ring, mets, state):
  """What an arm leaves: every state entry, the packed metrics of each
  dispatch, the carry and, on a prioritized ring, the priorities."""
  from daydreamer_tpu_torch import nn
  return dict(
      state={k: v.detach().clone() for k, v in nn.state(agent.agent).items()},
      metrics=[m._packed.clone() for m in mets],
      carry={k: v.clone() for k, v in state.items()},
      prios=ring.prios.clone() if ring.prioritized else None)


def _differences(a, b, path=''):
  """[(path, max abs difference, count of differing values)] of two trees
  of tensors, NaN equal to NaN; empty when they are equal bit for bit."""
  import torch
  if isinstance(a, dict):
    return [d for k in a for d in _differences(a[k], b[k], f'{path}/{k}')]
  if isinstance(a, list):
    return [d for i, (x, y) in enumerate(zip(a, b))
            for d in _differences(x, y, f'{path}/{i}')]
  if a is None:
    return []
  same = (a == b) | (torch.isnan(a) & torch.isnan(b)) if (
      a.is_floating_point()) else a == b
  if bool(same.all()):
    return []
  diff = (a.float() - b.float()).abs()
  diff = torch.where(same, torch.zeros_like(diff), diff)
  return [(path, float(diff.nan_to_num(float('inf')).max()),
           int((~same).sum()))]


def _graphs_learner(name, replay_kind, overrides=None, paths=()):
  """One eager and one graphed agent of the `name` block (with
  `overrides`) from one state and one generator state, each GRAPHS_K
  updates a dispatch for two dispatches from the same ring (the
  prioritized ring's priorities reset between the arms). Where `paths`
  are given (see GRAPHS_WIDTHS), the eager arm must have launched them and
  no arm may call a fusion's plain version. Returns the row of the
  comparison."""
  import torch
  from daydreamer_tpu_torch import envs, nn
  from daydreamer_tpu_torch.agents.dreamer import Agent
  import daydreamer_tpu_torch as ddp
  label = f'graphs ({name}, {replay_kind} ring)'
  if overrides:
    label = label[:-1] + ', ' + ' '.join(
        f'--{k} {v}' for k, v in overrides.items()) + ')'
  env = envs.load_env(f'{name}_dummy', amount=1, parallel='none')
  try:
    agents = {flag: Agent(env.obs_space, env.act_space, ddp.Counter(),
                          _graphs_config(name, flag, replay_kind, overrides))
              for flag in (False, True)}
    for agent in agents.values():
      agent._create()
    eager, graphed = agents[False], agents[True]
    nn.assign(graphed.agent, nn.state(eager.agent))
    graphed.generator.set_state(eager.generator.get_state())
    ring = eager.make_device_replay(capacity=GRAPHS_RING, block=64)
    ring.add_steps(_random_steps(env, GRAPHS_RING // 2, seed=0))
    prios = ring.prios.clone() if ring.prioritized else None
    snaps, rates = {}, {}
    for flag, agent in ((False, eager), (True, graphed)):
      if prios is not None:
        ring.prios.copy_(prios)
      reset_launches()
      mets, state = [], None
      times = []
      with _path_probe() as (calls, plain):
        for _ in range(2):
          torch.cuda.synchronize()
          begin = time.perf_counter()
          _, state, m = agent.train_device(ring, GRAPHS_K, state)
          torch.cuda.synchronize()
          times.append(time.perf_counter() - begin)
          mets.append(m)
      launches = read_launches(label, ())
      missing = [path for path in paths if not any(
          fn == path[0] and dims[path[1]] == path[2] for fn, dims in calls)]
      if paths and (plain or (missing and not flag)):
        raise AssertionError(
            f'{label}: graphs {flag}: plain versions called {dict(plain)}; '
            f'paths never launched {missing}')
      snaps[flag] = _snapshot(agent, ring, mets, state)
      rates[flag] = (GRAPHS_K / times[1], times[0], launches)
    stats = graphed.graphs.stats()['train_device']
    diffs = _differences(snaps[False], snaps[True])
    updates = 2 * GRAPHS_K
    # xarm takes the fused observe chain and rollout, a1 the loop path or,
    # with `rssm.impl: pallas`, the fused observe chain.
    fused_observe = name == 'xarm' or (overrides or {}).get(
        'rssm.impl') == 'pallas'
    kernels = (OBSERVE_KERNELS if fused_observe else ()) + (
        ('imagine_actor',) if name == 'xarm' else ())
    for flag in (False, True):
      launches = rates[flag][2]
      # The loop path runs its observe loop or its rollout (a1's) through
      # the RSSM step's kernels.
      steps = () if name == 'xarm' else STEP_KERNELS
      if any(launches[k] != updates for k in kernels) or any(
          launches[k] for k in RSSM_KERNELS if k not in kernels) or any(
              launches[k] < updates for k in FUSION_KERNELS + steps):
        raise AssertionError(
            f'{label}: graphs {flag}: launches {launches} in {updates} '
            f'updates; each RSSM kernel of the path once an update, each '
            f'of the fusions at least once')
    if rates[False][2] != rates[True][2]:
      raise AssertionError(f'{label}: launches eager {rates[False][2]}, '
                           f'graphed {rates[True][2]}')
    # Later replays drew other windows and other noise: each update's
    # metrics differ from the one before.
    rows = torch.cat([m for m in snaps[True]['metrics']])
    index = graphed._metric_names.index('model_loss_mean')
    if not bool((rows[1:, index] != rows[:-1, index]).all()):
      raise AssertionError(f'{label}: two replays gave the same model loss: '
                           f'{rows[:, index].tolist()}')
    reached = None
    if ring.prioritized:
      # Blocks added after the capture: the graph reads the ring's counts
      # on the device, so its next dispatch draws the new, unseen rows.
      from daydreamer_tpu_torch.replay.device_replay import UNSEEN_PRIORITY
      start = ring.filled
      ring.add_steps(_random_steps(env, 1024, seed=1))
      graphed.train_device(ring, GRAPHS_K, state)
      reached = int((ring.prios[start:start + 1024]
                     != UNSEEN_PRIORITY).sum())
      if not reached:
        raise AssertionError(f'{label}: no window reached the {1024} rows '
                             f'added after the capture.')
  finally:
    env.close()
  row = dict(
      eager_updates_per_s=rates[False][0],
      graphed_updates_per_s=rates[True][0],
      eager_first_dispatch_s=rates[False][1],
      graphed_first_dispatch_s=rates[True][1],
      capture_s=stats['capture_s'], pool_bytes=stats['pool_bytes'],
      replays=stats['replays'], launches=rates[True][2],
      differences=diffs, rows_reached_after_capture=reached)
  log(f'{label}: eager {row["eager_updates_per_s"]:.3f} updates/s, graphed '
      f'{row["graphed_updates_per_s"]:.3f} (second dispatch of '
      f'{GRAPHS_K}); first dispatch eager {row["eager_first_dispatch_s"]:.3f}'
      f' s, graphed {row["graphed_first_dispatch_s"]:.3f} s with a capture '
      f'of {row["capture_s"]:.3f} s; graph pool {row["pool_bytes"]} bytes; '
      f'{row["replays"]} replays; graphed launches {row["launches"]}; '
      f'rows added after the capture and drawn: {reached}')
  if diffs:
    raise AssertionError(f'{label}: graphed and eager differ: {diffs[:10]} '
                         f'({len(diffs)} tensors)')
  log(f'{label}: every state entry, the packed metrics of every update, '
      f'the carry{" and the priorities" if ring.prioritized else ""} equal '
      f'bit for bit')
  del agents, eager, graphed
  import gc
  gc.collect()
  torch.cuda.empty_cache()
  return row


def _graphs_noise():
  """A registered generator under replay: each replay draws new numbers,
  the numbers that eager calls draw in turn, and leaves the generator
  where those calls leave it."""
  import torch
  from daydreamer_tpu_torch.agents.dreamer import graphs as graphslib
  gen = torch.Generator(device='cuda').manual_seed(5)
  runner = graphslib.Runner('cuda', [gen])
  zeros = torch.zeros(4, device='cuda')
  fn = lambda x: x + torch.rand(4, generator=gen, device='cuda')
  drawn = [runner('noise', None, fn, (zeros,)) for _ in range(4)]
  twin = torch.Generator(device='cuda').manual_seed(5)
  eager = [zeros + torch.rand(4, generator=twin, device='cuda')
           for _ in range(4)]
  if not all(torch.equal(a, b) for a, b in zip(drawn, eager)) or torch.equal(
      drawn[2], drawn[3]) or not torch.equal(gen.get_state(),
                                             twin.get_state()):
    raise AssertionError(f'graphs (noise): replays drew {drawn}, eager '
                         f'calls {eager}')
  log('graphs (noise): two replays drew different numbers, equal to the '
      'eager calls\' in turn, and advanced the generator as they do')


def _graphs_policy(agents, env):
  """The xarm policy at batch 1 in each mode, eager and graphed from one
  state and generator state; the actions and the carried states must be
  equal bit for bit. Returns the ms a call of each arm."""
  import torch
  steps = _random_steps(env, GRAPHS_POLICY_STEPS, seed=2)
  obs = [{k: v[i:i + 1] for k, v in steps.items() if k != 'action'}
         for i in range(GRAPHS_POLICY_STEPS)]
  start = agents[False].generator.get_state()
  ms, diffs = {}, []
  for mode in ('train', 'eval', 'explore'):
    outs = {}
    for flag, agent in agents.items():
      agent.generator.set_state(start)
      state, acts, times = None, [], []
      for o in obs:
        torch.cuda.synchronize()
        begin = time.perf_counter()
        out, state = agent.policy(o, state, mode=mode)
        times.append(time.perf_counter() - begin)
        acts.append(torch.as_tensor(out['action']))
      # The first call carries no state (eager in both arms), the second
      # warms up and captures in the graphed arm.
      ms[(mode, flag)] = 1e3 * float(np.mean(times[2:]))
      outs[flag] = dict(actions=acts, state=_tree_dict(state))
    diffs += [(mode, *d) for d in _differences(outs[False], outs[True])]
  stats = agents[True].graphs.stats()['policy']
  log(f'graphs (xarm policy, batch 1): ms a call eager / graphed: ' +
      ', '.join(f'{mode} {ms[(mode, False)]:.3f} / {ms[(mode, True)]:.3f}'
                for mode in ('train', 'eval', 'explore')) +
      f'; {stats["graphs"]} graphs captured in {stats["capture_s"]:.3f} s, '
      f'pool {stats["pool_bytes"]} bytes')
  if diffs:
    raise AssertionError(f'graphs (xarm policy): graphed and eager differ: '
                         f'{diffs[:10]}')
  log('graphs (xarm policy): actions and carried states equal bit for bit '
      'in each mode')
  return dict(ms={f'{m}_{"graphed" if f else "eager"}': v
                  for (m, f), v in ms.items()}, **stats)


def _graphs_report(agents, env):
  """The xarm report, eager and graphed from one state and generator
  state, on GRAPHS_REPORTS batches of the config's shape: every scalar and
  video equal bit for bit, the generators left in one state, and the
  kernels launched as often in each arm (observe_fwd at least once a call;
  the graphed arm's launches credited at each replay). Returns the row."""
  import torch
  label = 'graphs (xarm report)'
  config = agents[False].config
  B, T = config.batch_size, config.replay_chunk
  batches = []
  for i in range(GRAPHS_REPORTS):
    steps = _random_steps(env, B * T, seed=10 + i)
    batch = {k: v.reshape((B, T) + v.shape[1:]) for k, v in steps.items()}
    batch['is_first'][:, 0] = True
    batches.append(batch)
  start = agents[False].generator.get_state()
  outs, times, launches = {}, {}, {}
  for flag, agent in agents.items():
    agent.generator.set_state(start)
    reset_launches()
    outs[flag], times[flag] = [], []
    for batch in batches:
      torch.cuda.synchronize()
      begin = time.perf_counter()
      report = agent.report(batch)  # Numpy: synced.
      times[flag].append(time.perf_counter() - begin)
      outs[flag].append({k: torch.as_tensor(v) for k, v in report.items()})
    launches[flag] = read_launches(label, ('observe_fwd',))
  stats = agents[True].graphs.stats()['report']
  diffs = _differences(outs[False], outs[True])
  # The first call of the graphed arm warms up and captures.
  ms = {flag: 1e3 * float(np.mean(times[flag][1:])) for flag in times}
  row = dict(eager_ms=ms[False], graphed_ms=ms[True],
             eager_first_s=times[False][0], graphed_first_s=times[True][0],
             capture_s=stats['capture_s'], pool_bytes=stats['pool_bytes'],
             replays=stats['replays'], launches=launches[True],
             entries=sorted(outs[True][0]))
  log(f'{label}: batch {B} x {T}, {GRAPHS_REPORTS} calls an arm: ms a call '
      f'eager {ms[False]:.3f}, graphed {ms[True]:.3f} (calls 2-'
      f'{GRAPHS_REPORTS}); first call eager {times[False][0]:.3f} s, graphed '
      f'{times[True][0]:.3f} s with a capture of {stats["capture_s"]:.3f} s; '
      f'graph pool {stats["pool_bytes"]} bytes; {stats["replays"]} replays; '
      f'launches eager {launches[False]}, graphed {launches[True]}; '
      f'{len(row["entries"])} entries ({", ".join(row["entries"])})')
  if diffs:
    raise AssertionError(f'{label}: graphed and eager differ: {diffs[:10]} '
                         f'({len(diffs)} tensors)')
  if launches[True] != launches[False] or (
      launches[True]['observe_fwd'] < GRAPHS_REPORTS):
    raise AssertionError(f'{label}: launches eager {launches[False]}, '
                         f'graphed {launches[True]} in {GRAPHS_REPORTS} calls')
  if not torch.equal(agents[False].generator.get_state(),
                     agents[True].generator.get_state()):
    raise AssertionError(f'{label}: the generators differ after the calls')
  log(f'{label}: every scalar and video equal bit for bit; observe_fwd '
      f'{launches[True]["observe_fwd"] // GRAPHS_REPORTS} launches a call in '
      f'each arm; the generators in one state')
  # What of a graphed call is the replay: its device time alone (CUDA
  # events), against the copies in and out and the numpy conversion.
  call, = [c for c in agents[True].graphs.captured.values()
           if c.name == 'report']
  row['replay_ms'] = cuda_time(call.run, reps=3, warmup=1)
  log(f'{label}: a replay alone {row["replay_ms"]:.3f} ms of the graphed '
      f'call\'s {ms[True]:.3f}')
  return row


def _tree_dict(tree, path=''):
  """A tree of tensors as a flat {path: tensor}."""
  if isinstance(tree, dict):
    return {p: v for k, x in tree.items()
            for p, v in _tree_dict(x, f'{path}/{k}').items()}
  if isinstance(tree, (tuple, list)):
    return {p: v for i, x in enumerate(tree)
            for p, v in _tree_dict(x, f'{path}/{i}').items()}
  return {path: tree} if tree is not None else {}


def phase_graphs():
  """`torch.graphs` held to the eager path (see the module's docstring,
  phase 14). Returns the rows for the kernels line's neighbours."""
  import torch
  import daydreamer_tpu_torch as ddp
  from daydreamer_tpu_torch import envs, nn
  from daydreamer_tpu_torch.agents.dreamer import Agent
  _graphs_noise()
  rows = {}
  for name in ('xarm', 'a1'):
    for replay_kind in ('fixed', 'prio'):
      rows[f'{name}_{replay_kind}'] = _graphs_learner(name, replay_kind)
  for key, name, overrides, paths in GRAPHS_WIDTHS:
    rows[key] = _graphs_learner(name, 'fixed', overrides, paths)
  # One eager and one graphed xarm agent from one state for the policy and
  # the report.
  env = envs.load_env('xarm_dummy', amount=1, parallel='none')
  try:
    agents = {flag: Agent(env.obs_space, env.act_space, ddp.Counter(),
                          _graphs_config('xarm', flag))
              for flag in (False, True)}
    for agent in agents.values():
      agent._create()
    nn.assign(agents[True].agent, nn.state(agents[False].agent))
    rows['policy'] = _graphs_policy(agents, env)
    rows['report'] = _graphs_report(agents, env)
  finally:
    env.close()
  del agents
  import gc
  gc.collect()
  torch.cuda.empty_cache()
  log(f'graphs: {json.dumps(rows, default=str)}')
  return rows


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
  # The first call of each entry point carries the creation pass, and
  # under torch.graphs the second the capture of its graph.
  train_s, policy_s = times['train'][2:], times['policy'][2:]
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
  path: no RSSM kernel may launch, the four of XLA's fusions must, and the
  RSSM step's four at least once an update), with the fused observe chain (`--rssm.impl
  pallas`: observe_fwd and observe_bwd at D = U = 256, E = 512, A = 12),
  and through the native batcher (`--data_loader native`), whose library
  g++ must have built into native/_build/ and loaded. Returns the loop
  path's launches."""
  from daydreamer_tpu_torch.agents.dreamer import torchagent
  from daydreamer_tpu_torch.native.build import BUILD
  from daydreamer_tpu_torch.replay import batcher
  library = BUILD / 'libfastcopy.so'
  built_before = library.exists()
  launches, run = phase_slice('a1', A1_ARGS, FUSION_KERNELS + STEP_KERNELS)
  if any(launches[k] for k in RSSM_KERNELS):
    raise AssertionError(f'a1: an RSSM kernel launched on the loop path: '
                         f'{launches}')
  # Every update runs the observe loop and the rollout through the RSSM
  # step's kernels (and the policy steps their forward pair).
  if any(launches[k] < run['updates'] for k in STEP_KERNELS):
    raise AssertionError(f'a1: the RSSM step\'s kernels launched less than '
                         f'once an update: {launches}')
  log('a1: the RSSM step\'s kernels, launches an update (the policy steps '
      'included): ' + ', '.join(f'{k} {launches[k] / run["updates"]:.2f}'
                                for k in STEP_KERNELS))
  phase_slice('a1 (rssm.impl pallas)', [*A1_ARGS, '--rssm.impl', 'pallas'],
              OBSERVE_KERNELS + FUSION_KERNELS)
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
  return launches


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
  import torch
  explore_calls = []
  explore_policy = behaviors.Explore.policy
  # A call made while a CUDA graph is being captured runs nothing; each
  # replay of the graph it was captured into runs Explore's actor instead.
  def counted(self, *args):
    if not torch.cuda.is_current_stream_capturing():
      explore_calls.append(1)
    return explore_policy(self, *args)

  behaviors.Explore.policy = counted
  try:
    label = 'explore (plan2explore)'
    with policy_probe() as seen:
      launches, run = phase_slice(label, PLAN2EXPLORE_ARGS, TRAIN_KERNELS)
  finally:
    behaviors.Explore.policy = explore_policy
  _twice_per_update(label, launches, run)
  agent, = seen['agents']
  explore_calls += [1] * sum(
      call.replays for (name, mode, _), call in agent.graphs.captured.items()
      if name == 'policy' and mode == 'explore')
  expl = {k: v for k, v in run['losses'].items()
          if k.startswith('train/expl_')}
  if not expl:
    raise AssertionError(f'{label}: no expl_ loss was logged.')
  # `train.expl_until: 0`: every policy step runs in mode 'explore'.
  if len(explore_calls) < run['policy_steps']:
    raise AssertionError(
        f'{label}: Explore acted {len(explore_calls)} times in '
        f'{run["policy_steps"]} policy steps.')
  log(f'{label}: Explore\'s actor in {len(explore_calls)} policy calls '
      f'(eager calls and replays of the graphs that hold it); last logged '
      f'expl_ losses {expl}')

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


def run_ranks(label, world, backend, rundir, graphs, card_each=False):
  """`world` ranks of the worker with `backend` and `--torch.graphs
  graphs`, all on card 0 or, with `card_each`, rank r on card r, through
  a `file://` store in `rundir`; each rank's output goes to a file there.
  Returns, per rank, its INFO, LAUNCHES and RESULT lines, parsed."""
  import os
  tag = f'{backend}_{world}_{"graphed" if graphs else "eager"}'
  store = (rundir / f'store_{tag}').as_uri()
  env = dict(os.environ, PYTHONPATH=str(ROOT))
  env.pop('LOCAL_RANK', None)
  outs, procs = [], []
  for rank in range(world):
    out = open(rundir / f'{tag}_rank{rank}.log', 'w')
    outs.append(out)
    if card_each:
      env = dict(env, LOCAL_RANK=str(rank))
    procs.append(subprocess.Popen(
        [sys.executable, '-m', 'daydreamer_tpu_torch.scripts.multihost_worker',
         store, str(world), str(rank), '--backend', backend, *PARALLEL_ARGS,
         '--torch.graphs', str(graphs)],
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
    text = (rundir / f'{tag}_rank{rank}.log').read_text()
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
    replays = rank['info']['graphs'].get('train', {}).get('replays', 0)
    if graphs != (replays >= updates):
      raise AssertionError(f'{label}: graphs {graphs}, but the update '
                           f'graph replayed {replays} times in {updates} '
                           f'updates: {rank["info"]["graphs"]}')
  for rank, result in enumerate(ranks):
    log(f'{label}: rank {rank}: {result["rate"]:.3f} updates/s over '
        f'{result["launches"]["updates"]} updates, model loss '
        f'{result["loss"]!r}, state checksum {result["checksum"]}, launches '
        f'{({k: result["launches"][k] for k in TRAIN_KERNELS})}, '
        f'{result["info"]}')
  return ranks


def _outcome(rank):
  """What the replicas and the arms must agree on: the loss, the state's
  checksum and the report's."""
  return rank['loss'], rank['checksum'], rank['info']['report_checksum']


def phase_parallel():
  """Two ranks on the card over gloo, eager, then one over NCCL graphed and
  eager (see the module docstring, phase 9). Returns each rank's launches
  of every kernel, by rank (`gloo_rank0`, `gloo_rank1`, `nccl_rank0`,
  graphed, and `nccl_rank0_eager`)."""
  import torch
  begin = time.perf_counter()
  torch.cuda.empty_cache()  # The earlier phases' cached blocks.
  rundir = new_logdir('parallel')
  smi = smi_cards()
  pair = run_ranks('parallel (2 ranks, gloo)', 2, 'gloo', rundir, False)
  if len({_outcome(r) for r in pair}) != 1:
    raise AssertionError(f'parallel (2 ranks, gloo): the replicas differ: '
                         f'{[_outcome(r) for r in pair]}')
  graphed, = run_ranks('parallel (1 rank, nccl, graphed)', 1, 'nccl', rundir,
                       True)
  eager, = run_ranks('parallel (1 rank, nccl, eager)', 1, 'nccl', rundir,
                     False)
  if _outcome(graphed) != _outcome(eager):
    raise AssertionError(
        f'parallel (1 rank, nccl): graphed and eager differ: '
        f'{_outcome(graphed)} / {_outcome(eager)}')
  grad_bytes = pair[0]['info']['grad_bytes']
  log(f'parallel: the two gloo ranks agree (loss {pair[0]["loss"]!r}, '
      f'checksum {pair[0]["checksum"]}); {grad_bytes} bytes of gradients '
      f'averaged over the ranks an update; updates/s of each rank of the '
      f'pair {[r["rate"] for r in pair]}; one rank over NCCL graphed '
      f'{graphed["rate"]}, eager {eager["rate"]}, the same loss '
      f'{graphed["loss"]!r}, state checksum {graphed["checksum"]} and '
      f'report checksum {graphed["info"]["report_checksum"]}; its graphs '
      f'{graphed["info"]["graphs"]} (a correctness run on one shared card, '
      f'not a scaling figure; {smi}); phase '
      f'{time.perf_counter() - begin:.1f} s')
  ranks = {f'gloo_rank{i}': r for i, r in enumerate(pair)}
  ranks['nccl_rank0'] = graphed
  ranks['nccl_rank0_eager'] = eager
  return {name: {k: v for k, v in r['launches'].items() if k != 'updates'}
          for name, r in ranks.items()}


def _imitation_arm(agent, obs, rng_seed):
  """One arm of the imitation phase: a warm `act`, ten under
  torch.profiler, the rollout's batch-1 `act` calls, `gae` and two
  `update`s on the same rollout. Returns its outputs and times."""
  from torch.profiler import ProfilerActivity, profile
  from daydreamer_tpu_torch.scripts import profile_train
  horizon = len(obs)
  acts = [agent.act(obs[:1])]  # Warm; the graphed arm captures here.
  activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
  with profile(activities=activities) as prof:
    for i in range(10):
      acts.append(agent.act(obs[i:i + 1]))
  rows, _, busy = profile_train.summarize(prof, 10, True)
  launches = sum(r['launches_per_update'] for r in rows)
  seg = {k: [] for k in ('action', 'logp', 'value')}
  act_s = []
  for i in range(horizon):
    begin = time.perf_counter()
    out = agent.act(obs[i:i + 1])
    act_s.append(time.perf_counter() - begin)
    acts.append(out)
    for key, x in zip(seg, out):
      seg[key].append(x[0])
  seg = {k: np.asarray(v, np.float32) for k, v in seg.items()}
  rng = np.random.default_rng(rng_seed)
  rewards = rng.uniform(0, 1, horizon).astype(np.float32)
  conts = (rng.uniform(size=horizon) > 0.002).astype(np.float32)
  begin = time.perf_counter()
  adv, ret = agent.gae(rewards, seg['value'], conts, seg['value'][-1])
  gae_s = time.perf_counter() - begin
  rollout = dict(obs=obs, action=seg['action'], logp=seg['logp'], adv=adv,
                 ret=ret)
  update_s, metrics = [], []  # The first update, then a warm one.
  for _ in range(2):
    begin = time.perf_counter()
    metrics.append(agent.update(rollout))
    update_s.append(time.perf_counter() - begin)
  return dict(acts=acts, act_ms=1e3 * np.asarray(act_s), launches=launches,
              busy=busy, gae_s=gae_s, rollout=rollout, update_s=update_s,
              metrics=metrics, state=agent.save())


def phase_parallel_cards():
  """One rank of the worker on each visible card over NCCL (at least two;
  the extra phase `parallel_cards`), graphed and eagerly, at the parallel
  phase's settings: the ranks of each arm must agree exactly (the
  collectives captured in the graphs reduce over the ranks at every
  replay), and so must the two arms, in the loss, the state's checksum and
  the report's. Returns each rank's launches of every kernel, by arm and
  rank."""
  import torch
  begin = time.perf_counter()
  world = torch.cuda.device_count()
  if world < 2:
    raise AssertionError(f'parallel_cards: {world} card; the phase needs '
                         f'one card a rank, two at least.')
  rundir = new_logdir('parallel_cards')
  arms = {}
  for graphs in (True, False):
    name = 'graphed' if graphs else 'eager'
    label = f'parallel_cards ({world} ranks, nccl, {name})'
    ranks = run_ranks(label, world, 'nccl', rundir, graphs, card_each=True)
    if len({_outcome(r) for r in ranks}) != 1:
      raise AssertionError(f'{label}: the replicas differ: '
                           f'{[_outcome(r) for r in ranks]}')
    arms[name] = ranks
  graphed, eager = arms['graphed'][0], arms['eager'][0]
  devices = sorted({r['info']['device'] for r in arms['graphed']})
  log(f'parallel_cards: {world} ranks on {devices}; graphed: every rank '
      f'{_outcome(graphed)}, updates/s {[r["rate"] for r in arms["graphed"]]}'
      f', graphs {graphed["info"]["graphs"]}; eager: {_outcome(eager)}, '
      f'updates/s {[r["rate"] for r in arms["eager"]]}; all-reduce of '
      f'{graphed["info"]["grad_bytes"]} bytes '
      f'{graphed["info"]["allreduce_ms"]} ms; {smi_cards()}; phase '
      f'{time.perf_counter() - begin:.1f} s')
  if _outcome(graphed) != _outcome(eager):
    raise AssertionError(f'parallel_cards: graphed and eager differ: '
                         f'{_outcome(graphed)} / {_outcome(eager)}')
  log('parallel_cards: graphed and eager equal in the loss, the state and '
      'the report')
  return {f'cards_{name}_rank{i}': {k: v for k, v in r['launches'].items()
                                    if k != 'updates'}
          for name, ranks in arms.items() for i, r in enumerate(ranks)}


def smi_cards():
  """The cards' names and power limits as nvidia-smi gives them."""
  return '; '.join(subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
      capture_output=True, text=True, check=True).stdout.strip().splitlines())


def phase_imitation(seed):
  """The imitation trainer's PPO learner at its defaults on the card. The
  card's machine has no MuJoCo, so the rollout's observations are made
  here: the proprio part from a NumPy generator seeded by `seed`, the
  target features from `task.a1_gait_clip('trot')` at the sim times that
  `ImitationA1._clip_time` gives (episode step x repeat x the physics
  step). The default agent (`act` and `update` replay CUDA graphs) runs
  beside an eager twin (`graphs=False`) loaded from its `save()` with its
  generator state: each times 2048 `act` calls at batch 1 (their launches
  from torch.profiler over ten), `gae` and two `update`s (the first pays
  the capture or the first launch of each kernel), and every `act` output,
  both updates' metrics and the state after them must be equal bit for
  bit in the two arms, and the metrics finite. Then it holds `_loss` and
  its gradients on one minibatch against a CPU agent loaded from the
  card's `save()` (within 1e-4 of the largest magnitude), and that agent's
  values on the same observations."""
  import torch
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
  assert agent.device.type == 'cuda' and agent._use_graphs
  twin = PPOImitation(obs_dim, act_dim, horizon=horizon, seed=seed,
                      graphs=False)
  twin.load(agent.save())
  twin.generator.set_state(agent.generator.get_state())
  arms = {'graphed': _imitation_arm(agent, obs, seed + 1),
          'eager': _imitation_arm(twin, obs, seed + 1)}
  graphed, eager = arms['graphed'], arms['eager']
  unequal = [i for i, (a, b) in enumerate(zip(graphed['acts'], eager['acts']))
             if not all(np.array_equal(x, y) for x, y in zip(a, b))]
  unequal_state = [k for k in graphed['state']
                   if not np.array_equal(graphed['state'][k],
                                         eager['state'][k])]
  if unequal or unequal_state or graphed['metrics'] != eager['metrics']:
    raise AssertionError(
        f'imitation: graphed and eager differ: act calls {unequal[:10]} '
        f'({len(unequal)} of {len(graphed["acts"])}), state entries '
        f'{unequal_state}, metrics {graphed["metrics"]} / '
        f'{eager["metrics"]}')
  metrics = graphed['metrics'][-1]
  bad = {k: v for k, v in metrics.items() if not math.isfinite(v)}
  if bad or metrics['ppo_opt_grad_steps'] != 80:
    raise AssertionError(f'imitation: update metrics {metrics}')
  stats = agent.graphs.stats()
  # The same weights on the CPU: the loss and its gradients on one
  # minibatch, and the values of the first rows.
  host = PPOImitation(obs_dim, act_dim, horizon=horizon, seed=seed,
                      device='cpu')
  host.load(agent.save())
  rollout = graphed['rollout']
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
  log(f'imitation: PPO at obs {obs_dim}, {act_dim} actions, horizon '
      f'{horizon}, {agent.epochs} x {agent.minibatches} minibatches of '
      f'{horizon // agent.minibatches} on {torch.cuda.get_device_name(0)} '
      f'({profile_train.card()}); graphed / eager: ' + '; '.join(
          f'{name}: act at batch 1 {arm["act_ms"].mean():.4f} ms mean, '
          f'{np.median(arm["act_ms"]):.4f} median over {horizon} calls '
          f'({arm["launches"]:.1f} launches and {arm["busy"]:.4f} ms device '
          f'busy a call, torch.profiler over 10); gae '
          f'{1e3 * arm["gae_s"]:.3f} ms; an update of '
          f'{agent.epochs * agent.minibatches} Adam steps '
          f'{1e3 * arm["update_s"][0]:.3f} ms the first, '
          f'{1e3 * arm["update_s"][1]:.3f} ms the next'
          for name, arm in arms.items()) +
      f'; graphs {stats}; every act output, both updates\' metrics and the '
      f'state after them equal bit for bit; metrics {metrics}; card against '
      f'CPU, worst scaled error {errors[worst]:.3g} ({worst}), loss '
      f'{outs[0][0].item()!r} / {outs[1][0].item()!r}')


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


def profile_tool(shape, rundir):
  """`scripts/profile_train.py --shape SHAPE --dispatches 1` as a
  subprocess, checked as `phase_tooling` says; returns its wrappers'
  launches."""
  from daydreamer_tpu_torch.nn import cost
  label = f'profile_train ({shape})'
  report = run_tool(label, 'daydreamer_tpu_torch.scripts.profile_train',
                    ['--shape', shape, '--dispatches', '1',
                     '--out', str(rundir / f'profile_{shape}.json')], rundir)
  updates, launches = report['updates_traced'], report['wrapper_launches']
  traced = {}
  for row in report['own_kernels']:
    for function in PROFILED_OBSERVE:
      if f'::{function}' in row['name']:
        traced[function] = traced.get(function, 0) + row[
            'launches_per_update']
  if shape == 'xarm':
    observed = (launches['observe_fwd'] == updates
                and launches['observe_bwd'] == updates
                and not launches['observe']
                and all(traced.get(f) == 1 for f in PROFILED_OBSERVE))
  else:
    observed = not any(launches[k] for k in RSSM_KERNELS) and not traced
  if not observed or not report['device_busy_ms_per_update'] < report[
      'wall_ms_per_update']:
    raise AssertionError(
        f'{label}: {updates} updates, wrapper launches {launches}, '
        f'device functions a traced update {traced}, busy '
        f'{report["device_busy_ms_per_update"]} against wall '
        f'{report["wall_ms_per_update"]} ms')
  log(f'{label}: {report["wall_ms_per_update"]:.3f} ms wall '
      f'per update traced ({report["untraced_wall_ms_per_update"]:.3f} '
      f'untraced), {report["device_busy_ms_per_update"]:.3f} ms device '
      f'busy, idle share {report["idle_share"]:.3f} (untraced '
      f'{report["idle_share_untraced"]:.3f}), '
      f'{report["launches_per_update"]:.1f} launches an update; by '
      f'category (ms, launches an update): ' + ', '.join(
          f'{r["category"]} {r["ms_per_update"]:.3f} / '
          f'{r["launches_per_update"]:.1f}' for r in report['categories']))
  # The counterparts of XLA's fusions: counted by their wrappers and seen
  # by name in the trace, each in a category of its own; at a1 (the loop
  # path) the RSSM step's four as well.
  names = FUSION_KERNELS + (STEP_KERNELS if shape == 'a1' else ())
  fused = {k: launches[k] / updates for k in FUSION_KERNELS + STEP_KERNELS}
  categories = {r['category']: r for r in report['categories']}
  if any(fused[k] < 1 for k in names) or any(
      k not in categories for k in names):
    raise AssertionError(f'{label}: the fusions\' launches an update '
                         f'{fused}, categories {sorted(categories)}')
  empty = dict(ms_per_update=0.0, launches_per_update=0.0)
  log(f'{label}: the fusions\' kernels, wrapper launches / '
      'device ms / device launches an update: ' + ', '.join(
          f'{k} {fused[k]:.2f} / '
          f'{categories.get(k, empty)["ms_per_update"]:.3f} / '
          f'{categories.get(k, empty)["launches_per_update"]:.1f}'
          for k in FUSION_KERNELS + STEP_KERNELS))
  counted = report['bytes']
  rate = counted['bytes_per_update'] / report['device_busy_ms_per_update'] / (
      1e6)
  log(f'{label}: {counted["bytes_per_update"]} bytes an update '
      f'(train_device_cost), {counted["twin_bytes_per_update"]} on the '
      f'loop-path twin; {rate:.1f} GB/s over the busy time; by category '
      f'(GB an update, twin GB, device ms, GB/s): ' + ', '.join(
          f'{r["category"]} {r["bytes_per_update"] / 1e9:.4f} / '
          f'{r["twin_bytes_per_update"] / 1e9:.4f} / '
          f'{r["device_ms_per_update"]} / {r["gb_per_s"]}'
          for r in counted['categories']))
  if not 0 < rate <= cost.H100['hbm_bytes'] / 1e9:
    raise AssertionError(f'{label}: {rate} GB/s over the busy time')
  return launches


def phase_tooling():
  """The port's two instruments as a user runs them. First
  `scripts/profile_train.py --shape xarm --dispatches 1` (K = 16:
  one dispatch that creates the state, two warm, one traced, so 64
  updates; then the bytes of an update by category): its wrappers must
  count observe_fwd and observe_bwd once a traced update and `observe`
  never, its trace must show observe_fwd's three device functions and
  observe_bwd's one launched once an update, the device's busy time must
  be under the wall time, and the bytes of an update over the busy time
  must stay under the card's memory rate. Then the same at `--shape a1`
  (K = 64, the loop path), whose wrappers must count no RSSM kernel and
  each of the RSSM step's four at least once an update, each in a
  category of its own in the trace. Then
  `scripts/policy_latency.py` at `--shape a1` and `--shape test`, the card
  and the host mirror: each must print its result, and the card's whole
  policy call at a1 must take under 50 ms. Returns the profiles' launches
  of each kernel, xarm's and a1's."""
  rundir = new_logdir('tooling')
  profiled = {}
  for shape in ('xarm', 'a1'):
    profiled[shape] = profile_tool(shape, rundir)
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
  return profiled['xarm'], profiled['a1']


# A minute and a half of the deployment pair; the learner on the card with
# the fused observe chain, the actor on a1_dummy (no MuJoCo on the card's
# machine).
SOAK_ARGS = ['--minutes', '1.5', '--learner-device', 'cuda', '--actor-task',
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


BENCH_BUDGET = 3.0  # Seconds of windows an arm in the bench phase.
# Its updates a dispatch: the bench's K at xarm, fewer at test (256) and a1
# (64), whose eager dispatches take 20-40 s each on the card.
BENCH_K = {'test': 32, 'a1': 16, 'xarm': 16}


def phase_bench(device_name):
  """The port's `scripts/bench.py` pieces at its three shapes with short
  budgets (see the module's docstring, phase 13), each shape's eager and
  graphed arm (`bench.compare_graphs`) in turn. `hbm_bw_util` holds the
  loop-path twin's bytes (`bytes_per_update`) to the timed program's rate,
  so where the timed program's own count is smaller (the fused observe
  kernels at xarm) it reads high by the ratio of the two, and the gate at 1
  holds the twin's count, not the timed program's; at xarm the share of
  the agent's own count is printed beside it. Returns the launches of each
  kernel in the graphed arm's timed windows at xarm."""
  import torch
  from daydreamer_tpu_torch.scripts import bench
  device = torch.device('cuda')
  results = {}
  for shape in ('test', 'a1', 'xarm'):
    begin = time.perf_counter()
    rows = bench.compare_graphs(
        shape, device, BENCH_BUDGET, K=BENCH_K[shape],
        policy_budget_s=3.0 if shape == 'test' else None)
    for arm in ('eager', 'graphed'):
      res = rows[arm]
      rates = [res['updates_per_s'], *res['rate_windows']]
      log(f'bench ({shape}, {arm}): {res["updates_per_s"]} updates/s median '
          f'of {rates[1:]}, first dispatch {res["first_dispatch_s"]:.3f} s, '
          f'capture {res["capture_s"]} s, pool {res["pool_bytes"]} bytes, '
          f'{rows["flops_per_update"]} FLOPs and {rows["bytes_per_update"]} '
          f'bytes an update, MFU {res["mfu"]}, HBM share '
          f'{res["hbm_bw_util"]}, '
          f'launches {res["launches"]} in {res["updates_timed"]} timed '
          f'updates, model loss {res["model_loss"]}'
          + (f', policy {res["policy"]["median_s"] * 1e3:.4f} ms a call'
             if 'policy' in res else ''))
      fused = {k: res['launches'].get(k, 0) / res['updates_timed']
               for k in FUSION_KERNELS}
      # The RSSM step's kernels: the loop paths (test, a1) forward and
      # backward, xarm's rollout (`imag_impl: scan`) at least forward.
      steps = {k: res['launches'].get(k, 0) / res['updates_timed']
               for k in STEP_KERNELS}
      log(f'bench ({shape}, {arm}): the fusions\' launches an update '
          f'{fused}, the RSSM step\'s {steps}')
      needed = STEP_FWD if shape == 'xarm' else STEP_KERNELS
      if (not all(math.isfinite(r) and r > 0 for r in rates)
          or any(v < 1 for v in fused.values())
          or any(steps[k] < 1 for k in needed)
          or not rows['flops_per_update'] > 0
          or not (rows['bytes_per_update'] or 0) > 0
          or not 0 < (res['hbm_bw_util'] or 0) <= 1.0
          or res['device'] != device_name
          or not math.isfinite(res['model_loss'])):
        raise AssertionError(f'bench ({shape}, {arm}): {res}')
    if shape == 'xarm':
      own = rows.get('own_cost') or {}
      if not (own.get('bytes accessed') or 0) > 0:
        raise AssertionError(f'bench (xarm): no count of its own: {own}')
      share = own['bytes accessed'] / rows['bytes_per_update']
      log(f'bench (xarm): an update of the configured agent '
          f'(train_device_cost) {own["flops"]} FLOPs, '
          f'{own["bytes accessed"]} bytes; of the loop-path twin '
          f'{rows["flops_per_update"]} FLOPs, {rows["bytes_per_update"]} '
          f'bytes; bytes over the twin\'s '
          f'{share:.4f}; HBM share of its own bytes, graphed '
          f'{rows["graphed"]["hbm_bw_util"] * share:.4f}')
    log(f'bench ({shape}): {time.perf_counter() - begin:.1f} s; graphed over '
        f'eager {rows["speedup"]:.3f}'
        + (f', policy {rows["policy_speedup"]:.3f}'
           if 'policy_speedup' in rows else '') + f' ({device_name})')
    results[shape] = rows
  for arm in ('eager', 'graphed'):
    xarm = results['xarm'][arm]
    if not 0 < (xarm['mfu'] or 0) < 1:
      raise AssertionError(f'bench (xarm, {arm}): MFU {xarm["mfu"]}')
  agent, data = bench.build_agent(*bench.SHAPES['test'][:2], device)
  policy = bench.measure_policy(agent, data, budget_s=3.0, max_windows=2)
  del agent, data
  bench.free_memory(device)
  if policy['device_on'] != 'cuda' or policy['mirror_on'] != 'cpu':
    raise AssertionError(f'bench policy: {policy}')
  log(f'bench policy (test shape, graphed): card {policy["device"]}, host '
      f'mirror {policy["cpu_mirror"]}, null round trip {policy["null_rtt"]}; '
      f'gates {json.dumps(bench.gates(policy))}')
  return results['xarm']['graphed']['launches']


def phase_impl_bench():
  """The port's two impl benches at their own budgets (see the module's
  docstring); each checks that its pallas arm launched its kernels once a
  timed update and its scan arm never."""
  from daydreamer_tpu_torch.scripts import fused_impl_bench, imag_impl_bench
  rundir = new_logdir('impl_bench')
  for script in (fused_impl_bench, imag_impl_bench):
    label = script.__name__.rsplit('.', 1)[-1]
    begin = time.perf_counter()
    result = script.main(['--out', str(rundir / f'{label}.json')])
    speedups = {shape: rows['speedup'] for shape, rows in result.items()
                if isinstance(rows, dict) and 'speedup' in rows}
    log(f'{label}: {time.perf_counter() - begin:.1f} s; pallas over scan '
        f'{speedups}; results in {rundir}')
    if not speedups or not all(
        math.isfinite(v) and v > 0 for v in speedups.values()):
      raise AssertionError(f'{label}: {result}')


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

  # Seed 0 keeps its file; another seed writes one of its own.
  out = ROOT / 'scores' / (f'{name}_dreamer_torch.json' if not seed else
                           f'{name}_dreamer_torch_s{seed}.json')
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
  train_s, policy_s = times['train'][2:], times['policy'][2:]
  log(f'{label}: {steps} env steps in {wall:.1f} s, {updates} updates '
      f'({len(train_s) / sum(train_s):.3f} updates/s, the first two '
      f'excluded: creation and capture), {len(times["policy"])} policy steps '
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


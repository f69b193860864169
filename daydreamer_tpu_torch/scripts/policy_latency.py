"""Break down `agent.policy` latency at batch 1, on the card and on the
host-CPU policy mirror: the port of `scripts/policy_latency.py`.

The reference asserts 0.007 s steady policy latency on its training GPU
(embodied/agents/dreamerv2plus/tests.py:87-89); the robot actor's budget
is 50 ms at 20 Hz (robot_interface.py:293). For the policy on the agent's
device, replayed as a CUDA graph (`torch.graphs: True`, the default) and
eagerly (`device_eager`), and for the mirror (`torch.policy_devices: cpu`,
always eager), each over `--reps` calls after two warm ones (the second
captures the graph):

  - whole_ms: the full `agent.policy` call (observations in as numpy,
    actions out as numpy, so it ends synced);
  - dispatch_ms: the policy's forward on observations already on its
    device, returning with its kernels queued, no sync (graphed: the copy
    into the graph's inputs, its replay and the copy of its outputs);
  - synced_ms: the same forward followed by `torch.cuda.synchronize()`;
  - fetch_ms: whole_ms - synced_ms (the copies in and out and the host
    conversions).

`null_rtt_ms` is the launch, sync and fetch of a trivial op on the device,
taken before and after the device's measurement. The three loops are
separate, so the breakdown is approximate. The mirror must run: a failure
there fails the script. It runs on the card unless `--device cpu`.

Usage:
  python -m daydreamer_tpu_torch.scripts.policy_latency [--shape test|a1] \\
      [--reps 50] [--out FILE] [--gate] [--device cuda|cpu]

Prints one JSON line per variant and the whole result as the last line.
"""

import argparse
import json
import pathlib
import time

import numpy as np
import torch

from .. import nn
from .profile_train import card, resolve_device


def build_agent(shape, device):
  import daydreamer_tpu_torch as ddp
  from daydreamer_tpu_torch.agents.dreamer import Agent
  from daydreamer_tpu_torch.envs import load_env
  config = ddp.Config(Agent.configs['defaults'])
  if shape == 'test':
    config = config.update({
        'replay_chunk': 8, 'batch_size': 8,
        r'.*\.layers': 2, r'.*\.units': 128, r'.*\.cnn_depth': 16})
    task = 'dummy_discrete'
  elif shape == 'a1':
    # The robot actor's shape: the proprio-only a1 config. The test
    # shape's policy runs a batch-1 image CNN, which the quadruped's does
    # not.
    config = config.update(Agent.configs['a1'])
    task = 'a1_dummy'
  else:
    raise NotImplementedError(shape)
  config = config.update({'env.parallel': 'none', r'.*\.wd$': 0.0,
                          'torch.device': str(device)})
  env = load_env(task, amount=1, parallel='none', length=10)
  agent = Agent(env.obs_space, env.act_space, ddp.Counter(), config)
  obs = {}
  for key, space in env.obs_space.items():
    obs[key] = np.zeros((1,) + space.shape, space.dtype)
  if 'image' in obs:
    obs['image'] = np.random.default_rng(0).integers(
        0, 255, (1, 64, 64, 3), np.uint8)
  obs['is_first'][:] = True
  env.close()
  return agent, obs


def _sync(device):
  if device.type == 'cuda':
    torch.cuda.synchronize(device)


def measure(agent, obs, reps):
  """The four times of one variant: the policy on `agent`'s policy device
  (the agent's own, or the host mirror)."""
  pstate = None
  for _ in range(2):
    _, pstate = agent.policy(obs, pstate, mode='eval')
  begin = time.perf_counter()
  for _ in range(reps):
    _, pstate = agent.policy(obs, pstate, mode='eval')
  whole = (time.perf_counter() - begin) / reps
  module, generator = agent._policy_agent()
  device = generator.device
  inputs = agent._to_device(obs, device)
  graphed = agent._use_graphs and module is agent.agent

  def forward():
    if graphed:  # The graph that the calls above captured.
      return agent.graphs('policy', 'eval', None, (inputs, pstate))
    with torch.no_grad(), nn.scope(dtype=agent.dtype, generator=generator):
      return module.policy(inputs, pstate, mode='eval')

  _sync(device)
  begin = time.perf_counter()
  for _ in range(reps):
    forward()
  dispatch = (time.perf_counter() - begin) / reps
  _sync(device)
  begin = time.perf_counter()
  for _ in range(reps):
    forward()
    _sync(device)
  synced = (time.perf_counter() - begin) / reps
  return dict(on=str(device), graphed=graphed, whole_ms=whole * 1e3,
              dispatch_ms=dispatch * 1e3, synced_ms=synced * 1e3,
              fetch_ms=(whole - synced) * 1e3)


def null_rtt(device, reps):
  """Launch, sync and fetch of a trivial op: the floor that any policy
  call on `device` pays whatever the model."""
  x = torch.zeros(8, device=device)
  (x + 1).cpu()
  begin = time.perf_counter()
  for _ in range(reps):
    (x + 1).cpu()
  return (time.perf_counter() - begin) / reps * 1e3


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  parser.add_argument('--reps', type=int, default=50)
  parser.add_argument('--shape', default='test', choices=['test', 'a1'])
  parser.add_argument('--out', default='')
  parser.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
  parser.add_argument('--gate', action='store_true',
                      help='assert the robot budgets: mirror whole call '
                           '<= 50 ms and device whole call minus null RTT '
                           '<= 10 ms; exit nonzero on failure')
  args = parser.parse_args(argv)
  device = resolve_device(args.device)
  on_card = device.type == 'cuda'
  results = {
      'backend': torch.cuda.get_device_name(device) if on_card else 'cpu',
      'card': card() if on_card else None,
      'shape': args.shape, 'reps': args.reps,
      'null_rtt_ms': null_rtt(device, args.reps)}
  agent, obs = build_agent(args.shape, device)
  results['device'] = measure(agent, obs, args.reps)
  print(json.dumps({'variant': 'device', **results['device']}), flush=True)
  graphs, agent._use_graphs = agent._use_graphs, False
  results['device_eager'] = measure(agent, obs, args.reps)
  agent._use_graphs = graphs
  print(json.dumps({'variant': 'device_eager', **results['device_eager']}),
        flush=True)
  # Bracket the device's measurements with a second sample of the floor.
  results['null_rtt_after_ms'] = null_rtt(device, args.reps)
  agent._policy_devices = 'cpu'
  agent._mirror = None
  results['cpu_mirror'] = measure(agent, obs, args.reps)
  print(json.dumps({'variant': 'cpu_mirror', **results['cpu_mirror']}),
        flush=True)
  if args.gate:
    # Robot budgets: 50 ms for the host actor loop (reference
    # robot_interface.py:293) and at most 10 ms of device work beyond the
    # round-trip floor (reference tests.py:87-89 asserts 7 ms).
    floor = max(results['null_rtt_ms'], results['null_rtt_after_ms'])
    results['gates'] = {
        'mirror_le_50ms': results['cpu_mirror']['whole_ms'] <= 50.0,
        'device_minus_null_rtt_le_10ms': (
            results['device']['whole_ms'] - floor <= 10.0)}
    print(json.dumps(results['gates']), flush=True)
  if args.out:
    pathlib.Path(args.out).write_text(json.dumps(results, indent=2) + '\n')
  print(json.dumps(results), flush=True)
  if args.gate and not all(results['gates'].values()):
    raise SystemExit(f'policy_latency: a budget was missed: '
                     f'{results["gates"]}')
  return results


if __name__ == '__main__':
  main()

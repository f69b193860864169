"""One rank of an N-process data-parallel group of the port, on the CPU
(gloo) or on the card: the port of `scripts/multihost_worker.py`.

Every rank builds the agent, whose `data` mesh spans the group, takes its
rows of one global batch made with numpy from seed 0 (the same global
batch whatever the world), and feeds them as K fused updates through
`parallel.host_local_batch` and `train_multi`: one dispatch that creates
the state, then `--steps` timed ones. The gradients and the batch statistics
are reduced over the ranks inside each update, so every rank ends with the
same state and the same metrics.

Usage:
  python -m daydreamer_tpu_torch.scripts.multihost_worker ADDRESS NUM_PROCS \\
      PROC_ID [--steps 3] [--fused 4] [--tiny] [--configs debug]
      [--device cpu] [--backend gloo] [config flags, e.g. --imag_impl pallas]

ADDRESS is a port on localhost or an init URL (`tcp://host:port`,
`file:///path`). `--configs debug` (the default) is the JAX worker's shape
(4 rows per rank, chunk 8, imag_horizon 3) and `--tiny` its MULTIHOST_TINY
cut of the widths; `--configs xarm` is xarm at full width, its batch of 32
split over the ranks. The device defaults to the card, and without one
the worker raises unless `--device cpu` is given; ranks on one host share
its cards (`LOCAL_RANK`). The backend defaults to nccl on the card and
gloo on the CPU; two ranks on one card need gloo.

Prints `RESULT <rank> <model_loss> <updates_per_s> <state_checksum>`, the
loss in full precision and the checksum a hash of the whole saved state,
and before it `LAUNCHES <json>`, the launches of each kernel in the timed
dispatches of this rank and their count of updates, and `INFO <json>`,
the world, the backend, the rows of this rank, the bytes of the
gradients averaged over the ranks in each update, the wall time of one
all-reduce of that many bytes on this group, the CUDA graphs of the
agent (`graphs`: per entry point its graphs, replays, capture seconds and
pool bytes; empty when it ran eagerly) and a hash of the scalars of a
report on this rank's rows after the updates (`report_checksum`: reduced
over the ranks, so the same on every rank; null where the chunk is too
short for the report's open loop).

Over NCCL the agent runs with `torch.graphs` as the config has it (True by
default: each update replays one CUDA graph, its collectives inside); over
gloo it runs eagerly, since a graph cannot capture gloo's collectives.
"""

import argparse
import hashlib
import json
import sys
import time

import numpy as np


# The JAX worker's shape under `--configs debug`, and MULTIHOST_TINY.
DEBUG = {'replay_chunk': 8, 'imag_horizon': 3, 'env.amount': 1}
TINY = {
    'encoder.cnn_keys': '$^', 'decoder.cnn_keys': '$^', 'replay_chunk': 4,
    'rssm': {'units': 32, 'deter': 32, 'stoch': 4, 'classes': 4},
    r'.*\.units': 32}


def make_batch(obs_space, act_space, B, T, seed):
  """A global batch from a seed: random observations of each space's
  dtype, one-hot or uniform actions, rewards in [0, 1], first steps at 0."""
  rng = np.random.default_rng(seed)
  data = {}
  for key, space in obs_space.items():
    if key.startswith('log_'):
      continue
    shape = (B, T) + space.shape
    if space.dtype == np.uint8:
      data[key] = rng.integers(0, 256, shape, np.uint8)
    elif space.dtype == bool:
      data[key] = np.zeros(shape, bool)
    else:
      data[key] = rng.standard_normal(shape).astype(space.dtype)
  action = act_space['action']
  A = action.shape[0]
  if action.discrete:
    data['action'] = np.eye(A, dtype=np.float32)[rng.integers(0, A, (B, T))]
  else:
    data['action'] = rng.uniform(-1, 1, (B, T, A)).astype(np.float32)
  data['reward'] = rng.uniform(0, 1, (B, T)).astype(np.float32)
  data['is_first'][:, 0] = True
  return data


def checksum(values):
  digest = hashlib.sha256()
  for key in sorted(values):
    digest.update(key.encode())
    digest.update(np.ascontiguousarray(values[key]).tobytes())
  return digest.hexdigest()[:16]


def main(argv):
  parser = argparse.ArgumentParser()
  parser.add_argument('address')
  parser.add_argument('num_processes', type=int)
  parser.add_argument('process_id', type=int)
  parser.add_argument('--steps', type=int, default=3)
  parser.add_argument('--fused', type=int, default=4)
  parser.add_argument('--tiny', action='store_true')
  parser.add_argument('--configs', nargs='+', default=['debug'])
  parser.add_argument('--device', default='cuda')
  parser.add_argument('--backend', default=None)
  args, other = parser.parse_known_args(argv)

  import torch
  import daydreamer_tpu_torch as ddp
  from daydreamer_tpu_torch import envs
  from daydreamer_tpu_torch.agents.dreamer import Agent
  from daydreamer_tpu_torch.agents.dreamer.torchagent import Prestacked
  from daydreamer_tpu_torch.ops import build
  # `daydreamer_tpu_torch.parallel` by its path: the package's name
  # `parallel` is core's module of parallel envs.
  from daydreamer_tpu_torch.parallel import distributed
  from daydreamer_tpu_torch.parallel import mesh as meshlib

  device = distributed.local_device(args.device)
  if device.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError(
        '--device is cuda but no CUDA device is available; pass --device '
        'cpu to run on the CPU.')
  if device.index is not None:
    torch.cuda.set_device(device)
  backend = args.backend or ('nccl' if device.type == 'cuda' else 'gloo')
  address = args.address
  if address.isdigit():
    address = f'localhost:{address}'
  distributed.initialize(address, args.num_processes, args.process_id, backend)
  world, rank = distributed.world_size(), distributed.rank()
  assert world == args.num_processes, world
  # The backend reduces before anything else runs on it.
  probe = torch.ones(1, device=device)
  torch.distributed.all_reduce(probe)
  assert int(probe.item()) == world, probe

  config = ddp.Config(Agent.configs['defaults'])
  for name in args.configs:
    config = config.update(Agent.configs[name])
  if 'debug' in args.configs:
    config = config.update(DEBUG, batch_size=4 * world)
  if args.tiny:
    config = config.update(TINY)
  # Over gloo eager unless a flag says otherwise: a CUDA graph cannot
  # capture gloo's collectives, and the agent raises on several ranks on
  # the card with `torch.graphs: True` there. Over NCCL the updates are
  # captured with their collectives, as in a single process.
  if backend != 'nccl':
    config = config.update({'torch.graphs': False})
  config = ddp.Flags(config).parse(other)
  config = config.update({'torch.device': str(device)})
  env = envs.load_env(config.task, **config.env)
  try:
    agent = Agent(env.obs_space, env.act_space, ddp.Counter(), config)
    data = make_batch(env.obs_space, env.act_space, config.batch_size,
                      config.replay_chunk, 0)
  finally:
    env.close()

  # This rank's rows, stacked K times along an unsharded leading axis.
  local = meshlib.shard_batch(
      {k: torch.as_tensor(v) for k, v in data.items()}, agent.mesh)
  K = args.fused
  stacked = distributed.host_local_batch(
      {k: torch.stack([v] * K) for k, v in local.items()}, agent.mesh,
      leading=1)
  batches = Prestacked(stacked, [None] * K, K)
  sync = torch.cuda.synchronize if device.type == 'cuda' else (lambda: None)
  _, state, mets = agent.train_multi(batches)  # Creates the state.
  sync()
  for kernel in build.KERNELS:
    kernel.launches = 0
  begin = time.perf_counter()
  for _ in range(args.steps):
    _, state, mets = agent.train_multi(batches, state)
  sync()
  rate = args.steps * K / (time.perf_counter() - begin)
  loss = float(mets['model_loss_mean'])
  launches = {k.name: k.launches for k in build.KERNELS}
  launches['updates'] = args.steps * K
  # The report on this rank's rows, twice (graphed: a capture, then a
  # replay); its scalars are reduced over the ranks inside the call. Its
  # open loop starts at step 5, so a shorter chunk (`--tiny`) has none.
  report_sum = None
  if config.replay_chunk > 5:
    for _ in range(2):
      report = agent.report(local)
    report_sum = checksum(
        {k: v for k, v in report.items() if not np.ndim(v)})
  params = sum(p.numel() for p in agent.agent.parameters())
  total = checksum(agent.save())
  # What one average of all the gradients costs on this group: a float32
  # bucket of every parameter, as the optimizers reduce theirs.
  bucket = torch.ones(params, device=device)
  torch.distributed.all_reduce(bucket)
  sync()
  begin = time.perf_counter()
  for _ in range(3):
    torch.distributed.all_reduce(bucket)
  sync()
  allreduce_ms = (time.perf_counter() - begin) / 3 * 1e3
  graphs = agent.graphs.stats()
  # The graphs may hold the group's collectives: released before it.
  agent.graphs.captured.clear()
  torch.distributed.destroy_process_group()
  if not np.isfinite(loss):
    raise SystemExit(f'rank {rank}: model loss {loss}')
  # The gradients that the ranks average each update, in float32.
  info = dict(world=world, backend=backend, device=str(device),
              rows=len(local['is_first']), params=params,
              grad_bytes=4 * params, allreduce_ms=round(allreduce_ms, 3),
              graphs=graphs, report_checksum=report_sum)
  print(f'INFO {json.dumps(info)}', flush=True)
  print(f'LAUNCHES {json.dumps(launches)}', flush=True)
  print(f'RESULT {rank} {loss!r} {rate:.3f} {total}', flush=True)


if __name__ == '__main__':
  main(sys.argv[1:])

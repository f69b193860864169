"""Multi-process data parallelism over `torch.distributed`: the port of
`daydreamer_tpu/parallel/distributed.py`.

The JAX package runs one SPMD program over every device of every host, so
each statistic it takes over the batch is one of the global batch, and XLA
inserts the collectives. Here each process (a rank) runs the update on its
own rows, and the places where the global batch matters reduce across the
ranks with the helpers below: the gradients (`nn/opt.py`), the statistics
of `Normalize` and `AutoAdapt` (`nn/utils.py`), the importance weights'
maximum (`agents/dreamer/agent.py`), DisagWhen's buffer merge
(`agents/dreamer/behaviors.py`) and the metrics (`torchagent.py`). Each
helper is the identity when no process group exists or its world is 1, so
a single process computes exactly what it computes without them. The
helpers ride the default group, which the agent's `data` axis spans.
"""

import os

import numpy as np
import torch
import torch.distributed as dist


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, backend='nccl'):
  """Join the process group; a no-op that returns False for a single
  process (no address given or in the environment, at most one process).

  Reads torchrun's `MASTER_ADDR`, `MASTER_PORT`, `WORLD_SIZE` and `RANK`
  where an argument is missing. `coordinator_address` is `host:port` or an
  init URL (`tcp://host:port`, `file:///path`). `backend` is `nccl` unless
  the caller names another (`gloo` on the CPU); a backend that does not
  come up raises, and no other is tried in its place.
  """
  env = os.environ
  if coordinator_address is None and env.get('MASTER_ADDR'):
    coordinator_address = (
        f'{env["MASTER_ADDR"]}:{env.get("MASTER_PORT", "29500")}')
  if num_processes is None and 'WORLD_SIZE' in env:
    num_processes = int(env['WORLD_SIZE'])
  if process_id is None and 'RANK' in env:
    process_id = int(env['RANK'])
  if num_processes in (None, 1) and not coordinator_address:
    return False
  if not coordinator_address or num_processes is None:
    raise ValueError(
        f'A process group needs an address and a process count: '
        f'{coordinator_address!r}, {num_processes!r}.')
  if process_id is None:
    if num_processes != 1:
      raise ValueError('process_id is missing.')
    process_id = 0
  if not dist.is_available() or not dist.is_backend_available(backend):
    raise RuntimeError(f'The {backend} backend is not available in this '
                       f'build of PyTorch.')
  url = coordinator_address
  if '://' not in url:
    url = f'tcp://{url}'
  dist.init_process_group(backend, init_method=url,
                          world_size=int(num_processes), rank=int(process_id))
  return True


def world_size():
  if dist.is_available() and dist.is_initialized():
    return dist.get_world_size()
  return 1


def rank():
  if dist.is_available() and dist.is_initialized():
    return dist.get_rank()
  return 0


def is_main_process():
  return rank() == 0


def local_device(device):
  """This rank's device: `cuda` without an index means the card
  `LOCAL_RANK` (modulo the cards visible, so that ranks may share one) when
  that variable is set; any other device is itself."""
  device = torch.device(device)
  local = os.environ.get('LOCAL_RANK')
  if (device.type == 'cuda' and device.index is None and local is not None
      and torch.cuda.is_available()):
    return torch.device('cuda', int(local) % torch.cuda.device_count())
  return device


def _tree_map(fn, tree):
  if isinstance(tree, dict):
    return {k: _tree_map(fn, v) for k, v in tree.items()}
  if isinstance(tree, (tuple, list)):
    return type(tree)(_tree_map(fn, v) for v in tree)
  return fn(tree)


def host_local_batch(batch, mesh, axis='data', leading=0):
  """This rank's rows of the global batch, on the rank's device.

  A rank holds only its own rows, so unlike the JAX version this returns
  local tensors, not global arrays. It checks that every array of `batch`
  has the same rows along axis `leading` (1 for the K groups of
  `train_multi`) and that every rank holds as many, so that the global
  batch is these rows times the mesh's size along `axis`."""
  leaves = []
  _tree_map(leaves.append, batch)
  rows = {int(np.shape(x)[leading]) for x in leaves}
  if len(rows) != 1:
    raise ValueError(f'The arrays of the batch differ in their rows along '
                     f'axis {leading}: {sorted(rows)}.')
  rows, = rows
  device = local_device(mesh.device_type)
  if world_size() > 1:
    # [max, -min] over the ranks in one collective.
    counts = torch.tensor([rows, -rows], device=device)
    dist.all_reduce(counts, op=dist.ReduceOp.MAX)
    if int(counts[0]) != -int(counts[1]):
      raise ValueError(f'The ranks hold from {-int(counts[1])} to '
                       f'{int(counts[0])} rows each; a global batch along '
                       f'{axis!r} needs the same count on every rank.')
  return _tree_map(lambda x: torch.as_tensor(np.asarray(x)).to(device)
                   if not isinstance(x, torch.Tensor) else x.to(device),
                   batch)


# -- collectives over the ranks ---------------------------------------------


def all_mean(x):
  """The average of `x` over the ranks (a new tensor)."""
  if world_size() == 1:
    return x
  x = x.detach().clone()
  dist.all_reduce(x)
  return x / world_size()


def all_mean_flat(tensors):
  """The averages over the ranks of a list of float32 tensors, reduced as
  one flat bucket in one collective."""
  if world_size() == 1:
    return list(tensors)
  flat = torch.cat([t.detach().reshape(-1) for t in tensors])
  dist.all_reduce(flat)
  flat /= world_size()
  sizes = [t.numel() for t in tensors]
  return [p.view(t.shape) for p, t in zip(flat.split(sizes), tensors)]


def all_max(x):
  """The largest `x` over the ranks, element by element."""
  if world_size() == 1:
    return x
  x = x.detach().clone()
  dist.all_reduce(x, op=dist.ReduceOp.MAX)
  return x


def all_gather_rows(x):
  """Every rank's `x` concatenated along axis 0 in rank order; each rank
  gives the same number of rows. A sum of zero-padded copies, which gloo
  reduces for tensors on the card as well as on the host, and which adds
  nothing but zeros to each value."""
  world = world_size()
  if world == 1:
    return x
  n = x.shape[0]
  out = x.new_zeros((world * n,) + tuple(x.shape[1:]))
  out[rank() * n:(rank() + 1) * n] = x.detach()
  dist.all_reduce(out)
  return out

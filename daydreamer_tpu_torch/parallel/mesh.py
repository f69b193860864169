"""The rank mesh and its placements: the port of
`daydreamer_tpu/parallel/mesh.py`.

The JAX package runs the update as one program over a `jax.sharding.Mesh`
of devices; the batch axis is sharded over `data`, the state replicated.
Here a mesh is a `torch.distributed` `DeviceMesh` over the ranks of the
process group (each rank one process on one device), and each rank runs
the update on its own rows.

What the JAX names mean here:
- `make_mesh(axes, devices)`: `devices` are ranks of the default group (all
  of them, in the mesh's order), not devices; every rank calls it.
- `replicated` and `batch_sharded` return the placements (`Replicate()`,
  `Shard(leading)` on the `axis` dimension) that a `NamedSharding` with
  `P()` or `P(None, ..., axis)` means. Nothing in the port places a tensor
  by them: a rank holds whole local tensors.
- `shard_batch` keeps this rank's slice of the rows, where the JAX version
  places every slice on its device.
- `replicate` broadcasts rank 0's values to every rank, where the JAX
  version copies one value to every device.
"""

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

from . import distributed


def make_mesh(axes=None, devices=None, device_type='cuda'):
  """A `DeviceMesh` over the ranks. axes: dict of axis name -> size, with at
  most one -1 (the remaining ranks). Default: all ranks on one 'data' axis.
  `device_type` is `cuda` unless the caller names another."""
  if not dist.is_initialized():
    raise RuntimeError('A mesh spans the ranks of a process group; start '
                       'one first (parallel.initialize).')
  world = dist.get_world_size()
  devices = list(range(world)) if devices is None else list(devices)
  if sorted(devices) != list(range(world)):
    raise ValueError(f'devices must list the {world} ranks: {devices}')
  axes = dict(axes or {'data': -1})
  sizes = list(axes.values())
  if sizes.count(-1) > 1:
    raise ValueError(f'At most one axis may take the rest: {axes}')
  if -1 in sizes:
    known = int(np.prod([s for s in sizes if s != -1]))
    if world % known:
      raise ValueError(f'{axes} does not divide {world} ranks.')
    sizes[sizes.index(-1)] = world // known
  if int(np.prod(sizes)) != world:
    raise ValueError(f'{axes} does not cover {world} ranks.')
  return DeviceMesh(device_type,
                    torch.tensor(devices, dtype=torch.int).reshape(sizes),
                    mesh_dim_names=tuple(axes.keys()))


def replicated(mesh):
  return (Replicate(),) * mesh.ndim


def batch_sharded(mesh, axis='data', leading=0):
  """The batch dimension (after `leading` unsharded ones, e.g. the fused
  updates' axis) sharded along the mesh axis `axis`."""
  return tuple(Shard(leading) if name == axis else Replicate()
               for name in mesh.mesh_dim_names)


def shard_batch(tree, mesh, axis='data'):
  """This rank's slice of the leading dim of every array, on its device."""
  count = mesh.size(mesh.mesh_dim_names.index(axis))
  index = mesh.get_local_rank(axis)
  device = distributed.local_device(mesh.device_type)

  def take(x):
    x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    if len(x) % count:
      raise ValueError(f'{len(x)} rows do not split over {count} ranks.')
    rows = len(x) // count
    return x[index * rows:(index + 1) * rows].to(device)

  return distributed._tree_map(take, tree)


def replicate(tree, mesh):
  """Every rank's tensors of `tree` take rank 0's values, in place (arrays
  that are no tensors become tensors on this rank's device first); one
  broadcast per dtype. Returns the tree."""
  device = distributed.local_device(mesh.device_type)
  tree = distributed._tree_map(
      lambda x: x if isinstance(x, torch.Tensor)
      else torch.as_tensor(np.asarray(x)).to(device), tree)
  if distributed.world_size() == 1:
    return tree
  leaves = []
  distributed._tree_map(leaves.append, tree)
  groups = {}
  for leaf in leaves:
    groups.setdefault((leaf.dtype, leaf.device), []).append(leaf)
  with torch.no_grad():
    for group in groups.values():
      flat = torch.cat([x.reshape(-1) for x in group])
      dist.broadcast(flat, src=0)
      for x, part in zip(group, flat.split([x.numel() for x in group])):
        x.copy_(part.view(x.shape))
  return tree

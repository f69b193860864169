"""The port's `parallel/` on a one-rank gloo group (a `file://` store, so
no port is taken): the counterpart of `test_parallelism.py`'s cases, and
the collective helpers, each the identity at world 1. Two ranks run in
`test_torch_multihost.py`."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from daydreamer_tpu_torch.parallel import distributed
from daydreamer_tpu_torch.parallel import mesh as meshlib
import daydreamer_tpu_torch.parallel as parallel_pkg

torch.set_num_threads(1)


@pytest.fixture
def group(tmp_path):
  assert distributed.initialize((tmp_path / 'store').as_uri(), 1, 0, 'gloo')
  yield
  dist.destroy_process_group()


def test_exports_the_jax_names():
  for name in ('make_mesh', 'replicated', 'batch_sharded', 'shard_batch',
               'replicate', 'initialize', 'is_main_process',
               'host_local_batch'):
    assert callable(getattr(parallel_pkg, name)), name


class TestMesh:

  def test_make_mesh_all_devices(self, group):
    mesh = meshlib.make_mesh(device_type='cpu')
    assert mesh.size() == dist.get_world_size() == 1
    assert mesh.mesh_dim_names == ('data',)

  def test_make_mesh_2d(self, group):
    mesh = meshlib.make_mesh({'data': 1, 'model': -1}, device_type='cpu')
    assert mesh.mesh_dim_names == ('data', 'model')
    assert mesh.shape == (1, 1)
    assert meshlib.batch_sharded(mesh, leading=1) == (
        meshlib.Shard(1), meshlib.Replicate())
    assert meshlib.replicated(mesh) == (meshlib.Replicate(),) * 2

  @pytest.mark.parametrize('axes', [
      {'data': 3, 'model': -1}, {'data': 2}, {'data': -1, 'model': -1}])
  def test_make_mesh_rejects_nondivisible(self, group, axes):
    with pytest.raises(ValueError):
      meshlib.make_mesh(axes, device_type='cpu')

  def test_make_mesh_needs_a_group(self):
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError):
      meshlib.make_mesh(device_type='cpu')

  def test_shard_batch_keeps_this_ranks_rows(self, group):
    mesh = meshlib.make_mesh(device_type='cpu')
    batch = {'x': np.arange(12, dtype=np.float32).reshape(4, 3)}
    out = meshlib.shard_batch(batch, mesh)
    # One rank: its slice is every row, as a tensor on its device.
    assert isinstance(out['x'], torch.Tensor)
    np.testing.assert_array_equal(out['x'].numpy(), batch['x'])

  def test_replicate_keeps_rank0_values(self, group):
    mesh = meshlib.make_mesh(device_type='cpu')
    weight = torch.ones(3, 3)
    tree = {'w': weight, 'n': np.arange(4, dtype=np.int32)}
    out = meshlib.replicate(tree, mesh)
    assert out['w'] is weight and torch.equal(weight, torch.ones(3, 3))
    assert torch.equal(out['n'], torch.arange(4, dtype=torch.int32))

  def test_mean_rides_the_group(self, group):
    """The global mean of a sharded batch: each rank's mean of its rows,
    averaged over the ranks."""
    mesh = meshlib.make_mesh(device_type='cpu')
    batch = np.arange(8, dtype=np.float32)
    rows = meshlib.shard_batch({'x': batch}, mesh)['x']
    total = rows.sum().reshape(1)
    dist.all_reduce(total, group=mesh.get_group('data'))
    mean = total / (len(rows) * mesh.size())
    np.testing.assert_allclose(float(mean), batch.mean(), rtol=1e-6)


class TestDistributed:

  def test_initialize_noop_single_process(self, monkeypatch):
    for name in ('MASTER_ADDR', 'MASTER_PORT', 'WORLD_SIZE', 'RANK'):
      monkeypatch.delenv(name, raising=False)
    assert distributed.initialize() is False
    assert distributed.initialize(num_processes=1) is False

  def test_unavailable_backend_raises(self, tmp_path):
    """A requested backend that cannot come up raises, and no other comes
    up in its place."""
    assert not dist.is_initialized()
    missing = [b for b in ('nccl', 'mpi', 'ucc')
               if not dist.is_backend_available(b)]
    with pytest.raises(RuntimeError, match=missing[0]):
      distributed.initialize((tmp_path / 'store').as_uri(), 1, 0, missing[0])
    assert not dist.is_initialized()

  def test_is_main_process(self, group):
    assert distributed.is_main_process()
    assert distributed.rank() == 0 and distributed.world_size() == 1

  def test_host_local_batch_single_process(self, group):
    mesh = meshlib.make_mesh(device_type='cpu')
    local = {'x': np.arange(12, dtype=np.float32).reshape(4, 3)}
    out = distributed.host_local_batch(local, mesh)
    # One rank: the global batch is the local one, as tensors.
    assert out['x'].shape == (4, 3)
    np.testing.assert_array_equal(out['x'].numpy(), local['x'])

  def test_host_local_batch_leading_axis(self, group):
    # The K groups of train_multi: the rows are axis 1.
    mesh = meshlib.make_mesh(device_type='cpu')
    local = {'x': np.arange(24, dtype=np.float32).reshape(2, 4, 3),
             'y': np.zeros((2, 4), bool)}
    out = distributed.host_local_batch(local, mesh, leading=1)
    assert out['x'].shape == (2, 4, 3) and out['y'].dtype == torch.bool
    np.testing.assert_array_equal(out['x'].numpy(), local['x'])
    with pytest.raises(ValueError):
      distributed.host_local_batch(
          {'x': local['x'], 'y': np.zeros((2, 5))}, mesh, leading=1)

  @pytest.mark.parametrize('with_group', [False, True])
  def test_collectives_identity_at_world_1(self, request, with_group):
    if with_group:
      request.getfixturevalue('group')
    assert dist.is_initialized() == with_group
    x = torch.arange(6, dtype=torch.float32).reshape(3, 2) - 2.5
    assert distributed.all_mean(x) is x
    assert distributed.all_max(x) is x
    assert distributed.all_gather_rows(x) is x
    grads = [x, x[0]]
    assert all(a is b for a, b in zip(distributed.all_mean_flat(grads),
                                      grads))

  def test_local_device(self, monkeypatch):
    monkeypatch.setenv('LOCAL_RANK', '3')
    assert distributed.local_device('cpu') == torch.device('cpu')
    assert distributed.local_device('cuda:1') == torch.device('cuda', 1)


def test_reduce_plan_reads_balance_stats():
  """Every ratio that `nn.balance_stats` returns is combined over the ranks
  by its class's share, named in `nn.BALANCE_RATIOS`; its other entries,
  and everything else, by kind."""
  from daydreamer_tpu_torch import nn
  from daydreamer_tpu_torch.agents.dreamer.torchagent import _reduce_plan
  stats = nn.balance_stats(nn.MSEDist(torch.tensor([0.3, 0.0, 0.8]), 0),
                           torch.tensor([1.0, 0.0, 0.0]), 0.5)
  ratios = {k for k, v in stats.items() if k in nn.BALANCE_RATIOS}
  assert ratios == {'pos_loss', 'neg_loss', 'pos_acc', 'neg_acc'}
  names = [f'reward_{k}' for k in stats] + [
      'loss_mean', 'loss_std', 'loss_max', 'loss_min', 'other_pos_loss']
  plan = {k: v.tolist() for k, v in _reduce_plan(names, 'cpu').items()}
  index = {name: i for i, name in enumerate(names)}
  assert sorted(plan['ratio']) == sorted(index[f'reward_{k}'] for k in ratios)
  assert set(plan['ratio_of']) == {index['reward_rate']}
  for i, positive in zip(plan['ratio'], plan['positive']):
    assert positive == nn.BALANCE_RATIOS[names[i][len('reward_'):]]
  # Without its `X_rate` a ratio-like name is a plain mean.
  assert sorted(plan['mean']) == sorted(
      [index[f'reward_{k}'] for k in stats if k not in ratios]
      + [index['loss_mean'], index['other_pos_loss']])
  assert plan['std'] == [index['loss_std']]
  assert plan['std_of'] == [index['loss_mean']]
  assert plan['max'] == [index['loss_max']]
  assert plan['min'] == [index['loss_min']]

"""The port's tooling scripts on the CPU (`scripts/profile_train.py`,
`scripts/policy_latency.py`) and the data-parallel worker's device
default. On the CPU the scripts give host times only: the profile's rows are
CPU operators and its device metrics are null; on the card they are
measured by `chip_smoke.py`'s `tooling` phase."""

import json
import math

import pytest
import torch

from daydreamer_tpu_torch.scripts import multihost_worker
from daydreamer_tpu_torch.scripts import policy_latency
from daydreamer_tpu_torch.scripts import profile_train

torch.set_num_threads(1)


def _json_lines(text):
  return [json.loads(line) for line in text.splitlines()
          if line.startswith('{')]


def test_policy_latency_on_cpu(capsys):
  result = policy_latency.main(
      ['--shape', 'test', '--reps', '2', '--device', 'cpu'])
  lines = _json_lines(capsys.readouterr().out)
  variants = {line['variant']: line for line in lines if 'variant' in line}
  assert set(variants) == {'device', 'device_eager', 'cpu_mirror'}
  assert variants['device']['graphed'] and not variants['device_eager'][
      'graphed']
  for name in ('device', 'device_eager', 'cpu_mirror'):
    assert variants[name]['on'] == 'cpu'
    for key in ('whole_ms', 'dispatch_ms', 'synced_ms', 'fetch_ms'):
      assert math.isfinite(variants[name][key]), key
      assert variants[name][key] == result[name][key], key
  assert lines[-1] == json.loads(json.dumps(result))
  assert result['backend'] == 'cpu' and result['card'] is None


def test_profile_train_on_cpu(capsys, monkeypatch):
  report = profile_train.profile_shape('test', 1, K=2, device='cpu')
  assert report['updates_traced'] == 2 and report['fused_K'] == 2
  assert report['device'] == 'cpu' and report['timeline'].startswith('cpu')
  assert report['device_busy_ms_per_update'] is None
  assert report['idle_share'] is None
  names = [row['name'] for row in report['top']]
  assert 'aten::mm' in names and len(names) == 30
  categories = {row['category'] for row in report['categories']}
  assert {'gemm', 'elementwise', 'cast_copy'} <= categories
  assert report['wrapper_launches']['observe_fwd'] == 0  # rssm.impl: scan.
  # The CLI prints the report's table and the report as its last line.
  monkeypatch.setattr(profile_train, 'profile_shape',
                      lambda *args, **kwargs: report)
  profile_train.main(['--shape', 'test', '--device', 'cpu'])
  last = capsys.readouterr().out.strip().splitlines()[-1]
  assert json.loads(last) == json.loads(json.dumps(report))


def test_profile_train_sets():
  """`--set KEY=VALUE` reads each value as a Python literal where it is
  one, else as a string, and refuses a pair without `=`."""
  assert profile_train.parse_sets([
      'rssm.deter=4096', 'rssm.norm=none', 'torch.graphs=False',
      'x.lr=1e-4']) == {'rssm.deter': 4096, 'rssm.norm': 'none',
                        'torch.graphs': False, 'x.lr': 1e-4}
  with pytest.raises(ValueError, match='KEY=VALUE'):
    profile_train.parse_sets(['rssm.deter'])


@pytest.mark.parametrize('name,category', [
    ('void (anonymous namespace)::prior_kernel<__nv_bfloat16>('
     '(anonymous namespace)::Params)', 'observe_fwd'),
    ('void (anonymous namespace)::embed_kernel<__nv_bfloat16>('
     '(anonymous namespace)::Params)', 'observe_fwd|observe'),
    ('void (anonymous namespace)::observe_bwd_kernel<float>('
     '(anonymous namespace)::Params)', 'observe_bwd'),
    ('void (anonymous namespace)::imagine_actor_kernel<__nv_bfloat16>('
     '(anonymous namespace)::Params, int)', 'imagine_actor'),
    ('void (anonymous namespace)::imagine_kernel<float>('
     '(anonymous namespace)::Params, int)', 'imagine'),
    ('gve_kernel', 'gve'),
    ('Memcpy HtoD (Pageable -> Device)', 'host_to_device'),
    ('void at::native::vectorized_elementwise_kernel<4, '
     'at::native::bfloat16_copy_kernel_cuda(at::TensorIteratorBase&)',
     'cast_copy'),
    ('nvjet_tst_128x64_64x4_1x2_h_bz_TNT', 'gemm'),
    ('sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc',
     'convolution'),
    ('void at::native::(anonymous namespace)::vectorized_layer_norm_kernel'
     '<c10::BFloat16, float, true>(int, float, ...)', 'layernorm'),
    ('void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, '
     'at::native::func_wrapper_t<float, at::native::sum_functor>>>',
     'reduction'),
    ('void at::native::vectorized_elementwise_kernel<4, '
     'at::native::tanh_kernel_cuda>', 'elementwise'),
    ('void at::native::(anonymous namespace)::distribution_elementwise_'
     'grid_stride_kernel', 'elementwise'),
    ('void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel', 'other'),
    # The counterparts of XLA's fusions, each under its wrapper's name.
    ('void (anonymous namespace)::ln_fwd_kernel<__nv_bfloat16, 8, 1>('
     '__nv_bfloat16 const*, float const*, float const*, __nv_bfloat16*, '
     'float*, float*, (anonymous namespace)::Shape, float)',
     'layer_norm_act_fwd'),
    ('void (anonymous namespace)::ln_bwd_kernel<float, 4, 1>(float const*)',
     'layer_norm_act_bwd'),
    ('void (anonymous namespace)::ln_bwd_kernel<__nv_bfloat16, 8, 2>('
     '__nv_bfloat16 const*, float const*, float const*, float const*, '
     'float const*, __nv_bfloat16 const*, __nv_bfloat16*, float*, float*, '
     'float*, unsigned int*, (anonymous namespace)::Shape, int)',
     'layer_norm_act_bwd'),
    ('(anonymous namespace)::sumsq_kernel((anonymous namespace)::Tensors, '
     'float*)', 'adam_sumsq'),
    ('(anonymous namespace)::sumsq_total_kernel(float const*, int, float*)',
     'adam_sumsq'),
    ('(anonymous namespace)::adam_update_kernel((anonymous namespace)::'
     'Tensors, (anonymous namespace)::Scalars)', 'adam_update'),
    # The RSSM step's: the GRU cell's backward and its sum over blocks
    # under one name.
    ('void (anonymous namespace)::gru_fwd_kernel<__nv_bfloat16, 8, 1>('
     '__nv_bfloat16 const*, __nv_bfloat16 const*, float const*, float '
     'const*, __nv_bfloat16*, float*, float*, (anonymous namespace)::Shape, '
     'float)', 'gru_cell_fwd'),
    ('void (anonymous namespace)::gru_bwd_kernel<float, 4, 2>(float const*)',
     'gru_cell_bwd'),
    ('(anonymous namespace)::gru_sum_kernel(float const*, int, int, float*, '
     'float*)', 'gru_cell_bwd'),
    ('void (anonymous namespace)::onehot_fwd_kernel<__nv_bfloat16>('
     '__nv_bfloat16 const*, float const*, __nv_bfloat16*, __nv_bfloat16*, '
     '(anonymous namespace)::Head)', 'onehot_head_fwd'),
    ('void (anonymous namespace)::onehot_bwd_kernel<float>(float const*, '
     'float const*, float const*, float const*, float*, (anonymous '
     'namespace)::Head)', 'onehot_head_bwd'),
    # Their paths past the first layouts, each under its wrapper's name.
    ('void (anonymous namespace)::gru_bare_fwd_kernel<float, 2>(float '
     'const*, float const*, float*, int, int)', 'gru_cell_fwd'),
    ('void (anonymous namespace)::gru_bare_bwd_kernel<__nv_bfloat16, 8>('
     '__nv_bfloat16 const*)', 'gru_cell_bwd'),
    ('void (anonymous namespace)::gru_wide_fwd_kernel<__nv_bfloat16, 8>('
     '__nv_bfloat16 const*)', 'gru_cell_fwd'),
    ('void (anonymous namespace)::gru_wide_bwd_kernel<float, 1>(float '
     'const*)', 'gru_cell_bwd'),
    ('void (anonymous namespace)::onehot_any_fwd_kernel<float>(float '
     'const*, float const*, float*, float*, (anonymous namespace)::Head, '
     'int)', 'onehot_head_fwd'),
    ('void (anonymous namespace)::onehot_any_bwd_kernel<__nv_bfloat16>('
     '__nv_bfloat16 const*)', 'onehot_head_bwd'),
    ('void (anonymous namespace)::ln_stream_fwd_kernel<__nv_bfloat16, 4>('
     '__nv_bfloat16 const*)', 'layer_norm_act_fwd'),
    ('void (anonymous namespace)::ln_stream_bwd_kernel<float, 4>(float '
     'const*)', 'layer_norm_act_bwd'),
    ('void (anonymous namespace)::gru_cluster_bwd_kernel<__nv_bfloat16, 1, '
     '1>(__nv_bfloat16 const*)', 'gru_cell_bwd'),
    ('void (anonymous namespace)::ln_cluster_bwd_kernel<float, 2, 2>(float '
     'const*)', 'layer_norm_act_bwd'),
    # The staged forward of those rows and the head's group backward.
    ('void (anonymous namespace)::ln_staged_fwd_kernel<__nv_bfloat16, 4>('
     '__nv_bfloat16 const*)', 'layer_norm_act_fwd'),
    ('void (anonymous namespace)::onehot_group_bwd_kernel<float, 8>(float '
     'const*)', 'onehot_head_bwd'),
    # The block forward of the GRU cell past D = 2 048 and the head's group
    # forward.
    ('void (anonymous namespace)::gru_block_fwd_kernel<__nv_bfloat16, 8, '
     '1>(__nv_bfloat16 const*)', 'gru_cell_fwd'),
    ('void (anonymous namespace)::gru_block_fwd_kernel<float, 1, 4>(float '
     'const*)', 'gru_cell_fwd'),
    ('void (anonymous namespace)::onehot_group_fwd_kernel<__nv_bfloat16, '
     '8>(__nv_bfloat16 const*, float const*)', 'onehot_head_fwd'),
    ('void (anonymous namespace)::onehot_group_fwd_kernel<float, 1>(float '
     'const*)', 'onehot_head_fwd'),
])
def test_categorize(name, category):
  assert profile_train.categorize(name) == category


def test_multihost_worker_needs_card(monkeypatch):
  """Without `--device`, the worker asks for the card and raises when
  there is none, naming `--device cpu`; it joins no group."""
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  with pytest.raises(RuntimeError, match='--device cpu'):
    multihost_worker.main(['file:///nonexistent/store', '2', '0', '--tiny'])
  assert not torch.distributed.is_initialized()

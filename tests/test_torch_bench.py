"""The port's measuring scripts on the CPU (`scripts/bench.py`,
`fused_impl_bench.py`, `imag_impl_bench.py`, `multihost_bench.py`), held
to the root `bench.py` where the two can meet: the agent's config and
batch, and the work of one update.

The work: the port counts the matmul and convolution FLOPs of one update
with `FlopCounterMode` (`bench.train_flops`); the JAX side is counted here
from the jaxpr of its plain train program, the products of the forward and
of the backward (the transposes of `dot_general`), each `scan` body times
its length; tolerance 5 %. On the CPU the scripts give host times only,
and no device metric: `mfu` is null."""

import importlib.util
import json
import math
import pathlib

import jax
import jax.extend
import numpy as np
import pytest
import torch

from daydreamer_tpu_torch.scripts import bench
from daydreamer_tpu_torch.scripts import fused_impl_bench
from daydreamer_tpu_torch.scripts import imag_impl_bench
from daydreamer_tpu_torch.scripts import multihost_bench

torch.set_num_threads(1)


def _root_bench():
  """The JAX package's bench, the root `bench.py`, by its path."""
  path = pathlib.Path(__file__).resolve().parent.parent / 'bench.py'
  spec = importlib.util.spec_from_file_location('jax_bench', path)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


jbench = _root_bench()

# The port's test shape, with two updates a dispatch instead of 256.
TASK, OVERRIDES, _ = bench.SHAPES['test']
K = 2
# The JAX bench's settings that mean nothing in the eager port.
UNROLL = ('rssm.unroll', 'imag_unroll')


@pytest.fixture(autouse=True)
def _jax_compute_dtype():
  """Creating a JAX agent sets its package's compute dtype for the whole
  process (`nn.set_compute_dtype`, bfloat16 at the bench's config): put it
  back, so that a later test in this process computes as it expects."""
  from daydreamer_tpu.nn import module
  dtype = module.COMPUTE_DTYPE
  yield
  module.set_compute_dtype(dtype)


def _json_lines(text):
  return [json.loads(line) for line in text.splitlines()
          if line.startswith('{')]


@pytest.mark.parametrize('shape', ['test', 'a1'])
def test_build_agent_matches_jax(shape):
  """The same config key by key (but the backend blocks and the unroll
  keys), and the same batch."""
  task, overrides, _ = bench.SHAPES[shape]
  jagent, jdata = jbench.build_agent(task, overrides)
  agent, data = bench.build_agent(task, overrides, 'cpu')
  jflat, flat = jagent.config.flat, agent.config.flat
  assert (jflat['rssm.unroll'], jflat['imag_unroll']) == (2, 3)

  def common(table, block):
    return {k: v for k, v in table.items()
            if not k.startswith(block) and k not in UNROLL}

  assert common(flat, 'torch.') == common(jflat, 'jax.')
  assert flat['torch.fused_metrics'] == jflat['jax.fused_metrics'] == 'last'
  assert flat['torch.device'] == 'cpu'
  assert sorted(data) == sorted(jdata)
  for key in data:
    np.testing.assert_array_equal(data[key], jdata[key], key)


def test_sweep_shapes_match_jax():
  assert bench.SWEEP_SHAPES == jbench.SWEEP_SHAPES


def _subjaxprs(params):
  for value in params.values():
    for item in value if isinstance(value, (list, tuple)) else [value]:
      if isinstance(item, jax.extend.core.ClosedJaxpr):
        yield item.jaxpr
      elif isinstance(item, jax.extend.core.Jaxpr):
        yield item


def _conv_flops(eqn):
  """2 x the products of a convolution that meet no padding and no hole of
  a dilation: each input pixel with each kernel tap that lands in the
  output, as PyTorch's counter counts a (transposed) convolution."""
  lhs, rhs = eqn.invars[0].aval.shape, eqn.invars[1].aval.shape
  out = eqn.outvars[0].aval.shape
  spec, params = eqn.params['dimension_numbers'], eqn.params
  pairs = 1
  for d in range(len(lhs) - 2):
    n_lhs = lhs[spec.lhs_spec[2 + d]]
    at = (np.arange(out[spec.out_spec[2 + d]])[:, None]
          * params['window_strides'][d]
          + np.arange(rhs[spec.rhs_spec[2 + d]])[None, :]
          * params['rhs_dilation'][d] - params['padding'][d][0])
    dilation = params['lhs_dilation'][d]
    pairs *= int(((at >= 0) & (at <= (n_lhs - 1) * dilation)
                  & (at % dilation == 0)).sum())
  return (2 * lhs[spec.lhs_spec[0]] * out[spec.out_spec[1]]
          * rhs[spec.rhs_spec[1]] * pairs)


def jaxpr_flops(jaxpr):
  """The `dot_general` and convolution FLOPs of one run of `jaxpr`, into
  every sub-jaxpr (`jit`, `custom_vjp`/`custom_jvp`, the larger branch of a
  `cond`), each `scan` body times its length."""
  total = 0
  for eqn in jaxpr.eqns:
    name = eqn.primitive.name
    if name == 'dot_general':
      (contract, _), _ = eqn.params['dimension_numbers']
      lhs = eqn.invars[0].aval.shape
      total += 2 * math.prod(eqn.outvars[0].aval.shape) * math.prod(
          lhs[i] for i in contract)
    elif name == 'conv_general_dilated':
      total += _conv_flops(eqn)
    else:
      inner = [jaxpr_flops(sub) for sub in _subjaxprs(eqn.params)]
      if name == 'cond':
        total += max(inner)
      elif name == 'scan':
        total += eqn.params['length'] * sum(inner)
      else:
        # A `while` runs its body an unknown number of times.
        assert name != 'while' or not any(inner), eqn
        total += sum(inner)
  return total


def test_train_flops_matches_jax():
  """One update's products at the test shape: the port's counter against
  the JAX package's plain train program (its creation pass traced
  abstractly: the agent's state as shapes only)."""
  jagent, jdata = jbench.build_agent(TASK, OVERRIDES)
  data = jagent._filter_data(dict(jdata))
  batch = jagent.config.batch_size

  def create(varibs):
    carry, varibs = jagent._pure_train_initial(varibs, 0, batch, create=True)
    _, varibs = jagent._pure_train(varibs, 0, data, carry, create=True)
    return varibs, carry

  varibs, carry = jax.eval_shape(create, jagent.varibs)
  closed = jax.make_jaxpr(jagent._pure_train_packed)(
      varibs, np.uint32(0), data, carry)
  want = jaxpr_flops(closed.jaxpr)
  got = bench.train_flops(TASK, OVERRIDES, 'cpu')
  print(f'FLOPs of one update at the test shape: port {got}, JAX {want}, '
        f'ratio {got / want:.5f}')
  assert got > 1e10
  assert abs(got / want - 1) < 0.05, (got, want)


def test_measure_updates_on_cpu():
  agent, data = bench.build_agent(TASK, OVERRIDES, 'cpu')
  result, _ = bench.measure_updates(agent, data, K, 1e9, windows=2, calls=1,
                                    flops=1e9, nbytes=10**9)
  assert len(result['rate_windows']) == 2 and result['updates_timed'] == 4
  for rate in [result['updates_per_s'], *result['rate_windows']]:
    assert math.isfinite(rate) and rate > 0
  assert result['first_dispatch_s'] > 0
  assert math.isfinite(result['model_loss'])
  # The CPU has no peak: a CPU run writes no device metric.
  assert result['device'] == 'cpu' and result['mfu'] is None
  assert result['bytes_per_update'] == 10**9 and result['hbm_bw_util'] is None
  assert set(result['launches']) == {k.name for k in bench.kernels()}
  assert not any(result['launches'].values())  # The loop path.


def test_measure_policy_on_cpu():
  agent, data = bench.build_agent(TASK, OVERRIDES, 'cpu')
  policy = bench.measure_policy(agent, data, budget_s=0.0, max_windows=1)
  assert policy['mirror_on'] == 'cpu' and agent._mirror is not None
  assert agent._policy_devices == 'all'  # Restored.
  for name in ('null_rtt', 'device', 'cpu_mirror'):
    assert policy[name]['median_s'] > 0 and len(policy[name]['windows']) == 1
  gates = bench.gates(policy)
  assert set(gates) == {'policy_mirror_le_50ms',
                        'policy_device_minus_null_rtt_le_10ms'}
  assert all(isinstance(v, bool) for v in gates.values())


def test_compare_graphs_on_cpu():
  """The eager and the graphed arm at the test shape. On the CPU both run
  the same functions, the graphed one through the runner's bookkeeping, so
  both arms train alike; nothing is captured."""
  rows = bench.compare_graphs('test', 'cpu', 0.0, K=K,
                              policy_budget_s=1e-9)
  for arm in ('eager', 'graphed'):
    row = rows[arm]
    assert row['updates_per_s'] > 0 and row['mfu'] is None
    assert row['updates_timed'] == K and math.isfinite(row['model_loss'])
    assert not any(row['launches'].values())
    assert row['capture_s'] is None and row['pool_bytes'] is None
    assert row['policy']['median_s'] > 0
  assert rows['eager']['model_loss'] == rows['graphed']['model_loss']
  assert rows['speedup'] == (rows['graphed']['updates_per_s']
                             / rows['eager']['updates_per_s'])
  assert rows['policy_speedup'] > 0 and rows['flops_per_update'] > 1e10
  assert isinstance(rows['bytes_per_update'], int)
  assert rows['bytes_per_update'] > 0
  assert all(rows[arm]['hbm_bw_util'] is None for arm in ('eager', 'graphed'))
  # The counted twin runs eagerly: on the card a graph's first call runs
  # the update and then captures it, and the counter would see both.
  assert bench.LOOP_PATH['torch.graphs'] is False


@pytest.mark.parametrize('script,kernels', [
    (fused_impl_bench, ('observe_fwd', 'observe_bwd')),
    (imag_impl_bench, ('imagine_actor',))])
def test_impl_bench_on_cpu(script, kernels):
  """Both arms at the test widths. On the CPU the kernels' plain versions
  run, so nothing launches in either arm."""
  rows = script.run_shape('test', TASK, OVERRIDES, K, 0.0, 'cpu')
  assert script.KERNELS == kernels
  for arm in ('scan', 'pallas'):
    assert rows[arm]['updates_per_s'] > 0 and rows[arm]['mfu'] is None
    assert rows[arm]['launches'] == dict.fromkeys(kernels, 0)
  assert rows['speedup'] == (rows['pallas']['updates_per_s']
                             / rows['scan']['updates_per_s'])
  assert rows['flops_per_update'] > 1e10 and rows['bytes_per_update'] > 0


def test_multihost_bench_actors(capsys):
  results = multihost_bench.main(
      ['--phase', 'actors', '--hosts', '2', '--seconds', '1'])
  assert _json_lines(capsys.readouterr().out) == json.loads(
      json.dumps(results))
  (result,) = results
  assert result['metric'] == 'env_steps_per_s_scaling_efficiency'
  assert result['detail']['rate_1host'] > 0 and result['value'] > 0


def test_multihost_bench_learner_gloo():
  """The worker as 1 rank and as 2 gloo ranks, 4 rows a rank."""
  (result,) = multihost_bench.main(
      ['--phase', 'learner', '--hosts', '2', '--device', 'cpu', '--tiny'])
  detail = result['detail']
  assert result['metric'] == 'learner_updates_per_s_multiprocess_efficiency'
  assert detail['device'] == {'name': 'cpu', 'backend': 'gloo'}
  assert detail['updates_1rank'] > 0 and detail['updates_2ranks'] > 0
  assert math.isclose(result['value'] * detail['updates_1rank'],
                      detail['updates_2ranks'])


@pytest.mark.parametrize('main,argv', [
    (bench.main, []), (bench.main, ['--sweep', 'unwritten.json']),
    (fused_impl_bench.main, []), (imag_impl_bench.main, []),
    (multihost_bench.main, ['--phase', 'learner'])])
def test_scripts_need_card(monkeypatch, tmp_path, main, argv):
  """Without `--device cpu` each script asks for the card and raises when
  there is none; it does not fall back to the CPU."""
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  monkeypatch.chdir(tmp_path)
  with pytest.raises(RuntimeError, match='--device cpu'):
    main(argv)
  assert not list(tmp_path.iterdir())

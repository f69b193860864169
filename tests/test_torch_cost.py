"""The port's count of the work and the bytes of an update (`nn/cost.py`,
`TorchAgent.train_device_cost`, `bench.train_cost`) on the CPU.

- Exact counts on small programs, each FLOP count equal to
  `FlopCounterMode`'s, and each kernel wrapper counted by its formula alone.
- The kernels' formulas (`ops/`) give the bounds of PERF.md's kernel table
  at the xarm and a1 shapes, to the digits printed there.
- At the bench's test shape: the loop-path twin's FLOPs equal
  `bench.train_flops` exactly, its bytes cover the optimizer's compulsory
  traffic, the fused kernels' path counts the same twice and no more than
  the loop path, and `train_device_cost` leaves the agent and the ring as
  it found them.
- The JAX package's plain train program, counted from its jaxpr (operands
  plus results of each equation, each `scan` body times its length),
  against the port's count with the plain versions of the fused LayerNorm
  and optimizer kernels (`build.plain_versions()`, op by op as the JAX
  equations are counted): the ratio must lie in [0.7, 0.85]; the kernels'
  count is below it.
"""

import importlib.util
import math
import pathlib

import jax
import jax.extend
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from daydreamer_tpu_torch.nn import cost
from daydreamer_tpu_torch.ops import build
from daydreamer_tpu_torch.ops import gru
from daydreamer_tpu_torch.ops import lambda_returns as lr
from daydreamer_tpu_torch.ops import onehot
from daydreamer_tpu_torch.ops import rssm
from daydreamer_tpu_torch.ops import rssm_vjp
from daydreamer_tpu_torch.scripts import bench
from daydreamer_tpu_torch.scripts import profile_train

torch.set_num_threads(1)

TASK, OVERRIDES, _ = bench.SHAPES['test']
F32, BF16 = torch.float32, torch.bfloat16


@pytest.fixture(autouse=True)
def _jax_compute_dtype():
  """Creating a JAX agent sets its package's compute dtype for the whole
  process (`nn.set_compute_dtype`, bfloat16 at the bench's config): put it
  back, so that a later test in this process computes as it expects."""
  from daydreamer_tpu.nn import module
  dtype = module.COMPUTE_DTYPE
  yield
  module.set_compute_dtype(dtype)


def _counted(fn):
  """(CostMode after fn, FlopCounterMode's total for a second call)."""
  with cost.CostMode() as counter:
    fn()
  with FlopCounterMode(display=False) as flops:
    fn()
  return counter, flops.get_total_flops()


def _linear():
  torch.manual_seed(0)
  layer = torch.nn.Linear(16, 8)
  x = torch.randn(4, 16, requires_grad=True)
  return lambda: layer(x).sum().backward()


def _tensors(*shapes, dtype=F32):
  gen = torch.Generator().manual_seed(0)
  return [torch.randn(s, generator=gen).to(dtype) for s in shapes]


def _case(name):
  """(program, bytes, FLOPs) of one hand-built case; 4 bytes a float32."""
  y, z, b = _tensors((4, 16), (4, 16), (16,))
  if name == 'linear':
    # Forward addmm: bias 32, x 256, weight 512 read, 128 written. sum: 128
    # read, 4 written; ones_like: 4 written. Backward: mm(grad, W) reads
    # the grad (an expanded scalar, 4) and W (512), writes 256; mm(grad^T,
    # x) reads 4 + 256, writes 512; the bias's sum reads 4, writes 32.
    return _linear(), 928 + 132 + 4 + 772 + 772 + 36, 2 * (4 * 16 * 8) * 3
  if name == 'layer_norm':
    # Reads 256, writes the output 256, the mean and the rstd 16 each.
    return lambda: torch.nn.functional.layer_norm(y, (16,)), 544, 0
  if name == 'view_chain':
    return lambda: y.reshape(2, 32).t().unsqueeze(0).expand(3, 32, 2)[
        ..., :1].squeeze(-1).as_strided((4,), (1,)), 0, 0
  if name == 'add_':
    return lambda: z.add_(y), 3 * 256, 0
  if name == 'bfloat16_cast':
    return lambda: y.to(BF16), 256 + 128, 0
  if name == 'foreach_mul_':
    xs = _tensors(3, 5, 7)
    return lambda: torch._foreach_mul_(xs, 2.0), 2 * 4 * (3 + 5 + 7), 0
  if name == 'out':
    out = torch.empty(4, 16)
    return lambda: torch.add(y, z, out=out), 3 * 256, 0
  if name == 'broadcast':
    # The bias is read once (64), not once a row.
    return lambda: y + b, 256 + 64 + 256, 0
  if name == 'gather':
    # Reads the 4 rows it returns (16) and the indices (32), writes 16.
    p, rows = torch.zeros(100), torch.tensor([1, 2, 3, 3])
    return lambda: p[rows], 16 + 32 + 16, 0
  if name == 'index_put_':
    # Reads the values (16) and the indices (32), writes 4 elements (16).
    p, rows, v = torch.zeros(100), torch.tensor([1, 2, 3, 3]), b[:4].clone()
    return lambda: p.__setitem__(rows, v), 16 + 32 + 16, 0
  raise KeyError(name)


@pytest.mark.parametrize('name', [
    'linear', 'layer_norm', 'view_chain', 'add_', 'bfloat16_cast',
    'foreach_mul_', 'out', 'broadcast', 'gather', 'index_put_'])
def test_counts_small_programs(name):
  fn, nbytes, flops = _case(name)
  counter, reference = _counted(fn)
  assert counter.nbytes == nbytes, dict(counter.table)
  assert counter.flops == flops == reference
  assert sum(row[2] for row in counter.table.values()) == nbytes


def test_copy_from_host_is_one_write_on_the_device():
  """With `device`, the bytes on other devices do not count: a copy from
  the CPU to the `meta` device writes 256 bytes there and reads none."""
  (y,) = _tensors((4, 16))
  with cost.CostMode('meta') as counter:
    y.to('meta')
  assert counter.nbytes == 256
  with cost.CostMode('cpu') as counter:
    y.to('meta')
  assert counter.nbytes == 256  # The read, on the CPU.


def _observe_inputs(dtype=F32, T=5, B=3, D=24, U=16, S=4, C=4, A=3, E=7):
  params = rssm.make_params(0, D, U, S, C, A, E, prior_layers=2, dtype=dtype)
  rng = np.random.default_rng(1)
  t = lambda x, d=dtype: torch.as_tensor(np.asarray(x, np.float32)).to(d)
  stoch0 = t(np.eye(C)[rng.integers(0, C, (B, S))].reshape(B, S * C))
  deter0 = t(np.tanh(rng.standard_normal((B, D))))
  actions = t(np.eye(A)[rng.integers(0, A, (T, B))])
  embeds = t(rng.standard_normal((T, B, E)))
  is_first = torch.as_tensor(rng.uniform(size=(T, B)) < 0.2)
  noise = t(rng.gumbel(size=(T, B, S * C)), F32)
  return params, (stoch0, deter0, actions, embeds), is_first, noise


def _wrapper_case(name, dtype):
  """(call, kernel name, (flops, bytes) by its formula) of one wrapper."""
  params, data, is_first, noise = _observe_inputs(dtype)
  stoch0, deter0, actions, embeds = data
  T, B, A = actions.shape
  D, U, S, C = 24, 16, 4, 4
  if name == 'observe_fwd':
    return (lambda: rssm_vjp.observe_fused(params, *data, is_first,
                                           noise=noise),
            rssm_vjp.observe_fwd_work(T, B, A, 7, D, U, S, C, 2, dtype))
  if name == 'observe':
    return (lambda: rssm.observe(params, *data, is_first, noise=noise),
            rssm.rollout_work(T, B, A, D, U, S, C, 2, dtype, E=7))
  if name == 'imagine':
    return (lambda: rssm.imagine(params, stoch0, deter0, actions,
                                 noise=noise),
            rssm.rollout_work(T, B, A, D, U, S, C, 2, dtype))
  if name == 'imagine_actor':
    actor = rssm.make_actor_params(2, D, U, S, C, A, layers=3, dtype=dtype)
    g_s, g_a = torch.zeros(T, B, S * C), torch.zeros(T, B, A)
    action0 = actions[0].clone()
    return (lambda: rssm.imagine_actor(params, actor, stoch0, deter0,
                                       action0, T, noise=(g_s, g_a)),
            rssm.imagine_actor_work(B, T, D, U, S, C, A, 2, 3, dtype))
  # No product in the last two: each formula counts its bytes alone.
  if name == 'gru_cell_fwd':
    x, scale, bias = _tensors((B, 3 * D), (3 * D,), (3 * D,))
    x = x.to(dtype)
    return (lambda: gru.gru_cell(x, deter0, scale, bias),
            (0, gru.gru_cell_work(B, D, dtype)[1]))
  if name == 'onehot_head_fwd':
    raw = _tensors((B, S, C))[0].to(dtype)
    u = noise[0].reshape(B, S, C).sigmoid()
    return (lambda: onehot.onehot_head(raw, u, 0.01),
            (0, onehot.onehot_head_work(B, S, C, dtype, 0.01, True)[1]))
  interm, disc, boot = _tensors((T, B), (T, B), (B,))
  return (lambda: lr.gve(interm, disc, boot, 0.95),
          lr.gve_work(T, B))


@pytest.mark.parametrize('name,dtype', [
    (name, dtype) for name in ('observe_fwd', 'observe', 'imagine',
                               'imagine_actor', 'gru_cell_fwd',
                               'onehot_head_fwd')
    for dtype in (F32, BF16)] + [('gve', F32)],  # gve: float32 only.
    ids=lambda x: str(x).split('.')[-1])
def test_wrapper_counts_its_formula_alone(name, dtype):
  """On the CPU the plain version runs inside the wrapper; the counter sees
  one launch of the kernel by its formula and none of the plain ops."""
  call, (flops, nbytes) = _wrapper_case(name, dtype)
  with torch.no_grad(), cost.CostMode() as counter:
    call()
  assert dict(counter.table) == {name: [1, int(flops), int(nbytes)]}
  assert (counter.flops, counter.nbytes) == (int(flops), int(nbytes))


def test_observe_bwd_counts_its_formula():
  """Under autograd the backward kernel counts its formula once; the
  epilogue's products are counted op by op, and nothing of the plain
  adjoint chain."""
  params, data, is_first, noise = _observe_inputs()
  leaves = [x.requires_grad_(True) for x in data[1:2]]
  outs = rssm_vjp.observe_fused(params, data[0], leaves[0], *data[2:],
                                is_first, noise=noise)
  loss = sum(o.float().sum() for o in outs)
  with cost.CostMode() as counter:
    loss.backward()
  T, B, A = data[2].shape
  flops, nbytes = rssm_vjp.observe_bwd_work(T, B, A, 24, 16, 4, 4, 2, F32)
  assert counter.table['observe_bwd'] == [1, int(flops), int(nbytes)]
  assert 'observe_fwd' not in counter.table
  # The plain chain runs T steps of `_cell_fwd`, each with its own LayerNorm
  # reductions: none of them may appear, only the epilogue's five LayerNorms
  # (in, GRU, the two prior layers, obs), recomputed once over all rows.
  assert counter.table['aten::mean'][0] == 2 * 5


def test_rssm_step_backwards_count_their_formulas():
  """Under autograd the GRU cell's and the stats head's backward kernels
  count their formulas once each, and nothing of the plain chains' autograd
  (sigmoid's, tanh's and the norm's backward, softmax's)."""
  rng = np.random.default_rng(2)
  t = lambda *shape: torch.as_tensor(
      rng.standard_normal(shape).astype(np.float32)).requires_grad_()
  B, D, S, C = 3, 24, 4, 4
  x, deter, scale, bias, raw = t(B, 3 * D), t(B, D), t(3 * D), t(3 * D), t(
      B, S, C)
  u = torch.as_tensor(rng.uniform(size=(B, S, C)).astype(np.float32))
  logit, stoch = onehot.onehot_head(raw, u, 0.01)
  loss = (gru.gru_cell(x, deter, scale, bias).sum() + logit.sum()
          + (stoch * torch.arange(C)).sum())
  with cost.CostMode() as counter:
    loss.backward()
  table = dict(counter.table)
  assert table['gru_cell_bwd'] == [1, 0, gru.gru_cell_work(
      B, D, F32, backward=True)[1]]
  assert table['onehot_head_bwd'] == [1, 0, onehot.onehot_head_work(
      B, S, C, F32, 0.01, True, backward=True)[1]]
  assert not {'aten::sigmoid_backward', 'aten::tanh_backward',
              'aten::native_layer_norm_backward',
              'aten::_softmax_backward_data'} & set(table)


# The work of the RSSM step's kernels at the sites of PERF.md's table
# (ops/gru.py, ops/onehot.py): each input read once and each output
# written once. GRU cell, rows x D: the product's 3 D values and deter in,
# the new deter out in the compute dtype, scale and bias in float32 and
# each row's mean and rstd out; backward x, deter and the new deter's
# gradient in, dx and ddeter out, mean and rstd in, scale and bias in and
# dscale and dbias out. Stats head, rows x S x C: raw in, u in float32
# with the sample, logit and stoch out; backward the logit's gradient in,
# with the sample logit and stoch's gradient in, with the mixture raw in,
# raw's gradient out.
@pytest.mark.parametrize('rows,D,dtype,fwd,bwd', [
    (1024, 512, BF16, (25165824, 5263360), (46137344, 9469952)),
    (32, 256, BF16, (393216, 88320), (720896, 160000)),
    (1, 256, F32, (12288, 11272), (22528, 21512)),
])
def test_gru_cell_work_is_its_formula(rows, D, dtype, fwd, bwd):
  item = dtype.itemsize
  assert gru.gru_cell_work(rows, D, dtype) == fwd == (
      rows * (8 * 3 * D + 24 * D),
      rows * (item * (3 * D + D + D) + 4 * 2) + 4 * 2 * 3 * D)
  assert gru.gru_cell_work(rows, D, dtype, backward=True) == bwd == (
      rows * (16 * 3 * D + 40 * D),
      rows * (item * (3 * D + D + D + 3 * D + D) + 4 * 2)
      + 2 * 4 * 2 * 3 * D)


@pytest.mark.parametrize('rows,unimix,sample,dtype,fwd,bwd', [
    (1024, 0.01, True, BF16, (29360128, 10485760), (25165824, 10485760)),
    (32, 0.01, False, BF16, (655360, 196608), (524288, 196608)),
    (1, 0.0, True, F32, (20480, 16384), (16384, 16384)),
])
def test_onehot_head_work_is_its_formula(rows, unimix, sample, dtype, fwd,
                                        bwd):
  S = C = 32
  n, item = rows * S * C, dtype.itemsize
  mix, drawn = bool(unimix), bool(sample)
  assert onehot.onehot_head_work(rows, S, C, dtype, unimix, sample) == (
      fwd) == ((12 + 8 * mix + 8 * drawn) * n,
               item * (1 + 2) * n + 4 * drawn * n)
  assert onehot.onehot_head_work(
      rows, S, C, dtype, unimix, sample, backward=True) == bwd == (
          8 * (1 + drawn + mix) * n,
          item * (1 + 2 * drawn + mix + 1) * n)


# PERF.md's kernel table (bf16 at the xarm shapes, float32 where named, a1's
# training shape and one rank's rows of the parallel phase): the bound in ms
# and what bounds it, as printed there.
BOUNDS = [
    ('observe_fwd', BF16, (32, 32, 6, 2560, 512, 512, 32, 32, 3), '0.0104',
     'operations'),
    ('observe_bwd', BF16, (32, 32, 6, 512, 512, 32, 32, 3), '0.0208',
     'bytes'),
    ('observe_fwd', BF16, (32, 32, 12, 512, 256, 256, 32, 32, 3), '0.0058',
     'bytes'),
    ('observe_fwd', F32, (32, 32, 12, 512, 256, 256, 32, 32, 3), '0.0405',
     'operations'),
    ('observe_bwd', BF16, (32, 32, 12, 256, 256, 32, 32, 3), '0.0135',
     'bytes'),
    ('observe_bwd', F32, (32, 32, 12, 256, 256, 32, 32, 3), '0.0646',
     'operations'),
    ('observe_fwd', BF16, (32, 16, 6, 2560, 512, 512, 32, 32, 3), '0.0064',
     'bytes'),
    ('observe_bwd', BF16, (32, 16, 6, 512, 512, 32, 32, 3), '0.0116',
     'bytes'),
    ('imagine_actor', BF16, (1024, 15, 512, 512, 32, 32, 6, 3, 4), '0.124',
     'operations'),
    ('imagine_actor', BF16, (512, 15, 512, 512, 32, 32, 6, 3, 4), '0.0620',
     'operations'),
    ('imagine_actor', F32, (512, 15, 512, 512, 32, 32, 6, 3, 4), '0.9145',
     'operations'),
    ('imagine', BF16, (15, 1024, 5, 512, 512, 32, 32, 3), '0.0910',
     'operations'),
    ('observe', BF16, (32, 32, 5, 512, 512, 32, 32, 3), '0.0057', 'bytes'),
    ('gve', F32, (15, 2048), '0.00011', 'bytes'),
]
WORK = {
    'observe_fwd': rssm_vjp.observe_fwd_work,
    'observe_bwd': rssm_vjp.observe_bwd_work,
    'imagine_actor': rssm.imagine_actor_work,
    'imagine': rssm.rollout_work,
    'observe': lambda T, B, A, D, U, S, C, n, dtype: rssm.rollout_work(
        T, B, A, D, U, S, C, n, dtype, E=512),
    'gve': lambda H, n, dtype: lr.gve_work(H, n),
}


@pytest.mark.parametrize('name,dtype,dims,printed,bound_by', BOUNDS)
def test_kernel_bounds_keep_their_numbers(name, dtype, dims, printed,
                                          bound_by):
  """The formulas, moved from `chip_smoke.py` into `ops/`, give the bounds
  that the kernel check printed before the move."""
  flops, nbytes = WORK[name](*dims, dtype)
  got = cost.bound(flops, nbytes, dtype)
  digits = len(printed.split('.')[1])
  assert f'{got["bound_ms"]:.{digits}f}' == printed, got
  assert got['bound_by'] == bound_by


@pytest.fixture(scope='module')
def twin():
  """The bench's count of one update at the test shape, the FlopCounter's,
  and the number of trainable values."""
  work = bench.train_cost(TASK, OVERRIDES, 'cpu')
  agent, _ = bench.build_agent(TASK, OVERRIDES, 'cpu')
  agent._create()
  params = sum(p.numel() for p in agent.agent.parameters())
  return work, bench.train_flops(TASK, OVERRIDES, 'cpu'), params


def test_twin_flops_equal_flop_counter(twin):
  work, flops, _ = twin
  assert work['flops'] == flops > 1e10
  assert sum(row[1] for row in work['table'].values()) == flops


def test_twin_bytes_cover_the_optimizer(twin):
  """At least the optimizer's compulsory traffic: the parameters, their
  gradients and both moments, each read and written once in float32."""
  work, _, params = twin
  assert isinstance(work['bytes'], int)
  assert work['bytes'] >= 4 * 2 * 4 * params
  assert sum(row[2] for row in work['table'].values()) == work['bytes']


def _ring_agent(overrides):
  agent, data = bench.build_agent(TASK, {**OVERRIDES, **overrides}, 'cpu')
  replay = profile_train.fill_ring(agent, data)
  state, _ = profile_train._dispatch(agent, replay, 1, None)
  return agent, replay, state


def test_fused_kernels_count_the_same_twice_and_no_more_than_the_loop():
  fused, replay, state = _ring_agent(
      {'rssm.impl': 'pallas', 'imag_impl': 'pallas'})
  first = fused.train_device_cost(replay, 1, state)
  second = fused.train_device_cost(replay, 1, state)
  assert first == second
  for name in ('observe_fwd', 'observe_bwd', 'imagine_actor'):
    assert first['table'][name][0] == 1, name
  loop, replay, state = _ring_agent({})
  scan = loop.train_device_cost(replay, 1, state)
  assert not {'observe_fwd', 'observe_bwd', 'imagine_actor'} & set(
      scan['table'])
  print(f'bytes of an update at the test shape: fused kernels '
        f'{first["bytes accessed"]}, loop path {scan["bytes accessed"]}')
  assert 0 < first['bytes accessed'] <= scan['bytes accessed']


def test_train_device_cost_leaves_agent_and_ring():
  agent, replay, state = _ring_agent({'replay': 'prio'})
  assert replay.prioritized
  before = agent.save()
  generators = [g.get_state() for g in (agent.generator,
                                        agent._policy_generator)]
  prios = replay.prios.clone()
  carry = {k: v.clone() for k, v in state.items()}
  steps = agent._train_steps
  got = agent.train_device_cost(replay, 2, state)
  assert got['flops'] > 2e10 and got['bytes accessed'] > 0
  assert 'aten::index_put_' in got['table']  # The priorities' writes.
  after = agent.save()
  assert sorted(before) == sorted(after)
  for key in before:
    np.testing.assert_array_equal(before[key], after[key], key)
  for old, g in zip(generators, (agent.generator, agent._policy_generator)):
    assert torch.equal(old, g.get_state())
  assert torch.equal(prios, replay.prios)
  assert all(torch.equal(carry[k], state[k]) for k in carry)
  assert agent._train_steps == steps and agent._use_graphs


# --------------------------------------------------------------------------
# The JAX package's plain train program, counted from its jaxpr.


def _root_bench():
  path = pathlib.Path(__file__).resolve().parent.parent / 'bench.py'
  spec = importlib.util.spec_from_file_location('jax_bench', path)
  module = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(module)
  return module


def _subjaxprs(params):
  for value in params.values():
    for item in value if isinstance(value, (list, tuple)) else [value]:
      if isinstance(item, jax.extend.core.ClosedJaxpr):
        yield item.jaxpr
      elif isinstance(item, jax.extend.core.Jaxpr):
        yield item


def _aval_bytes(var):
  aval = var.aval
  if not hasattr(aval, 'shape'):
    return 0
  return math.prod(aval.shape) * aval.dtype.itemsize  # A key: 8 bytes.


def jaxpr_bytes(jaxpr):
  """Operands plus results of each equation of one run of `jaxpr` (each
  distinct operand once), into every sub-jaxpr (`jit`, `custom_vjp`, the
  larger branch of a `cond`, a `while` body once), each `scan` body times
  its length. An equation with a sub-jaxpr counts only its body."""
  total = 0
  for eqn in jaxpr.eqns:
    inner = [jaxpr_bytes(sub) for sub in _subjaxprs(eqn.params)]
    if inner:
      if eqn.primitive.name == 'cond':
        total += max(inner)
      elif eqn.primitive.name == 'scan':
        total += eqn.params['length'] * sum(inner)
      else:
        total += sum(inner)
      continue
    operands = {id(v): v for v in eqn.invars}
    total += sum(_aval_bytes(v) for v in operands.values())
    total += sum(_aval_bytes(v) for v in eqn.outvars)
  return total


def test_train_bytes_beside_jax(twin):
  """One update at the test shape: the port's count with the plain
  versions of the LayerNorm and optimizer kernels (no fusion, the loop
  path) against the JAX plain train program's equations, each counted as
  if it were a kernel of its own. Neither is XLA's fused count. The ratio
  is 0.7738 on this tree. The band around it fails a count without the
  autograd backward: pausing the counter over `torch.autograd.grad` gives
  0.620, because at this shape the optimizer and the weight casts carry
  most of the bytes. It also fails a count of every byte twice (1.55) and
  a count in bits. The count with the kernels, by their formulas, is
  below the plain one (0.536 of it on this tree)."""
  jbench = _root_bench()
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
  want = jaxpr_bytes(closed.jaxpr)
  with build.plain_versions():
    got = bench.train_cost(TASK, OVERRIDES, 'cpu')['bytes']
  print(f'bytes of one update at the test shape: port {got}, JAX jaxpr '
        f'{want}, ratio {got / want:.4f}; with the kernels '
        f'{twin[0]["bytes"]}, {twin[0]["bytes"] / got:.4f} of the plain')
  assert 0.7 <= got / want <= 0.85, (got, want)
  assert twin[0]['bytes'] < got


def test_profile_counts_bytes_by_category():
  """`profile_train.py`'s bytes on the CPU: the twin's bytes are the bench's,
  both tables sorted into the profile's categories, and no device time."""
  report = profile_train.profile_shape('test', 1, K=2, device='cpu')
  counted = report['bytes']
  work = bench.train_cost(TASK, OVERRIDES, 'cpu')
  assert counted['twin_bytes_per_update'] == work['bytes']
  assert counted['twin_flops_per_update'] == work['flops']
  rows = {r['category']: r for r in counted['categories']}
  assert sum(r['twin_bytes_per_update'] for r in rows.values()) == (
      work['bytes'])
  assert sum(r['bytes_per_update'] for r in rows.values()) == (
      counted['bytes_per_update'])
  # The fused LayerNorm, optimizer and RSSM step kernels count under their
  # own names.
  assert {'elementwise', 'gemm', 'cast_copy', 'layer_norm_act_fwd',
          'layer_norm_act_bwd', 'adam_sumsq', 'adam_update', 'gru_cell_fwd',
          'gru_cell_bwd', 'onehot_head_fwd', 'onehot_head_bwd'} <= set(rows)
  assert all(r['gb_per_s'] is None for r in rows.values())
  assert len(counted['top']) == 25
  assert profile_train.category_bytes({
      'observe_bwd': [1, 0, 5], 'aten::mm': [1, 0, 7],
      'aten::elu_backward': [1, 0, 11], 'aten::cat': [1, 0, 13],
      'aten::argmax': [1, 0, 17], 'aten::_log_softmax': [1, 0, 19]}) == {
          'observe_bwd': 5, 'gemm': 7, 'elementwise': 11, 'cast_copy': 13,
          'reduction': 17, 'other': 19}

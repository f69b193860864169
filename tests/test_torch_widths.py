"""The port at widths past its fusion kernels' first layouts, each of which
the JAX package trains: `norm: none` (the GRU cell without a norm), class
counts that are no power of two from 2 to 32, a deter past 2 048 and
`norm: layer` rows past the layout that keeps a row in registers.

- One whole `Agent.train` step at `--rssm.classes 48 --rssm.norm none`
  against the JAX agent, on the JAX agent's state carried by `load`, with
  sampling set to the modes on both sides as `tests/test_torch_agent.py`
  sets it, at its tolerances: losses rtol 1e-4 (atol 1e-5), the state
  after the update atol 3e-4. Likewise one at `--rssm.impl pallas
  --rssm.deter 20 --rssm.prior_layers 9`, widths past the RSSM kernels'
  first layouts, through the fused observe chain and (the port's
  `--imag_impl pallas`) the fused rollout.
- No wrapper refuses these widths: each op's `_check` takes them (the
  launches themselves are held to the plain versions by the emulated
  cases, `tests/test_torch_emulate_gru.py`, `_onehot.py`, `_update.py`).
- `gru_cell` without a norm goes through `GRUCell`, the kernels' Function,
  and equals the plain version and its gradients exactly on the CPU.
- The LayerNorm backward of rows past the plan picks its kernel by the
  rows and their width (`norm.cluster_plan`: the cluster backward, or the
  streaming one for many narrow rows and for rows too wide for a
  cluster), and sizes `partial` for the launch it picks.
"""

import numpy as np
import pytest
import torch

from daydreamer_tpu_torch.ops import build, gru, norm, onehot
from daydreamer_tpu_torch.ops import rssm as pops
from daydreamer_tpu_torch.ops import rssm_vjp as pvjp
from test_torch_agent import _jax_run, env, mode_sampling, port_agent  # noqa: F401

torch.set_num_threads(1)

WIDTHS = {'rssm.classes': 48, 'rssm.norm': 'none'}


def test_train_step_matches_jax_classes_48_norm_none(env, mode_sampling):
  before, after, data, jmets = _jax_run(env, **WIDTHS)
  agent = port_agent(env, **WIDTHS)
  rssm = agent.agent.wm.rssm
  assert (rssm._classes, rssm._kw['norm']) == (48, 'none')
  agent.load(before)
  calls = []
  apply = gru.GRUCell.apply
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(gru.GRUCell, 'apply',
               lambda *a: calls.append(a[2]) or apply(*a))
    _, _, pmets = agent.train(data)
    pmets = dict(pmets)
  # The GRU cell ran through the kernels' Function, without a norm.
  assert calls and all(scale is None for scale in calls)
  assert set(pmets) == set(jmets)
  for key in sorted(jmets):
    np.testing.assert_allclose(pmets[key], jmets[key], rtol=1e-4,
                               atol=1e-5, err_msg=key)
  state = agent.save()
  assert set(state) == set(after)
  for key, value in after.items():
    np.testing.assert_allclose(
        state[key], np.asarray(value), atol=3e-4, rtol=0, err_msg=key)


CHAIN_WIDTHS = {'rssm.impl': 'pallas', 'rssm.deter': 20,
                'rssm.prior_layers': 9}


def test_train_step_matches_jax_pallas_deter20_prior9(env, mode_sampling):
  before, after, data, jmets = _jax_run(env, **CHAIN_WIDTHS)
  agent = port_agent(env, imag_impl='pallas', **CHAIN_WIDTHS)
  rssm = agent.agent.wm.rssm
  assert (rssm._deter, rssm._prior_layers) == (20, 9)
  agent.load(before)
  calls = {(pvjp, 'observe_fwd_plain'): 0, (pvjp, 'observe_bwd_plain'): 0,
           (pops, 'imagine_actor_plain'): 0}
  with pytest.MonkeyPatch.context() as mp:
    for module, name in calls:
      def counted(*a, _key=(module, name), _fn=getattr(module, name), **k):
        calls[_key] += 1
        return _fn(*a, **k)
      mp.setattr(module, name, counted)
    _, _, pmets = agent.train(data)
    pmets = dict(pmets)
  # The fused chain and rollout ran (their plain versions, on the CPU).
  assert all(calls.values()), calls
  assert set(pmets) == set(jmets)
  for key in sorted(jmets):
    np.testing.assert_allclose(pmets[key], jmets[key], rtol=1e-4,
                               atol=1e-5, err_msg=key)
  state = agent.save()
  assert set(state) == set(after)
  for key, value in after.items():
    np.testing.assert_allclose(
        state[key], np.asarray(value), atol=3e-4, rtol=0, err_msg=key)


def test_wrappers_take_every_width(monkeypatch):
  """Each op's `_check` at the widths it refused before: only the dtype
  checks remain (the tensors' device and layout are `build.check`'s, set
  aside here on the CPU)."""
  monkeypatch.setattr(build, 'check', lambda *args, **kwargs: None)
  t = lambda *shape: torch.zeros(shape)
  for D in (10, 2048, 2049, 4096):
    assert gru._check('gru_cell_fwd', t(2, 3 * D), t(2, D), t(3 * D),
                      t(3 * D)) == (2, D)
    assert gru._check('gru_cell_bwd', t(2, 3 * D), t(2, D), None,
                      None) == (2, D)
  for C in (1, 3, 48, 64, 100, 256):
    assert onehot._check('onehot_head_fwd', t(2, 4, C)) == C
  for C in (4100, 16392, 12292, 5000):
    assert norm._check('layer_norm_act_fwd', t(2, C), t(C), t(C),
                       'elu') == (2, C)
  with pytest.raises(TypeError):
    onehot._check('onehot_head_fwd', t(2, 4, 3).half())


def test_gru_cell_without_norm_goes_through_gru_cell_function():
  rng = np.random.default_rng(0)
  x = torch.as_tensor(rng.standard_normal((3, 30)).astype(np.float32))
  deter = torch.as_tensor(rng.standard_normal((3, 10)).astype(np.float32))
  dout = torch.as_tensor(rng.standard_normal((3, 10)).astype(np.float32))
  leaves = [v.clone().requires_grad_() for v in (x, deter)]
  out = gru.gru_cell(*leaves)
  assert type(out.grad_fn).__name__ == 'GRUCellBackward'
  out.backward(dout)
  plain = [v.clone().requires_grad_() for v in (x, deter)]
  ref = gru.gru_cell_plain(*plain)
  ref.backward(dout)
  assert torch.equal(out, ref)
  for got, want in zip(leaves, plain):
    assert torch.equal(got.grad, want.grad)


@pytest.mark.parametrize('rows,C,dtype,clustered', [
    (1024, 4100, torch.bfloat16, False),
    (16384, 6148, torch.bfloat16, False),
    (32, 4100, torch.bfloat16, True),
    (1, 4097, torch.bfloat16, True),
    (1024, 16392, torch.bfloat16, True),
    (1024, 4097, torch.float32, True),
    (1024, 12292, torch.float32, True),
    (1024, 70000, torch.bfloat16, False),
])
def test_layer_norm_backward_path(rows, C, dtype, clustered):
  plan = norm.cluster_plan(rows, C, dtype)
  assert (plan is not None) == clustered
  partial = norm._partial_rows(rows, plan)
  # At least the streaming backward's blocks and the clusters of 8 blocks
  # of rows a block's lanes hold; with a plan, its clusters' and groups'.
  assert partial >= min(norm.BWD_BLOCKS, -(-rows // norm.STREAM_ROWS))
  assert partial >= -(-min(rows, norm.BWD_BLOCKS) // 8)
  if plan is not None:
    ranks, threads, vec, clusters = plan
    assert partial >= clusters + norm._groups(clusters)
    item = torch.tensor([], dtype=dtype).element_size()
    # The cluster's lanes hold the row, at most CLUSTER_BYTES of it a lane.
    assert C % vec == 0 and threads % 32 == 0
    assert ranks * threads * (norm.CLUSTER_BYTES // item) >= C


@pytest.mark.parametrize('rows,C,dtype,act,limit,stages', [
    (1024, 12292, torch.float32, 'none', None, 2),
    (16384, 24580, torch.bfloat16, 'elu', None, 2),
    (1024, 16392, torch.bfloat16, 'elu', None, 0),
    (1024, 4100, torch.bfloat16, 'none', None, 0),
    (16384, 4100, torch.bfloat16, 'elu', None, 0),
    (1, 16392, torch.bfloat16, 'elu', None, 3),
    (32, 4100, torch.bfloat16, 'elu', None, 4),
    (128, 4097, torch.float32, 'elu', None, 4),
    (129, 4097, torch.float32, 'elu', None, 0),
    (32, 4100, torch.bfloat16, 'none', None, 0),
    (1024, 30000, torch.bfloat16, 'none', None, 2),
    (1024, 70000, torch.bfloat16, 'none', None, 0),
    (5, 4100, torch.bfloat16, 'elu', 16000, 0),
    (5, 4100, torch.bfloat16, 'elu', 20000, 2),
    (5, 4100, torch.bfloat16, 'elu', 40000, 2),
])
def test_layer_norm_forward_path(monkeypatch, rows, C, dtype, act, limit,
                                 stages):
  """The forward of rows past the plan (`norm.stage_plan`): the staged
  kernel for rows of at least STAGE_LEAST bytes and for at most STAGE_FEW
  rows with the ELU, with up to STAGES buffers a block, as many as half the
  card's shared memory holds (two blocks an SM), two where only all of it
  holds them; the streaming kernel elsewhere and where it does not hold
  two."""
  if limit is not None:
    monkeypatch.setattr(build, 'SHARED_MEMORY_LIMIT', limit)
  assert norm.stage_plan(rows, C, dtype, act) == stages
  item = torch.tensor([], dtype=dtype).element_size()
  buffer = -(-C * item // 16) * 16 + 16
  used = 4 * norm.STAGE_RED + 2 * buffer
  fits = used <= build.SHARED_MEMORY_LIMIT
  if stages:
    assert norm.stage_buffers(C, dtype) == stages
  assert (norm.stage_buffers(C, dtype) > 0) == fits
  routed = C * item >= norm.STAGE_LEAST or (rows <= norm.STAGE_FEW
                                            and act == 'elu')
  assert (stages > 0) == (routed and fits)
  assert stages <= norm.STAGES
  if stages > 2:
    used += (stages - 2) * buffer
    assert 2 * used <= build.SHARED_MEMORY_LIMIT


@pytest.mark.parametrize('C,dtype,lane', [
    (1, torch.bfloat16, 1), (3, torch.float32, 1), (48, torch.bfloat16, 8),
    (48, torch.float32, 4), (64, torch.bfloat16, 8), (100, torch.bfloat16, 4),
    (200, torch.bfloat16, 8), (255, torch.bfloat16, 8),
    (256, torch.float32, 8), (300, torch.bfloat16, 0),
    (257, torch.float32, 0), (1000, torch.bfloat16, 0),
])
def test_onehot_backward_path(C, dtype, lane):
  """The head backward at a class count that is no power of two from 2 to
  32 (`onehot.group_lane_classes`): a lane the widest vector that C is a
  multiple of, doubled until a warp's lanes hold the group, the group
  kernel up to GROUP_MOST classes a lane, the passes past it (0)."""
  assert onehot.group_lane_classes(C, dtype) == lane
  if lane:
    # A warp's lanes hold the group, and half as many classes a lane
    # would not, unless a lane holds no more than its vector.
    item = torch.tensor([], dtype=dtype).element_size()
    assert -(-C // lane) <= 32 and lane <= onehot.GROUP_MOST
    assert (lane * item <= 16 and C % lane == 0) or -(-C // (lane // 2)) > 32


@pytest.mark.parametrize('rows,D,dtype,plan', [
    (1024, 2048, torch.bfloat16, None),
    (1024, 4096, torch.bfloat16, (512, 8)),
    (1024, 2056, torch.bfloat16, (288, 8)),
    (1024, 3076, torch.bfloat16, (416, 4)),
    (16384, 6144, torch.bfloat16, (768, 8)),
    (16384, 8192, torch.bfloat16, (1024, 8)),
    (1024, 4096, torch.float32, None),
    (1024, 2049, torch.bfloat16, None),
    (1024, 6144, torch.float32, None),
    (32, 4096, torch.bfloat16, (1024, 4)),
    (32, 4096, torch.float32, (1024, 4)),
    (32, 4100, torch.float32, None),
    (1, 2049, torch.float32, (544, 1)),
    (1, 2056, torch.bfloat16, (544, 4)),
    (1, 4100, torch.bfloat16, (544, 4)),
    (1, 9000, torch.bfloat16, None),
])
def test_gru_forward_path(rows, D, dtype, plan):
  """The forward of deters past MAX_D (`gru.fwd_plan`): a block of up to
  FWD_THREADS threads a row where its threads hold the row at FWD_BYTES of
  a part a thread (a vector counted at 4 bytes at least): for fewer than
  FWD_SPREAD rows the most threads, for more the fewest, and then only
  where a thread keeps FWD_MANY_VALUES values of a part; else None, the
  streaming forward, as at or under MAX_D and for rows no block holds."""
  assert gru.fwd_plan(rows, D, dtype) == plan
  if plan is not None:
    threads, vec = plan
    item = torch.tensor([], dtype=dtype).element_size()
    nv = -(-D // (vec * threads))
    assert D % vec == 0 and threads % 32 == 0
    assert threads <= gru.FWD_THREADS
    assert nv * max(vec * item, 4) <= gru.FWD_BYTES
    assert 24 * nv * vec * threads <= build.SHARED_MEMORY_LIMIT
    if rows >= gru.FWD_SPREAD:
      assert nv * vec >= gru.FWD_MANY_VALUES


@pytest.mark.parametrize('rows,D,dtype,dims', [
    (1024, 4096, torch.bfloat16, (512, 8, 640)),
    (1024, 2056, torch.bfloat16, (288, 8, 640)),
    (1, 2049, torch.float32, (544, 1, 1024)),
    (1, 2056, torch.bfloat16, (544, 4, 1024)),
    (1024, 3076, torch.bfloat16, (416, 4, 1024)),
    (32, 4096, torch.bfloat16, (1024, 4, 1024)),
    (16384, 6144, torch.bfloat16, (768, 8, 1024)),
    (1024, 2049, torch.bfloat16, (0, 0, 0)),
])
def test_gru_forward_bound(monkeypatch, rows, D, dtype, dims):
  """The wrapper passes the block forward its threads, its vector and the
  launch bound of its instantiation: FWD_BOUND for blocks of at most
  FWD_BOUND threads that keep one 16-byte vector of a part, else
  FWD_THREADS; FWD_BOUND 0, FWD_THREADS for every block; zeros for the
  streaming forward."""
  seen = []
  monkeypatch.setattr(build, 'check', lambda *args, **kwargs: None)
  monkeypatch.setattr(build, 'launch',
                      lambda kernel, fn, dt, ptrs, dims, *rest:
                      seen.append(tuple(dims[5:])))
  x, deter = torch.zeros(rows, 3 * D, dtype=dtype), torch.zeros(
      rows, D, dtype=dtype)
  scale, bias = torch.ones(3 * D), torch.zeros(3 * D)
  gru.gru_cell_fwd_cuda(x, deter, scale, bias)
  monkeypatch.setattr(gru, 'FWD_BOUND', 0)
  gru.gru_cell_fwd_cuda(x, deter, scale, bias)
  loose = dims[:2] + (gru.FWD_THREADS if dims[0] else 0,)
  assert seen == [dims, loose]


def test_gru_forward_path_rules(monkeypatch):
  """A card whose shared memory cannot hold a block's scale and bias, and
  FWD_BYTES 0, send every deter to the streaming forward."""
  assert gru.fwd_plan(32, 4096, torch.bfloat16) is not None
  monkeypatch.setattr(build, 'SHARED_MEMORY_LIMIT', 64 * 1024)
  assert gru.fwd_plan(32, 4096, torch.bfloat16) is None
  assert gru.fwd_plan(32, 2049, torch.bfloat16) == (544, 1)
  monkeypatch.setattr(gru, 'FWD_BYTES', 0)
  assert gru.fwd_plan(1, 2049, torch.bfloat16) is None


@pytest.mark.parametrize('C,dtype,few,many,bwd', [
    (1, torch.bfloat16, 1, 1, 1), (3, torch.float32, 1, 3, 1),
    (6, torch.float32, 1, 6, 2), (37, torch.float32, 2, 3, 2),
    (48, torch.bfloat16, 2, 6, 8), (48, torch.float32, 2, 6, 4),
    (64, torch.bfloat16, 2, 8, 8), (100, torch.bfloat16, 4, 4, 4),
    (200, torch.bfloat16, 8, 8, 8), (255, torch.bfloat16, 8, 8, 8),
    (256, torch.float32, 8, 8, 8), (300, torch.bfloat16, 0, 0, 0),
    (300, torch.float32, 0, 0, 0),
])
def test_onehot_general_path(monkeypatch, C, dtype, few, many, bwd):
  """The head's general kernels at classes that are no power of two from 2
  to 32: the forward takes `fwd_lane_classes`' classes a lane (one of
  GROUP_LANES: the fewest idle places where those give GROUP_WIDE_LANES
  lanes or more, else the fewest that fit a group in a warp), the backward
  `group_lane_classes`' (1, 2, 4 or 8); each 0 past GROUP_MOST on a warp
  (the passes). The wrappers pass them to the kernel."""
  assert onehot.fwd_lane_classes(C, dtype, 32 * 32 * C) == few
  assert onehot.fwd_lane_classes(C, dtype, 1 << 30) == many
  if many:
    # The rule turns where the many values' lanes fill GROUP_WIDE_LANES.
    lanes = 1 << (-(-C // many) - 1).bit_length()
    groups = -(-onehot.GROUP_WIDE_LANES // lanes)
    assert onehot.fwd_lane_classes(C, dtype, groups * C) == many
    assert onehot.fwd_lane_classes(C, dtype, (groups - 1) * C) == few
  assert onehot.group_lane_classes(C, dtype) == bwd
  for lane in (few, many):
    if lane:
      lanes = 1 << (-(-C // lane) - 1).bit_length()
      at = onehot.GROUP_LANES.index(lane)
      assert lanes <= 32 and (
          at == 0 or -(-C // onehot.GROUP_LANES[at - 1]) > 32
          or lane == many)
  seen = []
  monkeypatch.setattr(build, 'check', lambda *args, **kwargs: None)
  monkeypatch.setattr(build, 'launch',
                      lambda kernel, fn, dt, ptrs, dims, *rest:
                      seen.append((fn, dims[5])))
  raw = torch.zeros(2, 3, C, dtype=dtype)
  logit, _ = onehot.onehot_head_fwd_cuda(raw, torch.zeros(2, 3, C), 0.01)
  onehot.onehot_head_bwd_cuda(raw, logit, logit, logit, 0.01, True)
  assert seen == [('onehot_head_fwd', few), ('onehot_head_bwd', bwd)]

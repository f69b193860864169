"""`torch.graphs`, the port's counterpart of `jax.jit`, on the CPU at the
test config (`debug`, `dummy_discrete`, batch 4 x chunk 6).

On the CPU there is no graph to capture, so the runner's bookkeeping (the
static buffers, the copies in and out, the keys) calls each function
eagerly; these tests hold what a capture on the card relies on:
(a) no state entry changes its address after creation, so a graph that
    writes the state writes the live entries;
(b) nothing in a captured function syncs with the host (`.item()`,
    `nonzero`, boolean masks, `unique`), for the default agent and
    plan2explore, in every entry point that is captured;
(c) the ring's counts as device scalars give the spans, windows and
    weights that its host ints give, before and after the ring wraps;
(d) the runner's bookkeeping equals a direct call, hands out copies, and
    makes a new entry for a new shape;
(e) `--torch.graphs False` and `True` make the same updates.
"""

import numpy as np
import pytest
import torch
from torch.utils import _python_dispatch

import daydreamer_tpu_torch as ddp
from daydreamer_tpu_torch import replay as replaylib
from daydreamer_tpu_torch.agents.dreamer import graphs
from daydreamer_tpu_torch.envs import load_env
from daydreamer_tpu_torch.ops import build
from daydreamer_tpu_torch.replay import device_replay as drlib

torch.set_num_threads(1)

MODES = ('train', 'eval', 'explore')


def make_agent(env, configs=('debug',), **kw):
  from daydreamer_tpu_torch.agents.dreamer import Agent
  config = ddp.Config(Agent.configs['defaults'])
  for name in configs:
    config = config.update(Agent.configs[name])
  config = config.update({
      'task': 'dummy_discrete', 'torch.device': 'cpu', 'batch_size': 4,
      'replay_chunk': 6, 'imag_horizon': 2, 'env.amount': 1,
      'env.length': 10, 'env.parallel': 'none', **kw})
  return Agent(env.obs_space, env.act_space, ddp.Counter(), config)


@pytest.fixture(scope='module')
def env():
  env = load_env('dummy_discrete', amount=1, parallel='none', length=10)
  yield env
  env.close()


def make_ring(env, agent, prioritized=False, steps=40):
  """A device ring on the agent's device, filled from a host replay of
  random actions; the same steps on every call."""
  np.random.seed(0)
  fixed = replaylib.FixedLength(replaylib.RAMStore(int(1e4)), chunk=6)
  stepper = ddp.Driver(env)
  stepper.on_step(fixed.add)
  stepper(ddp.RandomAgent(env.act_space).policy, steps=steps)
  ring = agent.make_device_replay(capacity=128, block=8,
                                  prioritized=prioritized)
  drlib.StoreMirror(fixed, ring).sync()
  return ring


def make_batch(env, B=4, T=6, seed=0):
  rng = np.random.default_rng(seed)
  data = {}
  for key, space in env.obs_space.items():
    if key.startswith('log_'):
      continue
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
  return data


def observation(env, B=1, seed=0):
  batch = make_batch(env, B, 1, seed)
  return {k: v[:, 0] for k, v in batch.items() if k != 'action'}


def state_of(agent):
  return {k: v.detach().clone() for k, v in ddp.nn.state(agent.agent).items()}


def addresses(agent):
  return {k: v.data_ptr() for k, v in ddp.nn.state(agent.agent).items()}


def drive(env, agent):
  """Every captured entry point after creation: `train` and `train_multi`
  (their first call carries no state and runs eagerly), `train_device` on
  a uniform and a prioritized ring, and the policy in each mode."""
  batch = make_batch(env)
  _, state, _ = agent.train(batch)
  _, state, _ = agent.train(make_batch(env, seed=1), state)
  agent.train_multi([batch, make_batch(env, seed=2)], state)
  for prioritized in (False, True):
    ring = make_ring(env, agent, prioritized)
    _, carry, _ = agent.train_device(ring, 2)
    agent.train_device(ring, 1, carry)
  for mode in MODES:
    obs = observation(env)
    _, state = agent.policy(obs, mode=mode)
    agent.policy(observation(env, seed=1), state, mode=mode)


# ---------------------------------------------------------------------------
# (a) Addresses.


def test_state_keeps_its_addresses(env):
  agent = make_agent(env)
  agent._create()
  before = addresses(agent)
  drive(env, agent)
  after = addresses(agent)
  assert set(after) == set(before)
  moved = [k for k in before if after[k] != before[k]]
  assert not moved, moved
  assert agent.graphs.captured  # The entry points went through the runner.


def test_write_updates_in_place_and_checks():
  module = ddp.nn.Module('m')
  with ddp.nn.scope(create=True):
    entry = module.value('count', lambda: torch.zeros((), dtype=torch.int32),
                         trainable=False)
  pointer = entry.data_ptr()
  module.write('count', entry + 1)
  assert module.values['count'] is entry and entry.data_ptr() == pointer
  assert int(entry) == 1
  with pytest.raises(ValueError, match='cannot write'):
    module.write('count', torch.zeros(()))  # float32 into int32.
  with pytest.raises(ValueError, match='cannot write'):
    module.write('count', torch.zeros(2, dtype=torch.int32))
  with pytest.raises(KeyError):
    module.write('other', entry)


# ---------------------------------------------------------------------------
# (b) No host sync inside a captured function.


SYNCS = ('aten._local_scalar_dense', 'aten.nonzero', 'aten.masked_select',
         'aten.unique', 'aten._unique', 'aten.unique_dim',
         'aten.unique_consecutive', 'aten._unique2', 'aten.equal',
         'aten.is_nonzero', 'aten.item')


class NoSync(_python_dispatch.TorchDispatchMode):
  """Raises at any operator that waits for the device's values on the
  card: those of `SYNCS`, and an index or an index write by a boolean
  mask, which counts its true entries first."""

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    name = str(func.overloadpacket).removeprefix('aten.')
    masked = name in ('index', 'index_put', 'index_put_', '_index_put_impl_')
    if name in (s.removeprefix('aten.') for s in SYNCS) or masked and any(
        isinstance(i, torch.Tensor) and i.dtype in (torch.bool, torch.uint8)
        for i in args[1] if i is not None):
      raise AssertionError(f'host sync inside a captured function: {func}')
    return func(*args, **(kwargs or {}))


@pytest.mark.parametrize('configs', [('debug',), ('debug', 'plan2explore')],
                         ids=['greedy', 'plan2explore'])
def test_captured_functions_do_not_sync(env, configs, monkeypatch):
  agent = make_agent(env, configs)
  agent._create()
  ran = []
  original = graphs.Captured.run

  def run(self):
    ran.append(self.name)
    with NoSync():
      return original(self)

  monkeypatch.setattr(graphs.Captured, 'run', run)
  drive(env, agent)
  assert set(ran) == {'train', 'train_device', 'policy'}
  assert ran.count('policy') == len(MODES)
  # The probe itself sees what it should: a mask index and an `.item()`.
  with pytest.raises(AssertionError, match='host sync'):
    with NoSync():
      torch.arange(4)[torch.arange(4) > 1]
  with pytest.raises(AssertionError, match='host sync'):
    with NoSync():
      torch.ones(()).item()


# ---------------------------------------------------------------------------
# (c) The ring's counts on the device.


def make_steps(start, n, ends=()):
  steps = {
      'value': np.arange(start, start + n, dtype=np.int32),
      'reward': np.linspace(0, 1, n).astype(np.float32),
      'is_first': np.zeros(n, bool),
      'is_last': np.zeros(n, bool)}
  steps['is_last'][list(ends)] = True
  return steps


@pytest.mark.parametrize('total', [24, 32, 80])
def test_device_counts_match_host_counts(total):
  """Before the ring is full, just full, and wrapped two and a half
  times: the span and base, the gathered windows and rows, the window
  weights and the draws are those of the host ints."""
  capacity, chunk = 32, 4
  ring = drlib.DeviceReplay(capacity, chunk, block=8, device='cpu',
                            prioritized=True)
  ring.add_steps(make_steps(0, total, ends=[5, 19]))
  ring.prios.copy_(torch.as_tensor(
      np.random.default_rng(0).uniform(0.01, 2.0, capacity),
      dtype=torch.float32))
  host, device = ring.state, ring.device_state
  assert (int(device[1]), int(device[2])) == (ring.filled, ring.cursor)
  _, span, base = drlib.valid_span(host, chunk)
  _, span_t, base_t = drlib.valid_span(device, chunk)
  assert isinstance(span, int) and isinstance(span_t, torch.Tensor)
  assert (int(span_t), int(base_t)) == (span, base)
  offset = torch.arange(span + 1)
  out, rows = drlib.gather(host, offset, chunk)
  out_t, rows_t = drlib.gather(device, offset, chunk)
  assert torch.equal(rows, rows_t)
  for key in out:
    assert torch.equal(out[key], out_t[key]), key
  weights = drlib.window_weights(host, ring.prios, chunk, 0.5, 0.1)
  weights_t = drlib.window_weights(device, ring.prios, chunk, 0.5, 0.1)
  assert torch.equal(weights, weights_t)
  for prio_ends in (0.0, 1.0):
    draws = [drlib.sample(state, torch.Generator().manual_seed(3), 16, chunk,
                          prio_ends) for state in (host, device)]
    for key in draws[0]:
      assert torch.equal(draws[0][key], draws[1][key]), (prio_ends, key)
  draws = [drlib.sample_prioritized(
      state, ring.prios, torch.Generator().manual_seed(3), 16, chunk)
      for state in (host, device)]
  assert torch.equal(draws[0][1], draws[1][1])
  assert torch.equal(draws[0][0]['prob'], draws[1][0]['prob'])


def test_device_counts_follow_later_blocks():
  """A draw that holds the device counts, as a graph captured before the
  blocks came does, reaches the rows added after it was set up."""
  ring = drlib.DeviceReplay(64, 4, block=8, device='cpu')
  ring.add_steps(make_steps(0, 16))
  state = ring.device_state
  before = drlib.sample(state, torch.Generator().manual_seed(0), 256, 4)
  assert before['value'].max() < 16
  ring.add_steps(make_steps(16, 40))
  after = drlib.sample(state, torch.Generator().manual_seed(0), 256, 4)
  assert after['value'].max() >= 16 and after['value'].max() < 56


def test_priorities_keep_the_last_write():
  """Overlapping windows write a row several times; the row keeps the last
  write in row-major order, as an index write on the CPU leaves it."""
  rng = np.random.default_rng(0)
  rows = torch.as_tensor(rng.integers(0, 12, (6, 4)))
  values = torch.as_tensor(rng.uniform(0, 1, (6, 4)), dtype=torch.float32)
  prios = torch.zeros(16)
  drlib.write_priorities(prios, rows, values)
  want = torch.zeros(16)
  for row, value in zip(rows.reshape(-1).tolist(), values.reshape(-1)):
    want[row] = value
  assert torch.equal(prios, want)
  assert len(set(rows.reshape(-1).tolist())) < rows.numel()  # Overlaps.


# ---------------------------------------------------------------------------
# (d) The runner's bookkeeping.


def test_runner_bookkeeping_equals_a_direct_call():
  runner = graphs.Runner('cpu')
  calls = []

  def fn(x, tree):
    calls.append(1)
    return {'sum': x * 2 + tree['y'], 'norm': x.square().sum()}, tree['y']

  x, y = torch.arange(6.0).reshape(2, 3), torch.ones(2, 3)
  first = runner('f', None, fn, (x, {'y': y}))
  direct = fn(x, {'y': y})
  assert torch.equal(first[0]['sum'], direct[0]['sum'])
  assert torch.equal(first[0]['norm'], direct[0]['norm'])
  assert torch.equal(first[1], y) and first[1] is not y
  kept = first[0]['sum'].clone()
  second = runner('f', None, fn, (x + 1, {'y': 2 * y}))
  assert torch.equal(first[0]['sum'], kept)  # Not overwritten.
  assert torch.equal(second[0]['sum'], 2 * (x + 1) + 2 * y)
  assert len(runner.captured) == 1
  runner('f', None, fn, (torch.zeros(4, 3), {'y': torch.zeros(4, 3)}))
  runner('f', None, fn, (x.double(), {'y': y.double()}))
  runner('f', 'other key', fn, (x, {'y': y}))
  assert len(runner.captured) == 4
  assert runner.stats() == {}  # No graph on the CPU.
  # The static inputs are the runner's own: a later edit of the caller's
  # tensors does not reach them.
  call = runner.get('f', None, fn, (x, {'y': y}))
  x.add_(100)
  assert call.inputs[0].max() < 100


def test_launch_credit():
  kernel = build.TritonKernel('probe', 'lambda_returns.py', 'nowhere')
  build.count(kernel)
  assert kernel.launches == 1
  assert build.take_captured() == {}  # Nothing is capturing here.
  build.credit({kernel: 3}, times=2)
  assert kernel.launches == 7


# ---------------------------------------------------------------------------
# (e) Graphed and eager agents make the same updates.


@pytest.mark.parametrize('replay', ['fixed', 'prio'])
def test_graphs_flag_gives_the_same_updates(env, replay):
  results = {}
  for flag in (False, True):
    agent = make_agent(env, replay=replay, **{'torch.graphs': flag})
    ring = make_ring(env, agent, prioritized=replay == 'prio')
    _, carry, mets = agent.train_device(ring, 2)
    _, carry, mets = agent.train_device(ring, 2, carry)
    obs = observation(env)
    _, state = agent.policy(obs)
    outs, _ = agent.policy(observation(env, seed=1), state)
    results[flag] = (state_of(agent), dict(mets), carry, outs,
                     ring.prios.clone() if ring.prioritized else None)
  eager, graphed = results[False], results[True]
  assert set(eager[0]) == set(graphed[0])
  for key in eager[0]:
    assert torch.equal(eager[0][key], graphed[0][key]), key
  assert eager[1].keys() == graphed[1].keys()
  for key in eager[1]:
    np.testing.assert_array_equal(eager[1][key], graphed[1][key], key)
  assert eager[2].keys() == graphed[2].keys()
  for key in eager[2]:
    assert torch.equal(eager[2][key], graphed[2][key]), key
  np.testing.assert_array_equal(eager[3]['action'], graphed[3]['action'])
  if replay == 'prio':
    assert torch.equal(eager[4], graphed[4])

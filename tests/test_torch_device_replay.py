"""The port's device-resident replay against the JAX package's on the same
numpy steps (ring contents, cursor and fill after wrap-around, window
weights and `prob`, rows and gathered batches, seam-free windows, the
`prio_ends` mixture), and the agent's device paths: `train_device` against
the same updates made one `train` call at a time, the prioritized ring's
write-back, the fused metric policy, and `device_feed`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import daydreamer_tpu_torch as ddp
from daydreamer_tpu.replay import device_replay as jdr
from daydreamer_tpu_torch import replay as replaylib
from daydreamer_tpu_torch.envs import load_env
from daydreamer_tpu_torch.replay import device_replay as drlib

torch.set_num_threads(1)


def make_steps(start, n, ends=()):
  steps = {
      'value': np.arange(start, start + n, dtype=np.int32),
      'image': (np.arange(start, start + n, dtype=np.uint8)[:, None, None]
                * np.ones((1, 2, 3), np.uint8)),
      'reward': np.linspace(0, 1, n).astype(np.float32),
      'is_first': np.zeros(n, bool),
      'is_last': np.zeros(n, bool)}
  steps['is_last'][list(ends)] = True
  return steps


def make_pair(total, capacity=32, chunk=4, block=8, prioritized=False,
              pieces=(5, 5, 30), ends=()):
  """The same steps added in the same pieces to a JAX ring and a port
  ring."""
  theirs = jdr.DeviceReplay(capacity, chunk, block, prioritized=prioritized)
  ours = drlib.DeviceReplay(capacity, chunk, block, device='cpu',
                            prioritized=prioritized)
  steps = make_steps(0, total, ends)
  start = 0
  sizes = list(pieces) + [total]
  for size in sizes:
    stop = min(start + size, total)
    piece = {k: v[start:stop] for k, v in steps.items()}
    theirs.add_steps(piece)
    ours.add_steps(piece)
    start = stop
  return theirs, ours


@pytest.mark.parametrize('total', [5, 13, 32, 80])
def test_ring_matches_jax(total):
  """Ring contents, cursor and fill: a partial block stays staged, and 80
  steps wrap a ring of 32 two and a half times."""
  theirs, ours = make_pair(total)
  assert (ours.filled, ours.cursor) == (theirs.filled, theirs.cursor)
  assert ours.filled == min(total // 8 * 8, 32)
  if not theirs.filled:
    assert ours.buffers is None
    return
  assert set(ours.buffers) == set(theirs.buffers)
  for key, value in theirs.buffers.items():
    np.testing.assert_array_equal(ours.buffers[key].numpy(),
                                  np.asarray(value), err_msg=key)
    assert ours.buffers[key].numpy().dtype == np.asarray(value).dtype
  assert ours.nbytes == sum(
      np.asarray(v).nbytes for v in theirs.buffers.values())


def test_ring_rejects_bad_sizes_and_keys():
  with pytest.raises(ValueError):
    drlib.DeviceReplay(30, 4, block=8, device='cpu')
  with pytest.raises(ValueError):
    drlib.DeviceReplay(8, 8, block=8, device='cpu')
  ring = drlib.DeviceReplay(32, 4, block=8, device='cpu')
  ring.add_steps(make_steps(0, 8))
  with pytest.raises(ValueError):
    ring.add_steps({'value': np.arange(8)})
  with pytest.raises(ValueError):
    ring.add_steps({'value': np.arange(8), 'is_first': np.zeros(7, bool)})


@pytest.mark.parametrize('total', [24, 80])
def test_gather_matches_jax_rows(total):
  """Rows and gathered batch for given offsets, not yet full and wrapped:
  the rows the JAX sampler takes for the same offsets (start = base +
  offset mod capacity, base the cursor once the ring is full)."""
  theirs, ours = make_pair(total)
  capacity, chunk = 32, 4
  _, span, base = drlib.valid_span(ours.state, chunk)
  assert base == (theirs.cursor if theirs.filled >= capacity else 0)
  assert span == (capacity - chunk if theirs.filled >= capacity
                  else theirs.filled - chunk)
  offset = torch.arange(span + 1)
  out, rows = drlib.gather(ours.state, offset, chunk)
  want = (base + np.arange(span + 1)[:, None] + np.arange(chunk)) % capacity
  np.testing.assert_array_equal(rows.numpy(), want)
  for key, value in theirs.buffers.items():
    expect = np.asarray(value)[want]
    if key == 'is_first':
      expect[:, 0] = True
    np.testing.assert_array_equal(out[key].numpy(), expect, err_msg=key)
  # Every window is consecutive, so none crosses the write seam, and only
  # the newest steps are left.
  assert (np.diff(out['value'].numpy(), axis=1) == 1).all()
  assert out['value'].min() == max(0, total - capacity)
  assert out['value'].max() == total - 1
  assert not ours.buffers['is_first'].any()  # The ring itself is unchanged.


@pytest.mark.parametrize('seed', range(5))
def test_sample_windows_are_seam_free(seed):
  _, ours = make_pair(80)
  gen = torch.Generator().manual_seed(seed)
  batch = drlib.sample(ours.state, gen, 16, 4)
  values = batch['value'].numpy()
  assert values.shape == (16, 4) and batch['image'].shape == (16, 4, 2, 3)
  assert (np.diff(values, axis=1) == 1).all()
  assert values.min() >= 48 and values.max() < 80
  assert batch['is_first'][:, 0].all() and not batch['is_first'][:, 1:].any()


def test_sample_covers_the_ring_and_follows_the_generator():
  _, ours = make_pair(32)
  gen = lambda seed: torch.Generator().manual_seed(seed)
  a = drlib.sample(ours.state, gen(1), 256, 4)['value']
  b = drlib.sample(ours.state, gen(1), 256, 4)['value']
  c = drlib.sample(ours.state, gen(2), 256, 4)['value']
  assert (a == b).all() and (a != c).any()
  assert len(np.unique(a[:, 0].numpy())) > 20


def test_prio_ends_share_matches_jax():
  """The share of windows that end on an episode's last step, by count
  under a fixed generator seed: within 0.03 of the mixture's mass (4096
  draws, standard deviation 0.007), as the JAX package's test holds its
  sampler, whose share under its own key is held to the same number."""
  ends = [19, 39]
  theirs, ours = make_pair(64, capacity=64, pieces=(64,), ends=ends)
  chunk, batch, prio = 4, 4096, 1.0
  span = 64 - chunk
  gate = (len(ends) * chunk * prio) / (len(ends) * chunk * prio + span + 1)
  expect = gate + (1 - gate) * len(ends) / (span + 1)
  gen = torch.Generator().manual_seed(3)
  out = drlib.sample(ours.state, gen, batch, chunk, prio_ends=prio)
  share = np.isin(out['value'][:, -1].numpy(), ends).mean()
  assert abs(share - expect) < 0.03, (share, expect)
  ref = jax.device_get(jdr.sample(
      theirs.state, jax.random.PRNGKey(3), batch, chunk, prio_ends=prio))
  assert abs(np.isin(ref['value'][:, -1], ends).mean() - expect) < 0.03
  plain = drlib.sample(ours.state, gen, batch, chunk)
  assert np.isin(plain['value'][:, -1].numpy(), ends).mean() < 0.1
  # No episode end in the span: every draw is a uniform one.
  _, none = make_pair(64, capacity=64, pieces=(64,))
  out = drlib.sample(none.state, gen, 64, chunk, prio_ends=prio)
  assert (np.diff(out['value'].numpy(), axis=1) == 1).all()


@pytest.mark.parametrize('total', [32, 80])
def test_window_weights_and_prob_match_jax(total):
  """For given priorities, the weight of every window start and the `prob`
  of the drawn ones equal the JAX sampler's, before and after the ring
  wraps (rtol 1e-4: float32 cumsums in another order)."""
  capacity, chunk, exponent, constant = 64, 4, 0.5, 0.1
  theirs, ours = make_pair(total, capacity=capacity, prioritized=True,
                           pieces=(total,))
  rng = np.random.default_rng(0)
  prios = rng.uniform(0.01, 2.0, capacity).astype(np.float32)
  prios[10] = 100.0
  theirs.prios, ours.prios = jnp.asarray(prios), torch.as_tensor(prios)
  _, span, base = drlib.valid_span(ours.state, chunk)
  weights = drlib.window_weights(
      ours.state, ours.prios, chunk, exponent, constant).numpy()
  stepw = np.abs(np.roll(prios, -base)) ** exponent + constant
  want = np.convolve(stepw, np.ones(chunk), 'valid')
  np.testing.assert_allclose(weights[:span + 1], want[:span + 1], rtol=1e-4)
  assert (weights[span + 1:] == 0).all()
  ref, ref_rows = jdr.sample_prioritized(
      theirs.state, theirs.prios, jax.random.PRNGKey(0), 16, chunk, exponent,
      constant)
  offsets = (np.asarray(ref_rows[:, 0]) - base) % capacity
  np.testing.assert_allclose(
      weights[offsets] / weights.sum(), np.asarray(ref['prob'][:, 0]),
      rtol=1e-4)
  out, rows = drlib.sample_prioritized(
      ours.state, ours.prios, torch.Generator().manual_seed(0), 16, chunk,
      exponent, constant)
  offsets = (rows[:, 0].numpy() - base) % capacity
  assert (offsets <= span).all()
  np.testing.assert_allclose(
      out['prob'].numpy(),
      np.broadcast_to((weights[offsets] / weights.sum())[:, None], (16, 4)),
      rtol=1e-6)
  np.testing.assert_array_equal(
      out['value'].numpy(), ours.buffers['value'].numpy()[rows.numpy()])
  assert out['is_first'][:, 0].all()


def test_prioritized_draws_follow_the_weights():
  """The share of draws that cover a hot step is the weights' share (3200
  draws, tolerance 0.05 as the JAX package's test), and unseen steps are
  drawn first."""
  capacity, chunk = 64, 4
  _, ours = make_pair(32, capacity=capacity, prioritized=True, pieces=(32,))
  assert (ours.prios[:32] == drlib.UNSEEN_PRIORITY).all()
  assert (ours.prios[32:] == 0).all()
  prios = np.zeros(capacity, np.float32)
  prios[:32] = 0.01
  prios[10] = 100.0
  ours.prios = torch.as_tensor(prios)
  weights = np.convolve(np.abs(prios[:32]) ** 0.5, np.ones(chunk), 'valid')
  gen = torch.Generator().manual_seed(0)
  starts = torch.cat([
      drlib.sample_prioritized(ours.state, ours.prios, gen, 16, chunk)[1][:, 0]
      for _ in range(200)]).numpy()
  hot = ((starts >= 7) & (starts <= 10)).mean()
  assert abs(hot - weights[7:11].sum() / weights.sum()) < 0.05
  prios[:24], prios[24:32] = 1e-4, drlib.UNSEEN_PRIORITY
  ours.prios = torch.as_tensor(prios)
  _, rows = drlib.sample_prioritized(ours.state, ours.prios, gen, 32, chunk)
  assert (rows[:, 0].numpy() >= 21).mean() > 0.95


# ---------------------------------------------------------------------------
# The agent's device paths.


def make_config(**kw):
  from daydreamer_tpu_torch.agents.dreamer import Agent
  config = ddp.Config(Agent.configs['defaults'])
  config = config.update(Agent.configs['debug'])
  return config.update({
      'task': 'dummy_discrete', 'torch.device': 'cpu', 'batch_size': 4,
      'replay_chunk': 6, 'imag_horizon': 2, 'env.amount': 1,
      'env.length': 10, 'env.parallel': 'none', **kw})


@pytest.fixture(scope='module')
def env():
  env = load_env('dummy_discrete', amount=1, parallel='none', length=10)
  yield env
  env.close()


def make_agent(env, **kw):
  from daydreamer_tpu_torch.agents.dreamer import Agent
  return Agent(env.obs_space, env.act_space, ddp.Counter(), make_config(**kw))


def fill(env, agent, steps=40):
  """A host replay prefilled with random actions and its mirror on the
  agent's device; the same steps on every call."""
  np.random.seed(0)
  fixed = replaylib.FixedLength(replaylib.RAMStore(int(1e4)), chunk=6)
  driver = ddp.Driver(env)
  driver.on_step(fixed.add)
  driver(ddp.RandomAgent(env.act_space).policy, steps=steps)
  ring = agent.make_device_replay(capacity=128, block=8)
  mirror = drlib.StoreMirror(fixed, ring)
  return fixed, driver, ring, mirror


def state_of(agent):
  return {k: v.detach().clone() for k, v in ddp.nn.state(agent.agent).items()}


def assert_same_state(a, b):
  assert set(a) == set(b)
  for key in a:
    np.testing.assert_allclose(
        a[key].float().numpy(), b[key].float().numpy(), atol=1e-6,
        err_msg=key)


def test_store_mirror_is_incremental(env):
  agent = make_agent(env)
  fixed, driver, ring, mirror = fill(env, agent, steps=44)
  assert mirror.sync() > 0 and ring.filled > 0
  assert mirror.sync() == 0  # No new trajectories.
  driver(ddp.RandomAgent(env.act_space).policy, steps=22)
  assert mirror.sync() > 0
  assert 'is_first' in ring.buffers
  assert not any(k.startswith('log_') for k in ring.buffers)
  assert all(v.device.type == 'cpu' for v in ring.buffers.values())


def test_make_device_replay_follows_the_config(env):
  agent = make_agent(env)
  ring = agent.make_device_replay(capacity=100)
  assert (ring.capacity, ring.chunk, ring.block) == (102, 6, 6)
  assert not ring.prioritized and ring.device == agent.device
  assert agent.make_device_replay(capacity=3, block=8).capacity == 16
  assert make_agent(env, replay='prio').make_device_replay(64).prioritized


@pytest.mark.parametrize('replay', ['fixed', 'prio'])
def test_train_device_equals_train_calls(env, replay):
  """K updates of `train_device` are K `train` calls on the batches that
  the same generator state samples, with the priorities written back
  between them on the prioritized ring."""
  steps = 3
  agents = [make_agent(env, replay=replay) for _ in range(2)]
  rings = []
  for agent in agents:
    _, _, ring, mirror = fill(env, agent)
    mirror.sync()
    rings.append(ring)
  first, second = agents
  for agent in agents:
    agent._create()  # The creation pass draws from the generator too.
  assert first.generator.get_state().equal(second.generator.get_state())
  outs, state, mets = first.train_device(rings[0], steps)
  assert outs == {} and np.isfinite(mets['model_loss_mean'])
  config = second.config
  carry = None
  losses = []
  for _ in range(steps):
    if replay == 'prio':
      batch, rows = drlib.sample_prioritized(
          rings[1].state, rings[1].prios, second.generator,
          config.batch_size, config.replay_chunk,
          config.replay_prio.exponent, config.replay_prio.constant)
    else:
      batch = drlib.sample(
          rings[1].state, second.generator, config.batch_size,
          config.replay_chunk, config.replay_fixed.prio_ends)
    outs, carry, step_mets = second.train(batch, carry)
    losses.append(step_mets['model_loss_mean'])
    if replay == 'prio':
      rings[1].prios[rows.reshape(-1)] = torch.as_tensor(
          outs['priority']).float().reshape(-1)
  assert_same_state(state_of(first), state_of(second))
  np.testing.assert_allclose(mets['model_loss_mean'], np.mean(losses),
                             rtol=1e-6)
  if replay == 'prio':
    np.testing.assert_allclose(rings[0].prios.numpy(), rings[1].prios.numpy())
    prios = rings[0].prios[:rings[0].filled]
    assert (prios != drlib.UNSEEN_PRIORITY).any()
    assert torch.isfinite(rings[0].prios).all()


def test_train_device_checks_the_ring(env):
  agent = make_agent(env)
  with pytest.raises(ValueError, match='under one chunk'):
    agent.train_device(agent.make_device_replay(capacity=64), 1)
  ring = drlib.DeviceReplay(64, 4, block=8, device='cpu')
  ring.add_steps(make_steps(0, 16))
  with pytest.raises(ValueError, match='chunk'):
    agent.train_device(ring, 1)


def test_fused_metrics_last_matches_all(env):
  """`torch.fused_metrics: last` trains as `all` does (packing metrics
  only observes) and reports the last update's metrics, not their mean."""
  results = {}
  for mode in ('all', 'last'):
    agent = make_agent(env, **{'torch.fused_metrics': mode})
    _, _, ring, mirror = fill(env, agent)
    mirror.sync()
    _, _, mets = agent.train_device(ring, 3)
    results[mode] = (state_of(agent), mets)
  assert_same_state(results['all'][0], results['last'][0])
  assert results['last'][1]._packed.shape[0] == 1
  assert results['all'][1]._packed.shape[0] == 3
  last = results['all'][1]._packed[-1].numpy()
  np.testing.assert_allclose(results['last'][1]._packed[0].numpy(), last)
  with pytest.raises(ValueError, match='fused_metrics'):
    make_agent(env, **{'torch.fused_metrics': 'none'})


def test_device_feed_groups_match_lists(env):
  """`device_feed` stacks `steps` batches into one Prestacked group, and
  `train_multi` on it makes the updates it makes on the list."""
  first, second = make_agent(env), make_agent(env)
  fixed, _, _, _ = fill(env, first)

  def batches():
    source = fixed.dataset()
    while True:
      rows = [next(source) for _ in range(4)]
      yield {k: np.stack([r[k] for r in rows]) for k in rows[0]}

  taken = []

  def recorded():
    for batch in batches():
      taken.append(batch)
      yield batch

  feed = first.device_feed(recorded(), 2)
  group = next(feed)
  assert group.steps == 2 and len(taken) == 4  # One group ahead.
  assert all(v.shape[:2] == (2, 4) for v in group.data.values())
  assert not any(k.startswith('log_') or k == 'key' for k in group.data)
  outs, _, mets = first.train_multi(group)
  outs2, _, mets2 = second.train_multi(taken[:2])
  assert_same_state(state_of(first), state_of(second))
  np.testing.assert_allclose(mets['model_loss_mean'],
                             mets2['model_loss_mean'], rtol=1e-6)
  assert set(outs) == set(outs2)

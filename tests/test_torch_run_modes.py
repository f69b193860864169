"""The port's other run modes on the CPU at the debug widths on
dummy_discrete: `learning` from a prefilled replay with `train_fused=2`
(host feed, device ring, prioritized device ring), `train_eval`,
`train_fixed_eval`, the CLI's `learner_addr` parsing, and the actor/learner
pair over ZMQ in two threads, as tests/test_run_modes.py and
tests/test_async.py drive the JAX package."""

import contextlib
import io
import json
import socket
import threading

import numpy as np
import pytest
import torch

import daydreamer_tpu_torch as ddp
from daydreamer_tpu_torch import replay as replaylib
from daydreamer_tpu_torch import run as runlib
from daydreamer_tpu_torch.envs import load_env

torch.set_num_threads(1)


def make_config(tmp_path, **overrides):
  from daydreamer_tpu_torch.agents.dreamer import Agent
  config = ddp.Config(Agent.configs['defaults'])
  config = config.update(Agent.configs['debug'])
  return config.update({
      'task': 'dummy_discrete', 'torch.device': 'cpu', 'batch_size': 4,
      'replay_chunk': 8, 'imag_horizon': 3, 'env.amount': 1,
      'env.length': 10, 'env.parallel': 'none', 'logdir': str(tmp_path),
      **overrides})


def build(tmp_path, **overrides):
  from daydreamer_tpu_torch.agents.dreamer import Agent
  config = make_config(tmp_path, **overrides)
  env = load_env(config.task, mode='train', **config.env)
  step = ddp.Counter()
  agent = Agent(env.obs_space, env.act_space, step, config)
  logger = ddp.Logger(step, [ddp.JSONLOutput(str(tmp_path))])
  return config, env, agent, step, logger


def read_metrics(tmp_path):
  path = tmp_path / 'metrics.jsonl'
  return [json.loads(line) for line in path.read_text().splitlines()]


def free_port():
  with socket.socket() as s:
    s.bind(('', 0))
    return s.getsockname()[1]


def make_fixed(config):
  return replaylib.FixedLength(
      replaylib.RAMStore(int(1e5)), chunk=config.replay_chunk)


def test_train_eval(tmp_path):
  config, env, agent, step, logger = build(tmp_path)
  eval_env = load_env(config.task, mode='eval', **config.env)
  args = ddp.Config(logdir=str(tmp_path), **config.train).update(
      steps=60, train_fill=30, eval_fill=30, train_every=10, log_every=20,
      eval_every=30, eval_eps=1, eval_samples=1)
  runlib.train_eval(
      agent, env, eval_env, make_fixed(config), make_fixed(config), logger,
      args)
  rows = read_metrics(tmp_path)
  assert int(step) >= 60
  assert [r for r in rows if any(k.startswith('train_episode') for k in r)]
  assert [r for r in rows if 'eval_episode/score' in r]
  env.close()
  eval_env.close()


def test_train_fixed_eval(tmp_path):
  config, env, agent, step, logger = build(tmp_path)
  args = ddp.Config(logdir=str(tmp_path), **config.train).update(
      steps=60, train_fill=30, eval_fill=16, train_every=10, log_every=20,
      eval_every=30, eval_samples=1)
  runlib.train_fixed_eval(
      agent, env, make_fixed(config), make_fixed(config), logger, args)
  rows = read_metrics(tmp_path)
  assert int(step) >= 60
  assert [r for r in rows if any('eval' in k for k in r)]
  env.close()


def _learn(tmp_path, replay_kind=None, **train):
  """run=learning for 4 updates from a replay prefilled in process.
  Returns what it printed."""
  overrides = {'replay': replay_kind} if replay_kind else {}
  config, env, agent, step, logger = build(tmp_path, **overrides)
  store = replaylib.Stats(replaylib.RAMStore(int(1e5)))
  if replay_kind == 'prio':
    train_replay = replaylib.Prioritized(
        store, config.replay_chunk, **config.replay_prio)
  else:
    train_replay = replaylib.FixedLength(store, chunk=config.replay_chunk)
  driver = ddp.Driver(env)
  driver.on_step(train_replay.add)
  driver(ddp.RandomAgent(env.act_space).policy, steps=40)
  # The learner's first eval fires immediately; give the eval replay data
  # so its dataset never blocks.
  eval_replay = make_fixed(config)
  eval_driver = ddp.Driver(env)
  eval_driver.on_step(eval_replay.add)
  eval_driver(ddp.RandomAgent(env.act_space).policy, steps=25)
  args = ddp.Config(
      logdir=str(tmp_path), **config.train, batch_size=config.batch_size,
      replay_chunk=config.replay_chunk).update(
      steps=4, train_fill=20, sync_every=300, log_every=300, eval_every=300,
      eval_samples=1, train_fused=2, **train)
  out = io.StringIO()
  with contextlib.redirect_stdout(out):
    runlib.learning(agent, train_replay, eval_replay, logger, args)
  assert int(step) >= 4
  assert (tmp_path / 'agent.pkl').exists()
  rows = read_metrics(tmp_path)
  losses = [v for r in rows for k, v in r.items()
            if k in ('train/model_opt_loss', 'train/actor_opt_loss')]
  assert losses and all(np.isfinite(v) for v in losses), rows
  env.close()
  return out.getvalue()


def test_learning_fused_host_feed(tmp_path):
  """train_fused > 1 without the device ring: `device_feed` groups the
  host batches and `train_multi` takes them."""
  printed = _learn(tmp_path, device_replay=False)
  assert 'Device-resident replay engaged' not in printed


def test_learning_device_replay(tmp_path):
  """The device path must ENGAGE for uniform replays (the JAX package's
  regression: a hasattr check on the universal no-op Replay.prioritize
  once disabled it for every uniform config)."""
  printed = _learn(tmp_path, device_replay=True, device_replay_steps=200)
  assert 'Device-resident replay engaged' in printed
  assert 'falling back to host sampling' not in printed


def test_learning_device_replay_prioritized(tmp_path):
  printed = _learn(tmp_path, replay_kind='prio', device_replay=True,
                   device_replay_steps=200)
  assert 'Prioritized replay runs DEVICE-SIDE' in printed
  assert 'Device-resident replay engaged' in printed


def test_cli_async_dispatch_parses_learner_addr(tmp_path, monkeypatch):
  """The learning/acting CLI branches read --learner_addr from the OUTER
  flag parser (it is not a config key)."""
  from daydreamer_tpu_torch.agents.dreamer import train as train_cli
  calls = {}
  monkeypatch.setattr(
      ddp.run, 'learning',
      lambda agent, replay, eval_replay, logger, args: calls.setdefault(
          'learning', replay))
  monkeypatch.setattr(
      ddp.run, 'acting',
      lambda agent, env, replay, logger, outdir, args: calls.setdefault(
          'acting', replay))
  common = ['--configs', 'debug', '--task', 'dummy_discrete',
            '--torch.device', 'cpu', '--env.parallel', 'none']
  port = free_port()
  train_cli.main(common + [
      '--run', 'learning', '--logdir', str(tmp_path / 'learn'),
      '--learner_addr', f'localhost:{port}'])
  assert isinstance(calls['learning'].store, replaylib.StoreServer)
  train_cli.main(common + [
      '--run', 'acting', '--logdir', str(tmp_path / 'act'),
      '--learner_addr', f'localhost:{port}'])
  assert isinstance(calls['acting'].store, replaylib.StoreClient)
  calls['learning'].store.close()


def test_cli_learning_from_saved_episodes(tmp_path, capsys):
  """`--run learning` through the CLI: it loads the episodes that a
  `--run train` left in the logdir, serves its store on the port of
  `--learner_addr`, engages the device ring and trains from it."""
  from daydreamer_tpu_torch.agents.dreamer import train as train_cli
  common = ['--configs', 'debug', '--task', 'dummy_discrete',
            '--torch.device', 'cpu', '--env.parallel', 'none',
            '--env.length', '50', '--logdir', str(tmp_path)]
  train_cli.main(common + [
      '--run', 'train', '--train.train_fill', '60', '--train.steps', '64',
      '--train.log_every', '1000', '--train.eval_every', '1000'])
  assert list((tmp_path / 'episodes').glob('*.npz'))
  capsys.readouterr()
  train_cli.main(common + [
      '--run', 'learning', '--train.train_fill', '30', '--train.steps', '4',
      '--train.train_fused', '2', '--train.device_replay_steps', '256',
      '--train.sync_every', '300', '--learner_addr',
      f'localhost:{free_port()}'])
  printed = capsys.readouterr().out
  assert 'Trajectory store serving' in printed
  assert 'Device-resident replay engaged' in printed
  assert (tmp_path / 'agent.pkl').exists()
  assert (tmp_path / 'learner.pkl').exists()
  losses = [v for row in read_metrics(tmp_path)
            for k, v in row.items() if k == 'train/model_opt_loss']
  assert losses and all(np.isfinite(v) for v in losses)


def test_cli_rejects_unknown_run_mode(tmp_path):
  from daydreamer_tpu_torch.agents.dreamer import train as train_cli
  with pytest.raises(NotImplementedError):
    train_cli.main([
        '--configs', 'debug', '--task', 'dummy_discrete', '--torch.device',
        'cpu', '--env.parallel', 'none', '--run', 'nothing', '--logdir',
        str(tmp_path)])


def test_actor_learner_pair(tmp_path):
  """Episodes flow to the learner over ZMQ, weights flow back through the
  checkpoint files, and `run.acting` drives the actor's side."""
  from daydreamer_tpu_torch.agents.dreamer import Agent
  port = free_port()
  config = make_config(tmp_path, batch_size=8)
  args = ddp.Config(
      logdir=str(tmp_path), **config.train, batch_size=config.batch_size,
      replay_chunk=config.replay_chunk).update({
          'steps': 4, 'train_fill': 30, 'sync_every': 30, 'log_every': 1000,
          'eval_every': 1000, 'eval_samples': 1, 'train_fused': 2,
          'device_replay_steps': 200})

  # Learner side: server store + agent training loop.
  learner_store = replaylib.Stats(replaylib.RAMStore())
  server = replaylib.StoreServer(learner_store, port)
  train_replay = replaylib.FixedLength(learner_store, 8)
  eval_replay = replaylib.FixedLength(replaylib.RAMStore(), 8)
  env = load_env('dummy_discrete', amount=1, parallel='none', length=10)
  eval_driver = ddp.Driver(env)
  eval_driver.on_step(eval_replay.add)
  eval_driver(ddp.RandomAgent(env.act_space).policy, steps=25)
  learner_agent = Agent(env.obs_space, env.act_space, ddp.Counter(), config)
  logger = ddp.Logger(ddp.Counter(), [])
  errors = []

  def learner():
    try:
      with contextlib.redirect_stdout(io.StringIO()):
        ddp.run.learning(
            learner_agent, train_replay, eval_replay, logger, args)
    except Exception as e:  # Reported by the assertion below.
      errors.append(e)

  thread = threading.Thread(target=learner, daemon=True)
  thread.start()

  # Actor side: `run.acting` prefills through the ZMQ client, waits for the
  # learner's first checkpoint, loads it and acts with the policy.
  client = replaylib.StoreClient(f'localhost:{port}')
  actor_replay = replaylib.FixedLength(client, 8)
  actor_env = load_env(
      'dummy_discrete', amount=1, parallel='none', length=10)
  actor_step = ddp.Counter()
  actor_agent = Agent(
      actor_env.obs_space, actor_env.act_space, actor_step, config)
  actor_logger = ddp.Logger(actor_step, [])
  actor_args = args.update({'steps': 160, 'train_fill': 60})
  ddp.run.acting(
      actor_agent, actor_env, actor_replay, actor_logger,
      tmp_path / 'worker0', actor_args)

  thread.join(timeout=300)
  assert not thread.is_alive(), 'learner did not finish'
  assert not errors, errors
  assert int(actor_step) >= 160
  assert (tmp_path / 'agent.pkl').exists()
  assert (tmp_path / 'policy.pkl').exists()
  assert (tmp_path / 'worker0' / 'actor.pkl').exists()
  # The policy snapshot is a strict subset that merges into a live state.
  fresh = Agent(
      actor_env.obs_space, actor_env.act_space, ddp.Counter(), config)
  for name in ('agent.pkl', 'policy.pkl'):
    cp = ddp.Checkpoint(str(tmp_path / name), log=False)
    cp.agent = fresh
    assert cp.load() >= 0
  obs = {k: np.zeros((1,) + v.shape, v.dtype)
         for k, v in actor_env.obs_space.items()}
  acts, _ = fresh.policy(obs)
  assert acts['action'].shape[0] == 1
  server.close()
  env.close()
  actor_env.close()

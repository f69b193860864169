"""CLI entry point of the port: config merge, logger, env/agent/replay
build, run-mode dispatch (the port of `daydreamer_tpu/agents/dreamer/
train.py`; reference: embodied/agents/dreamerv2plus/train.py:22-146).

Usage:
  python -m daydreamer_tpu_torch.agents.dreamer.train --configs xarm \
      --rssm.impl scan --imag_impl pallas --run train --logdir ~/logdir/run1

The agent runs on the card; `--torch.device cpu` runs it on the CPU. The
run modes are those of the JAX package: `train`, `train_eval`,
`train_fixed_eval`, and the asynchronous pair `learning` (the learner,
which serves its replay on the port of `--learner_addr`) and `acting` (an
actor, which sends its episodes there).
"""

import daydreamer_tpu_torch as embodied
from daydreamer_tpu_torch import envs as envslib
from daydreamer_tpu_torch import replay as replaylib


def main(argv=None):
  from .agent import Agent
  parsed, other = embodied.Flags(
      configs=['defaults'], worker=0, workers=1, learner_addr='localhost:2222',
  ).parse_known(argv)
  config = embodied.Config(Agent.configs['defaults'])
  for name in parsed.configs:
    config = config.update(Agent.configs[name])
  config = embodied.Flags(config).parse(other)
  if config.torch.threads:
    import torch
    torch.set_num_threads(config.torch.threads)
  args = embodied.Config(
      logdir=config.logdir,
      **config.train,
      batch_size=config.batch_size,
      replay_chunk=config.replay_chunk)
  print(config)

  logdir = embodied.Path(config.logdir)
  step = embodied.Counter()
  logger = make_logger(config, step)
  # Persist the exact resolved config for provenance.
  if str(logdir) not in ('/dev/null', ''):
    logdir.mkdirs()
    config.save(str(logdir / 'config.yaml'))

  cleanup = []
  try:
    config = config.update({'env.seed': hash((config.seed, parsed.worker))})
    env = envslib.load_env(config.task, mode='train', **config.env)
    cleanup.append(env)
    agent = Agent(env.obs_space, env.act_space, step, config)

    if config.run == 'train':
      replay = make_replay(config, logdir / 'episodes')
      embodied.run.train(agent, env, replay, logger, args)

    elif config.run == 'train_eval':
      replay = make_replay(config, logdir / 'episodes')
      eval_replay = make_replay(config, logdir / 'eval_episodes', is_eval=True)
      eval_env = envslib.load_env(config.task, mode='eval', **config.env)
      cleanup.append(eval_env)
      embodied.run.train_eval(
          agent, env, eval_env, replay, eval_replay, logger, args)

    elif config.run == 'train_fixed_eval':
      replay = make_replay(config, logdir / 'episodes')
      if config.eval_dir:
        assert not config.train.eval_fill
        eval_replay = make_replay(config, config.eval_dir, is_eval=True)
      else:
        assert config.train.eval_fill
        eval_replay = make_replay(config, logdir / 'eval_episodes',
                                  is_eval=True)
      embodied.run.train_fixed_eval(
          agent, env, replay, eval_replay, logger, args)

    elif config.run == 'learning':
      env.close()
      port = parsed.learner_addr.split(':')[-1]
      replay = make_replay(config, logdir / 'episodes', server_port=port)
      eval_replay = make_replay(config, logdir / 'eval_episodes',
                                is_eval=True)
      embodied.run.learning(agent, replay, eval_replay, logger, args)

    elif config.run == 'acting':
      replay = make_replay(
          config, logdir / 'episodes', remote_addr=parsed.learner_addr)
      outdir = logdir / f'worker{parsed.worker}'
      embodied.run.acting(agent, env, replay, logger, outdir, args)

    else:
      raise NotImplementedError(config.run)
  finally:
    for obj in cleanup:
      try:
        obj.close()
      except Exception:
        pass


def make_logger(config, step):
  logdir = embodied.Path(config.logdir)
  multiplier = config.env.repeat
  outputs = [
      embodied.TerminalOutput(config.filter),
      embodied.JSONLOutput(logdir, 'metrics.jsonl'),
      embodied.JSONLOutput(logdir, 'scores.jsonl', 'episode/score'),
      embodied.TensorBoardOutput(logdir),
  ]
  return embodied.Logger(step, outputs, multiplier)


def make_replay(
    config, directory=None, is_eval=False, server_port=None,
    remote_addr=None, **kwargs):
  """Store + sampler factory (reference: train.py:111-146)."""
  length = config.replay_chunk
  size = config.replay_size // 10 if is_eval else config.replay_size
  if remote_addr:
    store = replaylib.StoreClient(remote_addr)
  else:
    if directory and str(directory) != '/dev/null':
      store = replaylib.CkptRAMStore(directory, int(size), parallel=True)
    else:
      store = replaylib.RAMStore(int(size))
    store = replaylib.Stats(store)
    if server_port:
      store = replaylib.StoreServer(store, int(server_port))
  if config.replay == 'fixed' or is_eval:
    kw = dict(config.replay_fixed)
    kw.update(kwargs)
    replay = replaylib.FixedLength(store, length, **kw)
  elif config.replay == 'consec':
    kw = dict(config.replay_consec)
    kw.update(kwargs)
    replay = replaylib.Consecutive(store, length, **kw)
  elif config.replay == 'prio':
    kw = dict(config.replay_prio)
    kw.update(kwargs)
    replay = replaylib.Prioritized(store, length, **kw)
  else:
    raise NotImplementedError(config.replay)
  return replay


if __name__ == '__main__':
  main()

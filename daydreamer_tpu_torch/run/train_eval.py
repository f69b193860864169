"""Run mode with a separate eval env: eval episodes between train bursts.

Capability parity with the reference loop (reference:
embodied/run/train_eval.py:9-121): distinct train/eval envs and replays,
eval episodes collected with the deterministic policy before every train
burst, and an eval report section next to the train metrics.
"""

from .. import core
from ..core import when as whenlib
from .common import EpisodeReporter, UpdateLoop, fill_replay


def train_eval(
    agent, train_env, eval_env, train_replay, eval_replay, logger, args):
  logdir = core.Path(args.logdir)
  logdir.mkdirs()
  print('Logdir', logdir)
  step = logger.step

  timer = core.Timer()
  timer.wrap('agent', agent, ['policy', 'train', 'report', 'save'])
  timer.wrap('env', train_env, ['step'])
  if hasattr(train_replay, '_sample'):
    timer.wrap('replay', train_replay, ['_sample'])

  should_train = whenlib.Every(args.train_every)
  should_log = whenlib.Every(args.log_every)
  should_expl = whenlib.Until(args.expl_until)

  reporter = EpisodeReporter(logger, args, step)
  collect = core.Driver(train_env)
  collect.on_episode(reporter.callback(
      train_replay, whenlib.Every(args.eval_every),
      section='train_episode', logs_section='train_logs',
      label='Train episode'))
  collect.on_step(lambda tran, _: step.increment())
  collect.on_step(train_replay.add)

  evaluate = core.Driver(eval_env)
  evaluate.on_episode(reporter.callback(
      eval_replay, whenlib.Every(args.eval_every),
      section='eval_episode', logs_section='eval_logs',
      label='Eval episode'))
  evaluate.on_step(eval_replay.add)

  fill_replay(evaluate, eval_env.act_space, eval_replay,
              args.eval_fill, 'eval')
  fill_replay(collect, train_env.act_space, train_replay,
              args.train_fill, 'train')

  loop = UpdateLoop(agent, train_replay, args)
  loop.pretrain(args.pretrain)
  eval_dataset = iter(agent.dataset(eval_replay.dataset))

  def on_step(tran, worker):
    del tran, worker
    if should_train(step):
      loop.updates(args.train_steps)
    if should_log(step):
      loop.flush(logger, reports=[
          ('report', loop.last_batch), ('eval', next(eval_dataset))])
      logger.add(timer.stats(), prefix='timer')
      logger.write(fps=True)

  collect.on_step(on_step)

  checkpoint = core.Checkpoint(logdir / 'checkpoint.pkl')
  checkpoint.step = step
  checkpoint.agent = agent
  checkpoint.train_replay = train_replay
  checkpoint.eval_replay = eval_replay
  checkpoint.load_or_save()

  print('Start training loop.')
  train_policy = lambda *call: agent.policy(
      *call, mode='explore' if should_expl(step) else 'train')
  eval_policy = lambda *call: agent.policy(*call, mode='eval')
  try:
    while step < args.steps:
      logger.write()
      evaluate.reset()
      evaluate(eval_policy, episodes=max(len(eval_env), args.eval_eps))
      collect(train_policy, steps=args.eval_every)
      checkpoint.save()
  finally:
    # Join loader threads on the exception path too.
    loop.close()
    getattr(eval_dataset, 'close', lambda: None)()

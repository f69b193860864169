"""Run mode scoring a fixed eval dataset via agent.report.

Capability parity with the reference loop (reference:
embodied/run/train_fixed_eval.py:9-122): a one-time random prefill builds a
frozen eval replay (or it is loaded from ``eval_dir``) and every log period
reports world-model metrics on batches drawn from it.
"""

from .. import core
from ..core import when as whenlib
from .common import EpisodeReporter, UpdateLoop, fill_replay


def train_fixed_eval(agent, env, train_replay, eval_replay, logger, args):
  logdir = core.Path(args.logdir)
  logdir.mkdirs()
  print('Logdir', logdir)
  step = logger.step

  timer = core.Timer()
  timer.wrap('agent', agent, ['policy', 'train', 'report', 'save'])
  timer.wrap('env', env, ['step'])
  if hasattr(train_replay, '_sample'):
    timer.wrap('replay', train_replay, ['_sample'])

  should_train = whenlib.Every(args.train_every)
  should_log = whenlib.Every(args.log_every)
  should_expl = whenlib.Until(args.expl_until)

  if max(0, int(args.eval_fill) - len(eval_replay)):
    seeder = core.Driver(env)
    seeder.on_step(eval_replay.add)
    fill_replay(seeder, env.act_space, eval_replay, args.eval_fill, 'eval')
    del seeder

  reporter = EpisodeReporter(logger, args, step)
  driver = core.Driver(env)
  driver.on_episode(
      reporter.callback(train_replay, whenlib.Every(args.eval_every)))
  driver.on_step(lambda tran, _: step.increment())
  driver.on_step(train_replay.add)
  fill_replay(driver, env.act_space, train_replay, args.train_fill, 'train')

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

  driver.on_step(on_step)

  checkpoint = core.Checkpoint(logdir / 'checkpoint.pkl')
  checkpoint.step = step
  checkpoint.agent = agent
  checkpoint.train_replay = train_replay
  checkpoint.eval_replay = eval_replay
  checkpoint.load_or_save()

  print('Start training loop.')
  policy = lambda *call: agent.policy(
      *call, mode='explore' if should_expl(step) else 'train')
  try:
    while step < args.steps:
      logger.write()
      driver(policy, steps=args.eval_every)
      checkpoint.save()
  finally:
    # Join loader threads on the exception path too.
    loop.close()
    getattr(eval_dataset, 'close', lambda: None)()

"""Single-process run mode: env collection with interleaved training.

Capability parity with the reference loop (reference:
embodied/run/train.py:9-103): random prefill, pretrain to build variables,
per-episode metrics, a train burst every ``train_every`` env steps with
TBPTT state threading, and periodic checkpoints. Fused multi-update
dispatch (K gradient steps per device call) engages when the agent
supports it and ``train_fused`` > 1.
"""

from .. import core
from ..core import when as whenlib
from .common import EpisodeReporter, UpdateLoop, fill_replay


def train(agent, env, replay, logger, args):
  logdir = core.Path(args.logdir)
  logdir.mkdirs()
  print('Logdir', logdir)
  step = logger.step

  timer = core.Timer()
  timer.wrap('agent', agent, ['policy', 'train', 'report', 'save'])
  timer.wrap('env', env, ['step'])
  if hasattr(replay, '_sample'):
    timer.wrap('replay', replay, ['_sample'])

  should_train = whenlib.Every(args.train_every)
  should_log = whenlib.Every(args.log_every)
  should_expl = whenlib.Until(args.expl_until)

  reporter = EpisodeReporter(logger, args, step)
  driver = core.Driver(env)
  driver.on_episode(
      reporter.callback(replay, whenlib.Every(args.eval_every)))
  driver.on_step(lambda tran, _: step.increment())
  driver.on_step(replay.add)

  fill_replay(driver, env.act_space, replay, args.train_fill, 'train')
  if not len(replay):
    # Loud diagnosis for silent starvation: every collected trajectory was
    # rejected (e.g. episodes shorter than replay_chunk), so training would
    # wait forever while collection continues happily.
    print('WARNING: replay is empty after prefill; if episodes are '
          'shorter than replay_chunk they are skipped at insert time.')

  loop = UpdateLoop(agent, replay, args)
  loop.pretrain(args.pretrain)

  def on_step(tran, worker):
    del tran, worker
    if should_train(step):
      loop.updates(args.train_steps)
    if should_log(step):
      loop.flush(logger, reports=[('report', loop.last_batch)])
      logger.add(timer.stats(), prefix='timer')
      logger.write(fps=True)

  driver.on_step(on_step)

  checkpoint = core.Checkpoint(logdir / 'checkpoint.pkl')
  checkpoint.step = step
  checkpoint.agent = agent
  checkpoint.replay = replay
  checkpoint.load_or_save()

  print('Start training loop.')
  policy = lambda *call: agent.policy(
      *call, mode='explore' if should_expl(step) else 'train')
  try:
    while step < args.steps:
      driver(policy, steps=args.eval_every)
      checkpoint.save()
  finally:
    # Join loader threads on the exception path too; leaked Prefetch
    # workers race with later in-process work (e.g. GL context creation).
    loop.close()

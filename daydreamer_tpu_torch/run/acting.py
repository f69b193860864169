"""Actor half of the async pair (reference: embodied/run/acting.py:8-98).

Drives the (real-robot) env with the current policy, pushes completed
episodes to the learner over the replay's ZMQ client, and periodically
re-subscribes to the learner's published weights. Episode logging and the
random prefill are shared with the synchronous modes via ``run.common``.
"""

import time

import numpy as np

from .. import core
from ..core import when as whenlib
from .common import EpisodeReporter


class WeightSubscriber:
  """Pulls learner-published weights from a shared-filesystem checkpoint.

  The learner writes `agent.pkl` every `sync_every` wall seconds; the actor
  polls it on the same clock. Loads are retried with jittered backoff
  because the file may be mid-write on non-atomic filesystems (e.g. gs://),
  and the checkpoint age is logged so stale weights are visible in metrics.
  """

  RETRIES = 10

  def __init__(self, agent, logdir, logger):
    # Learners that support policy-subset snapshots publish policy.pkl on
    # the fast sync clock (the full agent.pkl goes on a 10x slower clock
    # for crash-resume); the actor prefers the fast channel when present.
    self._policy_cp = core.Checkpoint(core.Path(logdir) / 'policy.pkl')
    self._policy_cp.agent = agent
    self._full_cp = core.Checkpoint(core.Path(logdir) / 'agent.pkl')
    self._full_cp.agent = agent
    self._logger = logger

  def _pick(self):
    return self._policy_cp if self._policy_cp.exists() else self._full_cp

  def refresh(self):
    print('Syncing.')
    while not (self._policy_cp.exists() or self._full_cp.exists()):
      print('Waiting for agent checkpoint to be created.')
      time.sleep(10)
    last_error = None
    for _ in range(self.RETRIES):
      try:
        age = self._pick().load()
        if age is not None:
          self._logger.scalar('agent_cp_age', age)
        return
      except Exception as e:
        last_error = e
        print(f'Could not load checkpoint: {e}')
        time.sleep(np.random.uniform(1, 5))
    raise RuntimeError(f'Failed to load checkpoint: {last_error}')


def acting(agent, env, replay, logger, actordir, args):
  logdir = core.Path(args.logdir)
  logdir.mkdirs()
  print('Logdir:', logdir)
  actordir = core.Path(actordir)
  actordir.mkdirs()
  step = logger.step

  timer = core.Timer()
  timer.wrap('agent', agent, ['policy'])
  timer.wrap('env', env, ['step'])

  reporter = EpisodeReporter(logger, args, step)
  on_episode = reporter.callback(replay, whenlib.Every(args.eval_every))

  driver = core.Driver(env)
  driver.on_episode(lambda ep, worker: on_episode(ep, worker))
  driver.on_step(lambda tran, _: step.increment())
  driver.on_step(replay.add)

  # The actor's own resumable state is just its step counter; the episodes
  # themselves live on the learner side (ZMQ store) or the shared replay dir.
  actor_cp = core.Checkpoint(actordir / 'actor.pkl')
  actor_cp.step = step
  actor_cp.load_or_save()

  # Random prefill up to the learner's train_fill so it can start updating.
  # The remote store's length is not cheaply queryable, so the deficit comes
  # from the actor's own resumed step counter.
  remaining = max(1, args.train_fill - int(step))
  print(f'Fill dataset ({remaining} steps, 1 episode).')
  driver(core.RandomAgent(env.act_space).policy, steps=remaining, episodes=1)

  weights = WeightSubscriber(agent, logdir, logger)
  should_sync = whenlib.Clock(args.sync_every)
  should_expl = whenlib.Until(args.expl_until)
  should_log = whenlib.Every(args.log_every)

  print('Start collection loop.')

  def policy(obs, state):
    mode = 'explore' if should_expl(step) else 'train'
    return agent.policy(obs, state, mode=mode)

  while step < args.steps:
    if should_sync(step):
      actor_cp.save()
      weights.refresh()
    driver(policy, steps=100)
    if should_log(step):
      # Policy/env latency sections + steps/s: the actor-side numbers
      # that tell whether the robot's control-rate budget holds.
      logger.add(timer.stats(), prefix='timer')
      logger.write(fps=True)

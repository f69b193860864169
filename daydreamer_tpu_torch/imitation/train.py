"""Motion-imitation training entry point: the port of
`daydreamer_tpu/imitation/train.py`.

Collects on-policy segments from the clip-tracking A1 sim and applies PPO
updates, logging through the framework Logger. The flags and the loop are
the JAX trainer's. One default differs: `platform` is `cuda`, and without
a card the trainer raises unless `--platform cpu` is given. The JAX
trainer defaults to the host CPU because its nets are tiny MLPs whose cost
is per-call dispatch; the port runs on the card unless asked otherwise,
where `act` and `update` replay CUDA graphs, the counterpart of the JAX
trainer's `jax.jit`.

Usage:
  python -m daydreamer_tpu_torch.imitation.train --gait trot \\
      --steps 200000 --logdir ~/logdir/imitate [--platform cpu]
"""

import sys

import numpy as np

from .. import core
from ..core import logger as loggerlib
from .ppo import PPOImitation, resolve_device
from .task import ImitationA1


def main(argv=None):
  config = core.Config({
      'logdir': '~/logdir/imitate',
      'platform': 'cuda',
      'gait': 'trot',
      'clip_file': '',
      'steps': 200000,
      'horizon': 2048,
      'length': 500,
      'repeat': 2,
      'lr': 3e-4,
      'seed': 0,
      'log_every': 2048,
  })
  config = core.Flags(config).parse(argv if argv is not None else
                                    sys.argv[1:])
  device = resolve_device(config.platform)
  clip = None
  if config.clip_file:
    from .motion_clip import MotionClip
    clip = MotionClip.from_file(config.clip_file)
  env = ImitationA1(clip=clip, gait=config.gait, repeat=config.repeat,
                    length=config.length)
  obs_dim = env.obs_space['vector'].shape[0]
  act_dim = env.act_space['action'].shape[0]
  agent = PPOImitation(obs_dim, act_dim, lr=config.lr,
                       horizon=config.horizon, seed=config.seed,
                       device=device)

  step = core.Counter()
  logdir = core.Path(config.logdir)
  logdir.mkdirs()
  logger = loggerlib.Logger(step, [
      loggerlib.TerminalOutput(),
      loggerlib.JSONLOutput(logdir, 'metrics.jsonl'),
  ])

  obs = env.step({'action': np.zeros(act_dim, np.float32), 'reset': True})
  ep_ret, ep_len, returns = 0.0, 0, []
  while int(step) < config.steps:
    seg = {k: [] for k in ('obs', 'action', 'logp', 'reward', 'cont',
                           'value')}
    for _ in range(config.horizon):
      vec = obs['vector'][None]
      action, logp, value = agent.act(vec)
      nxt = env.step({'action': action[0], 'reset': False})
      seg['obs'].append(vec[0])
      seg['action'].append(action[0])
      seg['logp'].append(logp[0])
      seg['value'].append(value[0])
      seg['reward'].append(nxt['reward'])
      seg['cont'].append(0.0 if nxt['is_terminal'] else 1.0)
      ep_ret += float(nxt['reward'])
      ep_len += 1
      step.increment()
      if nxt['is_last']:
        returns.append(ep_ret)
        logger.add({'episode/score': ep_ret, 'episode/length': ep_len})
        ep_ret, ep_len = 0.0, 0
        nxt = env.step({'action': np.zeros(act_dim, np.float32),
                        'reset': True})
      obs = nxt
    seg = {k: np.asarray(v, np.float32) for k, v in seg.items()}
    _, _, last_value = agent.act(obs['vector'][None])
    adv, ret = agent.gae(seg['reward'], seg['value'], seg['cont'],
                         last_value[0])
    rollout = dict(obs=seg['obs'], action=seg['action'], logp=seg['logp'],
                   adv=adv, ret=ret)
    metrics = agent.update(rollout)
    logger.add(metrics)
    logger.write(fps=True)
  env.close()
  return returns


if __name__ == '__main__':
  main()

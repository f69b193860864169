"""Task and exploration behaviors, the port of
`daydreamer_tpu/agents/dreamer/behaviors.py` (reference:
embodied/agents/dreamerv2plus/behaviors.py:9-253)."""

import math

import torch

from ... import nn
from ...parallel import distributed
from . import agent as agentlib
from . import expl


class Greedy(nn.Module):
  """Actor-critic on the extrinsic reward (reference: behaviors.py:9-46)."""

  def __init__(self, name, wm, act_space, config):
    super().__init__(name)
    self.ref('wm', wm)
    self.config = config
    rewfn = lambda s: wm.heads['reward'](s).mean()[1:]
    critic = {
        'vfunction': agentlib.VFunction,
        'qfunction': agentlib.QFunction,
        'qtwin': agentlib.TwinQFunction,
    }.get(config.critic_type)
    if critic is None:
      raise NotImplementedError(config.critic_type)
    critics = {'extr': self.sub('critic', critic, rewfn, config)}
    self.ac = self.sub(
        'ac', agentlib.ImagActorCritic, critics, {'extr': 1.0}, act_space,
        config, wm=wm)

  def initial(self, batch_size):
    return self.ac.initial(batch_size)

  def policy(self, latent, state):
    return self.ac.policy(latent, state)

  def train(self, imagine, start, data):
    return self.ac.train(imagine, start, data)

  def report(self, data):
    metrics = {}
    context, _ = self.wm.rssm.observe(
        self.wm.encoder(data)[:6, :5], data['action'][:6, :5],
        data['is_first'][:6, :5])
    start = {k: v[:, -1] for k, v in context.items()}
    start['is_terminal'] = data['is_terminal'][:6, 4]
    traj, _ = self.wm.imagine(
        self.policy, start, self.initial(6), self.config.imag_horizon)
    dists = self.wm.heads['decoder'](traj)
    for key in self.wm.heads['decoder'].cnn_shapes.keys():
      video = dists[key].mode().permute(1, 0, 2, 3, 4)
      metrics[f'imag_{key}'] = nn.video_grid(video)
    return metrics


class Random(nn.Module):
  """Uniform policy (reference: behaviors.py:97-120)."""

  def __init__(self, name, wm, act_space, config):
    super().__init__(name)
    self.config = config
    self.act_space = act_space

  def initial(self, batch_size):
    return torch.zeros(batch_size, device=nn.device())

  def policy(self, latent, state):
    batch_size = len(state)
    shape = (batch_size,) + self.act_space.shape
    if self.act_space.discrete:
      dist = nn.OneHotDist(torch.zeros(shape, device=nn.device()))
    else:
      dist = _Uniform(shape)
    return {'action': dist}, state

  def train(self, imagine, start, data):
    return None, {}

  def report(self, data):
    return {}


class _Uniform:

  def __init__(self, shape):
    self._shape = shape

  def sample(self, generator):
    u = torch.rand(self._shape, generator=generator,
                   device=generator.device, dtype=torch.float32)
    return 2 * u - 1

  def mode(self):
    return torch.zeros(self._shape, device=nn.device())

  def entropy(self):
    return torch.full(self._shape[:-1], self._shape[-1] * math.log(2.0),
                      device=nn.device())


class KnownReward(nn.Module):
  """Actor-critic on a hand-specified reward over decoded observations
  (reference: behaviors.py:49-94)."""

  def __init__(self, name, wm, act_space, config):
    super().__init__(name)
    self.config = config
    self.ac = self.sub(
        'ac', agentlib.ImagActorCritic,
        {'manual': self.sub('critic', agentlib.VFunction, self.rewfn,
                            config)},
        {'manual': 1.0}, act_space, config, wm=wm)

  def rewfn(self, s):
    if self.config.known_reward == 'none':
      return torch.zeros(s['deter'][1:, ..., 0].shape,
                         device=s['deter'].device)
    raise NotImplementedError(self.config.known_reward)

  def initial(self, batch_size):
    return self.ac.initial(batch_size)

  def policy(self, latent, state):
    return self.ac.policy(latent, state)

  def train(self, imagine, start, data):
    return self.ac.train(imagine, start, data)

  def report(self, data):
    return {}


class DisagWhen(nn.Module):
  """Switches between achiever and explorer policies when ensemble
  disagreement exceeds a buffer quantile (reference: behaviors.py:170-253).

  The disagreement buffer is state: a [capacity, deter] ring of
  high-disagreement states plus their scores, replaced each train step by
  a top-k merge (in place of the reference's tf.Variable assignments)."""

  def __init__(self, name, wm, act_space, config):
    super().__init__(name)
    config = config.update({'disag_head.inputs': ['deter']})
    self.act_space = act_space
    self.config = config
    rewfn = lambda s: wm.heads['reward'](s).mean()[1:]
    self.achiever = self.sub(
        'achiever', agentlib.ImagActorCritic,
        {'extr': self.sub('critic_extr', agentlib.VFunction, rewfn,
                          config)},
        {'extr': 1.0}, act_space, config, wm=wm)
    self.disag = self.sub('disag', expl.Disag, wm, act_space, config)
    self.explorer = self.sub(
        'explorer', agentlib.ImagActorCritic,
        {'expl': self.sub('critic_expl', agentlib.VFunction, self.disag,
                          config)},
        {'expl': 1.0}, act_space, config, wm=wm)
    # `expl_when_buffer: 1e4` is a float in the YAML.
    self.capacity = int(config.expl_when_buffer)

  def initial(self, batch_size):
    dev = nn.device()
    return {
        'achiever': self.achiever.initial(batch_size),
        'explorer': self.explorer.initial(batch_size),
        'exploring': torch.zeros(batch_size, dtype=torch.bool, device=dev),
        'counter': torch.zeros(batch_size, dtype=torch.int32, device=dev),
    }

  def _buffer(self):
    deter = self.config.rssm.deter
    buffer = self.value(
        'buffer', lambda: torch.zeros((self.capacity, deter)),
        trainable=False)
    disags = self.value(
        'disags', lambda: torch.zeros(self.capacity), trainable=False)
    return buffer, disags

  def policy(self, latent, state):
    _, disags = self._buffer()
    disag = self._disagreement(latent['deter'])
    higher = disag[:, None] > disags[None, :]
    frac = higher.float().sum(1) / self.capacity
    exploring = torch.where(
        state['counter'] > 0, state['exploring'],
        frac > self.config.expl_when_frac)
    counter = (state['counter'] + 1) % self.config.expl_when_every
    ac_out, ac_state = self.achiever.policy(latent, state['achiever'])
    ex_out, ex_state = self.explorer.policy(latent, state['explorer'])
    ac_dist = ac_out['action']
    if self.config.expl_when_random:
      shape = (len(state['counter']),) + self.act_space.shape
      if self.act_space.discrete:
        ac_dist = nn.OneHotDist(torch.zeros(shape, device=nn.device()))
      else:
        ac_dist = _Uniform(shape)
    # Both actions are drawn, the explorer's first, before one is picked.
    ex_act = ex_out['action'].sample(nn.rng())
    ac_act = ac_dist.sample(nn.rng())
    act = torch.where(exploring[:, None], ex_act, ac_act)
    state = {
        'achiever': ac_state, 'explorer': ex_state,
        'exploring': exploring, 'counter': counter}
    return {'action': _Deterministic(act)}, state

  def train(self, imagine, start, data):
    metrics = {}
    metrics.update(self.disag.train(data))
    traj, mets = self.explorer.train(imagine, start, data)
    metrics.update({f'explorer_{k}': v for k, v in mets.items()})
    traj, mets = self.achiever.train(imagine, start, data)
    metrics.update({f'achiever_{k}': v for k, v in mets.items()})
    # Update the disagreement buffer with the batch's mid-sequence states.
    buffer, disags = self._buffer()
    with torch.no_grad():
      # The global batch's states in rank order, so that every replica
      # merges the same ones into the same buffer.
      states = distributed.all_gather_rows(
          data['deter'][:, data['deter'].shape[1] // 2].float())
      merged = torch.cat([buffer, states], 0)
      merged_disags = torch.cat([disags, self._disagreement(states)], 0)
      # Stable, as jnp.argsort is: the merged scores start with ties (the
      # zero buffer).
      indices = torch.argsort(merged_disags, stable=True)[-self.capacity:]
    self.write('buffer', merged[indices])
    self.write('disags', merged_disags[indices])
    return traj, metrics

  def _disagreement(self, deter):
    return self.disag({'deter': torch.cat([deter[:1], deter], 0)})

  def report(self, data):
    return {}


class _Deterministic:

  def __init__(self, value):
    self._value = value

  def sample(self, generator):
    return self._value

  def mode(self):
    return self._value

  def entropy(self):
    return torch.zeros(self._value.shape[:-1], device=self._value.device)


class Explore(nn.Module):
  """Multi-reward exploration actor-critic (reference: behaviors.py:123-167):
  extrinsic plus disagreement/VAE/control/PBE intrinsic critics."""

  REWARDS = {
      'disag': expl.Disag,
      'vae': expl.LatentVAE,
      'ctrl': expl.CtrlDisag,
      'pbe': expl.PBE,
  }

  def __init__(self, name, wm, act_space, config):
    super().__init__(name)
    self.config = config
    self.rewards = {}
    critics = {}
    for key, scale in config.expl_rewards.items():
      if not scale:
        continue
      if key == 'extr':
        reward = lambda traj: wm.heads['reward'](traj).mean()[1:]
        critics[key] = self.sub(
            f'critic_{key}', agentlib.VFunction, reward, config)
      else:
        reward = self.sub(
            f'reward_{key}', self.REWARDS[key], wm, act_space, config)
        critics[key] = self.sub(
            f'critic_{key}', agentlib.VFunction, reward, config.update(
                discount=config.expl_discount,
                retnorm=dict(config.expl_retnorm),
                scorenorm=dict(config.expl_scorenorm)))
        self.rewards[key] = reward
    scales = {k: v for k, v in config.expl_rewards.items() if v}
    self.ac = self.sub(
        'ac', agentlib.ImagActorCritic, critics, scales, act_space, config,
        wm=wm)

  def initial(self, batch_size):
    return self.ac.initial(batch_size)

  def policy(self, latent, state):
    return self.ac.policy(latent, state)

  def train(self, imagine, start, data):
    metrics = {}
    for key, reward in self.rewards.items():
      metrics.update(reward.train(data))
    traj, mets = self.ac.train(imagine, start, data)
    metrics.update(mets)
    return traj, metrics

  def report(self, data):
    return {}

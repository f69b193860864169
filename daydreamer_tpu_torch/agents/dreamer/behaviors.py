"""Task behaviors, the port of `daydreamer_tpu/agents/dreamer/behaviors.py`
(reference: embodied/agents/dreamerv2plus/behaviors.py:9-253). Only
`Greedy` with the VFunction critic is ported so far."""

from ... import nn
from . import agent as agentlib


class Greedy(nn.Module):
  """Actor-critic on the extrinsic reward (reference: behaviors.py:9-46)."""

  def __init__(self, name, wm, act_space, config):
    super().__init__(name)
    self.ref('wm', wm)
    self.config = config
    rewfn = lambda s: wm.heads['reward'](s).mean()[1:]
    if config.critic_type == 'vfunction':
      critics = {'extr': self.sub('critic', agentlib.VFunction, rewfn,
                                  config)}
    else:
      raise NotImplementedError(
          f'critic_type {config.critic_type} is not ported yet.')
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

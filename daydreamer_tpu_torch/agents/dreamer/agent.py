"""DreamerV2+ agent: world model + imagination actor-critic, the port of
`daydreamer_tpu/agents/dreamer/agent.py`.

The modules are `torch.nn.Module`s whose state carries the JAX package's
names; calls run inside an `nn.scope` that the wrapper (`torchagent.py`)
opens with the compute dtype and the agent's generator. Gradients come
from `torch.autograd.grad` inside each optimizer; parameters update in
place, so a later update in the same train step sees the earlier one's
result, as the JAX package's state threading does. The reinforce rollout
can run as one CUDA kernel (`imag_impl: pallas`, `ops/rssm.py`).
"""

import pathlib

import numpy as np
import torch

from ... import nn
from ...models import nets
from ...parallel import distributed
from . import behaviors
from .torchagent import Wrapper

sg = nn.sg
cast = nn.cast


def load_configs():
  own = pathlib.Path(__file__).parent / 'configs.yaml'
  return load_yaml12(own.read_text())


def load_yaml12(text):
  """YAML load with 1.2-style scalars: 1e-4 is a float and off/on/yes/no
  are strings, matching the ruamel safe loader the reference relied on."""
  import re as relib
  import yaml

  class Loader(yaml.SafeLoader):
    pass

  Loader.yaml_implicit_resolvers = {
      key: [(tag, regexp) for tag, regexp in values
            if tag != 'tag:yaml.org,2002:bool']
      for key, values in yaml.SafeLoader.yaml_implicit_resolvers.items()}
  Loader.add_implicit_resolver(
      'tag:yaml.org,2002:bool',
      relib.compile(r'^(?:true|True|false|False)$'), list('tTfF'))
  Loader.add_implicit_resolver(
      'tag:yaml.org,2002:float',
      relib.compile(r'''^(?:
          [-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
          |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
          |\.[0-9_]+(?:[eE][-+][0-9]+)?
          |[-+]?\.(?:inf|Inf|INF)
          |\.(?:nan|NaN|NAN))$''', relib.X),
      list('-+0123456789.'))
  return yaml.load(text, Loader=Loader)


@Wrapper
class Agent(nn.Module):

  configs = load_configs()

  def __init__(self, name, obs_space, act_space, step, config):
    super().__init__(name)
    self.config = config
    self.obs_space = obs_space
    self.act_space = act_space['action']
    self.step = step
    self.wm = self.sub('wm', WorldModel, obs_space, config)
    self.task_behavior = self.sub(
        'task_behavior', getattr(behaviors, config.task_behavior),
        self.wm, self.act_space, config)
    if config.expl_behavior == 'None':
      self.ref('expl_behavior', self.task_behavior)
    else:
      self.expl_behavior = self.sub(
          'expl_behavior', getattr(behaviors, config.expl_behavior),
          self.wm, self.act_space, config)

  def policy_initial(self, batch_size):
    return (
        self.wm.rssm.initial(batch_size),
        self.task_behavior.initial(batch_size),
        self.expl_behavior.initial(batch_size),
        torch.zeros((batch_size,) + self.act_space.shape, device=nn.device()))

  def train_initial(self, batch_size):
    return self.wm.rssm.initial(batch_size)

  def policy(self, obs, state, mode='train'):
    obs = self.preprocess(obs)
    latent, task_state, expl_state, action = state
    embed = self.wm.encoder(obs)
    latent, _ = self.wm.rssm.obs_step(
        latent, action, embed, obs['is_first'])
    noise = self.config.expl_noise
    if mode == 'eval':
      noise = self.config.eval_noise
      outs, task_state = self.task_behavior.policy(latent, task_state)
      outs = {**outs, 'action': self._mode_or_value(outs['action'])}
    elif mode == 'explore':
      outs, expl_state = self.expl_behavior.policy(latent, expl_state)
      outs = {**outs, 'action': self._sample_or_value(outs['action'])}
    elif mode == 'train':
      outs, task_state = self.task_behavior.policy(latent, task_state)
      outs = {**outs, 'action': self._sample_or_value(outs['action'])}
    else:
      raise NotImplementedError(mode)
    outs = {**outs, 'action': nn.action_noise(
        outs['action'], noise, self.act_space, nn.rng())}
    state = (latent, task_state, expl_state, outs['action'])
    return outs, state

  def train(self, data, state):
    metrics = {}
    data = self.preprocess(data)
    if self.config.train_wm:
      state, wm_outs, mets = self.wm.train(data, state)
      metrics.update(mets)
      context = {**data, **wm_outs['post']}
    else:
      with torch.no_grad():
        embed = self.wm.encoder(data)
        post, _ = self.wm.rssm.observe(
            embed, data['action'], data['is_first'], state)
      wm_outs = {'post': post}
      context = {**data, **post}
    # The world model's graph ends here: its parameters changed in place.
    context = sg(context)
    start = nn.tree_map(
        lambda x: x.reshape((-1,) + tuple(x.shape[2:])), context)
    _, mets = self.task_behavior.train(self.wm.imagine, start, context)
    metrics.update(mets)
    if self.config.expl_behavior != 'None':
      _, mets = self.expl_behavior.train(self.wm.imagine, start, context)
      metrics.update({'expl_' + k: v for k, v in mets.items()})
    outs = {}
    if 'prob' in data:
      criteria = {**data, **wm_outs}
      outs.update(priority=sg(criteria[self.config.priority]))
    return outs, sg(state), metrics

  def report(self, data):
    data = self.preprocess(data)
    report = {}
    report.update(self.wm.report(data))
    mets = self.task_behavior.report(data)
    report.update({f'task_{k}': v for k, v in mets.items()})
    if self.expl_behavior is not self.task_behavior:
      mets = self.expl_behavior.report(data)
      report.update({f'expl_{k}': v for k, v in mets.items()})
    return report

  def preprocess(self, obs):
    result = {}
    for key, value in obs.items():
      if key.startswith('log_') or key in ('key',):
        result[key] = value
        continue
      if len(value.shape) > 3 and value.dtype == torch.uint8:
        value = cast(value.float()) / 255.0
      else:
        value = value.float()
      result[key] = value
    result['reward'] = {
        'off': lambda x: x, 'sign': torch.sign,
        'tanh': torch.tanh, 'symlog': nn.symlog,
    }[self.config.transform_rewards](result['reward'])
    result['cont'] = 1.0 - obs['is_terminal'].float()
    return result

  def _sample_or_value(self, dist):
    return dist.sample(nn.rng()) if hasattr(dist, 'sample') else dist

  def _mode_or_value(self, dist):
    return dist.mode() if hasattr(dist, 'mode') else dist


class WorldModel(nn.Module):
  """RSSM + encoder + heads {decoder, reward, cont}
  (reference: agent.py:142-282)."""

  def __init__(self, name, obs_space, config):
    super().__init__(name)
    shapes = {k: tuple(v.shape) for k, v in obs_space.items()}
    shapes = {k: v for k, v in shapes.items() if not k.startswith('log_')}
    self.config = config
    self.rssm = self.sub('rssm', nets.RSSM, **config.rssm)
    self.encoder = self.sub('enc', nets.MultiEncoder, shapes,
                            **config.encoder)
    self.heads = {}
    self.heads['decoder'] = self.sub(
        'dec', nets.MultiDecoder, shapes, **config.decoder)
    self.heads['reward'] = self.sub(
        'rew', nets.MLP, (), **config.reward_head)
    self.heads['cont'] = self.sub(
        'cont', nets.MLP, (), **config.cont_head)
    self.model_opt = self.sub('model_opt', nn.Optimizer, **config.model_opt)
    self.wmkl = self.sub(
        'wmkl', nn.AutoAdapt, (), **config.wmkl, inverse=False)

  def train(self, data, state):
    modules = [self.encoder, self.rssm, *self.heads.values()]
    mets, (state, outs, metrics) = self.model_opt(
        lambda: self.loss(data, state, training=True), modules)
    metrics.update(mets)
    return state, outs, metrics

  def loss(self, data, state=None, training=False):
    metrics = {}
    embed = self.encoder(data)
    post, prior = self.rssm.observe(
        embed, data['action'], data['is_first'], state)
    dists = {}
    post_const = sg(post)
    for name, head in self.heads.items():
      out = head(post if name in self.config.grad_heads else post_const)
      if not isinstance(out, dict):
        out = {name: out}
      dists.update(out)
    losses = {}
    kl = self.rssm.kl_loss(post, prior, self.config.wmkl_balance)
    kl, mets = self.wmkl(kl, update=training)
    losses['kl'] = kl
    metrics.update({f'wmkl_{k}': v for k, v in mets.items()})
    for key, dist in dists.items():
      losses[key] = -dist.log_prob(data[key].float())
    metrics.update({f'{k}_loss_mean': v.mean() for k, v in losses.items()})
    metrics.update({f'{k}_loss_std': _std(v) for k, v in losses.items()})
    scaled = {}
    for key, loss in losses.items():
      assert loss.shape == embed.shape[:2], (key, loss.shape)
      scaled[key] = loss * self.config.loss_scales.get(key, 1.0)
    model_loss = sum(scaled.values())
    if 'prob' in data and self.config.priority_correct:
      weights = (1.0 / data['prob']) ** self.config.priority_correct
      weights = weights / distributed.all_max(weights.max())
      assert weights.shape == model_loss.shape
      model_loss = model_loss * weights
    out = {'embed': embed, 'post': post, 'prior': prior}
    out.update({f'{k}_loss': v for k, v in losses.items()})
    prior_ent = self.rssm.get_dist(prior).entropy()
    post_ent = self.rssm.get_dist(post).entropy()
    metrics['prior_ent_mean'] = prior_ent.mean()
    metrics['post_ent_mean'] = post_ent.mean()
    metrics['prior_ent_min'] = prior_ent.min()
    metrics['post_ent_min'] = post_ent.min()
    metrics['model_loss_mean'] = model_loss.mean()
    metrics['model_loss_std'] = _std(model_loss)
    if 'reward' in dists:
      stats = nn.balance_stats(dists['reward'], data['reward'], 0.1)
      metrics.update({f'reward_{k}': v for k, v in stats.items()})
    if 'cont' in dists:
      stats = nn.balance_stats(dists['cont'], data['cont'], 0.5)
      metrics.update({f'cont_{k}': v for k, v in stats.items()})
    last_state = {k: v[:, -1] for k, v in post.items()}
    metrics = sg(metrics)
    return model_loss.mean(), sg(last_state), sg(out), metrics

  def imagine(self, policy, start, carry, horizon):
    """Imagination rollout: img_step + policy over the horizon
    (reference: agent.py:234-261). start is a flattened [B*T, ...] state."""
    sample = lambda x: {
        k: v.sample(nn.rng()) if hasattr(v, 'sample') else v
        for k, v in x.items()}
    first_cont = 1.0 - start['is_terminal'].float()
    keys = self.rssm.state_keys()
    start = {k: v for k, v in start.items() if k in keys}
    action, carry = policy(start, carry)
    action = sample(action)

    def step(prev, _):
      prev_state, prev_action, carry = prev
      state = self.rssm.img_step(prev_state, prev_action['action'])
      action, carry = policy(state, carry)
      action = sample(action)
      return state, action, carry

    states, actions, carries = nn.scan(
        step, torch.arange(horizon), (start, action, carry))
    concat_first = lambda first, seq: {
        k: torch.cat([first[k][None].to(v.dtype), v], 0)
        for k, v in seq.items()}
    states = concat_first(start, states)
    actions = concat_first(action, actions)
    carry = nn.tree_map(lambda x: x[-1], carries)
    states['cont'] = torch.cat([
        first_cont[None], self.heads['cont'](states).mean()[1:]], 0)
    states['weight'] = torch.cumprod(
        self.config.discount * states['cont'], 0) / self.config.discount
    traj = {**states, **actions}
    return traj, carry

  def report(self, data):
    report = {}
    report.update(self.loss(data)[-1])
    context, _ = self.rssm.observe(
        self.encoder(data)[:6, :5], data['action'][:6, :5],
        data['is_first'][:6, :5])
    start = {k: v[:, -1] for k, v in context.items()}
    recon = self.heads['decoder'](context)
    openl = self.heads['decoder'](
        self.rssm.imagine(data['action'][:6, 5:], start))
    for key in self.heads['decoder'].cnn_shapes.keys():
      truth = data[key][:6].float()
      model = torch.cat(
          [recon[key].mode()[:, :5], openl[key].mode()], 1)
      error = (model - truth + 1) / 2
      video = torch.cat([truth, model, error], 2)
      report[f'openl_{key}'] = nn.video_grid(video)
    return report


def _std(x):
  return x.std(correction=0)


class ImagActorCritic(nn.Module):
  """Actor trained in imagination against one or more critics
  (reference: agent.py:285-381)."""

  def __init__(self, name, critics, scales, act_space, config, wm=None):
    super().__init__(name)
    for key, scale in scales.items():
      assert not scale or key in critics, key
    self.critics = {k: v for k, v in critics.items() if scales[k]}
    self.scales = scales
    self.act_space = act_space
    self.config = config
    self.ref('wm', wm)  # Enables the fused rollout (imag_impl: pallas).
    self.actor = self.sub(
        'actor', nets.MLP, act_space.shape, **config.actor,
        dist=(config.actor_dist_disc if act_space.discrete
              else config.actor_dist_cont))
    self.grad = (
        config.actor_grad_disc if act_space.discrete
        else config.actor_grad_cont)
    self.advnorm = self.sub('advnorm', nn.Normalize, **config.advnorm)
    self.retnorms = {
        k: self.sub(f'retnorm_{k}', nn.Normalize, **config.retnorm)
        for k in self.critics}
    self.scorenorms = {
        k: self.sub(f'scorenorm_{k}', nn.Normalize, **config.scorenorm)
        for k in self.critics}
    self.actent = self.sub(
        'actent', nn.AutoAdapt,
        act_space.shape[:-1] if act_space.discrete else act_space.shape,
        **config.actent, inverse=True)
    self.opt = self.sub('actor_opt', nn.Optimizer, **config.actor_opt)

  def initial(self, batch_size):
    return {}

  def policy(self, state, carry):
    return {'action': self.actor(state)}, carry

  def train(self, imagine, start, context):
    metrics = {}
    policy = lambda latent, carry: (
        {'action': self.actor(sg(latent))}, carry)
    if self.grad == 'reinforce':
      # Discrete: gradients do not flow through the dynamics, so one
      # no-grad rollout serves both critic and actor updates, which is why
      # it can run as one forward-only kernel.
      with torch.no_grad():
        if self._fused_imagine_ok():
          traj = self._imagine_fused(start, self.config.imag_horizon)
        else:
          traj, _ = imagine(policy, start, {}, self.config.imag_horizon)
      traj = sg(traj)
      for key, critic in self.critics.items():
        mets = critic.train(traj, self.actor)
        metrics.update({f'{key}_{k}': v for k, v in mets.items()})
      mets, _ = self.opt(lambda: self._loss(traj), self.actor)
      metrics.update(mets)
    elif self.grad == 'backprop':
      # Continuous: the rollout runs inside the loss so gradients flow
      # through the learned dynamics into the actor.
      def lossfn():
        traj, _ = imagine(policy, start, {}, self.config.imag_horizon)
        loss, mets = self._loss(traj)
        return loss, sg(traj), sg(mets)
      mets, (traj, loss_mets) = self.opt(lossfn, self.actor)
      metrics.update(loss_mets)
      metrics.update(mets)
      for key, critic in self.critics.items():
        cmets = critic.train(traj, self.actor)
        metrics.update({f'{key}_{k}': v for k, v in cmets.items()})
    else:
      raise NotImplementedError(self.grad)
    return traj, metrics

  def _fused_imagine_ok(self):
    """The fused policy-in-the-loop rollout covers the standard Greedy
    setup: discrete flat actions, the default elu/layer-norm actor MLP
    over [deter, stoch], and a fused-compatible RSSM."""
    if 'imag_impl' not in self.config or self.config.imag_impl != 'pallas':
      return False
    if nn.creating():
      return False
    if self.wm is None or not self.act_space.discrete:
      return False
    if len(self.act_space.shape) != 1:
      return False
    actor = self.config.actor
    return (self.wm.rssm.fused_compatible
            and list(actor.inputs) == ['deter', 'stoch']
            and actor.act == 'elu' and actor.norm == 'layer'
            and self.config.actor_dist_disc == 'onehot')

  def _actor_fused_params(self):
    """Actor MLP weights for the fused rollout, sliced from the SAME named
    state entries nets.MLP creates; the concat [deter, stoch] input becomes
    a split matmul, so `dense0/kernel[:D]` holds the deter rows."""
    get = lambda path, key: cast(self.actor.get_submodule(path).value(
        key, None))
    layers = self.config.actor.layers
    D = self.wm.rssm._deter
    k0 = get('dense0', 'kernel')
    return {
        'w_d': k0[:D], 'w_s': k0[D:],
        'w_h': [get(f'dense{i}', 'kernel') for i in range(1, layers)],
        'ln_scale': [get(f'dense{i}.norm', 'scale') for i in range(layers)],
        'ln_bias': [get(f'dense{i}.norm', 'bias') for i in range(layers)],
        'w_out': get('dist_out.out', 'kernel'),
        'b_out': get('dist_out.out', 'bias'),
    }

  def _imagine_fused(self, start, horizon):
    """Forward-only fused rollout replacing wm.imagine + per-step actor
    (ops/rssm.imagine_actor): the same trajectory layout and distributions
    as WorldModel.imagine with this actor policy, on another stream of
    random numbers."""
    from ...ops import rssm as ops_rssm
    wm = self.wm
    rssm = wm.rssm
    first_cont = 1.0 - start['is_terminal'].float()
    sstart = {k: start[k] for k in rssm.state_keys()}
    action0 = self.actor(sstart).sample(nn.rng())
    B, A = action0.shape
    SC = rssm._stoch * rssm._classes
    stoch0 = cast(sstart['stoch']).reshape(B, SC).contiguous()
    deter0 = cast(sstart['deter']).contiguous()
    deters, logits, stochs, actions = ops_rssm.imagine_actor(
        rssm.fused_img_params(), self._actor_fused_params(),
        stoch0, deter0, cast(action0).contiguous(), horizon, nn.rng(),
        unimix=rssm._unimix, act_unimix=float(self.config.actor.unimix),
        sample=True)
    shape = lambda x: x.reshape(
        tuple(x.shape[:2]) + (rssm._stoch, rssm._classes))
    dtype = stoch0.dtype
    # The kernel returns RAW prior logits; store unimix log-probs like the
    # loop path (see RSSM._stats_layer).
    logit = rssm._unimix_logit(shape(logits)).to(dtype)
    states = {
        'deter': deters.to(dtype),
        'stoch': shape(stochs).to(dtype),
        'logit': logit}
    states = {
        k: torch.cat([sstart[k][None].to(v.dtype), v], 0)
        for k, v in states.items()}
    actions_seq = torch.cat([action0[None], actions.float()], 0)
    states['cont'] = torch.cat([
        first_cont[None], wm.heads['cont'](states).mean()[1:]], 0)
    states['weight'] = torch.cumprod(
        self.config.discount * states['cont'], 0) / self.config.discount
    return {**states, 'action': actions_seq}

  def _loss(self, traj):
    metrics = {}
    scores = []
    for key, critic in self.critics.items():
      ret, baseline = critic.score(traj, self.actor)
      ret = self.retnorms[key](ret)
      baseline = self.retnorms[key](baseline, update=False)
      score = self.scorenorms[key](ret - baseline)
      metrics[f'{key}_score_mean'] = score.mean()
      metrics[f'{key}_score_std'] = _std(score)
      metrics[f'{key}_score_mag'] = score.abs().mean()
      metrics[f'{key}_score_max'] = score.abs().max()
      scores.append(score * self.scales[key])
    score = self.advnorm(torch.stack(scores).sum(0))
    policy = self.actor(sg(traj))
    action = sg(traj['action'])
    if self.grad == 'backprop':
      loss = -score
    elif self.grad == 'reinforce':
      loss = -policy.log_prob(action)[:-1] * sg(score)
    else:
      raise NotImplementedError(self.grad)
    if len(self.actent.shape) > 0:
      assert isinstance(policy, nn.Independent)
      ent = policy.inner.entropy()[:-1]
      if self.config.actent_norm:
        lo = policy.minent / np.prod(self.actent.shape)
        hi = policy.maxent / np.prod(self.actent.shape)
        ent = (ent - lo) / (hi - lo)
      ent_loss, mets = self.actent(ent)
      assert len(ent_loss.shape) == 2 + len(self.actent.shape)
      ent_loss = ent_loss.sum(tuple(range(2, len(ent_loss.shape))))
    else:
      ent = policy.entropy()[:-1]
      if self.config.actent_norm:
        lo, hi = policy.minent, policy.maxent
        ent = (ent - lo) / (hi - lo)
      ent_loss, mets = self.actent(ent)
    metrics.update({f'actent_{k}': v for k, v in mets.items()})
    loss = loss + ent_loss
    loss = loss * sg(traj['weight'])[:-1]
    return loss.mean(), sg(metrics)


class VFunction(nn.Module):
  """λ-return state-value critic with a slow target network
  (reference: agent.py:384-454)."""

  def __init__(self, name, rewfn, config):
    super().__init__(name)
    assert 'action' not in config.critic.inputs, config.critic.inputs
    self.ref('rewfn', rewfn)  # May be a module of the behavior's.
    self.config = config
    self.net = self.sub('net', nets.MLP, (), **config.critic)
    if config.slow_target:
      self.target_net = self.sub('target_net', nets.MLP, (), **config.critic)
    else:
      self.ref('target_net', self.net)
    self.opt = self.sub('critic_opt', nn.Optimizer, **config.critic_opt)

  def train(self, traj, actor):
    metrics = {}
    with torch.no_grad():
      reward = self.rewfn(traj)
      target = self.target(traj, reward, self.config.critic_return)[0]

    def lossfn():
      dist = self.net({k: v[:-1] for k, v in traj.items()})
      loss = -(dist.log_prob(target) * traj['weight'][:-1]).mean()
      value = dist.mean().detach()
      return loss, value.mean(), _std(value)

    mets, (critic_mean, critic_std) = self.opt(lossfn, self.net)
    metrics.update(mets)
    metrics.update({
        'imag_reward_mean': reward.mean(),
        'imag_reward_std': _std(reward),
        'imag_critic_mean': critic_mean,
        'imag_critic_std': critic_std,
        'imag_return_mean': target.mean(),
        'imag_return_std': _std(target),
    })
    self.update_slow()
    return metrics

  def score(self, traj, actor):
    return self.target(traj, self.rewfn(traj), self.config.actor_return)

  def target(self, traj, reward, impl):
    assert len(reward) == len(traj['action']) - 1, (
        'Should provide rewards for all but last action.')
    disc = traj['cont'][1:] * self.config.discount
    value = self.target_net(traj).mean()
    lam = self.config.return_lambda
    if impl == 'gae':
      deltas = reward + disc * value[1:] - value[:-1]
      adv = _reverse_scan(
          lambda nxt, inp: inp[0] + inp[1] * lam * nxt,
          (deltas, disc), torch.zeros_like(value[0]))
      return adv + value[:-1], value[:-1]
    elif impl == 'gve':
      interm = reward + disc * value[1:] * (1 - lam)
      ret = _reverse_scan(
          lambda nxt, inp: inp[0] + inp[1] * lam * nxt,
          (interm, disc), value[-1])
      return ret, value[:-1]
    else:
      raise NotImplementedError(impl)

  def update_slow(self):
    if not self.config.slow_target:
      return
    _slow_update(
        self, self.net, self.target_net,
        self.config.slow_target_update, self.config.slow_target_fraction)


class QFunction(nn.Module):
  """Q(s,a) critic with Peng's Q(λ) targets (reference: agent.py:457-525)."""

  def __init__(self, name, rewfn, config):
    super().__init__(name)
    assert config.actor_grad_disc == 'backprop'
    assert config.actor_grad_cont == 'backprop'
    assert 'action' in config.actor.inputs
    self.ref('rewfn', rewfn)
    self.config = config
    self.net = self.sub('net', nets.MLP, (), **config.critic)
    if config.slow_target:
      self.target_net = self.sub('target_net', nets.MLP, (), **config.critic)
    else:
      self.ref('target_net', self.net)
    self.opt = self.sub('critic_opt', nn.Optimizer, **config.critic_opt)

  def score(self, traj, actor):
    traj = sg(traj)
    action = actor(traj).sample(nn.rng())
    ret = self.net({**traj, 'action': action}).mode()[:-1]
    baseline = torch.zeros_like(ret)
    return ret, baseline

  def train(self, traj, actor):
    metrics = {}
    with torch.no_grad():
      reward = self.rewfn(traj)
      target = self.target(traj, actor, reward)

    def lossfn():
      dist = self.net({k: v[:-1] for k, v in traj.items()})
      loss = -(dist.log_prob(target) * traj['weight'][:-1]).mean()
      value = dist.mean().detach()
      return loss, value.mean(), _std(value)

    mets, (critic_mean, critic_std) = self.opt(lossfn, self.net)
    metrics.update(mets)
    metrics.update({
        'imag_reward_mean': reward.mean(),
        'imag_reward_std': _std(reward),
        'imag_critic_mean': critic_mean,
        'imag_critic_std': critic_std,
        'imag_target_mean': target.mean(),
        'imag_target_std': _std(target),
    })
    self.update_slow()
    return metrics

  def target(self, traj, actor, reward):
    assert len(reward) == len(traj['action']) - 1
    disc = traj['cont'][1:] * self.config.discount
    action = actor(traj).sample(nn.rng())
    value = self.target_net({**traj, 'action': action}).mean()
    return _q_target(reward, disc, value, self.config)

  def update_slow(self):
    if not self.config.slow_target:
      return
    _slow_update(
        self, self.net, self.target_net,
        self.config.slow_target_update, self.config.slow_target_fraction)


class TwinQFunction(nn.Module):
  """Twin-min Q critics (reference: agent.py:528-610)."""

  def __init__(self, name, rewfn, config):
    super().__init__(name)
    assert config.actor_grad_disc == 'backprop'
    assert config.actor_grad_cont == 'backprop'
    assert 'action' in config.actor.inputs
    self.ref('rewfn', rewfn)
    self.config = config
    self.net1 = self.sub('net1', nets.MLP, (), **config.critic)
    self.net2 = self.sub('net2', nets.MLP, (), **config.critic)
    if config.slow_target:
      self.target_net1 = self.sub('target_net1', nets.MLP, (),
                                  **config.critic)
      self.target_net2 = self.sub('target_net2', nets.MLP, (),
                                  **config.critic)
    else:
      self.ref('target_net1', self.net1)
      self.ref('target_net2', self.net2)
    self.opt = self.sub('critic_opt', nn.Optimizer, **config.critic_opt)

  def score(self, traj, actor):
    traj = sg(traj)
    inps = {**traj, 'action': actor(traj).sample(nn.rng())}
    ret = torch.minimum(self.net1(inps).mode(), self.net2(inps).mode())[:-1]
    baseline = torch.zeros_like(ret)
    return ret, baseline

  def train(self, traj, actor):
    metrics = {}
    with torch.no_grad():
      reward = self.rewfn(traj)
      target = self.target(traj, actor, reward)
    inps = {k: v[:-1] for k, v in traj.items()}

    def lossfn():
      dist1 = self.net1(inps)
      dist2 = self.net2(inps)
      loss1 = -(dist1.log_prob(target) * traj['weight'][:-1]).mean()
      loss2 = -(dist2.log_prob(target) * traj['weight'][:-1]).mean()
      return loss1 + loss2, dist1.mean().detach().mean()

    mets, (critic_mean,) = self.opt(lossfn, [self.net1, self.net2])
    metrics.update(mets)
    metrics.update({
        'imag_reward_mean': reward.mean(),
        'imag_reward_std': _std(reward),
        'imag_critic_mean': critic_mean,
        'imag_target_mean': target.mean(),
        'imag_target_std': _std(target),
    })
    self.update_slow()
    return metrics

  def target(self, traj, actor, reward):
    assert len(reward) == len(traj['action']) - 1
    disc = traj['cont'][1:] * self.config.discount
    action = actor(traj).sample(nn.rng())
    value = torch.minimum(
        self.target_net1({**traj, 'action': action}).mean(),
        self.target_net2({**traj, 'action': action}).mean())
    return _q_target(reward, disc, value, self.config)

  def update_slow(self):
    if not self.config.slow_target:
      return
    _slow_update(
        self, self.net1, self.target_net1,
        self.config.slow_target_update, self.config.slow_target_fraction)
    _slow_update(
        self, self.net2, self.target_net2,
        self.config.slow_target_update, self.config.slow_target_fraction)


def _q_target(reward, disc, value, config):
  """Peng's Q(λ) return, or the one-step target without `pengs_qlambda`."""
  if config.pengs_qlambda:
    lam = config.return_lambda
    interm = reward + disc * value[1:] * (1 - lam)
    return _reverse_scan(
        lambda nxt, inp: inp[0] + inp[1] * lam * nxt,
        (interm, disc), value[-1])
  return reward + disc * value[1:]


def _reverse_scan(step, inputs, bootstrap):
  """Backward recursion along the leading (time) axis.
  step(next_value, inputs_t) -> value_t. Returns stacked values [T, ...]."""
  return nn.scan(step, inputs, bootstrap, reverse=True)


def _slow_update(owner, src, dst, period, fraction):
  """Periodic slow-target mix: dst <- mix*src + (1-mix)*dst
  (reference: agent.py:444-454), with a counter that starts at -1 so the
  first call copies; decided on the device, without a host sync."""
  if src is dst:
    return
  name = f'updates_{dst.path.rsplit("/", 1)[-1]}'
  updates = owner.value(
      name, lambda: -torch.ones((), dtype=torch.int32), trainable=False)
  init = updates == -1
  due = init | (updates >= period)
  mix = torch.where(due, torch.where(init, 1.0, fraction), 0.0)
  dst_state = dict(dst.named_state(trainable=True))
  with torch.no_grad():
    for src_key, value in src.named_state(trainable=True):
      dst_key = src_key.replace(src.path + '/', dst.path + '/', 1)
      if nn.creating() and dst_key not in dst_state:
        continue  # Target net not built yet during creation.
      target = dst_state[dst_key]
      target.copy_(mix * value + (1 - mix) * target)
  owner.write(name, torch.where(due, 0, updates) + 1)

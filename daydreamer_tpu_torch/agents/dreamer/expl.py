"""Intrinsic reward modules, the port of `daydreamer_tpu/agents/dreamer/
expl.py` (reference: embodied/agents/dreamerv2plus/expl.py:9-134).

Each module is called on an imagined trajectory and returns one reward per
transition; `train` fits it on the replay's posterior context."""

import numpy as np
import torch

from ... import nn
from ...models import nets

sg = nn.sg


class Disag(nn.Module):
  """Ensemble disagreement: std of N MLPs predicting the next stoch
  (reference: expl.py:9-46)."""

  def __init__(self, name, wm, act_space, config):
    super().__init__(name)
    # The ensemble heads consume the already-gathered feature tensor;
    # only the outer Input uses the configured keys (reference:
    # expl.py:12-15).
    self.config = config.update({'disag_head.inputs': ['tensor']})
    self.opt = self.sub('opt', nn.Optimizer, **config.expl_opt)
    self.inputs = nets.Input(config.disag_head.inputs, dims='deter')
    self.target = nets.Input(config.disag_target, dims='deter')
    self._nets = None

  def forward(self, traj):
    self._build(traj)
    inputs = self.inputs(traj)
    preds = torch.stack([head(inputs).mode() for head in self._nets], 0)
    # jnp.std: the population standard deviation.
    disag = preds.std(0, correction=0).mean(-1)
    if 'action' in self.config.disag_head.inputs:
      return disag[:-1]
    else:
      return disag[1:]

  def train(self, data):
    # Shift actions so action[t] leads to state[t+1], matching imagination
    # convention (reference: expl.py:29-36).
    data = {**data, 'action': torch.cat(
        [data['action'][:, 1:], 0 * data['action'][:, :1]], 1)}
    self._build(data)
    inputs = sg(self.inputs(data)[:, :-1])
    target = sg(self.target(data)[:, 1:].float())

    def lossfn():
      preds = [head(inputs) for head in self._nets]
      return -sum(pred.log_prob(target).mean() for pred in preds)

    mets, _ = self.opt(lossfn, self._nets)
    return mets

  def _build(self, data):
    if not self._nets:
      size = self.target(data).shape[-1]
      self._nets = [
          self.sub(f'head{i}', nets.MLP, size, **self.config.disag_head)
          for i in range(self.config.disag_models)]


class LatentVAE(nn.Module):
  """ELBO surprise reward (reference: expl.py:49-92)."""

  def __init__(self, name, wm, act_space, config):
    super().__init__(name)
    self.config = config
    self.enc = self.sub('enc', nets.MLP, **config.expl_enc)
    self.dec = self.sub(
        'dec', nets.MLP, config.rssm.deter, **config.expl_dec)
    self._shape = tuple(config.expl_enc.shape)
    self.kl = self.sub('kl', nn.AutoAdapt, (), **config.expl_kl)
    self.opt = self.sub('opt', nn.Optimizer, **config.expl_opt)

  def _prior(self):
    shape = self._shape
    zeros = torch.zeros(shape, device=nn.device())
    if self.config.expl_enc.dist == 'onehot':
      return nn.Independent(nn.OneHotDist(zeros), len(shape) - 1)
    else:
      return nn.Independent(nn.Normal(zeros, torch.ones_like(zeros)),
                            len(shape))

  def _flatten(self, x):
    dims = len(self._shape)
    return x.reshape(tuple(x.shape[:-dims]) + (
        int(np.prod(x.shape[-dims:])),))

  def forward(self, traj):
    dist = self.enc(traj)
    target = sg(traj['deter'].float())
    ll = self.dec(self._flatten(dist.sample(nn.rng()))).log_prob(target)
    if self.config.expl_vae_elbo:
      kl = dist.kl(self._prior())
      reward = kl - ll / self.kl.scale()
    else:
      reward = -ll
    return reward[1:]

  def train(self, data):
    metrics = {}
    target = sg(data['deter'].float())

    def lossfn():
      dist = self.enc(data)
      kl = dist.kl(self._prior())
      kl, mets = self.kl(kl)
      ll = self.dec(self._flatten(dist.sample(nn.rng()))).log_prob(target)
      assert kl.shape == ll.shape, (kl.shape, ll.shape)
      loss = (kl - ll).mean()
      return loss, kl.detach().mean(), ll.detach().mean(), sg(mets)

    omets, (vae_kl, vae_ll, mets) = self.opt(lossfn, [self.enc, self.dec])
    metrics.update({f'kl_{k}': v for k, v in mets.items()})
    metrics['vae_kl'] = vae_kl
    metrics['vae_ll'] = vae_ll
    metrics.update(omets)
    return metrics


class CtrlDisag(nn.Module):
  """Disagreement in a controllability embedding trained by inverse
  dynamics (reference: expl.py:95-115)."""

  def __init__(self, name, wm, act_space, config):
    super().__init__(name)
    self.disag = self.sub(
        'disag', Disag, wm, act_space,
        config.update({'disag_target': ['ctrl']}))
    self.embed = self.sub(
        'embed', nets.MLP, (config.ctrl_size,), **config.ctrl_embed)
    self.head = self.sub(
        'head', nets.MLP, act_space.shape, **config.ctrl_head)
    self.opt = self.sub('opt', nn.Optimizer, **config.ctrl_opt)

  def forward(self, traj):
    return self.disag({**traj, 'ctrl': self.embed(traj).mode()})

  def train(self, data):
    metrics = {}

    def lossfn():
      ctrl = self.embed(data).mode()
      dist = self.head({'current': ctrl[:, :-1], 'next': ctrl[:, 1:]})
      loss = -dist.log_prob(data['action'][:, 1:]).mean()
      return loss, ctrl.detach()

    mets, (ctrl,) = self.opt(lossfn, [self.embed, self.head])
    metrics.update(mets)
    metrics.update(self.disag.train({**data, 'ctrl': ctrl}))
    return metrics


class PBE(nn.Module):
  """Particle-based entropy via kNN distances (reference: expl.py:118-134).

  The distances of every pair of the N = (H + 1) * B * T states are those
  of the JAX package's `[N, N, D]` differences, computed pairwise by
  `torch.cdist` without the matrix-product form, which keeps each state's
  distance to itself exactly 0 (the kNN counts it, as the reference's
  does); in float32 whatever the compute dtype. Under data parallelism the
  neighbours are those among the rank's own states, not the global
  batch's (PBE cannot train in either package, so nothing reads that)."""

  def __init__(self, name, wm, act_space, config):
    super().__init__(name)
    self.config = config
    self.inputs = nets.Input(config.pbe_inputs, dims='deter')

  def forward(self, traj):
    feat = self.inputs(traj)
    flat = feat.reshape(-1, feat.shape[-1]).float()
    dists = torch.cdist(
        flat, flat, compute_mode='donot_use_mm_for_euclid_dist')
    knn = torch.topk(dists, self.config.pbe_knn, -1, largest=False).values
    rew = knn.mean(-1)
    return rew.reshape(tuple(feat.shape[:-1]))

  def train(self, data):
    return {}

"""PPO trainer for motion imitation: the port of
`daydreamer_tpu/imitation/ppo.py`.

A clipped-surrogate PPO with GAE on the port's module system: the actor
critic and its Adam optimizer carry the JAX package's state names
(`ppo/...`, `ppo_opt/step`, `ppo_opt/m/...`, `ppo_opt/v/...`), so `load`
takes what the JAX agent's `save` gives and `save` gives what its `load`
takes. The JAX update is one jitted program of `epochs x minibatches`
optimizer steps; here the same steps run on the agent's device, each epoch
over a permutation drawn from the agent's generator, and the metrics
returned are the last step's, as there. One `torch.Generator`, seeded from
`seed`, serves sampling and permutations (`jax.random` cannot be
reproduced), so the two packages agree on log-probs and values of given
actions, not on samples.

`act` and `update` are what the JAX trainer jits. With `graphs=True` (the
default) each is captured once per input shape as a CUDA graph on the card
and replayed (`agents/dreamer/graphs.py`, the Dreamer agent's
`torch.graphs`): `act` holds the sample, its log-prob, the value and their
concatenation, `update` every optimizer step and the stacking of the
metrics; the one copy to the host follows each replay. `graphs=False` runs
them eagerly. The creation pass, `mean_act` (not jitted in the JAX trainer
either) and the host-side `gae` stay eager. On the CPU the graph runner's
bookkeeping calls the functions eagerly.
"""

import numpy as np
import torch

from .. import nn
from ..agents.dreamer import graphs as graphslib
from ..nn import dists
from ..nn.module import Module
from ..models.nets import MLP


def resolve_device(device):
  """`device` as a `torch.device`; a CUDA device without a card raises
  instead of running on the CPU unasked."""
  device = torch.device(device)
  if device.type == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError(
        f'The device is {device} but no CUDA device is available; ask for '
        f'the CPU (device cpu, --platform cpu) to run there.')
  return device


class ActorCritic(Module):

  def __init__(self, name, act_dim, layers=2, units=256):
    super().__init__(name)
    self._actor = self.sub('actor', MLP, None, layers, units, act='tanh')
    self._mean = self.sub('mean', nn.Linear, act_dim, outscale=0.01)
    self._critic = self.sub('critic', MLP, (), layers, units, act='tanh',
                            dist='mse')

  def dist(self, obs):
    feat = self._actor({'tensor': obs})
    mean = torch.tanh(self._mean(feat))
    log_std = self.value(
        'log_std', lambda: torch.zeros(mean.shape[-1], dtype=torch.float32))
    return dists.Independent(dists.Normal(mean, torch.exp(log_std)), 1)

  def value_fn(self, obs):
    return self._critic({'tensor': obs}).mode()


class PPOImitation:
  """PPO agent with the embodied policy surface (obs dict in, act out).

  Runs on `device`, the card unless the caller names the CPU; `graphs`
  captures `act` and `update` there (see the module's docstring)."""

  def __init__(self, obs_dim, act_dim, lr=3e-4, gamma=0.95, lam=0.95,
               clip=0.2, epochs=10, minibatches=4, ent_coef=0.0,
               horizon=2048, seed=0, device='cuda', graphs=True):
    self.device = resolve_device(device)
    self.net = ActorCritic('ppo', act_dim)
    self.opt = nn.Optimizer('ppo_opt', lr, eps=1e-5, clip=0.5)
    # Holds both trees so that one state dict covers them; their entries
    # keep their own paths.
    self._root = Module('ppo_agent')
    self._root.add_module('net', self.net)
    self._root.add_module('opt', self.opt)
    self.gamma, self.lam, self.clip = gamma, lam, clip
    self.epochs, self.minibatches = epochs, minibatches
    self.ent_coef = ent_coef
    self.horizon = horizon
    self.generator = torch.Generator(device=self.device)
    self.generator.manual_seed(seed)
    self._use_graphs = bool(graphs)
    self.graphs = graphslib.Runner(self.device, [self.generator])
    # Creation pass on tiny data allocates every entry, optimizer slots
    # included.
    with self._scope(create=True):
      with torch.no_grad():
        self._act_fn(torch.zeros((1, obs_dim), device=self.device))
      batch = dict(obs=torch.zeros((8, obs_dim)),
                   action=torch.zeros((8, act_dim)), logp=torch.zeros(8),
                   adv=torch.zeros(8), ret=torch.zeros(8))
      self._metric_names = sorted(self._update_fn(self._to_device(batch)))

  def _scope(self, create=False):
    return nn.scope(generator=self.generator, create=create)

  def _tensor(self, x):
    return torch.tensor(np.asarray(x, np.float32), device=self.device)

  def _to_device(self, data):
    return {k: self._tensor(v) for k, v in data.items()}

  def _act_fn(self, obs):
    d = self.net.dist(obs)
    action = d.sample(nn.rng())
    return (action, d.log_prob(action)), self.net.value_fn(obs)

  def _loss(self, batch):
    d = self.net.dist(batch['obs'])
    logp = d.log_prob(batch['action'])
    ratio = torch.exp(logp - batch['logp'])
    adv = batch['adv']
    # The population std, as numpy's and jnp's `std()`.
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    surr = torch.minimum(
        ratio * adv,
        torch.clamp(ratio, 1 - self.clip, 1 + self.clip) * adv)
    value = self.net.value_fn(batch['obs'])
    vloss = ((value - batch['ret']) ** 2).mean()
    ent = d.entropy().mean()
    loss = -surr.mean() + 0.5 * vloss - self.ent_coef * ent
    return loss, {'policy_loss': -surr.mean(), 'value_loss': vloss,
                  'entropy': ent}

  def _update_fn(self, batch):
    n = batch['obs'].shape[0]
    assert n % self.minibatches == 0, (n, self.minibatches)
    mb = n // self.minibatches
    metrics = {}
    for _ in range(self.epochs):
      perm = torch.randperm(n, generator=nn.rng(), device=self.device)
      shuffled = {k: v[perm] for k, v in batch.items()}
      for j in range(self.minibatches):
        sl = {k: v[j * mb:(j + 1) * mb] for k, v in shuffled.items()}
        mets, (aux,) = self.opt(self._loss, [self.net], sl)
        metrics = {**mets, **aux}
    return nn.sg(metrics)

  def _run(self, name, fn, inputs):
    """`fn(inputs)` through its graph, or eagerly on the device without
    graphs; the output fetched to the host in one copy."""
    if not self._use_graphs:
      return fn(self._to_device(inputs)).cpu()
    inputs = {k: torch.as_tensor(np.asarray(v, np.float32))
              for k, v in inputs.items()}
    return self.graphs(name, None, fn, (inputs,)).cpu()

  def _act_step(self, inputs):
    with torch.no_grad(), self._scope():
      (action, logp), value = self._act_fn(inputs['obs'])
      return torch.cat([action, logp[:, None], value[:, None]], -1)

  def act(self, obs):
    """Sampled actions, their log-probs and the values, as numpy arrays,
    fetched from the device in one copy."""
    out = self._run('act', self._act_step, {'obs': obs}).numpy()
    return out[:, :-2], out[:, -2], out[:, -1]

  def mean_act(self, obs):
    """Deterministic (mode) action, used for evaluation."""
    with torch.no_grad(), self._scope():
      action = self.net.dist(self._tensor(obs)).mode()
    return action.cpu().numpy()

  def gae(self, rewards, values, conts, last_value):
    """Host-side GAE over one rollout segment."""
    n = len(rewards)
    adv = np.zeros(n, np.float32)
    lastgaelam = 0.0
    for t in reversed(range(n)):
      nextv = last_value if t == n - 1 else values[t + 1]
      delta = rewards[t] + self.gamma * conts[t] * nextv - values[t]
      lastgaelam = delta + self.gamma * self.lam * conts[t] * lastgaelam
      adv[t] = lastgaelam
    return adv, adv + values

  def _update_step(self, batch):
    with self._scope():
      metrics = self._update_fn(batch)
    return torch.stack([metrics[k].float() for k in self._metric_names])

  def update(self, rollout):
    values = self._run('update', self._update_step, rollout).numpy()
    return {k: float(v) for k, v in zip(self._metric_names, values)}

  def save(self):
    """Every state entry by its JAX name, as numpy arrays in the JAX
    layout."""
    return nn.to_jax_state(nn.state(self._root), nn.kinds(self._root))

  def load(self, data):
    nn.assign(self._root, nn.from_jax_state(data, nn.kinds(self._root)))

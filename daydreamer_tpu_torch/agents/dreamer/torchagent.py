"""PyTorch backend wrapper: device, dtype, generator, creation pass,
metrics, checkpoints. The port of `daydreamer_tpu/agents/dreamer/
jaxagent.py` (reference: embodied/agents/dreamerv2plus/tfagent.py:14-178).

- The agent runs on the device that `config.torch.device` names, the card
  by default; asking for CUDA where there is none raises. The CPU runs
  only when asked (`--torch.device cpu`).
- `config.torch.precision: bfloat16` means what `nn.cast_to_compute` means
  in the JAX package: layers compute in bf16, parameters and optimizer
  state stay float32, norms and distribution statistics run in float32.
- One `torch.Generator` on the device per agent carries every random draw.
- The state is created by an explicit pass on dummy zero batches built
  from the spaces, on the first call of any entry point.
- `save()` returns a flat dict of numpy arrays under the JAX package's
  names and layouts; `load()` takes such a dict in the three forms of
  `jaxagent.py` (exact names, a strict subset, a name-sorted zip).
"""

import numpy as np
import torch

from ... import nn


class LazyMetrics(dict):
  """Metrics view that defers the device->host copy until first read.

  A train step returns its scalar metrics packed in one device tensor, so
  a loop can submit steps back to back and sync only when it logs."""

  def __init__(self, names, packed, fused=False):
    super().__init__()
    self._names = names
    self._packed = packed
    self._fused = fused
    self._done = False

  @classmethod
  def materialize_all(cls, mets_list):
    """Fetch every pending packed tensor in ONE device->host copy."""
    pending = [m for m in mets_list if isinstance(m, cls) and not m._done]
    if pending:
      flat = torch.cat([m._packed.reshape(-1) for m in pending]).cpu()
      sizes = [m._packed.numel() for m in pending]
      for m, values in zip(pending, torch.split(flat, sizes)):
        m._materialize(values.reshape(m._packed.shape).numpy())
    return mets_list

  def ensure_done(self):
    """Block until this step has executed (loop backpressure)."""
    if self._done or getattr(self, '_synced', False):
      return
    if self._packed is not None:
      self._packed.reshape(-1)[0].item()
    self._synced = True

  def _materialize(self, values=None):
    if not self._done:
      values = self._packed.cpu().numpy() if values is None else values
      if self._fused:  # Several updates: [steps, metrics].
        merged = {}
        for i, name in enumerate(self._names):
          col = values[:, i]
          if name.endswith('_max'):
            merged[name] = col.max()
          elif name.endswith('_min'):
            merged[name] = col.min()
          else:
            merged[name] = col.mean()
        super().update(merged)
      else:
        super().update(dict(zip(self._names, values)))
      self._done = True
      self._packed = None

  def __getitem__(self, key):
    self._materialize()
    return super().__getitem__(key)

  def __contains__(self, key):
    self._materialize()
    return super().__contains__(key)

  def __iter__(self):
    self._materialize()
    return super().__iter__()

  def __len__(self):
    self._materialize()
    return super().__len__()

  def keys(self):
    self._materialize()
    return super().keys()

  def values(self):
    self._materialize()
    return super().values()

  def items(self):
    self._materialize()
    return super().items()


def Wrapper(agent_cls):
  class Agent(TorchAgent):
    configs = agent_cls.configs
    inner = agent_cls

    def __init__(self, obs_space, act_space, step, config):
      super().__init__(agent_cls, obs_space, act_space, step, config)
  return Agent


def _to_numpy(tree):
  return nn.tree_map(
      lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
      else x, tree)


class TorchAgent:

  def __init__(self, agent_cls, obs_space, act_space, step, config):
    self.config = config
    self.obs_space = obs_space
    self.act_space = act_space
    self.device = torch.device(config.torch.device)
    if self.device.type == 'cuda' and not torch.cuda.is_available():
      raise RuntimeError(
          'torch.device is cuda but no CUDA device is available; pass '
          '--torch.device cpu to run on the CPU.')
    self.dtype = {'bfloat16': torch.bfloat16, 'float32': torch.float32}[
        config.torch.precision]
    self.generator = torch.Generator(device=self.device)
    self.generator.manual_seed(int(config.seed))
    self.agent = agent_cls('agent', obs_space, act_space, step, config)
    self._metric_names = None
    self._policy_read_log = set()
    self._created = False

  def _scope(self, create=False, read_log=None):
    return nn.scope(dtype=self.dtype, generator=self.generator,
                    create=create, read_log=read_log)

  # -- creation --------------------------------------------------------------

  def _create(self):
    """Creation pass on dummy zero batches derived from the spaces: runs
    every entry point once so every state entry exists."""
    if self._created:
      return
    B, T = 2, 8  # T >= 8 keeps the report's open-loop slicing valid.
    data = self._to_device(self._dummy_batch(B, T))
    obs = {k: v[:, 0] for k, v in data.items() if k != 'action'}
    log = self._policy_read_log
    with self._scope(create=True):
      carry = self.agent.train_initial(B)
      _, _, mets = self.agent.train(data, carry)
      self._metric_names = sorted(mets.keys())
    with torch.no_grad():
      with self._scope(create=True, read_log=log):
        state = self.agent.policy_initial(B)
        for mode in ('train', 'eval', 'explore'):
          self.agent.policy(obs, state, mode=mode)
      with self._scope(create=True):
        self.agent.report(data)
    self._created = True
    values = nn.state(self.agent)
    params = sum(v.numel() for v in self.agent.parameters())
    total = sum(v.numel() for v in values.values())
    print(f'Created agent state: {params:,} trainable parameters, '
          f'{total:,} total values.')

  def _dummy_batch(self, B, T):
    data = {}
    for key, space in self.obs_space.items():
      if key.startswith('log_'):
        continue
      data[key] = np.zeros((B, T) + space.shape, space.dtype)
    for key, space in self.act_space.items():
      if key == 'reset':
        continue
      data[key] = np.zeros((B, T) + space.shape, space.dtype)
    data['is_first'][:, 0] = True
    return data

  def _to_device(self, data):
    out = {}
    for key, value in data.items():
      if key.startswith('log_') or key == 'key':
        continue
      if isinstance(value, torch.Tensor):
        out[key] = value.to(self.device)
      else:
        out[key] = torch.as_tensor(np.asarray(value), device=self.device)
    return out

  # -- entry points ----------------------------------------------------------

  def policy(self, obs, state=None, mode='train'):
    self._create()
    obs = self._to_device(obs)
    with torch.no_grad(), self._scope():
      if state is None:
        state = self.agent.policy_initial(len(obs['is_first']))
      outs, state = self.agent.policy(obs, state, mode=mode)
    return _to_numpy(outs), state

  def _train_step(self, data, state):
    with self._scope():
      if state is None:
        state = self.agent.train_initial(len(data['is_first']))
      outs, state, mets = self.agent.train(data, state)
    packed = torch.stack([
        torch.as_tensor(mets[k], device=self.device).float().reshape(())
        for k in self._metric_names])
    return outs, state, packed

  def train(self, data, state=None):
    self._create()
    keys = data.get('key')
    outs, state, packed = self._train_step(self._to_device(data), state)
    outs = _to_numpy(outs)
    if keys is not None and 'priority' in outs:
      outs['key'] = keys
    return outs, state, LazyMetrics(self._metric_names, packed)

  def train_multi(self, datas, state=None):
    """len(datas) gradient updates in a row; the metrics are merged over
    them as the JAX package's fused dispatch merges them."""
    self._create()
    outs_list, packeds = [], []
    for data in datas:
      outs, state, packed = self._train_step(self._to_device(data), state)
      outs = _to_numpy(outs)
      if data.get('key') is not None and 'priority' in outs:
        outs['key'] = data['key']
      outs_list.append(outs)
      packeds.append(packed)
    outs = {k: np.stack([o[k] for o in outs_list]) for k in outs_list[0]}
    mets = LazyMetrics(self._metric_names, torch.stack(packeds), fused=True)
    return outs, state, mets

  def report(self, data):
    self._create()
    with torch.no_grad(), self._scope():
      report = self.agent.report(self._to_device(data))
    return _to_numpy(report)

  def dataset(self, generator):
    from ...core import Prefetch
    return Prefetch(
        sources=[generator] * self.config.batch_size, workers=8, prefetch=4)

  # -- checkpointing ---------------------------------------------------------

  def from_jax_state(self, values):
    """{name: array in the JAX layout} -> {name: tensor in the port's}."""
    self._create()
    return nn.from_jax_state(values, nn.kinds(self.agent))

  def save(self):
    self._create()
    values = nn.to_jax_state(nn.state(self.agent), nn.kinds(self.agent))
    count = int(sum(np.prod(x.shape) for x in values.values()))
    print(f'Saving agent with {len(values)} tensors and {count} values.')
    return values

  def save_policy(self):
    """Snapshot of ONLY the entries the policy reads (captured at
    creation): the actor's weight-sync payload."""
    self._create()
    live = nn.state(self.agent)
    subset = {k: live[k] for k in sorted(self._policy_read_log) if k in live}
    values = nn.to_jax_state(subset, nn.kinds(self.agent))
    count = int(sum(np.prod(x.shape) for x in values.values()))
    print(f'Saving policy snapshot with {len(values)} tensors and '
          f'{count} values.')
    return values

  def load(self, values):
    self._create()
    existing = nn.state(self.agent)
    count = int(sum(np.prod(np.shape(x)) for x in values.values()))
    print(f'Loading agent with {len(values)} tensors and {count} values.')
    if set(values) <= set(existing):
      # All names (or a policy-only subset merged into the live state).
      loaded = self.from_jax_state(values)
    else:
      # Name-sorted zip load for wire-format parity with checkpoints that
      # used different module naming (reference: tfutils.py:116-131).
      src = [v for _, v in sorted(values.items())]
      dst = sorted(existing)
      if len(src) != len(dst):
        raise ValueError(f'Cannot zip {len(src)} values into {len(dst)}.')
      loaded = self.from_jax_state(dict(zip(dst, src)))
    nn.assign(self.agent, loaded)

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
- `config.torch.debug_nans` raises FloatingPointError at the first NaN that
  an update (`train`, `train_multi`, `train_device`) or a policy call
  returns, as `jax.debug_nans` does for the JAX package's jitted calls: the
  outputs, the carried state, the metrics and, for an update, the agent's
  whole state after it. One host sync a call, so only when it is set;
  infinities pass, as they do there. Two NaNs are by design and pass: the
  creation pass is not checked, and neither are the balance diagnostics
  that `_reduce_plan` finds (`nn.BALANCE_RATIOS` beside their `X_rate`),
  which are NaN when a batch holds no example of a class.
  `jax.debug_nans` raises on both, so the JAX agent cannot even be created
  with it: its creation pass's zero batch has no positive reward.
- `config.torch.graphs` is the counterpart of `jax.jit`. `True` (the
  default), on the card: `train`, `train_multi`, `train_device` (one
  graph holds a ring draw, one update and, on a prioritized ring, the
  scatter of its priorities), `policy` (one graph per mode and batch
  size; the call with no state stays eager) and `report` (one graph per
  batch signature, the reduction of its scalars over the ranks inside)
  each capture their work once as a CUDA graph and replay it
  (`graphs.py`). `False` runs every call eagerly, as `jax.jit: False`
  does. On the CPU the same bookkeeping calls the functions eagerly. A
  capture that fails raises. Several ranks on the card capture their
  collectives with the rest under NCCL; under any other backend (gloo
  cannot be captured) `graphs: True` raises at construction. Host-side
  collectives (`host_local_batch`'s count check, the creation pass's
  `replicate`) stay outside every graph.
- `config.torch.policy_devices: cpu` serves the policy from a host-CPU
  mirror of the entries it reads, with a CPU generator of its own,
  refreshed at most every `policy_sync` train steps (`all`: the policy runs
  on the agent's device).
- The state is created by an explicit pass on dummy zero batches built
  from the spaces, on the first call of any entry point.
- `save()` returns a flat dict of numpy arrays under the JAX package's
  names and layouts; `load()` takes such a dict in the three forms of
  `jaxagent.py` (exact names, a strict subset, a name-sorted zip).
- Data parallelism (`parallel/`): in a process group of W ranks, the agent
  spans a `data` mesh over all of them, as the JAX agent's mesh spans its
  devices (`jaxagent.py:406-413`), and each rank trains on its
  `batch_size // W` rows. A batch size that W does not divide raises: the
  JAX agent drops devices until the count divides, but a rank cannot be
  dropped. `cuda` means the card `LOCAL_RANK` where that is set. Every rank
  creates the state alike, then takes rank 0's (`replicate`); from there
  the gradients, the controllers' statistics, the importance weights'
  maximum and DisagWhen's buffer are reduced over the ranks inside the
  update, so the replicas stay equal, and the packed metrics and the
  report's scalars are reduced as the JAX package's global ones read.
  Rank r seeds its generators from `seed + r * 2**32`, so rank 0 draws what
  a single process draws. `save` and `load` are the same on every rank.
"""

import collections
import copy

import numpy as np
import torch

from ... import nn
from ...parallel import distributed
from ...parallel import mesh as meshlib
from . import graphs as graphslib


# A group of `steps` training batches already stacked along a leading axis
# and (usually) resident on device: the payload of the fused train path.
# `keys` holds the per-step host-side PER keys (or None).
Prestacked = collections.namedtuple('Prestacked', 'data keys steps')


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


def _nan_paths(trees):
  """The paths of the floating tensors of `trees` (a dict of trees) that
  hold a NaN, fetched in one device->host copy."""
  paths, flags = [], []

  def visit(x, path):
    if isinstance(x, dict):
      for key, value in x.items():
        visit(value, f'{path}/{key}')
    elif isinstance(x, (tuple, list)):
      for i, value in enumerate(x):
        visit(value, f'{path}/{i}')
    elif isinstance(x, torch.Tensor) and x.is_floating_point():
      paths.append(path)
      flags.append(torch.isnan(x.detach()).any())

  for name, tree in trees.items():
    visit(tree, name)
  if not flags:
    return []
  flags = torch.stack(flags).cpu().tolist()
  return [path for path, flag in zip(paths, flags) if flag]


def _reduce_plan(names, device):
  """How each scalar of `names` combines over the ranks into the global
  batch's value: `_max` and `_min` by MAX and MIN; `X_std` beside `X_mean`
  from the ranks' variances and means; the ratios of `nn.balance_stats`
  (`nn.BALANCE_RATIOS`, beside their `X_rate`) weighted by each rank's
  share of that class; every other one, a mean over equal row counts, by
  the average."""
  index = {name: i for i, name in enumerate(names)}
  plan = {'mean': [], 'max': [], 'min': [], 'std': [], 'std_of': [],
          'ratio': [], 'ratio_of': [], 'positive': []}
  for i, name in enumerate(names):
    base, _, kind = name.rpartition('_')
    prefix, _, stat = base.rpartition('_')
    if kind in ('max', 'min'):
      plan[kind].append(i)
    elif kind == 'std' and f'{base}_mean' in index:
      plan['std'].append(i)
      plan['std_of'].append(index[f'{base}_mean'])
    elif (f'{stat}_{kind}' in nn.BALANCE_RATIOS
          and f'{prefix}_rate' in index):
      plan['ratio'].append(i)
      plan['ratio_of'].append(index[f'{prefix}_rate'])
      plan['positive'].append(nn.BALANCE_RATIOS[f'{stat}_{kind}'])
    else:
      plan['mean'].append(i)
  return {k: torch.tensor(v, dtype=torch.bool if k == 'positive' else
                          torch.long, device=device)
          for k, v in plan.items()}


def _reduce_scalars(plan, values):
  """The ranks' scalars `values` (1-D float32, in the order of the plan's
  names) combined as `_reduce_plan` says, in two collectives: one sum, one
  MAX. The identity for one rank."""
  world = distributed.world_size()
  if world == 1:
    return values
  means = values[plan['mean']]
  variances = values[plan['std']] ** 2
  # Each rank's means of the std entries in its own slot of a [world, n]
  # block: the sum gathers them all.
  slots = values.new_zeros((world, len(plan['std'])))
  slots[distributed.rank()] = values[plan['std_of']]
  rate = values[plan['ratio_of']]
  share = torch.where(plan['positive'], rate, 1 - rate)
  weighted = torch.where(share > 0, values[plan['ratio']] * share,
                         torch.zeros_like(share))
  sums = torch.cat([means, variances, slots.reshape(-1), weighted, share])
  torch.distributed.all_reduce(sums)
  means, variances, slots, weighted, share = sums.split(
      [len(means), len(variances), slots.numel(), len(weighted),
       len(share)])
  slots = slots.reshape(world, -1)
  spread = ((slots - slots.mean(0)) ** 2).mean(0)
  extremes = torch.cat([values[plan['max']], -values[plan['min']]])
  torch.distributed.all_reduce(extremes, op=torch.distributed.ReduceOp.MAX)
  out = values.clone()
  out[plan['mean']] = means / world
  out[plan['std']] = torch.sqrt(variances / world + spread)
  out[plan['ratio']] = weighted / share
  out[plan['max']] = extremes[:len(plan['max'])]
  out[plan['min']] = -extremes[len(plan['max']):]
  return out


class TorchAgent:

  def __init__(self, agent_cls, obs_space, act_space, step, config):
    self.config = config
    self.obs_space = obs_space
    self.act_space = act_space
    self.device = distributed.local_device(config.torch.device)
    if self.device.type == 'cuda' and not torch.cuda.is_available():
      raise RuntimeError(
          'torch.device is cuda but no CUDA device is available; pass '
          '--torch.device cpu to run on the CPU.')
    world = distributed.world_size()
    if config.batch_size % world:
      raise ValueError(f'batch_size {config.batch_size} does not split over '
                       f'{world} ranks.')
    self._local_batch = config.batch_size // world
    self.mesh = None
    if torch.distributed.is_initialized():
      if self.device.type == 'cuda' and self.device.index is not None:
        torch.cuda.set_device(self.device)
      self.mesh = meshlib.make_mesh({'data': world}, device_type=(
          self.device.type))
    seed = int(config.seed) + distributed.rank() * 2 ** 32
    self.dtype = {'bfloat16': torch.bfloat16, 'float32': torch.float32}[
        config.torch.precision]
    self._debug_nans = bool(config.torch.debug_nans)
    self.generator = torch.Generator(device=self.device)
    self.generator.manual_seed(seed)
    self._use_graphs = bool(config.torch.graphs)
    if self._use_graphs and self.device.type == 'cuda' and world > 1 and (
        torch.distributed.get_backend() != 'nccl'):
      raise ValueError(
          f'torch.graphs is True on {world} ranks over '
          f'{torch.distributed.get_backend()}: a CUDA graph captures NCCL\'s '
          'collectives only; use the nccl backend or pass --torch.graphs '
          'False.')
    self.graphs = graphslib.Runner(self.device, [self.generator])
    self.agent = agent_cls('agent', obs_space, act_space, step, config)
    # Metric policy of the fused entry points (`train_multi`,
    # `train_device`): 'all' packs every update's metrics (merged at fetch
    # time); 'last' packs only the final update's, which saves the other
    # updates' hundred small packing launches (the reference likewise logs
    # the current step's metrics when the log cadence fires).
    self._fused_metrics = str(config.torch.fused_metrics)
    if self._fused_metrics not in ('all', 'last'):
      raise ValueError(f'torch.fused_metrics: {self._fused_metrics}')
    self._metric_names = None
    self._policy_read_log = set()
    self._created = False
    # Host-CPU policy mirror (the JAX package's jaxagent.py:291-312): the
    # policy runs on the host against a copy of the entries it reads,
    # refreshed from the live state at most every `policy_sync` train
    # steps, the staleness of the reference's actor/learner checkpoint
    # polling (reference: acting.py:82-96). Built at the first policy call.
    self._policy_devices = str(config.torch.policy_devices)
    if self._policy_devices not in ('all', 'cpu'):
      raise ValueError(f'torch.policy_devices: {self._policy_devices}')
    self._policy_sync = int(config.torch.policy_sync)
    self._policy_generator = torch.Generator(device='cpu')
    self._policy_generator.manual_seed(seed)
    self._mirror = None
    self._mirror_at = None  # Train step of the last refresh; None: due.
    self._mirror_syncs = 0
    self._train_steps = 0

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
        report = self.agent.report(data)
    self._created = True
    self._metric_plan = _reduce_plan(self._metric_names, self.device)
    # The report's scalars and their plan, made here: a captured report
    # cannot copy a plan from the host.
    self._report_names = sorted(
        k for k, v in report.items() if isinstance(v, torch.Tensor)
        and v.ndim == 0 and v.is_floating_point())
    self._report_plan = _reduce_plan(self._report_names, self.device)
    # The balance ratios by the plan's rule: NaN where a batch holds no
    # example of a class, so `torch.debug_nans` lets them pass.
    self._ratio_names = frozenset(
        self._metric_names[i] for i in self._metric_plan['ratio'].tolist())
    values = nn.state(self.agent)
    if self.mesh is not None:
      meshlib.replicate(values, self.mesh)
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

  def _to_device(self, data, device=None):
    device = self.device if device is None else device
    out = {}
    for key, value in data.items():
      if key.startswith('log_') or key == 'key':
        continue
      if isinstance(value, torch.Tensor):
        out[key] = value.to(device)
      else:
        out[key] = torch.as_tensor(np.asarray(value), device=device)
    return out

  def _tensors(self, data):
    """The entries of `data` that `_to_device` keeps, as tensors where they
    lie (numpy on the CPU): what a graph's static buffers are loaded from,
    in one copy each."""
    return {k: v if isinstance(v, torch.Tensor) else torch.as_tensor(
        np.asarray(v)) for k, v in data.items()
            if not (k.startswith('log_') or k == 'key')}

  # -- host-CPU policy mirror --------------------------------------------------

  def _policy_agent(self):
    """The module the policy runs on and its generator: the agent itself,
    or the host mirror, refreshed first when it is due."""
    if self._policy_devices == 'all':
      return self.agent, self.generator
    if self._mirror is None:
      self._mirror = self._build_mirror()
    due = self._mirror_at is None or (
        self._train_steps - self._mirror_at >= self._policy_sync
        and self._mirror_at != self._train_steps)
    if due:
      live = nn.state(self.agent)
      nn.assign(self._mirror, {k: live[k] for k in nn.state(self._mirror)})
      self._mirror_at = self._train_steps
      self._mirror_syncs += 1
    return self._mirror, self._policy_generator

  def _build_mirror(self):
    """A copy of the agent's module tree on the CPU that holds only the
    entries the policy reads (captured at creation). The non-trainable
    entries live in plain dicts that `Module.to()` does not move, so every
    entry is mapped to its CPU copy explicitly; the values are filled in by
    the first refresh."""
    live = nn.state(self.agent)
    read = {k for k in self._policy_read_log if k in live}
    memo = {}
    for key, value in live.items():
      if key in read:
        copied = torch.empty_like(value, device='cpu')
        if isinstance(value, torch.nn.Parameter):
          copied = torch.nn.Parameter(copied, requires_grad=False)
        memo[id(value)] = copied
      else:
        memo[id(value)] = value  # Not copied; dropped below.
    mirror = copy.deepcopy(self.agent, memo)
    for module in mirror.modules():
      if not isinstance(module, nn.Module):
        continue
      for entries in (module._parameters, module.values):
        for name in list(entries):
          if f'{module.path}/{name}' not in read:
            del entries[name]
    return mirror

  # -- entry points ----------------------------------------------------------

  @staticmethod
  def _check_nans(where, **trees):
    """Raises FloatingPointError if a floating tensor of `trees` holds a
    NaN (called under `torch.debug_nans` only: one host sync)."""
    paths = _nan_paths(trees)
    if paths:
      raise FloatingPointError(
          f'invalid value (nan) encountered in {where}: {paths[:8]}'
          f'{" ..." if len(paths) > 8 else ""} ({len(paths)} tensors)')

  def policy(self, obs, state=None, mode='train'):
    self._create()
    agent, generator = self._policy_agent()
    if self._use_graphs and state is not None and agent is self.agent:
      obs = self._tensors(obs)
      outs, state = self.graphs(
          'policy', mode, lambda o, s: self._policy_step(o, s, mode),
          (obs, state))
    else:
      obs = self._to_device(obs, generator.device)
      with torch.no_grad(), nn.scope(dtype=self.dtype, generator=generator):
        if state is None:
          state = agent.policy_initial(len(obs['is_first']))
        outs, state = agent.policy(obs, state, mode=mode)
    if self._debug_nans:
      self._check_nans('policy', outs=outs, state=state)
    return _to_numpy(outs), state

  def _policy_step(self, obs, state, mode):
    with torch.no_grad(), self._scope():
      return self.agent.policy(obs, state, mode=mode)

  def _train_step(self, data, state, pack=True, check=True):
    with self._scope():
      if state is None:
        state = self.agent.train_initial(len(data['is_first']))
      outs, state, mets = self.agent.train(data, state)
    if check and self._debug_nans:
      checked = {k: v for k, v in mets.items()
                 if k not in self._ratio_names}
      self._check_nans('train', outs=outs, state=state, metrics=checked,
                       agent=nn.state(self.agent))
    packed = None
    if pack:
      packed = _reduce_scalars(self._metric_plan, torch.stack([
          torch.as_tensor(mets[k], device=self.device).float().reshape(())
          for k in self._metric_names]))
    return outs, state, packed

  def _check_packed(self, outs, state, packed):
    """`torch.debug_nans` after a captured update: its outputs, its carry,
    its packed metrics (but the balance ratios) and the agent's state."""
    checked = {k: packed[..., i] for i, k in enumerate(self._metric_names)
               if k not in self._ratio_names}
    self._check_nans('train', outs=outs, state=state, metrics=checked,
                     agent=nn.state(self.agent))

  def _graphed_update(self, data, state):
    """One update through the `train` graph of batches like `data` (on any
    device); returns (outs, state, packed), cloned out of the graph. A
    call with no carry runs eagerly: its carry's start is the learned
    initial state, whose parameters its gradient reaches."""
    if state is None:
      return self._train_step(self._to_device(data), None)
    outs, state, packed = self.graphs(
        'train', None,
        lambda d, s: self._train_step(d, s, pack=True, check=False),
        (data, state))
    if self._debug_nans:
      self._check_packed(outs, state, packed)
    return outs, state, packed

  def _fused_steps(self, steps, update):
    """`steps` updates in a row under the fused metric policy. `update(i,
    pack)` makes update i and returns its packed metrics. Returns the
    metrics of the group."""
    packeds = []
    for i in range(steps):
      pack = self._fused_metrics == 'all' or i == steps - 1
      packed = update(i, pack)
      if pack:
        packeds.append(packed)
    return LazyMetrics(self._metric_names, torch.stack(packeds), fused=True)

  def train(self, data, state=None):
    self._create()
    keys = data.get('key')
    if self._use_graphs:
      outs, state, packed = self._graphed_update(self._tensors(data), state)
    else:
      outs, state, packed = self._train_step(self._to_device(data), state)
    self._train_steps += 1
    outs = _to_numpy(outs)
    if keys is not None and 'priority' in outs:
      outs['key'] = keys
    return outs, state, LazyMetrics(self._metric_names, packed)

  def train_multi(self, datas, state=None):
    """len(datas) gradient updates in a row, or the `steps` of a
    `Prestacked` group; the same updates as one `train` call per batch,
    with outs stacked along a leading axis and the metrics merged over
    the group as the JAX package's fused dispatch merges them. Under
    `torch.graphs` each update replays the `train` graph, its batch copied
    into the graph's static buffer first."""
    self._create()
    if isinstance(datas, Prestacked):
      stacked, keys, steps = datas
      batches = [{k: v[i] for k, v in stacked.items()} for i in range(steps)]
    else:
      if not datas:
        raise ValueError('train_multi needs at least one batch.')
      keys = [data.get('key') for data in datas]
      batches, steps = datas, len(datas)
    outs_list = []
    carry = [state]

    def update(i, pack):
      if self._use_graphs:
        outs, carry[0], packed = self._graphed_update(
            self._tensors(batches[i]), carry[0])
      else:
        outs, carry[0], packed = self._train_step(
            self._to_device(batches[i]), carry[0], pack)
      outs_list.append(outs)
      return packed

    mets = self._fused_steps(steps, update)
    self._train_steps += steps
    outs = _to_numpy(
        {k: torch.stack([o[k] for o in outs_list]) for k in outs_list[0]})
    if keys[0] is not None and 'priority' in outs:
      outs['key'] = np.stack(keys)
    return outs, carry[0], mets

  def device_feed(self, source, steps):
    """Iterator of Prestacked groups for `train_multi`, one group ahead.

    Pulls `steps` batches from `source`, stacks them along a leading axis
    (GIL-released C++ gather) into pinned memory and starts their
    host->device copy on a stream of its own one group before the consumer
    needs it: a train call returns before the card has finished, so the
    stacking and the copy of group N+1 run while the card still trains on
    group N (reference capability: tf.data prefetch-to-device,
    agent.py:108-121). Deliberately
    single-threaded, like the JAX package's: produced inline, in the gap
    that the device's work leaves the host.
    """
    self._create()
    from ...replay.batcher import native_stack
    it = iter(source)
    on_card = self.device.type == 'cuda'
    stream = torch.cuda.Stream(self.device) if on_card else None

    def produce():
      datas = [dict(next(it)) for _ in range(steps)]
      keys = [d.pop('key', None) for d in datas]
      names = [k for k in datas[0] if not k.startswith('log_')]
      stacked = native_stack([{k: d[k] for k in names} for d in datas])
      stacked = {k: torch.from_numpy(v) for k, v in stacked.items()}
      if not on_card:
        return Prestacked(stacked, keys, steps), None
      with torch.cuda.stream(stream):
        stacked = {k: v.pin_memory().to(self.device, non_blocking=True)
                   for k, v in stacked.items()}
        copied = torch.cuda.Event()
        copied.record(stream)
      return Prestacked(stacked, keys, steps), copied

    def groups():
      ahead = produce()
      while True:
        (group, copied), ahead = ahead, produce()
        if copied is not None:
          # The consumer's stream waits for the copy, and the copy's
          # memory is not handed out again while that stream may read it.
          current = torch.cuda.current_stream(self.device)
          current.wait_event(copied)
          for value in group.data.values():
            value.record_stream(current)
        yield group

    return groups()

  def train_device(self, replay, steps, state=None):
    """Run `steps` gradient updates sampling from a DeviceReplay.

    Per update a chunk sample on the device (uniform windows over the
    device-resident step ring, or priority-proportional ones when the
    ring is prioritized) and a train step, so no training data crosses the
    host->device link and nothing waits for the device. The prioritized
    variant writes each update's priorities back into the ring at the
    sampled rows, so update k draws from the priorities of update k - 1.

    Returns (outs, state, metrics) like `train`, with outs empty. Under
    `torch.graphs` the K updates are K replays of one graph, whose packed
    metrics are copied into a [K, M] buffer (its last row only under
    `fused_metrics: last`).
    """
    from ...replay import device_replay as drlib
    self._create()
    if replay.filled < replay.chunk:
      raise ValueError(f'The ring holds {replay.filled} steps, under one '
                       f'chunk of {replay.chunk}.')
    if replay.chunk != self.config.replay_chunk:
      raise ValueError(f'The ring\'s chunk {replay.chunk} is not the '
                       f'config\'s {self.config.replay_chunk}.')
    batch, chunk = self._local_batch, self.config.replay_chunk
    # Match the host FixedLength sampler's episode-boundary oversampling
    # so run=learning has the same data distribution on both paths.
    prio_ends = float(self.config.replay_fixed.prio_ends)
    exponent = float(self.config.replay_prio.exponent)
    constant = float(self.config.replay_prio.constant)

    def update(carry, pack, check=True):
      # The ring's counts as device scalars: a graph reads them at replay.
      ring_state = replay.device_state
      if replay.prioritized:
        data, rows = drlib.sample_prioritized(
            ring_state, replay.prios, self.generator, batch, chunk,
            exponent, constant)
      else:
        data = drlib.sample(
            ring_state, self.generator, batch, chunk, prio_ends)
      outs, carry, packed = self._train_step(data, carry, pack, check)
      if replay.prioritized:
        drlib.write_priorities(replay.prios, rows, outs['priority'].detach())
      return outs, carry, packed

    if not self._use_graphs:
      carry = [state]

      def eager(i, pack):
        _, carry[0], packed = update(carry[0], pack)
        return packed

      mets = self._fused_steps(steps, eager)
      self._train_steps += steps
      return {}, carry[0], mets

    # One graph: a draw from the ring's device counts, one update, the
    # priorities' scatter; the carry is written back into the graph's own
    # input, so K replays chain as K eager updates do. An update with no
    # carry runs eagerly (see `_graphed_update`).
    first = None
    if state is None:
      _, state, first = update(None, True)
      steps -= 1

    def graphed(carry):
      outs, new, packed = update(carry, True, False)
      with torch.no_grad():
        graphslib.copy_into(carry, new)
      return outs, packed

    tensors = [*replay.buffers.values(), replay.prios]
    key = (id(replay), tuple(x.data_ptr() for x in tensors
                             if x is not None))
    call = self.graphs.get('train_device', key, graphed, (state,))
    call.load((state,))
    kept = steps if self._fused_metrics == 'all' else min(steps, 1)
    packeds = torch.empty((kept, len(self._metric_names)),
                          dtype=torch.float32, device=self.device)
    for i in range(steps):
      outs, packed = call.run()
      if i >= steps - kept:
        packeds[i - (steps - kept)].copy_(packed)
      if self._debug_nans:
        self._check_packed(outs, call.inputs[0], packed)
    if first is not None and (self._fused_metrics == 'all' or not steps):
      packeds = torch.cat([first[None], packeds])
    self._train_steps += steps + (first is not None)
    return {}, graphslib.clone(call.inputs[0]), LazyMetrics(
        self._metric_names, packeds, fused=True)

  def train_device_cost(self, replay, steps, state):
    """The work of ONE `train_device` dispatch of `steps` updates from
    `replay` as the agent is configured, the counterpart of the JAX
    agent's XLA cost analysis: {'flops': ..., 'bytes accessed': ...}, and
    under 'table' the count by op and kernel ({name: [calls, flops,
    bytes]}). `nn.cost.CostMode` counts the dispatch as it runs on the
    agent's device: the ring's draw, the updates and, on a prioritized
    ring, the priorities' writes; each kernel by its formula. A graph's
    replay dispatches no aten op, so the counted dispatch runs eagerly.

    Unlike XLA's lowering, it executes. So it leaves everything as it
    found it: the agent's state (parameters, optimizer state), its
    generators, the ring's priorities and its count of updates are put
    back bit for bit, and `state` is not touched. Kernels launched on the
    card count their launches as any launch does."""
    from ...nn import cost
    self._create()
    live = nn.state(self.agent)
    saved = {k: v.detach().clone() for k, v in live.items()}
    generators = [(g, g.get_state()) for g in (
        self.generator, self._policy_generator)]
    prios = None if replay.prios is None else replay.prios.clone()
    use_graphs, train_steps = self._use_graphs, self._train_steps
    try:
      self._use_graphs = False
      with cost.CostMode(self.device) as counter:
        self.train_device(replay, steps, graphslib.clone(state))
    finally:
      self._use_graphs, self._train_steps = use_graphs, train_steps
      with torch.no_grad():
        for key, value in live.items():
          value.copy_(saved[key])
        if prios is not None:
          replay.prios.copy_(prios)
      for generator, generator_state in generators:
        generator.set_state(generator_state)
    return {**counter.cost(), 'table': dict(counter.table)}

  def make_device_replay(self, capacity=None, block=None, prioritized=None):
    """Construct a DeviceReplay matching this agent's batch layout, on
    the agent's device."""
    from ...replay.device_replay import DeviceReplay
    chunk = self.config.replay_chunk
    if block is None:
      block = min(64, chunk)  # Small blocks flush promptly at prefill.
    if capacity is None:
      capacity = int(self.config.replay_size)
    if prioritized is None:
      prioritized = str(self.config.replay) == 'prio'
    capacity = max(capacity, 2 * max(chunk, block))
    capacity = (capacity + block - 1) // block * block
    return DeviceReplay(capacity, chunk, block=block, device=self.device,
                        prioritized=prioritized)

  def report(self, data):
    """The world model's and the behaviors' report on `data`: scalars
    (reduced over the ranks as the JAX package's global ones read) and
    videos, as numpy arrays. Under `torch.graphs` one graph per batch
    signature, the batch copied into its static buffers and the report
    cloned out of its pool."""
    self._create()
    if self._use_graphs:
      report = self.graphs(
          'report', None, self._report_step, (self._tensors(data),))
    else:
      report = self._report_step(self._to_device(data))
    return _to_numpy(report)

  def _report_step(self, data):
    with torch.no_grad(), self._scope():
      report = self.agent.report(data)
    names = self._report_names
    if names and distributed.world_size() > 1:
      values = _reduce_scalars(self._report_plan,
                               torch.stack([report[k] for k in names]))
      report.update(zip(names, values))
    return report

  def dataset(self, generator):
    loader = self.config.data_loader
    if loader == 'native' and hasattr(generator, '__self__'):
      # Threaded C++ batch assembly straight from the replay's store.
      from ...replay.batcher import NativeBatcher
      return NativeBatcher(generator.__self__, self._local_batch)
    from ...core import Prefetch
    return Prefetch(
        sources=[generator] * self._local_batch, workers=8, prefetch=4)

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
    self._mirror_at = None  # The host policy mirror refreshes after a load.

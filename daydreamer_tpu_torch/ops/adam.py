"""The optimizer's step over all the tensors of one optimizer: the port's
counterpart of the loops that XLA fuses out of the JAX package's optimizer
(`daydreamer_tpu/nn/opt.py:78-118`).

- `global_norm(grads)`: sqrt of the sum of squares of every gradient.
- `adam_update(...)`: clip by `scale`, Adam, decoupled weight decay on the
  tensors marked decayed, all skipped where the norm is not finite.

On CUDA tensors each launches `csrc/adam.cu` (`adam_sumsq`: per-block sums
in a workspace, then one ordered sum; `adam_update`: one pass over p, g, m
and v, up to 64 tensors a launch), with the same order of operations and
the same float32 roundings as the plain versions, so that `adam_update`
equals `adam_update_plain` bit for bit from the same norm. On CPU tensors,
and inside `build.plain_versions()`, they run the plain versions: the loop
that `nn/opt.py` ran before the kernels, unchanged.
"""

import torch

from . import build
from ..nn import cost

# Elements a block of either kernel takes: 32 a thread.
CHUNK = 8192

ADAM_SUMSQ = build.register(build.Kernel(
    'adam_sumsq', 'adam.cu',
    'daydreamer_tpu/nn/opt.py:78 (the global norm, fused by XLA)',
    {'adam_sumsq': build.signature(scalars=0),
     'adam_update': build.signature(scalars=7)}))
ADAM_UPDATE = build.register(build.Kernel(
    'adam_update', 'adam.cu',
    'daydreamer_tpu/nn/opt.py:84 (clip, Adam and weight decay, fused by '
    'XLA)', shares=ADAM_SUMSQ))


def global_norm_plain(grads):
  return torch.stack([g.square().sum() for g in grads]).sum().sqrt()


def adam_update_plain(params, grads, ms, vs, decayed, finite, scale, lr,
                      bias1, bias2, wd, beta1, beta2, eps):
  """The loop of `nn/opt.py` before the kernels: every tensor updated in
  place, where `finite`."""
  for param, grad, m, v, decay in zip(params, grads, ms, vs, decayed):
    grad = grad * scale
    m.copy_(torch.where(
        finite, beta1 * m + (1 - beta1) * grad, m))
    v.copy_(torch.where(
        finite, beta2 * v + (1 - beta2) * grad * grad, v))
    update = param
    if wd and decay:
      update = (1 - wd * lr) * param
    update = update - lr * (m / bias1) / (torch.sqrt(v / bias2) + eps)
    param.copy_(torch.where(finite, update, param))


def global_norm_work(sizes):
  """(operations, bytes) of `adam_sumsq` over tensors of `sizes`: each
  gradient read once, the norm written; two operations a value."""
  n = sum(sizes)
  return 2 * n, 4 * n + 4


def adam_update_work(sizes, decayed=None):
  """(operations, bytes) of `adam_update` over tensors of `sizes`: p, g, m
  and v read once, p, m and v written once, float32; 14 operations a
  value, 15 where decayed; the five scalars read."""
  n = sum(sizes)
  extra = sum(s for s, d in zip(sizes, decayed or ()) if d)
  return 14 * n + extra, 28 * n + 4 * 5


def _flat(tensors):
  """Each tensor as the flat array the kernel walks, contiguous."""
  return [t if t.is_contiguous() else t.contiguous() for t in tensors]


def global_norm(grads):
  """sqrt(sum of every g * g) of float32 gradients, a 0-d tensor."""
  if build.plain():
    return global_norm_plain(grads)
  sizes = [g.numel() for g in grads]
  work = lambda: (0, global_norm_work(sizes)[1])
  with cost.kernel('adam_sumsq', work):
    if grads[0].device.type == 'cpu':
      return global_norm_plain(grads)
    return global_norm_cuda(grads)


def global_norm_cuda(grads):
  """The norm from the launches of `adam_sumsq`; gradients on a card."""
  grads = _flat(grads)
  device = grads[0].device
  # The kernel reads 16-byte vectors of a gradient that starts on 16
  # bytes, else one float at a time: 4-byte alignment will do, and the
  # data-parallel mean hands the gradients over as views of one bucket.
  build.check('adam_sumsq', [(f'grad {i}', g) for i, g in enumerate(grads)
                             if g.numel()], device, torch.float32, align=4)
  sizes = [g.numel() for g in grads]
  slots = sum(-(-n // CHUNK) for n in sizes)
  norm = torch.empty((), dtype=torch.float32, device=device)
  workspace = torch.empty(max(slots, 1), dtype=torch.float32, device=device)
  build.launch(ADAM_SUMSQ, 'adam_sumsq', torch.float32,
               [norm, workspace, *grads], [len(grads), CHUNK, *sizes], [],
               device)
  return norm


def adam_update(params, grads, ms, vs, decayed, norm, finite, scale, lr,
                bias1, bias2, wd, beta1, beta2, eps):
  """The optimizer's step in place over float32 params, grads and the
  moments ms and vs: `decayed[i]` marks a tensor that takes the weight
  decay `wd`. `norm`, `finite`, `scale`, `bias1` and `bias2` are 0-d tensors
  on the params' device; `lr` a number or such a tensor. Nothing changes
  where the norm is not finite."""
  args = (params, grads, ms, vs, decayed)
  scalars = (scale, lr, bias1, bias2, wd, beta1, beta2, eps)
  if build.plain():
    return adam_update_plain(*args, finite, *scalars)
  sizes = [p.numel() for p in params]
  flags = [bool(wd and d) for d in decayed]
  work = lambda: (0, adam_update_work(sizes, flags)[1])
  with cost.kernel('adam_update', work):
    if params[0].device.type == 'cpu':
      return adam_update_plain(*args, finite, *scalars)
    return adam_update_cuda(*args, norm, *scalars)


def adam_update_cuda(params, grads, ms, vs, decayed, norm, scale, lr, bias1,
                     bias2, wd, beta1, beta2, eps):
  """The step from the launches of `adam_update`; tensors on a card. The
  kernel reads whether the norm is finite from `norm` itself."""
  device = params[0].device
  grads = _flat(grads)
  lists = [x for group in zip(params, grads, ms, vs) for x in group]
  build.check('adam_update', [(f'tensor {i}', x) for i, x in
                              enumerate(lists) if x.numel()], device,
              torch.float32, align=4)
  build.check('adam_update', [('norm', norm), ('scale', scale),
                              ('bias1', bias1), ('bias2', bias2)],
              device, torch.float32)
  # lr and the decay factor: device scalars where lr is a tensor (the
  # warmup's), else the numbers PyTorch would round to float32.
  lr_ptr = decay_ptr = None
  lr_value = decay_value = 0.0
  if isinstance(lr, torch.Tensor):
    lr_ptr = lr.float().contiguous()
    decay_ptr = (1 - wd * lr).float().contiguous()
  else:
    lr_value, decay_value = lr, 1 - wd * lr
  dims = [len(params), CHUNK]
  for p, d in zip(params, decayed):
    dims += [p.numel(), int(bool(wd and d))]
  # 1 - beta as PyTorch takes the Python number: its double, rounded to
  # float32 once (c_float rounds it so).
  build.launch(ADAM_UPDATE, 'adam_update', torch.float32,
               [norm, scale, lr_ptr, bias1, bias2, decay_ptr, *lists], dims,
               [lr_value, decay_value, beta1, 1 - beta1, beta2, 1 - beta2,
                eps], device)

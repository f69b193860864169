"""Optimizer: global-norm clip -> Adam -> decoupled weight decay by regex.

The port of `daydreamer_tpu/nn/opt.py`. Moments and the step counter are
state entries of the optimizer module (`step`, `m/<param>`, `v/<param>`,
with `/` in the parameter name written as `.`), so they checkpoint under
the JAX package's names. Parameters and slots are updated in place. A
gradient norm that is not finite skips the whole update, `step` included,
without a host sync: the skip is decided on the device.

The global norm and the per-tensor step run in `ops/adam.py`: on the card
as a few multi-tensor kernel launches, on the CPU as the plain loop, in
the order of operations of `daydreamer_tpu/nn/opt.py`.

Under data parallelism (`parallel/`) each rank's gradients are of the mean
over its own rows; they are averaged over the ranks in one flat bucket
before the norm, which makes them the global batch's, as in the JAX
package's one program. A gradient that is not finite on one rank then
makes every rank's norm non-finite, so every rank skips.
"""

import re

import torch

from ..ops import adam
from ..parallel import distributed
from .module import Module, creating


class Optimizer(Module):

  def __init__(self, name, lr, opt='adam', eps=1e-5, clip=0.0, warmup=0,
               wd=0.0, wd_pattern='kernel', beta1=0.9, beta2=0.999):
    super().__init__(name)
    assert opt == 'adam', opt
    assert 0 <= wd < 1, wd
    assert clip >= 0, clip
    self._lr = lr
    self._eps = eps
    self._clip = clip
    self._warmup = warmup
    self._wd = wd
    self._wd_pattern = re.compile(wd_pattern)
    self._beta1 = beta1
    self._beta2 = beta2

  def forward(self, lossfn, modules, *args):
    """Compute grads of lossfn w.r.t. the trainable entries under `modules`
    and apply the update. Returns (metrics, aux) where aux is whatever
    lossfn returned beyond the scalar loss."""
    modules = modules if isinstance(modules, (list, tuple)) else [modules]
    out = lossfn(*args)
    loss, aux = (out[0], out[1:]) if isinstance(out, tuple) else (out, ())
    params = dict(p for m in modules for p in m.named_state(trainable=True))
    keys = sorted(params)
    assert keys, [m.path for m in modules]
    step = self.value('step', lambda: torch.zeros((), dtype=torch.int32),
                      trainable=False)
    slots = {}
    for key in keys:
      slot = key.replace('/', '.')
      zeros = lambda: torch.zeros_like(params[key].detach())
      slots[key] = (self.value(f'm/{slot}', zeros, trainable=False),
                    self.value(f'v/{slot}', zeros, trainable=False))
    name = self.path.rsplit('/', 1)[-1]
    if creating():
      # Creation pass: the loss ran once to allocate the parameters; the
      # slots exist now; nothing is updated.
      zero = torch.zeros((), device=step.device)
      return {f'{name}_loss': loss.detach(), f'{name}_grad_norm': zero,
              f'{name}_grad_steps': step.float(),
              f'{name}_overflow': zero}, aux
    grads = torch.autograd.grad(
        loss, [params[k] for k in keys], allow_unused=True)
    grads = [torch.zeros_like(params[k]) if g is None else g.float()
             for k, g in zip(keys, grads)]
    grads = distributed.all_mean_flat(grads)

    with torch.no_grad():
      # Global-norm clipping. A nonfinite norm means some gradient overflowed
      # or produced a NaN; then the whole update is skipped so neither the
      # params nor the Adam moments absorb the poison.
      norm = adam.global_norm(grads)
      finite = torch.isfinite(norm)
      # Skipped updates do not advance the Adam step either, so the bias
      # correction stays consistent with the number of moment updates.
      step = step + finite.to(torch.int32)
      self.write('step', step)
      t = step.float()
      lr = self._lr
      if self._warmup:
        lr = self._lr * torch.clamp(t / self._warmup, 0.0, 1.0)
      if self._clip:
        scale = torch.clamp_max(self._clip / torch.clamp_min(norm, 1e-8), 1.0)
      else:
        scale = torch.ones((), device=norm.device)
      scale = torch.where(finite, scale, torch.zeros_like(scale))
      bias1 = 1 - self._beta1 ** t
      bias2 = 1 - self._beta2 ** t
      adam.adam_update(
          [params[k] for k in keys], grads, [slots[k][0] for k in keys],
          [slots[k][1] for k in keys],
          [bool(self._wd_pattern.search(k)) for k in keys], norm, finite,
          scale, lr, bias1, bias2, self._wd, self._beta1, self._beta2,
          self._eps)

    metrics = {
        f'{name}_loss': loss.detach(),
        f'{name}_grad_norm': norm,
        f'{name}_grad_steps': t,
        f'{name}_overflow': 1.0 - finite.float(),
    }
    return metrics, aux

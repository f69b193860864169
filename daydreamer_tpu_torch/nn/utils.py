"""Training utilities, the port of `daydreamer_tpu/nn/utils.py`: adaptive
loss-scale controllers, return normalizers, action noise, logging helpers.
Controller statistics are non-trainable state entries written by `write`.
"""

import torch

from ..parallel import distributed
from . import dists
from .module import Module, device
from .dists import symlog, symexp  # noqa: F401  (re-exported)


def action_noise(action, amount, act_space, generator):
  """Exploration noise (reference: tfutils.py:85-93)."""
  if amount == 0:
    return action
  if act_space.discrete:
    probs = amount / action.shape[-1] + (1 - amount) * action
    return dists.OneHotDist(probs=probs).sample(generator)
  noise = torch.randn(action.shape, generator=generator, device=action.device)
  return torch.clamp(action + amount * noise, -1, 1)


def video_grid(video):
  B, T, H, W, C = video.shape
  return video.permute(1, 2, 0, 3, 4).reshape(T, H, B * W, C)


def balance_stats(dist, target, thres):
  """Positive/negative prediction diagnostics (reference: tfutils.py:395-411).
  NaN when a batch has no positives/negatives; aggregate with nanmean."""
  target = target.float()
  pos = (target > thres).float()
  neg = (target <= thres).float()
  pred = (dist.mean().float() > thres).float()
  loss = -dist.log_prob(target)
  return dict(
      pos_loss=(loss * pos).sum() / pos.sum(),
      neg_loss=(loss * neg).sum() / neg.sum(),
      pos_acc=(pred * pos).sum() / pos.sum(),
      neg_acc=((1 - pred) * neg).sum() / neg.sum(),
      rate=pos.mean(),
      avg=target.mean(),
      pred=dist.mean().float().mean(),
  )


# The entries of `balance_stats` that are ratios over the rows of one class,
# with whether that class is the positive one: the share of a rank's rows
# that they average is `rate`, or `1 - rate`. Every other entry is a mean
# over all rows.
BALANCE_RATIOS = {'pos_loss': True, 'neg_loss': False, 'pos_acc': True,
                  'neg_acc': False}


def _std(x):
  # jnp.std: the population standard deviation.
  return x.std(correction=0) if x.numel() > 1 else torch.zeros_like(x.sum())


class AutoAdapt(Module):
  """Proportional/multiplicative Lagrange-style loss-scale controller
  (reference: tfutils.py:414-482)."""

  def __init__(self, name, shape, impl, scale, target, min, max,
               vel=0.1, thres=0.1, inverse=False):
    super().__init__(name)
    self._shape = tuple(shape)
    self._impl = impl
    self._fixed_scale = scale
    self._target = target
    self._min = min
    self._max = max
    self._vel = vel
    self._inverse = inverse
    self._thres = thres

  @property
  def shape(self):
    return self._shape

  def forward(self, reg, update=True):
    update and self.update(reg)
    scale = self.scale()
    loss = scale * (-reg if self._inverse else reg)
    metrics = {
        'mean': reg.mean(), 'std': _std(reg),
        'scale_mean': scale.mean(), 'scale_std': _std(scale)}
    return loss, metrics

  def _scale_value(self):
    return self.value('scale', lambda: torch.ones(self._shape), trainable=False)

  def scale(self):
    if self._impl == 'fixed':
      return torch.full(self._shape, float(self._fixed_scale),
                        device=device())
    return self._scale_value().detach()

  def update(self, reg):
    if self._impl == 'fixed':
      return
    # The mean over the global batch: the ranks' means averaged.
    avg = distributed.all_mean(reg.detach().mean(
        tuple(range(len(reg.shape) - len(self._shape)))))
    scale = self._scale_value()
    if self._impl == 'mult':
      below = avg < (1 / (1 + self._thres)) * self._target
      above = avg > (1 + self._thres) * self._target
      if self._inverse:
        below, above = above, below
      inside = ~below & ~above
      adjusted = (
          above.float() * scale * (1 + self._vel) +
          below.float() * scale / (1 + self._vel) +
          inside.float() * scale)
      self.write('scale', torch.clamp(adjusted, self._min, self._max))
    elif self._impl == 'prop':
      direction = avg - self._target
      if self._inverse:
        direction = -direction
      self.write('scale', torch.clamp(
          scale + self._vel * direction, self._min, self._max))
    else:
      raise NotImplementedError(self._impl)


class Normalize(Module):
  """EMA mean/std normalizer with bias correction
  (reference: tfutils.py:485-527)."""

  def __init__(self, name, impl='mean_std', decay=0.99, max=1e8, vareps=0.0,
               stdeps=0.0):
    super().__init__(name)
    self._impl = impl
    self._decay = decay
    self._max = max
    self._stdeps = stdeps
    self._vareps = vareps

  def forward(self, values, update=True):
    update and self.update(values)
    return self.transform(values)

  def _stats(self):
    step = self.value('step', lambda: torch.zeros((), dtype=torch.int32),
                      trainable=False)
    mean = self.value('mean', lambda: torch.zeros(()), trainable=False)
    sqrs = self.value('sqrs', lambda: torch.zeros(()), trainable=False)
    return step, mean, sqrs

  def update(self, values):
    x = values.detach().float()
    m = self._decay
    step, mean, sqrs = self._stats()
    # The global batch's moments: the ranks' averaged, in one collective.
    moments = distributed.all_mean(torch.stack([x.mean(), (x ** 2).mean()]))
    self.write('step', step + 1)
    self.write('mean', m * mean + (1 - m) * moments[0])
    self.write('sqrs', m * sqrs + (1 - m) * moments[1])

  def transform(self, values):
    if self._impl == 'off':
      return values
    step, mean, sqrs = self._stats()
    correction = 1 - self._decay ** torch.clamp_min(step.float(), 1.0)
    mean = mean / correction
    var = (sqrs / correction) - mean ** 2
    if self._max > 0.0:
      scale = torch.rsqrt(
          torch.clamp_min(var, 1 / self._max ** 2 + self._vareps)
          + self._stdeps)
    else:
      scale = torch.rsqrt(var + self._vareps) + self._stdeps
    if self._impl == 'mean_std':
      values = values - mean.to(values.dtype).detach()
      values = values * scale.to(values.dtype).detach()
    elif self._impl == 'std':
      values = values * scale.to(values.dtype).detach()
    else:
      raise NotImplementedError(self._impl)
    return values

"""Distribution classes for the agent's heads, the port of
`daydreamer_tpu/nn/dists.py`: straight-through OneHot categorical, diagonal
Normal with Independent event dims, truncated Normal, Bernoulli, and the
MSE / Symlog pseudo-likelihoods. All math runs in float32 whatever the
compute dtype. `sample(generator)` draws from the agent's generator.
"""

import math

import torch
import torch.nn.functional as F


def f32(x):
  return torch.as_tensor(x).float()


def one_hot(indices, classes):
  """`F.one_hot` as float32, without its range check, which reads the
  indices on the host on the CPU; the same ones and zeros, and nothing
  for a CUDA graph to wait on."""
  return (indices[..., None] == torch.arange(
      classes, device=indices.device)).float()


def symlog(x):
  return torch.sign(x) * torch.log(1 + torch.abs(x))


def symexp(x):
  return torch.sign(x) * (torch.exp(torch.abs(x)) - 1)


def uniform(shape, generator, device):
  """Uniform float32 draws in [0, 1) from `generator`."""
  return torch.rand(shape, generator=generator, device=device,
                    dtype=torch.float32)


def gumbel_noise(u):
  """Standard Gumbel noise from uniform draws, as jax.random.gumbel makes
  it."""
  tiny = torch.finfo(torch.float32).tiny
  return -torch.log(-torch.log(u.clamp_min(tiny)))


def gumbel(shape, generator, device):
  """Standard Gumbel noise, float32, as jax.random.gumbel draws it."""
  return gumbel_noise(uniform(shape, generator, device))


class OneHotDist:
  """Categorical over one-hot vectors with straight-through gradients
  (reference: tfutils.py:359-387). Batch shape = logits.shape[:-1]."""

  def __init__(self, logits=None, probs=None):
    if logits is None:
      logits = torch.log(torch.clamp(probs, 1e-8, 1.0))
    self.logits = F.log_softmax(f32(logits), -1)
    self.num_classes = logits.shape[-1]

  @property
  def probs(self):
    return torch.exp(self.logits)

  def sample(self, generator=None):
    noise = gumbel(self.logits.shape, generator, self.logits.device)
    indices = torch.argmax(self.logits.detach() + noise, -1)
    sample = one_hot(indices, self.num_classes)
    # Straight-through biased gradient estimator: forward pass is the hard
    # sample, backward pass flows through the softmax probabilities.
    probs = self.probs
    return sample + probs - probs.detach()

  def mode(self):
    return one_hot(torch.argmax(self.logits, -1), self.num_classes)

  def log_prob(self, value):
    return torch.sum(f32(value) * self.logits, -1)

  def entropy(self):
    return -torch.sum(torch.exp(self.logits) * self.logits, -1)

  def kl(self, other):
    return torch.sum(
        torch.exp(self.logits) * (self.logits - other.logits), -1)


class Independent:
  """Sums log-probs/entropies over the trailing `dims` batch dims of `dist`."""

  def __init__(self, dist, dims):
    self.dist = dist
    self.dims = dims
    for attr in ('minent', 'maxent'):
      if hasattr(dist, attr):
        setattr(self, attr, getattr(dist, attr))

  @property
  def inner(self):
    return self.dist

  def _reduce(self, x):
    if not self.dims:
      return x
    return torch.sum(x, dim=tuple(range(-self.dims, 0)))

  def sample(self, generator=None):
    return self.dist.sample(generator)

  def mode(self):
    return self.dist.mode()

  def mean(self):
    return self.dist.mean()

  def log_prob(self, value):
    return self._reduce(self.dist.log_prob(value))

  def entropy(self):
    return self._reduce(self.dist.entropy())

  def kl(self, other):
    other = other.dist if isinstance(other, Independent) else other
    return self._reduce(self.dist.kl(other))


class Normal:

  def __init__(self, mean, std):
    self._mean = f32(mean)
    self._std = f32(std) if torch.is_tensor(std) else torch.full_like(
        self._mean, float(std))

  def sample(self, generator=None):
    noise = torch.randn(self._mean.shape, generator=generator,
                        device=self._mean.device, dtype=torch.float32)
    return self._mean + self._std * noise

  def mode(self):
    return self._mean

  def mean(self):
    return self._mean

  def log_prob(self, value):
    var = self._std ** 2
    return -0.5 * (
        math.log(2 * math.pi) + 2 * torch.log(self._std)
        + (f32(value) - self._mean) ** 2 / var)

  def entropy(self):
    return 0.5 * math.log(2 * math.pi * math.e) + torch.log(self._std)

  def kl(self, other):
    return (
        torch.log(other._std) - torch.log(self._std)
        + (self._std ** 2 + (self._mean - other._mean) ** 2)
        / (2 * other._std ** 2) - 0.5)


class MultivariateNormalDiag:
  """Diagonal Gaussian whose event dim is the last axis."""

  def __init__(self, mean, std):
    self._inner = Normal(mean, std)

  def sample(self, generator=None):
    return self._inner.sample(generator)

  def mode(self):
    return self._inner.mode()

  def mean(self):
    return self._inner.mean()

  def log_prob(self, value):
    return torch.sum(self._inner.log_prob(value), -1)

  def entropy(self):
    return torch.sum(self._inner.entropy(), -1)

  def kl(self, other):
    return torch.sum(self._inner.kl(other._inner), -1)


class TruncNormal:
  """Normal truncated to [low, high] (reference actor dist 'trunc_normal')."""

  def __init__(self, mean, std, low=-1.0, high=1.0):
    self._mean = f32(mean)
    self._std = f32(std)
    self._low = low
    self._high = high

  def _alpha_beta(self):
    alpha = (self._low - self._mean) / self._std
    beta = (self._high - self._mean) / self._std
    return alpha, beta

  def _z(self):
    alpha, beta = self._alpha_beta()
    return _ndtr(beta) - _ndtr(alpha)

  def sample(self, generator=None):
    alpha, beta = self._alpha_beta()
    lo = _ndtr(alpha)
    hi = _ndtr(beta)
    u = uniform(self._mean.shape, generator, self._mean.device)
    u = u * (1 - 2e-6) + 1e-6
    x = torch.special.ndtri(lo + u * (hi - lo))
    return torch.clamp(self._mean + self._std * x, self._low, self._high)

  def mode(self):
    return torch.clamp(self._mean, self._low, self._high)

  def mean(self):
    alpha, beta = self._alpha_beta()
    z = self._z()
    return self._mean + self._std * (_npdf(alpha) - _npdf(beta)) / z

  def log_prob(self, value):
    x = (f32(value) - self._mean) / self._std
    log_unnorm = -0.5 * x ** 2 - 0.5 * math.log(2 * math.pi)
    return log_unnorm - torch.log(self._std) - torch.log(self._z() + 1e-12)

  def entropy(self):
    alpha, beta = self._alpha_beta()
    z = self._z()
    term = (alpha * _npdf(alpha) - beta * _npdf(beta)) / (2 * z + 1e-12)
    return 0.5 * math.log(2 * math.pi * math.e) + torch.log(
        self._std * z + 1e-12) + term


class Bernoulli:

  def __init__(self, logits):
    self.logits = f32(logits)

  def sample(self, generator=None):
    u = uniform(self.logits.shape, generator, self.logits.device)
    return (u < torch.sigmoid(self.logits)).float()

  def mode(self):
    return (self.logits > 0).float()

  def mean(self):
    return torch.sigmoid(self.logits)

  def log_prob(self, value):
    value = f32(value)
    return -(torch.clamp_min(self.logits, 0) - self.logits * value
             + torch.log1p(torch.exp(-torch.abs(self.logits))))

  def entropy(self):
    probs = torch.sigmoid(self.logits)
    return -(probs * torch.log(probs + 1e-12)
             + (1 - probs) * torch.log(1 - probs + 1e-12))


class MSEDist:
  """Squared-error pseudo-likelihood (reference: tfutils.py:305-329)."""

  def __init__(self, mode, dims, agg='sum'):
    self._mode = f32(mode)
    self._dims = tuple(range(-dims, 0))
    self._agg = agg

  def mode(self):
    return self._mode

  def mean(self):
    return self._mode

  def log_prob(self, value):
    assert self._mode.shape == value.shape, (self._mode.shape, value.shape)
    distance = (self._mode - f32(value)) ** 2
    return -_aggregate(distance, self._dims, self._agg)


class SymlogDist:
  """MSE in symlog space, decoded with symexp (reference: tfutils.py:332-356)."""

  def __init__(self, mode, dims, agg='sum'):
    self._mode = f32(mode)
    self._dims = tuple(range(-dims, 0))
    self._agg = agg

  def mode(self):
    return symexp(self._mode)

  def mean(self):
    return symexp(self._mode)

  def log_prob(self, value):
    assert self._mode.shape == value.shape, (self._mode.shape, value.shape)
    distance = (self._mode - symlog(f32(value))) ** 2
    return -_aggregate(distance, self._dims, self._agg)


def _aggregate(distance, dims, agg):
  if not dims:
    return distance
  if agg == 'mean':
    return distance.mean(dims)
  if agg == 'sum':
    return distance.sum(dims)
  raise NotImplementedError(agg)


def _ndtr(x):
  return 0.5 * (1 + torch.erf(x / math.sqrt(2)))


def _npdf(x):
  return torch.exp(-0.5 * x ** 2) / math.sqrt(2 * math.pi)


def kl_divergence(lhs, rhs):
  return lhs.kl(rhs)

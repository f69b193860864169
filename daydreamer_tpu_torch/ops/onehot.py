"""The RSSM's categorical stats head after its product, with its
straight-through sample, one pass each way: the port's counterpart of the
loop fusion that XLA makes of what follows the `img_stats` / `obs_stats`
product in the JAX package's scan step (`RSSM._unimix_logit`, `get_dist`'s
`OneHotDist` and its `sample` or `mode`: `daydreamer_tpu/models/nets.py:
289-298`, `daydreamer_tpu/nn/dists.py:39-50`).

`onehot_head(raw, u, unimix)` takes the raw logits [..., S, C] (float32 or
bfloat16) and returns the state's `logit` (the uniform mixture's log-probs
rounded to raw's dtype, or raw itself where `unimix` is 0) and its `stoch`
in raw's dtype: with `u`, uniform float32 draws of raw's shape (`uniform`,
drawn where the eager chain drew its Gumbel noise), the Gumbel-max sample
of `OneHotDist(logit)` with its straight-through gradient; with `u` None,
the mode, which has no gradient.

- On a CUDA tensor it launches `csrc/onehot.cu`: `onehot_head_fwd` and,
  under autograd, `onehot_head_bwd`, whose gradient of the raw logits runs
  through the straight-through probabilities, the cast, the log, the
  mixture and the softmax, rounded as autograd of the plain version rounds
  it. For classes a power of two from 2 to 32 each holds several classes a
  lane (`lane_classes`, `bwd_lane_classes`), on a grid of at most `BLOCKS`
  blocks walking the values; any other count of classes C >= 1 takes a
  general path each way: a lane's consecutive classes in registers and a
  group of up to a warp's lanes a group, read once (`fwd_lane_classes`,
  `group_lane_classes`), or past GROUP_MOST classes a lane a group of up
  to a warp's lanes that walks its classes in passes.
- On a CPU tensor it runs `onehot_head_plain`, the function in PyTorch ops
  (the RSSM's and `OneHotDist`'s code before the kernel), and
  differentiates it by autograd.
- Inside `build.plain_versions()` (tests and `chip_smoke.py` only) it runs
  the plain version on a card too.
"""

import torch

from . import build
from . import norm
from ..nn import cost
from ..nn import dists

# Blocks of a launch at most, forward and backward: its walk over the
# values (1 024 x 32 x 32 values take 512 blocks of 256 lanes of 8
# classes).
BLOCKS = 1056
# Classes a lane holds from WIDE_FROM values on, where the card is full and
# a lane's 16-byte loads and fewer shuffles pay: 8 forward, and backward
# a 16-byte load of the type (8 bfloat16, 4 float32 values); else 2, where
# few values leave the card idle and a lane's chain of work is the call's
# latency (measured at 32 768 and 1 048 576 values). LANE_CLASSES and
# BWD_LANE_CLASSES, where set (2, 4 or 8), take the forward's and the
# backward's place.
WIDE_FROM = 1 << 18
LANE_CLASSES = BWD_LANE_CLASSES = None
# Classes a lane of the general path holds at most (`group_lane_classes`,
# `fwd_lane_classes`): groups of more than a warp's lanes of GROUP_MOST
# classes take the passes.
# The general forward (`fwd_lane_classes`) takes many values' classes a
# lane where those give at least GROUP_WIDE_LANES lanes (128 blocks of 256,
# about the card's SMs), else few values', each one of GROUP_LANES (the
# counts the card's runs timed; csrc/onehot.cu builds no other).
GROUP_MOST = 8
GROUP_WIDE_LANES = 1 << 15
GROUP_LANES = (1, 2, 3, 4, 6, 8)

ONEHOT_HEAD_FWD = build.register(build.Kernel(
    'onehot_head_fwd', 'onehot.cu',
    'daydreamer_tpu/models/nets.py:289 (RSSM._unimix_logit, then '
    'OneHotDist and its sample, daydreamer_tpu/nn/dists.py:39, one loop '
    'fusion of XLA)',
    {'onehot_head_fwd': build.signature(scalars=2),
     'onehot_head_bwd': build.signature(scalars=2)}))
ONEHOT_HEAD_BWD = build.register(build.Kernel(
    'onehot_head_bwd', 'onehot.cu',
    'daydreamer_tpu/models/nets.py:289 (the gradient of the unimix logit '
    'and the straight-through sample, fused by XLA)',
    shares=ONEHOT_HEAD_FWD))


def uniform(shape, generator, device):
  """The uniform draws of a sample: float32, from `generator`, as
  `dists.gumbel` draws them."""
  return dists.uniform(shape, generator, device)


def unimix_logit(logit, unimix):
  """The categorical mixed with a uniform floor, as log-probs in logit's
  dtype (the RSSM's `_unimix_logit`); logit itself where unimix is 0."""
  if not unimix:
    return logit
  probs = torch.softmax(logit.float(), -1)
  probs = (1 - unimix) * probs + unimix / probs.shape[-1]
  return torch.log(probs).to(logit.dtype)


def onehot_head_plain(raw, u, unimix):
  """The function in PyTorch ops: (logit, stoch), stoch in raw's dtype."""
  logit = unimix_logit(raw, unimix)
  dist = dists.OneHotDist(logit)
  if u is None:
    return logit, dist.mode().to(raw.dtype)
  indices = torch.argmax(dist.logits.detach() + dists.gumbel_noise(u), -1)
  sample = dists.one_hot(indices, dist.num_classes)
  probs = dist.probs
  return logit, (sample + probs - probs.detach()).to(raw.dtype)


def _check(name, raw):
  if raw.dtype not in (torch.float32, torch.bfloat16):
    raise TypeError(f'{name} takes float32 or bfloat16, not {raw.dtype}.')
  return raw.shape[-1]


def _scalars(C, unimix):
  """keep = 1 - unimix and floor = unimix / C, as the plain version's
  products take them (rounded to float32 by ctypes)."""
  return [1 - unimix, unimix / C]


def lane_classes(n):
  """Classes a lane of the forward holds for n values."""
  if LANE_CLASSES is not None:
    return LANE_CLASSES
  return 8 if n >= WIDE_FROM else 2


def bwd_lane_classes(n, dtype):
  """Classes a lane of the backward holds for n values of dtype."""
  if BWD_LANE_CLASSES is not None:
    return BWD_LANE_CLASSES
  return 16 // cost.itemsize(dtype) if n >= WIDE_FROM else 2


def group_lane_classes(C, dtype):
  """Classes a lane of the general backward holds for groups of C classes
  of dtype (any count but the powers of two from 2 to 32): the widest
  vector of up to 16 bytes that C is a multiple of, doubled until a warp's
  lanes hold the group; 0, the passes, past GROUP_MOST."""
  lane = 16 // cost.itemsize(dtype)
  while C % lane:
    lane //= 2
  while -(-C // lane) > 32:
    lane *= 2
  return lane if lane <= GROUP_MOST else 0


def fwd_lane_classes(C, dtype, n):
  """Classes a lane of the general forward holds for n values in groups of
  C classes of dtype (any count but the powers of two from 2 to 32), one
  of GROUP_LANES up to GROUP_MOST, its group of lanes C over it rounded up
  to a power of two, at most a warp: many values' (where those lanes of
  all groups number at least GROUP_WIDE_LANES: the card is full), the
  count that leaves the fewest places idle, the widest vector (of up to 16
  bytes that it and C are multiples of) among equals, then the fewest (48
  classes take 6 a lane on 8 lanes, where 8 a lane leave 2 of 8 lanes
  idle; 3 take a lane a group); else few values', where they leave the
  card idle and a lane's chain of work is the call's latency, the fewest
  that fit a group in a warp (2 at 48 and 64); 0, the passes, where no
  count does."""
  best = few = None
  for lane in [k for k in GROUP_LANES if k <= GROUP_MOST]:
    lanes = 1 << (-(-C // lane) - 1).bit_length()
    if lanes > 32:
      continue
    few = few or lane
    vec = 16 // cost.itemsize(dtype)
    while C % vec or lane % vec:
      vec //= 2
    key = (lanes * lane, -vec)
    if best is None or key < best[0]:
      best = key, lane, lanes
  if best is None:
    return 0
  _, lane, lanes = best
  return lane if n // C * lanes >= GROUP_WIDE_LANES else few


def _power_of_two_classes(C):
  return 2 <= C <= 32 and C & (C - 1) == 0


def onehot_head_fwd_cuda(raw, u, unimix):
  """logit, stoch from one launch of `onehot_head_fwd`; raw on a card, u
  float32 of raw's shape or None (the mode)."""
  name = 'onehot_head_fwd'
  C = _check(name, raw)
  raw = norm._aligned(raw)
  build.check(name, [('raw', raw)], raw.device, raw.dtype)
  if u is not None:
    u = norm._aligned(u)
    if u.shape != raw.shape:
      raise ValueError(f'{name}: u {tuple(u.shape)} is not raw\'s shape '
                       f'{tuple(raw.shape)}.')
    build.check(name, [('u', u)], raw.device, torch.float32)
  logit, stoch = torch.empty_like(raw), torch.empty_like(raw)
  lanes = (lane_classes(raw.numel()) if _power_of_two_classes(C)
           else fwd_lane_classes(C, raw.dtype, raw.numel()))
  build.launch(ONEHOT_HEAD_FWD, name, raw.dtype, [raw, u, logit, stoch],
               [raw.numel(), C, int(bool(unimix)), int(u is not None),
                BLOCKS, lanes], _scalars(C, unimix), raw.device)
  return logit, stoch


def onehot_head_bwd_cuda(raw, logit, dlogit, dstoch, unimix, sample):
  """The raw logits' gradient from one launch of `onehot_head_bwd`: the
  forward's raw and logit, the gradients of logit and (with the sample)
  of stoch."""
  name = 'onehot_head_bwd'
  C = _check(name, raw)
  raw, logit = norm._aligned(raw), norm._aligned(logit)
  dlogit = norm._aligned(dlogit.to(raw.dtype))
  tensors = [('raw', raw), ('logit', logit), ('dlogit', dlogit)]
  if sample:
    dstoch = norm._aligned(dstoch.to(raw.dtype))
    tensors.append(('dstoch', dstoch))
  else:
    dstoch = None
  build.check(name, tensors, raw.device, raw.dtype)
  draw = torch.empty_like(raw)
  lanes = (bwd_lane_classes(raw.numel(), raw.dtype)
           if _power_of_two_classes(C) else group_lane_classes(C, raw.dtype))
  build.launch(ONEHOT_HEAD_BWD, name, raw.dtype,
               [raw, logit, dlogit, dstoch, draw],
               [raw.numel(), C, int(bool(unimix)), int(sample), BLOCKS,
                lanes],
               _scalars(C, unimix), raw.device)
  return draw


def onehot_head_work(rows, S, C, dtype, unimix, sample, backward=False):
  """(operations, bytes) of one launch: `rows` rows of S groups of C
  classes, each input read once, each output written once. Forward: raw
  and (with the sample) u in, logit and stoch out; about 12 operations a
  value, 8 more with the mixture and 8 with the noise. Backward: logit
  and stoch's gradient (with the sample), raw (with the mixture) and
  logit's gradient in, raw's gradient out; about 8 operations a value
  for either path, as the plain version's arithmetic counts them, where
  the kernel issues, by count, some 30 instructions a value for the sample
  and 40 for the mixture (full-precision exp and divides, the roundings),
  and its group sums about 2 more a value at 8 classes a lane (about 60
  when a lane held one class). No product is done (`cost.CostMode` counts
  products only, so the wrappers count no FLOPs)."""
  item, n = cost.itemsize(dtype), rows * S * C
  unimix, sample = bool(unimix), bool(sample)
  if backward:
    reads = 1 + 2 * sample + unimix
    return (8 * (1 + sample + unimix) * n, item * (reads + 1) * n)
  return ((12 + 8 * unimix + 8 * sample) * n,
          (3 * item + 4 * sample) * n)


class OneHotHead(torch.autograd.Function):
  """(raw, u, unimix) -> (logit, stoch). A CUDA input launches the kernels,
  a CPU input runs the plain version (its backward by autograd)."""

  @staticmethod
  def forward(ctx, raw, u, unimix):
    C = raw.shape[-1]
    rows, S = raw.numel() // (raw.shape[-2] * C), raw.shape[-2]
    sample = u is not None
    work = lambda: (0, onehot_head_work(rows, S, C, raw.dtype, unimix,
                                        sample)[1])
    with cost.kernel('onehot_head_fwd', work):
      if raw.device.type == 'cpu':
        logit, stoch = onehot_head_plain(raw, u, unimix)
        # Without the mixture the plain logit is raw itself; the Function
        # returns a tensor of its own, as the kernel does.
        logit = logit.clone() if logit is raw else logit
      else:
        logit, stoch = onehot_head_fwd_cuda(raw, u, unimix)
    ctx.save_for_backward(raw, logit, u)
    ctx.unimix, ctx.sample = unimix, sample
    if not sample:
      ctx.mark_non_differentiable(stoch)
    return logit, stoch

  @staticmethod
  def backward(ctx, dlogit, dstoch):
    raw, logit, u = ctx.saved_tensors
    C, S = raw.shape[-1], raw.shape[-2]
    rows = raw.numel() // (S * C)
    work = lambda: (0, onehot_head_work(
        rows, S, C, raw.dtype, ctx.unimix, ctx.sample, backward=True)[1])
    with cost.kernel('onehot_head_bwd', work):
      if raw.device.type == 'cpu':
        with torch.enable_grad():
          leaf = raw.detach().requires_grad_()
          outs = onehot_head_plain(leaf, u, ctx.unimix)
          grads = [(o, g) for o, g in zip(outs, (dlogit, dstoch))
                   if o.requires_grad]
          draw, = torch.autograd.grad(
              [o for o, _ in grads], leaf, [g for _, g in grads])
      else:
        draw = onehot_head_bwd_cuda(raw, logit, dlogit, dstoch, ctx.unimix,
                                    ctx.sample)
    return draw, None, None


def onehot_head(raw, u, unimix):
  """(logit, stoch) of the raw logits [..., S, C] (see the module
  docstring); logit and a sampled stoch are differentiable in raw."""
  if build.plain():
    return onehot_head_plain(raw, u, unimix)
  return OneHotHead.apply(raw, u, unimix)

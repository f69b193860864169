"""RSSM sequence cells, the port of `daydreamer_tpu/ops/pallas_rssm.py`.

Three forward-only chains, each a CUDA kernel on a CUDA tensor and the same
arithmetic in PyTorch (`*_plain`) on a CPU tensor:

- `imagine_actor`, the policy-in-the-loop imagination rollout of the
  training path (the JAX package's `imagine_actor_pallas`): H steps of the
  image cell, a one-hot prior sample, the actor MLP and a one-hot action.
  Kernel `csrc/imagine_actor.cu`, replaces `_imagine_actor_kernel`.
- `imagine`, the rollout on GIVEN actions (`imagine_pallas`): H steps of
  the image cell and a one-hot prior sample. Kernel `csrc/imagine.cu`,
  replaces `_imagine_kernel`.
- `observe`, the posterior chain (`observe_pallas`): per step the
  `is_first` zeroing of stoch, deter and action, the image cell for the
  deter only, the posterior head over [deter, embed] and a one-hot
  posterior sample. Kernel `csrc/observe.cu`, replaces `_observe_kernel`.

Each kernel's source note gives its bound and its design. The Gumbel noise
is an input of every route: the wrapper draws it from the caller's
generator, on the tensors' device. The TPU kernels' in-core generator and
their literal unimix mixture are replaced by `argmax(log((1-u) softmax(z)
+ u/C) + g)`, which has the same distribution and is what the JAX scan
references compute; without sampling the one-hot is `argmax(z)`.

The cell math mirrors the JAX cell exactly: matmuls accumulate in float32
and round to the compute dtype, LayerNorm runs in float32 (eps 1e-3), ELU
is exp(x) - 1, the GRU gates are float32. The logits returned are RAW; the
caller applies the unimix to store log-probs. `make_params` and
`make_actor_params` build random weights in this layout from a numpy seed.
"""

import ctypes

import numpy as np
import torch

from . import build
from ..nn import cost
from ..nn.dists import gumbel

f32 = torch.float32

IMAGINE_ACTOR = build.register(build.Kernel(
    'imagine_actor', 'imagine_actor.cu',
    'daydreamer_tpu/ops/pallas_rssm.py:427 (_imagine_actor_kernel)',
    {'imagine_actor': build.signature(scalars=2)},
    headers=('imagine_common.cuh', 'imagine_mma.cuh', 'hopper_ptx.cuh')))

IMAGINE = build.register(build.Kernel(
    'imagine', 'imagine.cu',
    'daydreamer_tpu/ops/pallas_rssm.py:207 (_imagine_kernel)',
    {'imagine': build.signature()},
    headers=('imagine_common.cuh', 'imagine_mma.cuh', 'hopper_ptx.cuh')))

OBSERVE = build.register(build.Kernel(
    'observe', 'observe.cu',
    'daydreamer_tpu/ops/pallas_rssm.py:682 (_observe_kernel)',
    {'observe': build.signature(),
     'observe_clusters': (ctypes.c_int, [
         ctypes.c_int, ctypes.POINTER(ctypes.c_int),
         ctypes.POINTER(ctypes.c_int)])},
    headers=('observe_common.cuh', 'observe_cluster.cuh', 'hopper_ptx.cuh')))


def _elu(x):
  """ELU without expm1, as the JAX cell computes it."""
  xf = x.float()
  return torch.where(xf > 0, xf, torch.exp(xf) - 1.0).to(x.dtype)


def _layernorm(x, scale, bias, eps=1e-3):
  dtype = x.dtype
  x = x.float()
  mean = x.mean(-1, keepdim=True)
  var = ((x - mean) ** 2).mean(-1, keepdim=True)
  x = (x - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()
  return x.to(dtype)


def _dot(x, w):
  """x @ w accumulated in float32 (preferred_element_type=f32)."""
  return x.float() @ w.float()


def _linear_ln_elu(x, w, scale, bias):
  return _elu(_layernorm(_dot(x, w).to(x.dtype), scale, bias))


def _gru_core(deter, x, params):
  """GRU with update bias -1, split matmul over [deter, x]."""
  g = _dot(deter, params['w_gru_d']) + _dot(x, params['w_gru_x'])
  g = _layernorm(g.to(x.dtype), params['ln_gru_scale'], params['ln_gru_bias'])
  reset, cand, update = torch.chunk(g.float(), 3, -1)
  reset = torch.sigmoid(reset)
  cand = torch.tanh(reset * cand)
  update = torch.sigmoid(update - 1)
  return (update * cand + (1 - update) * deter.float()).to(x.dtype)


def _img_deter(stoch, deter, action, params):
  """The recurrent half of one img_step: deter'."""
  x = _dot(stoch, params['w_in_s']) + _dot(action, params['w_in_a'])
  x = _elu(_layernorm(
      x.to(stoch.dtype), params['ln_in_scale'], params['ln_in_bias']))
  return _gru_core(deter, x, params)


def _img_cell(stoch, deter, action, params):
  """One img_step: returns (deter', raw logits float32)."""
  deter = _img_deter(stoch, deter, action, params)
  h = deter
  for w, s, b in zip(params['w_out'], params['ln_out_scale'],
                     params['ln_out_bias']):
    h = _linear_ln_elu(h, w, s, b)
  return deter, _dot(h, params['w_st']) + params['b_st'].float()


def _actor_cell(stoch, deter, actor):
  """Actor MLP over [deter, stoch]: raw action logits float32."""
  x = _dot(deter, actor['w_d']) + _dot(stoch, actor['w_s'])
  x = _elu(_layernorm(
      x.to(stoch.dtype), actor['ln_scale'][0], actor['ln_bias'][0]))
  for i, w in enumerate(actor['w_h']):
    x = _linear_ln_elu(x, w, actor['ln_scale'][i + 1], actor['ln_bias'][i + 1])
  return _dot(x, actor['w_out']) + actor['b_out'].float()


def _mixed_logprobs(logits, unimix):
  probs = torch.softmax(logits, -1)
  if unimix:
    probs = (1 - unimix) * probs + unimix / logits.shape[-1]
  return torch.log(probs)


def _argmax_onehot(scores):
  return torch.nn.functional.one_hot(
      scores.argmax(-1), scores.shape[-1]).to(scores.dtype)


def imagine_actor_plain(params, actor, stoch0, deter0, action0, horizon,
                        noise=None, unimix=0.01, act_unimix=0.01):
  """The rollout in PyTorch. noise: (g_s [H,B,S*C], g_a [H,B,A]) float32,
  or None for argmax latents and actions. Returns (deters [H,B,D], logits
  [H,B,S*C] float32, stochs [H,B,S*C], actions [H,B,A])."""
  S, C = params['stoch_n'], params['classes']
  B = stoch0.shape[0]
  dtype = stoch0.dtype
  stoch, deter, action = stoch0, deter0, action0.to(dtype)
  outs = []
  for t in range(horizon):
    deter, logit = _img_cell(stoch, deter, action, params)
    z = logit.reshape(B, S, C)
    if noise is None:
      onehot = _argmax_onehot(z)
    else:
      scores = _mixed_logprobs(z, unimix) + noise[0][t].reshape(B, S, C)
      onehot = _argmax_onehot(scores)
    stoch = onehot.reshape(B, S * C).to(dtype)
    alogit = _actor_cell(stoch, deter, actor)
    if act_unimix:
      alogit = _mixed_logprobs(alogit, act_unimix)
    if noise is not None:
      alogit = alogit + noise[1][t]
    action = _argmax_onehot(alogit).to(dtype)
    outs.append((deter, logit, stoch, action))
  return tuple(torch.stack(x, 0) for x in zip(*outs))


def _check_dtype(name, dtype):
  if dtype not in (torch.float32, torch.bfloat16):
    raise TypeError(f'{name} takes float32 or bfloat16, not {dtype}.')


# The layer counts the kernels' parameters hold: MAXL on the shipped path,
# MANY on the wide one (`csrc/imagine_common.cuh`, `observe_common.cuh`).
MAXL, MANY = 8, 128
# The layout of the observe kernels' chains (`csrc/observe_common.cuh`,
# `observe_cluster.cuh`): R rows a cluster of CL blocks, NW warps a block,
# the products' scratch in floats.
R, CL, NW, SCRATCH = 2, 4, 32, 16384


def head_in(D, U, n_out):
  """The width of the prior head's input: the last layer's, or with no
  layer the deter's."""
  return U if n_out else D


def load_values(dtype, *widths):
  """The weights the observe kernels read at a time (`csrc/
  observe_common.cuh`): a 16-byte load where every width is a multiple of
  it, else single values."""
  values = 16 // torch.empty((), dtype=dtype).element_size()
  return values if all(w % values == 0 for w in widths) else 1


def _check_shared(name, nbytes):
  if nbytes > build.SHARED_MEMORY_LIMIT:
    raise ValueError(
        f'{name}: these widths need {nbytes} bytes of shared memory a '
        f'block; the card gives {build.SHARED_MEMORY_LIMIT}.')


def _actor_bytes(D, U, S, C, A, itemsize, actor=True, wide=False):
  """The least shared memory `csrc/imagine_actor.cu` (or, without the
  actor, `csrc/imagine.cu`) takes, 8 rows a block: every product's float
  sum, the action logits (the actor's only), the sampled classes, the
  product inputs in the compute type and the schedule (float32
  `imagine.cu` keeps no schedule and needs its 656 bytes less). The ring
  of weight tiles takes what is left, or nothing. The wide path keeps the
  sums and the schedule in its workspace (`_rollout_workspace`)."""
  padded = (A + 3) // 4 * 4
  floats = (0 if wide else max(3 * D, S * C)) + (padded if actor else 0) + S
  return (8 * (4 * floats + itemsize * (S * C + D + padded + 2 * U))
          + (0 if wide else 656))


def cluster_workspace(name, shipped, wide, floats, B, device, force=False):
  """None where the shipped path of an observe kernel's chain, `shipped`
  bytes of shared memory a block, fits the card (and `force` is off), else
  the wide path's workspace: `floats` float32 for each block of the
  clusters that take B rows, its `wide` bytes of shared memory checked."""
  if shipped <= build.SHARED_MEMORY_LIMIT and not force:
    return None
  _check_shared(name, wide)
  return torch.empty(-(-B // R) * CL * floats, dtype=f32, device=device)


def _rollout_workspace(name, B, D, U, S, C, A, dtype, device, layers, actor):
  """None where the shipped path of `imagine_actor.cu` (`actor`) or
  `imagine.cu` takes these widths: at most MAXL prior (and actor) layers,
  its shared memory within the card's. Else the wide path's workspace, a
  block's copy for each 8 rows: the products' float sums [G][8] and the
  schedule of MANY layers (8 336 bytes)."""
  if max(layers) > MANY:
    raise ValueError(f'{name}: takes at most {MANY} layers an MLP, the '
                     'addresses that the parameters of its wide path hold.')
  item = torch.empty((), dtype=dtype).element_size()
  if max(layers) <= MAXL and _actor_bytes(
      D, U, S, C, A, item, actor) <= build.SHARED_MEMORY_LIMIT:
    return None
  _check_shared(name, _actor_bytes(D, U, S, C, A, item, actor, wide=True))
  return torch.empty(-(-B // 8) * (8 * max(3 * D, S * C) + 8336 // 4),
                     dtype=f32, device=device)


_CELL = ('w_in_s', 'w_in_a', 'ln_in_scale', 'ln_in_bias', 'w_gru_d',
         'w_gru_x', 'ln_gru_scale', 'ln_gru_bias')


def _cell_shapes(A, D, U, SC):
  return {
      'w_in_s': (SC, U), 'w_in_a': (A, U), 'ln_in_scale': (U,),
      'ln_in_bias': (U,), 'w_gru_d': (D, 3 * D), 'w_gru_x': (U, 3 * D),
      'ln_gru_scale': (3 * D,), 'ln_gru_bias': (3 * D,)}


def _check_shapes(name, tensors, expect):
  for key, shape in expect.items():
    if tuple(tensors[key].shape) != tuple(shape):
      raise ValueError(f'{name}: {key} has shape '
                       f'{tuple(tensors[key].shape)}, not {tuple(shape)}.')


def _prior_layers(name, params, D, U):
  """The prior MLP as (kernels, scales, biases), shapes checked."""
  layers = (params['w_out'], params['ln_out_scale'], params['ln_out_bias'])
  n_out = len(layers[0])
  if any(len(x) != n_out for x in layers):
    raise ValueError(f'{name}: inconsistent prior layers.')
  for i, (w, scale, bias) in enumerate(zip(*layers)):
    _check_shapes(name, {'w_out': w, 'ln_out_scale': scale,
                         'ln_out_bias': bias},
                  {'w_out': (D if i == 0 else U, U), 'ln_out_scale': (U,),
                   'ln_out_bias': (U,)})
  return layers


# The work of each kernel: its operations (2 a product's multiply-add; the
# product of `w_in_s`, and of the actor's `w_s`, with the chain's own
# one-hot stoch a gather of S weight rows, S * U adds) and its bytes (each
# input read once, each output written once), at these widths in `dtype`.
# `cost.bound` turns them into the least time on the card, and the
# wrappers count them under `cost.CostMode`.


def cell_numel(A, D, U, n_out=None):
  """(products, vectors) of the image cell (w_in_a, the GRU's two kernels,
  their norms' scales and biases) and, with `n_out`, the prior MLP's
  layers without their head."""
  products = A * U + 3 * D * D + 3 * U * D
  vectors = 2 * U + 6 * D
  if n_out:  # None or 0: no layer.
    products += D * U + (n_out - 1) * U * U
    vectors += 2 * U * n_out
  return products, vectors


def widths(params, actions, E=None):
  """(T, B, A[, E], D, U, S, C, n_out) of a chain, read from its inputs:
  the widths the `*_work` functions take."""
  T, B, A = actions.shape
  SC, U = params['w_in_s'].shape
  D = params['w_gru_d'].shape[0]
  S, C = params['stoch_n'], params['classes']
  return (T, B, A) + ((E,) if E is not None else ()) + (
      D, U, S, C, len(params['w_out']))


def imagine_actor_work(B, H, D, U, S, C, A, n_out, n_act, dtype):
  """(flops, bytes) of one call of `csrc/imagine_actor.cu`. The stoch that
  the actor's w_s takes, and that w_in_s takes from step 1 on, is the
  rollout's own one-hot sample; stoch0 @ w_in_s at step 0 is a product."""
  item, SC = cost.itemsize(dtype), S * C
  cell, cell_vectors = cell_numel(A, D, U, n_out)
  products = (cell + head_in(D, U, n_out) * SC + D * U
              + (n_act - 1) * U * U + U * A)
  flops = B * (2.0 * H * products + 2.0 * SC * U + (2 * H - 1) * S * U)
  weights = products + 2 * SC * U                      # w_in_s, actor w_s.
  vectors = cell_vectors + SC + 2 * U * n_act + A
  nbytes = item * (weights + vectors + B * (SC + D + A))
  nbytes += 4 * H * B * (SC + A)                       # Gumbel noise.
  nbytes += H * B * (item * (D + SC + A) + 4 * SC)     # Carries, logits.
  return flops, nbytes


def rollout_work(T, B, A, D, U, S, C, n_out, dtype, E=None):
  """(flops, bytes) of one call of `csrc/imagine.cu` (E None) or of the
  forward-only `csrc/observe.cu` (E, the embeds' width). `observe` reads
  no prior head, so none of `w_out*`, `w_st`, `b_st` counts for it."""
  item, SC = cost.itemsize(dtype), S * C
  products, vectors = cell_numel(A, D, U, n_out if E is None else None)
  # w_st, or w_post.
  products += (head_in(D, U, n_out) if E is None else U) * SC
  vectors += SC
  data = B * SC + B * D + T * B * A                    # stoch0, deter0, acts.
  if E is not None:
    products += D * U + E * U                          # w_obs_d, w_obs_e.
    vectors += 2 * U
    data += T * B * E
  flops = 2.0 * T * B * products + B * (2.0 * SC * U + (T - 1) * S * U)
  nbytes = item * (products + SC * U + vectors + data)
  nbytes += 4 * T * B * SC                             # Gumbel noise.
  if E is not None:
    nbytes += 4 * T * B                                # is_first.
  nbytes += T * B * (item * (D + SC) + 4 * SC)         # The three outputs.
  return flops, nbytes


def imagine_actor_cuda(params, actor, stoch0, deter0, action0, horizon,
                       noise=None, unimix=0.01, act_unimix=0.01):
  """The rollout as one launch of the CUDA kernel; same contract as
  `imagine_actor_plain`. Raises unless every input is a CUDA tensor of
  the compute dtype (float32 or bfloat16) in the layout the kernel reads."""
  name = 'imagine_actor_cuda'
  dtype, device = stoch0.dtype, stoch0.device
  _check_dtype(name, dtype)
  B, SC = stoch0.shape
  D = deter0.shape[1]
  U = params['w_in_s'].shape[1]
  A = action0.shape[-1]
  S, C = params['stoch_n'], params['classes']
  n_out, n_act = len(params['w_out']), len(actor['ln_scale'])
  if S * C != SC or len(actor['w_h']) != n_act - 1:
    raise ValueError(f'{name}: inconsistent shapes.')
  workspace = _rollout_workspace(name, B, D, U, S, C, A, dtype, device,
                                 (n_out, n_act), actor=True)
  weights = [
      params['w_in_s'], params['w_in_a'], params['ln_in_scale'],
      params['ln_in_bias'], params['w_gru_d'], params['w_gru_x'],
      params['ln_gru_scale'], params['ln_gru_bias'], params['w_st'],
      params['b_st'], actor['w_d'], actor['w_s'], actor['w_out'],
      actor['b_out']]
  layers = []
  for w, s, b in zip(params['w_out'], params['ln_out_scale'],
                     params['ln_out_bias']):
    layers += [w, s, b]
  for s, b in zip(actor['ln_scale'], actor['ln_bias']):
    layers += [s, b]
  layers += list(actor['w_h'])
  inputs = [stoch0, deter0, action0.to(dtype), *weights, *layers]
  build.check(name, [(f'input {i}', x) for i, x in enumerate(inputs)],
              device, dtype)
  g_s = g_a = None
  if noise is not None:
    g_s, g_a = (n.to(f32).contiguous() for n in noise)
    build.check(name, [('noise', g_s), ('action noise', g_a)], device, f32)
    if g_s.shape != (horizon, B, SC) or g_a.shape != (horizon, B, A):
      raise ValueError(f'{name}: noise shape.')
  deters = torch.empty((horizon, B, D), dtype=dtype, device=device)
  logits = torch.empty((horizon, B, SC), dtype=f32, device=device)
  stochs = torch.empty((horizon, B, SC), dtype=dtype, device=device)
  actions = torch.empty((horizon, B, A), dtype=dtype, device=device)
  ptrs = [inputs[0], inputs[1], inputs[2], g_s, g_a, *weights,
          deters, logits, stochs, actions, *layers, workspace]
  build.launch(IMAGINE_ACTOR, 'imagine_actor', dtype, ptrs,
               [B, horizon, D, U, S, C, A, n_out, n_act],
               [unimix, act_unimix], device)
  return deters, logits, stochs, actions


def imagine_actor(params, actor, stoch0, deter0, action0, horizon,
                  generator=None, unimix=0.01, act_unimix=0.01, sample=True,
                  noise=None):
  """H-step policy-in-the-loop rollout (see the module docstring).

  With `sample`, the Gumbel noise is `noise` when given, else drawn from
  `generator` on the inputs' device. A CUDA input launches the kernel, a
  CPU input runs the plain version."""
  if sample and noise is None:
    B, SC = stoch0.shape
    A = action0.shape[-1]
    noise = (gumbel((horizon, B, SC), generator, stoch0.device),
             gumbel((horizon, B, A), generator, stoch0.device))
  if not sample:
    noise = None
  fn = imagine_actor_plain if stoch0.device.type == 'cpu' else (
      imagine_actor_cuda)
  work = lambda: imagine_actor_work(
      stoch0.shape[0], horizon, deter0.shape[1], params['w_in_s'].shape[1],
      params['stoch_n'], params['classes'], action0.shape[-1],
      len(params['w_out']), len(actor['ln_scale']), stoch0.dtype)
  with cost.kernel('imagine_actor', work):
    return fn(params, actor, stoch0, deter0, action0, horizon, noise=noise,
              unimix=unimix, act_unimix=act_unimix)


# ---------------------------------------------------------------------------
# The rollout on given actions.


def _sample(logit, noise, S, C, unimix):
  """One-hot [B,S*C] float32 per group of C classes: the argmax of the
  raw logits, or with noise of log((1-u) softmax(z) + u/C) + g."""
  B = logit.shape[0]
  z = logit.reshape(B, S, C)
  if noise is not None:
    z = _mixed_logprobs(z, unimix) + noise.reshape(B, S, C)
  return _argmax_onehot(z).reshape(B, S * C)


@torch.no_grad()
def imagine_plain(params, stoch0, deter0, actions, noise=None, unimix=0.01):
  """The rollout on given actions in PyTorch (the arithmetic of the JAX
  package's `imagine_scan`). actions [H,B,A]; noise [H,B,S*C] float32, or
  None for argmax latents. Returns (deters [H,B,D], logits [H,B,S*C]
  float32 raw, stochs [H,B,S*C])."""
  S, C = params['stoch_n'], params['classes']
  B = stoch0.shape[0]
  dtype = stoch0.dtype
  stoch, deter = stoch0, deter0
  outs = []
  for t in range(actions.shape[0]):
    deter, logit = _img_cell(stoch, deter, actions[t].to(dtype), params)
    stoch = _sample(logit, None if noise is None else noise[t], S, C,
                    unimix).to(dtype)
    outs.append((deter, logit, stoch))
  return tuple(torch.stack(x, 0) for x in zip(*outs))


def imagine_cuda(params, stoch0, deter0, actions, noise=None, unimix=0.01):
  """The rollout on given actions as one launch of `csrc/imagine.cu`; same
  contract as `imagine_plain`. Raises unless every input is a contiguous
  CUDA tensor of the compute dtype (float32 or bfloat16)."""
  name = 'imagine_cuda'
  dtype, device = stoch0.dtype, stoch0.device
  _check_dtype(name, dtype)
  H, B, A = actions.shape
  SC, U = params['w_in_s'].shape
  D = params['w_gru_d'].shape[0]
  S, C = params['stoch_n'], params['classes']
  n_out = len(params['w_out'])
  _check_shapes(name, params, dict(
      _cell_shapes(A, D, U, SC), w_st=(head_in(D, U, n_out), SC),
      b_st=(SC,)))
  _check_shapes(name, {'stoch0': stoch0, 'deter0': deter0},
                {'stoch0': (B, S * C), 'deter0': (B, D)})
  layers = _prior_layers(name, params, D, U)
  workspace = _rollout_workspace(name, B, D, U, S, C, A, dtype, device,
                                 (n_out,), actor=False)
  weights = [*(params[k] for k in _CELL), params['w_st'], params['b_st'],
             *layers[0], *layers[1], *layers[2]]
  inputs = [stoch0, deter0, actions]
  build.check(name, [(f'input {i}', x) for i, x in enumerate(inputs)]
              + [(f'weight {i}', x) for i, x in enumerate(weights)],
              device, dtype)
  if noise is not None:
    noise = noise.to(f32).contiguous()
    build.check(name, [('noise', noise)], device, f32)
    if tuple(noise.shape) != (H, B, SC):
      raise ValueError(f'{name}: noise has the wrong shape.')
  deters = torch.empty((H, B, D), dtype=dtype, device=device)
  logits = torch.empty((H, B, SC), dtype=f32, device=device)
  stochs = torch.empty((H, B, SC), dtype=dtype, device=device)
  ptrs = [*inputs, noise, deters, logits, stochs, *weights, workspace]
  build.launch(IMAGINE, 'imagine', dtype, ptrs,
               [H, B, A, D, U, S, C, n_out], [unimix], device)
  return deters, logits, stochs


def imagine(params, stoch0, deter0, actions, generator=None, unimix=0.01,
            sample=True, noise=None):
  """H-step imagination rollout on given actions [H,B,A] (see the module
  docstring). With `sample`, the Gumbel noise is `noise` [H,B,S*C] when
  given, else drawn from `generator` on the inputs' device. A CUDA input
  launches the kernel, a CPU input runs the plain version."""
  if sample and noise is None:
    H, B = actions.shape[:2]
    noise = gumbel((H, B, stoch0.shape[-1]), generator, stoch0.device)
  if not sample:
    noise = None
  fn = imagine_plain if stoch0.device.type == 'cpu' else imagine_cuda
  work = lambda: rollout_work(*widths(params, actions), stoch0.dtype)
  with cost.kernel('imagine', work):
    return fn(params, stoch0, deter0, actions, noise=noise, unimix=unimix)


# ---------------------------------------------------------------------------
# The posterior chain, forward only.


@torch.no_grad()
def observe_plain(params, stoch0, deter0, actions, embeds, is_first,
                  noise=None, unimix=0.01):
  """The posterior chain in PyTorch (the arithmetic of the JAX package's
  `observe_scan`). actions [T,B,A], embeds [T,B,E], is_first [T,B]; noise
  [T,B,S*C] float32, or None for argmax latents. Returns (deters [T,B,D],
  posterior logits [T,B,S*C] float32 raw, stochs [T,B,S*C])."""
  S, C = params['stoch_n'], params['classes']
  dtype = stoch0.dtype
  stoch, deter = stoch0, deter0
  outs = []
  for t in range(actions.shape[0]):
    keep = (1.0 - is_first[t].float())[:, None]
    stoch = (stoch.float() * keep).to(dtype)
    deter = (deter.float() * keep).to(dtype)
    action = (actions[t].float() * keep).to(dtype)
    deter = _img_deter(stoch, deter, action, params)
    x = _dot(deter, params['w_obs_d']) + _dot(embeds[t], params['w_obs_e'])
    x = _elu(_layernorm(
        x.to(dtype), params['ln_obs_scale'], params['ln_obs_bias']))
    logit = _dot(x, params['w_post']) + params['b_post'].float()
    stoch = _sample(logit, None if noise is None else noise[t], S, C,
                    unimix).to(dtype)
    outs.append((deter, logit, stoch))
  return tuple(torch.stack(x, 0) for x in zip(*outs))


def observe_cuda(params, stoch0, deter0, actions, embeds, is_first,
                 noise=None, unimix=0.01):
  """The posterior chain as one call of `csrc/observe.cu` (two launches on
  the current stream: the embed product over all rows, then the clustered
  chain); same contract as `observe_plain`. Raises unless every input is a
  contiguous CUDA tensor of the compute dtype (float32 or bfloat16) at
  widths the kernel takes. The prior head's weights (`w_out*`, `w_st`,
  `b_st`) are not read."""
  name = 'observe_cuda'
  dtype, device = stoch0.dtype, stoch0.device
  _check_dtype(name, dtype)
  T, B, A = actions.shape
  E = embeds.shape[-1]
  SC, U = params['w_in_s'].shape
  D = params['w_gru_d'].shape[0]
  S, C = params['stoch_n'], params['classes']
  _check_shapes(name, params, dict(
      _cell_shapes(A, D, U, SC), w_obs_d=(D, U), w_obs_e=(E, U),
      ln_obs_scale=(U,), ln_obs_bias=(U,), w_post=(U, SC), b_post=(SC,)))
  _check_shapes(
      name, {'stoch0': stoch0, 'deter0': deter0, 'embeds': embeds,
             'is_first': is_first},
      {'stoch0': (B, S * C), 'deter0': (B, D), 'embeds': (T, B, E),
       'is_first': (T, B)})
  # `chain_bytes` of csrc/observe.cu: the keep mask, the warps' row sums,
  # the classes and the product's scratch (its prologue takes 80 KB at
  # most), and the vectors (`vector_floats`), in shared memory or in a
  # workspace.
  floats = R * (2 * SC + 5 * D + A + 2 * U)
  fixed = R * (1 + NW + S) + SCRATCH
  workspace = cluster_workspace(name, 4 * (floats + fixed), 4 * fixed,
                                floats, B, device)
  weights = [*(params[k] for k in _CELL), params['w_obs_d'],
             params['w_obs_e'], params['ln_obs_scale'],
             params['ln_obs_bias'], params['w_post'], params['b_post']]
  inputs = [stoch0, deter0, actions, embeds]
  build.check(name, [(f'input {i}', x) for i, x in enumerate(inputs)]
              + [(f'weight {i}', x) for i, x in enumerate(weights)],
              device, dtype)
  first = is_first.to(f32).contiguous()
  build.check(name, [('is_first', first)], device, f32)
  if noise is not None:
    noise = noise.to(f32).contiguous()
    build.check(name, [('noise', noise)], device, f32)
    if tuple(noise.shape) != (T, B, SC):
      raise ValueError(f'{name}: noise has the wrong shape.')
  deters = torch.empty((T, B, D), dtype=dtype, device=device)
  logits = torch.empty((T, B, SC), dtype=f32, device=device)
  stochs = torch.empty((T, B, SC), dtype=dtype, device=device)
  # The prologue's embeds @ w_obs_e, float32, last: the kernel's parent
  # reads the list in order as far as the weights.
  e_proj = torch.empty((T, B, U), dtype=f32, device=device)
  ptrs = [*inputs, first, noise, deters, logits, stochs, *weights, e_proj,
          workspace]
  build.launch(OBSERVE, 'observe', dtype, ptrs,
               [T, B, A, E, D, U, S, C, load_values(dtype, D, U, SC)],
               [unimix], device)
  return deters, logits, stochs


def observe_clusters(dtype, T, B, A, E, D, U, S, C):
  """How many thread block clusters of `observe`'s chain fit the card at
  once at these widths: (clusters of 4 blocks, the size it launches,
  clusters of 8), from `cudaOccupancyMaxActiveClusters`. The chain takes
  one cluster per pair of rows. Builds the kernel; needs a card."""
  fit = (ctypes.c_int * 2)()
  err = OBSERVE.lib().observe_clusters(
      int(dtype == torch.bfloat16), (ctypes.c_int * 8)(T, B, A, E, D, U, S, C),
      fit)
  if err != 0:
    raise RuntimeError(f'observe_clusters failed: CUDA error {err}.')
  return fit[0], fit[1]


def observe(params, stoch0, deter0, actions, embeds, is_first,
            generator=None, unimix=0.01, sample=True, noise=None):
  """T-step posterior chain, forward only (see the module docstring). With
  `sample`, the Gumbel noise is `noise` [T,B,S*C] when given, else drawn
  from `generator` on the inputs' device. A CUDA input launches the kernel,
  a CPU input runs the plain version."""
  if sample and noise is None:
    T, B = actions.shape[:2]
    noise = gumbel((T, B, stoch0.shape[-1]), generator, stoch0.device)
  if not sample:
    noise = None
  fn = observe_plain if stoch0.device.type == 'cpu' else observe_cuda
  work = lambda: rollout_work(*widths(params, actions), stoch0.dtype,
                              E=embeds.shape[-1])
  with cost.kernel('observe', work):
    return fn(params, stoch0, deter0, actions, embeds, is_first, noise=noise,
              unimix=unimix)


# ---------------------------------------------------------------------------
# Random weights for the tests and the proof entry point.


def _uniform(rng, shape, dtype, device):
  lim = np.sqrt(3.0 / np.mean(shape))
  values = rng.uniform(-lim, lim, shape).astype(np.float32)
  return torch.as_tensor(values).to(device, dtype)


def make_actor_params(seed, deter, units, stoch, classes, action_dim,
                      layers=4, dtype=torch.float32, device='cpu'):
  """Random actor-MLP weights in the layout `imagine_actor` takes (an MLP
  over [deter, stoch] and a one-hot head), from a numpy seed: uniform
  fan-average kernels, unit norm scales, zero biases."""
  rng = np.random.default_rng(seed)
  uni = lambda *shape: _uniform(rng, shape, dtype, device)
  SC = stoch * classes
  return {
      'w_d': uni(deter, units), 'w_s': uni(SC, units),
      'w_h': [uni(units, units) for _ in range(layers - 1)],
      'ln_scale': [torch.ones(units, dtype=dtype, device=device)
                   for _ in range(layers)],
      'ln_bias': [torch.zeros(units, dtype=dtype, device=device)
                  for _ in range(layers)],
      'w_out': uni(units, action_dim),
      'b_out': torch.zeros(action_dim, dtype=dtype, device=device)}


def make_params(seed, deter, units, stoch, classes, action_dim, embed_dim,
                prior_layers=3, dtype=torch.float32, device='cpu'):
  """Random cell weights in the layout every function of this module
  takes, from a numpy seed: uniform fan-average kernels, unit norm scales,
  zero biases."""
  rng = np.random.default_rng(seed)
  uni = lambda *shape: _uniform(rng, shape, dtype, device)
  ones = lambda n: torch.ones(n, dtype=dtype, device=device)
  zeros = lambda n: torch.zeros(n, dtype=dtype, device=device)
  SC = stoch * classes
  return {
      'w_in_s': uni(SC, units), 'w_in_a': uni(action_dim, units),
      'ln_in_scale': ones(units), 'ln_in_bias': zeros(units),
      'w_gru_d': uni(deter, 3 * deter), 'w_gru_x': uni(units, 3 * deter),
      'ln_gru_scale': ones(3 * deter), 'ln_gru_bias': zeros(3 * deter),
      'w_out': [uni(deter if i == 0 else units, units)
                for i in range(prior_layers)],
      'ln_out_scale': [ones(units) for _ in range(prior_layers)],
      'ln_out_bias': [zeros(units) for _ in range(prior_layers)],
      'w_st': uni(head_in(deter, units, prior_layers), SC),
      'b_st': zeros(SC),
      'w_obs_d': uni(deter, units), 'w_obs_e': uni(embed_dim, units),
      'ln_obs_scale': ones(units), 'ln_obs_bias': zeros(units),
      'w_post': uni(units, SC), 'b_post': zeros(SC),
      'stoch_n': stoch, 'classes': classes}

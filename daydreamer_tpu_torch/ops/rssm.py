"""RSSM sequence cells for the fused rollout, the port of the parts of
`daydreamer_tpu/ops/pallas_rssm.py` that the training path runs.

`imagine_actor` is the policy-in-the-loop imagination rollout (the JAX
package's `imagine_actor_pallas`): H steps of the image cell, a one-hot
prior sample, the actor MLP and a one-hot action, forward only. On a CUDA
tensor it launches the CUDA kernel `csrc/imagine_actor.cu` (which replaces
`pallas_rssm.py::_imagine_actor_kernel`; its source note gives the bound
and the design); on a CPU tensor it runs `imagine_actor_plain`, the same
arithmetic in PyTorch. The Gumbel noise is an input of both: the wrapper
draws it from the caller's generator, on the tensors' device.

The cell math mirrors the JAX cell exactly: matmuls accumulate in float32
and round to the compute dtype, LayerNorm runs in float32 (eps 1e-3), ELU
is exp(x) - 1, the GRU gates are float32. The logits returned are RAW; the
caller applies the unimix to store log-probs.
"""

import ctypes

import torch

from . import build
from ..nn.dists import gumbel

f32 = torch.float32

IMAGINE_ACTOR = build.register(build.Kernel(
    'imagine_actor', 'imagine_actor.cu',
    'daydreamer_tpu/ops/pallas_rssm.py:427 (_imagine_actor_kernel)',
    {'imagine_actor': (ctypes.c_int, [
        ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int), ctypes.c_float, ctypes.c_float,
        ctypes.c_void_p])}))


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


def _img_cell(stoch, deter, action, params):
  """One img_step: returns (deter', raw logits float32)."""
  x = _dot(stoch, params['w_in_s']) + _dot(action, params['w_in_a'])
  x = _elu(_layernorm(
      x.to(stoch.dtype), params['ln_in_scale'], params['ln_in_bias']))
  deter = _gru_core(deter, x, params)
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


def _ptr(x):
  return ctypes.c_void_p(x.data_ptr() if x is not None else 0)


def imagine_actor_cuda(params, actor, stoch0, deter0, action0, horizon,
                       noise=None, unimix=0.01, act_unimix=0.01):
  """The rollout as one launch of the CUDA kernel; same contract as
  `imagine_actor_plain`. Raises unless every input is a CUDA tensor of
  the compute dtype (float32 or bfloat16) in the layout the kernel reads."""
  dtype = stoch0.dtype
  if dtype not in (torch.float32, torch.bfloat16):
    raise TypeError(f'imagine_actor takes float32 or bfloat16, not {dtype}.')
  B, SC = stoch0.shape
  D = deter0.shape[1]
  U = params['w_in_s'].shape[1]
  A = action0.shape[-1]
  S, C = params['stoch_n'], params['classes']
  n_out, n_act = len(params['w_out']), len(actor['ln_scale'])
  if S * C != SC or len(actor['w_h']) != n_act - 1:
    raise ValueError('imagine_actor: inconsistent shapes.')
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
  device = stoch0.device
  for x in inputs:
    if x.device != device or x.device.type != 'cuda':
      raise ValueError(f'imagine_actor_cuda: tensor on {x.device}.')
    if x.dtype != dtype:
      raise TypeError(f'imagine_actor_cuda: {x.dtype} among {dtype}.')
    if not x.is_contiguous():
      raise ValueError('imagine_actor_cuda: non-contiguous input.')
  g_s = g_a = None
  if noise is not None:
    g_s, g_a = (n.to(f32).contiguous() for n in noise)
    if g_s.shape != (horizon, B, SC) or g_a.shape != (horizon, B, A):
      raise ValueError('imagine_actor_cuda: noise shape.')
  deters = torch.empty((horizon, B, D), dtype=dtype, device=device)
  logits = torch.empty((horizon, B, SC), dtype=f32, device=device)
  stochs = torch.empty((horizon, B, SC), dtype=dtype, device=device)
  actions = torch.empty((horizon, B, A), dtype=dtype, device=device)
  ptrs = [inputs[0], inputs[1], inputs[2], g_s, g_a, *weights,
          deters, logits, stochs, actions, *layers]
  ptr_array = (ctypes.c_void_p * len(ptrs))(*[_ptr(x).value for x in ptrs])
  dims = (ctypes.c_int * 9)(B, horizon, D, U, S, C, A, n_out, n_act)
  lib = IMAGINE_ACTOR.lib()
  stream = torch.cuda.current_stream(device).cuda_stream
  err = lib.imagine_actor(
      int(dtype == torch.bfloat16), ptr_array, dims, float(unimix),
      float(act_unimix), ctypes.c_void_p(stream))
  if err != 0:
    raise RuntimeError(f'imagine_actor kernel failed: CUDA error {err}.')
  IMAGINE_ACTOR.launches += 1
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
  return fn(params, actor, stoch0, deter0, action0, horizon, noise=noise,
            unimix=unimix, act_unimix=act_unimix)

"""Differentiable fused RSSM observe chain, the port of
`daydreamer_tpu/ops/pallas_rssm_vjp.py`.

`observe_fused` runs the whole T-step posterior chain of a chunk as ONE
forward kernel and, under autograd, ONE backward kernel:

  - forward (`csrc/observe_fwd.cu`, replaces `_obs_fwd_kernel`): per step
    the `is_first` mask, the image cell (img_in + LN + ELU, GRU with LN and
    update bias -1, the prior MLP), the raw prior logits, the posterior
    head, the unimix softmax within each group of C classes and a
    Gumbel-max one-hot. Outputs: deters, post logits (raw, float32), prior
    logits (raw, float32), stochs (exact one-hots).
  - backward (`csrc/observe_bwd.cu`, replaces `_obs_bwd_kernel`): the
    sequential part of backpropagation through time. It walks t = T-1..0,
    recomputes each step's forward from the saved carries, and emits the
    per-step pre-activation adjoints (float32) plus the gradients of the
    initial state. The stoch samples carry straight-through gradients.
  - epilogue (`observe_weight_grads`, plain PyTorch as in the JAX package):
    every weight gradient is one batched product over the T*B rows of a
    recomputed layer input and an emitted adjoint.

On a CUDA tensor the wrappers launch the kernels or raise; on a CPU tensor
they run `observe_fwd_plain` / `observe_bwd_plain`, the same arithmetic step
by step in PyTorch. All intermediates are float32 (weights are widened at
read); only the carries and the deter/stoch outputs are rounded to the
compute dtype. The backward recomputes from those rounded carries and takes
`e_proj = embeds @ w_obs_e` rounded to the compute dtype, as the reference
does. `is_first` ZEROES the incoming state and action; it does not replace
them by the learned initial state (the loop path does). The Gumbel noise is
an input of both routes. An exact tie within a group takes the first
maximum in the kernel and in the plain version alike.

`observe_scan_full` is the independent differentiable reference (autograd
through a plain loop) that the gradient tests hold the chain to.
"""

import ctypes

import torch

from . import build
from ..nn.dists import gumbel

f32 = torch.float32

_SIGNATURE = (ctypes.c_int, [
    ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
    ctypes.POINTER(ctypes.c_int), ctypes.c_float, ctypes.c_void_p])

OBSERVE_FWD = build.register(build.Kernel(
    'observe_fwd', 'observe_fwd.cu',
    'daydreamer_tpu/ops/pallas_rssm_vjp.py:239 (_obs_fwd_kernel)',
    {'observe_fwd': _SIGNATURE}, headers=('observe_common.cuh',)))

OBSERVE_BWD = build.register(build.Kernel(
    'observe_bwd', 'observe_bwd.cu',
    'daydreamer_tpu/ops/pallas_rssm_vjp.py:280 (_obs_bwd_kernel)',
    {'observe_bwd': _SIGNATURE}, headers=('observe_common.cuh',)))

# The order of the weights everywhere in this module (and of the gradients
# `ObserveFused.backward` returns): eight cell entries, the prior layers'
# kernels, scales and biases, then the two heads.
_HEAD = ('w_in_s', 'w_in_a', 'ln_in_scale', 'ln_in_bias',
         'w_gru_d', 'w_gru_x', 'ln_gru_scale', 'ln_gru_bias')
_LAYERS = ('w_out', 'ln_out_scale', 'ln_out_bias')
_TAIL = ('w_st', 'b_st', 'w_obs_d', 'w_obs_e', 'ln_obs_scale',
         'ln_obs_bias', 'w_post', 'b_post')


def flatten_params(params):
  """params dict -> (flat list of tensors, n_out)."""
  n_out = len(params['w_out'])
  flat = [params[k] for k in _HEAD]
  for key in _LAYERS:
    flat += list(params[key])
  flat += [params[k] for k in _TAIL]
  return flat, n_out


def unflatten_params(flat, n_out, stoch_n=None, classes=None):
  flat = list(flat)
  params = dict(zip(_HEAD, flat[:8]))
  for i, key in enumerate(_LAYERS):
    params[key] = flat[8 + i * n_out:8 + (i + 1) * n_out]
  params.update(zip(_TAIL, flat[8 + 3 * n_out:]))
  params['stoch_n'], params['classes'] = stoch_n, classes
  return params


def _ln_fwd(z, scale, bias, eps=1e-3):
  """(out, xhat, inv_std), all float32."""
  mean = z.mean(-1, keepdim=True)
  var = ((z - mean) ** 2).mean(-1, keepdim=True)
  inv = torch.rsqrt(var + eps)
  xhat = (z - mean) * inv
  return xhat * scale + bias, xhat, inv


def _ln_bwd(dn, xhat, inv, scale):
  """dz given dn, the gradient at the LayerNorm's output."""
  dxhat = dn * scale
  return inv * (dxhat - dxhat.mean(-1, keepdim=True)
                - xhat * (dxhat * xhat).mean(-1, keepdim=True))


def _elu(n):
  return torch.where(n > 0, n, torch.exp(n) - 1.0)


def _elu_grad(n):
  return torch.where(n > 0, torch.ones_like(n), torch.exp(n))


def _group(x, classes):
  return x.reshape(x.shape[:-1] + (-1, classes))


def _group_softmax(z, classes):
  return torch.softmax(_group(z, classes), -1).reshape(z.shape)


def _group_sum(x, classes):
  """Sum within each group of `classes` lanes, broadcast back."""
  return _group(x, classes).sum(-1, keepdim=True).expand(
      x.shape[:-1] + (-1, classes)).reshape(x.shape)


def _first_max_onehot(scores, classes):
  """One-hot of the first maximum of each group (torch.argmax returns the
  first of equal maxima)."""
  grouped = _group(scores, classes)
  onehot = torch.nn.functional.one_hot(grouped.argmax(-1), classes)
  return onehot.to(f32).reshape(scores.shape)


# ---------------------------------------------------------------------------
# The independent reference: a differentiable plain loop.


def observe_scan_full(params, stoch0, deter0, actions, embeds, is_first,
                      noise=None, unimix=0.01, sample=True, taps=None):
  """T-step posterior chain emitting (deters, post_logits, prior_logits,
  stochs), differentiable by autograd. All arithmetic is float32; the
  carries are rounded to the dtype of `stoch0`; stochs carry
  straight-through gradients through the unimix probabilities. `noise` is
  the Gumbel tensor [T, B, S*C] (None or zeros give the modes). `taps`, a
  list, receives one dict of each step's pre-activations (with retained
  gradients), for tests that locate a wrong adjoint."""
  classes = params['classes']
  w = lambda key: params[key].float()
  stoch, deter = stoch0, deter0
  outs = []
  for t in range(actions.shape[0]):
    keep = (1.0 - is_first[t].float())[:, None]
    s_m = stoch.float() * keep
    d_m = deter.float() * keep
    a_m = actions[t].float() * keep
    z1 = s_m @ w('w_in_s') + a_m @ w('w_in_a')
    n1, _, _ = _ln_fwd(z1, w('ln_in_scale'), w('ln_in_bias'))
    x1 = _elu(n1)
    zg = d_m @ w('w_gru_d') + x1 @ w('w_gru_x')
    ng, _, _ = _ln_fwd(zg, w('ln_gru_scale'), w('ln_gru_bias'))
    gr, gc, gu = torch.chunk(ng, 3, -1)
    r = torch.sigmoid(gr)
    c = torch.tanh(r * gc)
    u = torch.sigmoid(gu - 1)
    d_t = u * c + (1 - u) * d_m
    p = d_t
    qs, ms = [], []
    for w_out, scale, bias in zip(params['w_out'], params['ln_out_scale'],
                                  params['ln_out_bias']):
      q = p @ w_out.float()
      m, _, _ = _ln_fwd(q, scale.float(), bias.float())
      p = _elu(m)
      qs.append(q)
      ms.append(m)
    prior_logit = p @ w('w_st') + w('b_st')
    z2 = d_t @ w('w_obs_d') + embeds[t].float() @ w('w_obs_e')
    n2, _, _ = _ln_fwd(z2, w('ln_obs_scale'), w('ln_obs_bias'))
    post_logit = _elu(n2) @ w('w_post') + w('b_post')
    probs = _group_softmax(post_logit, classes)
    if unimix:
      probs = (1 - unimix) * probs + unimix / classes
    if sample and noise is not None:
      scores = torch.log(probs) + noise[t].float()
    else:
      scores = probs
    onehot = _first_max_onehot(scores.detach(), classes)
    s_t = onehot + probs - probs.detach()
    if taps is not None:
      tap = dict(z1=z1, n1=n1, zg=zg, ng=ng, z2=z2, n2=n2, qs=qs, ms=ms,
                 post_logit=post_logit)
      for value in tap.values():
        for x in (value if isinstance(value, list) else [value]):
          x.retain_grad()
      taps.append(tap)
    stoch, deter = s_t.to(stoch0.dtype), d_t.to(deter0.dtype)
    outs.append((d_t, post_logit, prior_logit, s_t))
  return tuple(torch.stack(x, 0) for x in zip(*outs))


# ---------------------------------------------------------------------------
# The kernels' functions, step by step.


def _cell_fwd(params, s_prev, d_prev, a, keep):
  """Every forward intermediate of one step's image cell (float32)."""
  w = lambda key: params[key].float()
  s_m = s_prev.float() * keep
  d_m = d_prev.float() * keep
  a_m = a.float() * keep
  z1 = s_m @ w('w_in_s') + a_m @ w('w_in_a')
  n1, xh1, inv1 = _ln_fwd(z1, w('ln_in_scale'), w('ln_in_bias'))
  x1 = _elu(n1)
  zg = d_m @ w('w_gru_d') + x1 @ w('w_gru_x')
  ng, xhg, invg = _ln_fwd(zg, w('ln_gru_scale'), w('ln_gru_bias'))
  gr, gc, gu = torch.chunk(ng, 3, -1)
  r = torch.sigmoid(gr)
  c = torch.tanh(r * gc)
  u = torch.sigmoid(gu - 1)
  d_t = u * c + (1 - u) * d_m
  ps, lns = [d_t], []
  for w_out, scale, bias in zip(params['w_out'], params['ln_out_scale'],
                                params['ln_out_bias']):
    q = ps[-1] @ w_out.float()
    m, xh, inv = _ln_fwd(q, scale.float(), bias.float())
    lns.append((m, xh, inv))
    ps.append(_elu(m))
  return dict(s_m=s_m, d_m=d_m, a_m=a_m, n1=n1, xh1=xh1, inv1=inv1, x1=x1,
              xhg=xhg, invg=invg, r=r, c=c, u=u, gc=gc, d_t=d_t, ps=ps,
              lns=lns)


def _as_tb(is_first):
  """is_first [T, B] (bool or number) -> float32 keep mask [T, B, 1]."""
  return (1.0 - is_first.to(f32))[..., None]


@torch.no_grad()
def observe_fwd_plain(params, stoch0, deter0, actions, embeds, is_first,
                      noise=None, unimix=0.01, sample=True):
  """What the forward kernel computes, in PyTorch. Returns (deters [T,B,D]
  dtype, post_logits [T,B,S*C] float32 raw, prior_logits [T,B,S*C] float32
  raw, stochs [T,B,S*C] dtype, exact one-hots of each group's first
  maximum)."""
  classes = params['classes']
  dtype = stoch0.dtype
  w = lambda key: params[key].float()
  keeps = _as_tb(is_first)
  stoch, deter = stoch0, deter0
  outs = []
  for t in range(actions.shape[0]):
    fw = _cell_fwd(params, stoch, deter, actions[t], keeps[t])
    prior_logit = fw['ps'][-1] @ w('w_st') + w('b_st')
    z2 = fw['d_t'] @ w('w_obs_d') + embeds[t].float() @ w('w_obs_e')
    n2, _, _ = _ln_fwd(z2, w('ln_obs_scale'), w('ln_obs_bias'))
    post_logit = _elu(n2) @ w('w_post') + w('b_post')
    probs = _group_softmax(post_logit, classes)
    if unimix:
      probs = (1 - unimix) * probs + unimix / classes
    if sample and noise is not None:
      scores = torch.log(probs) + noise[t].float()
    else:
      scores = probs
    stoch = _first_max_onehot(scores, classes).to(dtype)
    deter = fw['d_t'].to(dtype)
    outs.append((deter, post_logit, prior_logit, stoch))
  return tuple(torch.stack(x, 0) for x in zip(*outs))


@torch.no_grad()
def observe_bwd_plain(params, stoch0, deter0, actions, e_proj, is_first,
                      deters, post_logits, stochs, cts, unimix=0.01):
  """What the backward kernel computes, in PyTorch: the reverse-time
  adjoint chain, NOT autograd of the forward.

  `deters`, `post_logits`, `stochs` are the forward's outputs, `e_proj` is
  `embeds @ w_obs_e` [T,B,U], `cts` the four float32 cotangents (dd_out,
  dpl, dprl, ds_out). Returns (dz1, dn1, dzg, dng, dz2, dn2, dqs, dms,
  dpl_total, ds0, dd0), float32: per step the gradient after (dz*, dq) and
  before (dn*, dm) each LayerNorm's backward, the total posterior-logit
  gradient, and the gradients of the initial state."""
  classes = params['classes']
  n_out = len(params['w_out'])
  w = lambda key: params[key].float()
  ct = lambda a, m: a @ m.float().t()
  dd_out, dpl, dprl, ds_out = (x.float() for x in cts)
  T = actions.shape[0]
  keeps = _as_tb(is_first)
  s_prev = torch.cat([stoch0[None].to(stochs.dtype), stochs[:-1]], 0)
  d_prev = torch.cat([deter0[None].to(deters.dtype), deters[:-1]], 0)
  ds_c = torch.zeros_like(ds_out[0])
  dd_c = torch.zeros_like(dd_out[0])
  steps = []
  for t in reversed(range(T)):
    keep = keeps[t]
    fw = _cell_fwd(params, s_prev[t], d_prev[t], actions[t], keep)
    # Posterior-logit gradient: direct plus straight-through via the probs.
    ds_total = ds_out[t] + ds_c
    sm = _group_softmax(post_logits[t].float(), classes)
    dsm = (1.0 - unimix) * ds_total if unimix else ds_total
    dpl_st = sm * (dsm - _group_sum(dsm * sm, classes))
    dpl_total = dpl[t] + dpl_st
    # Posterior head.
    z2 = fw['d_t'] @ w('w_obs_d') + e_proj[t].float()
    n2, xh2, inv2 = _ln_fwd(z2, w('ln_obs_scale'), w('ln_obs_bias'))
    dn2 = ct(dpl_total, params['w_post']) * _elu_grad(n2)
    dz2 = _ln_bwd(dn2, xh2, inv2, w('ln_obs_scale'))
    dd_t = dd_out[t] + dd_c + ct(dz2, params['w_obs_d'])
    # Prior head.
    dp = ct(dprl[t], params['w_st'])
    dqs, dms = [None] * n_out, [None] * n_out
    for i in reversed(range(n_out)):
      m, xh, inv = fw['lns'][i]
      dms[i] = dp * _elu_grad(m)
      dqs[i] = _ln_bwd(dms[i], xh, inv, params['ln_out_scale'][i].float())
      dp = ct(dqs[i], params['w_out'][i])
    dd_t = dd_t + dp
    # GRU.
    c, u, r, gc, d_m = fw['c'], fw['u'], fw['r'], fw['gc'], fw['d_m']
    du = dd_t * (c - d_m)
    dc = dd_t * u
    dd_m = dd_t * (1.0 - u)
    dcbar = dc * (1.0 - c * c)
    dgr = dcbar * gc * r * (1.0 - r)
    dgc = dcbar * r
    dgu = du * u * (1.0 - u)
    dng = torch.cat([dgr, dgc, dgu], -1)
    dzg = _ln_bwd(dng, fw['xhg'], fw['invg'], w('ln_gru_scale'))
    dd_m = dd_m + ct(dzg, params['w_gru_d'])
    dn1 = ct(dzg, params['w_gru_x']) * _elu_grad(fw['n1'])
    dz1 = _ln_bwd(dn1, fw['xh1'], fw['inv1'], w('ln_in_scale'))
    ds_c = ct(dz1, params['w_in_s']) * keep
    dd_c = dd_m * keep
    steps.append((dz1, dn1, dzg, dng, dz2, dn2, dqs, dms, dpl_total))
  steps.reverse()
  stack = lambda xs: torch.stack(xs, 0)
  dz1, dn1, dzg, dng, dz2, dn2, dqs, dms, dpl_total = zip(*steps)
  dqs = [stack([step[i] for step in dqs]) for i in range(n_out)]
  dms = [stack([step[i] for step in dms]) for i in range(n_out)]
  return (stack(dz1), stack(dn1), stack(dzg), stack(dng), stack(dz2),
          stack(dn2), dqs, dms, stack(dpl_total), ds_c, dd_c)


def observe_weight_grads(params, stoch0, deter0, actions, embeds, is_first,
                         deters, stochs, adjoints, dprl):
  """The epilogue: weight gradients as batched products over the T*B rows
  of recomputed layer inputs and the adjoints a backward route emitted.
  Returns (flat list of float32 weight gradients in `flatten_params`
  order, da [T,B,A], de [T,B,E])."""
  dz1, dn1, dzg, dng, dz2, dn2, dqs, dms, dpl_total, _, _ = adjoints
  n_out = len(params['w_out'])
  w = lambda key: params[key].float()
  keep = _as_tb(is_first)
  s_prev = torch.cat([stoch0[None].to(stochs.dtype), stochs[:-1]], 0)
  d_prev = torch.cat([deter0[None].to(deters.dtype), deters[:-1]], 0)
  s_m = s_prev.float() * keep
  d_m = d_prev.float() * keep
  a_m = actions.float() * keep
  e_f = embeds.float()
  d_t = deters.float()
  dprl = dprl.float()
  flat2 = lambda x: x.reshape(-1, x.shape[-1])
  mm = lambda a, b: flat2(a).t() @ flat2(b)
  sum01 = lambda x: x.sum((0, 1))
  # The layer inputs the products need, recomputed in one batch each.
  z1 = s_m @ w('w_in_s') + a_m @ w('w_in_a')
  n1, xh1, _ = _ln_fwd(z1, w('ln_in_scale'), w('ln_in_bias'))
  x1 = _elu(n1)
  zg = d_m @ w('w_gru_d') + x1 @ w('w_gru_x')
  _, xhg, _ = _ln_fwd(zg, w('ln_gru_scale'), w('ln_gru_bias'))
  ps, xhqs = [d_t], []
  for w_out, scale, bias in zip(params['w_out'], params['ln_out_scale'],
                                params['ln_out_bias']):
    m, xh, _ = _ln_fwd(ps[-1] @ w_out.float(), scale.float(), bias.float())
    xhqs.append(xh)
    ps.append(_elu(m))
  z2 = d_t @ w('w_obs_d') + e_f @ w('w_obs_e')
  n2, xh2, _ = _ln_fwd(z2, w('ln_obs_scale'), w('ln_obs_bias'))
  x2 = _elu(n2)
  grads = [
      mm(s_m, dz1), mm(a_m, dz1), sum01(dn1 * xh1), sum01(dn1),
      mm(d_m, dzg), mm(x1, dzg), sum01(dng * xhg), sum01(dng),
      *[mm(ps[i], dqs[i]) for i in range(n_out)],
      *[sum01(dms[i] * xhqs[i]) for i in range(n_out)],
      *[sum01(dms[i]) for i in range(n_out)],
      mm(ps[-1], dprl), sum01(dprl),
      mm(d_t, dz2), mm(e_f, dz2), sum01(dn2 * xh2), sum01(dn2),
      mm(x2, dpl_total), sum01(dpl_total)]
  da = (dz1 @ w('w_in_a').t()) * keep
  de = dz2 @ w('w_obs_e').t()
  return grads, da, de


# ---------------------------------------------------------------------------
# The CUDA wrappers.


def _check(name, tensors, device, dtype):
  for key, x in tensors:
    if x.device != device or x.device.type != 'cuda':
      raise ValueError(f'{name}: {key} lies on {x.device}, not on a card.')
    if x.dtype != dtype:
      raise TypeError(f'{name}: {key} is {x.dtype} among {dtype}.')
    if not x.is_contiguous():
      raise ValueError(f'{name}: {key} is not contiguous.')
    if x.data_ptr() % 16:
      raise ValueError(f'{name}: {key} is not aligned to 16 bytes.')


def _shapes(name, params, stoch0, deter0, actions, width_e):
  """Read and check the chain's widths; returns (T, B, A, D, U, S, C, SC,
  n_out)."""
  T, B, A = actions.shape
  SC, U = params['w_in_s'].shape
  D = params['w_gru_d'].shape[0]
  S, C = params['stoch_n'], params['classes']
  n_out = len(params['w_out'])
  expect = {
      'w_in_a': (A, U), 'ln_in_scale': (U,), 'ln_in_bias': (U,),
      'w_gru_d': (D, 3 * D), 'w_gru_x': (U, 3 * D),
      'ln_gru_scale': (3 * D,), 'ln_gru_bias': (3 * D,),
      'w_st': (U, SC), 'b_st': (SC,), 'w_obs_d': (D, U),
      'w_obs_e': (width_e, U), 'ln_obs_scale': (U,), 'ln_obs_bias': (U,),
      'w_post': (U, SC), 'b_post': (SC,)}
  for key, shape in expect.items():
    if tuple(params[key].shape) != shape:
      raise ValueError(f'{name}: {key} has shape '
                       f'{tuple(params[key].shape)}, not {shape}.')
  for i in range(n_out):
    if (tuple(params['w_out'][i].shape) != (D if i == 0 else U, U)
        or tuple(params['ln_out_scale'][i].shape) != (U,)
        or tuple(params['ln_out_bias'][i].shape) != (U,)):
      raise ValueError(f'{name}: prior layer {i} has the wrong shape.')
  if (S * C != SC or tuple(stoch0.shape) != (B, SC)
      or tuple(deter0.shape) != (B, D) or not 1 <= n_out <= 8):
    raise ValueError(f'{name}: inconsistent shapes.')
  if D % 8 or U % 8 or SC % 8:
    raise ValueError(f'{name}: the kernel reads 16 bytes of a weight row at '
                     'a time; deter, units and stoch*classes must be '
                     'multiples of 8.')
  return T, B, A, D, U, S, C, SC, n_out


def _launch(kernel, fn, dtype, ptrs, dims, unimix, device):
  ptr_array = (ctypes.c_void_p * len(ptrs))(
      *[x.data_ptr() if x is not None else 0 for x in ptrs])
  dims = (ctypes.c_int * len(dims))(*dims)
  lib = kernel.lib()
  stream = torch.cuda.current_stream(device).cuda_stream
  err = getattr(lib, fn)(int(dtype == torch.bfloat16), ptr_array, dims,
                         float(unimix), ctypes.c_void_p(stream))
  if err != 0:
    raise RuntimeError(f'{fn} kernel failed: CUDA error {err}.')
  kernel.launches += 1


def observe_fwd_cuda(params, stoch0, deter0, actions, embeds, is_first,
                     noise=None, unimix=0.01, sample=True):
  """The forward chain as one launch of `csrc/observe_fwd.cu`; same
  contract as `observe_fwd_plain`. Raises unless every input is a
  contiguous CUDA tensor of the compute dtype (float32 or bfloat16)."""
  name = 'observe_fwd_cuda'
  dtype, device = stoch0.dtype, stoch0.device
  if dtype not in (torch.float32, torch.bfloat16):
    raise TypeError(f'{name} takes float32 or bfloat16, not {dtype}.')
  E = embeds.shape[-1]
  T, B, A, D, U, S, C, SC, n_out = _shapes(
      name, params, stoch0, deter0, actions, E)
  flat, _ = flatten_params(params)
  inputs = [stoch0, deter0, actions, embeds]
  _check(name, [(f'input {i}', x) for i, x in enumerate(inputs)]
         + [(f'weight {i}', x) for i, x in enumerate(flat)], device, dtype)
  if tuple(embeds.shape) != (T, B, E) or tuple(is_first.shape) != (T, B):
    raise ValueError(f'{name}: embeds or is_first has the wrong shape.')
  first = is_first.to(f32).contiguous()
  if sample and noise is not None:
    noise = noise.to(f32).contiguous()
    _check(name, [('noise', noise), ('is_first', first)], device, f32)
    if tuple(noise.shape) != (T, B, SC):
      raise ValueError(f'{name}: noise has the wrong shape.')
  else:
    noise = None
    _check(name, [('is_first', first)], device, f32)
  deters = torch.empty((T, B, D), dtype=dtype, device=device)
  post = torch.empty((T, B, SC), dtype=f32, device=device)
  prior = torch.empty((T, B, SC), dtype=f32, device=device)
  stochs = torch.empty((T, B, SC), dtype=dtype, device=device)
  ptrs = [stoch0, deter0, actions, embeds, first, noise,
          deters, post, prior, stochs, *flat]
  _launch(OBSERVE_FWD, 'observe_fwd', dtype, ptrs,
          [T, B, A, E, D, U, S, C, n_out], unimix, device)
  return deters, post, prior, stochs


def observe_bwd_cuda(params, stoch0, deter0, actions, e_proj, is_first,
                     deters, post_logits, stochs, cts, unimix=0.01):
  """The adjoint chain as one launch of `csrc/observe_bwd.cu`; same
  contract as `observe_bwd_plain`. `stochs` must be the forward's exact
  one-hots (the kernel gathers weight rows by their classes; `stoch0` may
  be any value). The transposed products read transposed copies of the
  weights, made here; a copy moves data and computes nothing."""
  name = 'observe_bwd_cuda'
  dtype, device = stoch0.dtype, stoch0.device
  if dtype not in (torch.float32, torch.bfloat16):
    raise TypeError(f'{name} takes float32 or bfloat16, not {dtype}.')
  T, B, A, D, U, S, C, SC, n_out = _shapes(
      name, params, stoch0, deter0, actions, params['w_obs_e'].shape[0])
  flat, _ = flatten_params(params)
  typed = [stoch0, deter0, actions, e_proj, deters, stochs]
  _check(name, [(f'input {i}', x) for i, x in enumerate(typed)]
         + [(f'weight {i}', x) for i, x in enumerate(flat)], device, dtype)
  first = is_first.to(f32).contiguous()
  cts = [x.to(f32).contiguous() for x in cts]
  _check(name, [('is_first', first), ('post_logits', post_logits)]
         + [(f'cotangent {i}', x) for i, x in enumerate(cts)], device, f32)
  shapes = [(e_proj, (T, B, U)), (first, (T, B)), (deters, (T, B, D)),
            (post_logits, (T, B, SC)), (stochs, (T, B, SC)),
            (cts[0], (T, B, D)), (cts[1], (T, B, SC)), (cts[2], (T, B, SC)),
            (cts[3], (T, B, SC))]
  if any(tuple(x.shape) != shape for x, shape in shapes):
    raise ValueError(f'{name}: an input has the wrong shape.')
  tr = lambda x: x.t().contiguous()
  transposed = [tr(params[k]) for k in (
      'w_in_s', 'w_gru_d', 'w_gru_x', 'w_st', 'w_obs_d', 'w_post')]
  transposed += [tr(x) for x in params['w_out']]
  empty = lambda *shape: torch.empty(shape, dtype=f32, device=device)
  dz1, dn1 = empty(T, B, U), empty(T, B, U)
  dzg, dng = empty(T, B, 3 * D), empty(T, B, 3 * D)
  dz2, dn2 = empty(T, B, U), empty(T, B, U)
  dqs = [empty(T, B, U) for _ in range(n_out)]
  dms = [empty(T, B, U) for _ in range(n_out)]
  dpl_total, ds0, dd0 = empty(T, B, SC), empty(B, SC), empty(B, D)
  cell = flat[:8 + 3 * n_out]
  heads = [params['w_obs_d'], params['ln_obs_scale'], params['ln_obs_bias']]
  ptrs = [stoch0, deter0, actions, e_proj, first, deters, post_logits,
          stochs, *cts, dz1, dn1, dzg, dng, dz2, dn2, dpl_total, ds0, dd0,
          *cell, *heads, *transposed, *dqs, *dms]
  _launch(OBSERVE_BWD, 'observe_bwd', dtype, ptrs,
          [T, B, A, D, U, S, C, n_out], unimix, device)
  return dz1, dn1, dzg, dng, dz2, dn2, dqs, dms, dpl_total, ds0, dd0


# ---------------------------------------------------------------------------
# Autograd.


class ObserveFused(torch.autograd.Function):
  """(stoch0, deter0, actions, embeds, is_first, noise, n_out, stoch_n,
  classes, unimix, sample, *weights) -> (deters, post_logits, prior_logits,
  stochs). A CUDA input launches the kernels, a CPU input runs the plain
  versions; the weight gradients come from the shared epilogue."""

  @staticmethod
  def forward(ctx, stoch0, deter0, actions, embeds, is_first, noise, n_out,
              stoch_n, classes, unimix, sample, *flat):
    params = unflatten_params(flat, n_out, stoch_n, classes)
    fn = observe_fwd_plain if stoch0.device.type == 'cpu' else (
        observe_fwd_cuda)
    deters, post_logits, prior_logits, stochs = fn(
        params, stoch0, deter0, actions, embeds, is_first, noise=noise,
        unimix=unimix, sample=sample)
    ctx.save_for_backward(stoch0, deter0, actions, embeds, is_first, deters,
                          post_logits, stochs, *flat)
    ctx.cfg = (n_out, stoch_n, classes, unimix)
    return deters, post_logits, prior_logits, stochs

  @staticmethod
  def backward(ctx, *cts):
    n_out, stoch_n, classes, unimix = ctx.cfg
    (stoch0, deter0, actions, embeds, is_first, deters, post_logits,
     stochs, *flat) = ctx.saved_tensors
    params = unflatten_params(flat, n_out, stoch_n, classes)
    cts = [x.to(f32).contiguous() for x in cts]
    e_proj = (embeds.float() @ params['w_obs_e'].float()).to(actions.dtype)
    fn = observe_bwd_plain if stoch0.device.type == 'cpu' else (
        observe_bwd_cuda)
    adjoints = fn(params, stoch0, deter0, actions, e_proj, is_first, deters,
                  post_logits, stochs, cts, unimix=unimix)
    grads, da, de = observe_weight_grads(
        params, stoch0, deter0, actions, embeds, is_first, deters, stochs,
        adjoints, cts[2])
    grads = [g.to(p.dtype) for g, p in zip(grads, flat)]
    ds0, dd0 = adjoints[-2:]
    return (ds0.to(stoch0.dtype), dd0.to(deter0.dtype),
            da.to(actions.dtype), de.to(embeds.dtype),
            None, None, None, None, None, None, None, *grads)


def observe_fused(params, stoch0, deter0, actions, embeds, is_first,
                  generator=None, noise=None, unimix=0.01, sample=True):
  """Differentiable fused observe chain (see the module docstring).

  Returns (deters, post_logits, prior_logits, stochs); gradients flow to
  every weight and to stoch0, deter0, actions and embeds, matching
  autograd of `observe_scan_full`. With `sample`, the Gumbel noise is
  `noise` [T,B,S*C] when given, else drawn from `generator` on the inputs'
  device; without, the stochs are the modes."""
  flat, n_out = flatten_params(params)
  if sample and noise is None:
    T, B = actions.shape[:2]
    noise = gumbel((T, B, stoch0.shape[-1]), generator, stoch0.device)
  if not sample:
    noise = None
  return ObserveFused.apply(
      stoch0, deter0, actions, embeds, is_first, noise, n_out,
      int(params['stoch_n']), int(params['classes']), float(unimix),
      bool(sample), *flat)

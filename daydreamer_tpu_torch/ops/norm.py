"""LayerNorm with its casts and the activation after it, one pass each way:
the port's counterpart of the loop fusion that XLA makes of the JAX
package's `Norm` (`daydreamer_tpu/nn/layers.py:140-160`: the upcast to
float32, the two-pass mean and variance, `rsqrt`, the affine step, the
downcast) with the ELU that follows it in a layer.

`layer_norm_act(x, scale, bias, act)` normalizes the last axis of `x`
(float32 or bfloat16, any leading shape) with eps 1e-3 in float32, applies
the float32 `scale` and `bias`, rounds to x's dtype, and applies `act`,
rounding again: `none` or `elu`, the activations the configs pair with
`norm: layer` (`configs.yaml`); any other activation, named by the layer
with its callable, is applied after the norm by that callable.

- On a CUDA tensor it launches `csrc/layer_norm.cu`: `layer_norm_act_fwd`
  (y, and each row's float32 mean and rstd) and, under autograd,
  `layer_norm_act_bwd`: the activation's gradient from the pre-activation
  recomputed from x, mean, rstd, scale and bias, rounded to x's dtype as
  autograd of the plain version rounds it, then the LayerNorm backward in
  float32; dx in x's dtype, and dscale and dbias summed over the rows in a
  fixed order, so that a graphed call equals an eager one bit for bit. The
  backward is one launch: its blocks' sums meet in clusters of up to 8
  blocks (distributed shared memory), the clusters' in the blocks that
  draw the last tickets of the counters (`_tickets`: one array a card,
  zeroed once, outside any capture, and reset by the kernel itself). A row
  wider than a block's lanes hold in registers (past 16 384 bfloat16 or
  12 288 float32 values, 4 096 where C is no multiple of a 16-byte vector)
  takes the staged forward where it measured the faster (`stage_plan`:
  rows of at least STAGE_LEAST bytes, few rows with the ELU; a block a row
  at a time, copied into shared memory once, the next rows' copies in
  flight), else the streaming forward (a block a row re-read from L1 or L2
  for each pass) and the cluster backward (`cluster_plan`): a cluster of
  CLUSTER_RANKS blocks takes a run of rows, each rank a share of every
  row's columns, so that each row is read once and kept in registers; the
  rows' sums meet through distributed shared memory, the columns' sums in
  a row of `partial` a cluster, summed through the tickets (in two levels
  where clusters take several rows). Rows too wide for that (more than
  CLUSTER_BYTES of x a lane) take the streaming backward, and so do
  launches of at least NARROW_ROWS rows of fewer than CLUSTER_LEAST bytes,
  where it measured the faster. Every C >= 1 runs.
- On a CPU tensor it runs `layer_norm_act_plain`, the same function in
  PyTorch ops (the layer's code before the kernel), and differentiates it
  by autograd.
- Inside `build.plain_versions()` (tests and `chip_smoke.py` only) it runs
  the plain version on a card too.
"""

import math

import torch
import torch.nn.functional as F

from . import build
from ..nn import cost

EPS = 1e-3
# The activations the kernel applies, and their plain versions.
ACTS = {'none': lambda x: x, 'elu': F.elu}
# Blocks of a launch at most (each launch also takes no more than the card
# holds at once): 8 and 4 for each of the H100's 132 SMs. A block walks its
# share of the rows; each cluster of the backward writes one row of
# partial sums of dscale and dbias.
FWD_BLOCKS = 1056
BWD_BLOCKS = 528
# Counters of a backward launch's tickets: one for each rank of a cluster
# (of up to 8 blocks), and in the cluster backward one for each of up to 16
# ranks and each rank of up to 23 groups of clusters (`_groups`).
TICKETS = 16 * 24
# The backward of rows past the plan: clusters of CLUSTER_RANKS blocks (16,
# past the 8 that are portable, where 8 would keep more than CLUSTER_BYTES
# of a row's x a lane) of up to CLUSTER_THREADS threads, at most
# CLUSTER_BLOCKS blocks (and no more clusters than the card holds at
# once); fewer rows than SPREAD_BLOCKS / CLUSTER_RANKS take narrower
# vectors over more lanes. Wider rows take the streaming backward, which
# launches a block for each STREAM_ROWS rows (up to BWD_BLOCKS and the rows
# of `partial`); so do launches of at least NARROW_ROWS rows of fewer than
# CLUSTER_LEAST bytes, where the streaming backward measured the faster
# (bfloat16 rows of 8-16 KB at 1 024 rows and more; the cluster backward
# at 1 and 32 rows of any width, and from 24 KB at 1 024 rows: PERF.md,
# PR 23).
CLUSTER_RANKS = 8
CLUSTER_THREADS = 256
CLUSTER_BLOCKS = 528
CLUSTER_BYTES = 32
CLUSTER_LEAST = 16384
NARROW_ROWS = 1024
SPREAD_BLOCKS = 264
STREAM_ROWS = 8

# The staged forward of rows past the plan (`stage_plan`): up to STAGES
# buffers a block, STAGE_THREADS threads a block (0: the kernel picks by
# the rows), at most STAGE_BLOCKS blocks; it takes rows of at least
# STAGE_LEAST bytes, and launches of at most STAGE_FEW rows with the ELU,
# where it measured the faster (PERF.md, `chip_smoke.py`'s wide_paths
# sweep); other rows take the streaming forward. STAGE_RED: the floats
# ahead of the buffers.
STAGES = 4
STAGE_THREADS = 0
STAGE_BLOCKS = 264
STAGE_LEAST = 40 * 1024
STAGE_FEW = 128
STAGE_RED = 64

LAYER_NORM_ACT_FWD = build.register(build.Kernel(
    'layer_norm_act_fwd', 'layer_norm.cu',
    'daydreamer_tpu/nn/layers.py:140 (Norm.__call__ and the activation '
    'after it, one loop fusion of XLA)',
    {'layer_norm_act_fwd': build.signature(),
     'layer_norm_act_bwd': build.signature()},
    headers=('hopper_ptx.cuh', 'row_cluster.cuh'),
    parts=('layer_norm_cluster.cu', 'layer_norm_staged.cu')))
LAYER_NORM_ACT_BWD = build.register(build.Kernel(
    'layer_norm_act_bwd', 'layer_norm.cu',
    'daydreamer_tpu/nn/layers.py:140 (the gradient of Norm and its '
    'activation, fused by XLA)', shares=LAYER_NORM_ACT_FWD))


def layer_norm_act_plain(x, scale, bias, act='none'):
  """The function in PyTorch ops: LayerNorm of float32(x), rounded to x's
  dtype, then `act` in that dtype."""
  y = F.layer_norm(x.float(), (x.shape[-1],), scale, bias, eps=EPS)
  return ACTS[act](y.to(x.dtype))


def _rows(x):
  return x.numel() // x.shape[-1], x.shape[-1]


def _aligned(x):
  """x as the kernel reads it: contiguous and 16-byte aligned (a view
  that starts inside its storage may not be), copied where it is not."""
  x = x.contiguous()
  return x if x.data_ptr() % 16 == 0 else x.clone()


def _check(name, x, scale, bias, act):
  if x.dtype not in (torch.float32, torch.bfloat16):
    raise TypeError(f'{name} takes float32 or bfloat16, not {x.dtype}.')
  if act not in ACTS:
    raise ValueError(f'{name}: no activation {act!r} in the kernel.')
  rows, C = _rows(x)
  build.check(name, [('scale', scale), ('bias', bias)], x.device,
              torch.float32)
  if tuple(scale.shape) != (C,) or tuple(bias.shape) != (C,):
    raise ValueError(f'{name}: scale and bias must have shape ({C},).')
  return rows, C


def lane_plan(rows, width, item, widest, most_bytes, ranks, threads,
              blocks, spread):
  """(blocks a cluster, threads a block, vector, clusters at most) of a
  cluster backward for rows of `width` values of `item` bytes, or None
  where a lane would keep more than `most_bytes` of a row (of a part):
  the widest vector of up to `widest` values that `width` is a multiple
  of; threads a multiple of 32 up to `threads`, as few as hold the row's
  vectors; `ranks` blocks a cluster, 16 where that many keep too much; a
  lane's vectors the fewest (a power of two) that hold the row. Fewer rows
  than `spread` / ranks take narrower vectors while more threads can hold
  them, so that few rows reach more lanes. The measurements behind the
  defaults are in PERF.md."""
  vec = widest
  while width % vec:
    vec //= 2

  def geometry(vec, ranks):
    nvec = width // vec
    t = min(threads, -(-nvec // (ranks * 32)) * 32)
    nv = 1
    while nv * ranks * t < nvec:
      nv *= 2
    return t, nv

  t, nv = geometry(vec, ranks)
  if nv * vec * item > most_bytes and ranks < 16:
    ranks = 16
    t, nv = geometry(vec, ranks)
  if nv * vec * item > most_bytes:
    return None
  while rows * ranks < spread and vec > 1 and 2 * t <= threads:
    vec //= 2
    t, nv = geometry(vec, ranks)
  return ranks, t, vec, min(rows, max(1, blocks // ranks))


def cluster_plan(rows, C, dtype):
  """`lane_plan` of the cluster backward for rows of C values of `dtype`
  (the kernel takes it only for rows too wide for a block's lanes): vectors
  of up to 16 bytes, at most CLUSTER_BYTES of x a lane; None for at
  least NARROW_ROWS rows of fewer than CLUSTER_LEAST bytes."""
  item = torch.tensor([], dtype=dtype).element_size()
  if rows >= NARROW_ROWS and C * item < CLUSTER_LEAST:
    return None
  return lane_plan(rows, C, item, 16 // item, CLUSTER_BYTES, CLUSTER_RANKS,
                   CLUSTER_THREADS, CLUSTER_BLOCKS, SPREAD_BLOCKS)


def stage_buffers(C, dtype):
  """The buffers a block of the staged forward takes for rows of C values
  of `dtype`: up to STAGES, as many as fit in half of
  `build.SHARED_MEMORY_LIMIT` bytes (two blocks an SM), else 2 where two
  fit in all of it, else 0 (none fit). A buffer holds the row's 16-byte
  chunks, one more where it starts off 16 bytes."""
  item = torch.tensor([], dtype=dtype).element_size()
  buffer = -(-C * item // 16) * 16 + 16
  room = build.SHARED_MEMORY_LIMIT - 4 * STAGE_RED
  stages = min(STAGES, (room // 2) // buffer)
  if stages >= 2:
    return stages
  return 2 if 2 * buffer <= room else 0


def stage_plan(rows, C, dtype, act):
  """How the forward takes rows of C values of `dtype` (the kernel reads it
  only for rows too wide for a block's lanes): `stage_buffers`' buffers,
  the staged forward, for rows of at least STAGE_LEAST bytes and for
  launches of at most STAGE_FEW rows with the ELU; else 0, the streaming
  forward, which also takes rows whose two buffers do not fit."""
  item = torch.tensor([], dtype=dtype).element_size()
  if C * item >= STAGE_LEAST or (rows <= STAGE_FEW and act == 'elu'):
    return stage_buffers(C, dtype)
  return 0


def _groups(clusters):
  """The most groups the cluster backward's clusters meet in: about
  sqrt(clusters) clusters a group (`row_cluster::group_size`)."""
  size = math.isqrt(clusters - 1) + 1 if clusters > 1 else 1
  return -(-clusters // size) if clusters > 1 else 0


def _partial_rows(rows, plan):
  """The rows of `partial` a backward launch may write: a row for each
  block of the streaming backward (a block for each STREAM_ROWS rows, up to
  BWD_BLOCKS), which also covers the clusters of 8 blocks of rows a
  block's lanes hold; and with the cluster backward's `plan`, at least a
  row a cluster and a row for each group of its clusters."""
  rows_of = min(BWD_BLOCKS, -(-rows // STREAM_ROWS))
  if plan is not None:
    rows_of = max(rows_of, plan[3] + _groups(plan[3]))
  return rows_of


def _tickets(device):
  """The backward's counters on `device` (`build.counters`)."""
  return build.counters('layer_norm_act_bwd', device, TICKETS)


def layer_norm_act_fwd_cuda(x, scale, bias, act='none'):
  """y, mean, rstd from one launch of `layer_norm_act_fwd`; x on a card.
  mean and rstd are float32, one a row."""
  name = 'layer_norm_act_fwd'
  x = _aligned(x)
  rows, C = _check(name, x, scale, bias, act)
  build.check(name, [('x', x)], x.device, x.dtype)
  y = torch.empty_like(x)
  mean = torch.empty(rows, dtype=torch.float32, device=x.device)
  rstd = torch.empty(rows, dtype=torch.float32, device=x.device)
  build.launch(LAYER_NORM_ACT_FWD, 'layer_norm_act_fwd', x.dtype,
               [x, scale, bias, y, mean, rstd],
               [rows, C, int(act == 'elu'), FWD_BLOCKS,
                stage_plan(rows, C, x.dtype, act), STAGE_THREADS,
                STAGE_BLOCKS],
               [EPS], x.device)
  return y, mean, rstd


def layer_norm_act_bwd_cuda(x, scale, bias, mean, rstd, dy, act='none'):
  """dx, dscale, dbias from one launch of `layer_norm_act_bwd`; the
  forward's x, mean and rstd."""
  name = 'layer_norm_act_bwd'
  x, dy = _aligned(x), _aligned(dy.to(x.dtype))
  rows, C = _check(name, x, scale, bias, act)
  build.check(name, [('x', x), ('dy', dy)], x.device, x.dtype)
  build.check(name, [('mean', mean), ('rstd', rstd)], x.device,
              torch.float32)
  dx = torch.empty_like(x)
  dscale = torch.empty(C, dtype=torch.float32, device=x.device)
  dbias = torch.empty(C, dtype=torch.float32, device=x.device)
  plan = cluster_plan(rows, C, x.dtype)
  # A row of partial sums a block or cluster: dscale's C columns, then
  # dbias's, each rounded up to 4 floats.
  partial = torch.empty((_partial_rows(rows, plan),
                         2 * (-(-C // 4) * 4)),
                        dtype=torch.float32, device=x.device)
  tickets = _tickets(x.device)
  build.launch(LAYER_NORM_ACT_BWD, 'layer_norm_act_bwd', x.dtype,
               [x, scale, bias, mean, rstd, dy, dx, partial, dscale, dbias,
                tickets],
               [rows, C, int(act == 'elu'), BWD_BLOCKS, partial.shape[0],
                TICKETS, *(plan or (0, 0, 0, 0))], [EPS], x.device)
  return dx, dscale, dbias


def layer_norm_act_work(rows, C, dtype, act='none', backward=False):
  """(operations, bytes) of one launch at these widths: each input read
  once, each output written once. Forward: x, scale and bias in; y, mean
  and rstd out; about 8 operations a value, 10 with the ELU. Backward: x,
  dy, scale, bias, mean and rstd in; dx, dscale and dbias out; about 16
  operations a value, 18 with the ELU. The partial sums and the counters
  are the kernel's own scratch, and no product is done (`cost.CostMode`
  counts products only, as `FlopCounterMode`, so the wrappers count no
  FLOPs)."""
  item, n = cost.itemsize(dtype), rows * C
  elu = 2 * (act == 'elu')
  if backward:
    return ((16 + elu) * n,
            3 * item * n + 4 * 2 * rows + 4 * 2 * C + 4 * 2 * C)
  return (8 + elu) * n, 2 * item * n + 4 * 2 * C + 4 * 2 * rows


class LayerNormAct(torch.autograd.Function):
  """(x, scale, bias, act) -> y. A CUDA input launches the kernels, a CPU
  input runs the plain version (its backward by autograd)."""

  @staticmethod
  def forward(ctx, x, scale, bias, act):
    rows, C = _rows(x)
    work = lambda: (0, layer_norm_act_work(rows, C, x.dtype, act)[1])
    with cost.kernel('layer_norm_act_fwd', work):
      if x.device.type == 'cpu':
        y, stats = layer_norm_act_plain(x, scale, bias, act), ()
      else:
        y, *stats = layer_norm_act_fwd_cuda(x, scale, bias, act)
    ctx.save_for_backward(x, scale, bias, *stats)
    ctx.act = act
    return y

  @staticmethod
  def backward(ctx, dy):
    x, scale, bias, *stats = ctx.saved_tensors
    rows, C = _rows(x)
    work = lambda: (0, layer_norm_act_work(
        rows, C, x.dtype, ctx.act, backward=True)[1])
    with cost.kernel('layer_norm_act_bwd', work):
      if x.device.type == 'cpu':
        with torch.enable_grad():
          inputs = [t.detach().requires_grad_() for t in (x, scale, bias)]
          y = layer_norm_act_plain(*inputs, ctx.act)
          dx, dscale, dbias = torch.autograd.grad(y, inputs, dy)
      else:
        dx, dscale, dbias = layer_norm_act_bwd_cuda(
            x, scale, bias, *stats, dy, ctx.act)
    return dx, dscale, dbias, None


def layer_norm_act(x, scale, bias, act='none', fn=None):
  """act(LayerNorm(x) * scale + bias), rounded to x's dtype after each (see
  the module docstring); differentiable in x, scale and bias. An `act` the
  kernel does not apply (not in ACTS) is `fn`, applied after the norm."""
  inner = act if act in ACTS else 'none'
  if build.plain():
    y = layer_norm_act_plain(x, scale, bias, inner)
  else:
    y = LayerNormAct.apply(x, scale, bias, inner)
  return y if inner == act else fn(y)

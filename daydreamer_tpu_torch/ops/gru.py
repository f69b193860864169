"""The RSSM's GRU cell after its product, one pass each way: the port's
counterpart of the loop fusion that XLA makes of the JAX package's
`RSSM._gru` tail (`daydreamer_tpu/models/nets.py:271-287`) inside the scan
step.

`gru_cell(x, deter, scale, bias)` takes the `gru_out` product x [..., 3 D]
(float32 or bfloat16), the previous deter [..., D] in x's dtype and the
norm's float32 scale and bias [3 D]; it normalizes x's rows with eps 1e-3
in float32, rounds to x's dtype, splits reset, cand and update, and returns
`u * c + (1 - u) * deter` with r = sigmoid(reset), c = tanh(r * cand) and
u = sigmoid(update - 1), rounding after each op as the eager chain does.
Without a norm (scale None, `norm: none`) the gates read x itself.

- On a CUDA tensor it launches `csrc/gru.cu`: `gru_cell_fwd` (the new deter,
  and each row's float32 mean and rstd; few rows spread over wider groups
  of lanes, `FWD_LANES`) and, under autograd,
  `gru_cell_bwd`: the gates' gradients rounded as autograd of the plain
  version rounds them, then the LayerNorm backward in float32, in one
  launch, with dscale and dbias summed over rows in a fixed order (a tree
  in each block, then the blocks of one cluster in rank order through
  distributed shared memory, or the rows of a cooperative grid's blocks in
  block order after a barrier, `_barrier`), so that a graphed call equals
  an eager one bit for bit. Without a norm (scale and bias None) both are
  one elementwise pass; with D past `MAX_D` the forward (`fwd_plan`)
  takes a block of up to 1 024 threads a row: a grid no larger than the
  card holds walks runs of rows, each thread the same columns of every
  row, read once and kept in registers, its scale and bias loaded once
  into shared memory; where no block holds a row, and for many rows where
  a thread would keep few values of one, a block a row streams it. The
  backward takes clusters (`cluster_plan`): a
  cluster of norm.CLUSTER_RANKS blocks takes a run of rows, each rank the
  same share of every row's columns of the three parts, of deter and dout,
  so that each row is read once and kept in registers; the rows' sums meet
  through distributed shared memory, the columns' sums in a row of
  `partial` a cluster, summed in a fixed order by the blocks that draw the
  last tickets (`_tickets`; in two levels where clusters take several
  rows). Deters too wide for that (more than CLUSTER_BYTES of a part a
  lane) take a block a row streamed in passes, its column sums summed in
  block order by a cooperative grid. Every norm setting and D >= 1 runs.
- On a CPU tensor it runs `gru_cell_plain`, the function in PyTorch ops
  (the RSSM's code before the kernel), and differentiates it by autograd.
- Inside `build.plain_versions()` (tests and `chip_smoke.py` only) it runs
  the plain version on a card too.
"""

import torch

from . import build
from . import norm
from ..nn import cost

EPS = norm.EPS
# The widest deter whose row a group of lanes holds in registers (256 lanes
# of 8 values a part); wider rows take the streaming forward and the
# cluster backward (below).
MAX_D = 2048
# The forward: at most FWD_BLOCKS blocks walking the rows; a group of at
# least a warp a row, wider where the rows take fewer than FWD_LANES lanes
# (1 and 32 rows take 8 warps a row, 1 024 rows of 256 a warp, of 512 two
# warps).
FWD_BLOCKS = 1056
FWD_LANES = 8192
# The backward: blocks of 256 threads, a group of lanes a row wide enough
# that the rows take BWD_LANES lanes where they can (32 rows of 256 take
# 128 lanes a row, 1 024 rows a warp a row). Up to CLUSTER blocks (16 is
# past the 8 that are portable) make one cluster; more make a cooperative
# grid of at most BWD_BLOCKS blocks (and no more than the card holds at
# once), each writing a row of partial column sums before a barrier
# (BARRIER counters) after which each sums a share of the columns; so does
# the streaming backward of deters too wide for the cluster backward.
BWD_BLOCKS = 128
CLUSTER = 16
BWD_LANES = 4096
BARRIER = 2
# The backward past MAX_D: `norm.lane_plan` at the LayerNorm backward's
# cluster geometry (norm.CLUSTER_RANKS, CLUSTER_THREADS, CLUSTER_BLOCKS,
# SPREAD_BLOCKS) with vectors of up to CLUSTER_VALUES values, a lane
# keeping at most CLUSTER_BYTES of each part of a row; ticket counters as
# `norm.TICKETS`.
CLUSTER_BYTES = 16
CLUSTER_VALUES = 4
TICKETS = norm.TICKETS
# The forward past MAX_D (`fwd_plan`): a block of up to FWD_THREADS
# threads a row, a thread keeping at most FWD_BYTES (up to 16) of each part
# of a row (a vector of fewer than 4 bytes counted as 4: a register), the
# most threads for launches of fewer than FWD_SPREAD rows, the fewest for
# more, at most FWD_BLOCKS blocks (and no more than the card holds at
# once). Launches of FWD_SPREAD rows and more whose threads would keep
# fewer than FWD_MANY_VALUES values of a part take the streaming forward,
# which measured the faster there (PERF.md, `chip_smoke.py`'s wide_paths
# sweep), as do rows no block holds; FWD_BYTES 0 sends every such row
# there. A block of at most FWD_BOUND threads that keep one 16-byte vector
# of a part takes the kernel built for that launch bound (csrc/gru.cu's
# FWD_TIGHT: up to 96 registers a thread, no spill), every other block the
# kernel built for FWD_THREADS (64), where the sweep measured each the
# faster; FWD_BOUND 0 sends every block to the latter.
FWD_THREADS = 1024
FWD_BYTES = 16
FWD_SPREAD = 264
FWD_MANY_VALUES = 8
FWD_BOUND = 640

GRU_CELL_FWD = build.register(build.Kernel(
    'gru_cell_fwd', 'gru.cu',
    'daydreamer_tpu/models/nets.py:271 (RSSM._gru after the gru_out '
    'product: its Norm and gates, one loop fusion of XLA)',
    {'gru_cell_fwd': build.signature(), 'gru_cell_bwd': build.signature()},
    headers=('hopper_ptx.cuh', 'row_cluster.cuh'),
    parts=('gru_cluster.cu', 'gru_block_fwd.cu')))
GRU_CELL_BWD = build.register(build.Kernel(
    'gru_cell_bwd', 'gru.cu',
    'daydreamer_tpu/models/nets.py:271 (the gradient of RSSM._gru after '
    'its product, fused by XLA)', shares=GRU_CELL_FWD))


def gru_cell_plain(x, deter, scale=None, bias=None):
  """The function in PyTorch ops (`RSSM._gru` after its product)."""
  if scale is not None:
    x = norm.layer_norm_act_plain(x, scale, bias)
  reset, cand, update = torch.chunk(x, 3, -1)
  reset = torch.sigmoid(reset)
  cand = torch.tanh(reset * cand)
  update = torch.sigmoid(update - 1)
  return update * cand + (1 - update) * deter


def _check(name, x, deter, scale, bias):
  if x.dtype not in (torch.float32, torch.bfloat16):
    raise TypeError(f'{name} takes float32 or bfloat16, not {x.dtype}.')
  D = x.shape[-1] // 3
  rows = x.numel() // x.shape[-1]
  if x.shape[-1] != 3 * D or tuple(deter.shape) != tuple(x.shape[:-1]) + (D,):
    raise ValueError(f'{name}: x {tuple(x.shape)} is not [..., 3 D] beside '
                     f'deter {tuple(deter.shape)}.')
  if (scale is None) != (bias is None):
    raise ValueError(f'{name}: scale and bias are both given or both None.')
  if scale is not None:
    build.check(name, [('scale', scale), ('bias', bias)], x.device,
                torch.float32)
    if tuple(scale.shape) != (3 * D,) or tuple(bias.shape) != (3 * D,):
      raise ValueError(f'{name}: scale and bias must have shape ({3 * D},).')
  return rows, D


def cluster_plan(rows, D, dtype):
  """`norm.lane_plan` of the cluster backward for rows of a deter of D
  values of `dtype` past MAX_D (else None): vectors of up to
  CLUSTER_VALUES values (the cell's gradient holds many values a column in
  registers), at most CLUSTER_BYTES of a part a lane."""
  item = torch.tensor([], dtype=dtype).element_size()
  if D <= MAX_D:
    return None
  return norm.lane_plan(rows, D, item, min(16 // item, CLUSTER_VALUES),
                        CLUSTER_BYTES, norm.CLUSTER_RANKS,
                        norm.CLUSTER_THREADS, norm.CLUSTER_BLOCKS,
                        norm.SPREAD_BLOCKS)


def fwd_plan(rows, D, dtype):
  """(threads a block, vector) of the block forward for rows of a deter of
  D values of `dtype` past MAX_D, else None: D up to MAX_D,
  and where the streaming forward (gru_wide_fwd_kernel) takes the rows.
  A thread keeps the same vectors of up to 16 bytes (a power of two of
  values that D is a multiple of), a power of two of them, at most
  FWD_BYTES of a part (its vectors counted at 4 bytes at least, a register
  each); threads a multiple of 32 up to FWD_THREADS, for fewer than
  FWD_SPREAD rows the most (the widest vector among equals), else the
  fewest, and then only where a thread keeps FWD_MANY_VALUES values of a
  part. The block keeps its threads' scale and bias in shared memory: 24
  bytes a column, within `build.SHARED_MEMORY_LIMIT`."""
  item = torch.tensor([], dtype=dtype).element_size()
  if D <= MAX_D:
    return None
  few = rows < FWD_SPREAD
  plans = []
  vec = 16 // item
  while vec >= 1:
    nv = 1
    while D % vec == 0 and nv * max(vec * item, 4) <= FWD_BYTES:
      threads = -(-D // (vec * nv * 32)) * 32
      if (threads <= FWD_THREADS
          and 24 * nv * vec * threads + 1024 <= build.SHARED_MEMORY_LIMIT):
        plans.append((threads, vec, nv))
      nv *= 2
    vec //= 2
  if not plans:
    return None
  threads, vec, nv = max(plans, key=lambda t: (t[0] if few else -t[0], t[1]))
  if not few and nv * vec < FWD_MANY_VALUES:
    return None
  return threads, vec


def gru_cell_fwd_cuda(x, deter, scale, bias):
  """out, mean, rstd from one launch of `gru_cell_fwd`; x on a card. mean
  and rstd are None without a norm."""
  name = 'gru_cell_fwd'
  x, deter = norm._aligned(x), norm._aligned(deter.to(x.dtype))
  rows, D = _check(name, x, deter, scale, bias)
  build.check(name, [('x', x), ('deter', deter)], x.device, x.dtype)
  out = torch.empty_like(deter)
  mean = rstd = None
  if scale is not None:
    mean = torch.empty(rows, dtype=torch.float32, device=x.device)
    rstd = torch.empty(rows, dtype=torch.float32, device=x.device)
  plan = fwd_plan(rows, D, x.dtype) if scale is not None else None
  if plan is not None:
    threads, vec = plan
    tight = threads <= FWD_BOUND and vec * x.element_size() == 16
    plan = (threads, vec, FWD_BOUND if tight else FWD_THREADS)
  build.launch(GRU_CELL_FWD, 'gru_cell_fwd', x.dtype,
               [x, deter, scale, bias, out, mean, rstd],
               [rows, D, FWD_BLOCKS, FWD_LANES, int(scale is not None),
                *(plan or (0, 0, 0))], [EPS], x.device)
  return out, mean, rstd


def gru_cell_bwd_cuda(x, deter, scale, bias, mean, rstd, dout):
  """dx, ddeter, dscale, dbias from one launch of `gru_cell_bwd` (dscale
  and dbias None without a norm)."""
  name = 'gru_cell_bwd'
  x, deter = norm._aligned(x), norm._aligned(deter.to(x.dtype))
  dout = norm._aligned(dout.to(x.dtype))
  rows, D = _check(name, x, deter, scale, bias)
  build.check(name, [('x', x), ('deter', deter), ('dout', dout)], x.device,
              x.dtype)
  dx, ddeter = torch.empty_like(x), torch.empty_like(deter)
  dscale = dbias = partial = barrier = tickets = plan = None
  partial_rows = 0
  if scale is not None:
    build.check(name, [('mean', mean), ('rstd', rstd)], x.device,
                torch.float32)
    dscale = torch.empty(3 * D, dtype=torch.float32, device=x.device)
    dbias = torch.empty(3 * D, dtype=torch.float32, device=x.device)
    plan = cluster_plan(rows, D, x.dtype)
    # A row of partial sums a cluster of the cluster backward, else a
    # block of a cooperative grid (no more blocks than rows): dscale's 3 D
    # columns, then dbias's.
    partial_rows = _partial_rows(rows, plan)
    partial = torch.empty((partial_rows, 6 * D), dtype=torch.float32,
                          device=x.device)
    barrier, tickets = _barrier(x.device), _tickets(x.device)
  build.launch(GRU_CELL_BWD, 'gru_cell_bwd', x.dtype,
               [x, deter, scale, bias, mean, rstd, dout, dx, partial, dscale,
                dbias, ddeter, barrier, tickets],
               [rows, D, BWD_BLOCKS, partial_rows, CLUSTER, BWD_LANES,
                BARRIER, int(scale is not None), *(plan or (0, 0, 0, 0)),
                TICKETS], [EPS], x.device)
  return dx, ddeter, dscale, dbias


def _partial_rows(rows, plan):
  """The rows of `partial` a backward launch writes at most: a row a
  cluster of the cluster backward's `plan` and a row for each group of its
  clusters, else a row a block of a cooperative grid."""
  if plan is not None:
    return plan[3] + norm._groups(plan[3])
  return min(BWD_BLOCKS, rows)


def _tickets(device):
  """The cluster backward's counters on `device` (`build.counters`): a
  rank's, and a rank's in each group of clusters, each back at zero after
  each launch."""
  return build.counters('gru_cell_bwd_tickets', device, TICKETS)


def _barrier(device):
  """The backward's grid barrier on `device` (`build.counters`): a count of
  arrivals, back at zero after each barrier, and a generation."""
  return build.counters('gru_cell_bwd', device, BARRIER)


def gru_cell_work(rows, D, dtype, backward=False, normed=True):
  """(operations, bytes) of one call at these widths: each input read once,
  each output written once. Forward: x [rows, 3 D], deter, scale and bias
  in; the new deter, mean and rstd out; about 8 operations a normalized
  value and 24 an output value (two sigmoids, a tanh, five products and
  sums). Backward: x, deter, the new deter's gradient, mean, rstd, scale
  and bias in; dx, ddeter, dscale and dbias out; about 16 operations a
  normalized value and 40 an output value. Without a norm (`normed` False)
  there is no scale, bias, mean, rstd, dscale or dbias, and no operation
  of the norm. The partial sums are the kernel's own scratch, and no
  product is done (`cost.CostMode` counts products only, so the wrappers
  count no FLOPs)."""
  item = cost.itemsize(dtype)
  params = 4 * 2 * 3 * D * normed
  stats = 8 * normed
  if backward:
    return (rows * (16 * 3 * D * normed + 40 * D),
            rows * (item * (3 * D + 3 * D + 3 * D) + stats) + 2 * params)
  return (rows * (8 * 3 * D * normed + 24 * D),
          rows * (item * (3 * D + 2 * D) + stats) + params)


class GRUCell(torch.autograd.Function):
  """(x, deter, scale, bias) -> the new deter; scale and bias may be None
  (`norm: none`). A CUDA input launches the kernels, a CPU input runs the
  plain version (its backward by autograd)."""

  @staticmethod
  def forward(ctx, x, deter, scale, bias):
    rows, D = x.numel() // x.shape[-1], x.shape[-1] // 3
    has_norm = scale is not None
    work = lambda: (0, gru_cell_work(rows, D, x.dtype, normed=has_norm)[1])
    with cost.kernel('gru_cell_fwd', work):
      if x.device.type == 'cpu':
        out, stats = gru_cell_plain(x, deter, scale, bias), ()
      else:
        out, *stats = gru_cell_fwd_cuda(x, deter, scale, bias)
    ctx.save_for_backward(x, deter, scale, bias, *stats)
    return out

  @staticmethod
  def backward(ctx, dout):
    x, deter, scale, bias, *stats = ctx.saved_tensors
    rows, D = x.numel() // x.shape[-1], x.shape[-1] // 3
    has_norm = scale is not None
    work = lambda: (0, gru_cell_work(rows, D, x.dtype, backward=True,
                                     normed=has_norm)[1])
    with cost.kernel('gru_cell_bwd', work):
      if x.device.type == 'cpu':
        with torch.enable_grad():
          inputs = [t if t is None else t.detach().requires_grad_()
                    for t in (x, deter, scale, bias)]
          out = gru_cell_plain(*inputs)
          grads = iter(torch.autograd.grad(
              out, [t for t in inputs if t is not None], dout))
          return tuple(t if t is None else next(grads) for t in inputs)
      dx, ddeter, dscale, dbias = gru_cell_bwd_cuda(
          x, deter, scale, bias, *stats, dout)
    return dx, ddeter, dscale, dbias


def gru_cell(x, deter, scale=None, bias=None):
  """The new deter from the `gru_out` product x, the previous deter and the
  norm's scale and bias, None for `norm: none` (see the module docstring);
  differentiable in all four."""
  if build.plain():
    return gru_cell_plain(x, deter, scale, bias)
  return GRUCell.apply(x, deter, scale, bias)

"""The λ-return backward recursion as a kernel, the port of `gve_pallas`
(`scripts/pallas_proof.py` of the JAX package, kernel `_gve_kernel`).

    ret[t] = interm[t] + disc[t] * lam * ret[t + 1],   ret[H] = bootstrap

walked backwards over the H steps, every lane independent. `gve` launches
the Triton kernel on a CUDA tensor and runs `gve_plain`, the same loop in
PyTorch (what the JAX package's `lambda_returns.gve_scan` computes), on a
CPU tensor. The agent computes its λ-returns inside its own loss, as the
JAX package does with the scan; only the proof entry point calls `gve`.

Bound: 2 * H * n float32 values read, n read, H * n written, one
multiply-add per value: bytes bound it (0.11 us for H = 15, n = 2048 at 3.35
TB/s is far below a launch's own cost, so at these sizes the kernel's time
is its launch). Design: one program per block of lanes keeps the carry in
registers and walks t backwards, so each value crosses memory once; there
is nothing else to fuse or to tile.
"""

import torch

from . import build
from ..nn import cost

f32 = torch.float32
BLOCK = 128  # Lanes per program.


GVE = build.register(build.TritonKernel(
    'gve', 'lambda_returns.py',
    'scripts/pallas_proof.py:47 (_gve_kernel)'))

_jitted = None


def _gve_kernel():
  """The Triton kernel, made on first use: `triton` is imported here, as
  globals of this module where the kernel's body looks its names up, so
  that the module imports where there is no card."""
  global triton, tl, _jitted
  if _jitted is None:
    import triton
    import triton.language as tl

    @triton.jit
    def gve_kernel(interm_ptr, disc_ptr, boot_ptr, out_ptr, n, lam,
                   HORIZON: tl.constexpr, LANES: tl.constexpr):
      lanes = tl.program_id(0) * LANES + tl.arange(0, LANES)
      mask = lanes < n
      carry = tl.load(boot_ptr + lanes, mask=mask, other=0.0)
      for i in range(HORIZON):
        offset = (HORIZON - 1 - i) * n + lanes
        interm = tl.load(interm_ptr + offset, mask=mask, other=0.0)
        disc = tl.load(disc_ptr + offset, mask=mask, other=0.0)
        carry = interm + disc * lam * carry
        tl.store(out_ptr + offset, carry, mask=mask)

    _jitted = gve_kernel
  return _jitted


def gve_plain(interm, disc, bootstrap, lam):
  """The recursion as a loop in PyTorch. interm, disc: [H, ...];
  bootstrap: [...]. Returns [H, ...]."""
  carry = bootstrap
  values = []
  for t in reversed(range(interm.shape[0])):
    carry = interm[t] + disc[t] * lam * carry
    values.append(carry)
  return torch.stack(values[::-1], 0)


def gve_triton(interm, disc, bootstrap, lam):
  """The recursion as one launch of the Triton kernel; same contract as
  `gve_plain` for float32 CUDA tensors."""
  for key, x in (('interm', interm), ('disc', disc), ('bootstrap', bootstrap)):
    if x.device.type != 'cuda' or x.device != interm.device:
      raise ValueError(f'gve_triton: {key} lies on {x.device}.')
    if x.dtype != f32:
      raise TypeError(f'gve_triton: {key} is {x.dtype}, not float32.')
  if (interm.shape != disc.shape or interm.shape[1:] != bootstrap.shape
      or interm.shape[0] < 1):
    raise ValueError('gve_triton: inconsistent shapes.')
  horizon = interm.shape[0]
  interm, disc, bootstrap = (
      x.contiguous() for x in (interm, disc, bootstrap))
  n = bootstrap.numel()
  out = torch.empty_like(interm)
  kernel = _gve_kernel()
  with torch.cuda.device(interm.device):
    kernel[((n + BLOCK - 1) // BLOCK,)](
        interm, disc, bootstrap, out, n, float(lam), HORIZON=horizon,
        LANES=BLOCK, num_warps=4)
  build.count(GVE)
  return out


def gve_work(H, n):
  """(flops, bytes) of one launch over H steps of n float32 lanes: a
  multiply-add a value; interm and disc read, the bootstrap read, the
  returns written."""
  return 2.0 * H * n, 4 * (3 * H * n + n)


def gve(interm, disc, bootstrap, lam):
  """ret[t] = interm[t] + disc[t] * lam * ret[t + 1], ret[H] = bootstrap.
  A CUDA input launches the Triton kernel, a CPU input runs the loop."""
  fn = gve_plain if interm.device.type == 'cpu' else gve_triton
  with cost.kernel('gve', lambda: gve_work(interm.shape[0],
                                           bootstrap.numel())):
    return fn(interm, disc, bootstrap, lam)

"""Run the observe kernels' CUDA sources on the CPU, without nvcc or a card.

    python -m daydreamer_tpu_torch.ops.emulate

compiles `csrc/observe_fwd.cu` and `csrc/observe_bwd.cu` with g++ against
the stand-in headers of `csrc/emulate/` (one OS thread per CUDA thread, see
`emulate.h`), calls them through the real wrappers of `rssm_vjp.py` on CPU
tensors at tiny widths, and holds each against its plain version in float32
and bfloat16. It checks a kernel's indices, layouts and formulas before a
card is at hand; it does not replace the check on the card (`chip_smoke.py`)
and says nothing about speed. Exit code 0: agreed; 1: disagreed; 75: cannot
run here (no g++ with C++20).
"""

import argparse
import contextlib
import ctypes
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

from . import build
from . import rssm_vjp

SHIM = build.CSRC / 'emulate'
CANNOT_RUN = 75
_SHARED = re.compile(r'extern __shared__ __align__\(16\) float (\w+)\[\];')
_LAUNCH = re.compile(r'(\w+<T>)<<<(.*?)>>>\((.*?)\);')


class Unavailable(RuntimeError):
  """There is no compiler here that can build the emulation."""


def compile_kernel(kernel, outdir):
  """g++ the kernel's source, with its launch and its shared memory handed
  to the stand-in, into a shared library; returns the loaded library."""
  compiler = shutil.which('g++')
  if compiler is None:
    raise Unavailable('g++ not found.')
  text = kernel.source.read_text()
  text, shared = _SHARED.subn(r'float* \1 = emu::smem;', text)
  text, launches = _LAUNCH.subn(r'emu::launch(\1, \2, \3);', text)
  if not (shared and launches):
    raise ValueError(f'{kernel.source.name}: no launch or no dynamic shared '
                     'memory found to hand to the emulation.')
  outdir = pathlib.Path(outdir)
  source = outdir / f'{kernel.name}.cpp'
  library = outdir / f'lib{kernel.name}_emulated.so'
  source.write_text(text)
  done = subprocess.run(
      [compiler, '-std=c++20', '-O1', '-shared', '-fPIC', '-pthread',
       '-Wno-unknown-pragmas', f'-I{SHIM}', f'-I{build.CSRC}', '-o',
       str(library), str(source)], capture_output=True, text=True)
  if done.returncode != 0:
    if '<barrier>' in done.stderr or 'c++20' in done.stderr:
      raise Unavailable(done.stderr)
    raise RuntimeError(f'g++ failed:\n{done.stderr}')
  lib = ctypes.CDLL(str(library))
  for fn, (restype, argtypes) in kernel.signature.items():
    getattr(lib, fn).restype = restype
    getattr(lib, fn).argtypes = argtypes
  return lib


@contextlib.contextmanager
def emulated(outdir):
  """Within the block, `observe_fwd_cuda` and `observe_bwd_cuda` take CPU
  tensors and run the emulated kernels (every other check stays)."""
  libs = {}
  for kernel in (rssm_vjp.OBSERVE_FWD, rssm_vjp.OBSERVE_BWD):
    libs.update(dict.fromkeys(kernel.signature, compile_kernel(
        kernel, outdir)))

  def check(name, tensors, device, dtype):
    for key, x in tensors:
      if x.dtype != dtype or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f'{name}: {key} is not what the kernel reads.')

  def launch(kernel, fn, dtype, ptrs, dims, unimix, device):
    ptr_array = (ctypes.c_void_p * len(ptrs))(
        *[x.data_ptr() if x is not None else 0 for x in ptrs])
    err = getattr(libs[fn], fn)(
        int(dtype == torch.bfloat16), ptr_array,
        (ctypes.c_int * len(dims))(*dims), float(unimix), None)
    if err != 0:
      raise RuntimeError(f'{fn} (emulated) failed: {err}.')

  saved = rssm_vjp._check, rssm_vjp._launch
  rssm_vjp._check, rssm_vjp._launch = check, launch
  try:
    yield
  finally:
    rssm_vjp._check, rssm_vjp._launch = saved


def make_inputs(dtype, D=32, U=32, S=4, C=8, A=5, E=16, B=3, T=3, n_out=2,
                seed=0):
  """Random weights and one chunk, from a seed. stoch0 is NOT one-hot (the
  kernels take any value there); B = 3 leaves a block half empty."""
  rng = np.random.default_rng(seed)
  SC = S * C
  t = lambda x: torch.as_tensor(np.asarray(x, np.float32)).to(dtype)
  w = lambda k, n: t(rng.uniform(-1, 1, (k, n)) * np.sqrt(6.0 / (k + n)))
  scale = lambda n: t(1 + 0.1 * rng.standard_normal(n))
  bias = lambda n: t(0.1 * rng.standard_normal(n))
  params = dict(
      stoch_n=S, classes=C, w_in_s=w(SC, U), w_in_a=w(A, U),
      ln_in_scale=scale(U), ln_in_bias=bias(U), w_gru_d=w(D, 3 * D),
      w_gru_x=w(U, 3 * D), ln_gru_scale=scale(3 * D),
      ln_gru_bias=bias(3 * D),
      w_out=[w(D if i == 0 else U, U) for i in range(n_out)],
      ln_out_scale=[scale(U) for _ in range(n_out)],
      ln_out_bias=[bias(U) for _ in range(n_out)],
      w_st=w(U, SC), b_st=bias(SC), w_obs_d=w(D, U), w_obs_e=w(E, U),
      ln_obs_scale=scale(U), ln_obs_bias=bias(U), w_post=w(U, SC),
      b_post=bias(SC))
  onehot = np.eye(C)[rng.integers(0, C, (B, S))].reshape(B, SC)
  data = (t(0.7 * onehot + 0.05), t(np.tanh(rng.standard_normal((B, D)))),
          t(rng.standard_normal((T, B, A))),
          t(rng.standard_normal((T, B, E))))
  first = np.zeros((T, B), bool)
  first[0, 0] = first[T - 1, 1] = True
  noise = torch.as_tensor(rng.gumbel(size=(T, B, SC)).astype(np.float32))
  cts = [torch.as_tensor(rng.standard_normal((T, B, n)).astype(np.float32))
         for n in (D, SC, SC, SC)]
  return params, data, torch.as_tensor(first), noise, cts


def compare(dtype, sample=True, unimix=0.01, **shape):
  """Both emulated kernels against their plain versions on one set of
  inputs (call inside `emulated`). Returns (stochs equal, the largest
  forward error, the largest backward error scaled by each tensor's
  maximum)."""
  params, data, first, noise, cts = make_inputs(dtype, **shape)
  kw = dict(noise=noise, unimix=unimix, sample=sample)
  out = rssm_vjp.observe_fwd_cuda(params, *data, first, **kw)
  ref = rssm_vjp.observe_fwd_plain(params, *data, first, **kw)
  equal = bool((out[3] == ref[3]).all())
  fwd_err = max(float((a.float() - b.float()).abs().max())
                for a, b in zip(out[:3], ref[:3]))
  stoch0, deter0, actions, embeds = data
  e_proj = (embeds.float() @ params['w_obs_e'].float()).to(dtype)
  args = (params, stoch0, deter0, actions, e_proj, first, ref[0], ref[1],
          ref[3], cts)
  got = rssm_vjp.observe_bwd_cuda(*args, unimix=unimix)
  want = rssm_vjp.observe_bwd_plain(*args, unimix=unimix)
  bwd_err = 0.0
  for g, w in zip(got, want):
    for gi, wi in (zip(g, w) if isinstance(g, list) else [(g, w)]):
      if not torch.isfinite(gi).all():
        return equal, fwd_err, float('inf')
      scale = max(1e-6, float(wi.abs().max()))
      bwd_err = max(bwd_err, float((gi - wi).abs().max()) / scale)
  return equal, fwd_err, bwd_err


# The default widths; no noise, no unimix, one prior layer; bfloat16; widths
# that are no power of two, five rows; widths that take two passes of the
# product (3 * D and S * C above 512).
CASES = (
    (torch.float32, {}),
    (torch.float32, dict(sample=False, unimix=0.0, B=2, T=2, n_out=1)),
    (torch.bfloat16, {}),
    (torch.float32, dict(D=24, U=40, S=4, C=4, A=3, E=10, B=5, T=3,
                         n_out=3)),
    (torch.bfloat16, dict(D=176, U=64, S=36, C=16, A=6, E=24, B=2, T=2)),
)


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--out', default=None, help='Build directory.')
  args = parser.parse_args(argv)
  torch.set_num_threads(1)
  with contextlib.ExitStack() as stack:
    outdir = args.out or stack.enter_context(tempfile.TemporaryDirectory())
    try:
      stack.enter_context(emulated(outdir))
    except Unavailable as e:
      print(f'emulate: cannot run here: {e}', file=sys.stderr)
      return CANNOT_RUN
    ok = True
    for dtype, case in CASES:
      equal, fwd_err, bwd_err = compare(dtype, **case)
      # float32 arithmetic on both sides, summed in another order.
      good = equal and fwd_err <= 1e-4 and bwd_err <= 1e-4
      ok = ok and good
      print(f'{dtype} {case}: stochs equal {equal}, forward error '
            f'{fwd_err:.3g}, scaled backward error {bwd_err:.3g} '
            f'(tolerance 1e-4): {"ok" if good else "DISAGREES"}', flush=True)
  return 0 if ok else 1


if __name__ == '__main__':
  sys.exit(main())

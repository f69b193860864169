"""Run the kernels' CUDA sources on the CPU, without nvcc or a card.

    python -m daydreamer_tpu_torch.ops.emulate [--out DIR] [--case NAME]...

compiles every source of `csrc/` (`observe_fwd.cu`, `observe_bwd.cu`,
`imagine_actor.cu`, `imagine.cu`, `observe.cu`, `layer_norm.cu`,
`adam.cu`, `gru.cu`, `onehot.cu`) with g++ against the
stand-in headers of `csrc/emulate/` (one fiber per CUDA thread, the
blocks of a cluster or of a cooperative grid side by side, see
`emulate.h`; `cp.async`, `ldmatrix`,
`mma.sync` and the cluster's barrier and shared memory as `ptx.h` stands in
for them), calls them through the real wrappers of `rssm_vjp.py`,
`rssm.py`, `norm.py`, `adam.py`, `gru.py` and `onehot.py` on CPU tensors
at tiny widths, and holds each against its plain
version in float32 and bfloat16, one case after another (`--case` picks
cases by name and builds and loads only the sources they run, `SOURCES`;
`--list` names them). The libraries go to `--out` (made if
missing; without it, a temporary directory), named by the contents of the
source, its headers and the stand-ins, so that a library already there is
loaded and not built again; `--build-only` builds them and stops. It checks a
kernel's indices, layouts and formulas before a card is at hand; it does
not replace the check on the card (`chip_smoke.py`), cannot be relied on
for a missing barrier or a race between the ranks of a cluster, and says
nothing about speed. Exit code 0: agreed; 1: disagreed; 75: cannot run here
(no g++ with C++20).
"""

import argparse
import concurrent.futures
import contextlib
import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import torch

from . import adam
from . import build
from . import gru
from . import norm
from . import onehot
from . import rssm
from . import rssm_vjp

SHIM = build.CSRC / 'emulate'
CANNOT_RUN = 75
_SHARED = re.compile(r'extern __shared__ __align__\(16\) float (\w+)\[\];')
_LAUNCH = re.compile(r'(\w+)(<[\w, ]+>)?<<<(.*?)>>>\((.*?)\);')
# A kernel's definition: its cluster size, where it has one, and its name.
_KERNEL = re.compile(r'__global__\s+void\s+'
                     r'(?:__cluster_dims__\((\w+)[^)]*\)\s+)?'
                     r'(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(')


class Unavailable(RuntimeError):
  """There is no compiler here that can build the emulation."""


def _gxx(args):
  """Runs g++ with the emulation's flags; raises Unavailable where there is
  no g++ or it lacks C++20."""
  compiler = shutil.which('g++')
  if compiler is None:
    raise Unavailable('g++ not found.')
  done = subprocess.run(
      [compiler, '-std=c++20', '-O1', '-shared', '-fPIC', '-pthread',
       '-Wno-unknown-pragmas', f'-I{SHIM}', f'-I{build.CSRC}', *args],
      capture_output=True, text=True)
  if done.returncode != 0:
    if '<barrier>' in done.stderr or 'c++20' in done.stderr:
      raise Unavailable(done.stderr)
    raise RuntimeError(f'g++ failed:\n{done.stderr}')


def _shim_digest():
  """A hash of the stand-in headers, which every emulated library
  includes."""
  digest = hashlib.sha256()
  for path in sorted(SHIM.iterdir()):
    digest.update(path.read_bytes())
  return digest.hexdigest()[:12]


def compile_kernel(kernel, outdir):
  """g++ the kernel's source and its parts, with their launches and their
  shared memory handed to the stand-in, into a shared library in
  `outdir`, unless one for the same sources, headers and stand-ins is
  there; returns the loaded library. The rewritten sources keep their
  names in a directory of their own, searched first, so that a part that
  includes the source includes the rewritten one."""
  outdir = pathlib.Path(outdir)
  library = outdir / f'lib{kernel.name}_{kernel.digest()}_{_shim_digest()}.so'
  if not library.exists():
    texts = {path.name: _SHARED.sub(r'float* \1 = emu::smem;',
                                    path.read_text())
             for path in [kernel.source, *kernel.parts]}
    # Each launch takes its kernel's cluster size, whose blocks run side by
    # side (a launch through cudaLaunchKernelEx names its own).
    clusters = {name: size or '1' for text in texts.values()
                for size, name in _KERNEL.findall(text)}
    texts = {name: _LAUNCH.subn(
        lambda m: f'emu::launch({clusters.get(m[1], "1")}, '
                  f'{m[1]}{m[2] or ""}, {m[3]}, {m[4]});', text)
             for name, text in texts.items()}
    if not texts[kernel.source.name][1]:
      raise ValueError(f'{kernel.source.name}: no launch found to hand to '
                       'the emulation.')
    rewritten = library.with_suffix(f'.{os.getpid()}.src')
    rewritten.mkdir(exist_ok=True)
    sources = []
    for name, (text, _) in texts.items():
      source = rewritten / name
      source.write_text(text)
      sources.append(str(source))
    tmp = library.with_suffix(f'.{os.getpid()}.tmp')
    _gxx([f'-I{rewritten}', '-x', 'c++', '-o', str(tmp), *sources])
    os.replace(tmp, library)
  lib = ctypes.CDLL(str(library))
  for fn, (restype, argtypes) in kernel.signature.items():
    getattr(lib, fn).restype = restype
    getattr(lib, fn).argtypes = argtypes
  return lib


def compile_selftest(outdir):
  """The library of `csrc/emulate/ptx_selftest.cpp`: `mma_fragments(a, b,
  d)` and `mma_ldmatrix(w, x, d)` run the stand-ins of the tensor-core
  operations on bfloat16 bit patterns and write a float [16][8]."""
  library = pathlib.Path(outdir) / 'libptx_selftest.so'
  _gxx(['-o', str(library), str(SHIM / 'ptx_selftest.cpp')])
  lib = ctypes.CDLL(str(library))
  for fn in (lib.mma_fragments, lib.mma_ldmatrix):
    fn.restype = None
    fn.argtypes = [ctypes.c_void_p] * 3
  return lib


# The sources each kind of case runs (a kernel that shares another's source
# by that one).
SOURCES = {
    'chain': (rssm_vjp.OBSERVE_FWD, rssm_vjp.OBSERVE_BWD),
    'rollout': (rssm.IMAGINE_ACTOR, rssm.IMAGINE, rssm.OBSERVE),
    'observe': (rssm.OBSERVE,),
    'layer_norm': (norm.LAYER_NORM_ACT_FWD,),
    'layer_norm_grid': (norm.LAYER_NORM_ACT_FWD,),
    'adam': (adam.ADAM_SUMSQ,),
    'gru': (gru.GRU_CELL_FWD,),
    'onehot': (onehot.ONEHOT_HEAD_FWD,),
}


def sources(names):
  """The kernels whose sources the cases `names` run, each once."""
  return tuple(dict.fromkeys(k for name in names
                             for k in SOURCES[NAMES[name][0]]))


@contextlib.contextmanager
def emulated(outdir, kernels=None):
  """Within the block, the CUDA wrappers of `rssm_vjp.py`, `rssm.py`,
  `norm.py`, `adam.py`, `gru.py` and `onehot.py` take CPU tensors and run
  the emulated kernels (every other check stays): those of `kernels`, by
  default every source. The sources compile side by side."""
  if kernels is None:
    kernels = tuple(dict.fromkeys(k for ks in SOURCES.values() for k in ks))
  pathlib.Path(outdir).mkdir(parents=True, exist_ok=True)
  with concurrent.futures.ThreadPoolExecutor(len(kernels)) as pool:
    compiled = list(pool.map(lambda k: compile_kernel(k, outdir), kernels))
  libs = {fn: lib for kernel, lib in zip(kernels, compiled)
          for fn in kernel.signature}

  def check(name, tensors, device, dtype, align=16):
    for key, x in tensors:
      if x.dtype != dtype or not x.is_contiguous() or x.data_ptr() % align:
        raise ValueError(f'{name}: {key} is not what the kernel reads.')

  def launch(kernel, fn, dtype, ptrs, dims, scalars, device):
    ptr_array = (ctypes.c_void_p * len(ptrs))(
        *[x.data_ptr() if x is not None else 0 for x in ptrs])
    err = getattr(libs[fn], fn)(
        int(dtype == torch.bfloat16), ptr_array,
        (ctypes.c_int * len(dims))(*dims), *[float(x) for x in scalars],
        None)
    if err != 0:
      raise RuntimeError(f'{fn} (emulated) failed: {err}.')

  saved = build.check, build.launch
  build.check, build.launch = check, launch
  try:
    yield
  finally:
    build.check, build.launch = saved


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
      w_st=w(rssm.head_in(D, U, n_out), SC), b_st=bias(SC),
      w_obs_d=w(D, U), w_obs_e=w(E, U),
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


@contextlib.contextmanager
def shared_limit(limit):
  """Within the block the wrappers take the card's shared memory a block
  to be `limit` bytes (None: as it is), so that widths this small take the
  paths of widths past it."""
  saved = build.SHARED_MEMORY_LIMIT
  build.SHARED_MEMORY_LIMIT = limit or saved
  try:
    yield
  finally:
    build.SHARED_MEMORY_LIMIT = saved


def compare(dtype, sample=True, unimix=0.01, shared=None, **shape):
  """Both emulated kernels against their plain versions on one set of
  inputs (call inside `emulated`), the card's shared memory taken to be
  `shared` bytes where given. Returns (stochs equal, the largest forward
  error, the largest backward error scaled by each tensor's maximum)."""
  params, data, first, noise, cts = make_inputs(dtype, **shape)
  kw = dict(noise=noise, unimix=unimix, sample=sample)
  with shared_limit(shared):
    out = rssm_vjp.observe_fwd_cuda(params, *data, first, **kw)
  ref = rssm_vjp.observe_fwd_plain(params, *data, first, **kw)
  equal = bool((out[3] == ref[3]).all())
  fwd_err = max(_error(a, b) for a, b in zip(out[:3], ref[:3]))
  stoch0, deter0, actions, embeds = data
  e_proj = (embeds.float() @ params['w_obs_e'].float()).to(dtype)
  args = (params, stoch0, deter0, actions, e_proj, first, ref[0], ref[1],
          ref[3], cts)
  with shared_limit(shared):
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


def _error(a, b):
  """The largest |a - b|; infinite where either holds a NaN or an
  infinity, which max() would otherwise pass over."""
  diff = (a.float() - b.float()).abs()
  return float(diff.max()) if bool(torch.isfinite(diff).all()) else (
      float('inf'))


def _forward_errors(out, ref):
  """(one-hots equal, the largest error of the other outputs); the
  one-hots come last."""
  *values, (onehot, onehot_ref) = zip(out, ref)
  err = max(_error(a, b) for a, b in values)
  return bool((onehot == onehot_ref).all()), err


def compare_rollouts(dtype, sample=True, unimix=0.01, n_act=3, shared=None,
                     **shape):
  """The emulated `imagine_actor`, `imagine` and `observe` kernels against
  their plain versions on one set of inputs (call inside `emulated`), the
  card's shared memory taken to be `shared` bytes for the two rollouts
  where given. Returns (every one-hot equal, the largest error of deters
  and logits)."""
  params, data, first, noise, _ = make_inputs(dtype, **shape)
  stoch0, deter0, actions, embeds = data
  T, B, A = actions.shape
  D, U = deter0.shape[1], params['w_in_s'].shape[1]
  S, C = params['stoch_n'], params['classes']
  rng = np.random.default_rng(1)
  t = lambda x: torch.as_tensor(np.asarray(x, np.float32)).to(dtype)
  actor = rssm.make_actor_params(2, D, U, S, C, A, layers=n_act, dtype=dtype)
  actor['ln_bias'] = [t(0.1 * rng.standard_normal(U)) for _ in range(n_act)]
  actor['b_out'] = t(rng.standard_normal(A))
  action0 = t(np.eye(A)[rng.integers(0, A, B)])
  g_a = torch.as_tensor(rng.gumbel(size=(T, B, A)).astype(np.float32))
  results = []
  # imagine_actor's outputs end (stochs, actions); compare the actions
  # with the one-hots and the rest by value.
  kw = dict(noise=(noise, g_a) if sample else None, unimix=unimix,
            act_unimix=0.1 if unimix else 0.0)
  args = (params, actor, stoch0, deter0, action0, T)
  with shared_limit(shared):
    out = rssm.imagine_actor_cuda(*args, **kw)
  ref = rssm.imagine_actor_plain(*args, **kw)
  results.append(_forward_errors(out[:3], ref[:3]))
  results.append((bool((out[3] == ref[3]).all()), 0.0))
  kw = dict(noise=noise if sample else None, unimix=unimix)
  args = (params, stoch0, deter0, actions)
  with shared_limit(shared):
    out = rssm.imagine_cuda(*args, **kw)
  results.append(_forward_errors(out, rssm.imagine_plain(*args, **kw)))
  args = (params, stoch0, deter0, actions, embeds, first)
  results.append(_forward_errors(
      rssm.observe_cuda(*args, **kw), rssm.observe_plain(*args, **kw)))
  return all(r[0] for r in results), max(r[1] for r in results)


def compare_observe(dtype, unimix=0.01, restart=None, shared=None, **shape):
  """The emulated `observe` kernel against its plain version, sampled and
  unsampled, on one set of inputs (call inside `emulated`); with `restart`
  every row starts anew at that step as well; the card's shared memory
  taken to be `shared` bytes where given. Returns (every one-hot equal,
  the largest error of deters and logits)."""
  params, data, first, noise, _ = make_inputs(dtype, **shape)
  if restart is not None:
    first[restart] = True
  results = []
  for sampled in (noise, None):
    kw = dict(noise=sampled, unimix=unimix)
    args = (params, *data, first)
    with shared_limit(shared):
      out = rssm.observe_cuda(*args, **kw)
    results.append(_forward_errors(out, rssm.observe_plain(*args, **kw)))
  return all(r[0] for r in results), max(r[1] for r in results)


# The default widths (T x B = 3 x 3: the last tile of 8 rows of
# observe_fwd's embed product and prior head holds one row, the chain's
# last pair of rows one); no noise, no unimix, one prior layer; bfloat16;
# widths that are no power of two, five rows, an embed width E = 10; widths
# that take two passes of the product (3 * D and S * C above 512); bfloat16
# at the narrow widths, where the chains' cluster splits 5, 9 and 2 groups
# of columns among its 4 ranks, so that the split is ragged and ranks go
# empty. Then cases for the forward's prologue, chain and epilogue:
# bfloat16 with E = 12, no multiple of 8 (a row of embeds is 24 bytes), one
# prior layer; bfloat16 at widths of one or two groups of 8 columns a
# product (U = 16, S * C = 8: three ranks of four own nothing), three prior
# layers, four rows and four steps; float32 with C = 40 classes, more than
# a warp's lanes, so that a lane of the sample takes two classes, and an
# E = 7 with T x B = 2 x 7 rows; last, float32 at the a1 config's widths
# (D = U = 256, S * C = 1024, E = 512) with its 12 continuous actions, on
# two rows of two steps. Then the widths past the shipped ones, each
# through every kernel of the chain on two rows (one cluster) of two
# steps: bfloat16 at the audit's D = 20,
# U = 12, S x C = 3 x 4 (single values) with no prior layer (the head
# reads d_t); bfloat16 at S x C = 3 x 2 with 9 prior layers (the wide
# path: MANY layers' addresses, the vectors in the workspace); float32 at
# D = 9, U = 13 with 2 layers; bfloat16 at D = 9, U = 13, S x C = 3 x 4
# with one; float32 at D = 6, U = 10, S x C = 3 x 2 with no layer; and the
# default widths in both types with the card's shared memory taken to be
# 68 000 bytes, under what both chains keep there (the forward's chain
# about 68 600, the backward about 71 700) and over what the prior head
# and the wide paths need: both kernels on their workspaces. Every case
# has a first step inside the chunk (`make_inputs`).
CASES = (
    (torch.float32, {}),
    (torch.float32, dict(sample=False, unimix=0.0, B=2, T=2, n_out=1)),
    (torch.bfloat16, {}),
    (torch.float32, dict(D=24, U=40, S=4, C=4, A=3, E=10, B=5, T=3,
                         n_out=3)),
    (torch.bfloat16, dict(D=176, U=64, S=36, C=16, A=6, E=24, B=2, T=2)),
    (torch.bfloat16, dict(D=24, U=40, S=4, C=4, A=3, E=10, B=2, T=3,
                          n_out=2)),
    (torch.bfloat16, dict(E=12, n_out=1)),
    (torch.bfloat16, dict(D=8, U=16, S=2, C=4, A=2, E=5, B=4, T=4,
                          n_out=3)),
    (torch.float32, dict(D=16, U=24, S=2, C=40, A=3, E=7, B=7, T=2)),
    (torch.float32, dict(D=256, U=256, S=32, C=32, A=12, E=512, B=2, T=2)),
    (torch.bfloat16, dict(D=20, U=12, S=3, C=4, A=3, E=10, B=2, T=2,
                          n_out=0)),
    (torch.bfloat16, dict(D=20, U=12, S=3, C=2, A=3, E=10, B=2, T=2,
                          n_out=9)),
    (torch.float32, dict(D=9, U=13, S=3, C=2, A=2, E=7, B=2, T=2)),
    (torch.bfloat16, dict(D=9, U=13, S=3, C=4, A=2, E=7, B=2, T=2,
                          n_out=1)),
    (torch.float32, dict(D=6, U=10, S=3, C=2, A=2, E=5, B=2, T=2, n_out=0)),
    (torch.bfloat16, dict(shared=68000, B=2, T=2)),
    (torch.float32, dict(shared=68000, n_out=3, B=2, T=2)),
)


# imagine_actor, imagine and observe: the default widths (three rows leave a
# block of either layout partly empty); no noise, no unimix, one prior layer
# and a one-layer actor; bfloat16; widths that are no power of two (a
# multiple of 8, as observe's product asks), ten rows, so that the rollouts
# take two blocks, and an action width that is a multiple of 4; widths
# that take two passes of either product. In bfloat16 `imagine_actor` and
# `imagine` take their products to the tensor cores where every K and N is
# a multiple of 16 (the default widths: one tile a product), so once more
# at the widths of two passes, where a product is several tiles of 16
# columns a warp and 6 to 18 slices of K, more than the ring's stages, the
# last of them half a tile; and at the widths that are no multiple of 16,
# where every product falls to the FMAs on its bfloat16 inputs. Then the
# widths past the shipped ones: bfloat16 at the audit's D = 20, U = 12,
# S x C = 3 x 4 with no prior layer and a two-layer actor (observe on
# single values); float32 at D = 9, U = 13, S x C = 3 x 2 with 9 prior and
# 9 actor layers (the rollouts' wide paths); and the default widths in
# both types on two steps with the card's shared memory taken
# to be 5 000 bytes for the rollouts (the shipped paths need 6 288 in
# bfloat16 and 8 464 in float32, the wide ones 2 560 and 4 736): their
# products' sums and the schedule in the workspace, bfloat16's products on
# the tensor cores from a ring of 4 stages.
ROLLOUT_CASES = (
    (torch.float32, {}),
    (torch.float32, dict(sample=False, unimix=0.0, B=2, T=2, n_out=1,
                         n_act=1)),
    (torch.bfloat16, {}),
    (torch.float32, dict(D=24, U=40, S=4, C=4, A=12, E=10, B=10, T=3,
                         n_out=3)),
    (torch.float32, dict(D=176, U=64, S=36, C=16, A=6, E=24, B=2, T=2)),
    (torch.bfloat16, dict(D=176, U=64, S=36, C=16, A=6, E=24, B=2, T=2)),
    (torch.bfloat16, dict(D=24, U=40, S=4, C=4, A=12, E=10, B=10, T=3,
                          n_out=3)),
    (torch.bfloat16, dict(D=20, U=12, S=3, C=4, A=3, E=10, B=3, T=2,
                          n_out=0, n_act=2)),
    (torch.float32, dict(D=9, U=13, S=3, C=2, A=3, E=7, B=3, T=2, n_out=9,
                         n_act=9)),
    (torch.bfloat16, dict(shared=5000, T=2)),
    (torch.float32, dict(shared=5000, n_out=0, T=2)),
)


# `observe` alone, sampled and unsampled, at what its clustered chain and
# its prologue meet and the rollout cases do not: bfloat16 at one or two
# groups of 8 columns a product (U = 16, S * C = 8: the cluster splits 1, 2
# and 1 groups among its 4 ranks, three of which own nothing); five rows in
# float32, so that the last cluster holds one row; bfloat16 with E = 12, no
# multiple of 8 (a row of embeds is 24 bytes); float32 with C = 40 classes,
# more than a warp's lanes, so that a lane of the sample takes two classes
# and the first maximum is met across lanes; and bfloat16 with every row
# starting anew at step 2 of 5, besides the first steps of `make_inputs`.
# Then bfloat16 at S x C = 3 x 2 (single values), and the default widths in
# float32 with the card's shared memory taken to be 67 000 bytes, under
# the chain's 68 176 and over its wide path's 65 832: its vectors in the
# workspace.
OBSERVE_CASES = (
    (torch.bfloat16, dict(D=8, U=16, S=2, C=4, A=2, E=5, B=4, T=4)),
    (torch.float32, dict(D=24, U=40, S=4, C=4, A=3, E=10, B=5, T=3)),
    (torch.bfloat16, dict(E=12, B=4, T=3)),
    (torch.float32, dict(D=16, U=24, S=2, C=40, A=3, E=7, B=7, T=2)),
    (torch.bfloat16, dict(D=16, U=24, S=4, C=8, A=4, E=9, B=3, T=5,
                          restart=2)),
    (torch.bfloat16, dict(D=20, U=12, S=3, C=2, A=3, E=10, B=2, T=2)),
    (torch.float32, dict(B=2, T=2, shared=67000)),
)


def _scaled(got, want):
  """The largest |got - want| over the largest |want|; infinite where got
  holds a NaN or an infinity."""
  return _error(got, want) / max(1e-6, float(want.float().abs().max()))


@contextlib.contextmanager
def settings(module, values):
  """Within the block the module's constants named in `values` (a dict, or
  None) take those values."""
  saved = {name: getattr(module, name) for name in values or {}}
  for name, value in (values or {}).items():
    setattr(module, name, value)
  try:
    yield
  finally:
    for name, value in saved.items():
      setattr(module, name, value)


def compare_layer_norm(dtype, C, rows, act, blocks=None, fwd_blocks=None,
                       twice=False, cluster=None, shared=None, seed=0):
  """The emulated `layer_norm_act_fwd` and `layer_norm_act_bwd` against
  the plain version and its autograd (call inside `emulated`); `blocks`
  and `fwd_blocks` cap the backward's and the forward's grids, so that a
  block takes several steps of rows; the forward runs twice on the same
  inputs, and with `twice` the backward too; `cluster` sets constants of
  `norm` (the cluster backward's CLUSTER_RANKS, CLUSTER_THREADS,
  CLUSTER_BLOCKS, CLUSTER_BYTES; the staged forward's STAGES,
  STAGE_THREADS, STAGE_LEAST); the card's shared memory is taken to be `shared`
  bytes where given. Returns (the largest error of y relative to max(|y|,
  1), the largest scaled error of dx, dscale and dbias over the runs for
  each of the three, whether every run gave the same bits and left the
  counters at zero)."""
  rng = np.random.default_rng(seed)
  t = lambda *shape: torch.as_tensor(
      rng.standard_normal(shape).astype(np.float32))
  x = (3 * t(rows, C) + 1).to(dtype)
  scale, bias, dy = 1 + 0.2 * t(C), 0.3 * t(C), t(rows, C).to(dtype)
  caps = {'FWD_BLOCKS': fwd_blocks, 'STAGE_BLOCKS': fwd_blocks,
          'BWD_BLOCKS': blocks, **(cluster or {})}
  with settings(norm, {k: v for k, v in caps.items() if v is not None}), (
      shared_limit(shared)):
    y, mean, rstd = norm.layer_norm_act_fwd_cuda(x, scale, bias, act)
    again = norm.layer_norm_act_fwd_cuda(x, scale, bias, act)
    runs = [norm.layer_norm_act_bwd_cuda(x, scale, bias, mean, rstd, dy, act)
            for _ in range(2 if twice else 1)]
    zeroed = not bool(norm._tickets(x.device).any())
  leaves = [v.clone().requires_grad_() for v in (x, scale, bias)]
  ref = norm.layer_norm_act_plain(*leaves, act)
  want = torch.autograd.grad(ref, leaves, dy)
  ref = ref.detach()
  fwd = float(((y.float() - ref.float()).abs()
               / ref.float().abs().clamp_min(1)).max())
  same = zeroed and all(torch.equal(a, b) for run in runs[1:]
                        for a, b in zip(runs[0], run)) and all(
                            torch.equal(a, b)
                            for a, b in zip((y, mean, rstd), again))
  return fwd, [max(_scaled(got[i], want[i]) for got in runs)
               for i in range(3)], same


def compare_adam(sizes, decayed, warmup, seed=0):
  """The emulated `adam_sumsq` and `adam_update` against the plain versions
  from the same state (call inside `emulated`), in two steps: one with
  finite gradients, one with a NaN in a gradient. Returns (the norm's
  relative error, p, m and v equal to the plain loop's bit for bit after
  the finite step, and left as they were by the NaN one)."""
  rng = np.random.default_rng(seed)
  t = lambda n: torch.as_tensor(rng.standard_normal(n).astype(np.float32))
  params = [t(n) for n in sizes]
  ms = [0.1 * t(n) for n in sizes]
  vs = [t(n).square() for n in sizes]
  # The gradients as views of one flat bucket, as the data-parallel mean
  # hands them over: the second starts off 16-byte alignment.
  grads = list(t(sum(sizes)).split(list(sizes)))
  step = torch.tensor(3.0)
  lr = 1e-3 * torch.clamp(step / 10, 0, 1) if warmup else 1e-3
  kw = dict(wd=1e-2, beta1=0.9, beta2=0.999, eps=1e-5)
  norm_ = adam.global_norm_cuda(grads)
  want = adam.global_norm_plain(grads)
  rel = abs(float(norm_) - float(want)) / float(want)
  same = True
  for poison in (False, True):
    if poison:
      grads[1][2] = float('nan')
      want = adam.global_norm_plain(grads)
    finite = torch.isfinite(want)
    scale = torch.where(finite, torch.clamp_max(
        100 / torch.clamp_min(want, 1e-8), 1.0), torch.zeros(()))
    bias1, bias2 = 1 - 0.9 ** step, 1 - 0.999 ** step
    states = [[x.clone() for x in xs] for xs in (params, ms, vs)]
    plain = [[x.clone() for x in xs] for xs in (params, ms, vs)]
    adam.adam_update_cuda(*states[:1], grads, *states[1:], decayed, want,
                          scale, lr, bias1, bias2, **kw)
    adam.adam_update_plain(plain[0], grads, plain[1], plain[2], decayed,
                           finite, scale, lr, bias1, bias2, **kw)
    for got, ref, old in zip(states, plain, (params, ms, vs)):
      for g, r, o in zip(got, ref, old):
        same &= bool(torch.equal(g, r))
        if poison:
          same &= bool(torch.equal(g, o))
    if not poison:
      params, ms, vs = states
  return rel, same


# The settings of a case that send rows past the plan to PR 21's
# streaming backward (no lane may keep a byte of a row, so no cluster plan
# fits); the cases' few rows take the cluster backward without them.
STREAMED = {'CLUSTER_BYTES': 0}
# layer_norm_act: C = 64 and C = 130 in both dtypes, with the ELU and
# without, on 37 rows (no multiple of a block's 32, 16 or 8 rows): bfloat16
# at 64 takes 16-byte vectors and groups of 8 lanes, float32 at 64 groups
# of 16; 130 is no multiple of a vector, so a value a lane, a warp a row
# and 6 values a lane, 2 of them past the row. Then C = 9 (groups of 16
# lanes, 7 of them idle) and C = 1536 (four warps a row, 2 vectors a lane,
# their sums through shared memory) in bfloat16; 64 once more on 600 rows
# with the backward capped at 2 blocks, so that each block takes a run of
# 10 steps and the two blocks' sums meet in a cluster of 2; 768 on 20 rows
# (the GRU's norm at a1, two warps a row, 1.5 vectors a lane); float32 at
# 1536 (four warps a row, 3 vectors a lane); and bfloat16 at 3072 with the
# backward capped at 1 block, the whole block a row. Each as (dtype, C,
# rows, act, blocks).
LAYER_NORM_CASES = (
    (torch.bfloat16, 64, 37, 'elu', None),
    (torch.float32, 64, 37, 'elu', None),
    (torch.bfloat16, 130, 37, 'none', None),
    (torch.float32, 130, 37, 'elu', None),
    (torch.bfloat16, 9, 21, 'elu', None),
    (torch.bfloat16, 1536, 5, 'elu', None),
    (torch.bfloat16, 64, 600, 'elu', 2),
    (torch.bfloat16, 768, 20, 'none', None),
    (torch.float32, 1536, 11, 'elu', None),
    (torch.bfloat16, 3072, 9, 'elu', 1),
)
# The grid of rows, named after the cases above and held to the same
# tolerances but for dx in bfloat16 (see `run_case`). The forward's walk
# over the rows: bfloat16 at 64 on 600 rows with the forward capped at 2
# blocks (each group takes 10 rows, the next in flight while it reduces
# one), float32 at 512 on 40 rows in 1 block (5 rows, each loaded after the
# last), float32 at 256 the same way with the next row in flight.
# The backward's clusters and tickets: a grid of 1 block at 256 columns on
# 50 rows (no ticket); 400 rows of 64 in 13 blocks, 2 clusters (the second
# with 5 blocks of rows); 2000 rows of 64 in 63 blocks, 8 clusters of 8
# (the last block empty); 1100 rows in 35 blocks, 5 clusters (the last with 3
# blocks of rows); float32 at 768 on 200 rows (two warps a row) in 50
# blocks, 7 clusters; 700 rows of 128 in 44 blocks twice, equal bit for
# bit, the counters back at zero. Then a1's observe step: 32 rows at 256
# with the ELU and at 768 without. Last, the streaming path (rows past the
# plan, a block a row): C = 4 100 on 5 rows, bfloat16 (8-byte vectors)
# with the ELU and float32 (16-byte vectors) without (5 blocks, one
# cluster); bfloat16 on
# 37 rows with the forward capped at 3 blocks (the backward takes a block
# for each chunk of 8 rows: one cluster of 5, runs of 8 rows); 16 392
# bfloat16 (16-byte vectors) on 3 rows; 12 292 float32 (16-byte vectors)
# on 2 rows; 4 097 bfloat16 (single values) on 150 rows in 17 blocks
# (two clusters of 8, runs of 10 rows in chunks of 8 and 2, the last block
# none; their rows summed by the last tickets) twice, equal bit for bit,
# the counters back at zero. Since the cluster backward took the
# backward of those rows, the same cases run it at its own geometry
# (clusters of 8 blocks, `norm.lane_plan`: 4 100 bfloat16 in 8-byte
# vectors, one a lane, blocks of 160 threads, 4 rows a barrier; 4 097 in
# single values, 4 a lane, 256 threads, 66 clusters on 150 rows, 4 rows a
# barrier; 16 392 bfloat16 and 12 292 float32 in 16-byte vectors, 2 a lane
# for the first lanes, a row a barrier), and the streaming backward takes
# C = 4 100 on 37 rows once more with CLUSTER_BYTES lowered to 2 (a block
# for each chunk of 8 rows: one cluster of 5). Then the cluster backward at
# smaller clusters: bfloat16 at 4 100 with the ELU on 10 rows in 3
# clusters of 2 (runs of 4, 4 and 2 rows; 8-byte vectors, 4 a lane, 1 025
# of them over 512 lanes; a row a barrier), their rows summed through the
# tickets; float32 at 4 098 without it on 7 rows in 3 clusters of 4 (8-byte
# vectors, 2 049 over 1 024 lanes) twice, equal bit for bit, the counters
# back at zero; bfloat16 at 4 097 with the ELU (single values, 16 a lane)
# on 6 rows in 2 clusters of 4 blocks of 128 threads; float32 at 12 292
# with the ELU (16-byte vectors, 2 a lane) on 3 rows in one cluster of 8,
# which writes dscale and dbias itself. Where a cluster takes more than
# one row its clusters' rows meet in two levels of tickets (groups of
# about sqrt(clusters) clusters): 4 097 on 150 rows (66 clusters in 8
# groups), 4 100 on 10 rows (3 clusters in 2 groups); else in one. Last,
# the streaming backward once more (STREAMED) at the first five widths
# above that the cluster backward took: bfloat16 at 4 100 with the ELU and
# float32 without on 5 rows, 16 392 bfloat16 on 3 rows, 12 292 float32 on
# 2 rows, and 4 097 bfloat16 (single values) on 150 rows in 17 blocks
# twice, equal bit for bit, the counters back at zero; and bfloat16 at
# 4 100 on 37 rows sent there by the wrapper's own rule (rows of fewer
# than CLUSTER_LEAST bytes, NARROW_ROWS lowered to 37). Since the staged
# forward took some of the forward of rows past the plan
# (`norm.stage_plan`: rows of at least STAGE_LEAST bytes, at most
# STAGE_FEW rows with the ELU; 4 buffers a block at 4 100 and 4 097
# bfloat16, 3 at 16 392, 2 at 12 292 float32), the cases above with the
# ELU on few rows run it; its own cases, sent there by the rule or with
# STAGE_LEAST lowered to 0: bfloat16 at 4 100 (8-byte vectors; every
# second row starts 8 bytes off 16, the last row's last chunk past the
# tensor's end read value by value) with the ELU on 9 rows in 2 blocks
# (runs of 5 and 4 rows, the buffers taken in turn), with 4 buffers and
# with 2; 4 097 bfloat16 (single values, rows 2 bytes apart modulo 16, the
# tensor's end 14 bytes past a chunk) without it on 7 rows in 3 blocks of
# 3 buffers, and with it on 150 rows in 7 blocks (512 threads, the
# kernel's pick past 132 rows; runs of 21 and 22 rows); 16 392 bfloat16
# (16-byte rows) on 3 rows in one block; float32 at 12 292 (49 KB rows,
# by the rule at any count) without the ELU on 130 rows in 5 blocks;
# float32 at 4 098 (8-byte vectors) with it on 5 rows in 2 blocks of
# 1 024 threads twice, equal bit for bit; bfloat16 at 4 100 on 6 rows in
# blocks of 64 threads (33 vectors of 8 bytes a thread, most of a row's
# chunks a thread); and the rule for rows whose two buffers do not fit:
# bfloat16 at 4 100 with the ELU on 5 rows with the card's shared memory
# taken to be 16 000 bytes (the streaming forward) and 20 000 (two buffers
# in all of it). Each as (dtype, C, rows, act, blocks[, fwd_blocks[,
# twice[, cluster[, shared]]]]), `cluster` the settings of
# `compare_layer_norm`, `shared` its bytes.
LAYER_NORM_GRID_CASES = (
    (torch.bfloat16, 64, 600, 'elu', None, 2),
    (torch.float32, 512, 40, 'none', None, 1),
    (torch.float32, 256, 40, 'elu', None, 1),
    (torch.bfloat16, 256, 50, 'elu', 1),
    (torch.bfloat16, 64, 400, 'none', None),
    (torch.bfloat16, 64, 2000, 'elu', None),
    (torch.bfloat16, 64, 1100, 'none', None),
    (torch.float32, 768, 200, 'elu', None),
    (torch.bfloat16, 128, 700, 'elu', None, None, True),
    (torch.bfloat16, 256, 32, 'elu', None),
    (torch.bfloat16, 768, 32, 'none', None),
    (torch.bfloat16, 4100, 5, 'elu', None),
    (torch.float32, 4100, 5, 'none', None),
    (torch.bfloat16, 4100, 37, 'elu', 11, 3),
    (torch.bfloat16, 16392, 3, 'none', None),
    (torch.float32, 12292, 2, 'elu', None),
    (torch.bfloat16, 4097, 150, 'elu', 17, None, True),
    (torch.bfloat16, 4100, 37, 'elu', 11, 3, False, {'CLUSTER_BYTES': 2}),
    (torch.bfloat16, 4100, 10, 'elu', None, None, False,
     {'CLUSTER_RANKS': 2, 'CLUSTER_BLOCKS': 6}),
    (torch.float32, 4098, 7, 'none', None, None, True,
     {'CLUSTER_RANKS': 4, 'CLUSTER_BLOCKS': 12}),
    (torch.bfloat16, 4097, 6, 'elu', None, None, False,
     {'CLUSTER_RANKS': 4, 'CLUSTER_THREADS': 128, 'CLUSTER_BLOCKS': 8}),
    (torch.float32, 12292, 3, 'elu', None, None, False,
     {'CLUSTER_RANKS': 8, 'CLUSTER_BLOCKS': 8}),
    (torch.bfloat16, 4100, 5, 'elu', None, None, False, STREAMED),
    (torch.float32, 4100, 5, 'none', None, None, False, STREAMED),
    (torch.bfloat16, 16392, 3, 'none', None, None, False, STREAMED),
    (torch.float32, 12292, 2, 'elu', None, None, False, STREAMED),
    (torch.bfloat16, 4097, 150, 'elu', 17, None, True, STREAMED),
    (torch.bfloat16, 4100, 37, 'elu', 11, 3, False, {'NARROW_ROWS': 37}),
    (torch.bfloat16, 4100, 9, 'elu', None, 2),
    (torch.bfloat16, 4100, 9, 'elu', None, 2, False, {'STAGES': 2}),
    (torch.bfloat16, 4097, 7, 'none', None, 3, False,
     {'STAGES': 3, 'STAGE_LEAST': 0}),
    (torch.bfloat16, 4097, 150, 'elu', None, 7, False, {'STAGE_LEAST': 0}),
    (torch.bfloat16, 16392, 3, 'none', None, 1, False, {'STAGE_LEAST': 0}),
    (torch.float32, 12292, 130, 'none', None, 5),
    (torch.float32, 4098, 5, 'elu', None, 2, True, {'STAGE_THREADS': 1024}),
    (torch.bfloat16, 4100, 6, 'none', None, 2, False,
     {'STAGE_THREADS': 64, 'STAGE_LEAST': 0}),
    (torch.bfloat16, 4100, 5, 'elu', None, None, False, None, 16000),
    (torch.bfloat16, 4100, 5, 'elu', None, None, False, None, 20000),
)
# adam: three tensors of odd sizes, the second decayed, one of them over a
# block's chunk; with a constant lr and with a warmup's tensor lr. Then 200
# small tensors, four of them empty, every third decayed: more than a
# launch of either kernel takes. Each as (sizes, decayed, warmup).
ADAM_CASES = (
    ((7, adam.CHUNK + 13, 301), (False, True, False), False),
    ((7, adam.CHUNK + 13, 301), (False, True, False), True),
    (tuple(i * 37 % 50 for i in range(200)),
     tuple(i % 3 == 0 for i in range(200)), False),
)


def compare_gru(dtype, D, rows, fwd_blocks=None, cluster=None, blocks=None,
                lanes=None, fwd_lanes=None, normed=True, wide=None, seed=0):
  """The emulated `gru_cell_fwd` and `gru_cell_bwd` against the plain
  version and its autograd (call inside `emulated`); `fwd_blocks` caps the
  forward's grid, so that a block takes several steps of rows, and
  `fwd_lanes` sets the lanes it spreads the rows over; `cluster`, `blocks`
  and `lanes` set the backward's cluster, its blocks at most and the lanes
  it spreads the rows over; without `normed` the cell has no norm (scale
  and bias None); `wide` sets the constants of the kernels past MAX_D
  (gru's CLUSTER_BYTES and the forward's FWD_*; norm's CLUSTER_RANKS,
  CLUSTER_THREADS and CLUSTER_BLOCKS, which gru reads). Each way runs
  twice. Returns (the largest error of
  the new deter relative to max(|deter|, 1), the largest scaled error of
  dx, ddeter, dscale and dbias (the first two without a norm), whether the
  two runs each way gave the same bits and left the counters at zero)."""
  rng = np.random.default_rng(seed)
  t = lambda *shape: torch.as_tensor(
      rng.standard_normal(shape).astype(np.float32))
  x = (2 * t(rows, 3 * D) + 0.5).to(dtype)
  deter = torch.tanh(t(rows, D)).to(dtype)
  scale, bias, dout = 1 + 0.2 * t(3 * D), 0.3 * t(3 * D), t(rows, D).to(dtype)
  if not normed:
    scale = bias = None
  caps = dict(zip(('FWD_BLOCKS', 'CLUSTER', 'BWD_BLOCKS', 'BWD_LANES',
                    'FWD_LANES'),
                   (fwd_blocks, cluster, blocks, lanes, fwd_lanes)))
  caps = {k: v for k, v in caps.items() if v is not None}
  # The cluster geometry that gru.py reads from norm.
  shared = {k: v for k, v in (wide or {}).items() if not hasattr(gru, k)}
  caps.update({k: v for k, v in (wide or {}).items() if k not in shared})
  with settings(gru, caps), settings(norm, shared):
    out, mean, rstd = gru.gru_cell_fwd_cuda(x, deter, scale, bias)
    again = gru.gru_cell_fwd_cuda(x, deter, scale, bias)
    runs = [gru.gru_cell_bwd_cuda(x, deter, scale, bias, mean, rstd, dout)
            for _ in range(2)]
    zeroed = not (bool(gru._barrier(x.device)[0])
                  or bool(gru._tickets(x.device).any()))
  leaves = [v.clone().requires_grad_() for v in (x, deter, scale, bias)
            if v is not None]
  ref = gru.gru_cell_plain(*leaves)
  want = torch.autograd.grad(ref, leaves, dout)
  ref = ref.detach()
  # A NaN makes the error NaN, which no tolerance passes.
  fwd = float(((out.float() - ref.float()).abs()
               / ref.float().abs().clamp_min(1)).max())
  bwd = [_scaled(got, w) for got, w in zip(runs[0], want)]
  same = zeroed and all(a is None or torch.equal(a, b)
                        for a, b in [*zip(*runs), *zip((out, mean, rstd),
                                                       again)])
  return fwd, bwd, same


def compare_onehot(dtype, rows, S, C, unimix, sample, blocks=None,
                   lane_classes=None, bwd_lane_classes=None, tied=False,
                   wide=False, seed=0):
  """The emulated `onehot_head_fwd` and `onehot_head_bwd` against the plain
  version and its autograd (call inside `emulated`); `blocks` caps both
  grids, so that a block walks several steps, `lane_classes` sets the
  classes a lane holds, in the backward `bwd_lane_classes` where given;
  with `tied` every group's raw logits are 0 but for its first C // 3
  classes, at -1, so that its largest values tie from class C // 3 on, in
  several lanes; with `wide` the general forward takes the values to fill
  the card (GROUP_WIDE_LANES 0: many values' classes a lane); each way runs
  twice on the same inputs. Returns (the
  largest error of the logit relative to max(|logit|, 1), the groups
  whose choice differs and whether each of them is a tie, the largest
  error of stoch on the other groups, the scaled error of raw's gradient,
  whether the two runs each way gave the same bits)."""
  rng = np.random.default_rng(seed)
  t = lambda *shape: torch.as_tensor(
      rng.standard_normal(shape).astype(np.float32))
  raw = (2 * t(rows, S, C)).to(dtype)
  if tied:
    raw = torch.zeros_like(raw)
    raw[..., :C // 3] = -1
  u = torch.as_tensor(rng.uniform(size=(rows, S, C)).astype(np.float32)) if (
      sample) else None
  dlogit, dstoch = t(rows, S, C).to(dtype), t(rows, S, C).to(dtype)
  names = ('BLOCKS', 'LANE_CLASSES', 'BWD_LANE_CLASSES', 'GROUP_WIDE_LANES')
  saved = [getattr(onehot, name) for name in names]
  for name, value in zip(names, (blocks or saved[0], lane_classes,
                                 bwd_lane_classes or lane_classes,
                                 0 if wide else saved[3])):
    setattr(onehot, name, value)
  try:
    logit, stoch = onehot.onehot_head_fwd_cuda(raw, u, unimix)
    fwd_again = onehot.onehot_head_fwd_cuda(raw, u, unimix)
    draw, again = [onehot.onehot_head_bwd_cuda(raw, logit, dlogit, dstoch,
                                              unimix, sample)
                   for _ in range(2)]
  finally:
    for name, value in zip(names, saved):
      setattr(onehot, name, value)
  leaf = raw.clone().requires_grad_()
  ref_logit, ref_stoch = onehot.onehot_head_plain(leaf, u, unimix)
  outs = [(ref_logit, dlogit)] + ([(ref_stoch, dstoch)] if sample else [])
  want, = torch.autograd.grad([o for o, _ in outs], leaf,
                              [g for _, g in outs])
  logit_err = float(((logit.float() - ref_logit.detach().float()).abs()
                     / ref_logit.detach().float().abs().clamp_min(1)).max())
  flips, ties = _choices(stoch, ref_stoch.detach(), ref_logit.detach(), u)
  keep = (stoch.argmax(-1) == ref_stoch.detach().argmax(-1))[..., None]
  stoch_err = _error(stoch * keep, ref_stoch.detach() * keep)
  same = torch.equal(draw, again) and all(
      torch.equal(a, b) for a, b in zip((logit, stoch), fwd_again))
  return logit_err, (flips, ties), stoch_err, _scaled(draw, want), same


def _choices(stoch, ref, logit, u, rel=1e-5):
  """(groups whose chosen class differs between `stoch` and `ref`, whether
  every one of them is a tie): the two classes' values of the plain
  version's arg max (log_softmax of `logit`, plus the noise of `u` where
  sampled) within `rel` of max(their size, 1)."""
  values = torch.log_softmax(logit.float(), -1)
  if u is not None:
    from ..nn import dists
    values = values + dists.gumbel_noise(u)
  got, want = stoch.argmax(-1), ref.argmax(-1)
  differ = got != want
  a = values.gather(-1, got[..., None])[..., 0][differ]
  b = values.gather(-1, want[..., None])[..., 0][differ]
  ties = bool(((a - b).abs() <= rel * torch.maximum(
      a.abs(), torch.ones_like(a))).all())
  return int(differ.sum()), ties


# gru. The forward (a group of at least a warp a row, or of the row's
# vectors where fewer, wider where the rows take fewer than FWD_LANES
# lanes; blocks of 256 threads, or of the group where it spans warps):
# bfloat16 at D = 24 with FWD_LANES 1 (three 16-byte vectors a part: groups
# of 4 lanes, 64 rows a step) on 150 rows (no multiple of 64) with its grid
# capped at 2 blocks, so that it walks its steps by the grid's stride;
# float32 at D = 130, no multiple of a 16-byte vector
# (130 single values: 8 warps a row, 126 lanes without a value); bfloat16
# at xarm's D = 512 on 9 rows (8 warps a row, 4-byte vectors). The backward
# (blocks of 256 threads) of the same cases: the first with the narrowest
# group (lanes 1: 16-byte vectors, 4 lanes a row, 64 rows a step, a tree of
# 6 levels) in a cooperative grid of 3 blocks (past a cluster of 2), their
# rows of partial sums summed after the grid's barrier; the second with
# 4-byte vectors (4 a lane, the last of them past the row) and a warp a
# row, 5 steps of 8 rows in one cluster of 2 blocks (runs of 3 and 2
# steps); the third spread over the widest group (8 warps a row, 4-byte
# vectors), a block a row, 9 blocks in a cluster of 16, 7 of them without
# a step. Then a1's observe step (bfloat16, D = 256, 32 rows: 8 warps a row
# and single values forward, 128 lanes a row and 4-byte vectors backward,
# one cluster of 16) and its policy step (1 row: one block of 8 warps both
# ways); D = 64 on 300 rows (a warp a row and 4-byte vectors forward, 16
# lanes and 8-byte vectors backward) in a cooperative grid of 19 blocks;
# float32 at D = 512 on 40 rows (8 warps a row forward, 128 lanes backward)
# in one cluster of 4 blocks taking runs of 5 steps; float32 at D = 130 in a
# cooperative grid of 4 blocks taking runs of 2, 2, 1 and no steps. Then
# the forward's own: bfloat16 D = 512 at 2 warps a row (FWD_LANES 1: a
# 16-byte vector a part a lane, a block of 64 threads a row) on 40 rows in
# one block, which walks 40 steps holding its scale and bias; float32 D =
# 512 at 2 warps a row (2 vectors of 4 a part) on 20 rows in 2 blocks of
# 10 steps; bfloat16 D = 256 a warp a row on 100 rows in one block, 13
# steps of 8 rows; the wide groups of few rows: float32 at 32
# x 256 (8 warps, single values), bfloat16 at 32 x 512 (8 warps, 4-byte
# vectors), float32 at 1 x 512 (8 warps, 8-byte vectors); last, bfloat16
# at D = 45, no vector at all (single values, 2 warps a row, wider groups
# leaving lanes without one). Then the two paths past that layout. Without
# a norm (elementwise, a thread a vector): bfloat16 at D = 24 on 37 rows
# (16-byte vectors) and float32 at D = 130 (8-byte vectors) on 5 rows, each
# with the forward's grid capped at one block, which walks the rows'
# vectors; and D = 45 (single values) in bfloat16 and float32. The wide rows (D past
# MAX_D, a block a row streamed in passes): D = 2 049 (single values) on 5
# rows in both types, the backward a cooperative grid of 5 blocks; on 7
# rows with the forward's grid capped at 2 blocks and the backward's at 3
# (runs of 3, 3 and 1 rows, each block's column sums over its rows before
# the grid's); on 1 row (one block, the sums written directly);
# bfloat16 at D = 2 056 (16-byte vectors) on 3 rows; and float32 at D =
# 2 049 on 20 rows in 2 blocks (runs of 10 rows in chunks of 8 and 2).
# Since the cluster backward took the backward past MAX_D, the same cases
# run it at its own geometry (clusters of 8 blocks, `norm.lane_plan`:
# D = 2 049 in single values, 2 a lane for the first lanes, 256 threads, 2
# rows a barrier in bfloat16 and a row in float32; D = 2 056 on 3 rows in
# 4-byte vectors over 160 threads; 5, 7, 1, 3 and 20 clusters), and the
# streaming backward takes D = 2 049 on 7 rows once
# more with CLUSTER_BYTES lowered to 1 (a cooperative grid of 3 blocks).
# Then the cluster backward at smaller clusters: bfloat16 at D = 2 056 on
# 7 rows in 3 clusters of 4 blocks of 128 threads (runs of 3, 3 and 1 rows;
# 8-byte vectors, 2 a lane, 514 of them over 512 lanes; a row a barrier);
# float32 at D = 2 049 (single values, 4 a lane) on 6 rows in 2 clusters
# of 4; bfloat16 at 2 049 (8 a lane) on 5 rows in one cluster of 2, which
# writes dscale and dbias itself; float32 at D = 4 100 (16-byte vectors,
# blocks of 160 threads) on 9 rows in 3 clusters of 8, which meet in two
# levels of tickets (2 groups; the 20 clusters of a row each above meet in
# one). Last, the streaming backward once more (STREAMED) where the
# cluster backward took the cases above: float32 at D = 2 049 on 7 rows (a
# cooperative grid of 3 blocks), bfloat16 on 1 row (one block, the sums
# written directly), bfloat16 at D = 2 056 (16-byte vectors) on 3 rows,
# float32 at D = 2 049 on 20 rows in 2 blocks (runs of 10 rows in chunks
# of 8 and 2). Since the forward past MAX_D left the streaming kernel
# (`gru.fwd_plan`), the cases above past it run the block forward (D =
# 2 049 in single values, 4 a part a thread over 544 threads, the last
# thread with one; D = 2 056 over 544 threads of 8-byte vectors; a block a
# row), but float32's 9 rows at 4 100, which no block holds at 16 bytes of
# a part a thread (the streaming forward). Its own cases: bfloat16 at D =
# 2 056 on 40 rows in at most 16 blocks (runs of 3 rows that hold their
# scale and bias, the last run 1); on 37 rows as a launch of many rows
# (FWD_SPREAD 1: the fewest threads, 288 of 16-byte vectors, in 4 blocks:
# runs of 10, 10, 10 and 7); float32 at D = 2 049 on 20 rows in 3 blocks
# of 544 threads (runs of 7, 7 and 6); bfloat16 at D = 2 049 on 9 rows in
# 2 blocks (runs of 5 and 4); bfloat16 at D = 4 100 on 5 rows with 2
# vectors of 4 a part a thread over 544 threads (the second past the row
# for the last 63 threads); float32 at D = 4 100 on 3 rows, which no block
# holds (the streaming forward); the rule that keeps the streaming
# forward, FWD_BYTES 0 (no thread may keep a part's byte), bfloat16 at D =
# 2 049 on 7 rows with its grid capped at 2 blocks; bfloat16 at D = 2 056
# on 40 rows as many rows in 2 blocks of 288 threads (runs of 20 rows);
# float32 at D = 4 096 on 33 rows in 7 blocks of 1 024 threads (runs of 5
# rows, the last 3), a1's imagined rows' layout; and the rule that sends a
# launch of many rows whose threads would keep fewer than FWD_MANY_VALUES
# values of a part to the streaming forward: bfloat16 at D = 2 049 on 20
# rows with FWD_SPREAD 1; and with FWD_BOUND 0, the 288 threads of 37
# bfloat16 rows at D = 2 056 (FWD_SPREAD 1) on the instantiation built for
# 1 024 threads, where without it (the cases of 37 and 40 rows at 288
# threads above) one 16-byte vector a part takes the one built for 640.
# Each
# as (dtype, D, rows,
# fwd_blocks, cluster, blocks, lanes, fwd_lanes[, normed[, wide]]), `wide`
# the settings of `compare_gru`.
GRU_CASES = (
    (torch.bfloat16, 24, 150, 2, 2, 3, 1, 1),
    (torch.float32, 130, 37, None, 2, 2, 1, None),
    (torch.bfloat16, 512, 9, None, None, None, None, None),
    (torch.bfloat16, 256, 32, None, None, None, None, None),
    (torch.bfloat16, 256, 1, None, None, None, None, None),
    (torch.bfloat16, 64, 300, None, 4, 20, None, None),
    (torch.float32, 512, 40, None, 4, 4, None, None),
    (torch.float32, 130, 37, None, 1, 4, 1, None),
    (torch.bfloat16, 512, 40, 1, None, None, None, 1),
    (torch.float32, 512, 20, 2, None, None, None, 1),
    (torch.bfloat16, 256, 100, 1, None, None, None, 1),
    (torch.float32, 256, 32, None, None, None, None, None),
    (torch.bfloat16, 512, 32, None, None, None, None, None),
    (torch.float32, 512, 1, None, None, None, None, None),
    (torch.bfloat16, 45, 7, None, None, None, None, None),
    (torch.bfloat16, 24, 37, 1, None, None, None, None, False),
    (torch.float32, 130, 5, 1, None, None, None, None, False),
    (torch.bfloat16, 45, 7, None, None, None, None, None, False),
    (torch.float32, 45, 7, None, None, None, None, None, False),
    (torch.bfloat16, 2049, 5, None, None, None, None, None),
    (torch.float32, 2049, 5, None, None, None, None, None),
    (torch.bfloat16, 2049, 7, 2, None, 3, None, None),
    (torch.float32, 2049, 7, 2, None, 3, None, None),
    (torch.bfloat16, 2049, 1, None, None, None, None, None),
    (torch.bfloat16, 2056, 3, None, None, None, None, None),
    (torch.float32, 2049, 20, None, None, 2, None, None),
    (torch.bfloat16, 2049, 7, 2, None, 3, None, None, True,
     {'CLUSTER_BYTES': 1}),
    (torch.bfloat16, 2056, 7, None, None, None, None, None, True,
     {'CLUSTER_RANKS': 4, 'CLUSTER_THREADS': 128, 'CLUSTER_BLOCKS': 12}),
    (torch.float32, 2049, 6, None, None, None, None, None, True,
     {'CLUSTER_RANKS': 4, 'CLUSTER_BLOCKS': 8}),
    (torch.bfloat16, 2049, 5, None, None, None, None, None, True,
     {'CLUSTER_RANKS': 2, 'CLUSTER_BLOCKS': 2}),
    (torch.float32, 4100, 9, None, None, None, None, None, True,
     {'CLUSTER_RANKS': 8, 'CLUSTER_BLOCKS': 32}),
    (torch.float32, 2049, 7, 2, None, 3, None, None, True, STREAMED),
    (torch.bfloat16, 2049, 1, None, None, None, None, None, True, STREAMED),
    (torch.bfloat16, 2056, 3, None, None, None, None, None, True, STREAMED),
    (torch.float32, 2049, 20, None, None, 2, None, None, True, STREAMED),
    (torch.bfloat16, 2056, 40, 16, None, None, None, None),
    (torch.bfloat16, 2056, 37, 4, None, None, None, None, True,
     {'FWD_SPREAD': 1}),
    (torch.float32, 2049, 20, 3, None, None, None, None),
    (torch.bfloat16, 2049, 9, 2, None, None, None, None),
    (torch.bfloat16, 4100, 5, None, None, None, None, None),
    (torch.float32, 4100, 3, None, None, None, None, None),
    (torch.bfloat16, 2049, 7, 2, None, None, None, None, True,
     {'FWD_BYTES': 0}),
    (torch.bfloat16, 2056, 40, 2, None, None, None, None, True,
     {'FWD_SPREAD': 1}),
    (torch.float32, 4096, 33, 8, None, None, None, None),
    (torch.bfloat16, 2049, 20, None, None, None, None, None, True,
     {'FWD_SPREAD': 1}),
    (torch.bfloat16, 2056, 37, 4, None, None, None, None, True,
     {'FWD_SPREAD': 1, 'FWD_BOUND': 0}),
)
# onehot: both kernels hold the same classes a lane unless the case names
# the backward's. 8 classes a lane: bfloat16 with 32 classes (4 lanes a
# group) and unimix 0.01, sampled, on 5 rows of 3 groups (480 values: 60
# lanes, the block partly empty); float32 with 8 classes (a lane a group,
# two 16-byte loads) and no mixture, sampled, on 7 rows of 5 groups;
# bfloat16 with 4 classes (2 groups a lane) and unimix 0.01, the mode, on 3
# rows of 4 groups; float32 with 2 classes and unimix, sampled, on 3 rows
# of 3 groups (18 values: the last lane holds 2 of its 8, loaded and stored
# one by one); bfloat16 with 16 classes (2 lanes a group), sampled, on 33
# rows of 8 groups (528 lanes) with the grids capped at 2 blocks, so that
# the first walks a third step. By size (2 classes a lane below WIDE_FROM
# values): a1's `initial()` mode at its observe step, bfloat16, 32 rows of
# 32 x 32 (16 lanes a group). 2 classes a lane: float32, 32 classes (an
# 8-byte load), sampled, on 5 rows of 3 groups; bfloat16 with 2 classes (a
# lane a group), sampled, on 3 rows of 3 groups; bfloat16 with 32 classes,
# sampled, on 7 rows of 3 groups; float32 with 4 classes, the mode without
# the mixture (the backward hands the logit's gradient on); bfloat16 with 8
# classes and unimix, the mode, on 17 rows of 5 groups (340 lanes) in one
# block, which walks 2 steps. Then float32 with 4 classes at 8 a lane,
# sampled, on 3 rows of 5 groups (60 values: the last lane holds one group
# of its two); float32 with 32 classes and no mixture, sampled, the forward
# at 8 a lane and the backward at 2; 4 classes a lane: bfloat16 with 2
# classes, sampled (18 values: the last lane holds 2 of its 4), and with 32
# classes (8 lanes a group), sampled, on 9 rows of 4 groups (288 lanes) in
# one block; float32 with 8 classes at 8 a lane, sampled, on 40 rows of 8
# groups (320 lanes) in one block. Then float32 as the card runs it from
# WIDE_FROM values (the forward at 8 a lane, the backward at 4, a 16-byte
# load): 32 classes (8 lanes a group), sampled, on 9 rows of 4 groups (288
# lanes) in one block, and 2 classes, sampled, on 3 rows of 3 groups (18
# values: the last lane holds 2 of its 4). Last, the general path (any
# class count but the powers of two from 2 to 32; classes a lane play no
# part): 3 classes (groups of 4 lanes, 8 a warp) with unimix, sampled and
# the mode, in both types on 7 rows of 5 groups; 48 (a warp a group, 16
# lanes with two classes) and 64 (two each) with unimix, sampled, and 64
# the mode without it, in both types; 1 class with unimix, sampled; 100
# classes on 33 rows of 8 groups, sampled, with the grid capped at 2
# blocks, which walk their steps. Since the backward's group kernel took
# the general path (`onehot.group_lane_classes`: the cases above at 1, 3,
# 48, 64 and 100 classes, 1 to 8 classes a lane, groups of 1 to 32 lanes,
# some of them without a class), more of it: 1 class in bfloat16, the
# mode without the mixture and sampled with it; 3 classes sampled without
# the mixture in both types (a lane a class, 4 lanes a group, one empty);
# 48 bfloat16 the mode with the mixture and float32 sampled without (4
# classes a lane, 12 of 16 lanes); 100 float32 the mode with the mixture
# (4 a lane, 25 of 32 lanes) and bfloat16 sampled without it; 200
# bfloat16 (8 a lane, 25 of 32 lanes) and 256 float32 (two 16-byte
# vectors a lane) sampled with the mixture; 255 bfloat16 (single values,
# 8 a lane, the last lane 7) sampled with it, on a grid capped at 1
# block; and past 8 classes a lane on a warp, the passes: 300
# classes, sampled with the mixture in bfloat16 and the mode in float32.
# Since the forward's group kernel took the general path too, the cases above
# run it each way (300 classes both ways on the passes), the forward at few
# values' classes a lane (`onehot.fwd_lane_classes`: the fewest of
# `onehot.GROUP_LANES` that fit a group in a warp); and more, with `wide`
# at the classes a lane of many values (GROUP_WIDE_LANES 0: the fewest idle
# places, 3 to 8): tied
# logits (`compare_onehot`'s `tied`: the largest from class C // 3 on, in
# several lanes, where the first must win) at 48 bfloat16 classes, the mode
# with the mixture (6 a lane, 16 tied classes from lane 2 of 8) and without
# it, 100 float32 classes sampled (4 a lane; tied logits, the noise choosing)
# and, at few values' 4 a lane, the mode, and 255 bfloat16 the mode; float32
# groups off 16 bytes, sampled with the mixture: 37 classes (single values, 3
# a lane, 16 lanes) and 6 (8-byte vectors, a lane a group, groups 24 bytes
# apart); grids capped below the groups: 48 bfloat16 classes sampled with the
# mixture on 33 rows of 8 groups in one block (6 a lane, 9 steps of 32
# groups), 200 float32 sampled with it on 9 rows of 4 groups in 2 blocks (8 a
# lane, 5 steps of 8 groups); and, many values' way, 3 classes in bfloat16
# sampled with the mixture (a lane a group), 100 bfloat16 sampled without it
# (4 a lane in 8-byte vectors) and 3 float32 tied, the mode (the tie inside a
# lane).
# Each as (dtype, rows, S, C, unimix, sample, blocks,
# lane_classes[, bwd_lane_classes[, tied[, wide]]]).
ONEHOT_CASES = (
    (torch.bfloat16, 5, 3, 32, 0.01, True, None, 8),
    (torch.float32, 7, 5, 8, 0.0, True, None, 8),
    (torch.bfloat16, 3, 4, 4, 0.01, False, None, 8),
    (torch.float32, 3, 3, 2, 0.01, True, None, 8),
    (torch.bfloat16, 33, 8, 16, 0.01, True, 2, 8),
    (torch.bfloat16, 32, 32, 32, 0.01, False, None, None),
    (torch.float32, 5, 3, 32, 0.01, True, None, 2),
    (torch.bfloat16, 3, 3, 2, 0.01, True, None, 2),
    (torch.bfloat16, 7, 3, 32, 0.01, True, None, 2),
    (torch.float32, 5, 3, 4, 0.0, False, None, 2),
    (torch.bfloat16, 17, 5, 8, 0.01, False, 1, 2),
    (torch.float32, 3, 5, 4, 0.01, True, None, 8),
    (torch.float32, 5, 3, 32, 0.0, True, None, 8, 2),
    (torch.bfloat16, 3, 3, 2, 0.01, True, None, 4),
    (torch.bfloat16, 9, 4, 32, 0.01, True, 1, 4),
    (torch.float32, 40, 8, 8, 0.01, True, 1, 8),
    (torch.float32, 9, 4, 32, 0.01, True, 1, 8, 4),
    (torch.float32, 3, 3, 2, 0.01, True, None, 8, 4),
    (torch.bfloat16, 7, 5, 3, 0.01, True, None, None),
    (torch.float32, 7, 5, 3, 0.01, True, None, None),
    (torch.bfloat16, 7, 5, 3, 0.01, False, None, None),
    (torch.float32, 7, 5, 3, 0.01, False, None, None),
    (torch.bfloat16, 5, 3, 48, 0.01, True, None, None),
    (torch.float32, 5, 3, 48, 0.01, True, None, None),
    (torch.bfloat16, 5, 3, 64, 0.01, True, None, None),
    (torch.float32, 5, 3, 64, 0.01, True, None, None),
    (torch.bfloat16, 5, 3, 64, 0.0, False, None, None),
    (torch.float32, 5, 3, 64, 0.0, False, None, None),
    (torch.float32, 4, 3, 1, 0.01, True, None, None),
    (torch.bfloat16, 33, 8, 100, 0.01, True, 2, None),
    (torch.bfloat16, 4, 3, 1, 0.0, False, None, None),
    (torch.bfloat16, 4, 3, 1, 0.01, True, None, None),
    (torch.bfloat16, 7, 5, 3, 0.0, True, None, None),
    (torch.float32, 7, 5, 3, 0.0, True, None, None),
    (torch.bfloat16, 5, 3, 48, 0.01, False, None, None),
    (torch.float32, 5, 3, 48, 0.0, True, None, None),
    (torch.float32, 5, 3, 100, 0.01, False, None, None),
    (torch.bfloat16, 5, 3, 100, 0.0, True, None, None),
    (torch.bfloat16, 3, 3, 200, 0.01, True, None, None),
    (torch.float32, 3, 3, 256, 0.01, True, None, None),
    (torch.bfloat16, 9, 4, 255, 0.01, True, 1, None),
    (torch.bfloat16, 3, 3, 300, 0.01, True, None, None),
    (torch.float32, 3, 3, 300, 0.01, False, None, None),
    (torch.bfloat16, 5, 3, 48, 0.01, False, None, None, None, True, True),
    (torch.bfloat16, 5, 3, 48, 0.0, False, None, None, None, True, True),
    (torch.float32, 5, 3, 100, 0.01, True, None, None, None, True, True),
    (torch.float32, 5, 3, 100, 0.0, False, None, None, None, True),
    (torch.bfloat16, 3, 3, 255, 0.01, False, None, None, None, True),
    (torch.float32, 5, 3, 37, 0.01, True, None, None, None, False, True),
    (torch.float32, 5, 3, 6, 0.01, True, None, None, None, False, True),
    (torch.bfloat16, 33, 8, 48, 0.01, True, 1, None, None, False, True),
    (torch.float32, 9, 4, 200, 0.01, True, 2, None),
    (torch.bfloat16, 7, 5, 3, 0.01, True, None, None, None, False, True),
    (torch.bfloat16, 5, 3, 100, 0.0, True, None, None, None, False, True),
    (torch.float32, 7, 5, 3, 0.0, False, None, None, None, True, True),
)


# Every case by name: the fused chain's (forward and backward, `CASES`),
# the rollouts' (`ROLLOUT_CASES`), `observe`'s own (`OBSERVE_CASES`),
# `layer_norm_act`'s and the optimizer's, as (kind, dtype, shape).
NAMES = {
    f'{kind}{i}-{str(dtype).split(".")[-1]}': (kind, dtype, case)
    for kind, cases in (('chain', CASES), ('rollout', ROLLOUT_CASES),
                        ('observe', OBSERVE_CASES))
    for i, (dtype, case) in enumerate(cases)}
NAMES.update({
    f'layer_norm{i}-{str(case[0]).split(".")[-1]}': (kind, case[0], case[1:])
    for i, (kind, case) in enumerate(
        [('layer_norm', case) for case in LAYER_NORM_CASES]
        + [('layer_norm_grid', case) for case in LAYER_NORM_GRID_CASES])})
NAMES.update({f'adam{i}-float32': ('adam', torch.float32, case)
              for i, case in enumerate(ADAM_CASES)})
NAMES.update({
    f'{kind}{i}-{str(case[0]).split(".")[-1]}': (kind, case[0], case[1:])
    for kind, cases in (('gru', GRU_CASES), ('onehot', ONEHOT_CASES))
    for i, case in enumerate(cases)})


def run_case(name):
  """Runs one case (call inside `emulated`); prints its line, ending in
  ': ok' or ': DISAGREES', and returns whether it agreed."""
  kind, dtype, case = NAMES[name]
  if kind in ('layer_norm', 'layer_norm_grid'):
    fwd_err, bwd_errs, same = compare_layer_norm(dtype, *case)
    # float32: the same arithmetic summed in another order. bfloat16: y
    # may round to the other side, one unit in the last place (2^-7 of
    # |y| in [1, 2)); in the first cases none does, and the backward in
    # float32 after the same roundings agrees as float32 does (a dn left
    # unrounded moves dx by 6e-3 of its scale). Over the grid's hundreds
    # of rows some dx in bfloat16 lands on the other side of a rounding:
    # one unit in the last place, up to 2^-7 of the largest |dx| (dx at
    # -0.6055 for -0.6016 at 32 rows of 768); dscale and dbias, float32,
    # stay within 1e-3.
    limits = (1e-5, (1e-4,) * 3) if dtype == torch.float32 else (
        2 ** -7, (2 ** -7 if kind == 'layer_norm_grid' else 1e-3, 1e-3, 1e-3))
    good = (fwd_err <= limits[0] and same
            and all(e <= lim for e, lim in zip(bwd_errs, limits[1])))
    print(f'{name} {dtype} C, rows, act, blocks, fwd_blocks, twice, cluster '
          f'{case}: '
          f'forward error {fwd_err:.3g} (tolerance {limits[0]:g} of '
          f'max(|y|, 1)), scaled backward errors dx, dscale, dbias '
          f'{", ".join(f"{e:.3g}" for e in bwd_errs)} (tolerances '
          f'{", ".join(f"{e:g}" for e in limits[1])}), runs equal and '
          f'counters zero {same}: {"ok" if good else "DISAGREES"}',
          flush=True)
    return good
  if kind == 'gru':
    fwd_err, bwd_errs, same = compare_gru(dtype, *case)
    # float32: the same arithmetic in another order, with the card's (here
    # the C library's) exp and tanh. bfloat16: a norm output or a gate may
    # round to the other side, one unit in the last place (2^-8 of a value
    # in [1, 2)), and the rounded chain carries it to the new deter; the
    # backward in float32 after the same roundings, whose row sums a
    # flipped rounding moves (as layer_norm_act's grid cases).
    limits = (1e-5, (1e-4, 1e-4, 1e-4, 1e-4)) if dtype == torch.float32 else (
        2 ** -7, (2 ** -6, 2 ** -7, 1e-2, 1e-2))
    good = (fwd_err <= limits[0] and same
            and all(e <= lim for e, lim in zip(bwd_errs, limits[1])))
    print(f'{name} {dtype} D, rows, fwd_blocks, cluster, blocks, lanes, '
          f'fwd_lanes[, normed, wide] {case}: forward '
          f'error {fwd_err:.3g} (tolerance {limits[0]:g} of max(|y|, 1)), '
          f'scaled backward errors dx, ddeter, dscale, dbias '
          f'{", ".join(f"{e:.3g}" for e in bwd_errs)} (tolerances '
          f'{", ".join(f"{e:g}" for e in limits[1])}), two runs '
          f'each way equal and counters zero {same}: '
          f'{"ok" if good else "DISAGREES"}', flush=True)
    return good
  if kind == 'onehot':
    logit_err, (flips, ties), stoch_err, grad_err, same = compare_onehot(
        dtype, *case)
    # Where the case ties the logits on purpose, the first of the tied
    # classes must win, as torch.argmax picks it: no choice may differ.
    ties = ties and not (len(case) > 8 and case[8] and flips)
    # float32: the same arithmetic with the card's (here the C library's)
    # exp and log. bfloat16: a logit of the mixture may round to the other
    # side (2^-8 of its size); stoch rounds 1 + p - p to 1 either way, and
    # the backward's float32 sums after the same roundings agree as
    # float32 does but where a rounding to bfloat16 falls the other way.
    limits = (1e-5, 1e-6, 1e-4) if dtype == torch.float32 else (
        2 ** -7, 2 ** -8, 2e-2)
    good = (logit_err <= limits[0] and ties and stoch_err <= limits[1]
            and grad_err <= limits[2] and same)
    print(f'{name} {dtype} rows, S, C, unimix, sample, blocks, '
          f'lane_classes[, bwd_lane_classes[, tied[, wide]]] {case}: '
          f'logit error '
          f'{logit_err:.3g} (tolerance {limits[0]:g} of max(|logit|, 1)), '
          f'{flips} groups choose another class, all ties {ties}, stoch '
          f'error elsewhere {stoch_err:.3g} (tolerance {limits[1]:g}), '
          f'scaled gradient error {grad_err:.3g} (tolerance {limits[2]:g}),'
          f' two runs each way equal {same}: '
          f'{"ok" if good else "DISAGREES"}', flush=True)
    return good
  if kind == 'adam':
    rel, same = compare_adam(*case)
    good = same and rel <= 1e-6
    print(f'{name} sizes, decayed, warmup {case}: norm relative error '
          f'{rel:.3g} (tolerance 1e-6), update equal bit for bit and a NaN '
          f'gradient changes nothing {same}: '
          f'{"ok" if good else "DISAGREES"}', flush=True)
    return good
  if kind == 'chain':
    equal, fwd_err, bwd_err = compare(dtype, **case)
    # float32 arithmetic on both sides, summed in another order.
    good = equal and fwd_err <= 1e-4 and bwd_err <= 1e-4
    print(f'{name} {dtype} {case}: stochs equal {equal}, forward error '
          f'{fwd_err:.3g}, scaled backward error {bwd_err:.3g} '
          f'(tolerance 1e-4): {"ok" if good else "DISAGREES"}', flush=True)
    return good
  compare_fn = compare_rollouts if kind == 'rollout' else compare_observe
  equal, err = compare_fn(dtype, **case)
  # float32: the same arithmetic summed in another order. bfloat16: a sum
  # that rounds to the other side moves a value by one unit in the last
  # place (2^-8 of its size) and the next layers carry it on. `observe`'s
  # own cases hold bfloat16 to float32's limit: at their widths and inputs
  # no sum of either route lands on the other side of a rounding (the
  # largest error is 2.4e-7), while a rounding that the kernel drops or
  # adds moves its logits by 2.8e-3 or more.
  limit = 1e-4 if dtype == torch.float32 or kind == 'observe' else 5e-2
  good = equal and err <= limit
  print(f'{name} {dtype} {case}: one-hots equal {equal}, largest error of '
        f'deters and logits {err:.3g} (tolerance {limit:g}): '
        f'{"ok" if good else "DISAGREES"}', flush=True)
  return good


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
  parser.add_argument('--out', default=None,
                      help='Build directory, made if missing; libraries '
                      'already there for the same sources are loaded.')
  parser.add_argument('--case', action='append', choices=NAMES,
                      help='Run this case (repeats; default: all).')
  parser.add_argument('--list', action='store_true',
                      help='Print the cases\' names and stop.')
  parser.add_argument('--build-only', action='store_true',
                      help='Build the libraries (those of the --case '
                      'cases, where given) and stop.')
  args = parser.parse_args(argv)
  if args.list:
    print('\n'.join(NAMES))
    return 0
  torch.set_num_threads(1)
  with contextlib.ExitStack() as stack:
    outdir = args.out or stack.enter_context(tempfile.TemporaryDirectory())
    try:
      stack.enter_context(emulated(
          outdir, sources(args.case) if args.case else None))
    except Unavailable as e:
      print(f'emulate: cannot run here: {e}', file=sys.stderr)
      return CANNOT_RUN
    if args.build_only:
      return 0
    results = [run_case(name) for name in args.case or NAMES]
  return 0 if all(results) else 1


if __name__ == '__main__':
  sys.exit(main())

"""Build and load the port's CUDA kernels.

Each kernel is one CUDA C++ source under `ops/csrc/` with a plain C
interface. `nvcc` compiles it for `sm_90a` into a shared library, at first
use, into `ops/_build/` (listed in `.gitignore`); `ctypes` loads it. The
library's name carries a hash of the source and of the headers under
`ops/csrc/` that it includes, so an edit of either builds anew. `build_all()` starts one `nvcc` per source, all at once.

Every kernel's C function takes `(int bf16, void* const* ptrs, const int*
dims, float..., void* stream)` and returns `cudaGetLastError()`; `check`
holds the tensors to what a kernel reads and `launch` makes the call.

Two kernels may share one source and its library (`shares`): each keeps
its own launch count. A kernel's source may have `parts`, further sources
that nvcc compiles beside it, one process each, into objects linked into
its library: a source with many instantiations builds in the time of its
longest part.

A launch is counted on its kernel (`count`). While a CUDA graph is being
captured on the calling thread's stream nothing launches: the call is
recorded for the graph instead (`take_captured`), and the graph's runner
credits it to the kernel at every replay (`credit`), so a kernel's count
is the number of times the card ran it either way.
"""

import collections
import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

HERE = pathlib.Path(__file__).resolve().parent
CSRC = HERE / 'csrc'
BUILD = HERE / '_build'
ARCH = ['-gencode', 'arch=compute_90a,code=sm_90a']
FLAGS = [*ARCH, '-std=c++17', '-O3', '-shared', '-Xcompiler', '-fPIC',
         '-Xptxas', '-v']


def nvcc():
  home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
  path = shutil.which('nvcc') or os.path.join(home, 'bin', 'nvcc')
  if not os.path.exists(path):
    raise RuntimeError('nvcc not found: the CUDA kernels build only on a '
                       'machine with the CUDA toolkit.')
  return path


class Kernel:
  """One CUDA source, its library, and its launch count.

  `launches` is the number of times a wrapper launched the kernel; a
  caller may reset it to 0 before a run and read it after."""

  route = 'cuda'

  def __init__(self, name, source, replaces, signature=None, headers=(),
               shares=None, parts=()):
    self.name = name
    self.source = CSRC / source
    self.parts = [CSRC / part for part in parts]
    self.headers = [CSRC / header for header in headers]
    self.replaces = replaces
    self.signature = signature  # {C function: (restype, argtypes)}
    self.shares = shares  # The kernel whose library holds this one.
    self.launches = 0
    self._lib = None
    self._lock = threading.Lock()
    if shares is not None:
      self.headers, self.signature = shares.headers, shares.signature

  def digest(self):
    """A hash of the source, its parts and the headers they include."""
    digest = hashlib.sha256(self.source.read_bytes())
    for header in self.parts + self.headers:
      digest.update(header.read_bytes())
    return digest.hexdigest()[:12]

  @property
  def library(self):
    if self.shares is not None:
      return self.shares.library
    return BUILD / f'lib{self.name}_{self.digest()}.so'

  def start_build(self):
    """Start nvcc unless the library exists (or is another kernel's to
    build); returns the process or None."""
    if self.library.exists() or self.shares is not None:
      return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = self.library.with_suffix(f'.{os.getpid()}.tmp')
    log = open(self.library.with_suffix('.log'), 'w')
    if self.parts:
      proc = _Parts(self.source, self.parts, tmp, log)
    else:
      proc = subprocess.Popen(
          [nvcc(), *FLAGS, '-o', str(tmp), str(self.source)],
          stdout=log, stderr=subprocess.STDOUT)
    proc.tmp, proc.log = tmp, log
    return proc

  @staticmethod
  def finish_build(proc):
    if proc is None:
      return
    code = proc.wait()
    proc.log.close()
    log = pathlib.Path(proc.log.name)
    if code != 0:
      raise RuntimeError(f'nvcc failed ({code}):\n{log.read_text()}')
    os.replace(proc.tmp, log.with_suffix('.so'))

  def lib(self):
    if self.shares is not None:
      return self.shares.lib()
    with self._lock:
      if self._lib is None:
        self.finish_build(self.start_build())
        lib = ctypes.CDLL(str(self.library))
        for fn, (restype, argtypes) in self.signature.items():
          getattr(lib, fn).restype = restype
          getattr(lib, fn).argtypes = argtypes
        self._lib = lib
    return self._lib

  def build_log(self):
    log = self.library.with_suffix('.log')
    return log.read_text() if log.exists() else ''


class _Parts:
  """The nvcc processes of a source and its parts, one object each, and
  their link into the library once all are done: `poll` and `wait` as a
  process has them."""

  def __init__(self, source, parts, tmp, log):
    self.objects = [tmp.with_suffix(f'.{i}.o') for i in range(len(parts) + 1)]
    flags = [f for f in FLAGS if f != '-shared']
    self.procs = [
        subprocess.Popen([nvcc(), *flags, '-c', '-o', str(obj), str(src)],
                         stdout=log, stderr=subprocess.STDOUT)
        for obj, src in zip(self.objects, [source, *parts])]
    self.tmp, self.log = tmp, log

  def poll(self):
    codes = [proc.poll() for proc in self.procs]
    return None if None in codes else max(codes, key=abs)

  def wait(self):
    code = max((proc.wait() for proc in self.procs), key=abs)
    if code == 0:
      code = subprocess.run(
          [nvcc(), *ARCH, '-shared', '-o', str(self.tmp),
           *map(str, self.objects)],
          stdout=self.log, stderr=subprocess.STDOUT).returncode
    for obj in self.objects:
      obj.unlink(missing_ok=True)
    return code


class TritonKernel:
  """A kernel written in Triton, registered beside the CUDA ones: its name,
  the file that holds it, the TPU kernel it replaces and its launch count.
  Triton compiles it at its first launch, so there is nothing to build."""

  route = 'triton'

  def __init__(self, name, source, replaces):
    self.name = name
    self.source = HERE / source
    self.replaces = replaces
    self.launches = 0

  def start_build(self):
    return None

  def lib(self):
    return None

  def build_log(self):
    return ''


def signature(scalars=1):
  """(restype, argtypes) of a kernel's C function with `scalars` floats."""
  return (ctypes.c_int, [
      ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
      ctypes.POINTER(ctypes.c_int), *[ctypes.c_float] * scalars,
      ctypes.c_void_p])


def check(name, tensors, device, dtype, align=16):
  """Raises unless every (key, tensor) is a contiguous, `align`-byte
  aligned tensor of `dtype` on the card `device`."""
  for key, x in tensors:
    if x.device != device or x.device.type != 'cuda':
      raise ValueError(f'{name}: {key} lies on {x.device}, not on a card.')
    if x.dtype != dtype:
      raise TypeError(f'{name}: {key} is {x.dtype} among {dtype}.')
    if not x.is_contiguous():
      raise ValueError(f'{name}: {key} is not contiguous.')
    if x.data_ptr() % align:
      raise ValueError(f'{name}: {key} is not aligned to {align} bytes.')


def launch(kernel, fn, dtype, ptrs, dims, scalars, device):
  """Launches `fn` of `kernel` on the current stream of `device`, raises
  if the launch is refused, and counts it. ptrs: tensors or None."""
  ptr_array = (ctypes.c_void_p * len(ptrs))(
      *[x.data_ptr() if x is not None else 0 for x in ptrs])
  dims = (ctypes.c_int * len(dims))(*dims)
  lib = kernel.lib()
  stream = torch.cuda.current_stream(device).cuda_stream
  err = getattr(lib, fn)(int(dtype == torch.bfloat16), ptr_array, dims,
                         *[float(x) for x in scalars],
                         ctypes.c_void_p(stream))
  if err != 0:
    raise RuntimeError(f'{fn} kernel failed: CUDA error {err}.')
  count(kernel)


# Launches recorded into the CUDA graph being captured: {kernel: calls}.
_CAPTURED = collections.Counter()


def count(kernel):
  """One launch of `kernel` on the current stream: counted, or recorded
  for the graph when that stream is capturing one."""
  if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
    _CAPTURED[kernel] += 1
  else:
    kernel.launches += 1


def take_captured():
  """The launches recorded since the last call, {kernel: calls}, and
  forget them: what one replay of the graph just captured launches."""
  taken = dict(_CAPTURED)
  _CAPTURED.clear()
  return taken


def credit(captured, times=1):
  """Count the launches of `times` replays of a graph that `captured`."""
  for kernel, calls in captured.items():
    kernel.launches += calls * times


_PLAIN = [0]


@contextlib.contextmanager
def plain_versions():
  """Within the block the wrappers of `ops/norm.py` and `ops/adam.py` run
  their plain versions on a card too, as PyTorch ops under autograd. For
  the tests and `chip_smoke.py`, which hold the kernels' path against the
  plain one; nothing else calls it."""
  _PLAIN[0] += 1
  try:
    yield
  finally:
    _PLAIN[0] -= 1


def plain():
  """Whether `plain_versions` is open."""
  return _PLAIN[0] > 0


_COUNTERS = {}


def counters(name, device, n):
  """The `n` int32 counters of the kernel `name` on `device`: zeros, made
  once and kept, so that their address is the same in every launch and
  every graph. The kernel leaves them ready for its next launch (a ticket
  or an arrival count back at zero); launches on one card share them,
  since the port runs a kernel on one stream at a time. Made outside any
  capture: a capture that would make them raises."""
  key = (name, str(device))
  if key not in _COUNTERS:
    if (device.type == 'cuda' and torch.cuda.is_available()
        and torch.cuda.is_current_stream_capturing()):
      raise RuntimeError(
          f'{name}: its counters are made at the first eager launch on '
          f'{device}; a CUDA graph capture cannot make them.')
    made = torch.zeros(n, dtype=torch.int32, device=device)
    if device.type == 'cuda':
      torch.cuda.synchronize(device)
    _COUNTERS[key] = made
  return _COUNTERS[key]


# A block's dynamic shared memory on sm_90a.
SHARED_MEMORY_LIMIT = 232448

KERNELS = []


def register(kernel):
  KERNELS.append(kernel)
  return kernel


def build_all(kernels=None):
  """Build every kernel with one nvcc per source, started together."""
  kernels = KERNELS if kernels is None else kernels
  procs = [k.start_build() for k in kernels]
  for proc in procs:
    Kernel.finish_build(proc)
  return [k.lib() for k in kernels]

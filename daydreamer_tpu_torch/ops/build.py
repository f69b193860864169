"""Build and load the port's CUDA kernels.

Each kernel is one CUDA C++ source under `ops/csrc/` with a plain C
interface. `nvcc` compiles it for `sm_90a` into a shared library, at first
use, into `ops/_build/` (listed in `.gitignore`); `ctypes` loads it. The
library's name carries a hash of the source and of the headers under
`ops/csrc/` that it includes, so an edit of either builds anew. `build_all()` starts one `nvcc` per source, all at once.
"""

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

HERE = pathlib.Path(__file__).resolve().parent
CSRC = HERE / 'csrc'
BUILD = HERE / '_build'
FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
         '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']


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

  def __init__(self, name, source, replaces, signature, headers=()):
    self.name = name
    self.source = CSRC / source
    self.headers = [CSRC / header for header in headers]
    self.replaces = replaces
    self.signature = signature  # {C function: (restype, argtypes)}
    self.launches = 0
    self._lib = None
    self._lock = threading.Lock()

  @property
  def library(self):
    digest = hashlib.sha256(self.source.read_bytes())
    for header in self.headers:
      digest.update(header.read_bytes())
    digest = digest.hexdigest()[:12]
    return BUILD / f'lib{self.name}_{digest}.so'

  def start_build(self):
    """Start nvcc unless the library exists; returns the process or None."""
    if self.library.exists():
      return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = self.library.with_suffix(f'.{os.getpid()}.tmp')
    log = open(self.library.with_suffix('.log'), 'w')
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

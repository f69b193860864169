"""On-demand g++ build + ctypes loading of the native components.

Builds into `native/_build/` (listed in `.gitignore`), never next to the
sources. Rebuilds when the source is newer than the cached .so; safe to
call from multiple processes (build into a temp file then atomic-rename).
"""

import ctypes
import os
import pathlib
import subprocess
import tempfile

_DIR = pathlib.Path(__file__).parent
BUILD = _DIR / '_build'
_CACHE = {}

SOURCES = {
    'robot_interface': ('robot_interface.cpp', []),
    'fastcopy': ('fastcopy.cpp', ['-pthread']),
    'qp_solver': ('qp_solver.cpp', []),
}


def build(name):
  src_name, extra = SOURCES[name]
  src = _DIR / src_name
  lib = BUILD / f'lib{name}.so'
  if not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime:
    BUILD.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=str(BUILD))
    os.close(fd)
    cmd = ['g++', '-O2', '-shared', '-fPIC', *extra, '-o', tmp, str(src)]
    try:
      subprocess.run(cmd, check=True, capture_output=True, text=True)
      os.replace(tmp, lib)
    except subprocess.CalledProcessError as e:
      os.unlink(tmp)
      raise RuntimeError(f'native build failed: {e.stderr}') from e
    except BaseException:
      if os.path.exists(tmp):
        os.unlink(tmp)
      raise
  return lib


def load(name):
  if name in _CACHE:
    return _CACHE[name]
  lib = ctypes.CDLL(str(build(name)))
  _configure(name, lib)
  _CACHE[name] = lib
  return lib


def _configure(name, lib):
  c = ctypes
  if name == 'robot_interface':
    lib.a1_create.restype = c.c_void_p
    lib.a1_create.argtypes = [c.c_char_p, c.c_int, c.c_int, c.c_int]
    lib.a1_create_wire.restype = c.c_void_p
    lib.a1_create_wire.argtypes = [
        c.c_char_p, c.c_int, c.c_int, c.c_int, c.c_int]
    lib.a1_pack_lowcmd.restype = c.c_int
    lib.a1_pack_lowcmd.argtypes = [c.POINTER(c.c_float), c.c_char_p]
    lib.a1_pack_lowstate.restype = c.c_int
    lib.a1_pack_lowstate.argtypes = [c.POINTER(c.c_float), c.c_char_p]
    lib.a1_parse_lowstate.restype = c.c_int
    lib.a1_parse_lowstate.argtypes = [
        c.c_char_p, c.c_int, c.POINTER(c.c_float)]
    lib.a1_set_power_protect.argtypes = [c.c_void_p, c.c_float]
    lib.a1_safety_clamp.argtypes = [c.c_void_p, c.POINTER(c.c_float)]
    lib.a1_send_command.restype = c.c_int
    lib.a1_send_command.argtypes = [c.c_void_p, c.POINTER(c.c_float)]
    lib.a1_receive_observation.restype = c.c_int
    lib.a1_receive_observation.argtypes = [c.c_void_p, c.POINTER(c.c_float)]
    lib.a1_stats.argtypes = [
        c.c_void_p, c.POINTER(c.c_uint64), c.POINTER(c.c_uint64),
        c.POINTER(c.c_uint64)]
    lib.a1_destroy.argtypes = [c.c_void_p]
  elif name == 'fastcopy':
    lib.fast_gather.argtypes = [
        c.POINTER(c.c_char_p), c.POINTER(c.c_int64), c.POINTER(c.c_int64),
        c.c_int64, c.c_char_p, c.c_int]
  elif name == 'qp_solver':
    lib.qp_solve_box.restype = c.c_int
    lib.qp_solve_box.argtypes = [
        c.POINTER(c.c_double), c.POINTER(c.c_double),
        c.POINTER(c.c_double), c.POINTER(c.c_double), c.c_int,
        c.POINTER(c.c_double), c.c_int, c.c_double, c.c_double]
    lib.qp_solve.restype = c.c_int
    lib.qp_solve.argtypes = [
        c.POINTER(c.c_double), c.POINTER(c.c_double),
        c.POINTER(c.c_double), c.POINTER(c.c_double),
        c.POINTER(c.c_double), c.c_int, c.c_int,
        c.POINTER(c.c_double), c.c_int, c.c_double, c.c_double]

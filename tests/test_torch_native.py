"""The port's native components against the JAX package's, on the CPU.

Both packages compile the same C++ sources with the same g++ flags, so the
same inputs must give the same outputs bit for bit: every comparison here
is `np.array_equal` (or equality of bytes), no tolerance. The port builds
into `daydreamer_tpu_torch/native/_build/`, the JAX package next to its
sources.
"""

import ctypes

import numpy as np
import pytest

from daydreamer_tpu import native as jnative
from daydreamer_tpu import replay as jreplay
from daydreamer_tpu.native import qp as jqp
from daydreamer_tpu.replay import batcher as jbatcher
from daydreamer_tpu_torch import native as pnative
from daydreamer_tpu_torch import replay as preplay
from daydreamer_tpu_torch.native import qp as pqp
from daydreamer_tpu_torch.replay import batcher as pbatcher

LOWCMD_SIZE = 730
LOWSTATE_SIZE = 891


def test_libraries_build_under_build_dir():
  from daydreamer_tpu_torch.native.build import BUILD, SOURCES, _DIR, build
  for name in SOURCES:
    lib = build(name)
    assert lib.parent == BUILD, lib
    assert lib.exists()
  assert BUILD == _DIR / '_build'


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_box_qp_matches_jax(seed):
  rng = np.random.default_rng(seed)
  n = 4 + seed
  M = rng.normal(size=(n, n))
  P = M @ M.T + np.eye(n)
  q = rng.normal(size=n)
  lo, hi = -0.5 * np.ones(n), 0.5 * np.ones(n)
  x, iters = pqp.solve_box_qp(P, q, lo, hi)
  x_ref, iters_ref = jqp.solve_box_qp(P, q, lo, hi)
  assert iters == iters_ref
  assert np.array_equal(x, x_ref)


@pytest.mark.parametrize('seed', [0, 1])
def test_general_qp_matches_jax(seed):
  rng = np.random.default_rng(seed)
  n, m = 6, 4
  M = rng.normal(size=(n, n))
  P = M @ M.T + np.eye(n)
  q = rng.normal(size=n)
  A = rng.normal(size=(m, n))
  b = rng.normal(size=m)
  lo = np.concatenate([b[:2], [-1e20, -1e20]])
  hi = np.concatenate([b[:2], b[2:] + 0.1])
  x, iters = pqp.solve_qp(P, q, A, lo, hi)
  x_ref, iters_ref = jqp.solve_qp(P, q, A, lo, hi)
  assert iters == iters_ref
  assert np.array_equal(x, x_ref)


def _command(seed):
  rng = np.random.default_rng(seed)
  cmd = np.zeros((12, 5), np.float32)
  cmd[:, 0] = rng.uniform(-2, 2, 12)
  cmd[:, 1] = rng.uniform(-5, 5, 12)
  cmd[:, 2] = rng.uniform(0, 80, 12)
  cmd[:, 3] = rng.uniform(0, 2, 12)
  cmd[:, 4] = rng.uniform(-40, 40, 12)
  return cmd


@pytest.mark.parametrize('seed', [0, 1])
def test_lowcmd_bytes_match_jax(seed):
  cmd = _command(seed)
  packets = []
  for lib in (pnative.load('robot_interface'),
              jnative.load('robot_interface')):
    buf = (ctypes.c_float * 60)(*cmd.reshape(-1))
    packet = ctypes.create_string_buffer(LOWCMD_SIZE)
    assert lib.a1_pack_lowcmd(buf, packet) == LOWCMD_SIZE
    packets.append(packet.raw)
  assert packets[0] == packets[1]


def test_lowstate_pack_and_parse_match_jax():
  rng = np.random.default_rng(3)
  obs = rng.uniform(-3, 3, 50).astype(np.float32)
  obs[46:50] = rng.integers(0, 100, 4)  # int16 foot forces.
  libs = (pnative.load('robot_interface'), jnative.load('robot_interface'))
  packets, parsed = [], []
  for lib in libs:
    packet = ctypes.create_string_buffer(LOWSTATE_SIZE)
    assert lib.a1_pack_lowstate(
        obs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        packet) == LOWSTATE_SIZE
    packets.append(packet.raw)
  assert packets[0] == packets[1]
  bad = bytearray(packets[0])
  bad[100] ^= 0xFF
  for lib in libs:
    out = (ctypes.c_float * 50)()
    assert lib.a1_parse_lowstate(packets[0], LOWSTATE_SIZE, out) == 1
    parsed.append(np.ctypeslib.as_array(out).copy())
    assert lib.a1_parse_lowstate(bytes(bad), LOWSTATE_SIZE, out) == -1
  assert np.array_equal(parsed[0], parsed[1])


def test_safety_clamp_matches_jax():
  cmd = _command(4)
  cmd[0, 0] = np.nan
  outs = []
  for lib in (pnative.load('robot_interface'),
              jnative.load('robot_interface')):
    handle = lib.a1_create(b'127.0.0.1', 0, 0, 10)
    buf = (ctypes.c_float * 60)(*cmd.reshape(-1))
    lib.a1_safety_clamp(handle, buf)
    outs.append(np.ctypeslib.as_array(buf).copy())
    lib.a1_destroy(handle)
  assert np.array_equal(outs[0], outs[1])


def _trees(seed, n=5):
  rng = np.random.default_rng(seed)
  return [{'a': rng.normal(size=(3, 7)).astype(np.float32),
           'b': rng.integers(0, 255, (4, 4, 3), np.uint8),
           'c': np.float64(rng.normal()),
           'd': rng.normal(size=(2, 5))[:, ::2]}  # Not contiguous.
          for _ in range(n)]


@pytest.mark.parametrize('seed', [0, 1])
def test_native_stack_matches_np_stack_and_jax(seed):
  trees = _trees(seed)
  got = pbatcher.native_stack(trees)
  ref = jbatcher.native_stack(trees)
  assert pbatcher._STACK_LIB is not None
  assert set(got) == set(trees[0])
  for key in trees[0]:
    expect = np.stack([t[key] for t in trees])
    assert got[key].dtype == expect.dtype and np.array_equal(got[key], expect)
    assert np.array_equal(got[key], ref[key])


def test_native_stack_numpy_fallback(monkeypatch):
  monkeypatch.setattr(pbatcher, '_STACK_LIB', None)
  monkeypatch.setattr(pbatcher, '_STACK_LIB_TRIED', True)
  trees = _trees(2)
  got = pbatcher.native_stack(trees)
  for key in trees[0]:
    assert np.array_equal(got[key], np.stack([t[key] for t in trees]))


def _fill(lib, chunk, episodes=4, seed=0):
  rng = np.random.default_rng(seed)
  replay = lib.FixedLength(lib.RAMStore(), chunk=chunk)
  for ep in range(episodes):
    length = 6 + 3 * ep
    for t in range(length):
      replay.add({
          'action': rng.normal(size=3).astype(np.float32),
          'vector': rng.normal(size=(2, 4)).astype(np.float32),
          'image': rng.integers(0, 255, (5, 5, 3), np.uint8),
          'reward': np.float32(rng.normal()),
          'is_first': t == 0, 'is_last': t == length - 1,
          'is_terminal': False})
  return replay


@pytest.mark.parametrize('seed', [0, 3])
def test_native_batcher_matches_jax(seed):
  port = pbatcher.NativeBatcher(_fill(preplay, 5), batch_size=6, seed=seed)
  ref = jbatcher.NativeBatcher(_fill(jreplay, 5), batch_size=6, seed=seed)
  assert port._lib is not None
  for _ in range(3):
    got, want = next(port), next(ref)
    assert set(got) == set(want)
    for key in want:
      assert got[key].dtype == want[key].dtype, key
      assert np.array_equal(got[key], want[key]), key
  assert got['action'].shape == (6, 5, 3)
  assert got['is_first'][:, 0].all() and not got['is_first'][:, 1:].any()


def test_native_batcher_memmove_fallback():
  """Without the library the batcher copies with ctypes.memmove; the
  batches are the same."""
  fast = pbatcher.NativeBatcher(_fill(preplay, 4, seed=1), 5, seed=7)
  slow = pbatcher.NativeBatcher(_fill(preplay, 4, seed=1), 5, seed=7)
  slow._lib = None
  for _ in range(2):
    a, b = next(fast), next(slow)
    for key in a:
      assert np.array_equal(a[key], b[key]), key

"""The CUDA sources themselves, compiled with g++ against the stand-in
headers (`ops/emulate.py`), agree with the plain versions at tiny widths in
float32 and bfloat16: one test per case of `emulate.NAMES`. This file holds
the fused observe chain's cases (`observe_fwd.cu`, `observe_bwd.cu`) and
the machinery that the other files of the emulated cases share, one file a
source or a group of sources, so that the workers of a test run that
distributes by file share the cases:
`test_torch_emulate_rollout.py` (`imagine_actor.cu`, `imagine.cu`,
`observe.cu`), `test_torch_emulate_update.py` (`layer_norm.cu`,
`adam.cu`), `test_torch_emulate_gru.py` (`gru.cu`) and
`test_torch_emulate_onehot.py` (`onehot.cu`).

Each file's sources are built once for the module, into a directory that
every case of the file loads them from. Each case runs in a process of its
own at a lower priority, with a time limit of its own: a cluster's 4096
CUDA threads are fibers of one OS thread there, and a case that hangs or
crashes takes only its own test with it."""

import os
import subprocess
import sys

import pytest

from daydreamer_tpu_torch.ops import emulate

# Seconds a case may take. With the cases in one file run alone on an
# 8-core machine the longest case took 13 s and the build of all nine
# sources 7 s; the margin covers a machine crowded by the other workers of
# the test run. The cases of `gru.cu` and `onehot.cu` (the largest, the GRU
# backward's cooperative grid of 19 blocks, 4 864 fibers side by side) took
# 3.0-4.7 s each so, most of it the process's start, and the build of all
# nine sources about 20 s beside three other workers.
BUILD_LIMIT = 600
CASE_LIMIT = 300


def _emulate(*args, timeout):
  return subprocess.run(
      [sys.executable, '-m', 'daydreamer_tpu_torch.ops.emulate', *args],
      capture_output=True, text=True, timeout=timeout,
      preexec_fn=lambda: os.nice(10))


def cases(*kinds):
  """The names of the cases of these kinds, in `emulate.NAMES`' order."""
  return [name for name, (kind, _, _) in emulate.NAMES.items()
          if kind in kinds]


def build_libraries(tmp_path_factory, names):
  """A directory with the libraries of the sources that the cases `names`
  run, built once."""
  out = tmp_path_factory.mktemp('emulated')
  done = _emulate('--out', str(out), '--build-only',
                  *[arg for name in names for arg in ('--case', name)],
                  timeout=BUILD_LIMIT)
  if done.returncode == emulate.CANNOT_RUN:
    pytest.skip(f'No g++ with C++20 here: {done.stderr[-200:]}')
  assert done.returncode == 0, done.stdout + done.stderr
  return out


def run_case(libraries, case):
  """Runs one case in a process of its own on the module's libraries."""
  built = sorted(libraries.glob('*.so'))
  done = _emulate('--out', str(libraries), '--case', case,
                  timeout=CASE_LIMIT)
  assert done.returncode == 0, done.stdout + done.stderr
  assert done.stdout.count(': ok') == 1, done.stdout
  # The case loaded the module's libraries and built none of its own.
  assert sorted(libraries.glob('*.so')) == built


CASES = cases('chain')


@pytest.fixture(scope='module')
def libraries(tmp_path_factory):
  return build_libraries(tmp_path_factory, CASES)


@pytest.mark.parametrize('case', CASES)
def test_cuda_source_emulated_on_cpu(libraries, case):
  run_case(libraries, case)

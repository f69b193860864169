"""The GRU cell's CUDA source (`gru.cu`), compiled with g++ against the stand-
in headers, held to the plain versions at tiny widths: one test per case,
as `tests/test_torch_emulate_cases.py` runs them (its machinery), on
libraries of these sources alone."""

import pytest

from test_torch_emulate_cases import build_libraries, cases, run_case

CASES = cases('gru')


@pytest.fixture(scope='module')
def libraries(tmp_path_factory):
  return build_libraries(tmp_path_factory, CASES)


@pytest.mark.parametrize('case', CASES)
def test_cuda_source_emulated_on_cpu(libraries, case):
  run_case(libraries, case)

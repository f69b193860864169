"""The CPU stand-ins of the tensor-core operations (`ops/csrc/emulate/
ptx.h`), held to a plain float32 product: the emulation of a kernel
(`ops/emulate.py`) checks its fragment indices only as far as the stand-ins
lay their fragments out as the hardware does."""

import numpy as np
import pytest
import torch

from daydreamer_tpu_torch.ops import emulate


@pytest.fixture(scope='module')
def selftest(tmp_path_factory):
  try:
    return emulate.compile_selftest(tmp_path_factory.mktemp('ptx'))
  except emulate.Unavailable as e:
    pytest.skip(f'No g++ with C++20 here: {str(e)[-200:]}')


def _bf16(rng, shape):
  """Random bfloat16 values as (their bit patterns, their float32 values)."""
  x = torch.as_tensor(rng.standard_normal(shape).astype(np.float32))
  x = x.to(torch.bfloat16)
  return x.view(torch.int16).contiguous(), x.float()


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_mma_stand_in_matches_float32_product(selftest, seed):
  """Fragments filled element by element as the PTX ISA lays them out:
  d = a @ b for a [16][16] and b [16][8]. bf16 x bf16 products are exact in
  float32, so only the order of 16 additions differs: 1e-5."""
  rng = np.random.default_rng(seed)
  (a_bits, a), (b_bits, b) = _bf16(rng, (16, 16)), _bf16(rng, (16, 8))
  d = torch.full((16, 8), float('nan'))
  selftest.mma_fragments(a_bits.data_ptr(), b_bits.data_ptr(), d.data_ptr())
  assert (d - a @ b).abs().max() <= 1e-5


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_ldmatrix_stand_in_feeds_the_swapped_product(selftest, seed):
  """The kernel's own use: a weight tile w [k][n] and a vector x [k][row],
  both through transposed ldmatrix loads, give d[n][row] = (w^T x)."""
  rng = np.random.default_rng(seed)
  (w_bits, w), (x_bits, x) = _bf16(rng, (16, 16)), _bf16(rng, (16, 8))
  d = torch.full((16, 8), float('nan'))
  selftest.mma_ldmatrix(w_bits.data_ptr(), x_bits.data_ptr(), d.data_ptr())
  assert (d - w.t() @ x).abs().max() <= 1e-5

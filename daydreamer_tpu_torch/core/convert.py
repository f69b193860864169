"""Canonical dtype coercion for transitions (reference: embodied/core/convert.py:4-23).

Floats become float32, signed ints int32 (int32 keeps host<->device transfers
cheap on TPU; the reference used int64 which XLA would immediately downcast),
uint8 and bool pass through.
"""

import numpy as np

CONVERSION = {
    np.floating: np.float32,
    np.signedinteger: np.int32,
    np.uint8: np.uint8,
    bool: bool,
}


def convert(value):
  value = np.asarray(value)
  if value.dtype not in CONVERSION.values():
    for src, dst in CONVERSION.items():
      if np.issubdtype(value.dtype, src):
        if value.dtype != dst:
          value = value.astype(dst)
        break
    else:
      raise TypeError(f'Cannot convert dtype {value.dtype} of {value}.')
  return value

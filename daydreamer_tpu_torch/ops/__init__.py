"""CUDA kernels of the port and their plain PyTorch versions."""

from . import build
from . import rssm  # noqa: F401  (registers its kernel)
from . import rssm_vjp  # noqa: F401  (registers its two kernels)

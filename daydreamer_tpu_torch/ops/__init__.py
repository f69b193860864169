"""CUDA kernels of the port and their plain PyTorch versions."""

from . import build
from . import rssm  # noqa: F401  (registers its kernel)

"""CUDA kernels of the port and their plain PyTorch versions."""

from . import adam  # noqa: F401  (registers its two kernels)
from . import build
from . import gru  # noqa: F401  (registers its two kernels)
from . import norm  # noqa: F401  (registers its two kernels)
from . import onehot  # noqa: F401  (registers its two kernels)
from . import rssm  # noqa: F401  (registers its kernel)
from . import rssm_vjp  # noqa: F401  (registers its two kernels)

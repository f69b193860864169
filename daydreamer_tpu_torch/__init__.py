"""daydreamer_tpu_torch: the PyTorch and CUDA port of daydreamer_tpu.

The same DreamerV2+ world-model agent, trained and acting on one NVIDIA
GPU. The module layout mirrors `daydreamer_tpu` so each module's
counterpart is found under the same path; the host-side layers (`core/`,
`replay/`, `run/`, `envs/`) are copies, and the kernels that the JAX
package wrote in Pallas for the TPU are CUDA kernels under `ops/csrc/`.
"""

__version__ = '0.1.0'

from .core import *  # noqa: F401,F403
from .core import when, wrappers  # noqa: F401
from . import replay  # noqa: F401
from . import envs  # noqa: F401
from . import run  # noqa: F401

from .module import (
    Module, scope, creating, compute_dtype, rng, device, cast, sg, tree_map,
    scan, state, kinds, from_jax_state, to_jax_state, assign)
from . import module
from .layers import Linear, Conv2D, Norm, Input, get_act
from .opt import Optimizer
from .utils import (
    AutoAdapt, Normalize, action_noise, balance_stats, BALANCE_RATIOS,
    video_grid, symlog, symexp)
from . import dists
from .dists import (
    OneHotDist, Independent, Normal, MultivariateNormalDiag, TruncNormal,
    Bernoulli, MSEDist, SymlogDist, kl_divergence)

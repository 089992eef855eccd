"""PyTorch/CUDA port of bayesian_optimization_tpu for one NVIDIA H100.

The same public names as the JAX package, for the slice ported so far:
`fmin`/`BO` on a `RealSpace`, the `GaussianProcess` (Matern or RBF kernel,
batched L-BFGS MLE) and the BFGS `AcquisitionArgmax`. Each kernel the JAX
package wrote in Pallas for the TPU is a CUDA kernel written by hand for
Hopper (csrc/), built at first use. Public constructors take `device=`
(default "cuda") and raise when no suitable GPU is present; tests pass
device="cpu", where each kernel's plain PyTorch twin runs instead.
"""
__version__ = "0.1.0"

from . import _device  # noqa: F401  (pins float32 matmul precision at import)
from ._device import DEFAULT_DEVICE, require_cuda
from .space import (
    Bool, BoolSpace, Discrete, DiscreteSpace, Integer, IntegerSpace, Node,
    Ordinal, OrdinalSpace, Real, RealSpace, SearchSpace, SpaceEncoding, Subset,
    SubsetSpace, Variable,
)
from .utils import (
    AskEmptyError, ConstraintEvaluationError, FlatFitnessError,
    ObjectiveEvaluationError, RecommendationUnavailableError,
)
from .core import BO, BaseBO, BaseOptimizer, Solution
from .models import GaussianProcess, trend
from .models.trend import constant_trend
from .ops.acquisition import EI, MGFI, PI, UCB, EpsilonPI
from .optim import AcquisitionArgmax
from .fmin import fmin

__all__ = [
    "__version__", "fmin", "DEFAULT_DEVICE", "require_cuda",
    "Variable", "Real", "Integer", "Ordinal", "Discrete", "Bool", "Subset",
    "SearchSpace", "RealSpace", "IntegerSpace", "OrdinalSpace", "DiscreteSpace",
    "BoolSpace", "SubsetSpace", "Node", "SpaceEncoding",
    "Solution", "BaseOptimizer", "BaseBO", "BO",
    "GaussianProcess", "AcquisitionArgmax", "trend", "constant_trend",
    "EI", "PI", "EpsilonPI", "UCB", "MGFI",
    "AskEmptyError", "FlatFitnessError", "RecommendationUnavailableError",
    "ObjectiveEvaluationError", "ConstraintEvaluationError",
]

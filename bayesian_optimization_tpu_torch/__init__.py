"""PyTorch/CUDA port of bayesian_optimization_tpu for one NVIDIA H100.

The same public names as the JAX package, and everything it does:
`fmin` (n_point >= 1), `BO` and the batch flavors `ParallelBO`,
`AnnealingBO`, `SelfAdaptiveBO`, `NoisyBO`, `MultiAcquisitionBO` on real and
mixed spaces, with equality/inequality constraints (`eq_fun`/`ineq_fun`,
`ConstraintProgram`), `PCABO`, `ConditionalBO`, the multi-objective `MOBO`
(EHVI) and `MOBO_qEHVI` (joint q-point qEHVI); the `GaussianProcess` (every
kernel of the JAX package's `_KERNELS`; batched L-BFGS or population-CMA
MLE, or an HMC/NUTS/VI ensemble; float32 or float64; `gradient`/`Hessian`;
a `NonparametricTrend` prior), the `RandomForest` grown on the device (no
scikit-learn) and `SurrogateAggregation`, the criteria EI, PI, EpsilonPI,
UCB, MGFI, GEI, EHVI and qEHVI, and the `AcquisitionArgmax` with its BFGS, CMA, SMC and
MIES engines; particle meshes and `torch.distributed` (`parallel/`, `mesh=`
on BO and the argmax), the ask/tell HTTP service and its daemon
(`service/`, `simple_http_server`), and the entry points
(`entry.py`). Each kernel the JAX
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
from .core import (
    BO, MOBO, PCABO, AnnealingBO, BaseBO, BaseOptimizer, ConditionalBO, MOBO_qEHVI,
    MultiAcquisitionBO, NoisyBO, ParallelBO, SelfAdaptiveBO, Solution,
)
from .models import GaussianProcess, RandomForest, SurrogateAggregation, trend
from .models.trend import NonparametricTrend, constant_trend
from .ops.acquisition import EI, GEI, MGFI, PI, UCB, EpsilonPI
from .optim import AcquisitionArgmax, ConstraintProgram
from .fmin import fmin

__all__ = [
    "__version__", "fmin", "DEFAULT_DEVICE", "require_cuda",
    "Variable", "Real", "Integer", "Ordinal", "Discrete", "Bool", "Subset",
    "SearchSpace", "RealSpace", "IntegerSpace", "OrdinalSpace", "DiscreteSpace",
    "BoolSpace", "SubsetSpace", "Node", "SpaceEncoding",
    "Solution", "BaseOptimizer", "BaseBO",
    "BO", "ParallelBO", "AnnealingBO", "SelfAdaptiveBO", "NoisyBO", "MultiAcquisitionBO",
    "MOBO", "MOBO_qEHVI", "PCABO", "ConditionalBO", "GaussianProcess", "RandomForest", "SurrogateAggregation",
    "NonparametricTrend", "AcquisitionArgmax", "ConstraintProgram", "trend", "constant_trend", "EI", "PI", "EpsilonPI", "UCB", "MGFI", "GEI",
    "AskEmptyError", "FlatFitnessError", "RecommendationUnavailableError",
    "ObjectiveEvaluationError", "ConstraintEvaluationError",
]

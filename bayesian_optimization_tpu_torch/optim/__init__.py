"""Acquisition argmax engines: batched L-BFGS multistart, population
(1+1)-Cholesky-CMA-ES, SMC-resampled CMA chains, mixed-space evolution (MIES),
and the constraint programs they maximize under."""
from .argmax import AcquisitionArgmax, make_unit_criterion
from .constraints import ConstraintProgram
from .cma import OnePlusOne_Cholesky_CMA, run_cma
from .mies import MIES

__all__ = [
    "AcquisitionArgmax", "ConstraintProgram", "make_unit_criterion", "OnePlusOne_Cholesky_CMA",
    "run_cma",
]

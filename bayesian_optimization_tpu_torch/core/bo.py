"""Sequential Bayesian optimization.

Counterpart of `BO` in bayesian_optimization_tpu/core/bo.py. The batch
flavours (ParallelBO, AnnealingBO, SelfAdaptiveBO, NoisyBO,
MultiAcquisitionBO) are not ported yet.
"""
from __future__ import annotations

from .base import BaseBO


class BO(BaseBO):
    """Sequential Bayesian optimization (ref parity: bayes_opt.py:15-55)."""

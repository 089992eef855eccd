"""BO engine core: data model, ask/evaluate/tell loop, BO flavors."""
from .solution import Solution
from .base import BaseBO, BaseOptimizer
from .bo import BO, AnnealingBO, MultiAcquisitionBO, NoisyBO, ParallelBO, SelfAdaptiveBO

__all__ = [
    "Solution", "BaseOptimizer", "BaseBO",
    "BO", "ParallelBO", "AnnealingBO", "SelfAdaptiveBO", "NoisyBO", "MultiAcquisitionBO",
]

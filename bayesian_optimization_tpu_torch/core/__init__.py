"""BO engine core: data model, ask/evaluate/tell loop, BO flavors, MOBO, PCABO, ConditionalBO."""
from .solution import Solution
from .base import BaseBO, BaseOptimizer
from .bo import BO, AnnealingBO, MultiAcquisitionBO, NoisyBO, ParallelBO, SelfAdaptiveBO
from .mobo import MOBO, MOBO_qEHVI
from .extensions import PCABO, ConditionalBO

__all__ = [
    "Solution", "BaseOptimizer", "BaseBO",
    "BO", "ParallelBO", "AnnealingBO", "SelfAdaptiveBO", "NoisyBO", "MultiAcquisitionBO",
    "MOBO", "MOBO_qEHVI", "PCABO", "ConditionalBO",
]

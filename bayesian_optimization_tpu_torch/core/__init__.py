"""BO engine core: data model, ask/evaluate/tell loop, sequential BO."""
from .solution import Solution
from .base import BaseBO, BaseOptimizer
from .bo import BO

__all__ = ["Solution", "BaseOptimizer", "BaseBO", "BO"]

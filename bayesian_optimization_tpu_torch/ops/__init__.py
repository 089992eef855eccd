"""Compute kernels and the tensor code around them: the hand-written
Hopper kernels, GP linear algebra, batched L-BFGS, acquisition math."""
from .optimize import from_box, maximize_restarts, minimize_restarts, to_box

__all__ = ["minimize_restarts", "maximize_restarts", "to_box", "from_box"]

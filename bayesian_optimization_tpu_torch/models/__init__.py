"""Surrogate models: batched GP (Kriging), trends, kernels."""
from .gp import GaussianProcess
from .kernels import kernel_fn
from .likelihood import GPConfig
from .trend import BasisExpansionTrend, constant_trend, linear_trend, quadratic_trend

__all__ = [
    "GaussianProcess", "GPConfig", "kernel_fn",
    "BasisExpansionTrend", "constant_trend", "linear_trend", "quadratic_trend",
]

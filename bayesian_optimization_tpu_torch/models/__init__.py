"""Surrogate models: batched GP (Kriging), its hyperparameter samplers, trends, kernels,
and the random forest."""
from .gp import GaussianProcess
from .hmc import effective_sample_size, fit_vi, hmc_sample, nuts_sample
from .kernels import kernel_fn
from .likelihood import GPConfig
from .random_forest import RandomForest, RFConfig, RFState, SurrogateAggregation
from .trend import (
    BasisExpansionTrend, NonparametricTrend, constant_trend, linear_trend, quadratic_trend,
)

__all__ = [
    "GaussianProcess", "GPConfig", "kernel_fn",
    "hmc_sample", "nuts_sample", "fit_vi", "effective_sample_size",
    "BasisExpansionTrend", "constant_trend", "linear_trend", "quadratic_trend",
    "NonparametricTrend", "RandomForest", "SurrogateAggregation", "RFConfig", "RFState",
]

"""Basis-expansion trend (prior mean) functions for universal/ordinary kriging.

Counterpart of bayesian_optimization_tpu/models/trend.py: constant, linear
and quadratic bases F(X) with optional fixed coefficients `beta`
(beta=None => estimated by GLS inside the GP fit). `NonparametricTrend`
waits for the random forest.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


class BasisExpansionTrend:
    """mean(X) = F(X) @ beta, with F a fixed basis expansion."""

    def __init__(self, dim: int, beta: Optional[np.ndarray] = None):
        self.dim = dim
        self.beta = None if beta is None else torch.atleast_1d(
            torch.as_tensor(np.asarray(beta, np.float32))
        )

    @property
    def estimate_coefficients(self) -> bool:
        return self.beta is None

    def F(self, X: torch.Tensor) -> torch.Tensor:  # pragma: no cover - abstract
        raise NotImplementedError

    @property
    def n_basis(self) -> int:  # pragma: no cover - abstract
        raise NotImplementedError

    def __call__(self, X: torch.Tensor) -> torch.Tensor:
        if self.beta is None:
            raise ValueError("trend coefficients not set/estimated yet")
        beta = self.beta.to(device=X.device, dtype=X.dtype).reshape(self.n_basis, -1)
        return self.F(X) @ beta


class constant_trend(BasisExpansionTrend):
    """F(x) = [1]."""

    @property
    def n_basis(self) -> int:
        return 1

    def F(self, X: torch.Tensor) -> torch.Tensor:
        return torch.ones((X.shape[0], 1), dtype=X.dtype, device=X.device)


class linear_trend(BasisExpansionTrend):
    """F(x) = [1, x_1..x_d]."""

    @property
    def n_basis(self) -> int:
        return 1 + self.dim

    def F(self, X: torch.Tensor) -> torch.Tensor:
        return torch.cat([torch.ones_like(X[:, :1]), X], dim=1)


class quadratic_trend(BasisExpansionTrend):
    """F(x) = [1, x_i, x_i x_j (i<=j)]."""

    @property
    def n_basis(self) -> int:
        d = self.dim
        return 1 + d + d * (d + 1) // 2

    def F(self, X: torch.Tensor) -> torch.Tensor:
        iu, ju = np.triu_indices(X.shape[1])
        return torch.cat([torch.ones_like(X[:, :1]), X, X[:, iu] * X[:, ju]], dim=1)


TRENDS = {"constant": constant_trend, "linear": linear_trend, "quadratic": quadratic_trend}

"""Stationary GP correlation kernels on the hand-written Matern kernel.

Counterpart of bayesian_optimization_tpu/models/kernels.py for the names on
the main path: `matern` (nu in {1/2, 3/2, 5/2}), `matern12`, `matern32`,
`matern52`, `squared_exponential` and `rbf` all build their matrix through
`matern_fused` (ops/hopper_kernels.py), which fuses the weighted distance
with the kernel map. theta may carry a leading batch axis (one row per MLE
restart lane): (B, D) -> (B, N, M).

Not ported yet (they raise NotImplementedError): the L1 kernels
(absolute/generalized exponential), `cubic`, `pure_nugget`, the closed form
for other half-integer nu and the generic-nu Bessel path.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Callable

from ..ops.hopper_kernels import matern_fused

_SPECIAL_NU = (0.5, 1.5, 2.5)


def matern(theta, X, Y=None, nu: float = 1.5):
    """Matern correlation with r = sqrt(sum_d theta_d dx_d^2); unit diagonal
    when Y is None."""
    if float(nu) not in _SPECIAL_NU:
        raise NotImplementedError(
            f"matern nu={nu}: only nu in {_SPECIAL_NU} is ported to the GPU package"
        )
    return matern_fused(theta, X, Y, nu=float(nu))


def squared_exponential(theta, X, Y=None):
    """exp(-sum_d theta_d dx_d^2); unit diagonal when Y is None."""
    return matern_fused(theta, X, Y, nu=math.inf)


def _not_ported(name: str) -> Callable:
    def kernel(*_args, **_kwargs):
        raise NotImplementedError(f"kernel {name!r} is not ported to the GPU package yet")

    return kernel


_KERNELS: dict = {
    "matern": partial(matern, nu=1.5),
    "matern12": partial(matern, nu=0.5),
    "matern32": partial(matern, nu=1.5),
    "matern52": partial(matern, nu=2.5),
    "squared_exponential": squared_exponential,
    "rbf": squared_exponential,
    "absolute_exponential": _not_ported("absolute_exponential"),
    "generalized_exponential": _not_ported("generalized_exponential"),
    "cubic": _not_ported("cubic"),
    "pure_nugget": _not_ported("pure_nugget"),
}


def kernel_fn(name) -> Callable:
    """Look up a kernel by name; also accepts a callable or a
    ("matern", nu) tuple."""
    if callable(name):
        return name
    if isinstance(name, tuple) and len(name) == 2:
        family, param = name
        if family == "matern":
            return partial(matern, nu=float(param))
        if family == "generalized_exponential":
            return _not_ported("generalized_exponential")
        raise ValueError(f"unknown parameterized kernel family {family!r}")
    if name not in _KERNELS:
        raise ValueError(f"unknown kernel {name!r}; available: {sorted(_KERNELS)}")
    return _KERNELS[name]

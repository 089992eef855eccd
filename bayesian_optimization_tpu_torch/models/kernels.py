"""Stationary GP correlation kernels.

Counterpart of bayesian_optimization_tpu/models/kernels.py, every name of
its `_KERNELS` and both tuple families. theta may carry a leading batch axis
(one row per MLE restart lane or ensemble member): (D,) -> (N, M) and
(B, D) -> (B, N, M).

- `matern` with nu in {1/2, 3/2, 5/2}, `matern12/32/52`,
  `squared_exponential` and `rbf` build their matrix through `matern_fused`
  (ops/hopper_kernels.py), the hand-written kernel that fuses the weighted
  distance with the map. float64 takes the kernel's plain twin instead,
  chosen here by dtype: the JAX package's float64 likewise never reaches its
  Pallas kernel, which is float32 only. `matern_fused` itself raises on a
  float64 CUDA tensor, so a float32 call always reaches the kernel.
- the closed form for any other half-integer nu, the L1 kernels
  (`absolute_exponential`, `generalized_exponential`), `cubic` and
  `pure_nugget` are plain torch, as they are XLA ops (no Pallas) in the JAX
  package.
- any other nu > 0 evaluates K_nu with scipy on the host in float64, a
  round trip to the host on every call by design, as the JAX package's
  `pure_callback` is (`_BesselPhi`).
"""
from __future__ import annotations

import math
from functools import partial
from typing import Callable

import numpy as np
import torch

from ..ops.hopper_kernels import matern_fused, matern_twin

_SPECIAL_NU = (0.5, 1.5, 2.5)
_SAFE_EPS = 1e-30


def _theta_rows(theta, X: torch.Tensor):
    """(theta as (B, D), was it one vector): a scalar or (D,) is one lane."""
    theta = torch.as_tensor(theta, dtype=X.dtype, device=X.device)
    single = theta.ndim < 2
    theta2 = theta.reshape(1, -1) if single else theta
    return torch.broadcast_to(theta2, (theta2.shape[0], X.shape[-1])), single


def _per_feature_sum(theta2, X, Y, term: Callable) -> torch.Tensor:
    """sum_d theta2[b, d] * term(X[i, d] - Y[j, d]) as (B, N, M), one
    (N, M) difference per feature (no (N, M, D) tensor)."""
    out = None
    for d in range(X.shape[1]):
        t = theta2[:, d, None, None] * term(X[:, d, None] - Y[None, :, d])[None]
        out = t if out is None else out + t
    return out


def _finish(K: torch.Tensor, single: bool, unit: bool) -> torch.Tensor:
    if unit:
        K = _unit_diag(K)
    return K[0] if single else K


def _unit_diag(K: torch.Tensor) -> torch.Tensor:
    """K with an exact unit diagonal (batched over leading axes)."""
    eye = torch.eye(K.shape[-2], K.shape[-1], dtype=K.dtype, device=K.device)
    return K * (1.0 - eye) + eye


def weighted_l1_dist(theta, X, Y=None) -> torch.Tensor:
    """l1[b, i, j] = sum_d theta_bd |X_id - Y_jd|; (N, M) for one theta."""
    theta2, single = _theta_rows(theta, X)
    l1 = _per_feature_sum(theta2, X, X if Y is None else Y, torch.abs)
    return l1[0] if single else l1


def _matern_half_integer(r: torch.Tensor, nu: float) -> torch.Tensor:
    """Closed-form Matern for half-integer nu = p + 1/2: a degree-p
    polynomial in s = sqrt(2 nu) r times exp(-s),
        K = exp(-s) (p!/(2p)!) sum_i (p+i)!/(i!(p-i)!) (2s)^(p-i)."""
    p = int(nu - 0.5)
    s = math.sqrt(2.0 * nu) * r
    poly = torch.zeros_like(s)
    for i in range(p + 1):
        coef = math.factorial(p + i) / (math.factorial(i) * math.factorial(p - i))
        poly = poly + coef * (2.0 * s) ** (p - i)
    return (math.factorial(p) / math.factorial(2 * p)) * poly * torch.exp(-s)


def _bessel_host(s: torch.Tensor, nu: float, order: float, scale: float) -> torch.Tensor:
    """scale * s^nu * K_order(s), computed with scipy on the host in float64
    (s^nu alone under/overflows float32 near 0); the s -> 0 limit is 1 for
    the primal (order == nu) and 0 for its derivative."""
    from scipy.special import kv

    s64 = s.detach().cpu().double().numpy()
    with np.errstate(invalid="ignore", over="ignore"):
        out = scale * s64 ** nu * kv(order, s64)
    limit = 1.0 if order == nu else 0.0
    out = np.nan_to_num(np.where(s64 <= 1e-12, limit, out), nan=limit)
    return torch.as_tensor(out, device=s.device).to(s.dtype)


class _BesselPhi(torch.autograd.Function):
    """phi(s) = 2^(1-nu)/Gamma(nu) s^nu K_nu(s) for any nu > 0, its backward
    from d/ds[s^nu K_nu(s)] = -s^nu K_(nu-1)(s). Both directions are a host
    round trip through scipy, by design (K_nu has no torch op), as the JAX
    package's custom-JVP `pure_callback`. Once differentiable: a backward
    asked to build a graph (create_graph=True, for a second derivative)
    raises."""

    @staticmethod
    def forward(ctx, s, nu):
        ctx.save_for_backward(s)
        ctx.nu = nu
        return _bessel_host(s, nu, nu, 2.0 ** (1.0 - nu) / math.gamma(nu))

    @staticmethod
    def backward(ctx, g):
        if torch.is_grad_enabled():
            raise RuntimeError("the generic-nu Matern's derivative is a host Bessel evaluation "
                               "with no derivative of its own: no second derivative")
        (s,) = ctx.saved_tensors
        nu = ctx.nu
        return g * _bessel_host(s, nu, nu - 1.0, -(2.0 ** (1.0 - nu)) / math.gamma(nu)), None


def matern(theta, X, Y=None, nu: float = 1.5) -> torch.Tensor:
    """Matern correlation with r = sqrt(sum_d theta_d dx_d^2); unit diagonal
    when Y is None."""
    nu = float(nu)
    if nu in _SPECIAL_NU:
        if X.dtype == torch.float64:  # the JAX package's f64 route: no kernel
            return matern_twin(theta, X, Y, nu=nu)
        return matern_fused(theta, X, Y, nu=nu)
    if not nu > 0:
        raise ValueError(f"matern requires nu > 0, got {nu}")
    theta2, single = _theta_rows(theta, X)
    r = torch.sqrt(_per_feature_sum(theta2.clamp_min(0.0), X, X if Y is None else Y,
                                    lambda d: d * d).clamp_min(_SAFE_EPS))
    if float(nu - 0.5).is_integer():
        K = _matern_half_integer(r, nu)
    else:
        K = _BesselPhi.apply(math.sqrt(2.0 * nu) * r, nu)
    return _finish(K, single, Y is None)


def squared_exponential(theta, X, Y=None) -> torch.Tensor:
    """exp(-sum_d theta_d dx_d^2); unit diagonal when Y is None."""
    if X.dtype == torch.float64:  # the JAX package's f64 route: no kernel
        return matern_twin(theta, X, Y, nu=math.inf)
    return matern_fused(theta, X, Y, nu=math.inf)


def absolute_exponential(theta, X, Y=None) -> torch.Tensor:
    """exp(-sum_d theta_d |dx_d|), the OU kernel."""
    K = torch.exp(-weighted_l1_dist(theta, X, Y))
    return _unit_diag(K) if Y is None else K


def generalized_exponential(theta, X, Y=None, power: float = 1.5) -> torch.Tensor:
    """exp(-sum_d theta_d |dx_d|^p), 0 < p <= 2."""
    theta2, single = _theta_rows(theta, X)
    K = torch.exp(-_per_feature_sum(theta2, X, X if Y is None else Y,
                                    lambda d: torch.abs(d) ** power))
    return _finish(K, single, Y is None)


def cubic(theta, X, Y=None) -> torch.Tensor:
    """prod_d (1 - 3 td^2 + 2 td^3) over td = min(theta_d |dx_d|, 1)."""
    theta2, single = _theta_rows(theta, X)
    Yv = X if Y is None else Y
    K = None
    for d in range(X.shape[1]):
        td = (theta2[:, d, None, None] * torch.abs(X[:, d, None] - Yv[None, :, d])[None]).clamp_max(1.0)
        f = 1.0 - 3.0 * td ** 2 + 2.0 * td ** 3
        K = f if K is None else K * f
    return _finish(K, single, Y is None)


def pure_nugget(theta, X, Y=None) -> torch.Tensor:
    """White-noise correlation: 1 iff the same point."""
    theta2, single = _theta_rows(theta, X)
    B = theta2.shape[0]
    if Y is None:
        K = torch.eye(X.shape[0], dtype=X.dtype, device=X.device).expand(B, -1, -1)
    else:
        d = torch.abs(X[:, None, :] - Y[None, :, :]).sum(-1)
        K = (d == 0.0).to(X.dtype).expand(B, -1, -1)
    return K[0] if single else K


_KERNELS: dict = {
    "matern": partial(matern, nu=1.5),
    "matern12": partial(matern, nu=0.5),
    "matern32": partial(matern, nu=1.5),
    "matern52": partial(matern, nu=2.5),
    "squared_exponential": squared_exponential,
    "rbf": squared_exponential,
    "absolute_exponential": absolute_exponential,
    "generalized_exponential": generalized_exponential,
    "cubic": cubic,
    "pure_nugget": pure_nugget,
}


def kernel_fn(name) -> Callable:
    """Look up a kernel by name; also accepts a callable, or a
    ("matern", nu) / ("generalized_exponential", power) tuple."""
    if callable(name):
        return name
    if isinstance(name, tuple) and len(name) == 2:
        family, param = name
        if family == "matern":
            return partial(matern, nu=float(param))
        if family == "generalized_exponential":
            return partial(generalized_exponential, power=float(param))
        raise ValueError(f"unknown parameterized kernel family {family!r}")
    if name not in _KERNELS:
        raise ValueError(f"unknown kernel {name!r}; available: {sorted(_KERNELS)}")
    return _KERNELS[name]

"""Acquisition functions as batched PyTorch criteria.

Counterpart of bayesian_optimization_tpu/ops/acquisition.py: EI, PI,
epsilon-PI, UCB, MGFI (t <= 22.36) and generalized EI of order g for
minimization with an improvement plugin, each a function of batched
posterior moments (mu[N], sd[N]) -> value[N], maximized by the argmax
engines. sd ~ 0 and non-finite values give 0, as in the JAX package. Each
parameter (plugin, t, alpha, epsilon) is a number or a per-lane tensor (N,):
a batch of q criteria runs as one population whose lanes carry their own
criterion's parameters; GEI's order g is a Python integer.
"""
from __future__ import annotations

import math
import numbers
from typing import Callable, Dict, Optional

import numpy as np
import torch

_SD_FLOOR = 1e-10
MGFI_T_MAX = 22.36
_INV_SQRT2 = 1.0 / math.sqrt(2.0)
_INV_SQRT2PI = 1.0 / math.sqrt(2.0 * math.pi)


def _cdf(u):
    return 0.5 * torch.erfc(-u * _INV_SQRT2)


def _pdf(u):
    return torch.exp(-0.5 * u * u) * _INV_SQRT2PI


def _lane(v, like: torch.Tensor):
    """A parameter as a tensor on like's device and dtype: a number becomes a
    0-d tensor, filled there (not copied from the host, which a CUDA graph's
    capture cannot do), a per-lane vector stays (N,); one already there is
    not copied."""
    if isinstance(v, numbers.Real):
        return torch.full((), v, dtype=like.dtype, device=like.device)
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def _guard(value: torch.Tensor, sd: torch.Tensor) -> torch.Tensor:
    value = torch.where(torch.isfinite(value), value, torch.zeros_like(value))
    return torch.where(sd > _SD_FLOOR, value, torch.zeros_like(value))


def ei(mu, sd, plugin, **_):
    """Expected improvement below `plugin`."""
    sd_safe = sd.clamp_min(_SD_FLOOR)
    imp = _lane(plugin, mu) - mu
    u = imp / sd_safe
    return _guard(imp * _cdf(u) + sd_safe * _pdf(u), sd)


def pi(mu, sd, plugin, epsilon: float = 0.0, **_):
    """(epsilon-)probability of improvement."""
    sd_safe = sd.clamp_min(_SD_FLOOR)
    epsilon = _lane(epsilon, mu)
    coef = torch.where(mu > 0, 1.0 - epsilon, 1.0 + epsilon)
    return _guard(_cdf((_lane(plugin, mu) - coef * mu) / sd_safe), sd)


def epsilon_pi(mu, sd, plugin, epsilon: float = 1e-10, **_):
    return pi(mu, sd, plugin, epsilon=epsilon)


def ucb(mu, sd, alpha: float = 0.5, **_):
    """Lower-confidence bound for minimization, maximized as -mu + alpha sd."""
    return -mu + _lane(alpha, mu) * sd


def mgfi(mu, sd, plugin, t: float = 1.0, **_):
    """Moment-generating function of the improvement [Wang et al., SMC'17]."""
    t = _lane(t, mu).clamp(1e-12, MGFI_T_MAX)
    plugin = _lane(plugin, mu)
    sd_safe = sd.clamp_min(_SD_FLOOR)
    mu_p = mu - t * sd_safe ** 2
    beta_p = (plugin - mu_p) / sd_safe
    log_term = t * (plugin - mu - 1.0) + 0.5 * t ** 2 * sd_safe ** 2
    return _guard(_cdf(beta_p) * torch.exp(log_term.clamp_max(60.0)), sd)


def gei(mu, sd, plugin, g: int = 2, **_):
    """Generalized expected improvement E[I^g] (Schonlau et al. 1998) by the
    truncated-moment recursion M_0 = Phi(u), M_1 = -phi(u),
    M_k = -u^(k-1) phi(u) + (k-1) M_(k-2), u = (plugin - mu) / sd:
    E[I^g] = sd^g sum_k C(g, k) u^(g-k) (-1)^k M_k. g = 1 is EI."""
    g = int(g)
    sd_safe = sd.clamp_min(_SD_FLOOR)
    u = (_lane(plugin, mu) - mu) / sd_safe
    phi_u = _pdf(u)
    moments = [_cdf(u), -phi_u]
    for k in range(2, g + 1):
        moments.append(-(u ** (k - 1)) * phi_u + (k - 1) * moments[k - 2])
    total = 0.0
    for k in range(g + 1):
        total = total + math.comb(g, k) * (u ** (g - k)) * ((-1.0) ** k) * moments[k]
    return _guard(sd_safe ** g * total, sd)


ACQUISITIONS: Dict[str, Callable] = {
    "EI": ei,
    "PI": pi,
    "EpsilonPI": epsilon_pi,
    "UCB": ucb,
    "MGFI": mgfi,
    "GEI": gei,
}


def acquisition_fn(name) -> Callable:
    if callable(name):
        return name
    if name not in ACQUISITIONS:
        raise ValueError(f"unknown acquisition {name!r}; available: {sorted(ACQUISITIONS)}")
    return ACQUISITIONS[name]


class AcquisitionFunction:
    """Object wrapper binding a fitted model: handles the minimize/maximize
    sign flip and offers __call__(X, return_dx)."""

    _fn_name: str = "EI"

    def __init__(self, model=None, plugin: Optional[float] = None, minimize: bool = True, **params):
        self.minimize = minimize
        self.params = params
        self.model = model
        self.plugin = plugin

    @property
    def plugin(self):
        return self._plugin

    @plugin.setter
    def plugin(self, plugin):
        self._plugin = None if plugin is None else (plugin if self.minimize else -plugin)

    def criterion_params(self) -> dict:
        p = dict(self.params)
        if self._fn_name in ("EI", "PI", "EpsilonPI", "MGFI", "GEI"):
            p["plugin"] = self._plugin
        return p

    def __call__(self, X, return_dx: bool = False):
        fn = acquisition_fn(self._fn_name)
        model = self.model
        Xq = torch.as_tensor(np.atleast_2d(np.asarray(X, float)), dtype=torch.float32,
                             device=model.device).requires_grad_(return_dx)
        with torch.set_grad_enabled(return_dx):
            mu, var = model.predict_torch(Xq, eval_mse=True)
            mu = mu[:, 0] if self.minimize else -mu[:, 0]
            sd = torch.sqrt(var[:, 0].clamp_min(0.0))
            value = fn(mu, sd, **self.criterion_params())
        vals = value.detach().cpu().double().numpy()
        out = vals if vals.size > 1 else float(vals[0])
        if not return_dx:
            return out
        (dx,) = torch.autograd.grad(value.sum(), Xq)
        dx = dx.cpu().double().numpy().reshape(-1, 1)
        return out, np.where(np.isfinite(dx), dx, 0.0)


class EI(AcquisitionFunction):
    _fn_name = "EI"


class PI(AcquisitionFunction):
    _fn_name = "PI"


class EpsilonPI(AcquisitionFunction):
    _fn_name = "EpsilonPI"

    def __init__(self, epsilon: float = 1e-10, **kwargs):
        super().__init__(epsilon=epsilon, **kwargs)


class UCB(AcquisitionFunction):
    _fn_name = "UCB"

    def __init__(self, alpha: float = 0.5, **kwargs):
        super().__init__(alpha=alpha, **kwargs)


class GEI(AcquisitionFunction):
    _fn_name = "GEI"

    def __init__(self, g: int = 2, **kwargs):
        if int(g) < 1:
            raise ValueError("g must be a positive integer")
        super().__init__(g=int(g), **kwargs)


class MGFI(AcquisitionFunction):
    _fn_name = "MGFI"

    def __init__(self, t: float = 1.0, **kwargs):
        super().__init__(t=min(t, MGFI_T_MAX), **kwargs)

    @property
    def t(self):
        return self.params["t"]

    @t.setter
    def t(self, t):
        self.params["t"] = min(float(t), MGFI_T_MAX)

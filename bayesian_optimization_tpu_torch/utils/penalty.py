"""Constraint penalties and box handling, batched in PyTorch.

Counterpart of bayesian_optimization_tpu/utils/penalty.py: the reflective
box transform, the dynamic penalty, and the host-side evaluation of
black-box constraint callables, each acting on whole candidate populations.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def reflect_into_box(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """Mirror out-of-box coordinates back inside [lo, hi]
    (ref parity: utils/utils.py:108-146, Rui Li's alg. 6). The fold is a
    floor-mod (`torch.remainder`, as jnp.mod), never `torch.fmod`: the two
    differ below lo, where ES offspring land every generation."""
    lo = torch.as_tensor(lo, dtype=x.dtype, device=x.device)
    hi = torch.as_tensor(hi, dtype=x.dtype, device=x.device)
    width = (hi - lo).clamp_min(1e-30)
    y = torch.remainder(x - lo, 2.0 * width)
    y = torch.where(y > width, 2.0 * width - y, y)
    return lo + y


def violation(h_vals: Optional[torch.Tensor], g_vals: Optional[torch.Tensor],
              beta: float = 2.0, epsilon: float = 0.01) -> torch.Tensor:
    """sum|h| (where |h|>eps) + sum max(0,g)^beta over the last axis (a
    missing kind counts 0): the raw violation every penalty scales."""
    total = torch.zeros(())
    if h_vals is not None:
        viol = torch.atleast_2d(h_vals).abs()
        total = total + torch.where(viol > epsilon, viol, torch.zeros_like(viol)).sum(-1)
    if g_vals is not None:
        total = total + (torch.atleast_2d(g_vals).clamp_min(0.0) ** beta).sum(-1)
    return total


def dynamic_penalty(
    h_vals: Optional[torch.Tensor],
    g_vals: Optional[torch.Tensor],
    t,
    C: float = 0.5,
    alpha: float = 1.0,
    beta: float = 2.0,
    epsilon: float = 0.01,
    minimize: bool = True,
) -> torch.Tensor:
    """(t*C)^alpha * [sum|h| (where |h|>eps) + sum max(0,g)^beta], batched
    over the leading axis of h_vals/g_vals (ref parity: utils/utils.py:272-344)."""
    if h_vals is None and g_vals is None:
        return torch.zeros(())
    total = violation(h_vals, g_vals, beta, epsilon)
    p = (torch.as_tensor(t, dtype=total.dtype, device=total.device) * C) ** alpha * total
    return p if minimize else -p


def eval_constraints_host(x, h: Optional[Callable], g: Optional[Callable]):
    """Host-side evaluation of black-box constraint callables on one point;
    returns (h_vals, g_vals) as float arrays (or None)."""
    hv = np.atleast_1d(np.asarray(h(x), dtype=float)) if h is not None else None
    gv = np.atleast_1d(np.asarray(g(x), dtype=float)) if g is not None else None
    return hv, gv


def violation_host(x, h: Optional[Callable], g: Optional[Callable]) -> float:
    """The raw violation of one point under host constraint callables."""
    hv, gv = eval_constraints_host(x, h, g)
    return float(violation(None if hv is None else torch.from_numpy(hv),
                           None if gv is None else torch.from_numpy(gv))[0])

"""Acquisition argmax by batched multi-start L-BFGS.

Counterpart of bayesian_optimization_tpu/optim/argmax.py for
method="BFGS" (and "auto" on all-real spaces): restarts are lanes of one
batched L-BFGS (ops/optimize.py), and every trip evaluates the criterion
for all live lanes at once -- one point per lane, one shared posterior, so
one (P, n_pad) cross-covariance through the hand Matern kernel per trip.

The restart pool is drawn from a torch.Generator seeded from `seed` (on the
CPU, so a seed gives the same pool on every device); `x0_seed` overwrites
its head, which is how the parity tests hand both packages the same starts.
Not ported yet (they raise): the CMA, MIES and SMC engines, `.batch`,
constraints, PCA, a random-forest prior, EHVI and qEHVI.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from .._device import DEFAULT_DEVICE, resolve_device
from ..models.likelihood import GPConfig, PosteriorState, predict, trend_basis
from ..ops.acquisition import acquisition_fn
from ..ops.optimize import maximize_restarts


def _inject_seeds(x0: torch.Tensor, x0_seed) -> torch.Tensor:
    """Overwrite the head of a (P, dim) restart pool with caller-supplied
    unit-cube rows; the rest of the pool stays random."""
    if x0_seed is None:
        return x0
    seeds = torch.as_tensor(np.atleast_2d(np.asarray(x0_seed, float)), dtype=x0.dtype,
                            device=x0.device)
    s = min(seeds.shape[0], x0.shape[0])
    x0 = x0.clone()
    x0[:s] = seeds[:s]
    return x0


def make_unit_criterion(
    encoding,
    state: PosteriorState,
    config: GPConfig,
    acq_name: str,
    acq_params: Dict,
    minimize: bool = True,
    fixed_mask: Optional[torch.Tensor] = None,
    fixed_vals: Optional[torch.Tensor] = None,
) -> Callable:
    """crit(U[P, dim]) -> value[P]: unit cube -> embed -> GP posterior ->
    acquisition. Larger is better."""
    fn = acquisition_fn(acq_name)

    def crit(U: torch.Tensor) -> torch.Tensor:
        if fixed_mask is not None:
            U = torch.where(fixed_mask[None, :] > 0, fixed_vals[None, :], U)
        E = encoding.unit_to_embed(U)
        mu, var = predict(state, E, trend_basis(config, E), config, True)
        mu0, sd0 = mu[:, 0], torch.sqrt(var[:, 0].clamp_min(0.0))
        if not minimize:
            mu0 = -mu0
        return fn(mu0, sd0, **acq_params)

    return crit


def _bfgs_argmax(state, config, encoding, acq_name, acq_params, minimize,
                 x0, fixed_mask, fixed_vals, max_iter):
    crit = make_unit_criterion(
        encoding, state, config, acq_name, acq_params, minimize, fixed_mask, fixed_vals
    )
    dim = x0.shape[-1]
    zeros = torch.zeros(dim, dtype=x0.dtype, device=x0.device)
    res = maximize_restarts(crit, x0, zeros, zeros + 1.0, max_iter=max_iter)
    u, val = res.x_best, res.fun_best
    if fixed_mask is not None:
        u = torch.where(fixed_mask > 0, fixed_vals, u)
    return u, val


class AcquisitionArgmax:
    """Maximizes acquisition criteria over a `SpaceEncoding`'s unit cube
    with batched multi-start L-BFGS (method 'BFGS', or 'auto' on an
    all-real space)."""

    def __init__(
        self,
        encoding,
        method: str = "auto",
        n_restart: Optional[int] = None,
        seed: int = 0,
        mesh=None,
        constraints=None,
        device=DEFAULT_DEVICE,
    ):
        self.device = resolve_device(device)
        if mesh is not None or constraints is not None:
            raise NotImplementedError("meshes and constraints are not ported to the GPU package yet")
        all_real = bool(np.all(encoding.is_real))
        if method == "auto" and all_real:
            method = "BFGS"
        if method != "BFGS":
            raise NotImplementedError(
                f"argmax method {method!r} (all_real={all_real}) is not ported to the "
                "GPU package yet; only BFGS on all-real spaces"
            )
        self.encoding = encoding
        self.method = method
        dim = encoding.dim
        self.n_restart = n_restart or 5 * dim
        self.max_iter = 40
        self._gen = torch.Generator().manual_seed(int(seed))

    def __call__(
        self,
        state: PosteriorState,
        config: GPConfig,
        acq_name: str,
        acq_params: Dict,
        minimize: bool = True,
        fixed: Optional[Dict[int, float]] = None,
        x0_seed: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, float]:
        """Returns (u_best[dim] on the unit cube, criterion value).
        x0_seed: optional (s, dim) unit-cube rows injected at the head of
        the restart pool."""
        dim = self.encoding.dim
        dtype = self.encoding.dtype
        fixed_mask = fixed_vals = None
        if fixed:
            fm, fv = np.zeros(dim), np.zeros(dim)
            for j, u in fixed.items():
                fm[j], fv[j] = 1.0, u
            fixed_mask = torch.as_tensor(fm, dtype=dtype, device=self.device)
            fixed_vals = torch.as_tensor(fv, dtype=dtype, device=self.device)
        x0 = torch.rand((self.n_restart, dim), generator=self._gen, dtype=dtype)
        x0 = _inject_seeds(x0.to(self.device), x0_seed)
        u, val = _bfgs_argmax(
            state, config, self.encoding, acq_name, dict(acq_params), minimize,
            x0, fixed_mask, fixed_vals, self.max_iter,
        )
        u = self.encoding.quantize_unit(u).clamp(0.0, 1.0).cpu().numpy()
        return u, float(val)

    def batch(self, *_args, **_kwargs):
        raise NotImplementedError("AcquisitionArgmax.batch is not ported to the GPU package yet")

"""Expected Hypervolume Improvement: exact EHVI and Monte-Carlo qEHVI.

Counterpart of bayesian_optimization_tpu/ops/ehvi.py (ref parity:
bayes_optim/multi_objective/analytic.py:99-274, [Yang2019] psi/nu cell
terms and the 2^m cross-product gather), in PyTorch: a whole candidate
population evaluates in one batch of tensor ops over its hypercells, on the
device of its moments, and autograd gives the BFGS engine its gradient. The
formulas are the JAX package's as written (`1 - cdf(u)`, the clamps), so
float64 values agree to rounding.

Convention: MAXIMIZATION; `mu` is the posterior mean of the m objectives at
each candidate, `sigma` the posterior standard deviation, and the cells come
from ops/box_decomposition.NondominatedPartitioning.

qEHVI's standard-normal samples `eps` are an argument: a caller fixes them
once an argmax, so every criterion evaluation of that argmax sees the same
draws and the engine a deterministic criterion (MOBO_qEHVI draws them from a
torch.Generator seeded by its numpy stream, core/mobo.py).
"""
from __future__ import annotations

import functools
import math
from itertools import product

import numpy as np
import torch

_UPPER_CLAMP = 1e8  # inf upper bounds clamped for differentiability (ref :240-242)
_SIGMA_FLOOR = 1e-9
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)

# MC sample count of the qEHVI criterion. The estimator below is exact per
# sample (inclusion-exclusion over cells), so its only error is variance:
# the JAX package measured a median |rel err| against a 2^18-sample golden
# of 2.7% at q=2 and 0.8% at q=8 with 256 samples
# (tests/test_mo.py::test_qehvi_mc_accuracy).
QEHVI_N_SAMPLES = 256

# elements of qEHVI's (lanes, S, 2^q - 1, K, m) intermediate evaluated at once;
# more lanes than fit run in chunks, with the same values
_QEHVI_CHUNK_ELEMENTS = 1 << 25


def _pdf(u: torch.Tensor) -> torch.Tensor:
    return torch.exp(-0.5 * u * u) * _INV_SQRT_2PI


def _psi(lower, upper, mu, sigma):
    """Eq. 19 of [Yang2019] (ref parity: analytic.py:176-200)."""
    u = (upper - mu) / sigma
    return sigma * _pdf(u) + (mu - lower) * (1.0 - torch.special.ndtr(u))


def _nu(lower, upper, mu, sigma):
    """Eq. 25 of [Yang2019] (ref parity: analytic.py:202-221)."""
    return (upper - lower) * (1.0 - torch.special.ndtr((upper - mu) / sigma))


@functools.lru_cache(maxsize=None)
def _cross_index(m: int, device: torch.device):
    """The (2^m, m) rows of {0, 1}^m in itertools.product order, and the
    column index (m,): the gather of the cross product over {psi_diff, nu}."""
    idx = torch.tensor(list(product(*[[0, 1]] * m)), dtype=torch.long, device=device)
    return idx, torch.arange(m, device=device)


def ehvi(mu: torch.Tensor, sigma: torch.Tensor, cell_lower: torch.Tensor,
         cell_upper: torch.Tensor) -> torch.Tensor:
    """EHVI for a batch of candidates.

    mu, sigma: (B, m) posterior moments; cell_lower/upper: (K, m).
    Returns (B,) EHVI values.
    """
    m = mu.shape[-1]
    sigma = sigma.clamp_min(_SIGMA_FLOOR)
    upper = cell_upper.clamp_max(_UPPER_CLAMP)
    lower = cell_lower
    mu_b, sig_b = mu[:, None, :], sigma[:, None, :]  # (B, 1, m)
    psi_lu = _psi(lower, upper, mu_b, sig_b)  # (B, K, m)
    psi_ll = _psi(lower, lower, mu_b, sig_b)
    nu = _nu(lower, upper, mu_b, sig_b)
    psi_diff = psi_ll - psi_lu
    # cross product over {psi_diff, nu}^m (ref parity: analytic.py:255-274)
    idx, cols = _cross_index(m, mu.device)
    stacked = torch.stack([psi_diff, nu], dim=-2)  # (B, K, 2, m)
    terms = stacked[..., idx, cols]  # (B, K, 2^m, m)
    return terms.prod(-1).sum((-1, -2))


@functools.lru_cache(maxsize=None)
def _subsets(q: int, device: torch.device, dtype: torch.dtype):
    """(2^q - 1, q) masks of the non-empty candidate subsets, in the JAX
    package's order, and their inclusion-exclusion signs."""
    masks = np.asarray([[(t >> i) & 1 for i in range(q)] for t in range(1, 2 ** q)], dtype=bool)
    signs = (-1.0) ** (masks.sum(axis=1) + 1)
    return (torch.as_tensor(masks, device=device),
            torch.as_tensor(signs, dtype=dtype, device=device))


def _qehvi_lanes(mu, sigma, lower, upper, eps, masks, signs):
    """qEHVI of lanes (P, q, m) -> (P,)."""
    Y = mu[:, None] + sigma[:, None] * eps  # (P, S, q, m)
    # per-subset joint minimum of the samples (min over selected candidates)
    sel = torch.where(masks[:, :, None], Y[:, :, None], _UPPER_CLAMP)  # (P, S, T, q, m)
    y_min = sel.amin(-2)  # (P, S, T, m)
    # overlap of [cell_lower, min(cell_upper, y_min)] per cell
    top = torch.minimum(upper, y_min[..., None, :])  # (P, S, T, K, m)
    vol = (top - lower).clamp_min(0.0).prod(-1)  # (P, S, T, K)
    hvi = (vol * signs[:, None]).sum((-1, -2))  # (P, S)
    return hvi.mean(-1)


def qehvi(mu: torch.Tensor, sigma: torch.Tensor, cell_lower: torch.Tensor,
          cell_upper: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """Monte-Carlo joint Expected Hypervolume Improvement of q candidates
    [Daulton2020qehvi]: inclusion-exclusion over candidate subsets inside
    each hypercell, averaged over posterior samples mu + sigma * eps.

    mu, sigma: (q, m) per-candidate posterior moments, or (P, q, m) for P
    lanes (marginal sampling -- cross-candidate posterior covariance is not
    modeled, as in the JAX package); eps: (S, q, m) standard-normal samples,
    shared by every lane. Returns a scalar, or (P,).
    """
    lanes = mu.ndim == 3
    mu, sigma = (mu, sigma) if lanes else (mu[None], sigma[None])
    P, q, m = mu.shape
    sigma = sigma.clamp_min(_SIGMA_FLOOR)
    upper = cell_upper.clamp_max(_UPPER_CLAMP)
    eps = eps.to(mu.dtype)
    masks, signs = _subsets(q, mu.device, mu.dtype)
    per_lane = eps.shape[0] * masks.shape[0] * (cell_lower.shape[0] + q) * m
    chunk = max(1, _QEHVI_CHUNK_ELEMENTS // per_lane)
    out = torch.cat([_qehvi_lanes(mu[i:i + chunk], sigma[i:i + chunk], cell_lower, upper, eps, masks,
                                  signs) for i in range(0, P, chunk)])
    return out if lanes else out[0]


class EHVI:
    """Object wrapper mirroring the reference's criterion surface
    (ref: analytic.py:99-175): EHVI(model, ref_point, partitioning)(X),
    evaluated on the CPU in float32, as the JAX package's wrapper is."""

    def __init__(self, model, ref_point, partitioning):
        self.model = model
        self.ref_point = np.asarray(ref_point, dtype=float).ravel()
        if len(self.ref_point) != partitioning.num_outcomes:
            raise ValueError("the reference point length must match the number of outcomes")
        P = partitioning.pareto_Y
        if len(P) > 0 and not np.any(np.all(P > self.ref_point, axis=1)):
            raise ValueError("at least one pareto point must be better than the reference point")
        self.partitioning = partitioning
        bounds = partitioning.get_hypercell_bounds()
        self.cell_lower = torch.as_tensor(bounds[0], dtype=torch.float32)
        self.cell_upper = torch.as_tensor(bounds[1], dtype=torch.float32)

    def __call__(self, X, return_dx: bool = False):
        X = np.atleast_2d(np.asarray(X, dtype=object))
        mu, mse = self.model.predict(np.asarray(X, dtype=float), eval_MSE=True)
        mu = torch.as_tensor(np.atleast_2d(mu), dtype=torch.float32)
        sigma = torch.as_tensor(np.atleast_2d(mse), dtype=torch.float32).clamp_min(0.0).sqrt()
        vals = ehvi(mu, sigma, self.cell_lower, self.cell_upper).double().numpy()
        out = vals if vals.size > 1 else float(vals.ravel()[0])
        if not return_dx:
            return out
        raise NotImplementedError("use the acquisition argmax's criterion for gradients")

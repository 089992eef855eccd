"""Box decomposition of the non-dominated region for EHVI.

Counterpart of bayesian_optimization_tpu/ops/box_decomposition.py (ref
parity: bayes_optim/utils/multi_objective/box_decompositions/
box_decomposition.py:29-330, non_dominated.py:29-333 and the fast variant
`FastNondominatedPartitioning` [Yang2019] at non_dominated.py:334+): given a
Pareto front (maximization) and a reference point, hypercells [lower, upper]
covering the region that is above `ref` and not dominated by the front --
the integration domain of EHVI [Yang2019]. The cells come out in the JAX
package's order.

Algorithm: recursive slab slicing along the last objective. The axis is cut
at the front's coordinate values; within one slab only the points whose last
coordinate reaches the slab's UPPER edge can dominate, so the slab reduces to
an (m-1)-dimensional instance over the projected (re-Pareto-filtered) front.
m=1 terminates with a single ray. O(n) cells at m=2, O(n^{m-1}) in general;
`_grid_cells`, the (n+1)^m coordinate grid, is the golden oracle. Runs on
the host in numpy (and the Pareto filter on CPU tensors): the recursion is
one small filter a slab, which on the card would be a few launches and a
sync each.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .hypervolume import hypervolume
from .pareto import is_non_dominated


def _slab_cells(ref: np.ndarray, P: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Exact decomposition of {y >= ref : no p in P dominates y} into
    half-open boxes. P: (n, m) in maximization orientation. Returns
    (lo, hi), each (K, m); upper boundary cells extend to +inf."""
    m = ref.shape[0]
    if len(P) == 0:
        return ref[None, :].copy(), np.full((1, m), np.inf)
    if m == 1:
        lo = max(float(P.max()), float(ref[0]))
        return np.asarray([[lo]]), np.asarray([[np.inf]])
    zs = np.unique(np.concatenate([ref[-1:], P[:, -1][P[:, -1] > ref[-1]]]))
    zs = np.concatenate([zs, [np.inf]])
    los, his = [], []
    for z0, z1 in zip(zs[:-1], zs[1:]):
        # a point can dominate the slab's interior (y[-1] > z0) only if its
        # own last coordinate reaches the next grid line
        sub = P[P[:, -1] >= z1, :-1]
        if len(sub) > 1:
            sub = sub[is_non_dominated(sub).numpy()]
        slo, shi = _slab_cells(ref[:-1], sub)
        k = len(slo)
        los.append(np.column_stack([slo, np.full(k, z0)]))
        his.append(np.column_stack([shi, np.full(k, z1)]))
    return np.concatenate(los, axis=0), np.concatenate(his, axis=0)


def _grid_cells(ref: np.ndarray, P: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The (n+1)^m coordinate-grid decomposition; exact but exponential in
    m. The golden oracle the slab decomposition is tested against."""
    m = ref.shape[0]
    if len(P) == 0:
        return ref[None, :].copy(), np.full((1, m), np.inf)
    axes = []
    for j in range(m):
        vals = np.unique(np.concatenate([[ref[j]], P[:, j][P[:, j] > ref[j]]]))
        axes.append(np.concatenate([vals, [np.inf]]))
    lowers = np.meshgrid(*[a[:-1] for a in axes], indexing="ij")
    uppers = np.meshgrid(*[a[1:] for a in axes], indexing="ij")
    lo = np.stack([g.ravel() for g in lowers], axis=1)
    hi = np.stack([g.ravel() for g in uppers], axis=1)
    # grid lines pass through pareto coordinates, so p dominates the open
    # cell interior iff p > lo in all coordinates
    dominated = np.any(np.all(P[None, :, :] > lo[:, None, :], axis=2), axis=1)
    keep = ~dominated
    return lo[keep], hi[keep]


class NondominatedPartitioning:
    """Exact hypercell decomposition of the non-dominated region.

    Parameters mirror the reference class: `ref_point` (m,), `Y` (n, m) in
    MAXIMIZATION orientation.
    """

    def __init__(self, ref_point, Y):
        self.ref_point = np.asarray(ref_point, dtype=float).ravel()
        Y = np.asarray(Y, dtype=float)
        if Y.ndim == 1:
            Y = Y.reshape(1, -1)
        self.num_outcomes = self.ref_point.shape[0]
        if Y.shape[1] != self.num_outcomes:
            raise ValueError("Y and ref_point dimensionality mismatch")
        self.pareto_Y = Y[is_non_dominated(Y).numpy()]
        # only points strictly above ref in EVERY coordinate can dominate
        # any part of {y >= ref} beyond a measure-zero boundary
        P = self.pareto_Y[np.all(self.pareto_Y > self.ref_point, axis=1)]
        self.cell_lower, self.cell_upper = _slab_cells(self.ref_point, P)

    def get_hypercell_bounds(self) -> np.ndarray:
        """(2, K, m) stacked [lower, upper] bounds (reference surface)."""
        return np.stack([self.cell_lower, self.cell_upper], axis=0)

    def compute_hypervolume(self) -> float:
        return hypervolume(self.pareto_Y, self.ref_point)


FastNondominatedPartitioning = NondominatedPartitioning

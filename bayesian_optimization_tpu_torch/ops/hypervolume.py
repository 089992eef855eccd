"""Hypervolume indicator.

Counterpart of bayesian_optimization_tpu/ops/hypervolume.py (ref parity:
bayes_optim/utils/multi_objective/hypervolume.py:20-307, [Fonseca2006]):
an exact grid-cell algorithm -- the dominated region's boundaries align with
the coordinates of the front, so summing the volumes of dominated grid cells
is exact -- in numpy on the host (m <= 2 uses the classic sweep), and the
port's WFG routine in host C++ (native/wfg.cpp) for larger fronts. Where the
JAX package falls back to the grid when its WFG build fails, the port
raises: the value would be the same, the time not (~7 s at 40 x 4).

Convention: MAXIMIZATION w.r.t. a reference point `ref` (matching the
reference/BoTorch semantics); points <= ref contribute nothing.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ..native import wfg_hypervolume

# fronts whose grid, len(Y) * (len(Y) + 1) ** m cells x points, reaches this
# go to the WFG routine; below it the grid is cheap
NATIVE_MIN_WORK = 20000


def hypervolume(Y, ref) -> float:
    """Exact hypervolume dominated by rows of Y[n, m] above `ref`."""
    Y = np.asarray(Y, dtype=float)
    if Y.ndim == 1:
        Y = Y.reshape(1, -1)
    ref = np.asarray(ref, dtype=float).ravel()
    m = ref.shape[0]
    if Y.shape[0] == 0:
        return 0.0
    # clip below at ref; drop points that dominate nothing
    Yc = np.maximum(Y, ref)
    Yc = Yc[np.any(Yc > ref, axis=1)]
    if len(Yc) == 0:
        return 0.0
    if m == 1:
        return float(Yc.max() - ref[0])
    if m == 2:
        return _hv_2d(Yc, ref)
    if len(Yc) * (len(Yc) + 1) ** m >= NATIVE_MIN_WORK:
        return wfg_hypervolume(Yc, ref)
    return _hv_grid(Yc, ref)


def _hv_2d(Y: np.ndarray, ref: np.ndarray) -> float:
    """Classic sweep for two objectives."""
    order = np.argsort(-Y[:, 0])
    hv, y2_max = 0.0, ref[1]
    for i in order:
        y1, y2 = Y[i]
        if y2 > y2_max:
            hv += (y1 - ref[0]) * (y2 - y2_max)
            y2_max = y2
    return float(hv)


def _hv_grid(Y: np.ndarray, ref: np.ndarray) -> float:
    """Exact grid-cell summation for m >= 3 (cells aligned with front
    coordinates are either fully dominated or fully not)."""
    m = Y.shape[1]
    axes = [np.unique(np.concatenate([[ref[j]], Y[:, j]])) for j in range(m)]
    lowers = np.meshgrid(*[a[:-1] for a in axes], indexing="ij")
    uppers = np.meshgrid(*[a[1:] for a in axes], indexing="ij")
    lo = np.stack([g.ravel() for g in lowers], axis=1)  # (K, m)
    hi = np.stack([g.ravel() for g in uppers], axis=1)
    # cell dominated <=> some y >= cell upper corner in all coords
    dominated = np.any(np.all(Y[None, :, :] >= hi[:, None, :], axis=2), axis=1)
    vol = np.prod(hi - lo, axis=1)
    return float(vol[dominated].sum())


class Hypervolume:
    """Object API mirroring the reference's vendored class
    (ref: hypervolume.py:20-307): `Hypervolume(ref_point).compute(Y)`."""

    def __init__(self, ref_point: Sequence[float]):
        self.ref_point = np.asarray(ref_point, dtype=float)

    def compute(self, pareto_Y) -> float:
        return hypervolume(np.asarray(pareto_Y, dtype=float), self.ref_point)

"""Constrained sampling via Sequential Constrained Monte Carlo (SCMC).

Capability parity with the reference's SCMC sampler
(ref: bayes_optim/search_space/samplers.py:28-248, after [GolchiL15]):
soft-constraint log-posterior `sum_i log Phi(-C_i(x) / nu)` with `nu`
annealed over a log-spaced ladder down to `tol / 8`, Metropolis-Hastings
moves per variable type (Gaussian for reals, double-geometric for integers,
uniform level resampling for categoricals).

TPU-first design difference: the reference mutates and accepts one particle
coordinate at a time in Python loops; here every MH sweep proposes and
accepts across the *whole particle population at once* (vectorized accept
mask). User constraint callables are black-box per-point functions, so they
are evaluated in a thin host loop — swap in `vector_constraints=True` when
the callable accepts an (N, dim) batch to remove that loop too.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
from scipy.stats import norm

from .variables import Real
from .space import SearchSpace


class SCMC:
    """Sequential constrained Monte-Carlo sampler over a mixed search space."""

    def __init__(
        self,
        space: SearchSpace,
        h: Optional[Callable] = None,
        g: Optional[Callable] = None,
        tol: float = 1e-2,
        n_temperature_steps: int = 20,
        n_sweeps: int = 17,
        vector_constraints="auto",
        rng: Optional[np.random.Generator] = None,
    ):
        self.space = space
        self.h, self.g = h, g
        self.tol = tol
        self.rng = rng or space._rng
        self.n_temperature_steps = n_temperature_steps
        self.n_sweeps = n_sweeps
        # True: constraints take (N, dim) batches; False: per-point loop;
        # "auto" (default): probe once — call the constraint on a 2-row
        # batch and keep the batch path iff it reproduces the per-point
        # values, so numpy-vectorizable constraints never pay the host loop
        self.vector_constraints = vector_constraints
        # anneal nu from a loose 10 down to tol/8 (ref parity: samplers.py:76-78)
        self.nu_schedule = np.logspace(1, np.log10(tol / 8.0), n_temperature_steps)
        self._real_idx = [i for i, v in enumerate(space.data) if isinstance(v, Real)]
        self._disc_idx = [i for i, v in enumerate(space.data) if not isinstance(v, Real)]

    # ------------------------------------------------------------------
    def _constraint_values(self, X: np.ndarray) -> np.ndarray:
        """Stack |h| and g into one violation array C: (N, n_con); feasibility
        corresponds to C <= 0 (equalities appear as |h| which the soft
        posterior drives towards 0)."""

        def one(x):
            parts = []
            if self.h is not None:
                parts.append(np.abs(np.atleast_1d(np.asarray(self.h(x), dtype=float))))
            if self.g is not None:
                parts.append(np.atleast_1d(np.asarray(self.g(x), dtype=float)))
            return np.concatenate(parts) if parts else np.zeros(0)

        def batch(Xb):
            def as_cols(a):
                a = np.asarray(a, dtype=float)
                # a 1-D return of length N is one constraint per ROW
                return a[:, None] if a.ndim == 1 else a

            parts = []
            if self.h is not None:
                parts.append(np.abs(as_cols(self.h(Xb))))
            if self.g is not None:
                parts.append(as_cols(self.g(Xb)))
            return np.hstack(parts) if parts else np.zeros((len(Xb), 0))

        if self.vector_constraints == "auto":
            # one-time probe: does the user callable broadcast over rows?
            try:
                k = min(2, len(X))
                per = np.array([one(x) for x in X[:k]])
                vec = batch(X[:k])
                self.vector_constraints = (
                    vec.shape == per.shape and np.allclose(vec, per, equal_nan=True)
                )
            except Exception:  # noqa: BLE001 - any failure => per-point loop
                self.vector_constraints = False

        try:
            if self.vector_constraints:
                return batch(X)
            return np.array([one(x) for x in X])
        except Exception as e:  # noqa: BLE001 - user constraint crashed
            from ..utils.exceptions import ConstraintEvaluationError

            raise ConstraintEvaluationError(
                f"constraint evaluation failed during SCMC sampling: {e}"
            ) from None

    def _log_posterior(self, X: np.ndarray, nu: float) -> np.ndarray:
        C = self._constraint_values(X)
        if C.shape[1] == 0:
            return np.zeros(len(X))
        with np.errstate(divide="ignore"):
            lp = norm.logcdf(-C / nu).sum(axis=1)
        return lp

    # ------------------------------------------------------------------
    def _propose(self, X: np.ndarray, scale: float) -> np.ndarray:
        """Population-wide proposal: perturb every coordinate of every
        particle according to its type."""
        Xn = X.copy()
        N = len(X)
        for j in self._real_idx:
            var = self.space.data[j]
            lo, hi = var.bounds
            width = (hi - lo) * scale
            x = np.asarray(X[:, j], dtype=float) + self.rng.normal(0.0, width, N)
            # reflect into the box
            x = _reflect(x, lo, hi)
            Xn[:, j] = var.round(x)
        for j in self._disc_idx:
            var = self.space.data[j]
            n = var.n_levels
            cur = np.array([var.level_of(v) for v in X[:, j]])
            if getattr(var, "is_ordered", False):
                # double-geometric jump (ref parity: samplers.py:129-142)
                p = max(1.0 / n, 0.2)
                step = self.rng.geometric(p, N) - self.rng.geometric(p, N)
                lev = np.clip(cur + step, 0, n - 1)
            else:
                lev = self.rng.integers(0, n, N)
            # only move a random subset of discrete coords each sweep
            move = self.rng.random(N) < 0.5
            lev = np.where(move, lev, cur)
            Xn[:, j] = np.array([var.value_of(k) for k in lev], dtype=object)
        return Xn

    def sample(self, n: int) -> np.ndarray:
        """Draw `n` (approximately) feasible particles."""
        X = self.space._sample(n, method="LHS")
        lp = self._log_posterior(X, self.nu_schedule[0])
        for nu in self.nu_schedule:
            lp = self._log_posterior(X, nu)
            for sweep in range(self.n_sweeps):
                scale = 0.3 * (0.95**sweep)
                Xn = self._propose(X, scale)
                lpn = self._log_posterior(Xn, nu)
                accept = np.log(self.rng.random(n)) < (lpn - lp)
                X[accept] = Xn[accept]
                lp = np.where(accept, lpn, lp)
        return X


def _reflect(x: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """Reflect values back into [lo, hi] (mirror at the boundaries)."""
    width = hi - lo
    if width <= 0:
        return np.full_like(x, lo)
    y = np.mod(x - lo, 2 * width)
    y = np.where(y > width, 2 * width - y, y)
    return lo + y

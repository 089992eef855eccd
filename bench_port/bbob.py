"""BBOB noiseless functions F8 (Rosenbrock) and F10 (rotated ellipsoid)
with the instance machinery they use, on the host in numpy.

Frozen copy of benchmark/bbob.py (its `_rng`, `_rotation`, `_x_opt`,
`_f_opt`, `_t_osz`, `_f8_rosenbrock`, `_f10_rotated_ellipsoid` and the
`BBOBFunction` constructor for these two ids), itself written from the BBOB
function definitions (Hansen et al., "Real-Parameter Black-Box Optimization
Benchmarking: Noiseless Functions Definitions"). The benchmark keeps its
own copy so that the objective a cell evaluates cannot change with the
repository's module.
"""
from __future__ import annotations

import numpy as np


def _rng(fid: int, instance: int, dim: int, salt: int = 0) -> np.random.Generator:
    return np.random.default_rng(1000003 * fid + 101 * instance + dim + 7919 * salt)


def _rotation(fid: int, instance: int, dim: int, salt: int) -> np.ndarray:
    """Random orthogonal matrix via QR of a Gaussian matrix."""
    g = _rng(fid, instance, dim, salt)
    Q, R = np.linalg.qr(g.standard_normal((dim, dim)))
    return Q * np.sign(np.diag(R))


def _x_opt(fid: int, instance: int, dim: int) -> np.ndarray:
    return _rng(fid, instance, dim, 1).uniform(-4, 4, dim)


def _f_opt(fid: int, instance: int) -> float:
    v = np.round(100.0 * _rng(fid, instance, 1, 2).standard_cauchy() / 10.0, 2)
    return float(np.clip(v, -1000, 1000))


def _t_osz(x: np.ndarray) -> np.ndarray:
    """Oscillation transform T_osz."""
    xhat = np.where(x != 0, np.log(np.abs(x) + 1e-300), 0.0)
    c1 = np.where(x > 0, 10.0, 5.5)
    c2 = np.where(x > 0, 7.9, 3.1)
    return np.sign(x) * np.exp(xhat + 0.049 * (np.sin(c1 * xhat) + np.sin(c2 * xhat)))


def _f8_rosenbrock(p, X):
    z = np.maximum(1.0, np.sqrt(p.dim) / 8.0) * (X - p.x_opt) + 1.0
    return np.sum(100.0 * (z[:, :-1] ** 2 - z[:, 1:]) ** 2 + (z[:, :-1] - 1.0) ** 2, axis=-1)


def _f10_rotated_ellipsoid(p, X):
    z = _t_osz((X - p.x_opt) @ p.R.T)
    w = 10.0 ** (6.0 * np.arange(p.dim) / max(p.dim - 1, 1))
    return np.sum(w * z**2, axis=-1)


_CORES = {8: _f8_rosenbrock, 10: _f10_rotated_ellipsoid}


class BBOBFunction:
    """One (fid, instance, dim) problem: f(X (N, dim)) -> (N,), or a float
    for a single point."""

    def __init__(self, fid: int, dim: int, instance: int = 1):
        if fid not in _CORES:
            raise ValueError(f"F{fid} is not in the benchmark's copy; available: {sorted(_CORES)}")
        self.fid, self.dim, self.instance = fid, dim, instance
        self.x_opt = _x_opt(fid, instance, dim)
        self.f_opt = _f_opt(fid, instance)
        self.R = _rotation(fid, instance, dim, 3)
        self._core = _CORES[fid]

    def __call__(self, X):
        X = np.asarray(X, dtype=float)
        single = X.ndim == 1
        out = self._core(self, np.atleast_2d(X)) + self.f_opt
        return float(out[0]) if single else out

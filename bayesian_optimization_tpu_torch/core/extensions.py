"""PCA-assisted BO and conditional-space BO.

Counterpart of `PCABO` and `LinearTransform` in
bayesian_optimization_tpu/core/extensions.py (ref parity:
bayes_optim/extension.py:21-208) [RaponiWB+20]: rank-weighted centering
`w = log N - log rank`, BO in the PCA-reduced space, ask inverse-transforms,
tell re-fits the PCA and rebuilds the reduced RealSpace and a fresh GP every
iteration, and the acquisition carries an out-of-original-box penalty
(reserved `_pca*` parameters of the criterion, optim/argmax.py). The GP and
the argmax run on `device=`.

`ConditionalBO` (ref parity: extension.py:211-306): one sub-BO with a
random-forest surrogate per unconditional subspace of the condition tree,
the first asks walking the subspaces in order and later ones drawing a
subspace from the optimizer's numpy generator, dict-based ask/tell with
`None` for inactive variables. Each forest grows on `device=`, seeded from
`random_seed`.
"""
from __future__ import annotations

from copy import deepcopy
from typing import List, Optional, Union

import numpy as np
from scipy.stats import rankdata

from .._device import DEFAULT_DEVICE
from ..models.gp import GaussianProcess
from ..models.random_forest import RandomForest
from ..models.trend import constant_trend
from ..optim.argmax import AcquisitionArgmax
from ..space import RealSpace
from ..utils.logging import timed_phase
from .bo import BO, ParallelBO
from .solution import Solution


class LinearTransform:
    """Rank-weighted PCA (ref parity: extension.py:21-58) on numpy's SVD."""

    def __init__(self, n_components: Union[int, float, None] = None, minimize: bool = True):
        self.n_components = n_components
        self.minimize = minimize

    def fit(self, X: np.ndarray, y: np.ndarray) -> "LinearTransform":
        X = np.asarray(X, dtype=float)
        y = np.asarray(y, dtype=float).ravel()
        self.center = X.mean(axis=0)
        Xc = X - self.center
        y_ = y if self.minimize else -y
        r = rankdata(y_)
        N = len(y_)
        w = np.log(N) - np.log(r)
        w = w / np.sum(w)
        Xs = Xc * w.reshape(-1, 1)
        self.mean_ = Xs.mean(axis=0)
        _, S, Vt = np.linalg.svd(Xs - self.mean_, full_matrices=False)
        var = S**2
        k = len(S)
        if isinstance(self.n_components, int):
            k = min(self.n_components, k)
        elif isinstance(self.n_components, float):
            frac = np.cumsum(var) / max(var.sum(), 1e-300)
            k = int(np.searchsorted(frac, self.n_components) + 1)
        k = max(1, min(k, len(S)))
        self.components_ = Vt[:k]  # (k, D)
        self.explained_variance_ = var[:k]
        return self

    def transform(self, X: np.ndarray) -> np.ndarray:
        return (np.asarray(X, dtype=float) - self.center - self.mean_) @ self.components_.T

    def fit_transform(self, X, y) -> np.ndarray:
        return self.fit(X, y).transform(X)

    def inverse_transform(self, Z: np.ndarray) -> np.ndarray:
        if not hasattr(self, "components_"):
            return np.asarray(Z, dtype=float)
        return np.asarray(Z, dtype=float) @ self.components_ + self.mean_ + self.center


class PCABO(BO):
    """High-dimensional BO via supervised PCA (ref parity: extension.py:89-208)."""

    def __init__(
        self,
        n_components: Union[float, int, None] = None,
        incumbent_injection: bool = False,
        theta_warm_start: bool = False,
        **kwargs,
    ):
        kwargs.pop("model", None)
        super().__init__(model=_DummyUnfitted(), **kwargs)
        if not isinstance(self._search_space, RealSpace):
            raise ValueError("PCABO requires a RealSpace")
        self._original_space = deepcopy(self._search_space)
        self._pca = LinearTransform(n_components=n_components, minimize=self.minimize)
        self._incumbent_injection = bool(incumbent_injection)
        self._theta_warm_start = bool(theta_warm_start)
        self._enc_cache, self._argmax_cache = {}, {}

    @staticmethod
    def _compute_bounds(pca: LinearTransform, space: RealSpace) -> List[List[float]]:
        """Sphere-radius bounds in component space (ref parity:
        extension.py:113-119)."""
        bounds = np.asarray(space.bounds, dtype=float)
        C = bounds.mean(axis=1)
        radius = float(np.sqrt(np.sum((bounds[:, 0] - C) ** 2)))
        C_ = (C - pca.mean_ - pca.center) @ pca.components_.T
        return [[c - radius, c + radius] for c in C_]

    def pre_eval_check(self, X: List) -> List:
        # points are proposed in a changing reduced space; duplicates in the
        # original space are possible and tolerated (ref parity: :131-137)
        return [list(r) for r in np.atleast_2d(np.asarray(X, dtype=object))] if len(X) else X

    @timed_phase("ask")
    def ask(self, n_point: Optional[int] = None, fixed: Optional[dict] = None):
        if getattr(self.model, "is_fitted", False):
            n_point = self.n_point if n_point is None else int(n_point)
            candidates = self.arg_max_acquisition(n_point=n_point)
            X = self._pca.inverse_transform(np.asarray(candidates, dtype=float))
            X = np.clip(
                X,
                [b[0] for b in self._original_space.bounds],
                [b[1] for b in self._original_space.bounds],
            )
            return [list(map(float, row)) for row in X]
        n_point = self._DoE_size if n_point is None else int(n_point)
        S = self._original_space.sample(n_point, method="LHS" if n_point > 1 else "uniform")
        return [list(map(float, row)) for row in np.atleast_2d(S)]

    @timed_phase("tell")
    def tell(self, new_X, new_y, **kwargs):
        new_y = np.asarray(new_y, dtype=float).reshape(len(new_X), -1)
        start = len(self.data) if self.data is not None else 0
        sol = Solution(
            new_X, fitness=new_y, n_eval=np.ones(len(new_X), int),
            index=np.arange(start, start + len(new_X)),
            var_name=self._original_space.var_name,
        )
        sol = self.post_eval_check(sol)
        self.data = self.data + sol if self.data is not None else sol
        self.eval_count += len(sol)
        self.iter_count += 1

        # re-fit the PCA and rebuild the reduced space + fresh GP (ref :154-208)
        X_red = self._pca.fit_transform(
            np.asarray(self.data.values, dtype=float), self.data.fitness[:, 0]
        )
        bounds = self._compute_bounds(self._pca, self._original_space)
        self._search_space = RealSpace(bounds)
        # one SpaceEncoding and argmax per reduced dimension, kept across
        # iterations as the JAX package keeps them (its argmax carries its
        # random stream); only the bound arrays are refreshed
        k = len(bounds)
        if k not in self._enc_cache:
            self._enc_cache[k] = self._search_space.encoding()
            self._argmax_cache[k] = AcquisitionArgmax(
                self._enc_cache[k], method="BFGS", seed=(self.random_seed or 0) + 17 + k,
                device=self.device,
            )
        enc = self._enc_cache[k]
        enc.space = self._search_space
        b = np.asarray(bounds, dtype=float)
        enc.lo_t, enc.hi_t = b[:, 0].copy(), b[:, 1].copy()
        self.encoding = enc
        self._argmax = self._argmax_cache[k]
        self._update_model_reduced(X_red, self.data.fitness[:, 0])
        self.hist_f.append(self.xopt.fitness.ravel().copy())

    def _incumbent_seed(self) -> Optional[np.ndarray]:
        """The incumbent best, projected into the current reduced space and
        encoded to the unit cube: injected into the argmax restart pool."""
        if not self._incumbent_injection or self.data is None or not len(self.data):
            return None
        fit = self.data.fitness[:, 0]
        i = int(np.argmin(fit) if self.minimize else np.argmax(fit))
        x = np.asarray(self.data.values[i], dtype=float).reshape(1, -1)
        z = self._pca.transform(x)
        u = self.encoding.encode_unit(np.asarray(z, dtype=object))
        return np.clip(np.asarray(u, dtype=float), 0.0, 1.0)

    def _update_model_reduced(self, X_red: np.ndarray, y: np.ndarray):
        k = X_red.shape[1]
        # theta bounds track the reduced-box width w: the reference bounds
        # theta by 1e-3/1e3 times the width on raw coordinates
        # (ref: extension.py:188-196), which on unit coordinates is a w^3
        # window
        b = np.asarray(self._search_space.bounds, dtype=float)
        w3 = (b[:, 1] - b[:, 0]) ** 3
        self.model = GaussianProcess(
            mean=constant_trend(k), corr="matern",
            thetaL=1e-3 * w3, thetaU=1e3 * w3,
            nugget=1e-6, likelihood="concentrated",
            random_start=max(10, k), random_state=self.random_seed, device=self.device,
        )
        # already in unit convention: never rescaled again
        self.model._theta_bounds_unit_scaled = True
        # warm-start theta across the per-iteration GP rebuilds (the reduced
        # box width is iteration-invariant): it seeds restart 0 of the ladder
        prev = getattr(self, "_prev_theta", None) if self._theta_warm_start else None
        if prev is not None and len(prev) == k:
            self.model.theta_ = np.asarray(prev, dtype=float)
        std = np.std(y)
        y_ = y if np.isclose(std, 0) else (y - np.mean(y)) / std
        self._fitness_mean = float(np.mean(y)) if not np.isclose(std, 0) else 0.0
        self._fitness_std = float(std) if not np.isclose(std, 0) else 1.0
        self.fmin, self.fmax = float(np.min(y_)), float(np.max(y_))
        self.frange = self.fmax - self.fmin
        # the GP fits on the unit encoding of the reduced space
        U = self.encoding.encode_unit(np.asarray(X_red, dtype=object))
        E = self.encoding.unit_to_embed_np(U)
        self.model.fit(E, y_.reshape(-1, 1))
        self._prev_theta = np.asarray(self.model.theta_, dtype=float).copy()

    def _acq_par_defaults(self, par: dict) -> dict:
        out = super()._acq_par_defaults(par)
        # out-of-box penalty parameters (consumed by optim/argmax.py)
        red_bounds = np.asarray(self._search_space.bounds, dtype=float)
        orig_bounds = np.asarray(self._original_space.bounds, dtype=float)
        out.update(
            _pca_C=self._pca.components_,
            _pca_offset=self._pca.mean_ + self._pca.center,
            _box_lo=orig_bounds[:, 0],
            _box_hi=orig_bounds[:, 1],
            _red_lo=red_bounds[:, 0],
            _red_hi=red_bounds[:, 1],
        )
        return out

    def arg_max_acquisition(self, n_point=None, return_value: bool = False, fixed=None):
        """Candidates in reduced-space coordinates. For q > 1 the q argmaxes
        (independent restart pools of the same criterion) run as one
        population, like ParallelBO's."""
        n_point = self.n_point if n_point is None else int(n_point)
        seed = self._incumbent_seed()
        if n_point == 1:
            u, v = self._argmax_one(
                self._acq_par_defaults(self._acquisition_par), None, x0_seed=seed
            )
            us, vals = [u], [v]
        else:
            pars = [self._acq_par_defaults(dict(self._acquisition_par)) for _ in range(n_point)]
            us, vals = self._argmax.batch(
                self.model.posterior, self.model.config, self.acquisition_fun,
                pars, minimize=self.minimize, fixed=None, x0_seed=seed,
            )
        out = []
        for u in us:
            z = self.encoding.decode_unit(np.asarray(u)[None, :])[0]
            out.append([float(x) for x in z])
        return (out, vals) if return_value else out


class _DummyUnfitted:
    is_fitted = False


class ConditionalBO(ParallelBO):
    """BO over conditional spaces: one random-forest sub-BO per
    unconditional subspace (ref parity: extension.py:211-306)."""

    def __init__(self, **kwargs):
        kwargs.setdefault("acquisition_fun", "MGFI")
        n_point = kwargs.get("n_point", 1)
        # ParallelBO requires n_point > 1; the asks use the caller's n_point
        kwargs["n_point"] = max(2, n_point)
        super().__init__(model=self._forest(kwargs), **kwargs)
        self.n_point = n_point
        self._create_subspace_optimizers(**kwargs)
        self._bo_idx: List[int] = []

    @staticmethod
    def _forest(kwargs) -> RandomForest:
        return RandomForest(feature_space="embedding", random_state=kwargs.get("random_seed"),
                            device=kwargs.get("device", DEFAULT_DEVICE))

    def _create_subspace_optimizers(self, **kwargs):
        for key in (
            "DoE_size", "n_point", "search_space", "eval_type", "model",
            "acquisition_fun", "acquisition_par", "obj_fun", "parallel_obj_fun",
        ):
            kwargs.pop(key, None)
        self.subspaces = self.search_space.get_unconditional_subspace()
        self._bo = [
            BO(search_space=cs, DoE_size=1, n_point=1, eval_type="dict",
               model=self._forest(kwargs), acquisition_fun="MGFI", acquisition_par={"t": 2.0},
               **kwargs)
            for _, cs in self.subspaces
        ]
        self.n_subspace = len(self.subspaces)
        self._init_gen = iter(range(self.n_subspace))
        self._fixed_vars = [dict(d) for d, _ in self.subspaces]

    def select_subspace(self, n_point: int) -> List[int]:
        if n_point <= 0:
            return []
        return self._rng.choice(self.n_subspace, n_point).tolist()

    @timed_phase("ask")
    def ask(self, n_point: Optional[int] = None, fixed: Optional[dict] = None) -> List[dict]:
        n_point = self.n_point if n_point is None else int(n_point)
        idx: List[int] = []
        for _ in range(n_point):
            nxt = next(self._init_gen, None)
            if nxt is None:
                break
            idx.append(nxt)
        idx += self.select_subspace(n_point - len(idx))
        self._bo_idx = idx
        X = [dict(self._bo[i].ask()[0]) for i in idx]
        for i, k in enumerate(idx):
            X[i].update(self._fixed_vars[k])
            X[i].update({name: None for name in set(self.var_names) - set(X[i])})
        return X

    @timed_phase("tell")
    def tell(self, X: List[dict], func_vals, warm_start: bool = False, **kwargs):
        if len(self._bo_idx) != len(X):
            raise ValueError("tell must follow the matching ask")
        for i, k in enumerate(self._bo_idx):
            sub_names = set(self._bo[k].var_names)
            self._bo[k].tell([{n: v for n, v in X[i].items() if n in sub_names}], [func_vals[i]])
        rows = [[d.get(name) for name in self.var_names] for d in X]
        start = len(self.data) if self.data is not None else 0
        sol = Solution(
            rows, fitness=np.asarray(func_vals, dtype=float).reshape(len(X), -1),
            n_eval=np.ones(len(X), int), index=np.arange(start, start + len(X)),
            var_name=self.var_names,
        )
        self.data = self.data + sol if self.data is not None else sol
        self.eval_count += len(X)
        if not warm_start:
            self.iter_count += 1
            self.hist_f.append(self.xopt.fitness.ravel().copy())

    def _to_pheno(self, X: Solution):
        return [dict(zip(self.var_names, row)) for row in X.values]

    def step(self):
        X = self.ask()
        self.tell(X, [self.obj_fun(x) for x in X])

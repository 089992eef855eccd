"""Ask–evaluate–tell optimizer skeleton and the BO engine core.

Capability parity with the reference's two base classes:
- `BaseOptimizer` (ref: bayes_optim/_base.py:14-179): ask/tell/step/run
  loop, three objective-evaluation modes (user-batched `parallel_obj_fun`,
  joblib pool `n_job`, sequential), stop conditions max_FEs/ftarget,
  `xopt`/`recommend`.
- `BaseBO` (ref: bayes_optim/base.py:31-540): DoE (default 5*dim, LHS),
  warm data, geno/pheno codecs (list vs dict eval types), internal
  acquisition-optimizer selection, ask with duplicate back-fill from random
  design, tell with fitness standardization + model refit + r2 logging,
  NaN/inf row dropping, flat-fitness guard, fixed-variable asks, dill
  save/load checkpointing.

PyTorch port of bayesian_optimization_tpu/core/base.py. The GP and the
acquisition argmax are the port's (models/gp.py, optim/argmax.py), both on
the device named by `device=` (default "cuda"). Not ported yet (they raise):
constraints (eq_fun/ineq_fun), particle meshes, a NonparametricTrend prior
and non-GP surrogates.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from .._device import DEFAULT_DEVICE, resolve_device
from ..models.gp import GaussianProcess
from ..models.trend import constant_trend
from ..optim.argmax import AcquisitionArgmax
from ..space import SearchSpace
from ..utils import (
    AskEmptyError,
    FlatFitnessError,
    ObjectiveEvaluationError,
    RecommendationUnavailableError,
    get_logger,
)
from ..utils.expr import evaluate_size
from ..utils.logging import PhaseTimer, timed_phase
from .solution import Solution


class BaseOptimizer:
    """Ask/tell/step/run skeleton (ref parity: _base.py:14-179)."""

    def __init__(
        self,
        search_space: SearchSpace,
        n_obj: int = 1,
        obj_fun: Optional[Callable] = None,
        parallel_obj_fun: Optional[Callable] = None,
        eq_fun: Optional[Callable] = None,
        ineq_fun: Optional[Callable] = None,
        n_job: int = 1,
        ftarget: Optional[float] = None,
        max_FEs: Optional[Union[int, str]] = None,
        minimize: bool = True,
        verbose: bool = False,
        log_file: Optional[str] = None,
        random_seed: Optional[int] = None,
        instance_id: Optional[str] = None,
    ):
        self.search_space = search_space
        self.n_obj = int(n_obj)
        self.obj_fun = obj_fun
        self.parallel_obj_fun = parallel_obj_fun
        self.h = eq_fun
        self.g = ineq_fun
        self.n_job = max(1, int(n_job))
        self.ftarget = ftarget
        self.minimize = minimize
        self.verbose = verbose
        if isinstance(max_FEs, str):
            # "100*dim" convenience via the whitelisted-AST parser, NOT eval()
            max_FEs = evaluate_size(max_FEs, self.dim)
        self.max_FEs = int(max_FEs) if max_FEs else np.inf

        self.random_seed = random_seed
        self._rng = np.random.default_rng(random_seed)
        self.instance_id = instance_id or str(id(self))
        self.iter_count = 0
        self.eval_count = 0
        self.stop_dict: Dict[str, object] = {}
        self.hist_f: List = []
        self._timer = PhaseTimer()
        self.logger = get_logger(
            f"{type(self).__name__}({self.instance_id})", file=log_file, console=verbose
        )

    # ------------------------------------------------------------- space
    @property
    def search_space(self) -> SearchSpace:
        return self._search_space

    @search_space.setter
    def search_space(self, space: SearchSpace):
        self._search_space = space
        self.dim = space.dim
        self.var_names = space.var_name
        self.r_index = space.real_id
        self.i_index = space.integer_id
        self.d_index = space.categorical_id

    # ------------------------------------------------------------ control
    def ask(self, n_point=None, fixed=None):  # pragma: no cover - abstract
        raise NotImplementedError

    def tell(self, X, func_vals, **kwargs):  # pragma: no cover - abstract
        raise NotImplementedError

    def step(self):
        X = self.ask()
        func_vals = self.evaluate(X)
        self.tell(X, func_vals)

    @timed_phase("evaluate")
    def evaluate(self, X) -> List[float]:
        """Three execution modes (ref parity: _base.py:110-121)."""
        try:
            if self.parallel_obj_fun is not None:
                return list(self.parallel_obj_fun(X))
            if self.n_job > 1:
                from joblib import Parallel, delayed

                return list(Parallel(n_jobs=self.n_job)(delayed(self.obj_fun)(x) for x in X))
            return [self.obj_fun(x) for x in X]
        except Exception as e:
            raise ObjectiveEvaluationError(str(e)) from e

    def check_stop(self) -> bool:
        if self.eval_count >= self.max_FEs:
            self.stop_dict["max_FEs"] = self.eval_count
        if self.ftarget is not None and self.xopt is not None:
            f = float(np.atleast_1d(self.xopt.fitness).ravel()[0])
            if (f < self.ftarget) if self.minimize else (f > self.ftarget):
                self.stop_dict["ftarget"] = f
        return bool(self.stop_dict)

    def run(self):
        while not self.check_stop():
            self.step()
        xopt = self.xopt
        return self._to_pheno(xopt), xopt.fitness.ravel(), self.stop_dict

    def recommend(self) -> Solution:
        if getattr(self, "data", None) is None or self.xopt is None or len(self.xopt) == 0:
            raise RecommendationUnavailableError()
        return self.xopt

    @property
    def xopt(self) -> Optional[Solution]:
        if getattr(self, "data", None) is None or len(self.data) == 0:
            return None
        f = self.data.fitness[:, 0]
        i = int(np.nanargmin(f) if self.minimize else np.nanargmax(f))
        return self.data[i]

    @property
    def fopt(self) -> float:
        """Best observed objective value (the reference's examples use this
        but its package never defines it — example/example_BO_CMA.py)."""
        xopt = self.xopt
        if xopt is None:
            return np.nan
        return float(xopt.fitness.ravel()[0])

    def _to_pheno(self, X: Solution):
        return X.tolist()

    def _compare(self, f1, f2) -> bool:
        return f1 < f2 if self.minimize else f1 > f2


class BaseBO(BaseOptimizer):
    """The BO engine: DoE + surrogate + acquisition argmax
    (ref parity: base.py:31-540)."""

    def __init__(
        self,
        search_space: SearchSpace,
        model=None,
        DoE_size: Optional[Union[int, str]] = None,
        warm_data: Optional[Tuple] = None,
        n_point: int = 1,
        acquisition_fun: str = "EI",
        acquisition_par: Optional[dict] = None,
        acquisition_optimization: Optional[dict] = None,
        eval_type: str = "list",
        data_file: Optional[str] = None,
        mesh=None,
        device=DEFAULT_DEVICE,
        **kwargs,
    ):
        if mesh is not None:
            raise NotImplementedError("particle meshes are not ported to the GPU package yet")
        self.device = resolve_device(device)
        super().__init__(search_space, **kwargs)
        self.n_point = max(1, int(n_point))
        self.data_file = data_file
        self._eval_type = eval_type
        if eval_type not in ("list", "dict"):
            raise ValueError("eval_type must be 'list' or 'dict'")

        if isinstance(DoE_size, str):
            # "5*dim" convenience via the whitelisted-AST parser, NOT eval()
            DoE_size = evaluate_size(DoE_size, self.dim)
        self._DoE_size = int(DoE_size) if DoE_size else int(self.dim * 5)

        self.acquisition_fun = acquisition_fun
        self._acquisition_par = dict(acquisition_par or {})
        self._acquisition_callbacks: List[Callable] = []

        self.encoding = self._search_space.encoding()
        self._constraints = self._build_constraints()
        self.model = model if model is not None else self._default_model()
        self._rescale_theta_bounds_to_unit()
        self._set_internal_optimization(acquisition_optimization or {})
        self.data: Optional[Solution] = None
        self.fmin = self.fmax = self.frange = None
        self._fitness_mean = 0.0
        self._fitness_std = 1.0
        self._init_flatfitness_trial = 2
        self.warm_data = warm_data

    # --------------------------------------------------------------- setup
    def _default_model(self):
        """GP on the unit-cube embedding for any space (the one-hot blocks
        make categorical distance meaningful); mirrors the reference's GP
        defaults from fmin (ref: __init__.py:147-160): theta bounds
        proportional to the RAW box widths — _rescale_theta_bounds_to_unit
        then maps them onto the unit embedding."""
        enc = self.encoding
        d = enc.d_embed
        w = enc.embed_widths()
        return GaussianProcess(
            mean=constant_trend(d),
            corr="matern",
            thetaL=1e-3 * w,
            thetaU=1e3 * w,
            nugget=1e-6,
            likelihood="concentrated",
            optimizer="BFGS",
            random_start=max(10, d),
            random_state=self.random_seed,
            device=self.device,
        )

    def _rescale_theta_bounds_to_unit(self):
        """Map user GP theta bounds from RAW-coordinate convention to the
        unit embedding the GP actually fits on.

        The reference's kernels compute theta * d^2 with d in RAW variable
        units, and users (and the reference's own defaults,
        ref: __init__.py:149-151) choose thetaL/thetaU against those units.
        Our GP fits on the unit-cube embedding where distances shrink by the
        box width w_j, so the equivalent window is theta_raw * w_j^2 per
        real dimension (one-hot/level dims already live on unit ranges).
        Without this the MLE window is off by w^2 — 100x for [-5, 5] boxes:
        measured on the q=8 MGFI parity config, theta kept pinning at the
        unscaled lower bound (flat kernel directions), regret 2x the
        reference's. Applied ONCE per model. NOTE: the internal default
        model (_default_model) deliberately carries RAW width-proportional
        bounds and NO tag — it relies on exactly this rescale (tagging it
        would silently shrink the default theta window by width^2); only
        PCABO's per-iteration GPs are built directly in unit convention
        and tagged."""
        m = self.model
        if not isinstance(m, GaussianProcess):
            return
        if getattr(m, "_theta_bounds_unit_scaled", False) or m.is_fitted:
            return
        if m.thetaL is None or m.thetaU is None:
            return
        enc = self.encoding
        scale = enc.embed_widths() ** 2
        def expand(v):
            v = np.atleast_1d(np.asarray(v, dtype=float))
            return np.repeat(v, enc.d_embed) if v.size == 1 else v
        tl, tu = expand(m.thetaL), expand(m.thetaU)
        if tl.size != enc.d_embed or tu.size != enc.d_embed:
            return  # custom layout: leave the user's bounds untouched
        m.thetaL = tl * scale
        m.thetaU = tu * scale
        if m.theta0 is not None:
            t0 = expand(m.theta0)
            if t0.size == enc.d_embed:
                m.theta0 = t0 * scale
        m._theta_bounds_unit_scaled = True

    def _build_constraints(self):
        if self.h is not None or self.g is not None:
            raise NotImplementedError("constraints are not ported to the GPU package yet")
        return None

    def _set_internal_optimization(self, opts: dict):
        """Pick the argmax engine (ref parity: base.py:192-229 + option.py)."""
        method = opts.get("optimizer", "auto")
        if method == "auto":
            all_real = bool(np.all(self.encoding.is_real))
            can_grad = isinstance(self.model, GaussianProcess)
            method = "BFGS" if (all_real and can_grad) else "MIES"
        self._optimizer_name = method
        self._argmax = AcquisitionArgmax(
            self.encoding,
            method=method,
            n_restart=opts.get("n_restart"),
            seed=(self.random_seed or 0) + 17,
            device=self.device,
        )

    @property
    def warm_data(self):
        return self._warm_data

    @warm_data.setter
    def warm_data(self, data):
        if data is None or len(data) == 0:
            self._warm_data = None
            return
        X, y = data
        X = [list(x) for x in np.asarray(X, dtype=object)]
        for x in X:
            if x not in self._search_space:
                raise ValueError(f"warm data point {x} outside the search space")
        self._warm_data = (X, list(y))
        self.tell(X, list(y), warm_start=True)

    # ------------------------------------------------------------ codecs
    def _to_pheno(self, X: Solution):
        if self._eval_type == "dict":
            return [dict(zip(self.var_names, row)) for row in np.atleast_2d(X.values)]
        return X.tolist()

    def _to_geno(self, X, index=None) -> Solution:
        if isinstance(X, Solution):
            return X
        if isinstance(X, dict):
            X = [X]
        if len(X) and isinstance(X[0], dict):
            X = [[d[name] for name in self.var_names] for d in X]
        if len(X) and not hasattr(X[0], "__iter__"):
            X = [X]
        idx = index
        if idx is None:
            start = len(self.data) if self.data is not None else 0
            idx = np.arange(start, start + len(X))
        return Solution(X, index=idx, var_name=self.var_names, n_obj=self.n_obj)

    # ------------------------------------------------------------ ask/tell
    @timed_phase("ask")
    def ask(self, n_point: Optional[int] = None, fixed: Optional[dict] = None):
        if self.model is not None and getattr(self.model, "is_fitted", False):
            n_point = self.n_point if n_point is None else int(n_point)
            X = self.arg_max_acquisition(n_point=n_point, fixed=fixed)
            X = self.pre_eval_check(X)
            if len(X) < n_point:
                self.logger.warning(
                    f"iteration {self.iter_count}: duplicated candidates from the "
                    "acquisition argmax; back-filling from random design"
                )
                X = X + self.create_DoE(n_point - len(X), fixed=fixed)
        else:
            n_point = self._DoE_size if n_point is None else int(n_point)
            X = self.create_DoE(n_point, fixed=fixed)
        if len(X) == 0:
            raise AskEmptyError(n_requested=n_point)
        start = len(self.data) if self.data is not None else 0
        sol = Solution(X, index=np.arange(start, start + len(X)), var_name=self.var_names, n_obj=self.n_obj)
        return self._to_pheno(sol)

    @timed_phase("tell")
    def tell(self, X, func_vals, h_vals=None, g_vals=None, index=None, warm_start: bool = False):
        X = self._to_geno(X, index)
        func_vals = np.asarray(func_vals, dtype=float).reshape(len(X), -1)
        X.fitness = func_vals
        X.n_eval = X.n_eval + 1
        if not warm_start:
            self.eval_count += len(X)

        X = self.post_eval_check(X)
        self.data = self.data + X if self.data is not None else X
        self.update_model()
        if self.data_file is not None:
            X.to_csv(self.data_file, header=True, append=True)

        xopt = self.xopt
        self.logger.info(f"fopt: {xopt.fitness.ravel()}")
        if not warm_start:
            self.iter_count += 1
            self.hist_f.append(xopt.fitness.ravel().copy())

    def create_DoE(self, n_point: int, fixed: Optional[dict] = None) -> List:
        """LHS design with fixed-variable fill (ref parity: base.py:362-400)."""
        fixed = fixed or {}
        free_space = self._search_space.filter(list(fixed.keys()), invert=True)
        free_names = free_space.var_name

        def fill(row_free: list) -> list:
            vals = dict(zip(free_names, row_free))
            vals.update(fixed)
            return [vals[name] for name in self.var_names]

        DoE: List[list] = []
        for _ in range(4):
            want = n_point - len(DoE)
            if want <= 0:
                break
            S = free_space.sample(want, method="LHS" if want > 1 else "uniform")
            rows = [fill(list(r)) for r in np.atleast_2d(S)] if len(S) else []
            rows = [r for r in rows if r is not None]
            if rows:
                rows = [list(r) for r in self._search_space.round(rows)]
                DoE += self.pre_eval_check(rows)
        return DoE[:n_point]

    def pre_eval_check(self, X: List) -> List:
        """Drop duplicates within the batch and against history
        (ref parity: bayes_opt.py:27-55, vectorized over unit encodings)."""
        if len(X) == 0:
            return X
        rows = [list(r) for r in np.atleast_2d(np.asarray(X, dtype=object))]
        U_new = self.encoding.encode_unit(np.asarray(rows, dtype=object))
        U_all = (
            np.concatenate([self.encoding.encode_unit(self.data.values), U_new], axis=0)
            if self.data is not None and len(self.data)
            else U_new
        )
        n_old = len(U_all) - len(U_new)
        keep = []
        for i in range(len(U_new)):
            me = U_new[i]
            others = np.delete(U_all, n_old + i, axis=0) if n_old + len(U_new) > 1 else np.zeros((0, U_all.shape[1]))
            dup = np.any(np.all(np.isclose(others, me[None, :], atol=1e-8), axis=1)) if len(others) else False
            prior_dup = any(
                np.all(np.isclose(U_new[j], me, atol=1e-8)) for j in keep
            )
            if not dup and not prior_dup:
                keep.append(i)
        return [rows[i] for i in keep]

    def post_eval_check(self, X: Solution) -> Solution:
        bad = np.isnan(X.fitness).any(axis=1) | np.isinf(X.fitness).any(axis=1)
        if np.any(bad):
            self.logger.warning(f"{int(bad.sum())} candidates dropped: non-finite fitness")
            X = X[~bad]
        return X

    # ----------------------------------------------------------- modelling
    @timed_phase("fit")
    def update_model(self):
        """Standardize fitness and refit the surrogate (ref parity:
        base.py:423-446)."""
        fitness = self.data.fitness[:, 0]
        std = np.std(fitness)
        if len(fitness) > 5 and np.isclose(std, 0):
            raise FlatFitnessError("flat fitness landscape: constant objective values")
        if np.isclose(std, 0):
            fitness_ = fitness.copy()
            self._fitness_mean, self._fitness_std = 0.0, 1.0
        else:
            self._fitness_mean, self._fitness_std = float(np.mean(fitness)), float(std)
            fitness_ = (fitness - self._fitness_mean) / self._fitness_std
        self.fmin, self.fmax = float(np.min(fitness_)), float(np.max(fitness_))
        self.frange = self.fmax - self.fmin

        Xfeat = self._model_features(self.data)
        self.model.fit(Xfeat, fitness_.reshape(-1, 1))
        y_hat = np.asarray(self.model.predict(Xfeat)).ravel()
        ss_res = float(np.sum((fitness_ - y_hat) ** 2))
        ss_tot = float(np.sum((fitness_ - np.mean(fitness_)) ** 2)) or 1.0
        self._r2 = 1.0 - ss_res / ss_tot
        self.logger.info(f"model r2: {self._r2:.4f}")

    def _model_features(self, data: Solution) -> np.ndarray:
        """Features handed to the surrogate: the masked continuous embedding."""
        U = self.encoding.encode_unit(data.values)
        return self.encoding.unit_to_embed_np(U)

    # ----------------------------------------------------- acquisition optim
    def _acq_par_defaults(self, par: dict) -> dict:
        out = dict(par)
        if self.acquisition_fun in ("EI", "PI", "EpsilonPI", "MGFI") and "plugin" not in out:
            out["plugin"] = self.fmin if self.minimize else -self.fmax
        return out

    def _fixed_units(self, fixed: Optional[dict]) -> Optional[Dict[int, float]]:
        if not fixed:
            return None
        row = []
        for name in self.var_names:
            row.append(fixed.get(name, self._search_space[name].default_value))
        # encode only fixed columns; others fed dummy defaults then ignored
        dummy = [v if v is not None else self._search_space[j].bounds[0] for j, v in enumerate(row)]
        U = self.encoding.encode_unit(np.asarray([dummy], dtype=object))[0]
        return {self.var_names.index(k): float(U[self.var_names.index(k)]) for k in fixed}

    @timed_phase("arg_max_acquisition")
    def arg_max_acquisition(self, n_point: Optional[int] = None, return_value: bool = False, fixed: Optional[dict] = None):
        n_point = self.n_point if n_point is None else int(n_point)
        fixed_units = self._fixed_units(fixed)
        if n_point > 1:
            candidates, values = self._batch_arg_max_acquisition(n_point, fixed_units)
        else:
            u, v = self._argmax_one(self._acq_par_defaults(self._acquisition_par), fixed_units)
            candidates, values = [u], [v]
        for cb in self._acquisition_callbacks:
            cb()
        X = [list(r) for r in self.encoding.decode_unit(np.asarray(candidates))]
        return (X, values) if return_value else X

    def _argmax_one(self, acq_par: dict, fixed_units, x0_seed=None) -> Tuple[np.ndarray, float]:
        # the surrogate fits standardized raw fitness, so the criterion must
        # carry the problem's own min/max orientation
        return self._argmax(
            self.model.posterior,
            self.model.config,
            self.acquisition_fun,
            dict(acq_par),
            minimize=self.minimize,
            fixed=fixed_units,
            x0_seed=x0_seed,
        )

    def _batch_arg_max_acquisition(self, n_point: int, fixed_units):
        raise NotImplementedError("batch proposals (ParallelBO) are not ported to the GPU package yet")

    # --------------------------------------------------------- persistence
    def save(self, filename: str):
        """Checkpoint via dill (ref parity: base.py:499-540); loggers are
        name-based so no handler surgery is required."""
        import dill

        os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
        logger, argmax = self.logger, self._argmax
        try:
            self.logger = None
            self._argmax = None  # rebuilt on load
            with open(filename, "wb") as f:
                dill.dump(self, f)
        finally:
            self.logger = logger
            self._argmax = argmax

    @classmethod
    def load(cls, filename: str):
        import dill

        with open(filename, "rb") as f:
            obj = dill.load(f)
        obj.logger = get_logger(f"{type(obj).__name__}({obj.instance_id})", console=obj.verbose)
        obj._set_internal_optimization({"optimizer": obj._optimizer_name})
        return obj

    # ---------------------------------------------------- structured state
    def state_dict(self) -> dict:
        """Plain-array checkpoint state (no pickled code): observed data,
        counters, RNG state, and fitted hyperparameters — the orbax-style
        alternative to dill `save` (SURVEY section 5 checkpoint/resume)."""
        out = {
            "version": 1,
            "cls": type(self).__name__,
            "iter_count": self.iter_count,
            "eval_count": self.eval_count,
            "hist_f": [np.asarray(h).tolist() for h in self.hist_f],
            "rng_state": self._rng.bit_generator.state,
            "space": self._search_space.to_dict(),
        }
        if self.data is not None:
            out["data"] = {
                "values": [list(r) for r in self.data.values],
                "fitness": self.data.fitness.tolist(),
                "n_eval": self.data.n_eval.tolist(),
                "index": self.data.index.tolist(),
                "var_name": self.data.var_name,
            }
        theta = getattr(self.model, "theta_", None)
        if theta is not None:
            out["model_theta"] = np.asarray(theta).tolist()
        return out

    def save_state(self, filename: str) -> None:
        import json

        os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
        with open(filename, "w") as f:
            json.dump(self.state_dict(), f)

    def load_state(self, filename: str) -> "BaseBO":
        """Restore observations + counters + RNG into THIS optimizer (its
        search space / model config must match the checkpoint) and refit."""
        import json

        with open(filename) as f:
            state = json.load(f)
        if state.get("space", {}).keys() != self._search_space.to_dict().keys():
            raise ValueError("checkpoint search space does not match this optimizer")
        self.iter_count = int(state["iter_count"])
        self.eval_count = int(state["eval_count"])
        self.hist_f = [np.asarray(h) for h in state["hist_f"]]
        self._rng.bit_generator.state = state["rng_state"]
        if "data" in state:
            d = state["data"]
            self.data = Solution(
                d["values"], fitness=d["fitness"], n_eval=d["n_eval"],
                index=d["index"], var_name=d["var_name"],
            )
            self.update_model()
        return self


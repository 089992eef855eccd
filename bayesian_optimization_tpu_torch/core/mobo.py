"""Multi-objective Bayesian optimization.

Counterpart of bayesian_optimization_tpu/core/mobo.py (ref parity:
bayes_optim/mobo.py:20-235): per-objective minimize flags, objectives
MinMax-normalized and sign-flipped to maximization (`y` property,
mobo.py:66-75), `xopt` = non-dominated subset (mobo.py:51-57), reference
point 0.8 * min (mobo.py:59-63), hypervolume logged at every tell
(mobo.py:135-143), `MOBO` forcing EHVI + nondominated partitioning
(mobo.py:168-186), `MOBO_qEHVI` optimizing q points jointly over a
q-replicated space (mobo.py:212-235), and `ask(q>1)` on plain MOBO raising
NotImplementedError (asserted by the reference tests).

The surrogate is multi-output (one GP with a shared theta, or a forest) on
the device named by `device=`; the EHVI criterion evaluates whole candidate
populations inside the argmax (optim/argmax.py). The box decomposition, the
hypervolume and the Pareto filters run on the host, where the data are. The
hypercell bounds are rounded to float32, as the JAX package's are, for a
float64 surrogate too; its padding of the cell count to buckets of 64 (a
recompile guard) is left out: a padded cell contributes exactly 0.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..ops.box_decomposition import NondominatedPartitioning
from ..ops.ehvi import QEHVI_N_SAMPLES
from ..ops.hypervolume import Hypervolume
from ..ops.pareto import is_non_dominated
from ..optim.argmax import AcquisitionArgmax
from ..utils import RecommendationUnavailableError
from ..utils.logging import timed_phase
from .bo import BO
from .solution import Solution


class BaseMOBO(BO):
    """Multi-objective BO core (ref parity: mobo.py:20-165)."""

    def __init__(self, n_obj: int = 2, minimize: Union[bool, List[bool]] = True, **kwargs):
        kwargs["n_obj"] = n_obj
        super().__init__(minimize=True, **kwargs)
        self._check_obj_fun(n_obj)
        self._check_minimize(minimize)

    def _check_minimize(self, minimize) -> None:
        if isinstance(minimize, bool):
            minimize = [minimize] * self.n_obj
        if len(minimize) != self.n_obj:
            raise ValueError("minimize flags must match n_obj")
        self.minimize = np.asarray(minimize, dtype=bool)

    def _check_obj_fun(self, n_obj: int) -> None:
        self.n_obj = int(n_obj)
        if self.obj_fun is None:
            return
        if not hasattr(self.obj_fun, "__iter__"):
            raise ValueError("MOBO expects a list of objective callables")
        self.obj_fun = list(self.obj_fun)
        if len(self.obj_fun) != self.n_obj:
            self.logger.warning("n_obj reset to len(obj_fun)")
            self.n_obj = len(self.obj_fun)
        if self.n_obj <= 1:
            raise ValueError("MOBO needs at least two objectives")

    # ------------------------------------------------------------- targets
    @property
    def y(self) -> Optional[np.ndarray]:
        """MinMax-normalized objectives, sign-flipped to MAXIMIZATION
        (ref parity: mobo.py:66-75)."""
        if self.data is None or len(self.data) == 0:
            return None
        F = self.data.fitness
        self._y_min = F.min(axis=0)
        self._y_max = F.max(axis=0)
        scale = np.where(self._y_max > self._y_min, self._y_max - self._y_min, 1.0)
        self._y_scale = scale
        y = (F - self._y_min) / scale
        return y * np.where(self.minimize, -1.0, 1.0)

    @property
    def xopt(self) -> Optional[Solution]:
        y = self.y
        if y is None:
            return None
        return self.data[np.nonzero(is_non_dominated(y).numpy())[0]]

    def recommend(self) -> Solution:
        if self.data is None or self.xopt is None or len(self.xopt) == 0:
            raise RecommendationUnavailableError()
        return self.xopt

    def check_stop(self) -> bool:
        # ftarget is scalar-objective semantics; MO stops on budget only
        if self.eval_count >= self.max_FEs:
            self.stop_dict["max_FEs"] = self.eval_count
        return bool(self.stop_dict)

    @property
    def ref_point(self) -> np.ndarray:
        """0.8 * componentwise min of normalized-maximization objectives
        (ref parity: mobo.py:59-63)."""
        return np.min(self.y, axis=0) * 0.8 - 1e-6

    def _partition(self) -> NondominatedPartitioning:
        return NondominatedPartitioning(self.ref_point, self.y)

    def _mo_par(self) -> dict:
        """The criterion's hypercells, rounded to float32 (+inf stays +inf),
        and the constraint penalty's time."""
        part = self._partition()
        out = {"cell_lower": part.cell_lower.astype(np.float32),
               "cell_upper": part.cell_upper.astype(np.float32)}
        if self._constraints is not None:
            out["_penalty_t"] = 10.0 + float(self._argmax.max_FEs)
        return out

    # ------------------------------------------------------------ evaluate
    @timed_phase("evaluate")
    def evaluate(self, X) -> List[Tuple[float, ...]]:
        cols = []
        for f in self.obj_fun:
            if self.n_job > 1:
                from joblib import Parallel, delayed

                cols.append(list(Parallel(n_jobs=self.n_job)(delayed(f)(x) for x in X)))
            else:
                cols.append([f(x) for x in X])
        return list(zip(*cols))

    # ---------------------------------------------------------------- tell
    @timed_phase("tell")
    def tell(self, X, func_vals, h_vals=None, g_vals=None, index=None, warm_start: bool = False):
        X = self._to_geno(X, index)
        F = np.asarray(func_vals, dtype=float).reshape(len(X), self.n_obj)
        X.fitness = F
        X.n_eval = X.n_eval + 1
        if not warm_start:
            self.eval_count += len(X) * self.n_obj
        X = self.post_eval_check(X)
        self.data = self.data + X if self.data is not None else X
        self.update_model()
        if self.data_file is not None:
            X.to_csv(self.data_file, header=True, append=True)

        xopt = self.xopt
        y = self.y
        pf = y[is_non_dominated(y).numpy()]
        hv = Hypervolume(self.ref_point).compute(pf)
        self._last_hv = hv
        self.logger.info(f"hypervolume of the normalized front: {hv:.6f}")
        if not warm_start:
            self.iter_count += 1
            self.hist_f.append(xopt.fitness.copy())

    def update_model(self):
        """Fit a multi-output surrogate on the normalized objectives
        (ref parity: mobo.py:155-165)."""
        y = self.y
        Xfeat = self._model_features(self.data)
        self.model.fit(Xfeat, y)
        y_hat = np.asarray(self.model.predict(Xfeat)).reshape(len(y), -1)
        for k in range(self.n_obj):
            ss_res = float(np.sum((y[:, k] - y_hat[:, k]) ** 2))
            ss_tot = float(np.sum((y[:, k] - y[:, k].mean()) ** 2)) or 1.0
            self.logger.info(f"model of f{k + 1} r2: {1.0 - ss_res / ss_tot:.4f}")


class MOBO(BaseMOBO):
    """EHVI-driven MOBO (ref parity: mobo.py:168-186)."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("acquisition_fun", "EHVI")
        super().__init__(*args, **kwargs)
        if self.acquisition_fun != "EHVI":
            self.logger.warning("MOBO only supports EHVI; overriding")
            self.acquisition_fun = "EHVI"

    def _acq_par_defaults(self, par: dict) -> dict:
        return self._mo_par()

    def _argmax_one(self, acq_par: dict, fixed_units, x0_seed=None):
        # model outputs are already maximization-oriented; no sign flip
        return self._argmax(
            self.model.posterior, self.model.config, "EHVI", acq_par,
            minimize=True, fixed=fixed_units, x0_seed=x0_seed,
        )

    def _batch_arg_max_acquisition(self, n_point: int, fixed_units):
        raise NotImplementedError("plain MOBO only supports n_point=1; use MOBO_qEHVI")


class MOBO_qEHVI(BaseMOBO):
    """Joint q-point EHVI over a q-replicated space
    (ref parity: mobo.py:188-235).

    Each ask draws one integer from the numpy stream `self._rng`, where the
    JAX package draws its PRNG key, so both streams stay in step; it seeds a
    CPU torch.Generator for the ask's (QEHVI_N_SAMPLES, q, n_obj) samples,
    fixed for the whole argmax (the same on every device)."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("acquisition_fun", "qEHVI")
        super().__init__(*args, **kwargs)
        self.acquisition_fun = "qEHVI"
        self._q_argmax_cache: Dict[int, AcquisitionArgmax] = {}

    def _qehvi_par(self, q: int) -> dict:
        out = self._mo_par()
        gen = torch.Generator().manual_seed(int(self._rng.integers(0, 2**31 - 1)))
        out["eps"] = torch.randn((QEHVI_N_SAMPLES, q, self.n_obj), generator=gen, dtype=torch.float64)
        return out

    def _q_argmax(self, q: int) -> AcquisitionArgmax:
        if q not in self._q_argmax_cache:
            # constraints are defined on the BASE space; the joint-q
            # criterion reshapes each (q*dim) candidate into q per-copy
            # rows before the penalty (optim/argmax.make_unit_criterion)
            self._q_argmax_cache[q] = AcquisitionArgmax(
                (self._search_space * q).encoding(), method="OnePlusOne_Cholesky_CMA",
                seed=(self.random_seed or 0) + 31 + q, constraints=self._constraints,
                device=self.device,
            )
        return self._q_argmax_cache[q]

    def arg_max_acquisition(self, n_point=None, return_value: bool = False, fixed=None):
        n_point = self.n_point if n_point is None else int(n_point)
        acq_par = self._qehvi_par(n_point)
        u_joint, val = self._q_argmax(n_point)(
            self.model.posterior, self.model.config, f"qEHVI{n_point}", acq_par,
            minimize=True, fixed=None,
        )
        X = [list(r) for r in self.encoding.decode_unit(u_joint.reshape(n_point, self.dim))]
        for cb in self._acquisition_callbacks:
            cb()
        return (X, [val] * n_point) if return_value else X

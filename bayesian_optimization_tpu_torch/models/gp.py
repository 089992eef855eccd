"""Gaussian-process surrogate (Kriging) with batched MLE on the GPU.

Counterpart of bayesian_optimization_tpu/models/gp.py, BFGS path: the
multi-restart MLE runs as one batched L-BFGS (ops/optimize.py) on the
successive-halving ladder -- all restarts on a data subset, the best few on
larger subsets, the final two on all rows -- with the restarts ranked and
culled on the device between rungs. Observations are padded to the same
size buckets as the JAX package. Restart starts come from numpy's
`default_rng(random_state)`, drawn in the same order as the JAX package, so
both packages start from identical points.

The other optimizers (CMA, HMC, NUTS, VI), `precompile` and the float64
option are not ported yet and raise.
"""
from __future__ import annotations

import os as _os
from typing import Optional

import numpy as np
import torch

from .._device import DEFAULT_DEVICE, resolve_device
from ..ops.optimize import minimize_restarts
from .likelihood import (
    PIV_TOL,
    GPConfig,
    PosteriorState,
    n_hyper_params,
    neg_log_likelihood,
    posterior_state,
    predict as _predict_point,
)
from .trend import TRENDS, BasisExpansionTrend, constant_trend


def _mle_ladder_plan(n, n_pad, n_restarts, max_iter, multi_fidelity):
    """Successive-halving MLE schedule: (rungs, final), rungs a list of
    (ns, n_starts_in, iters) on data subsets, final (n_starts_in, iters) on
    all rows. Rung sizes are capped at the largest 128-multiple <= n."""
    if multi_fidelity and n >= 512 and n_restarts > 4:
        cap = max(128, (n // 128) * 128)
        if n_pad // 4 >= 256:
            r1 = min(n_pad // 4, cap)
            r2 = min(n_pad // 2, cap)
            rungs = [(r1, n_restarts, max(5, max_iter // 2))]
            if r2 > r1:
                rungs.append((r2, 6, max(5, max_iter // 4)))
            return rungs, (2 if r2 > r1 else 4, max(6, (3 * max_iter) // 10))
        return (
            [(min(n_pad // 2, cap), n_restarts, max(5, max_iter // 2))],
            (4, max(5, max_iter // 2)),
        )
    return [], (n_restarts, max_iter)


def _bucket(n: int) -> int:
    """Pad count n up to a size bucket (x4 geometric, from 16)."""
    b = 16
    while b < n:
        b *= 4
    return b


def _fit_summary(par, nll, state: PosteriorState):
    """(ok, theta, nll, sigma2, beta) on the host, in one transfer. ok folds
    the degenerate-likelihood check: finite nll below the penalty, finite
    gamma, and raw pivots above PIV_TOL at the chosen hyperparameters."""
    ok = (
        torch.isfinite(nll)
        & (nll < 1e11)
        & torch.isfinite(state.gamma).all()
        & (state.min_pivot.min() > PIV_TOL)
    )
    flat = torch.cat([
        ok.to(par.dtype).reshape(1), 10.0 ** par.reshape(-1), nll.reshape(1),
        state.sigma2.reshape(-1), state.beta.reshape(-1),
    ]).cpu().double().numpy()
    P, m = par.numel(), state.sigma2.numel()
    return (
        bool(flat[0]), flat[1:1 + P], float(flat[1 + P]),
        flat[2 + P:2 + P + m], flat[2 + P + m:].reshape(state.beta.shape),
    )


class GaussianProcess:
    """Kriging surrogate over a numeric feature space."""

    def __init__(
        self,
        mean: Optional[BasisExpansionTrend] = None,
        corr: str = "matern",
        theta0=None,
        thetaL=None,
        thetaU=None,
        sigma2=None,
        nugget: float = 1e-6,
        noise_estim: bool = False,
        optimizer: str = "BFGS",
        likelihood: str = "concentrated",
        random_start: Optional[int] = None,
        wait_iter: int = 5,
        eval_budget: Optional[int] = None,
        random_state=None,
        verbose: bool = False,
        dtype="f32",
        max_iter: int = 40,
        max_linesearch_steps: int = 12,
        multi_fidelity: bool = True,
        theta_prior_strength: float = 0.0,
        device=DEFAULT_DEVICE,
    ):
        self.device = resolve_device(device)
        if isinstance(dtype, str):
            dtype = {"f32": torch.float32, "float32": torch.float32,
                     "f64": torch.float64, "float64": torch.float64}[dtype]
        # f64 runs the plain-torch likelihood/posterior stack, as the JAX
        # package's f64 runs its pure-XLA path; the card's kernels are f32
        # only, so on the card the option raises
        if dtype == torch.float64 and self.device.type != "cpu":
            raise NotImplementedError("the float64 GP option is not ported to the card")
        self.dtype = dtype
        if optimizer not in ("BFGS", "CMA", "HMC", "NUTS", "VI"):
            raise ValueError(
                f"unknown optimizer {optimizer!r}; expected one of "
                "'BFGS', 'CMA', 'HMC', 'NUTS', 'VI'"
            )
        if optimizer != "BFGS":
            raise NotImplementedError(f"optimizer {optimizer!r} is not ported to the GPU package yet")
        self.mean = mean
        self.corr_type = corr if isinstance(corr, str) else "custom"
        self._corr = corr
        self.theta0 = None if theta0 is None else np.atleast_1d(np.asarray(theta0, float))
        self.thetaL = None if thetaL is None else np.atleast_1d(np.asarray(thetaL, float))
        self.thetaU = None if thetaU is None else np.atleast_1d(np.asarray(thetaU, float))
        if self.thetaL is not None and not (
            np.isfinite(self.thetaL).all() and np.isfinite(self.thetaU).all()
        ):
            raise ValueError("all theta bounds must be finite")
        self.sigma2 = sigma2
        self.nugget = float(nugget) if nugget else 0.0
        self.noise_estim = bool(noise_estim)
        self.optimizer = optimizer
        self.likelihood = likelihood
        self.random_start = random_start
        self.wait_iter = wait_iter
        self.eval_budget = eval_budget
        self.max_iter = int(max_iter)
        self.max_linesearch_steps = int(max_linesearch_steps)
        self.multi_fidelity = bool(multi_fidelity)
        self.theta_prior_strength = float(theta_prior_strength)
        self.verbose = verbose
        self._rng = np.random.default_rng(
            random_state if isinstance(random_state, (int, np.integer)) else None
        )
        self.is_fitted = False
        self._state: Optional[PosteriorState] = None
        self._estimate_trend_user: Optional[bool] = None

        if self.noise_estim:
            self.estimation_mode = "noise_estim"
        elif self.nugget:
            self.estimation_mode = "noisy"
        else:
            self.estimation_mode = "noiseless"
        self.noise_var = self.nugget

    # ------------------------------------------------------------------
    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=self.dtype, device=self.device)

    def _config(self, dim: int) -> GPConfig:
        mean = self.mean
        # whether the trend is GLS-estimated is frozen from the user's intent
        # (fit() writes the estimated beta back into the trend)
        if self._estimate_trend_user is None:
            self._estimate_trend_user = (
                isinstance(mean, BasisExpansionTrend) and mean.estimate_coefficients
            )
        n_basis = mean.n_basis if isinstance(mean, BasisExpansionTrend) else 1
        trend_name = {cls: name for name, cls in TRENDS.items()}.get(type(mean), "custom")
        return GPConfig(
            kernel=self.corr_type if isinstance(self._corr, str) else self._corr,
            mode=self.estimation_mode,
            likelihood=self.likelihood,
            estimate_trend=self._estimate_trend_user,
            n_basis=n_basis,
            trend=trend_name,
            jitter=1e-6,
            theta_prior_strength=self.theta_prior_strength,
        )

    def _trend_F(self, X: torch.Tensor) -> torch.Tensor:
        if isinstance(self.mean, BasisExpansionTrend):
            return self.mean.F(X)
        return torch.ones_like(X[:, :1])

    def _hyper_bounds(self, dim: int, y: np.ndarray) -> np.ndarray:
        """log10-space bounds rows [lo, hi]."""
        rows = [np.log10(np.c_[self.thetaL, self.thetaU])]
        if self.estimation_mode == "noisy":
            hi = max(1e-3, float(np.std(y)) ** 2)
            rows.append(np.log10(np.atleast_2d([1e-5, hi])))
        elif self.estimation_mode == "noise_estim":
            rows.append(np.log10(np.atleast_2d([1e-10, 1.0 - 1e-10])))
        return np.concatenate(rows, axis=0)

    def _escalate_nugget(self, dim, y, noise_var, config, bounds, starts, R):
        """Degenerate-likelihood escalation: a noiseless fit becomes noisy
        with a 1e-5 floor (fresh config/bounds/starts); an already-noisy fit
        bumps the noise x10."""
        if self.estimation_mode == "noiseless":
            self.estimation_mode = "noisy"
            noise_var = 1e-5
            config = self._config(dim)
            bounds = self._hyper_bounds(dim, y)
            n_par = n_hyper_params(dim, config)
            starts = self._rng.uniform(bounds[:, 0], bounds[:, 1], size=(R, n_par))
        else:
            noise_var = max(noise_var, 1e-8) * 10.0
        return noise_var, config, bounds, starts

    def _run_mle_ladder(self, starts, lo_b, hi_b, data_host, data_dev, n, n_pad,
                        noise_var, beta0, config, warm_refit: bool = False):
        """Successive-halving MLE ladder as a Python loop over rungs; the
        restarts are ranked on the device between rungs. warm_refit (a
        BO-loop refit with < 25% new data since the last full ladder) skips
        the exploration rungs: the previous optimum and the median-heuristic
        start polish on all rows at the full iteration budget."""
        Xp, Yp = data_host
        max_iter = max(4, int(self.max_iter))
        if warm_refit:
            rungs, (n_final, iters_b) = [], (min(2, len(starts)), max_iter)
        else:
            rungs, (n_final, iters_b) = _mle_ladder_plan(
                n, n_pad, len(starts), max_iter, self.multi_fidelity
            )
        idxs = [self._rng.choice(n, size=ns, replace=False) for ns, _, _ in rungs]
        stages = []
        for idx, (ns, n_in, iters) in zip(idxs, rungs):
            Xs, Ys = self._tensor(Xp[idx]), self._tensor(Yp[idx])
            ones = torch.ones(ns, dtype=self.dtype, device=self.device)
            stages.append(((Xs, Ys, self._trend_F(Xs), ones, float(ns)), n_in, iters))
        stages.append((data_dev, n_final, iters_b))

        xs = self._tensor(starts)
        res = None
        for i, ((X, Y, F, mask, n_s), n_in, iters) in enumerate(stages):
            def nll(p, X=X, Y=Y, F=F, mask=mask, n_s=n_s):
                return neg_log_likelihood(
                    p, X, Y, F, mask, n_s, noise_var, beta0, config,
                    prior_lo=lo_b, prior_hi=hi_b,
                )

            res = minimize_restarts(
                nll, xs[:n_in], lo_b, hi_b, max_iter=iters,
                max_linesearch_steps=self.max_linesearch_steps,
            )
            if i + 1 < len(stages):
                xs = res.x[torch.argsort(res.fun, stable=True)]
        X, Y, F, mask, n_s = data_dev
        state = posterior_state(res.x_best, X, Y, F, mask, n_s, noise_var, beta0, config)
        return res.x_best, res.fun_best, state

    def _probe(self, starts, lo_b, hi_b, data_dev, noise_var, beta0, config):
        """Batched likelihood at the starts on all rows: tells whether every
        start sits in the 1e12 penalty region, so fit() can escalate the
        nugget without running the ladder on a zero-gradient plateau."""
        X, Y, F, mask, n_s = data_dev
        with torch.no_grad():
            return neg_log_likelihood(
                self._tensor(starts), X, Y, F, mask, n_s, noise_var, beta0, config,
                prior_lo=lo_b, prior_hi=hi_b,
            )

    def fit(self, X, y) -> "GaussianProcess":
        X = np.asarray(X, dtype=float)
        y = np.asarray(y, dtype=float)
        if X.ndim == 1:
            X = X.reshape(-1, 1)
        if y.ndim == 1:
            y = y.reshape(-1, 1)
        n, dim = X.shape
        m = y.shape[1]
        if self.mean is None:
            self.mean = constant_trend(dim)
        if self.thetaL is None or self.thetaU is None:
            raise ValueError("thetaL/thetaU are required for fitting")
        if len(self.thetaL) == 1 and dim > 1:
            self.thetaL = np.repeat(self.thetaL, dim)
            self.thetaU = np.repeat(self.thetaU, dim)

        config = self._config(dim)
        n_pad = _bucket(n)
        Xp = np.zeros((n_pad, dim))
        Xp[:n] = X
        Yp = np.zeros((n_pad, m))
        Yp[:n] = y
        mask = np.zeros(n_pad)
        mask[:n] = 1.0
        Xj, Yj, maskj = self._tensor(Xp), self._tensor(Yp), self._tensor(mask)
        Fj = self._trend_F(Xj) * maskj[:, None]
        data_dev = (Xj, Yj, Fj, maskj, float(n))
        if (
            not self._estimate_trend_user
            and isinstance(self.mean, BasisExpansionTrend)
            and self.mean.beta is not None
            and self.mean.beta.numel()
        ):
            beta0 = self.mean.beta.to(self.device, self.dtype).reshape(Fj.shape[1], -1)
            beta0 = beta0.expand(Fj.shape[1], m).contiguous()
        else:
            beta0 = torch.zeros((Fj.shape[1], m), dtype=self.dtype, device=self.device)

        bounds = self._hyper_bounds(dim, y)
        n_par = n_hyper_params(dim, config)
        R = self.random_start or max(10, dim)

        # first start: previous optimum / theta0; others log10-uniform
        starts = self._rng.uniform(bounds[:, 0], bounds[:, 1], size=(R, n_par))
        warm = getattr(self, "theta_", None)
        if warm is not None and len(warm) == dim:
            starts[0, :dim] = np.log10(np.clip(warm, self.thetaL, self.thetaU))
        elif self.theta0 is not None:
            t0 = np.repeat(self.theta0, dim) if len(self.theta0) == 1 else self.theta0
            starts[0, :dim] = np.log10(np.clip(t0, self.thetaL, self.thetaU))
        if R > 1 and n >= 2:
            # second start: the anisotropic median heuristic
            sub = X[self._rng.choice(n, size=min(n, 256), replace=False)]
            d2 = (sub[:, None, :] - sub[None, :, :]) ** 2
            med = np.median(d2[np.triu_indices(len(sub), k=1)], axis=0)
            theta_med = 1.0 / np.maximum(dim * med, 1e-30)
            starts[1, :dim] = np.log10(np.clip(theta_med, self.thetaL, self.thetaU))

        noise_var = self.noise_var if self.estimation_mode == "noisy" else 0.0
        warm_ok = (
            warm is not None
            and len(warm) == dim
            and _os.environ.get("BOTPU_NO_WARM_REFIT") is None
            and getattr(self, "_full_ladder_n", 0) > 0
            and n <= int(self._full_ladder_n * 1.25)
        )
        for attempt in range(6):
            lo_b = self._tensor(bounds[:, 0])
            hi_b = self._tensor(bounds[:, 1])
            # all-dead probe: only on the big buckets, in already-noisy modes,
            # and never on the last attempt (see the JAX package's fit)
            if attempt < 5 and n_pad > 1024 and self.estimation_mode != "noiseless":
                probe = self._probe(starts, lo_b, hi_b, data_dev, noise_var, beta0, config)
                if bool((probe >= 1e11).all()):
                    noise_var, config, bounds, starts = self._escalate_nugget(
                        dim, y, noise_var, config, bounds, starts, R
                    )
                    continue
            wr = warm_ok and attempt == 0  # escalation regenerates starts
            par, nll, state = self._run_mle_ladder(
                starts, lo_b, hi_b, (Xp, Yp), data_dev, n, n_pad, noise_var,
                beta0, config, warm_refit=wr,
            )
            if not wr:
                self._full_ladder_n = n
            ok_h, theta_h, nll_h, s2_h, beta_h = _fit_summary(par, nll, state)
            if ok_h:
                break
            noise_var, config, bounds, starts = self._escalate_nugget(
                dim, y, noise_var, config, bounds, starts, R
            )
        self.noise_var = noise_var
        self._state = state
        self._config_cache = config
        self.theta_ = np.asarray(theta_h, dtype=float)[:dim]
        self.log_likelihood_ = -float(nll_h)
        self.sigma2 = np.asarray(s2_h, dtype=float)
        if isinstance(self.mean, BasisExpansionTrend) and self._estimate_trend_user:
            self.mean.beta = torch.as_tensor(np.asarray(beta_h, np.float32))
        self.is_fitted = True
        self._n, self._dim, self._m = n, dim, m
        return self

    # ------------------------------------------------------------------
    def load_fitted(self, theta, state_fields: dict, config_fields: dict) -> "GaussianProcess":
        """Adopt a fit made elsewhere (e.g. by the JAX package): theta (dim,),
        the numpy fields of its PosteriorState and of its GPConfig."""
        from .convert import gpconfig_from_fields, posterior_state_from_numpy

        self._state = posterior_state_from_numpy(state_fields, self.device)
        self._config_cache = gpconfig_from_fields(config_fields)
        self.theta_ = np.asarray(theta, dtype=float).ravel()
        self._dim = self._state.X.shape[1]
        self._m = self._state.beta.shape[1]
        self._n = int(self._state.mask.sum().item())
        self.is_fitted = True
        return self

    def _predict_padded(self, X: np.ndarray, eval_mse: bool):
        nq = X.shape[0]
        Xq = np.zeros((_bucket(nq), self._dim))
        Xq[:nq] = X
        Xj = self._tensor(Xq)
        with torch.no_grad():
            mu, mse = _predict_point(self._state, Xj, self._trend_F(Xj), self._config_cache, eval_mse)
        return mu[:nq], (mse[:nq] if mse is not None else None)

    def predict(self, X, eval_MSE: bool = False):
        """BLUP mean (and MSE) at X: (n_eval, n_targets), squeezed to
        (n_eval,) for single-target models."""
        if not self.is_fitted:
            raise ValueError("model is not fitted yet")
        X = np.asarray(X, dtype=float)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        mu, mse = self._predict_padded(X, eval_MSE)
        mu = mu.cpu().double().numpy()
        if self._m == 1:
            mu = mu.ravel()
        if eval_MSE:
            mse = mse.cpu().double().numpy()
            if self._m == 1:
                mse = mse.ravel()
            return mu, mse
        return mu

    # -- device-side handles for the acquisition argmax -------------------
    @property
    def posterior(self) -> PosteriorState:
        if not self.is_fitted:
            raise ValueError("model is not fitted yet")
        return self._state

    @property
    def config(self) -> GPConfig:
        return self._config_cache

    def predict_torch(self, Xq: torch.Tensor, eval_mse: bool = True):
        """predict on device tensors, differentiable in Xq:
        (Nq, dim) -> (mu[Nq, m], mse[Nq, m])."""
        return _predict_point(self._state, Xq, self._trend_F(Xq), self._config_cache, eval_mse)

"""Gaussian-process surrogate (Kriging) with batched MLE on the GPU.

Counterpart of bayesian_optimization_tpu/models/gp.py. optimizer="BFGS":
the multi-restart MLE runs as one batched L-BFGS (ops/optimize.py) on the
successive-halving ladder -- all restarts on a data subset, the best few on
larger subsets, the final two on all rows -- with the restarts ranked and
culled on the device between rungs. optimizer="CMA": the restarts are
chains of the population (1+1)-Cholesky-CMA (optim/cma.py) over the log10
hyperparameters on all rows, one batched likelihood per generation.
optimizer="HMC" | "NUTS" | "VI": a posterior over the hyperparameters
(models/hmc.py), its chains or Monte-Carlo draws lanes of one batched
likelihood and gradient; the fit keeps `n_ensemble` samples as one stacked
posterior state, and predict mixes them. Observations are padded to the
same size buckets as the JAX package. Restart starts, the samplers' seeds
and the data subsets come from numpy's `default_rng(random_state)`, drawn in
the same order as the JAX package, so both packages start from identical
points.

With a `NonparametricTrend` prior the GP fits the residual y - m(X) under a
fixed zero constant trend and adds m back in `predict`; `predict_torch`
adds the prior's forest traversal on the device. dtype="f64" runs the plain
torch stack on any device, the card included: the JAX package's float64
likewise takes its non-Pallas path, and the port chooses it by dtype
(models/kernels.py, ops/linalg.py). `gradient` and `Hessian` differentiate
the posterior mean and MSE at a point by autograd; `Hessian` runs its
second derivative through the kernels' plain twins (the Matern backward
kernel has no derivative of its own).

`precompile` (TPU compile warming) has no counterpart.
"""
from __future__ import annotations

import os as _os
from typing import Optional

import numpy as np
import torch

from .._device import DEFAULT_DEVICE, resolve_device
from ..ops.optimize import minimize_restarts
from ..optim.cma import run_cma
from ..utils.logging import host_sync
from .hmc import Draws, _to_box, fit_vi, hmc_sample, nuts_sample
from .likelihood import (
    PIV_TOL,
    GPConfig,
    PosteriorState,
    n_hyper_params,
    neg_log_likelihood,
    posterior_state,
    predict_gp,
)
from .random_forest import RandomForest, rf_predict
from .trend import TRENDS, BasisExpansionTrend, NonparametricTrend, constant_trend


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
    gamma, and raw pivots above PIV_TOL at the chosen hyperparameters (of
    every member of a stacked state)."""
    ok = (
        torch.isfinite(nll)
        & (nll < 1e11)
        & torch.isfinite(state.gamma).all()
        & (state.min_pivot.min() > PIV_TOL)
    )
    flat = torch.cat([
        ok.to(par.dtype).reshape(1), 10.0 ** par.reshape(-1), nll.reshape(1),
        state.sigma2.reshape(-1), state.beta.reshape(-1),
    ])
    with host_sync():
        flat = flat.cpu()
    flat = flat.double().numpy()
    P, m = par.numel(), state.sigma2.numel()
    return (
        bool(flat[0]), flat[1:1 + P], float(flat[1 + P]),
        flat[2 + P:2 + P + m].reshape(state.sigma2.shape), flat[2 + P + m:].reshape(state.beta.shape),
    )


def _negated(nll):
    """The samplers' target, the log likelihood, from a negative log likelihood."""
    return lambda p: -nll(p)


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
        # f64 runs the plain-torch likelihood/posterior stack on any device,
        # as the JAX package's f64 runs its pure-XLA path (the routing is by
        # dtype, in models/kernels.py and ops/linalg.py)
        self.dtype = dtype
        if optimizer not in ("BFGS", "CMA", "HMC", "NUTS", "VI"):
            raise ValueError(
                f"unknown optimizer {optimizer!r}; expected one of "
                "'BFGS', 'CMA', 'HMC', 'NUTS', 'VI'"
            )
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
        with host_sync():  # a blocking copy to the device
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
        if isinstance(mean, NonparametricTrend):
            # the residual GP: y - m(X) under a fixed zero constant trend
            trend_name = "constant"
        else:
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

    def _prior_mean(self, X: np.ndarray) -> Optional[np.ndarray]:
        """m(X) of a nonparametric prior trend, (n, m); None otherwise."""
        if isinstance(self.mean, NonparametricTrend):
            return self.mean(X).double().numpy().reshape(X.shape[0], -1)
        return None

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

    def _subset_stage(self, Xp, Yp, idx):
        """The likelihood's data (X, Y, F, mask, n) on the rows idx."""
        Xs, Ys = self._tensor(Xp[idx]), self._tensor(Yp[idx])
        ones = torch.ones(len(idx), dtype=self.dtype, device=self.device)
        return Xs, Ys, self._trend_F(Xs), ones, float(len(idx))

    def _data_subset_stage(self, Xp, Yp, n, n_pad):
        """The likelihood's data on a random ~n/4 subset (a 128-multiple):
        the sampler's phase-1 warm-up target."""
        ns = min(n_pad // 4, max(128, (n // 128) * 128))
        return self._subset_stage(Xp, Yp, self._rng.choice(n, size=ns, replace=False))

    def _run_mle_ladder(self, starts, lo_b, hi_b, data_host, data_dev, n, n_pad,
                        noise_var, beta0, config, iters_scale: float = 1.0,
                        warm_refit: bool = False):
        """Successive-halving MLE ladder as a Python loop over rungs; the
        restarts are ranked on the device between rungs. iters_scale < 1
        runs a shortened ladder (to seed the sampler's chains at the MAP).
        warm_refit (a BO-loop refit with < 25% new data since the last full
        ladder) skips the exploration rungs: the previous optimum and the
        median-heuristic start polish on all rows at the full iteration
        budget."""
        Xp, Yp = data_host
        max_iter = max(4, int(self.max_iter * iters_scale))
        if warm_refit:
            rungs, (n_final, iters_b) = [], (min(2, len(starts)), max_iter)
        else:
            rungs, (n_final, iters_b) = _mle_ladder_plan(
                n, n_pad, len(starts), max_iter, self.multi_fidelity
            )
        idxs = [self._rng.choice(n, size=ns, replace=False) for ns, _, _ in rungs]
        stages = [(self._subset_stage(Xp, Yp, idx), n_in, iters)
                  for idx, (_, n_in, iters) in zip(idxs, rungs)]
        stages.append((data_dev, n_final, iters_b))

        xs = self._tensor(starts)
        res = None
        for i, (stage, n_in, iters) in enumerate(stages):
            res = minimize_restarts(
                self._nll(stage, lo_b, hi_b, noise_var, beta0, config), xs[:n_in], lo_b, hi_b,
                max_iter=iters, max_linesearch_steps=self.max_linesearch_steps,
            )
            if i + 1 < len(stages):
                xs = res.x[torch.argsort(res.fun, stable=True)]
        X, Y, F, mask, n_s = data_dev
        state = posterior_state(res.x_best, X, Y, F, mask, n_s, noise_var, beta0, config)
        return res.x_best, res.fun_best, state

    def _fit_cma(self, starts, lo_b, hi_b, data_dev, noise_var, beta0, config):
        """MLE by population CMA chains from the starts, 4 * max_iter
        generations on all rows. The chains' generator is seeded by the
        integer the JAX package draws from self._rng for its PRNG key, so
        every later draw from self._rng stays in step with it."""
        seed = int(self._rng.integers(0, 2**31 - 1))
        gen = torch.Generator(device=self.device).manual_seed(seed)
        with torch.no_grad():
            par, fun, _, _ = run_cma(gen, self._nll(data_dev, lo_b, hi_b, noise_var, beta0, config),
                                     self._tensor(starts), lo_b, hi_b, 4 * self.max_iter)
        X, Y, F, mask, n_s = data_dev
        state = posterior_state(par, X, Y, F, mask, n_s, noise_var, beta0, config)
        return par, fun, state

    @staticmethod
    def _nll(data, lo_b, hi_b, noise_var, beta0, config):
        """log10 parameters (B, P) -> the negative log likelihood, with the
        MAP prior, on data (X, Y, F, mask, n): (B,)."""
        X, Y, F, mask, n_s = data

        def nll(p):
            return neg_log_likelihood(p, X, Y, F, mask, n_s, noise_var, beta0, config,
                                      prior_lo=lo_b, prior_hi=hi_b)

        return nll

    @staticmethod
    def _ensemble_posterior(pars, nll, data_dev, noise_var, beta0, config):
        """(mean nll, stacked states) of an (S, P) hyperparameter ensemble:
        the shared tail of the HMC/NUTS and VI fits."""
        X, Y, F, mask, n_s = data_dev
        with torch.no_grad():
            mean_nll = nll(pars).mean()
        states = posterior_state(pars, X, Y, F, mask, n_s, noise_var, beta0,
                                 config._replace(n_ensemble=0))
        return mean_nll, states

    def _fit_hmc(self, seed, chain0, lo_b, hi_b, data_dev, noise_var, beta0, config, n_ensemble,
                 n_warmup, warm_stage=None, carry=None, n_warmup2=None):
        """A posterior over the hyperparameters by adaptive HMC or NUTS, the
        chains the rows of chain0: (samples (S, P), nll, stacked states,
        accept rate, inv_mass, step size, draws (n_samples, C, P)). thin=2,
        ceil(S / C) draws a chain, 12 leapfrogs (HMC) or depth 6 (NUTS), as
        the JAX package. warm_stage: the data of a row subset, the phase-1
        target; carry: (inv_mass, step size) of the previous refit, which
        skips phase 1. Draws from a generator on the device seeded with
        `seed`."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        nll = self._nll(data_dev, lo_b, hi_b, noise_var, beta0, config)
        warm_nll = None if warm_stage is None else self._nll(warm_stage, lo_b, hi_b, noise_var,
                                                             beta0, config)
        x0 = self._tensor(chain0)
        C, P = x0.shape
        kw = dict(n_warmup=n_warmup, n_samples=max(1, -(-n_ensemble // C)), thin=2,
                  warmup_log_prob_fn=None if warm_nll is None else _negated(warm_nll),
                  n_warmup2=n_warmup2, draws=Draws(gen))
        if carry is not None:
            kw.update(init_inv_mass=self._tensor(carry[0]), init_step_size=self._tensor(carry[1]))
        if self.optimizer == "NUTS":
            res = nuts_sample(gen, _negated(nll), x0, lo_b, hi_b, max_depth=6, **kw)
        else:
            res = hmc_sample(gen, _negated(nll), x0, lo_b, hi_b, n_leapfrog=12, **kw)
        pars = res.samples.reshape(-1, P)[:n_ensemble]
        mean_nll, states = self._ensemble_posterior(pars, nll, data_dev, noise_var, beta0, config)
        return pars, mean_nll, states, res.accept_rate, res.inv_mass, res.step_size, res.samples

    def _fit_vi(self, seed, lo_b, hi_b, data_dev, noise_var, beta0, config, n_ensemble, n_steps):
        """A posterior over the hyperparameters by mean-field ADVI; its
        n_ensemble samples, mapped to box coordinates, stacked into the same
        ensemble state as the samplers'. Returns (samples, nll, states,
        (mean, log_std))."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        draws = Draws(gen)
        nll = self._nll(data_dev, lo_b, hi_b, noise_var, beta0, config)
        mean, log_std = fit_vi(gen, _negated(nll), lo_b, hi_b, n_steps=n_steps, draws=draws)
        eps = draws.normal((n_ensemble, lo_b.shape[0]), self.dtype)
        pars = _to_box(mean[None, :] + torch.exp(log_std)[None, :] * eps, lo_b, hi_b)
        mean_nll, states = self._ensemble_posterior(pars, nll, data_dev, noise_var, beta0, config)
        return pars, mean_nll, states, (mean, log_std)

    def _probe(self, starts, lo_b, hi_b, data_dev, noise_var, beta0, config):
        """Batched likelihood at the starts on all rows: tells whether every
        start sits in the 1e12 penalty region, so fit() can escalate the
        nugget without running the ladder on a zero-gradient plateau."""
        with torch.no_grad():
            return self._nll(data_dev, lo_b, hi_b, noise_var, beta0, config)(self._tensor(starts))

    def _sampler_setup(self, starts, bounds, R, data_host, data_dev, n, n_pad, lo_b, hi_b,
                       noise_var, beta0, config):
        """(chain0, warm stage, carry, n_warmup2) of an HMC/NUTS fit, with the
        JAX package's draws from self._rng in its order: C = max(4, min(R,
        8)) chains; at n >= 512 jittered by 0.1 of the bounds' width around
        the previous fit's log10 MAP (or a half-length MLE ladder's optimum
        when there is none), and phase 1 on an n/4 row subset; below 512 the
        first C starts. The previous refit's (inv_mass, step) is carried when
        it has the same chains, sampler and size bucket."""
        Xp, Yp = data_host
        C = max(4, min(R, 8))
        n_par = bounds.shape[0]
        n_warm = int(getattr(self, "hmc_warmup", 64))
        if n >= 512:
            map_par = getattr(self, "_map_par_log10", None)
            if map_par is None or len(map_par) != n_par:
                map_t, _, _ = self._run_mle_ladder(
                    starts, lo_b, hi_b, data_host, data_dev, n, n_pad, noise_var, beta0,
                    config, iters_scale=0.5)
                map_par = map_t.cpu().double().numpy()
            width = bounds[:, 1] - bounds[:, 0]
            chain0 = np.clip(
                map_par[None, :] + 0.1 * width[None, :] * self._rng.standard_normal((C, n_par)),
                bounds[:, 0], bounds[:, 1],
            )
            warm_stage = self._data_subset_stage(Xp, Yp, n, n_pad)
        else:
            chain0, warm_stage = starts[:C], None
        carry = getattr(self, "_sampler_carry", None)
        if carry is not None and (
            carry[0].shape != (len(chain0), n_par) or carry[2] != (self.optimizer, n_pad)
        ):
            carry = None
        n_w2 = max(8, n_warm // 4) if carry is not None or warm_stage is not None else None
        return chain0, warm_stage, carry, n_w2

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
        prior = self._prior_mean(X)
        if prior is not None:  # the residual GP
            y = y - prior
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
            if self.optimizer in ("HMC", "NUTS", "VI"):
                S = int(getattr(self, "n_ensemble", 16))
                seed = int(self._rng.integers(0, 2**31 - 1))
                if self.optimizer == "VI":
                    par_s, nll, state, vi_params = self._fit_vi(
                        seed, lo_b, hi_b, data_dev, noise_var, beta0, config, S,
                        int(getattr(self, "vi_steps", 400)))
                    self.vi_params_ = tuple(p.cpu().double().numpy() for p in vi_params)
                else:
                    chain0, warm_stage, carry, n_w2 = self._sampler_setup(
                        starts, bounds, R, (Xp, Yp), data_dev, n, n_pad, lo_b, hi_b,
                        noise_var, beta0, config)
                    par_s, nll, state, acc, inv_mass, step, chains = self._fit_hmc(
                        seed, chain0, lo_b, hi_b, data_dev, noise_var, beta0, config, S,
                        int(getattr(self, "hmc_warmup", 64)), warm_stage, carry, n_w2)
                    self.accept_rate_ = acc.cpu().double().numpy()
                    # (draws, chains, P) box-coordinate draws for ESS
                    # diagnostics (models/hmc.effective_sample_size)
                    self.sample_chains_ = chains.cpu().double().numpy()
                    self._sampler_carry = (inv_mass.cpu().double().numpy(),
                                           step.cpu().double().numpy(), (self.optimizer, n_pad))
                self.theta_samples_ = 10.0 ** par_s[:, :dim].cpu().double().numpy()
                par = torch.quantile(par_s, 0.5, dim=0)  # the posterior median
                config = config._replace(n_ensemble=S)
            elif self.optimizer == "CMA":
                par, nll, state = self._fit_cma(starts, lo_b, hi_b, data_dev, noise_var,
                                                beta0, config)
            else:
                # all-dead probe: only on the big buckets, in already-noisy
                # modes, and never on the last attempt (see the JAX package's fit)
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
        full_par = np.asarray(theta_h, dtype=float)
        # the log10 MAP (or posterior-median) vector: seeds the next refit's
        # sampler chains
        self._map_par_log10 = np.log10(np.maximum(full_par, 1e-300))
        self.theta_ = full_par[:dim]
        self.log_likelihood_ = -float(nll_h)
        self.sigma2 = np.asarray(s2_h, dtype=float)
        if (
            config.n_ensemble == 0
            and isinstance(self.mean, BasisExpansionTrend)
            and self._estimate_trend_user
        ):
            self.mean.beta = torch.as_tensor(np.asarray(beta_h, np.float32))
        self.is_fitted = True
        self._n, self._dim, self._m = n, dim, m
        return self

    # ------------------------------------------------------------------
    def load_fitted(self, theta, state_fields: dict, config_fields: dict) -> "GaussianProcess":
        """Adopt a fit made elsewhere (e.g. by the JAX package): theta (dim,),
        the numpy fields of its PosteriorState (point or stacked) and of its
        GPConfig, in this model's dtype."""
        from .convert import gpconfig_from_fields, posterior_state_from_numpy

        self._state = posterior_state_from_numpy(state_fields, self.device, self.dtype)
        self._config_cache = gpconfig_from_fields(config_fields)
        self.theta_ = np.asarray(theta, dtype=float).ravel()
        self._dim = self._state.X.shape[1]
        self._m = self._state.beta.shape[-1]
        self._n = int(self._state.mask.sum().item())
        self.is_fitted = True
        return self

    def _predict_padded(self, X: np.ndarray, eval_mse: bool):
        nq = X.shape[0]
        Xq = np.zeros((_bucket(nq), self._dim))
        Xq[:nq] = X
        Xj = self._tensor(Xq)
        with torch.no_grad():
            mu, mse = predict_gp(self._state, Xj, self._trend_F(Xj), self._config_cache, eval_mse)
        mu = mu[:nq]
        prior = self._prior_mean(X)  # the residual GP: add the prior mean back
        if prior is not None:
            mu = mu + torch.as_tensor(prior, dtype=mu.dtype, device=mu.device)
        return mu, (mse[:nq] if mse is not None else None)

    def predict(self, X, eval_MSE: bool = False):
        """BLUP mean (and MSE) at X: (n_eval, n_targets), squeezed to
        (n_eval,) for single-target models."""
        if not self.is_fitted:
            raise ValueError("model is not fitted yet")
        X = np.asarray(X, dtype=float)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        mu, mse = self._predict_padded(X, eval_MSE)
        with host_sync(1 + eval_MSE):
            mu = mu.cpu()
            mse = mse.cpu() if eval_MSE else None
        mu = mu.double().numpy()
        if self._m == 1:
            mu = mu.ravel()
        if eval_MSE:
            mse = mse.double().numpy()
            if self._m == 1:
                mse = mse.ravel()
            return mu, mse
        return mu

    def _moment(self, x: torch.Tensor, of: str, config: GPConfig) -> torch.Tensor:
        """The posterior mean (of="mean") or MSE ("mse") at one point x (dim,),
        summed over targets, without a nonparametric prior (as the JAX
        package's gradient and Hessian)."""
        Xq = x.reshape(1, -1)
        mu, mse = predict_gp(self._state, Xq, self._trend_F(Xq), config, of == "mse")
        return (mu if of == "mean" else mse).sum()

    def gradient(self, x):
        """Gradients (dim, 1) of the posterior mean and of the MSE at a single
        point, by autograd: in float32 on the card through the Matern
        backward kernel."""
        x = self._tensor(np.asarray(x, dtype=float).ravel())
        grads = []
        for of in ("mean", "mse"):
            xx = x.clone().requires_grad_(True)
            (g,) = torch.autograd.grad(self._moment(xx, of, self._config_cache), xx)
            grads.append(g.cpu().double().numpy().reshape(-1, 1))
        return grads[0], grads[1]

    def Hessian(self, x, of: str = "mean"):
        """Hessian (dim, dim) of the posterior mean, or with of="mse" of the
        posterior variance, at a single point, by double backward: in
        float32 on the card the Matern/RBF cross-covariance runs its forward
        and backward kernels and the second-derivative kernel
        (`matern_bwd2_fused`). (A generic-nu Matern's host Bessel derivative
        has no derivative of its own, and raises.)"""
        if of not in ("mean", "mse"):
            raise ValueError("of must be 'mean' or 'mse'")
        x = np.asarray(x, dtype=float)
        if x.ndim == 2:
            if x.shape[0] != 1:
                raise ValueError("x must be a single point")
            x = x.ravel()
        if x.shape[0] != self._dim:
            raise ValueError("x does not have the right size")
        H = torch.autograd.functional.hessian(lambda xx: self._moment(xx, of, self._config_cache),
                                              self._tensor(x))
        return H.cpu().double().numpy()

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
        (Nq, dim) -> (mu[Nq, m], mse[Nq, m]); an ensemble's mixture. A
        NonparametricTrend prior's forest is traversed here and added to
        the mean; a prior that is not a fitted port RandomForest raises."""
        mu, mse = predict_gp(self._state, Xq, self._trend_F(Xq), self._config_cache, eval_mse)
        if isinstance(self.mean, NonparametricTrend):
            wrapped = self.mean.model
            if not (isinstance(wrapped, RandomForest) and wrapped.is_fitted):
                raise ValueError(
                    "predict_torch with a NonparametricTrend requires the prior to wrap a "
                    "fitted bayesian_optimization_tpu_torch RandomForest (its traversal runs "
                    "on device tensors); host-only regressors work through .predict() but "
                    "cannot run inside the acquisition criterion"
                )
            pm, _ = rf_predict(wrapped.posterior, Xq, wrapped.config)
            mu = mu + pm.reshape(mu.shape)
        return mu, mse

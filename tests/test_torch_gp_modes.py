"""The port's GaussianProcess modes and likelihood goldens on the CPU, the
cases of tests/test_gp.py that no other port test covers, with its goldens
and tolerances: the concentrated likelihood and the posterior against an
independent numpy transcription of the Kriging equations, padding
invariance, the batched L-BFGS on a quadratic, fit/predict, multi-output,
the noise-estimating mode, the MLE ladder's plan, the theta prior, the
nugget escalation and float64. The
deterministic parts are held to the JAX package: the ladder's plan, the
hyperparameter bounds of each mode and the escalation's config and bounds."""
import numpy as np
import pytest
import torch

from bayesian_optimization_tpu.models import GaussianProcess as JGP
from bayesian_optimization_tpu.models import constant_trend as j_const
from bayesian_optimization_tpu.models.gp import _mle_ladder_plan as j_plan
from bayesian_optimization_tpu_torch.models import GaussianProcess as TGP
from bayesian_optimization_tpu_torch.models import constant_trend as t_const
from bayesian_optimization_tpu_torch.models.gp import _mle_ladder_plan as t_plan
from bayesian_optimization_tpu_torch.models.likelihood import (
    GPConfig, neg_log_likelihood, posterior_state, predict,
)
from bayesian_optimization_tpu_torch.ops.optimize import minimize_restarts

torch.set_num_threads(1)  # one thread per pytest worker: more oversubscribe the cores


def gp(**kw):
    return TGP(device="cpu", **kw)


# ------------------------------------------------- numpy goldens (test_gp.py)
def _numpy_matern32_K(theta, X, Y=None):
    Y = X if Y is None else Y
    d2 = ((X[:, None, :] - Y[None, :, :]) ** 2 * theta[None, None, :]).sum(-1)
    s = np.sqrt(3) * np.sqrt(np.maximum(d2, 0))
    return (1 + s) * np.exp(-s)


def _numpy_concentrated_nll_noiseless(theta, X, y, jitter=1e-6):
    n = len(X)
    L = np.linalg.cholesky(_numpy_matern32_K(theta, X) + jitter * np.eye(n))
    Yt = np.linalg.solve(L, y.reshape(-1, 1))
    Ft = np.linalg.solve(L, np.ones((n, 1)))
    Q, G = np.linalg.qr(Ft)
    beta = np.linalg.solve(G, Q.T @ Yt)
    rho = Yt - Ft @ beta
    sigma2 = float((rho**2).sum()) / (n - 1)
    ll = -0.5 * (n * np.log(2 * np.pi * sigma2) + 2 * np.log(np.diag(L)).sum() + n)
    return -ll, sigma2, beta, L, rho


def _pad(X, y, n_pad):
    n, d = X.shape
    Xp = np.zeros((n_pad, d))
    Xp[:n] = X
    Yp = np.zeros((n_pad, 1))
    Yp[:n] = y.reshape(-1, 1)
    mask = np.zeros(n_pad)
    mask[:n] = 1
    return [torch.tensor(a, dtype=torch.float32) for a in (Xp, Yp, mask[:, None], mask)]


def test_nll_matches_numpy_golden():
    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, (12, 3))
    y = np.sin(X).sum(1) + 0.1 * rng.normal(size=12)
    theta = np.array([0.7, 1.3, 0.4])
    config = GPConfig(kernel="matern", mode="noiseless", estimate_trend=True, jitter=1e-6)
    Xt, Yt, Ft, mask = _pad(X, y, 16)
    nll = neg_log_likelihood(torch.log10(torch.tensor(theta, dtype=torch.float32)), Xt, Yt, Ft, mask,
                             12.0, 0.0, torch.zeros(1), config)
    nll_np, *_ = _numpy_concentrated_nll_noiseless(theta, X, y)
    assert np.isclose(float(nll), nll_np, rtol=2e-3), (float(nll), nll_np)


def test_padding_invariance():
    rng = np.random.default_rng(1)
    X = rng.uniform(-1, 1, (10, 2))
    y = (X**2).sum(1)
    par = torch.tensor(np.r_[np.log10([0.5, 0.8]), -1.0], dtype=torch.float32)
    config = GPConfig(kernel="matern", mode="noisy", estimate_trend=True)
    vals = [float(neg_log_likelihood(par, *_pad(X, y, n_pad), 10.0, 1e-6, torch.zeros(1), config))
            for n_pad in (16, 32, 64)]
    assert np.allclose(vals, vals[0], rtol=1e-4), vals


def test_predict_matches_numpy_golden():
    rng = np.random.default_rng(2)
    X = rng.uniform(-2, 2, (15, 2))
    y = np.cos(X[:, 0]) + 0.5 * X[:, 1]
    theta = np.array([1.1, 0.6])
    Xq = rng.uniform(-2, 2, (7, 2))
    config = GPConfig(kernel="matern", mode="noiseless", estimate_trend=True, jitter=1e-6)
    state = posterior_state(torch.log10(torch.tensor(theta, dtype=torch.float32)), *_pad(X, y, 16), 15.0,
                            0.0, torch.zeros(1), config)
    Xqp = torch.zeros((8, 2))
    Xqp[:7] = torch.tensor(Xq, dtype=torch.float32)
    mu, mse = predict(state, Xqp, torch.ones((8, 1)), config)

    _, sigma2, beta, L, rho = _numpy_concentrated_nll_noiseless(theta, X, y)
    r0 = _numpy_matern32_K(theta, Xq, X)
    mu_np = beta.ravel() + (r0 @ np.linalg.solve(L.T, rho)).ravel()
    rt = np.linalg.solve(L, r0.T)
    Ft = np.linalg.solve(L, np.ones((15, 1)))
    _, G = np.linalg.qr(Ft)
    u = np.linalg.solve(G.T, Ft.T @ rt - np.ones((1, 7)))
    mse_np = sigma2 * (1 - (rt**2).sum(0) + (u**2).sum(0))
    assert np.allclose(mu[:7].numpy().ravel(), mu_np, rtol=2e-2, atol=2e-2)
    assert np.allclose(mse[:7].numpy().ravel(), np.maximum(mse_np, 0), rtol=5e-2, atol=2e-3)


# ---------------------------------------------------------- batched L-BFGS
A = torch.diag(torch.tensor([1.0, 4.0, 9.0]))
b = torch.tensor([1.0, -2.0, 0.5])
X_STAR = np.linalg.solve(A.numpy(), b.numpy())


def _quadratic(x):
    return 0.5 * ((x @ A) * x).sum(-1) - x @ b


def test_lbfgs_minimizes_quadratic():
    x0 = torch.tensor(np.random.default_rng(3).uniform(-4, 4, (6, 3)), dtype=torch.float32)
    res = minimize_restarts(_quadratic, x0, torch.full((3,), -5.0), torch.full((3,), 5.0), max_iter=40)
    assert np.allclose(res.x_best.numpy(), X_STAR, atol=1e-3)


# ------------------------------------------------------------- fit modes
def test_gp_fit_predict_interpolates():
    rng = np.random.default_rng(4)
    X = rng.uniform(-3, 3, (20, 2))
    y = X[:, 0] ** 2 + np.sin(X[:, 1])
    m = gp(mean=t_const(2), thetaL=1e-3 * np.ones(2), thetaU=1e2 * np.ones(2), nugget=1e-6,
           random_state=0).fit(X, y)
    mu, mse = m.predict(X, eval_MSE=True)
    assert mu.shape == (20,)
    assert (np.abs(mu - y) / np.abs(y).max()).max() < 0.05
    assert mse.min() >= 0
    Xt = rng.uniform(-2.5, 2.5, (50, 2))
    yt = Xt[:, 0] ** 2 + np.sin(Xt[:, 1])
    r2 = 1 - np.sum((m.predict(Xt) - yt) ** 2) / np.sum((yt - yt.mean()) ** 2)
    assert r2 > 0.9, r2


def test_gp_mle_beats_random_theta():
    rng = np.random.default_rng(5)
    X = rng.uniform(0, 1, (25, 2))
    y = np.sin(6 * X[:, 0]) * np.cos(3 * X[:, 1])
    m = gp(thetaL=1e-2 * np.ones(2), thetaU=1e3 * np.ones(2), nugget=1e-6, random_state=0).fit(X, y)
    assert np.all(m.theta_ >= 1e-2) and np.all(m.theta_ <= 1e3)
    assert np.isfinite(m.log_likelihood_)


def test_gp_multioutput():
    rng = np.random.default_rng(6)
    X = rng.uniform(-1, 1, (18, 2))
    Y = np.stack([X.sum(1), (X**2).sum(1)], axis=1)
    m = gp(thetaL=1e-3 * np.ones(2), thetaU=1e2 * np.ones(2), nugget=1e-6, random_state=1).fit(X, Y)
    mu, mse = m.predict(X[:5], eval_MSE=True)
    assert mu.shape == (5, 2) and mse.shape == (5, 2)
    assert np.allclose(mu, Y[:5], atol=0.3)


def test_gp_noise_estim_mode():
    """noise_estim fits the noise share: the fit does not interpolate the
    noise; the mode, its config and its bounds are the JAX package's."""
    rng = np.random.default_rng(7)
    X = rng.uniform(-2, 2, (30, 1))
    y = np.sin(X[:, 0]) + 0.2 * rng.normal(size=30)
    kw = dict(thetaL=np.array([1e-2]), thetaU=np.array([1e2]), noise_estim=True, nugget=1e-6,
              random_state=2)
    m, j = gp(**kw), JGP(**kw)
    assert m.estimation_mode == j.estimation_mode == "noise_estim"
    assert m._config(1).mode == j._config(1).mode
    np.testing.assert_array_equal(m._hyper_bounds(1, y), j._hyper_bounds(1, y))
    m.fit(X, y)
    mu, mse = m.predict(X, eval_MSE=True)
    assert float(np.mean(mse)) > 1e-8
    assert np.corrcoef(mu, y)[0, 1] > 0.7


def test_mle_ladder_plan_respects_n():
    """Rung sizes never exceed n, stay 128-aligned and increase; the plan is
    the JAX package's."""
    for n, n_pad in ((1100, 4096), (1025, 4096), (4097, 16384), (2047, 4096),
                     (1000, 1024), (600, 1024), (512, 1024), (100, 128)):
        rungs, final = t_plan(n, n_pad, 10, 40, True)
        assert (rungs, final) == tuple(j_plan(n, n_pad, 10, 40, True))
        for ns, _, _ in rungs:
            assert ns <= n and (ns <= 128 or ns % 128 == 0), (n, n_pad, rungs)
        sizes = [ns for ns, _, _ in rungs]
        assert sizes == sorted(set(sizes))


def test_theta_prior_pulls_away_from_white_noise_basin():
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 1, (20, 10))
    y = rng.standard_normal(20)  # pure noise: MLE prefers theta -> huge
    kw = dict(mean=t_const(10), thetaL=1e-2 * np.ones(10), thetaU=1e6 * np.ones(10), nugget=1e-6,
              random_state=0)
    d0 = np.abs(np.log10(gp(**kw).fit(X, y).theta_) - 2.0).mean()
    d1 = np.abs(np.log10(gp(theta_prior_strength=50.0, **kw).fit(X, y).theta_) - 2.0).mean()
    assert d1 < d0 and d1 < 1.0


def test_escalate_nugget_contract():
    """A noiseless model escalates to noisy with a 1e-5 floor and fresh
    config, bounds and starts (one more hyperparameter); a noisy one bumps
    the noise x10. Config and bounds equal the JAX package's at each step.
    A noiseless fit on duplicated, conflicting rows stays finite."""
    kw = dict(corr="matern", thetaL=1e-2 * np.ones(2), thetaU=1e2 * np.ones(2), nugget=0.0,
              random_start=4, random_state=0)
    m, j = gp(mean=t_const(2), **kw), JGP(mean=j_const(2), **kw)
    assert m.estimation_mode == j.estimation_mode == "noiseless"
    y = np.linspace(-1, 1, 8)
    config0, bounds0 = m._config(2), m._hyper_bounds(2, y)
    starts0 = np.zeros((4, bounds0.shape[0]))
    nv, config, bounds, starts = m._escalate_nugget(2, y, 0.0, config0, bounds0, starts0, 4)
    nv_j, config_j, bounds_j, starts_j = j._escalate_nugget(2, y, 0.0, j._config(2), j._hyper_bounds(2, y),
                                                            starts0, 4)
    assert m.estimation_mode == j.estimation_mode == "noisy"
    assert nv == nv_j == 1e-5 and config.mode == config_j.mode == "noisy"
    assert bounds.shape[0] == bounds0.shape[0] + 1
    np.testing.assert_array_equal(bounds, bounds_j)
    assert starts.shape == starts_j.shape == (4, bounds.shape[0])
    nv2, config2, bounds2, starts2 = m._escalate_nugget(2, y, nv, config, bounds, starts, 4)
    assert nv2 == pytest.approx(1e-4)
    assert config2 is config and bounds2 is bounds and starts2 is starts

    rng = np.random.default_rng(0)
    Xb = rng.uniform(0, 1, (12, 2))
    m2 = gp(mean=t_const(2), **kw).fit(np.vstack([Xb, Xb]), np.concatenate([Xb.sum(1), Xb.sum(1) + 0.5]))
    assert np.isfinite(m2.log_likelihood_)
    mu, mse = m2.predict(Xb[:4], eval_MSE=True)
    assert np.all(np.isfinite(mu)) and np.all(mse >= 0.0)


def test_gp_f64_likelihood_option():
    """dtype="f64" runs fit and predict in float64 and agrees with the
    float32 fit on a well-conditioned problem; its gradient is finite."""
    rng = np.random.default_rng(0)
    n, dim = 80, 3
    X = rng.uniform(-1, 1, (n, dim))
    y = np.sin(3 * X[:, 0]) + X[:, 1] ** 2 + 0.1 * X[:, 2]
    Xq = rng.uniform(-1, 1, (50, dim))
    yq = np.sin(3 * Xq[:, 0]) + Xq[:, 1] ** 2 + 0.1 * Xq[:, 2]
    results = {}
    for dt, want in (("f32", torch.float32), ("f64", torch.float64)):
        m = gp(mean=t_const(dim), corr="matern", thetaL=1e-3 * np.ones(dim), thetaU=1e3 * np.ones(dim),
               nugget=1e-6, random_state=1, dtype=dt).fit(X, y)
        assert m.posterior.L.dtype == want
        mu, mse = m.predict(Xq, eval_MSE=True)
        assert np.all(np.isfinite(mu)) and np.all(mse >= 0)
        results[dt] = (np.corrcoef(mu.ravel(), yq)[0, 1], np.asarray(m.theta_))
    assert results["f32"][0] > 0.99 and results["f64"][0] > 0.99
    assert np.allclose(results["f32"][1], results["f64"][1], rtol=0.2)
    dmu, dmse = m.gradient(Xq[0])
    assert np.all(np.isfinite(dmu)) and np.all(np.isfinite(dmse))

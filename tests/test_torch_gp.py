"""bayesian_optimization_tpu_torch's batched L-BFGS and GaussianProcess
against the JAX package on the CPU: the same starts on the same likelihood;
and the port's ladder and warm refit (tests/test_torch_gp_fit.py holds the
fit itself to the JAX package's)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_optimization_tpu.models import likelihood as jlik
from bayesian_optimization_tpu.ops.optimize import minimize_restarts as j_minimize
from bayesian_optimization_tpu_torch.models import GaussianProcess as TGP
from bayesian_optimization_tpu_torch.models import constant_trend as t_const
from bayesian_optimization_tpu_torch.models import likelihood as tlik
from bayesian_optimization_tpu_torch.models.gp import _bucket, _mle_ladder_plan
from bayesian_optimization_tpu_torch.ops.optimize import minimize_restarts as t_minimize

torch.set_num_threads(1)  # one thread per pytest worker: more oversubscribe the cores


def _problem(n, dim, seed):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 1, (n, dim))
    y = np.sin(3 * X).sum(1) + 0.1 * rng.standard_normal(n)
    return X, (y - y.mean()) / y.std()


def test_minimize_restarts_matches_jax_on_nll():
    n, n_pad, dim = 100, 128, 3
    X, y = _problem(n, dim, 0)
    Xp = np.zeros((n_pad, dim), np.float32)
    Xp[:n] = X
    Yp = np.zeros((n_pad, 1), np.float32)
    Yp[:n, 0] = y
    mask = np.zeros(n_pad, np.float32)
    mask[:n] = 1.0
    lo = np.asarray([-2.0] * dim + [-5.0], np.float32)
    hi = np.asarray([2.0] * dim + [0.0], np.float32)
    starts = np.random.default_rng(1).uniform(lo, hi, (6, dim + 1)).astype(np.float32)
    cfg = jlik.GPConfig()

    def j_nll(p):
        return jlik.neg_log_likelihood(
            p, jnp.asarray(Xp), jnp.asarray(Yp), jnp.asarray(mask[:, None]), jnp.asarray(mask),
            jnp.asarray(float(n)), jnp.asarray(1e-6), jnp.zeros((1, 1)), cfg,
        )

    res_j = jax.jit(lambda x0: j_minimize(j_nll, x0, jnp.asarray(lo), jnp.asarray(hi),
                                          max_iter=20, max_linesearch_steps=12))(jnp.asarray(starts))

    tcfg = tlik.GPConfig()
    args = (torch.tensor(Xp), torch.tensor(Yp), torch.tensor(mask[:, None]), torch.tensor(mask))

    def t_nll(p):
        return tlik.neg_log_likelihood(p, *args, n, 1e-6, torch.zeros(1, 1), tcfg)

    res_t = t_minimize(t_nll, torch.tensor(starts), torch.tensor(lo), torch.tensor(hi),
                       max_iter=20, max_linesearch_steps=12)
    fb_j, fb_t = float(res_j.fun_best), float(res_t.fun_best)
    assert abs(fb_t - fb_j) < 1e-3 * abs(fb_j)
    assert res_t.x.shape == (6, dim + 1)
    assert bool(torch.all((res_t.x >= torch.tensor(lo)) & (res_t.x <= torch.tensor(hi))))


def test_minimize_restarts_lanes_match_jax_in_f64():
    """Lane by lane, in float64: the batched two-loop L-BFGS ends every
    restart where the JAX package's does, at the default nugget."""
    n, n_pad, dim = 100, 128, 3
    X, y = _problem(n, dim, 0)
    Xp = np.zeros((n_pad, dim))
    Xp[:n] = X
    Yp = np.zeros((n_pad, 1))
    Yp[:n, 0] = y
    mask = np.zeros(n_pad)
    mask[:n] = 1.0
    lo = np.asarray([-3.0] * dim + [-5.0])
    hi = np.asarray([3.0] * dim + [0.0])
    starts = np.random.default_rng(2).uniform(lo, hi, (8, dim + 1))
    with jax.enable_x64():
        a = [jnp.asarray(v, jnp.float64) for v in (Xp, Yp, mask[:, None], mask, lo, hi)]

        def j_nll(p):
            return jlik.neg_log_likelihood(
                p, a[0], a[1], a[2], a[3], jnp.asarray(float(n)), jnp.asarray(1e-6),
                jnp.zeros((1, 1)), jlik.GPConfig(), prior_lo=a[4], prior_hi=a[5],
            )

        res_j = jax.jit(lambda x0: j_minimize(j_nll, x0, a[4], a[5], max_iter=40,
                                              max_linesearch_steps=12))(jnp.asarray(starts))
        fun_j = np.asarray(res_j.fun, np.float64)
    t = [torch.tensor(v, dtype=torch.float64) for v in (Xp, Yp, mask[:, None], mask, lo, hi)]

    def t_nll(p):
        return tlik.neg_log_likelihood(p, *t[:4], n, 1e-6, torch.zeros(1, 1, dtype=torch.float64),
                                       tlik.GPConfig(), prior_lo=t[4], prior_hi=t[5])

    res_t = t_minimize(t_nll, torch.tensor(starts), t[4], t[5], max_iter=40, max_linesearch_steps=12)
    np.testing.assert_allclose(res_t.fun.numpy(), fun_j, rtol=1e-6)


def _gp(seed, dim):
    return TGP(mean=t_const(dim), corr="matern", thetaL=1e-3 * np.ones(dim),
               thetaU=1e3 * np.ones(dim), random_start=10, random_state=seed, device="cpu")


def test_ladder_fit_and_warm_refit():
    """n >= 512 takes the successive-halving ladder; a refit with < 25% new
    data takes the warm two-lane path, and BOTPU_NO_WARM_REFIT disables it."""
    n, dim = 600, 3
    X, y = _problem(700, dim, 4)
    assert _mle_ladder_plan(n, _bucket(n), 10, 40, True) == (
        [(256, 10, 20), (512, 6, 10)], (2, 12)
    )
    gp = _gp(3, dim)
    gp.fit(X[:n], y[:n])
    assert gp._full_ladder_n == n
    assert np.isfinite(gp.log_likelihood_)
    assert float(gp.posterior.min_pivot) > tlik.PIV_TOL
    assert np.abs(gp.predict(X[:64]) - y[:64]).max() < 0.1
    gp.fit(X[:650], y[:650])
    assert gp._full_ladder_n == n  # warm refit: no full ladder
    assert np.abs(gp.predict(X[600:650]) - y[600:650]).max() < 0.1


def test_warm_refit_can_be_disabled(monkeypatch):
    monkeypatch.setenv("BOTPU_NO_WARM_REFIT", "1")
    X, y = _problem(90, 2, 5)
    gp = _gp(1, 2)
    gp.fit(X[:80], y[:80])
    gp.fit(X, y)
    assert gp._full_ladder_n == 90


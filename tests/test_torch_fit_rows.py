"""The row count of a GP fit's data layout (`models/gp.py::_fit_rows`): the
next 128-multiple of n, or n's size bucket where that is smaller, on the
CPU. The padded rows are masked and decoupled, so the likelihood, the fit
and its predictions do not depend on how many of them there are; the fit's
schedule (the ladder's plan and its row subsets, drawn from `_rng`) still
follows the bucket, as in the JAX package, which lays the data out at the
bucket and is the reference here."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_optimization_tpu.models import GaussianProcess as JGP
from bayesian_optimization_tpu.models import constant_trend as j_const
from bayesian_optimization_tpu.models import likelihood as jlik
from bayesian_optimization_tpu_torch.models import GaussianProcess as TGP
from bayesian_optimization_tpu_torch.models import constant_trend
from bayesian_optimization_tpu_torch.models import gp as gp_mod
from bayesian_optimization_tpu_torch.models.likelihood import GPConfig, neg_log_likelihood
from bayesian_optimization_tpu_torch.utils.logging import PhaseTimer, timed_phase

torch.set_num_threads(1)  # one thread per pytest worker: more oversubscribe the cores

D = 5


def _problem(n, seed):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 1, (n, D))
    y = np.sin(3 * X).sum(1) + 0.1 * rng.standard_normal(n)
    return X, (y - y.mean()) / y.std()


def _padded(X, y, rows):
    """(X, Y, F, mask) of the data laid out at `rows` rows, float64."""
    n = len(X)
    Xp, Yp, mask = np.zeros((rows, D)), np.zeros((rows, 1)), np.zeros(rows)
    Xp[:n], Yp[:n, 0], mask[:n] = X, y, 1.0
    Xt, Yt, mt = (torch.tensor(a) for a in (Xp, Yp, mask))
    return Xt, Yt, mt[:, None], mt


def _jax_nll_and_grad(X, y, rows, pars):
    """The JAX package's negative log likelihood and gradient of the data
    laid out at `rows` rows, float64, one point at a time."""
    with jax.enable_x64():
        Xt, Yt, Ft, mt = (jnp.asarray(t.numpy()) for t in _padded(X, y, rows))
        cfg = jlik.GPConfig(kernel="matern", mode="noisy", estimate_trend=True)

        def nll(p):
            return jlik.neg_log_likelihood(p, Xt, Yt, Ft, mt, jnp.asarray(float(len(X))),
                                           jnp.asarray(1e-6), jnp.zeros((1, 1)), cfg)

        vg = jax.jit(jax.value_and_grad(nll))
        out = [vg(jnp.asarray(p.numpy())) for p in pars]
        return (np.array([float(v) for v, _ in out]), np.stack([np.asarray(g) for _, g in out]))


def test_likelihood_and_gradient_do_not_depend_on_the_padded_rows():
    """n = 300 at 384 rows (the layout) and at 1024 (the bucket): the same
    negative log likelihood and gradient in float64, at three points, and
    both equal to the JAX package's at the bucket's 1024 rows."""
    X, y = _problem(300, 0)
    config = GPConfig(kernel="matern", mode="noisy", estimate_trend=True)
    pars = torch.tensor([[-0.5, 0.0, 0.3, -0.2, 0.1, -2.0],
                         [0.5, 0.7, 0.2, 0.9, 0.4, -4.0],
                         [-1.0, -0.8, -1.2, -0.6, -1.1, -1.0]], dtype=torch.float64)
    out = []
    for rows in (384, 1024):
        p = pars.clone().requires_grad_(True)
        nll = neg_log_likelihood(p, *_padded(X, y, rows), 300.0, 1e-6, torch.zeros(1, 1), config)
        (g,) = torch.autograd.grad(nll.sum(), p)
        out.append((nll.detach(), g))
    (v1, g1), (v2, g2) = out
    assert torch.isfinite(v1).all() and (v1 < 1e11).all()
    assert float(((v1 - v2).abs() / v2.abs()).max()) < 1e-10
    assert float((g1 - g2).abs().max() / g2.abs().max()) < 1e-10
    vj, gj = _jax_nll_and_grad(X, y, 1024, pars)
    for v, g in ((v1, g1), (v2, g2)):
        assert float(np.abs((v.numpy() - vj) / vj).max()) < 1e-10
        assert float(np.abs(g.numpy() - gj).max() / np.abs(gj).max()) < 1e-10


class _Draws:
    """A numpy Generator that keeps every `choice` it makes (the subsets of
    the ladder's rungs and of the start heuristic), the rest passed through."""

    def __init__(self, rng):
        self._g, self.chosen = rng, []

    def choice(self, *args, **kw):
        out = self._g.choice(*args, **kw)
        self.chosen.append(np.array(out))
        return out

    def __getattr__(self, name):
        return getattr(self._g, name)


class _Owner:
    """A timed phase "fit" around GaussianProcess.fit, as the BO loop has."""

    def __init__(self):
        self._timer = PhaseTimer()

    @timed_phase("fit")
    def fit(self, gp, X, y):
        return gp.fit(X, y)


@pytest.fixture(scope="module")
def fits():
    """A seeded float64 fit at n = 600 (the ladder's two rungs and its final
    stage), on the layout and with the layout forced back to the bucket:
    for each, (gp, the rung subsets it drew, its phase's snapshot); and the
    JAX package's fit of the same data from the same random_state, laid out
    at the bucket's 1024 rows: (gp, None, None)."""
    X, y = _problem(600, 1)
    kw = dict(corr="matern", thetaL=1e-3 * np.ones(D), thetaU=1e3 * np.ones(D), nugget=1e-6,
              random_start=10, max_iter=8, random_state=3, dtype="f64")
    jgp = JGP(mean=j_const(D), **kw)
    jgp._rng = _Draws(jgp._rng)
    jgp.fit(X, y.reshape(-1, 1))
    out = {"jax": (jgp, None, None)}
    for name, rows in (("layout", gp_mod._fit_rows), ("bucket", gp_mod._bucket)):
        gp = TGP(mean=constant_trend(D), device="cpu", **kw)
        gp._rng = _Draws(gp._rng)
        idxs = []
        real = TGP._subset_stage
        owner = _Owner()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(gp_mod, "_fit_rows", rows)
            mp.setattr(TGP, "_subset_stage",
                       lambda self, Xp, Yp, idx: idxs.append(np.array(idx)) or real(self, Xp, Yp, idx))
            owner.fit(gp, X, y.reshape(-1, 1))
        out[name] = (gp, idxs, owner._timer.snapshot())
    return X, out


def test_fit_lays_out_the_next_128_multiple_and_equals_the_bucket_fit(fits):
    """The n = 600 fit's posterior has 640 rows, and its hyperparameters, log
    likelihood and predictions equal the bucket layout's (1024 rows) to 1e-6
    relative; both drew the same rung subsets from `_rng` and left it in
    the same state."""
    X, out = fits
    (gp, idxs, _), (gb, idxs_b, _) = out["layout"], out["bucket"]
    assert gp.posterior.X.shape[0] == 640 and gb.posterior.X.shape[0] == 1024
    assert [len(i) for i in idxs] == [256, 512]
    assert all(np.array_equal(a, b) for a, b in zip(idxs, idxs_b)) and len(idxs) == len(idxs_b)
    assert gp._rng.bit_generator.state == gb._rng.bit_generator.state
    np.testing.assert_allclose(gp.theta_, gb.theta_, rtol=1e-6)
    assert abs(gp.log_likelihood_ - gb.log_likelihood_) <= 1e-6 * abs(gb.log_likelihood_)
    Xq = np.random.default_rng(7).uniform(0, 1, (50, D))
    (mu, mse), (mu_b, mse_b) = gp.predict(Xq, eval_MSE=True), gb.predict(Xq, eval_MSE=True)
    np.testing.assert_allclose(mu, mu_b, rtol=1e-6, atol=1e-6 * np.abs(mu_b).max())
    np.testing.assert_allclose(mse, mse_b, rtol=1e-6, atol=1e-6 * np.abs(mse_b).max())


def test_fit_on_the_layout_matches_the_jax_package(fits):
    """The n = 600 fit laid out at 640 rows against the JAX package's at 1024
    rows, float64, the same random_state: the same draws from `_rng` (every
    subset alike) and the same final state; the same log likelihood to 1e-8
    relative (7.8e-10 read); theta and the predictions to 1e-5 relative. The
    layout is no farther from the JAX package than the port's bucket layout:
    on this seed the two packages part by 4.2e-6 in theta and 1.3e-6 in the
    mean at either layout (the 8-iteration L-BFGS runs end mid-descent,
    where the packages' float64 roundings move the end point), while the
    port's two layouts agree to 1e-12."""
    _, out = fits
    (jgp, _, _), (gp, _, _), (gb, _, _) = out["jax"], out["layout"], out["bucket"]
    assert gp.posterior.X.shape[0] == 640
    assert [len(c) for c in gp._rng.chosen] == [len(c) for c in jgp._rng.chosen] == [256, 256, 512]
    assert all(np.array_equal(a, b) for a, b in zip(gp._rng.chosen, jgp._rng.chosen))
    assert gp._rng.bit_generator.state == jgp._rng.bit_generator.state
    assert abs(gp.log_likelihood_ - jgp.log_likelihood_) <= 1e-8 * abs(jgp.log_likelihood_)
    np.testing.assert_allclose(gp.theta_, jgp.theta_, rtol=1e-5)
    Xq = np.random.default_rng(7).uniform(0, 1, (50, D))
    pj = jgp.predict(Xq, eval_MSE=True)
    for k, (ours, bucket) in enumerate(zip(gp.predict(Xq, eval_MSE=True), gb.predict(Xq, eval_MSE=True))):
        ref = np.asarray(pj[k])
        scale = np.abs(ref).max()
        np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5 * scale)
        assert np.abs(ours - ref).max() <= np.abs(bucket - ref).max() + 1e-9 * scale
    rel = lambda a: np.abs((np.asarray(a) - jgp.theta_) / jgp.theta_).max()
    assert rel(gp.theta_) <= rel(gb.theta_) + 1e-9


def test_fit_counts_its_rows_and_the_buckets(fits):
    """Inside the phase "fit" the counters "fit/gp.rows" and
    "fit/gp.bucket_rows" record the layout's rows and the bucket's."""
    _, out = fits
    snap = out["layout"][2]
    assert snap["fit/gp.rows"] == 640 and snap["fit/gp.bucket_rows"] == 1024
    snap_b = out["bucket"][2]
    assert snap_b["fit/gp.rows"] == 1024 and snap_b["fit/gp.bucket_rows"] == 1024


@pytest.mark.parametrize("n, rows", [(16, 16), (64, 64), (100, 128), (256, 256), (1000, 1024),
                                     (1024, 1024), (1025, 1152), (1800, 1920)])
def test_fit_rows(n, rows):
    """The layout's rows: the bucket up to 64, then the next 128-multiple."""
    assert gp_mod._fit_rows(n) == rows
    assert rows <= gp_mod._bucket(n) and (rows <= 128 or rows % 128 == 0)

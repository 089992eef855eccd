"""The port's criteria (ops/acquisition.py) against the JAX package on the
CPU: the closed-form goldens of tests/test_acquisition.py with its
tolerances, the generalized expected improvement (`gei` and the GEI class)
and GEI through BO, and MGFI's `t` property."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import norm

import bayesian_optimization_tpu as jbo
import bayesian_optimization_tpu_torch as tbo
from bayesian_optimization_tpu.ops import acquisition as ja
from bayesian_optimization_tpu_torch.ops import acquisition as ta

torch.set_num_threads(1)  # one thread per pytest worker: more oversubscribe the cores


def _moments(seed=0, n=64):
    rng = np.random.default_rng(seed)
    mu = rng.standard_normal(n)
    sd = 10 ** rng.uniform(-3, 0.5, n)
    sd[:3] = [0.0, 1e-12, 1e-9]  # the sd guard
    return mu, sd


@pytest.mark.parametrize("g", [1, 2, 3, 4])
def test_gei_matches_jax(g):
    mu, sd = _moments(g)
    plugin = np.random.default_rng(9).standard_normal(64)  # a per-lane plugin
    with jax.enable_x64():
        want = np.asarray(ja.gei(jnp.asarray(mu), jnp.asarray(sd), jnp.asarray(plugin), g=g))
    got = ta.gei(torch.tensor(mu), torch.tensor(sd), torch.tensor(plugin), g=g).numpy()
    assert np.abs(got - want).max() <= 1e-10 * max(1.0, np.abs(want).max())
    assert np.all(got[:2] == 0.0)
    if g == 1:
        ei = ta.ei(torch.tensor(mu), torch.tensor(sd), torch.tensor(plugin)).numpy()
        assert np.abs(got - ei).max() <= 1e-12


def test_gei_gradient_matches_jax():
    mu, sd = _moments(5)
    mu, sd = mu[3:], sd[3:]
    with jax.enable_x64():
        gj = np.asarray(jax.grad(lambda m: jnp.sum(ja.gei(m, jnp.asarray(sd), 0.3, g=3)))(jnp.asarray(mu)))
    mt = torch.tensor(mu, requires_grad=True)
    (gt,) = torch.autograd.grad(ta.gei(mt, torch.tensor(sd), 0.3, g=3).sum(), mt)
    assert np.abs(gt.numpy() - gj).max() <= 1e-10 * np.abs(gj).max()


def test_gei_class_refuses_order_zero():
    with pytest.raises(ValueError):
        tbo.GEI(g=0)
    assert tbo.GEI(g=3).params == {"g": 3}


def test_gei_object_on_a_fitted_model():
    """The object API: GEI(model, plugin)(X) is the criterion at X."""
    X = np.random.default_rng(1).uniform(0, 1, (20, 2))
    y = (X ** 2).sum(1)
    gp = tbo.GaussianProcess(thetaL=1e-3 * np.ones(2), thetaU=1e3 * np.ones(2), random_state=0,
                             device="cpu").fit(X, y)
    Xq = np.random.default_rng(2).uniform(0, 1, (5, 2))
    v, dx = tbo.GEI(g=2, model=gp, plugin=float(y.min()))(Xq[:1], return_dx=True)
    vals = tbo.GEI(g=2, model=gp, plugin=float(y.min()))(Xq)
    mu, mse = gp.predict(Xq, eval_MSE=True)
    want = ta.gei(torch.tensor(np.ravel(mu)), torch.tensor(np.sqrt(np.ravel(mse))), float(y.min()), g=2)
    assert np.allclose(vals, want.numpy(), rtol=1e-4, atol=1e-12)
    assert abs(v - vals[0]) <= 1e-6 * max(1.0, abs(vals[0])) and dx.shape == (2, 1)


@pytest.mark.parametrize("g", [1, 3])
def test_gei_through_bo(g):
    """BO(acquisition_fun="GEI", {"g": g}) runs on the CPU: the order rides
    in the criterion's name ("GEI<g>"), and the run improves on its DoE."""
    opt = tbo.BO(search_space=tbo.RealSpace([[-5, 5]] * 2, random_seed=0),
                 obj_fun=lambda x: float(np.sum(np.asarray(x) ** 2)), DoE_size=5, max_FEs=12,
                 acquisition_fun="GEI", acquisition_par={"g": g}, random_seed=0, device="cpu")
    opt.run()
    assert opt.eval_count == 12 and opt._acquisition_par == {"g": g}
    assert opt.fopt <= float(np.min(opt.data.fitness[:5]))


# ------------------------------------- tests/test_acquisition.py's goldens
def _t(*a):
    return [torch.tensor(np.asarray(v, np.float32)) for v in a]


def test_ei_golden():
    mu, sd, plugin = np.array([0.0, 1.0, -1.0]), np.array([1.0, 0.5, 2.0]), 0.0
    got = ta.ei(*_t(mu, sd), plugin).numpy()
    imp = plugin - mu
    want = imp * norm.cdf(imp / sd) + sd * norm.pdf(imp / sd)
    assert np.allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.allclose(got, np.asarray(ja.ei(jnp.asarray(mu, jnp.float32), jnp.asarray(sd, jnp.float32),
                                             plugin)), rtol=1e-5, atol=1e-6)


def test_ei_zero_sd_is_zero():
    assert float(ta.ei(*_t([0.5], [0.0]), 1.0)[0]) == 0.0


def test_pi_golden():
    mu, sd = np.array([0.3, -0.3]), np.array([0.7, 0.9])
    got = ta.pi(*_t(mu, sd), 0.1).numpy()
    assert np.allclose(got, norm.cdf((0.1 - mu) / sd), rtol=1e-5)


def test_ucb_is_linear():
    assert np.allclose(ta.ucb(*_t([1.0, 2.0], [0.5, 1.0]), alpha=2.0).numpy(), [0.0, 0.0])


def test_mgfi_golden_and_clamp():
    mu, sd, plugin, t = 0.2, 0.8, 0.0, 1.5
    got = float(ta.mgfi(*_t([mu], [sd]), plugin, t=t)[0])
    beta_p = (plugin - (mu - t * sd**2)) / sd
    want = norm.cdf(beta_p) * np.exp(t * (plugin - mu - 1.0) + t**2 * sd**2 / 2.0)
    assert np.isclose(got, want, rtol=1e-4)
    assert np.isfinite(float(ta.mgfi(*_t([mu], [sd]), plugin, t=1e3)[0]))


def test_batch_shapes():
    mu, sd = torch.zeros(128), torch.ones(128)
    for fn, kw in [(ta.ei, {"plugin": 0.0}), (ta.pi, {"plugin": 0.0}), (ta.ucb, {"alpha": 1.0}),
                   (ta.mgfi, {"plugin": 0.0, "t": 2.0})]:
        out = fn(mu, sd, **kw)
        assert out.shape == (128,) and bool(torch.isfinite(out).all())


def test_gei_matches_mc():
    """tests/test_acquisition.py's Monte Carlo golden for g = 2, 3."""
    mu, sd, plugin = 0.3, 0.8, 0.1
    y = mu + sd * np.random.default_rng(0).standard_normal(400000)
    for g in (2, 3):
        got = float(ta.gei(*_t([mu], [sd]), plugin, g=g)[0])
        assert got == pytest.approx(float(np.mean(np.maximum(plugin - y, 0.0) ** g)), rel=0.03)


def test_mgfi_t_property_matches_jax():
    """MGFI.t reads and writes params["t"], clamped at MGFI_T_MAX, as the
    JAX package's property does: both packages' params and criterion
    parameters agree after construction and after each assignment."""
    j, t = jbo.MGFI(t=1.0, plugin=0.5), tbo.MGFI(t=1.0, plugin=0.5)
    assert t.t == j.t == 1.0
    for value, want in ((None, 1.0), (5.0, 5.0), (100.0, 22.36)):
        if value is not None:
            j.t = value
            t.t = value
        assert t.params == j.params == {"t": want}
        assert t.criterion_params() == j.criterion_params() == {"t": want, "plugin": 0.5}
    assert tbo.MGFI(t=50.0).t == jbo.MGFI(t=50.0).t == ta.MGFI_T_MAX

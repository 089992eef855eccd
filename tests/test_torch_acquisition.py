"""The port's generalized expected improvement (ops/acquisition.py::gei and
the GEI class) against the JAX package on the CPU, and GEI through BO."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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

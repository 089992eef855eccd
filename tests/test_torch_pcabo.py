"""The port's PCABO (core/extensions.py) against the JAX package on the CPU:
the rank-weighted PCA and the reduced bounds on the same numpy inputs, the
criterion with the out-of-box penalty on a carried posterior, and the
PCABO cases of tests/test_extensions.py end to end on device="cpu"."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesian_optimization_tpu as jbo
import bayesian_optimization_tpu_torch as tbo
from bayesian_optimization_tpu.core.extensions import PCABO as JPCABO
from bayesian_optimization_tpu.core.extensions import LinearTransform as JLT
from bayesian_optimization_tpu.models import GaussianProcess as JGP
from bayesian_optimization_tpu.models import constant_trend as j_const
from bayesian_optimization_tpu.models.likelihood import PosteriorState as JState
from bayesian_optimization_tpu.optim.argmax import make_unit_criterion as j_criterion
from bayesian_optimization_tpu_torch.core.extensions import PCABO as TPCABO
from bayesian_optimization_tpu_torch.core.extensions import LinearTransform as TLT
from bayesian_optimization_tpu_torch.models import GaussianProcess as TGP
from bayesian_optimization_tpu_torch.optim.argmax import make_unit_criterion as t_criterion

torch.set_num_threads(1)  # one thread per pytest worker: more oversubscribe the cores


def ellipsoid(x):
    x = np.asarray(x, dtype=float)
    w = 10 ** np.linspace(0, 2, len(x))
    return float(np.sum(w * x**2))


@pytest.mark.parametrize("n_components, minimize", [(3, True), (0.9, True), (2, False), (None, True)])
def test_linear_transform_matches_jax(n_components, minimize):
    rng = np.random.default_rng(0)
    X = rng.uniform(-5, 5, (30, 6))
    y = (X**2).sum(1) + rng.standard_normal(30)
    j = JLT(n_components=n_components, minimize=minimize).fit(X, y)
    t = TLT(n_components=n_components, minimize=minimize).fit(X, y)
    for name in ("components_", "mean_", "center", "explained_variance_"):
        np.testing.assert_allclose(getattr(t, name), getattr(j, name), rtol=0, atol=1e-10)
    Z = rng.uniform(-3, 3, (7, t.components_.shape[0]))
    np.testing.assert_allclose(t.transform(X), j.transform(X), rtol=0, atol=1e-10)
    np.testing.assert_allclose(t.inverse_transform(Z), j.inverse_transform(Z), rtol=0, atol=1e-10)
    space_j, space_t = jbo.RealSpace([[-5, 5]] * 6), tbo.RealSpace([[-5, 5]] * 6)
    np.testing.assert_allclose(TPCABO._compute_bounds(t, space_t),
                               JPCABO._compute_bounds(j, space_j), rtol=0, atol=1e-10)


def test_linear_transform_weights_favor_good_points():
    """Good points spread along dim 0, bad points along dim 1 -> PC1 ~ dim 0
    (tests/test_extensions.py's case)."""
    rng = np.random.default_rng(1)
    n = 40
    X = np.zeros((n, 4))
    X[: n // 2, 0] = rng.uniform(-5, 5, n // 2)
    X[n // 2:, 1] = rng.uniform(-5, 5, n // 2)
    y = np.concatenate([np.zeros(n // 2), 100 + rng.uniform(0, 1, n // 2)])
    comp = np.abs(TLT(n_components=1).fit(X, y).components_[0])
    assert comp[0] == pytest.approx(np.max(comp)) and comp[0] > 3 * comp[1]


@pytest.fixture(scope="module")
def reduced_fit():
    """A JAX fit on 3 PCA components of 24 ellipsoid samples in 8-D, the
    reduced box and the out-of-box penalty's parameters, and the port's GP
    loaded with the JAX posterior."""
    rng = np.random.default_rng(2)
    X = rng.uniform(-5, 5, (24, 8))
    y = np.array([ellipsoid(x) for x in X])
    pca = JLT(n_components=3).fit(X, y)
    bounds = np.asarray(JPCABO._compute_bounds(pca, jbo.RealSpace([[-5, 5]] * 8)))
    U = (pca.transform(X) - bounds[:, 0]) / (bounds[:, 1] - bounds[:, 0])
    ys = (y - y.mean()) / y.std()
    w3 = (bounds[:, 1] - bounds[:, 0]) ** 3
    jgp = JGP(mean=j_const(3), corr="matern", thetaL=1e-3 * w3, thetaU=1e3 * w3, nugget=1e-6,
              random_start=10, random_state=0)
    jgp.fit(U, ys)
    tgp = TGP(thetaL=1e-3 * w3, thetaU=1e3 * w3, device="cpu")
    tgp.load_fitted(jgp.theta_, {k: np.asarray(v) for k, v in jgp.posterior._asdict().items()},
                    jgp.config._asdict())
    pars = {"plugin": float(ys.min()), "_pca_C": pca.components_,
            "_pca_offset": pca.mean_ + pca.center, "_box_lo": -5.0 * np.ones(8),
            "_box_hi": 5.0 * np.ones(8), "_red_lo": bounds[:, 0], "_red_hi": bounds[:, 1]}
    return jgp, tgp, bounds, pars


def test_box_penalty_criterion_matches_jax(reduced_fit):
    """The EI criterion with PCABO's out-of-box penalty on one posterior in
    both packages, in float64: inside the box it is EI, outside it is minus
    the box violation; values and gradients agree."""
    jgp, tgp, bounds, pars = reduced_fit
    U = np.random.default_rng(3).uniform(0, 1, (64, 3))
    with jax.enable_x64():
        enc_j = jbo.RealSpace(bounds.tolist()).encoding(dtype=jnp.float64)
        state = JState(**{k: jnp.asarray(np.asarray(v), jnp.float64)
                          for k, v in jgp.posterior._asdict().items()})
        crit = j_criterion(enc_j, state, jgp.config, "EI",
                           {k: jnp.asarray(v, jnp.float64) for k, v in pars.items()})
        vj = np.asarray(crit(jnp.asarray(U)))
        gj = np.asarray(jax.grad(lambda u: jnp.sum(crit(u)))(jnp.asarray(U)))
    enc_t = tbo.RealSpace(bounds.tolist()).encoding(dtype=torch.float64)
    post = tgp.posterior._replace(**{k: v.double() for k, v in tgp.posterior._asdict().items()})
    crit_t = t_criterion(enc_t, post, tgp.config, "EI",
                         {k: torch.tensor(v, dtype=torch.float64) for k, v in pars.items()})
    Ut = torch.tensor(U, requires_grad=True)
    vt = crit_t(Ut)
    (gt,) = torch.autograd.grad(vt.sum(), Ut)
    assert (vj < 0).sum() > 0 and (vj > 0).sum() > 0  # both sides of the box
    assert np.abs(vt.detach().numpy() - vj).max() <= 1e-8 * np.abs(vj).max()
    assert np.abs(gt.numpy() - gj).max() <= 1e-8 * np.abs(gj).max()


def test_batch_shares_the_reserved_parameters(reduced_fit):
    """`.batch` gives every lane the same (k, D) PCA matrix: the reserved
    parameters are never split by lane, and q = 3 criteria with one shared
    parameter set find the q = 1 criterion's best value."""
    _, tgp, bounds, pars = reduced_fit
    enc = tbo.RealSpace(bounds.tolist()).encoding()
    x0 = np.random.default_rng(4).uniform(0, 1, (6, 3))
    am = tbo.AcquisitionArgmax(enc, method="BFGS", n_restart=6, seed=0, device="cpu")
    us, vs = am.batch(tgp.posterior, tgp.config, "EI", [dict(pars)] * 3, x0_seed=x0)
    u1, v1 = am(tgp.posterior, tgp.config, "EI", dict(pars), x0_seed=x0)
    assert len(us) == 3 and all(abs(v - v1) <= 1e-5 * abs(v1) for v in vs)
    with pytest.raises(ValueError):
        am.batch(tgp.posterior, tgp.config, "EI",
                 [dict(pars), {**pars, "_box_lo": -4.0 * np.ones(8)}])


def test_pcabo_runs_on_ellipsoid():
    space = tbo.RealSpace([[-5, 5]] * 8, random_seed=0)
    opt = tbo.PCABO(search_space=space, obj_fun=ellipsoid, n_components=3,
                    DoE_size=10, max_FEs=20, random_seed=0, device="cpu")
    xopt, fopt, _ = opt.run()
    assert opt.eval_count == 20
    assert len(xopt[0]) == 8  # back in the original space
    assert fopt[0] < ellipsoid([4.0] * 8)
    V = np.asarray(opt.data.values, dtype=float)
    assert V.min() >= -5 - 1e-6 and V.max() <= 5 + 1e-6
    assert opt._argmax.method == "BFGS" and opt.encoding.dim == 3


def test_pcabo_q_gt_1_batched():
    space = tbo.RealSpace([[-5, 5]] * 6, random_seed=0)
    opt = tbo.PCABO(search_space=space, obj_fun=ellipsoid, n_components=3,
                    DoE_size=8, max_FEs=20, n_point=2, random_seed=0, device="cpu")
    opt.run()
    assert opt.eval_count >= 20
    V = np.asarray(opt.data.values, dtype=float)
    assert V.min() >= -5 - 1e-6 and V.max() <= 5 + 1e-6


def test_pcabo_flags_incumbent_and_warm_start():
    space = tbo.RealSpace([[-5.0, 5.0]] * 8, random_seed=0)
    opt = tbo.PCABO(search_space=space, obj_fun=ellipsoid, n_components=3,
                    DoE_size=8, max_FEs=16, random_seed=0,
                    incumbent_injection=True, theta_warm_start=True, device="cpu")
    opt.run()
    assert opt.eval_count == 16
    seed = opt._incumbent_seed()
    assert seed is not None and seed.shape[1] == opt.encoding.dim
    assert np.all(seed >= 0.0) and np.all(seed <= 1.0)
    assert hasattr(opt, "_prev_theta") and len(opt._prev_theta) == opt.encoding.dim
    assert np.isfinite(float(np.ravel(opt.xopt.fitness)[0]))


def test_pcabo_flags_off_no_seed():
    space = tbo.RealSpace([[-5.0, 5.0]] * 6, random_seed=0)
    opt = tbo.PCABO(search_space=space, obj_fun=lambda x: float(np.sum(np.asarray(x) ** 2)),
                    n_components=2, DoE_size=6, max_FEs=9, random_seed=0, device="cpu")
    opt.run()
    assert opt._incumbent_seed() is None

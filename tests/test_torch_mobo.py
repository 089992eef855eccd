"""The port's MOBO and MOBO_qEHVI (core/mobo.py) against the JAX package on
the CPU: the normalized targets, reference point, front and hypercells on
the same data, the numpy stream after the same asks, the 2- and 3-output GP
fit in float64; and every MOBO case of tests/test_mo.py run on the port with
device="cpu", with the same settings and checks."""
import numpy as np
import pytest
import torch

import bayesian_optimization_tpu as jbo
import bayesian_optimization_tpu_torch as tbo
from bayesian_optimization_tpu.core.mobo import MOBO as JMOBO
from bayesian_optimization_tpu.core.mobo import MOBO_qEHVI as JMOBO_qEHVI
from bayesian_optimization_tpu.models import GaussianProcess as JGP
from bayesian_optimization_tpu.models import constant_trend as j_const
from bayesian_optimization_tpu_torch import MOBO, MOBO_qEHVI, RandomForest, RealSpace
from bayesian_optimization_tpu_torch import RecommendationUnavailableError
from bayesian_optimization_tpu_torch.models import GaussianProcess as TGP
from bayesian_optimization_tpu_torch.models import constant_trend as t_const
from bayesian_optimization_tpu_torch.models.random_forest import rf_predict_trees
from bayesian_optimization_tpu_torch.ops.box_decomposition import NondominatedPartitioning
from bayesian_optimization_tpu_torch.ops.ehvi import EHVI, ehvi

torch.set_num_threads(1)  # one thread per pytest worker: more oversubscribe the cores


def _schaffer(x):
    x = float(np.asarray(x, dtype=float).ravel()[0])
    return x**2


def _schaffer2(x):
    x = float(np.asarray(x, dtype=float).ravel()[0])
    return (x - 2.0) ** 2


_TRI = [
    lambda x: float(x[0]) ** 2 + float(x[1]) ** 2,
    lambda x: (float(x[0]) - 1) ** 2 + float(x[1]) ** 2,
    lambda x: float(x[0]) ** 2 + (float(x[1]) - 1) ** 2,
]


# ----------------------------------------------- tests/test_mo.py on the port
def test_mobo_runs_and_improves_hv():
    space = RealSpace([-2, 4], var_name="x", random_seed=0)
    opt = MOBO(search_space=space, obj_fun=[_schaffer, _schaffer2], n_obj=2,
               DoE_size=6, max_FEs=24, random_seed=0, device="cpu")
    opt.run()
    assert opt.data.N >= 10
    front = opt.xopt
    assert front.N >= 2
    # pareto solutions of schaffer lie in [0, 2]
    xs = np.asarray([row[0] for row in front.tolist()], dtype=float)
    assert np.all(xs > -1.2) and np.all(xs < 3.2)
    # the final front's hypervolume, on the final normalization, beats the DoE's
    y = opt.y
    doe_front = NondominatedPartitioning(opt.ref_point, y[:6]).compute_hypervolume()
    assert opt._last_hv > doe_front


def test_mobo_q_gt_1_raises():
    space = RealSpace([-2, 4], random_seed=0)
    opt = MOBO(search_space=space, obj_fun=[_schaffer, _schaffer2], n_obj=2,
               DoE_size=5, max_FEs=30, n_point=2, random_seed=0, device="cpu")
    X = opt.ask(5)  # DoE fine
    opt.tell(X, opt.evaluate(X))
    with pytest.raises(NotImplementedError):
        opt.ask(2)


def test_mobo_recommend_before_data():
    space = RealSpace([-2, 4], random_seed=0)
    opt = MOBO(search_space=space, obj_fun=[_schaffer, _schaffer2], n_obj=2, DoE_size=5, max_FEs=30,
               device="cpu")
    with pytest.raises(RecommendationUnavailableError):
        opt.recommend()


def test_mobo_qehvi_batch():
    space = RealSpace([-2, 4], var_name="x", random_seed=0)
    opt = MOBO_qEHVI(search_space=space, obj_fun=[_schaffer, _schaffer2], n_obj=2,
                     DoE_size=6, max_FEs=20, n_point=2, random_seed=0, device="cpu")
    X = opt.ask(6)
    opt.tell(X, opt.evaluate(X))
    X2 = opt.ask()  # joint q=2 proposal
    assert len(X2) == 2
    opt.tell(X2, opt.evaluate(X2))
    assert opt.data.N == 8
    am = opt._q_argmax(2)
    assert am.method == "OnePlusOne_Cholesky_CMA" and am.encoding.dim == 2 and am.device.type == "cpu"


def test_mobo_3_objectives():
    space = RealSpace([[-1, 2]] * 2, random_seed=0)
    opt = MOBO(search_space=space, obj_fun=_TRI, n_obj=3, DoE_size=8, max_FEs=33, random_seed=0,
               device="cpu")
    opt.run()
    assert opt.xopt.N >= 3


def test_mobo_with_rf_surrogate():
    """A multi-output forest through the EHVI argmax ("auto" runs MIES)."""
    space = RealSpace([-2, 4], var_name="x", random_seed=0)
    model = RandomForest(n_estimators=30, random_state=0, feature_space="embedding", device="cpu")
    opt = MOBO(search_space=space, obj_fun=[_schaffer, _schaffer2], n_obj=2,
               model=model, DoE_size=6, max_FEs=20, random_seed=0, device="cpu")
    opt.run()
    assert opt.data.N >= 8
    assert opt.xopt.N >= 2


def test_rf_multioutput_predict_shapes():
    rng = np.random.default_rng(0)
    X = rng.uniform(size=(40, 3))
    Y = np.c_[X.sum(1), (X**2).sum(1)]
    rf = RandomForest(n_estimators=25, random_state=0, feature_space="embedding", device="cpu").fit(X, Y)
    mu, var = rf.predict(X[:7], eval_MSE=True)
    assert mu.shape == (7, 2) and var.shape == (7, 2)
    # per-output means are the trees' mean (the port grows its own forest)
    trees = rf_predict_trees(rf.posterior, torch.tensor(X[:7], dtype=torch.float32), rf.config)
    assert np.allclose(mu, trees.mean(1).numpy(), atol=1e-5)


def test_mobo_qehvi_3_objectives():
    space = RealSpace([[-1, 2]] * 2, random_seed=0)
    opt = MOBO_qEHVI(search_space=space, obj_fun=_TRI, n_obj=3,
                     DoE_size=8, max_FEs=16, n_point=2, random_seed=0, device="cpu")
    X = opt.ask(8)
    opt.tell(X, opt.evaluate(X))
    X2 = opt.ask()  # joint q=2 proposal over the replicated space
    assert len(X2) == 2
    opt.tell(X2, opt.evaluate(X2))
    assert opt.data.N == 10
    assert opt.xopt.N >= 2


def test_mobo_constrained_asks_feasible():
    """With g(x) = x - 2 (feasible iff x <= 2), every told point is feasible."""
    space = RealSpace([-2, 4], var_name="x", random_seed=0)
    opt = MOBO(search_space=space, obj_fun=[_schaffer, _schaffer2], n_obj=2,
               ineq_fun=lambda x: x[0] - 2.0, DoE_size=6, max_FEs=18, random_seed=0, device="cpu")
    assert opt._constraints is not None and opt._constraints.traceable
    opt.run()
    xs = np.asarray([row[0] for row in opt.data.tolist()], dtype=float)
    assert np.all(xs <= 2.0 + 1e-6), xs.max()


def test_mobo_qehvi_constrained_joint():
    """Per-copy penalty and the all-copy feasibility preference."""
    space = RealSpace([-2, 4], var_name="x", random_seed=0)
    opt = MOBO_qEHVI(search_space=space, obj_fun=[_schaffer, _schaffer2], n_obj=2,
                     ineq_fun=lambda x: x[0] - 2.0, DoE_size=6, max_FEs=16, n_point=2, random_seed=0,
                     device="cpu")
    X = opt.ask(6)
    opt.tell(X, opt.evaluate(X))
    X2 = opt.ask()
    assert len(X2) == 2
    assert all(float(r[0]) <= 2.0 + 1e-6 for r in X2), X2


# ---------------------------------------------------- against the JAX package
@pytest.mark.parametrize("kind", ["MOBO", "MOBO_qEHVI"])
def test_targets_cells_and_stream_match_jax(kind):
    """The same told data in both packages: normalized targets, reference
    point, front, hypervolume and hypercells (JAX's padded to 64, the port's
    not, both rounded to float32) agree; after one model-driven ask each,
    both numpy streams have drawn the same numbers."""
    minimize = [True, False]
    pkgs = {"MOBO": (JMOBO, MOBO), "MOBO_qEHVI": (JMOBO_qEHVI, MOBO_qEHVI)}[kind]
    X = [[x] for x in np.linspace(-2, 4, 7)]
    F = [(_schaffer(x), -_schaffer2(x)) for x in X]
    opts = []
    for cls, space_mod, extra in ((pkgs[0], jbo, {}), (pkgs[1], tbo, {"device": "cpu"})):
        opt = cls(search_space=space_mod.RealSpace([-2, 4], var_name="x", random_seed=0),
                  obj_fun=[_schaffer, lambda x: -_schaffer2(x)], n_obj=2, minimize=minimize,
                  DoE_size=7, max_FEs=30, n_point=1 + (kind == "MOBO_qEHVI"), random_seed=0, **extra)
        opt.tell(X, F)
        opts.append(opt)
    j, t = opts
    np.testing.assert_array_equal(t.y, j.y)
    np.testing.assert_array_equal(t.ref_point, j.ref_point)
    np.testing.assert_array_equal(np.asarray(t.xopt.tolist(), float), np.asarray(j.xopt.tolist(), float))
    assert t._last_hv == pytest.approx(j._last_hv, rel=1e-12)
    par_j = j._acq_par_defaults({})
    par_t = t._mo_par()
    K = len(par_t["cell_lower"])
    for key in ("cell_lower", "cell_upper"):
        want = np.asarray(par_j[key])
        assert want.shape[0] % 64 == 0 and not np.any(want[K:])
        np.testing.assert_array_equal(par_t[key], want[:K])
        assert par_t[key].dtype == np.float32
    j._rng.bit_generator.state = t._rng.bit_generator.state  # the key draw above moved JAX's
    state = t._rng.bit_generator.state
    j.ask()
    t.ask()
    assert t._rng.bit_generator.state == j._rng.bit_generator.state
    assert (t._rng.bit_generator.state != state) == (kind == "MOBO_qEHVI")


@pytest.mark.parametrize("m", [2, 3])
def test_multi_output_gp_fit_matches_jax_float64(m):
    """One GP with a shared theta on m objectives (the bi- and tri-sphere),
    float64 in both packages: log-likelihood within 1e-6 relative, the
    predicted mean and MSE within 1e-8."""
    rng = np.random.default_rng(m)
    X = rng.uniform(0, 1, (60, 2))
    centers = np.linspace(0.2, 0.8, m)
    F = np.stack([((X - c) ** 2).sum(1) for c in centers], axis=1)
    y = -(F - F.min(0)) / (F.max(0) - F.min(0))
    kw = dict(corr="matern", thetaL=1e-3 * np.ones(2), thetaU=1e3 * np.ones(2), nugget=1e-6,
              random_start=10, random_state=0, dtype="f64")
    jgp, tgp = JGP(mean=j_const(2), **kw), TGP(mean=t_const(2), device="cpu", **kw)
    jgp.fit(X, y)
    tgp.fit(X, y)
    assert abs(tgp.log_likelihood_ - jgp.log_likelihood_) <= 1e-6 * abs(jgp.log_likelihood_)
    Xq = rng.uniform(0, 1, (25, 2))
    mu_j, mse_j = (np.asarray(a) for a in jgp.predict(Xq, eval_MSE=True))
    mu_t, mse_t = tgp.predict(Xq, eval_MSE=True)
    assert mu_t.shape == (25, m) and mse_t.shape == (25, m)
    np.testing.assert_allclose(mu_t, mu_j, rtol=0, atol=1e-8)
    np.testing.assert_allclose(mse_t, mse_j, rtol=0, atol=1e-8)


def test_ehvi_object_wrapper():
    """EHVI(model, ref_point, partitioning)(X) is `ehvi` on the model's
    float32 moments; a reference point above the front is refused."""
    rng = np.random.default_rng(4)
    X = rng.uniform(0, 1, (20, 2))
    y = -np.c_[((X - 0.2) ** 2).sum(1), ((X - 0.8) ** 2).sum(1)]
    gp = TGP(thetaL=1e-3 * np.ones(2), thetaU=1e3 * np.ones(2), device="cpu").fit(X, y)
    ref = y.min(0) * 0.8 - 1e-6
    part = NondominatedPartitioning(ref, y)
    crit = EHVI(gp, ref, part)
    Xq = rng.uniform(0, 1, (5, 2))
    mu, mse = gp.predict(Xq, eval_MSE=True)
    want = ehvi(torch.tensor(mu, dtype=torch.float32), torch.tensor(mse, dtype=torch.float32).sqrt(),
                crit.cell_lower, crit.cell_upper).double().numpy()
    np.testing.assert_array_equal(crit(Xq), want)
    assert isinstance(crit(Xq[:1]), float)
    with pytest.raises(ValueError):
        EHVI(gp, np.zeros(2), NondominatedPartitioning(np.zeros(2), y))

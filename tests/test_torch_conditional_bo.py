"""The port's tree-surrogate BO paths against the JAX package on the CPU:
ConditionalBO (tests/test_extensions.py's case, and its subspaces against
the JAX package's), BO with a random-forest surrogate on a mixed space
(tests/test_random_forest.py's case), the criterion over a forest and over
a GP with a NonparametricTrend prior against the JAX package's
make_unit_criterion on one forest carried across, in float64, and the
refit of the prior's forest at every tell."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesian_optimization_tpu as jbo
import bayesian_optimization_tpu_torch as tbo
from bayesian_optimization_tpu.core.extensions import ConditionalBO as JCBO
from bayesian_optimization_tpu.models import GaussianProcess as JGP
from bayesian_optimization_tpu.models import NonparametricTrend as JNPT
from bayesian_optimization_tpu.models.random_forest import RandomForest as JRF
from bayesian_optimization_tpu.models.random_forest import RFState as JRFState
from bayesian_optimization_tpu.models.likelihood import PosteriorState as JState
from bayesian_optimization_tpu.optim.argmax import make_unit_criterion as j_criterion
from bayesian_optimization_tpu_torch.models import GaussianProcess as TGP
from bayesian_optimization_tpu_torch.models.convert import rf_state_from_numpy
from bayesian_optimization_tpu_torch.optim.argmax import make_unit_criterion as t_criterion

torch.set_num_threads(1)  # one thread per pytest worker: more oversubscribe the cores


def _conditional_space(pkg):
    return pkg.SearchSpace([
        pkg.Integer([1, 3], "x"),
        pkg.Discrete(["A", "B", "C"], "y1", conditions="x == 1"),
        pkg.Discrete(["A", "B", "C"], "y2", conditions="x == 2"),
        pkg.Real([-5, 5], "z"),
    ])


def _fitness(params):
    v = params["x"] ** 2 + params["z"] ** 2
    if params.get("y1"):
        v += params["y1"] == "B"
    if params.get("y2"):
        v += params["y2"] == "A"
    return float(v)


def test_conditional_bo():
    """tests/test_extensions.py:71-96 on the port."""
    opt = tbo.ConditionalBO(search_space=_conditional_space(tbo), obj_fun=_fitness, DoE_size=4,
                            max_FEs=14, random_seed=0, device="cpu")
    opt.run()
    assert opt.eval_count >= 14
    assert opt.data.N >= 14
    X = opt.ask(2)  # dicts with every variable present (inactive => None)
    assert all(set(x) == {"x", "y1", "y2", "z"} for x in X)
    assert all((x["y1"] is None) == (x["x"] != 1) for x in X)
    assert all(isinstance(bo.model, tbo.RandomForest) and bo.model.is_fitted
               for bo in opt._bo if bo.data is not None)


def test_conditional_bo_subspaces_match_jax():
    """The port's subspaces, their fixed assignments and the sub-BOs' spaces
    are the JAX package's; a tell without its ask raises."""
    kw = dict(obj_fun=_fitness, DoE_size=4, max_FEs=14, random_seed=0)
    j = JCBO(search_space=_conditional_space(jbo), **kw)
    t = tbo.ConditionalBO(search_space=_conditional_space(tbo), device="cpu", **kw)
    assert [(d, cs.var_name) for d, cs in t.subspaces] == [(d, cs.var_name) for d, cs in j.subspaces]
    assert t._fixed_vars == j._fixed_vars
    assert [bo.var_names for bo in t._bo] == [bo.var_names for bo in j._bo]
    with pytest.raises(ValueError, match="matching ask"):
        t.tell([{"x": 1}], [0.0])


def test_bo_with_rf_surrogate_mixed():
    """tests/test_random_forest.py:61-75 on the port: "auto" picks MIES."""
    def obj(x):
        r, c = x
        return float(r) ** 2 + (0.0 if c == "b" else 1.0)

    space = tbo.RealSpace([-2, 2], var_name="r") + tbo.DiscreteSpace(["a", "b", "c"], var_name="c")
    space.random_seed = 0
    rf = tbo.RandomForest(n_estimators=20, feature_space="embedding", random_state=0, device="cpu")
    opt = tbo.BO(search_space=space, obj_fun=obj, model=rf, DoE_size=6, max_FEs=12,
                 acquisition_fun="MGFI", acquisition_par={"t": 2.0}, random_seed=0, device="cpu")
    xopt, fopt, _ = opt.run()
    assert opt._argmax.method == "MIES"
    assert opt.eval_count == 12
    assert fopt[0] < 2.5


def _mixed(pkg):
    s = pkg.RealSpace([[-2.0, 2.0]] * 2, var_name="r") + pkg.DiscreteSpace(["a", "b", "c"], var_name="c")
    s.random_seed = 0
    return s


def _mixed_data():
    rng = np.random.default_rng(0)
    enc = _mixed(jbo).encoding()
    X = [[float(a), float(b), c] for a, b, c in zip(rng.uniform(-2, 2, 40), rng.uniform(-2, 2, 40),
                                                     rng.choice(["a", "b", "c"], 40))]
    E = np.asarray(enc.unit_to_embed_np(enc.encode_unit(np.asarray(X, dtype=object))))
    y = np.array([x[0] ** 2 + x[1] + (x[2] == "b") for x in X])
    return E, (y - y.mean()) / y.std()


def _carried(jrf):
    state, config = rf_state_from_numpy({k: np.asarray(v) for k, v in jrf.posterior._asdict().items()},
                                        jrf.config.max_depth, "cpu", dtype=torch.float64)
    return state, config


def _jax_state64(jrf):
    return JRFState(**{k: (jnp.asarray(np.asarray(v), jnp.float64) if k == "value" else jnp.asarray(v))
                       for k, v in jrf.posterior._asdict().items()})


def test_rf_criterion_matches_jax():
    """MGFI over a forest (its mean and across-tree variance) on the mixed
    space's unit cube, the same forest in both packages, float64, 1e-8."""
    E, y = _mixed_data()
    jrf = JRF(n_estimators=30, feature_space="embedding", random_state=0).fit(E, y)
    state, config = _carried(jrf)
    U = np.random.default_rng(1).uniform(0, 1, (64, 3))
    pars = {"plugin": float(y.min()), "t": 2.0}
    with jax.enable_x64():
        crit = j_criterion(_mixed(jbo).encoding(dtype=jnp.float64), _jax_state64(jrf), jrf.config,
                           "MGFI", {k: jnp.asarray(v, jnp.float64) for k, v in pars.items()})
        vj = np.asarray(crit(jnp.asarray(U)))
    crit_t = t_criterion(_mixed(tbo).encoding(dtype=torch.float64), state, config, "MGFI",
                         {k: torch.tensor(v, dtype=torch.float64) for k, v in pars.items()})
    vt = crit_t(torch.tensor(U)).numpy()
    assert np.ptp(vj) > 0
    assert np.abs(vt - vj).max() <= 1e-8 * np.abs(vj).max()


def test_nonparametric_trend_criterion_matches_jax():
    """EI over a residual GP plus its NonparametricTrend prior's forest
    (`_prior_state`): the JAX fit and its forest carried across, float64,
    values and gradients at 1e-8."""
    rng = np.random.default_rng(2)
    X = rng.uniform(0, 1, (40, 2))
    y = np.sin(4 * X).sum(1)
    jrf = JRF(n_estimators=20, feature_space="embedding", random_state=0).fit(X, y)
    kw = dict(thetaL=1e-2 * np.ones(2), thetaU=1e2 * np.ones(2), random_start=4, random_state=0,
              dtype="f64")
    jgp = JGP(mean=JNPT(jrf), **kw).fit(X, y)
    assert jgp.config.trend == "constant" and not jgp.config.estimate_trend
    state, config = _carried(jrf)
    tgp = TGP(mean=tbo.NonparametricTrend(tbo.RandomForest(device="cpu"), device="cpu"),
              device="cpu", **kw)
    tgp.load_fitted(jgp.theta_, {k: np.asarray(v) for k, v in jgp.posterior._asdict().items()},
                    jgp.config._asdict())
    U = np.random.default_rng(3).uniform(0, 1, (64, 2))
    pars = {"plugin": float(y.min())}
    with jax.enable_x64():
        jpost = JState(**{k: jnp.asarray(np.asarray(v), jnp.float64)
                          for k, v in jgp.posterior._asdict().items()})
        crit = j_criterion(jbo.RealSpace([[0.0, 1.0]] * 2).encoding(dtype=jnp.float64), jpost,
                           jgp.config, "EI", {"plugin": jnp.asarray(pars["plugin"]),
                                              "_prior_state": _jax_state64(jrf),
                                              "_prior_depth": jrf.config.max_depth})
        vj = np.asarray(crit(jnp.asarray(U)))
        gj = np.asarray(jax.grad(lambda u: jnp.sum(crit(u)))(jnp.asarray(U)))
    crit_t = t_criterion(tbo.RealSpace([[0.0, 1.0]] * 2).encoding(dtype=torch.float64),
                         tgp.posterior, tgp.config, "EI",
                         {"plugin": torch.tensor(pars["plugin"], dtype=torch.float64),
                          "_prior_state": state, "_prior_depth": config.max_depth})
    Ut = torch.tensor(U, requires_grad=True)
    vt = crit_t(Ut)
    (gt,) = torch.autograd.grad(vt.sum(), Ut)
    assert np.abs(vt.detach().numpy() - vj).max() <= 1e-8 * np.abs(vj).max()
    assert np.abs(gt.numpy() - gj).max() <= 1e-8 * np.abs(gj).max()


def test_nonparametric_trend_predict_and_refit():
    """The residual GP adds its prior back in predict and predict_torch; a
    BO loop refits the wrapped forest at every tell, on the standardized
    targets; a prior that is not the port's forest raises in the loop."""
    forest = tbo.RandomForest(n_estimators=10, feature_space="embedding", random_state=0,
                              device="cpu")
    gp = TGP(mean=tbo.NonparametricTrend(forest, device="cpu"), thetaL=1e-3 * np.ones(2),
             thetaU=1e3 * np.ones(2), random_state=0, device="cpu")
    fits = []
    fit = forest.fit
    forest.fit = lambda X, y: fits.append(np.asarray(y).copy()) or fit(X, y)
    opt = tbo.BO(search_space=tbo.RealSpace([[-5.0, 5.0]] * 2, random_seed=0),
                 obj_fun=lambda x: float(np.sum(np.asarray(x) ** 2)), model=gp, DoE_size=5,
                 max_FEs=8, random_seed=0, device="cpu")
    opt.run()
    assert len(fits) == 4  # the DoE's tell and three more
    f = opt.data.fitness[:, 0]
    np.testing.assert_allclose(fits[-1], (f - f.mean()) / f.std())
    Xe = opt._model_features(opt.data)
    mu = gp.predict(Xe)
    mu_t, _ = gp.predict_torch(torch.tensor(Xe, dtype=torch.float32))
    np.testing.assert_allclose(mu, mu_t[:, 0].double().numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(mu, fits[-1], atol=0.05)  # a near-interpolating fit

    class Host:
        is_fitted = True

        def predict(self, X):
            return np.zeros(len(X))

    gp.mean = tbo.NonparametricTrend(Host(), device="cpu")
    with pytest.raises(ValueError, match="RandomForest"):
        gp.predict_torch(torch.zeros(1, 2))
    with pytest.raises(ValueError, match="RandomForest"):
        opt.update_model()


def test_reference_style_nonparametric_trend():
    """NonparametricTrend(X, y) grows a 20-tree forest on the device named."""
    rng = np.random.default_rng(4)
    X = rng.uniform(0, 1, (30, 2))
    trend = tbo.NonparametricTrend(X, X.sum(1), device="cpu")
    assert isinstance(trend.model, tbo.RandomForest) and trend.model.n_estimators == 20
    assert trend(X).shape == (30, 1) and not trend.estimate_coefficients

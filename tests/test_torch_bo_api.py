"""The port's BO entry points (core/base.py) against the JAX package on the
CPU, the cases of tests/test_bo.py that no other port test covers: the warm
start of fmin, the manual ask/tell, the fixed-variable ask through the DoE
and the argmax, the flat-fitness guard, recommend before any data, the dict
eval type, the dill checkpoint (and a card checkpoint where there is no
card), the infeasible ask, the JSON state and its space check, and the theta
bounds rescaled to the unit embedding. The deterministic parts are held to
the JAX package computed here with the same seed: the DoE rows, the JSON
state's keys, space, data, counters and random state, and the rescaled
bounds."""
import numpy as np
import pytest
import torch

import bayesian_optimization_tpu as jbo
import bayesian_optimization_tpu_torch as tbo
from bayesian_optimization_tpu.models.trend import constant_trend as j_const
from bayesian_optimization_tpu_torch.models.trend import constant_trend as t_const

torch.set_num_threads(1)  # one thread per pytest worker: more oversubscribe the cores

CPU = {"device": "cpu"}


def sphere(x):
    return float(np.sum(np.asarray(x, dtype=float) ** 2))


def make_gp(d, pkg=tbo):
    trend, extra = (t_const, CPU) if pkg is tbo else (j_const, {})
    return pkg.GaussianProcess(mean=trend(d), corr="matern", thetaL=1e-3 * np.ones(d),
                               thetaU=1e3 * np.ones(d), nugget=1e-6, random_start=6, max_iter=30,
                               random_state=0, **extra)


def make_bo(pkg=tbo, d=2, box=(-5, 5), var_name="x", cls="BO", **kw):
    extra = CPU if pkg is tbo else {}
    kw.setdefault("obj_fun", sphere)
    return getattr(pkg, cls)(search_space=pkg.RealSpace([list(box)] * d, var_name=var_name, random_seed=0),
                             model=make_gp(d, pkg), random_seed=0, **kw, **extra)


def test_fmin_warm_start_x0_y0():
    x0 = [[1.0, 1.0], [-2.0, 3.0], [0.5, -0.5], [4.0, -4.0], [-1.0, -1.0]]
    y0 = [sphere(x) for x in x0]
    xopt, fopt, iters, evals, _ = tbo.fmin(sphere, [-5.0] * 2, [5.0] * 2, x0=x0, y0=y0, max_FEs=6,
                                           seed=1, **CPU)
    assert evals <= 6
    assert fopt <= min(y0)


def test_bo_continuous_run():
    opt = make_bo(DoE_size=5, max_FEs=12)
    xopt, fopt, stop = opt.run()
    assert opt.eval_count == 12
    assert "max_FEs" in stop
    assert fopt[0] < 5.0


def test_bo_ask_tell_manual():
    opt, j = (make_bo(pkg, box=(-1, 1), DoE_size=4, max_FEs=10) for pkg in (tbo, jbo))
    X = opt.ask()
    assert len(X) == 4 and X == j.ask()  # the JAX package's DoE rows
    opt.tell(X, [sphere(x) for x in X])
    X2 = opt.ask()
    assert len(X2) == 1  # model fitted, single acquisition point
    opt.tell(X2, [sphere(x) for x in X2])
    assert opt.iter_count == 2


def test_bo_fixed_variable_ask():
    """ask(fixed=) through the DoE (the JAX package's rows) and through the
    argmax: every row carries the fixed value, the free coordinate stays in
    the box."""
    opt, j = (make_bo(pkg, var_name=["a", "b"], DoE_size=4, max_FEs=8) for pkg in (tbo, jbo))
    X = opt.ask(fixed={"a": 1.5})
    assert X == j.ask(fixed={"a": 1.5})
    for x in X:
        assert np.isclose(float(x[0]), 1.5, atol=1e-4)
    opt.tell(X, [sphere(x) for x in X])
    for col, value in ((0, -2.0), (1, 0.25)):
        (x,) = opt.ask(fixed={"ab"[col]: value})
        assert np.isclose(float(x[col]), value, atol=1e-4)
        assert all(-5.0 <= float(v) <= 5.0 for v in x)


def test_bo_flat_fitness_error():
    opt = make_bo(obj_fun=lambda x: 1.0, DoE_size=8, max_FEs=30)
    with pytest.raises(tbo.FlatFitnessError):
        opt.run()


def test_recommend_before_data_raises():
    opt = tbo.BO(search_space=tbo.RealSpace([[-5, 5]] * 2, random_seed=0), model=make_gp(2),
                 DoE_size=4, max_FEs=8, **CPU)
    with pytest.raises(tbo.RecommendationUnavailableError):
        opt.recommend()


def test_bo_dict_eval_type():
    def obj(d):
        return d["u"] ** 2 + d["v"] ** 2

    opt, j = (make_bo(pkg, box=(-1, 1), var_name=["u", "v"], obj_fun=obj, DoE_size=4, max_FEs=8,
                      eval_type="dict") for pkg in (tbo, jbo))
    X = opt.ask()
    assert isinstance(X[0], dict) and set(X[0]) == {"u", "v"}
    assert X == j.ask()
    opt.tell(X, [obj(x) for x in X])
    X2 = opt.ask()
    assert len(X2) == 1 and set(X2[0]) == {"u", "v"}
    opt.tell(X2, [obj(x) for x in X2])
    assert opt.eval_count == 5


def test_save_load_roundtrip(tmp_path):
    """The dill checkpoint continues, and its next ask equals the saved
    optimizer's (the argmax is rebuilt from its seed, as the JAX package
    rebuilds it)."""
    opt = make_bo(DoE_size=4, max_FEs=10)
    opt.step()
    f = tmp_path / "ckpt.pkl"
    opt.save(str(f))
    opt2 = tbo.BO.load(str(f))
    assert opt2.iter_count == opt.iter_count and opt2.data.N == opt.data.N
    assert opt2.device == torch.device("cpu") and opt2.model.posterior.L.device.type == "cpu"
    assert opt2.ask() == opt.ask()
    opt2.step()  # must be able to continue
    assert opt2.iter_count == opt.iter_count + 1


def test_card_checkpoint_without_a_card_raises(tmp_path):
    """A checkpoint saved from the card, loaded where there is none, raises
    the device gate's error before any tensor is read."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: a card checkpoint loads")
    opt = make_bo(DoE_size=4, max_FEs=10)
    opt.step()
    opt.device = torch.device("cuda")  # what a BO on the card records
    f = tmp_path / "card.pkl"
    opt.save(str(f))
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        tbo.BO.load(str(f))


def test_infeasible_constraint_ask_empty():
    opt = make_bo(box=(0, 1), ineq_fun=lambda x: 1.0, DoE_size=4, max_FEs=8)  # never feasible
    with pytest.raises(tbo.AskEmptyError):
        opt.ask()


def test_structured_state_roundtrip(tmp_path):
    """The JSON state restores data, counters and the random state into a
    fresh optimizer, which refits to the same theta and continues. Its keys,
    space, data, counters and random state are the JAX package's."""
    opt, j = (make_bo(pkg, DoE_size=4, max_FEs=12) for pkg in (tbo, jbo))
    opt.step()
    j.step()
    state, state_j = opt.state_dict(), j.state_dict()
    assert sorted(state) == sorted(state_j)
    for key in ("version", "cls", "iter_count", "eval_count", "hist_f", "rng_state", "space", "data"):
        assert state[key] == state_j[key], key
    f = tmp_path / "state.json"
    opt.save_state(str(f))
    opt2 = make_bo(DoE_size=4, max_FEs=12)
    opt2.load_state(str(f))
    assert (opt2.iter_count, opt2.eval_count) == (opt.iter_count, opt.eval_count)
    assert opt2.data.N == opt.data.N and opt2.model.is_fitted
    np.testing.assert_array_equal(opt2.model.theta_, opt.model.theta_)
    assert opt2._rng.bit_generator.state == opt._rng.bit_generator.state
    opt2.step()
    assert opt2.data.N > opt.data.N


def test_structured_state_space_mismatch(tmp_path):
    opt = make_bo(DoE_size=4, max_FEs=12)
    opt.step()
    f = tmp_path / "state.json"
    opt.save_state(str(f))
    other = make_bo(d=3, var_name="y", DoE_size=4, max_FEs=12)
    with pytest.raises(ValueError):
        other.load_state(str(f))


def test_theta_bounds_rescaled_to_unit_embedding():
    """User theta bounds are rescaled by width^2 per real dimension onto the
    unit embedding, once, as the JAX package rescales them."""
    def bounds(pkg, **gp_kw):
        trend, extra = (t_const, CPU) if pkg is tbo else (j_const, {})
        gp = pkg.GaussianProcess(mean=trend(3), nugget=1e-6, random_state=0, **gp_kw, **extra)
        opt = pkg.BO(search_space=pkg.RealSpace([[-5.0, 5.0]] * 3, random_seed=0), obj_fun=sphere,
                     model=gp, DoE_size=4, max_FEs=8, random_seed=0, **extra)
        return opt, gp

    opt, gp = bounds(tbo, thetaL=1e-2 * np.ones(3), thetaU=1e4 * np.ones(3))
    assert np.allclose(gp.thetaL, 1e-2 * 100.0) and np.allclose(gp.thetaU, 1e4 * 100.0)
    assert gp._theta_bounds_unit_scaled
    opt._rescale_theta_bounds_to_unit()  # idempotent
    assert np.allclose(gp.thetaL, 1e-2 * 100.0)
    _, gj = bounds(jbo, thetaL=1e-2 * np.ones(3), thetaU=1e4 * np.ones(3))
    np.testing.assert_array_equal(gp.thetaL, gj.thetaL)
    np.testing.assert_array_equal(gp.thetaU, gj.thetaU)
    # scalar bounds broadcast, then scale
    _, gp2 = bounds(tbo, thetaL=np.asarray([1e-3]), thetaU=np.asarray([1e3]))
    _, gj2 = bounds(jbo, thetaL=np.asarray([1e-3]), thetaU=np.asarray([1e3]))
    assert gp2.thetaL.shape == (3,) and np.allclose(gp2.thetaL, 0.1)
    np.testing.assert_array_equal(gp2.thetaL, gj2.thetaL)
    # the default model gets the width-proportional window, 1e-3 * w * w^2
    defaults = [pkg.BO(search_space=pkg.RealSpace([[-5.0, 5.0]] * 3), obj_fun=sphere, DoE_size=4,
                       max_FEs=8, **extra).model for pkg, extra in ((tbo, CPU), (jbo, {}))]
    assert np.allclose(defaults[0].thetaL, 1e-3 * 10.0 * 100.0)
    assert np.allclose(defaults[0].thetaU, 1e3 * 10.0 * 100.0)
    np.testing.assert_array_equal(defaults[0].thetaL, defaults[1].thetaL)
    np.testing.assert_array_equal(defaults[0].thetaU, defaults[1].thetaU)

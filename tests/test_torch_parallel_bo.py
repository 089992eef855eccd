"""The port's batch BO flavors and fmin(n_point > 1) against the JAX
package on the CPU (modeled on tests/test_bo.py:89-155): the acquisition
parameters the samplers draw from numpy's generator equal the JAX
package's exactly for the same seed, ask for ask, while both packages see
the same observations, the same posterior and the same restart pool
(SelfAdaptiveBO's next t follows the ranking of the batch's values, which
follows the fit -- float32 fits of 8 points can end in other basins,
ROADMAP Queue 3 -- and the restarts); every ask returns q distinct points."""
import numpy as np
import pytest
import torch

import bayesian_optimization_tpu as jbo
import bayesian_optimization_tpu_torch as tbo
from bayesian_optimization_tpu.models.trend import constant_trend as j_const
from bayesian_optimization_tpu_torch.models.trend import constant_trend as t_const

torch.set_num_threads(1)  # one thread per pytest worker: more oversubscribe the cores

Q = 3
N_RESTART = 4
POOL = np.random.default_rng(5).uniform(0, 1, (N_RESTART, 2))  # every criterion's starts


def sphere(x):
    return float(np.sum(np.asarray(x, dtype=float) ** 2))


def make_gp(pkg, trend, **kw):
    return pkg.GaussianProcess(
        mean=trend(2), corr="matern", thetaL=1e-3 * np.ones(2), thetaU=1e3 * np.ones(2),
        nugget=1e-6, random_start=4, max_iter=20, random_state=0, **kw,
    )


def make_pair(cls_name, **kw):
    """The same optimizer in both packages: 2-D sphere, DoE of 5, seed 0."""
    out = []
    for pkg, trend, extra in ((jbo, j_const, {}), (tbo, t_const, {"device": "cpu"})):
        out.append(getattr(pkg, cls_name)(
            search_space=pkg.RealSpace([[-5, 5]] * 2, random_seed=0), obj_fun=sphere,
            model=make_gp(pkg, trend, **extra), DoE_size=5, max_FEs=5 + 3 * Q, n_point=Q,
            random_seed=0, acquisition_optimization={"n_restart": N_RESTART}, **extra, **kw,
        ))
    return out


def tell_both(j, t, X, y):
    """Both packages observe (X, y); the port then adopts the JAX fit."""
    j.tell(X, y)
    t.tell(X, y)
    t.model.load_fitted(j.model.theta_,
                        {k: np.asarray(v) for k, v in j.model.posterior._asdict().items()},
                        j.model.config._asdict())


def record_batches(opt):
    """Wrap opt's argmax batch to start every criterion from POOL; returns
    the list its calls append to, each (acquisition, [the sampled
    parameters of each criterion, plugin aside])."""
    calls, batch = [], opt._argmax.batch

    def recorder(state, config, acq, pars, **kw):
        calls.append((acq, [{k: v for k, v in p.items() if k != "plugin"} for p in pars]))
        return batch(state, config, acq, pars, x0_seed=POOL, **kw)

    opt._argmax.batch = recorder
    return calls


CONFIGS = [
    ("ParallelBO", {"acquisition_fun": "MGFI", "acquisition_par": {"t": 2.0}}),
    ("ParallelBO", {"acquisition_fun": "UCB", "acquisition_par": {"alpha": 0.5}}),
    ("AnnealingBO", {"schedule": "exp"}),
    ("AnnealingBO", {"schedule": "linear"}),
    ("AnnealingBO", {"schedule": "log"}),
    ("SelfAdaptiveBO", {}),
    ("MultiAcquisitionBO", {}),
]


@pytest.mark.parametrize("cls_name,kw", CONFIGS, ids=[f"{c}-{k}" for c, k in
                                                      [(c, "-".join(map(str, kw.values()))) for c, kw in CONFIGS]])
def test_sampled_parameters_equal_jax_over_three_asks(cls_name, kw):
    j, t = make_pair(cls_name, **kw)
    calls_j, calls_t = record_batches(j), record_batches(t)
    X = j.ask()
    assert np.array_equal(np.asarray(X, float), np.asarray(t.ask(), float))  # the same DoE
    tell_both(j, t, X, [sphere(x) for x in X])
    for _ in range(3):
        Xj, Xt = j.ask(), t.ask()
        assert len(Xt) == Q and len({tuple(np.round(x, 12)) for x in Xt}) == Q
        tell_both(j, t, Xj, [sphere(x) for x in Xj])
    assert len(calls_t) == len(calls_j) >= 3
    assert calls_t == calls_j
    assert t._rng.bit_generator.state == j._rng.bit_generator.state


def test_noisy_bo_accepts_duplicates_and_plugs_in_a_prediction():
    _, t = make_pair("NoisyBO")
    X = t.ask()
    t.tell(X, [sphere(x) for x in X])
    rows = [[1.0, 2.0], [1.0, 2.0], [0.5, -0.5]]
    assert t.pre_eval_check(rows) == rows
    y_hat = t.model.predict(t._model_features(t.data))
    assert t._acq_par_defaults({"t": 1.0})["plugin"] == float(np.min(y_hat))
    Xq = t.ask()
    assert len(Xq) == Q


def test_fmin_n_point_runs_in_chunks_as_jax():
    """fmin(sphere, n_point=3, max_FEs=15): the DoE, then chunks of 3."""
    hist = {}
    for pkg, extra in ((jbo, {}), (tbo, {"device": "cpu"})):
        xopt, fopt, iters, evals, h = pkg.fmin(sphere, [-5.0] * 2, [5.0] * 2, n_point=3,
                                                max_FEs=15, seed=0, **extra)
        hist[pkg.__name__] = ([len(c) for c in h], iters, evals)
        assert abs(sphere(xopt) - fopt) < 1e-9 and fopt <= min(sphere(x) for x in h[0])
    assert hist["bayesian_optimization_tpu_torch"] == hist["bayesian_optimization_tpu"]
    assert hist["bayesian_optimization_tpu_torch"][0] == [10, 3, 3]


def test_bo_mixed_space_runs_mies():
    """tests/test_bo.py:89's mixed space: method 'auto' picks MIES."""
    def obj(x):
        r, i, c, b = x
        return float(r) ** 2 + abs(int(i) - 3) + (0.0 if c == "b" else 1.0) + (0.0 if b else 0.5)

    space = (
        tbo.RealSpace([-2, 2], var_name="r") + tbo.IntegerSpace([0, 6], var_name="i")
        + tbo.DiscreteSpace(["a", "b", "c"], var_name="c") + tbo.BoolSpace(var_name="b")
    )
    space.random_seed = 0
    opt = tbo.BO(search_space=space, obj_fun=obj, DoE_size=6, max_FEs=12, random_seed=0, device="cpu")
    assert opt._argmax.method == "MIES"
    xopt, fopt, _ = opt.run()
    assert opt.eval_count == 12
    assert fopt[0] <= 8.0
    r, i, c, b = opt.xopt.first()
    assert isinstance(float(r), float) and float(i).is_integer()
    assert c in ("a", "b", "c") and isinstance(b, (bool, np.bool_))


@pytest.mark.parametrize("cls_name", ["ParallelBO", "MultiAcquisitionBO"])
def test_batch_flavors_on_a_mixed_space(cls_name):
    """Under MIES a batch runs the CMA engine, as in the JAX package, also
    for a group of one criterion (MultiAcquisitionBO's UCB slot at q = 3)."""
    def obj(x):
        r, i, c = x
        return float(r) ** 2 + abs(int(i) - 3) + (0.0 if c == "b" else 1.0)

    space = (tbo.RealSpace([-2, 2], var_name="r") + tbo.IntegerSpace([0, 6], var_name="i")
             + tbo.DiscreteSpace(["a", "b", "c"], var_name="c"))
    space.random_seed = 0
    opt = getattr(tbo, cls_name)(search_space=space, obj_fun=obj, DoE_size=5, max_FEs=8, n_point=Q,
                                 random_seed=0, device="cpu")
    assert opt._argmax.method == "MIES"
    X = opt.ask()
    opt.tell(X, [obj(x) for x in X])
    X = opt.ask()
    assert len(X) == Q and all(float(x[1]).is_integer() and x[2] in ("a", "b", "c") for x in X)


def test_parallel_bo_refuses_one_point():
    with pytest.raises(ValueError):
        tbo.ParallelBO(search_space=tbo.RealSpace([[-1, 1]] * 2), obj_fun=sphere, n_point=1,
                       device="cpu")
    with pytest.raises(NotImplementedError):
        tbo.BO(search_space=tbo.RealSpace([[-1, 1]] * 2), obj_fun=sphere,
               device="cpu")._batch_arg_max_acquisition(2, None)

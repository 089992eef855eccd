"""Constrained BO end to end on the port, device="cpu": the cases of
tests/test_constrained_bo.py (ref: unittest/test_constraint.py:29-108),
with the same settings and the same checks. The dict-eval case runs the
default GP on its mixed space (MIES engine): the random forest is not
ported. Equality with the JAX package's winner is not asked: both runs
end near the same constrained optimum (config 6 of benchmark/parity.py),
which the first case checks against the JAX package's own run."""
import numpy as np
import pytest
import torch

import bayesian_optimization_tpu as jbo
import bayesian_optimization_tpu_torch as tbo
from bayesian_optimization_tpu_torch.utils.exceptions import ConstraintEvaluationError

torch.set_num_threads(1)  # one thread per pytest worker: more oversubscribe the cores


def _obj(x):
    return np.sum(np.array(x) ** 2) + 5 * np.sum(np.array(x)) + 10


def _h(x):
    return np.sum(x) - 1


def _gp(pkg, dim, seed=42, **kw):
    return pkg.GaussianProcess(corr="squared_exponential", thetaL=1e-5 * np.ones(dim),
                               thetaU=np.ones(dim), nugget=1e-1, random_state=seed, **kw)


def test_bo_equality_bfgs_traced():
    """|h(xopt)| <= 0.1 and BFGS kept; the JAX package's run on the same
    settings ends at the same constrained optimum (15.44 on h = 0)."""
    kw = dict(obj_fun=_obj, eq_fun=_h, max_FEs=20, DoE_size=3, acquisition_fun="MGFI",
              acquisition_par={"t": 2}, acquisition_optimization={"optimizer": "BFGS"},
              random_seed=42)
    opt = tbo.BO(search_space=tbo.RealSpace([0, 1]) * 2, model=_gp(tbo, 2, device="cpu"),
                 device="cpu", **kw)
    assert opt._constraints is not None and opt._constraints.traceable
    assert opt._optimizer_name == "BFGS"
    xopt, fopt, _ = opt.run()
    assert np.isclose(_h(np.asarray(xopt, float)), 0, atol=1e-1)
    ref = jbo.BO(search_space=jbo.RealSpace([0, 1]) * 2, model=_gp(jbo, 2), **kw)
    _, fopt_j, _ = ref.run()
    assert abs(float(fopt[0]) - float(fopt_j[0])) < 0.02


def test_bo_equality_callback_fallback():
    """A constraint that cannot run as tensor code (np.array coercion) runs
    on the host, moves BFGS to the CMA engine and still ends near-feasible."""

    def h_host(x):
        return float(np.sum(np.array(list(x), dtype=float))) - 1.0

    opt = tbo.BO(search_space=tbo.RealSpace([0, 1]) * 2, obj_fun=_obj, eq_fun=h_host,
                 model=_gp(tbo, 2, device="cpu"), max_FEs=14, DoE_size=3,
                 acquisition_fun="MGFI", acquisition_par={"t": 2},
                 acquisition_optimization={"optimizer": "BFGS"}, random_seed=42, device="cpu")
    assert not opt._constraints.traceable
    assert opt._optimizer_name == "OnePlusOne_Cholesky_CMA"
    xopt, _, _ = opt.run()
    assert np.isclose(h_host(xopt), 0, atol=1e-1)
    assert opt._constraints.host_calls > 0


def test_bo_inequality_dict_mixed_space():
    """MGFI + dict eval_type with inequality constraints on a mixed space
    ends feasible (the default GP and its MIES engine)."""

    def obj2(x):
        return (x["pc"] - 0.2) ** 2 + x["mu"] + x["lam"] + abs(x["p"] - 0.7)

    def g(x):
        return [-x["pc"], x["mu"] - 1.9]

    space = (tbo.IntegerSpace([1, 10], var_name="mu") + tbo.IntegerSpace([1, 10], var_name="lam")
             + tbo.RealSpace([0, 1], var_name="pc") + tbo.RealSpace([0.005, 0.5], var_name="p"))
    opt = tbo.BO(search_space=space, obj_fun=obj2, ineq_fun=g, max_FEs=10, DoE_size=3,
                 eval_type="dict", acquisition_fun="MGFI", acquisition_par={"t": 2},
                 random_seed=42, device="cpu")
    assert opt._constraints.traceable and opt._optimizer_name == "MIES"
    xopt, _, _ = opt.run()
    xd = xopt[0] if isinstance(xopt[0], dict) else dict(zip(space.var_name, xopt[0]))
    assert all(np.array(g(xd)) <= 0)


def test_parallel_bo_inequality_batch():
    """q-batch asks carry the penalty through the batched argmax."""

    def g(x):
        return x[0] + x[1] - 1.2  # feasible region: x0 + x1 <= 1.2

    opt = tbo.ParallelBO(search_space=tbo.RealSpace([0, 1]) * 3,
                         obj_fun=lambda x: float(np.sum((np.asarray(x) - 0.8) ** 2)),
                         ineq_fun=g, model=_gp(tbo, 3, seed=42, device="cpu"), n_point=3,
                         max_FEs=15, DoE_size=6, random_seed=7, device="cpu")
    xopt, _, _ = opt.run()
    assert g(np.asarray(xopt, float).ravel()) <= 1e-6


def test_bad_constraint_raises():
    """A constraint that crashes on the space's values raises at construction."""
    space = (tbo.DiscreteSpace(["1", "2", "3"], var_name="lam") + tbo.RealSpace([0, 1], var_name="pc")
             + tbo.RealSpace([0.005, 0.5], var_name="p"))
    with pytest.raises(ConstraintEvaluationError):
        tbo.BO(search_space=space, obj_fun=lambda x: 10 * (x[0] == "3") + x[1] * x[2],
               ineq_fun=lambda x: sum(np.array(list(x)) ** 2), max_FEs=10, DoE_size=3,
               eval_type="list", acquisition_fun="MGFI", acquisition_par={"t": 2},
               random_seed=42, device="cpu").run()


def test_save_load_rebuilds_constraints(tmp_path):
    opt = tbo.BO(search_space=tbo.RealSpace([0, 1]) * 2, obj_fun=_obj, eq_fun=_h,
                 model=_gp(tbo, 2, device="cpu"), max_FEs=8, DoE_size=3,
                 acquisition_fun="MGFI", acquisition_par={"t": 2}, random_seed=1, device="cpu")
    opt.step()
    f = str(tmp_path / "ck.dill")
    opt.save(f)
    opt2 = tbo.BO.load(f)
    assert opt2._constraints is not None and opt2._constraints.traceable
    assert opt2._argmax.constraints is opt2._constraints
    opt2.step()  # still runs constrained asks
    assert opt2.eval_count == 4


@pytest.mark.parametrize("method", ["OnePlusOne_Cholesky_CMA", "SMC", "MIES"])
def test_constrained_argmax_engines_pick_feasible(method):
    """AcquisitionArgmax(constraints=...) on the derivative-free engines: the
    winner of an EI argmax on a bowl posterior whose optimum lies outside
    the feasible set (x0 + x1 <= 0.6) is feasible, and the penalty moved it."""
    X = np.random.default_rng(0).uniform(0, 1, (30, 2))
    y = ((X - 0.7) ** 2).sum(1)
    y = (y - y.mean()) / y.std()
    gp = tbo.GaussianProcess(thetaL=1e-3 * np.ones(2), thetaU=1e3 * np.ones(2), random_state=0,
                             device="cpu").fit(X, y)
    enc = (tbo.RealSpace([0, 1]) * 2).encoding()
    cp = tbo.ConstraintProgram(enc, g=lambda x: x[0] + x[1] - 0.6, device="cpu")
    am = tbo.AcquisitionArgmax(enc, method=method, seed=0, constraints=cp, device="cpu")
    u, v = am(gp.posterior, gp.config, "EI", {"plugin": float(y.min()), "_penalty_t": 1e3})
    assert u[0] + u[1] <= 0.6 + 1e-6 and np.isfinite(v)
    u0, _ = tbo.AcquisitionArgmax(enc, method=method, seed=0, device="cpu")(
        gp.posterior, gp.config, "EI", {"plugin": float(y.min())})
    assert u0[0] + u0[1] > 0.6

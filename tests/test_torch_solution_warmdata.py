"""The port's Solution (core/solution.py) and warm data (BaseBO.warm_data)
against the JAX package on the CPU: the cases of
tests/test_solution_warmdata.py on the port, with the deterministic ones
held to the JAX package's output (the CSV text, the dict, `unique`, the
warm state's data and counters)."""
import numpy as np
import pytest
import torch

import bayesian_optimization_tpu as jbo
import bayesian_optimization_tpu_torch as tbo
from bayesian_optimization_tpu.models.trend import constant_trend as j_const
from bayesian_optimization_tpu_torch.models.trend import constant_trend as t_const

torch.set_num_threads(1)  # one thread per pytest worker: more oversubscribe the cores


def make_solution(pkg=tbo):
    return pkg.Solution([[1.0, "a"], [2.0, "b"], [3.0, "a"]], fitness=[[0.1], [0.2], [0.3]],
                        var_name=["x", "c"])


def test_slicing_and_metadata():
    s = make_solution()
    row = s[1]
    assert row.N == 1
    assert row.first() == [2.0, "b"]
    assert row.fitness[0, 0] == pytest.approx(0.2)
    sub = s[[0, 2]]
    assert sub.N == 2 and sub.index.tolist() == [0, 2]


def test_fitness_writes_through_basic_slices():
    s = make_solution()
    view = s[0:2]
    view.fitness[0, 0] = 9.9
    assert s.fitness[0, 0] == pytest.approx(9.9)
    s[[0, 2]].fitness[0, 0] = -1.0  # a fancy index copies
    assert s.fitness[0, 0] == pytest.approx(9.9)


def test_concat_and_repeat():
    s = make_solution()
    assert (s + s).N == 6
    rep = s * 2
    assert rep.N == 6 and rep.values[3, 0] == s.values[0, 0]
    j = make_solution(jbo) * 2
    assert rep.tolist() == j.tolist() and rep.index.tolist() == j.index.tolist()


def test_unique():
    rows = [[1, "a"], [1, "a"], [2, "b"], [1, "b"]]
    t = tbo.Solution(rows, var_name=["i", "c"]).unique()
    j = jbo.Solution(rows, var_name=["i", "c"]).unique()
    assert t.N == 3 and t.tolist() == j.tolist()


def test_dict_roundtrip():
    s = make_solution()
    for orient in ("var", "index"):
        d = s.to_dict(orient=orient)
        assert d == make_solution(jbo).to_dict(orient=orient)
    s2 = tbo.Solution.from_dict(s.to_dict(orient="var"))
    assert s2.N == s.N and s2.values[1, 1] == "b"


def test_csv_roundtrip(tmp_path):
    """The CSV text equals the JAX package's, and reads back."""
    f, fj = tmp_path / "sol.csv", tmp_path / "sol_jax.csv"
    make_solution().to_csv(str(f))
    make_solution(jbo).to_csv(str(fj))
    assert f.read_text() == fj.read_text()
    make_solution().to_csv(str(f), header=False, append=True)
    make_solution(jbo).to_csv(str(fj), header=False, append=True)
    assert f.read_text() == fj.read_text()
    s2 = tbo.Solution.from_csv(str(tmp_path / "sol.csv"))
    assert s2.N == 6
    assert float(s2.values[2, 0]) == 3.0
    assert np.allclose(s2.fitness.ravel(), [0.1, 0.2, 0.3] * 2)


def sphere(x):
    return float(np.sum(np.asarray(x, dtype=float) ** 2))


X0 = [[1.0, 1.0], [-2.0, 3.0], [0.5, -0.5], [4.0, -4.0], [-1.0, -1.0], [2.0, 2.0]]


def warm_bo(pkg, trend, **extra):
    gp = pkg.GaussianProcess(mean=trend(2), corr="matern", thetaL=1e-3 * np.ones(2),
                             thetaU=1e3 * np.ones(2), nugget=1e-6, random_start=6, max_iter=25,
                             random_state=0, **extra)
    return pkg.BO(search_space=pkg.RealSpace([[-5, 5]] * 2, random_seed=0), obj_fun=sphere, model=gp,
                  warm_data=(X0, [sphere(x) for x in X0]), max_FEs=4, random_seed=0, **extra)


def test_warm_data_seeds_model_and_counts():
    """Warm data becomes the initial data, the model is fitted, and the
    budget counts only fresh evaluations; the warm state (data, counters,
    the fitness standardization) is the JAX package's."""
    opt = warm_bo(tbo, t_const, device="cpu")
    j = warm_bo(jbo, j_const)
    assert opt.data.N == j.data.N == len(X0)
    assert opt.data.tolist() == j.data.tolist()
    assert np.array_equal(opt.data.fitness, j.data.fitness)
    assert opt.data.index.tolist() == j.data.index.tolist()
    assert opt.model.is_fitted and j.model.is_fitted
    assert (opt.eval_count, opt.iter_count) == (j.eval_count, j.iter_count) == (0, 0)
    assert opt._fitness_mean == j._fitness_mean and opt._fitness_std == j._fitness_std
    opt.run()
    assert opt.eval_count == 4
    assert opt.data.N == len(X0) + 4


@pytest.mark.parametrize("pkg", [jbo, tbo], ids=["jax", "torch"])
def test_warm_data_out_of_space_rejected(pkg):
    extra = {"device": "cpu"} if pkg is tbo else {}
    gp = pkg.GaussianProcess(thetaL=1e-3 * np.ones(2), thetaU=1e3 * np.ones(2), **extra)
    with pytest.raises(ValueError):
        pkg.BO(search_space=pkg.RealSpace([[-1, 1]] * 2, random_seed=0), obj_fun=lambda x: 0.0,
               model=gp, warm_data=([[5.0, 5.0]], [50.0]), max_FEs=5, **extra)

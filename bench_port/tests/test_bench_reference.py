"""The plain reference against the port on the CPU at small sizes: the
port's float64 path computes the same model, so they agree to rounding;
its float32 path (the cells' precision) to float32 rounding."""
import numpy as np
import pytest
import torch

from bayesian_optimization_tpu_torch import GaussianProcess
from bayesian_optimization_tpu_torch.models.likelihood import GPConfig, posterior_state, predict_gp
from bayesian_optimization_tpu_torch.models.trend import constant_trend
from bayesian_optimization_tpu_torch.ops.acquisition import ei
from bench_port.bbob import BBOBFunction
from bench_port.reference import gp as ref
from bench_port.reference import judge

D = 5


def _data(n, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-5, 5, (n, D))
    y = BBOBFunction(8, D, 3)(X)
    return (X + 5) / 10, (y - y.mean()) / y.std()


def _fit(U, ys, dtype):
    g = GaussianProcess(mean=constant_trend(D), corr="matern", thetaL=1e-2 * 100 * np.ones(D),
                        thetaU=1e4 * 100 * np.ones(D), nugget=1e-6, random_start=10,
                        random_state=0, dtype=dtype, device="cpu")
    return g.fit(U, ys)


@pytest.mark.parametrize("dtype,ll_tol,mu_tol", [("f64", 1e-8, 1e-8), ("f32", 5e-2, 2e-3)])
def test_likelihood_and_posterior_match_the_port(dtype, ll_tol, mu_tol):
    U, ys = _data(60)
    g = _fit(U, ys, dtype)
    post = ref.Posterior(U, ys, g._map_par_log10, g.noise_var, 1e-6, "float64", "cpu")
    assert post.log_likelihood == pytest.approx(g.log_likelihood_, abs=ll_tol * len(ys))
    Uq = np.random.default_rng(1).uniform(0, 1, (17, D))
    mu, var = g.predict(Uq, eval_MSE=True)
    rmu, rvar = post.predict(Uq)
    assert np.allclose(rmu.numpy(), mu, atol=mu_tol)
    assert np.allclose(rvar.numpy(), var, atol=mu_tol, rtol=mu_tol)


def test_mixture_matches_the_ports_ensemble_predict():
    U, ys = _data(40, 1)
    pars = np.array([[0.1, 0.3, -0.2, 0.5, 0.0, -0.01], [0.4, -0.1, 0.2, 0.1, 0.3, -0.02]])
    cfg = GPConfig(kernel="matern", mode="noisy", estimate_trend=True)
    X = torch.as_tensor(U)
    Y = torch.as_tensor(ys)[:, None]
    F = torch.ones(len(ys), 1, dtype=torch.float64)
    state = posterior_state(torch.as_tensor(pars), X, Y, F, torch.ones(len(ys), dtype=torch.float64),
                            float(len(ys)), 1e-6, torch.zeros(1, 1, dtype=torch.float64), cfg)
    Uq = torch.rand(9, D, dtype=torch.float64, generator=torch.Generator().manual_seed(2))
    mu, var = predict_gp(state, Uq, torch.ones(9, 1, dtype=torch.float64), cfg._replace(n_ensemble=2))
    posts = [ref.Posterior(U, ys, p, 1e-6, 1e-6, "float64", "cpu") for p in pars]
    rmu, rvar = ref.mixture(posts, Uq)
    assert torch.allclose(rmu, mu[:, 0], atol=1e-9)
    assert torch.allclose(rvar, var[:, 0], atol=1e-9)


def test_criteria_match_the_ports():
    g = torch.Generator().manual_seed(3)
    mu = torch.randn(50, generator=g, dtype=torch.float64)
    sd = torch.rand(50, generator=g, dtype=torch.float64) * 0.5
    sd[:3] = 0.0
    assert torch.allclose(ref.expected_improvement(mu, sd, -0.3), ei(mu, sd, plugin=-0.3), atol=1e-14)


def _record(U, ys, par, winner):
    # box [0, 1]: unit coordinates are the record's own
    return {"X": U, "y": ys, "par": np.asarray(par), "noise_var": 1e-6,
            "winners": np.atleast_2d(winner), "values": np.zeros(1), "crit": "EI",
            "asked": np.atleast_2d(winner)}


def test_argmax_ascent_reads_nought_at_a_maximum_and_more_elsewhere():
    U, ys = _data(40, 4)
    lb, ub = np.zeros(D), np.ones(D)
    model = {"nugget": 1e-6, "jitter": 1e-6}
    par = [1.0, 1.2, 0.8, 1.0, 0.9, -0.1]
    start = np.random.default_rng(5).uniform(0, 1, D)
    rec = _record(U, ys, par, start)
    r = judge.evaluate(rec, model, lb, ub, "float64", "cpu")
    assert judge.argmax_ascent(r, rec, lb, ub, "cpu") > 0.05
    top = ref.maximize(lambda t: judge._log_ei(r["posts"], r["plugin"], t).sum(), start[None],
                       lb, ub, "cpu")
    rec = _record(U, ys, par, top[0])
    assert judge.argmax_ascent(r, rec, lb, ub, "cpu") < 1e-6


def test_a_sampled_number_is_the_median_of_its_sample_and_judged_over_it():
    rows = [{"ll_gap": 1e-6, "argmax_ascent": a} for a in (0.0, 0.5, 1e-6, None)]
    numbers = judge.worst(rows)
    assert numbers["ll_gap"] == 1e-6 and numbers["argmax_ascent"] == 1e-6
    limits = {"ll_gap": 1e-4, "argmax_ascent": 1e-2}
    assert judge.verdict(numbers, limits)
    # a record whose own ascent is large does not fail by itself
    assert judge.row_verdict(rows[1], limits)


def test_reference_imports_nothing_of_the_port():
    import ast
    from pathlib import Path

    for path in Path(ref.__file__).parent.glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.partition(".")[0] not in ("jax", "bayesian_optimization_tpu",
                                                   "bayesian_optimization_tpu_torch"), (path, n)

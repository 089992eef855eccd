"""The port's search space (space/space.py, space/samplers.py,
space/variables.py) against the JAX package's, the cases of
tests/test_search_space.py on the port. Where a case is deterministic the
port is held to the JAX package's output for the same seed: the samples of
every method, the JSON text, the constrained (SCMC) samples and the
conditional subspaces."""
import json

import numpy as np
import pytest

import bayesian_optimization_tpu as jbo
import bayesian_optimization_tpu_torch as tbo
from bayesian_optimization_tpu.space.samplers import SCMC as JSCMC
from bayesian_optimization_tpu_torch.space.samplers import SCMC as TSCMC


def rows(X):
    return [list(r) for r in np.asarray(X, dtype=object)]


def test_real_scale_transforms():
    v = tbo.Real([1e-3, 1e3], scale="log10", name="x")
    lo, hi = v.bounds_transformed
    assert np.isclose(lo, -3) and np.isclose(hi, 3)
    assert np.isclose(v.to_linear_scale(0.0), 1.0)
    v = tbo.Real([-10, 10], scale="bilog", name="y")
    z = np.array([-5.0, 0.0, 5.0])
    assert np.allclose(v.to_linear_scale(v._trans(z)), z)
    assert np.array_equal(v._trans(z), jbo.Real([-10, 10], scale="bilog", name="y")._trans(z))


def test_real_precision_round():
    assert tbo.Real([0, 1], precision=2, name="x").round(0.123456) == pytest.approx(0.12)


def test_bounds_clip_warning():
    with pytest.warns(UserWarning):
        tbo.Real([-1, 10], scale="log", name="x")


def test_space_construction_and_masks():
    cs = (tbo.RealSpace([0, 1], var_name="r") + tbo.IntegerSpace([0, 10], var_name="i")
          + tbo.DiscreteSpace(["a", "b", "c"], var_name="c") + tbo.BoolSpace(var_name="b"))
    js = (jbo.RealSpace([0, 1], var_name="r") + jbo.IntegerSpace([0, 10], var_name="i")
          + jbo.DiscreteSpace(["a", "b", "c"], var_name="c") + jbo.BoolSpace(var_name="b"))
    assert cs.dim == 4
    assert list(cs.real_id) == [0] and list(cs.integer_id) == [1]
    assert list(cs.discrete_id) == [2] and list(cs.bool_id) == [3]
    assert cs.categorical_id.tolist() == js.categorical_id.tolist()


def test_space_algebra():
    s1 = tbo.RealSpace([[0, 1], [0, 2]], var_name=["a", "b"])
    s2 = tbo.IntegerSpace([0, 5], var_name="k")
    s = s1 + s2
    assert s.dim == 3 and isinstance(s, tbo.SearchSpace)
    s3 = s - "k"
    assert s3.dim == 2 and isinstance(s3, tbo.RealSpace)
    s4 = tbo.RealSpace([0, 1], var_name="x") * 3
    assert s4.dim == 3 and s4.var_name == ["x0", "x1", "x2"]
    assert (s1 + s2) == (s1 + s2)


def test_narrowing_classes():
    s = tbo.SearchSpace([tbo.Real([0, 1], name="x"), tbo.Real([0, 2], name="y")])
    assert isinstance(s, tbo.RealSpace)
    assert isinstance(tbo.SearchSpace([tbo.Integer([0, 5], name="i")]), tbo.IntegerSpace)
    assert isinstance(tbo.SearchSpace([tbo.Discrete(["a"], name="d")]), tbo.DiscreteSpace)
    assert type(tbo.SearchSpace([tbo.Real([0, 1], name="x"), tbo.Integer([0, 5], name="i")])) \
        is tbo.SearchSpace


def _sampling_space(pkg, seed):
    return (pkg.RealSpace([0.5, 2.5], var_name="r", scale="log", random_seed=seed)
            + pkg.IntegerSpace([3, 9], var_name="i") + pkg.DiscreteSpace(["x", "y", "z"], var_name="c"))


@pytest.mark.parametrize("method", ["uniform", "LHS", "sobol"])
def test_sampling_methods(method):
    cs = _sampling_space(tbo, 3)
    cs.random_seed = 3
    X = cs.sample(20, method=method)
    assert X.shape == (20, 3)
    for row in X:
        assert 0.5 <= row[0] <= 2.5
        assert 3 <= row[1] <= 9 and float(row[1]).is_integer()
        assert row[2] in ("x", "y", "z")
    js = _sampling_space(jbo, 3)
    js.random_seed = 3
    assert rows(X) == rows(js.sample(20, method=method))


def test_lhs_stratification():
    X = np.asarray(tbo.RealSpace([0, 1], var_name="x").sample(10, method="LHS"), dtype=float).ravel()
    assert sorted(np.floor(X * 10).astype(int).tolist()) == list(range(10))


def test_sample_reproducible_with_seed():
    a = tbo.RealSpace([0, 1], var_name="x", random_seed=7).sample(5)
    b = tbo.RealSpace([0, 1], var_name="x", random_seed=7).sample(5)
    j = jbo.RealSpace([0, 1], var_name="x", random_seed=7).sample(5)
    assert np.array_equal(np.asarray(a, float), np.asarray(b, float))
    assert np.array_equal(np.asarray(a, float), np.asarray(j, float))


def test_no_global_rng_mutation():
    np.random.seed(123)
    before = np.random.rand()
    np.random.seed(123)
    tbo.RealSpace([0, 1], var_name="x", random_seed=99).sample(5)
    assert np.random.rand() == before


def _json_space(pkg):
    return (pkg.RealSpace([1e-5, 1e-1], var_name="lr", scale="log10", precision=8)
            + pkg.IntegerSpace([1, 64], var_name="width", step=1)
            + pkg.DiscreteSpace(["adam", "sgd"], var_name="opt")
            + pkg.OrdinalSpace(["low", "mid", "high"], var_name="lvl")
            + pkg.BoolSpace(var_name="flag"))


def test_json_roundtrip(tmp_path):
    """The JSON file equals the JAX package's, and reads back in both."""
    f, fj = tmp_path / "space.json", tmp_path / "space_jax.json"
    cs = _json_space(tbo)
    cs.to_json(str(f))
    _json_space(jbo).to_json(str(fj))
    assert json.loads(f.read_text()) == json.loads(fj.read_text())
    for back in (tbo.SearchSpace.from_json(str(f)), tbo.SearchSpace.from_json(str(fj))):
        assert back.var_name == cs.var_name
        assert back.var_type == cs.var_type
        assert back.bounds == cs.bounds


def test_subset_powerset():
    v = tbo.Subset(["a", "b", "c"], name="s")
    assert v.n_levels == 7  # 2^3 - 1 non-empty subsets
    assert list(v.bounds) == list(jbo.Subset(["a", "b", "c"], name="s").bounds)


def _conditional(pkg):
    return pkg.SearchSpace([
        pkg.Discrete(["svm", "rf"], name="algo"),
        pkg.Real([1e-3, 1e3], name="C", conditions="`algo` == 'rf'"),
        pkg.Integer([1, 100], name="n_trees", conditions="`algo` == 'svm'"),
    ])


def test_conditional_structure():
    subs = _conditional(tbo).get_unconditional_subspace()
    assert len(subs) == 2
    keys = sorted(tuple(sorted(k.items())) for k, _ in subs)
    assert all("algo" in dict(k) for k in keys)
    want = sorted((tuple(sorted(k.items())), s.var_name) for k, s in _conditional(jbo).get_unconditional_subspace())
    assert sorted((tuple(sorted(k.items())), s.var_name) for k, s in subs) == want


def test_contains_and_getitem():
    cs = tbo.RealSpace([[0, 1], [0, 2]], var_name=["a", "b"]) + tbo.IntegerSpace([0, 3], var_name="i")
    assert "a" in cs
    assert [0.5, 1.0, 2] in cs
    assert [0.5, 5.0, 2] not in cs
    assert cs[["a", "i"]].var_name == ["a", "i"]
    assert isinstance(cs["b"], tbo.Real)


def test_update_and_filter():
    cs = tbo.RealSpace([[0, 1], [0, 2]], var_name=["a", "b"])
    cs.update(tbo.RealSpace([5, 6], var_name="a") + tbo.IntegerSpace([0, 9], var_name="z"))
    assert cs.dim == 3
    assert cs["a"].bounds == (5, 6)
    assert cs.filter(["a", "b"]).var_name == ["a", "b"]
    assert cs.filter(["a"], invert=True).var_name == ["b", "z"]


def _xy(pkg):
    return pkg.RealSpace([[-5, 5]] * 2, var_name=["x", "y"], random_seed=0)


def test_constrained_sampling_scmc():
    g = lambda x: float(x[0]) + float(x[1])  # noqa: E731  (feasible: x + y <= 0)
    X = _xy(tbo).sample(8, g=g)
    assert len(X) > 0
    for row in X:
        assert float(row[0]) + float(row[1]) <= 1e-6
    assert rows(X) == rows(_xy(jbo).sample(8, g=g))


def test_constrained_sampling_equality():
    h = lambda x: float(x[0]) - float(x[1])  # noqa: E731
    X = _xy(tbo).sample(5, h=h, tol=1e-1)
    assert len(X) > 0
    for row in X:
        assert abs(float(row[0]) - float(row[1])) <= 1e-1
    assert rows(X) == rows(_xy(jbo).sample(5, h=h, tol=1e-1))


def g_vec(x):
    x = np.asarray(x, dtype=float)
    return x[:, 0] + x[:, 1] - 1.0 if x.ndim == 2 else x[0] + x[1] - 1.0


class ScalarOnly:
    def __call__(self, x):
        x = np.asarray(x, dtype=float)
        assert x.ndim == 1  # refuses batches
        return x[0] + x[1] - 1.0


@pytest.mark.parametrize("g, vector", [(g_vec, True), (ScalarOnly(), False)], ids=["vector", "scalar"])
def test_scmc_auto_vectorized_constraints(g, vector):
    """The "auto" probe takes the batch path for a broadcasting constraint
    and the per-point loop for a scalar-only one; the samples are the JAX
    package's."""
    s = TSCMC(tbo.RealSpace([[-2.0, 2.0]] * 2, random_seed=0), g=g, tol=1e-2)
    out = np.asarray(s.sample(32)[:, :2], dtype=float)
    assert s.vector_constraints is vector
    assert np.mean(out.sum(1) <= 1.0 + 1e-6) > 0.9
    j = JSCMC(jbo.RealSpace([[-2.0, 2.0]] * 2, random_seed=0), g=g, tol=1e-2)
    assert np.array_equal(out, np.asarray(j.sample(32)[:, :2], dtype=float))

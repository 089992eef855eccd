"""The port's SpaceEncoding host helpers (`embed_raw`, `n_free_real`)
against the JAX package's, on the CPU: the same raw points, drawn with
numpy, through both packages' encodings of the same space."""
import numpy as np
import pytest

import bayesian_optimization_tpu as bo_jax
import bayesian_optimization_tpu_torch as bo_torch


def _space(pkg, kind):
    """One space, built from `pkg`'s classes: mixed (real on a log scale,
    integer, nominal, bool, ordinal), reals only, or discrete only."""
    if kind == "mixed":
        return (pkg.RealSpace([1e-3, 1e3], var_name="lr", scale="log10")
                + pkg.IntegerSpace([0, 9], var_name="k")
                + pkg.DiscreteSpace(["a", "b", "c"], var_name="cat")
                + pkg.BoolSpace(var_name="flag")
                + pkg.OrdinalSpace(["s", "m", "l"], var_name="size"))
    if kind == "reals":
        return (pkg.RealSpace([-5, 5], var_name="x") * 2
                + pkg.RealSpace([1e-2, 1e2], var_name="s", scale="log10"))
    return (pkg.IntegerSpace([-3, 3], var_name="i") + pkg.DiscreteSpace(["u", "v"], var_name="d")
            + pkg.OrdinalSpace([1, 2, 4, 8], var_name="o"))


def _raw(kind, n, seed=0):
    """n raw points of the space, as an object array."""
    r = np.random.default_rng(seed)
    if kind == "mixed":
        cols = [10 ** r.uniform(-3, 3, n), r.integers(0, 10, n), r.choice(["a", "b", "c"], n),
                r.choice([False, True], n), r.choice(["s", "m", "l"], n)]
    elif kind == "reals":
        cols = [r.uniform(-5, 5, n), r.uniform(-5, 5, n), 10 ** r.uniform(-2, 2, n)]
    else:
        cols = [r.integers(-3, 4, n), r.choice(["u", "v"], n), r.choice([1, 2, 4, 8], n)]
    X = np.empty((n, len(cols)), dtype=object)
    for j, c in enumerate(cols):
        X[:, j] = [v.item() if hasattr(v, "item") else v for v in c]
    return X


@pytest.mark.parametrize("kind", ["mixed", "reals", "discrete"])
def test_embed_raw_matches_jax(kind):
    """The surrogate features of raw points, a batch and a single row, equal
    the JAX package's within 1e-12."""
    enc_j = _space(bo_jax, kind).encoding()
    enc_t = _space(bo_torch, kind).encoding()
    X = _raw(kind, 40)
    want = np.asarray(enc_j.embed_raw(X), np.float64)
    got = enc_t.embed_raw(X)
    assert got.shape == want.shape == (40, enc_j.d_embed)
    assert np.abs(got - want).max() <= 1e-12
    one = enc_t.embed_raw(X[3])
    assert one.shape == (1, enc_j.d_embed)
    assert np.abs(one - np.asarray(enc_j.embed_raw(X[3]), np.float64)).max() <= 1e-12


@pytest.mark.parametrize("kind, n_real", [("mixed", 1), ("reals", 3), ("discrete", 0)])
def test_n_free_real_matches_jax(kind, n_real):
    """The number of real variables, as the JAX package counts it."""
    enc_j = _space(bo_jax, kind).encoding()
    enc_t = _space(bo_torch, kind).encoding()
    assert enc_t.n_free_real == enc_j.n_free_real == n_real
    assert isinstance(enc_t.n_free_real, int)

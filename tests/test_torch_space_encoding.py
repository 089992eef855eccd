"""The port's SpaceEncoding (space/encoding.py) against the JAX package's,
on the CPU: the host helpers (`embed_raw`, `n_free_real`) on the same raw
points, drawn with numpy, through both packages' encodings of the same
space, and the cases of tests/test_encoding.py on the port (the layout, the
round trip through raw values, quantize, the one-hot embedding, the LHS
sampler, gradients in the real columns, and the numpy path against the
tensor path, each also against the JAX package's on the same unit points)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


# ------------------------------------------------ tests/test_encoding.py
def test_embed_layout():
    enc = _space(bo_torch, "mixed").encoding()
    # lr(1) + k(1) + cat(one-hot 3) + flag(1) + size(1)
    assert (enc.d_embed, enc.dim) == (7, 5)
    enc_j = _space(bo_jax, "mixed").encoding()
    assert enc.emb_offset.tolist() == np.asarray(enc_j.emb_offset).tolist()
    assert enc.emb_width.tolist() == np.asarray(enc_j.emb_width).tolist()


def test_unit_roundtrip_through_raw():
    cs = _space(bo_torch, "mixed")
    cs.random_seed = 0
    enc = cs.encoding()
    X = cs.sample(32)
    U = enc.encode_unit(X)
    X2 = enc.decode_unit(U)
    for a, b in zip(X.ravel(), X2.ravel()):
        if isinstance(a, float):
            assert np.isclose(a, float(b), rtol=1e-5)
        else:
            assert a == b
    enc_j = _space(bo_jax, "mixed").encoding()
    assert np.array_equal(U, np.asarray(enc_j.encode_unit(X)))
    assert X2.tolist() == enc_j.decode_unit(U).tolist()


def test_quantize_idempotent():
    enc = _space(bo_torch, "mixed").encoding()
    U = enc.sample_unit(torch.Generator().manual_seed(0), 16)
    Q = enc.quantize_unit(U)
    assert torch.allclose(Q, enc.quantize_unit(Q), atol=1e-6)
    a, b = enc.decode_unit(U.numpy()), enc.decode_unit(Q.numpy())
    for x, y in zip(a.ravel(), b.ravel()):
        if not isinstance(x, float):
            assert x == y
    enc_j = _space(bo_jax, "mixed").encoding()
    assert np.allclose(Q.numpy(), np.asarray(enc_j.quantize_unit(jnp.asarray(U.numpy()))), atol=1e-7)


def test_embed_is_onehot():
    enc = _space(bo_torch, "mixed").encoding()
    U = enc.sample_unit(torch.Generator().manual_seed(1), 8)
    E = enc.unit_to_embed(U)
    assert E.shape == (8, enc.d_embed)
    block = E[:, 2:5].numpy()  # the categorical block is exactly one-hot
    assert np.allclose(block.sum(axis=1), 1.0) and set(np.unique(block)) <= {0.0, 1.0}
    enc_j = _space(bo_jax, "mixed").encoding()
    assert np.array_equal(E.numpy(), np.asarray(enc_j.unit_to_embed(jnp.asarray(U.numpy()))))


def test_lhs_unit_sampler():
    enc = bo_torch.RealSpace([[0, 1]] * 3, var_name="x").encoding()
    U = enc.sample_unit(torch.Generator().manual_seed(2), 10, method="lhs").numpy()
    for j in range(3):
        assert sorted(np.floor(U[:, j] * 10).astype(int).tolist()) == list(range(10))


def test_real_gradients_flow():
    cs = bo_torch.RealSpace([[0, 1]] * 2, var_name="x") + bo_torch.IntegerSpace([0, 5], var_name="k")
    enc = cs.encoding()
    u = torch.full((1, 3), 0.4, requires_grad=True)
    (g,) = torch.autograd.grad((enc.unit_to_embed(u) ** 2).sum(), u)
    assert torch.isfinite(g).all() and abs(float(g[0, 0])) > 0  # real columns carry gradient
    assert float(g[0, 2]) == 0.0  # the integer's level is piecewise constant


def test_unit_to_embed_np_matches_tensor():
    """The host embedding of ask/tell equals the tensor one of the argmax,
    and the JAX package's host embedding."""
    enc = _space(bo_torch, "mixed").encoding()
    U = np.random.default_rng(7).uniform(0, 1, (37, enc.dim))
    E_np = enc.unit_to_embed_np(U)
    E_t = enc.unit_to_embed(torch.tensor(U, dtype=torch.float64)).numpy()
    assert E_np.shape == E_t.shape and np.allclose(E_np, E_t, atol=1e-6)
    assert np.array_equal(E_np, np.asarray(_space(bo_jax, "mixed").encoding().unit_to_embed_np(U)))


@pytest.mark.parametrize("d", [3, 20])
@pytest.mark.parametrize("transposed", [False, True])
def test_all_real_embed_is_the_column_stack_without_its_ops(d, transposed):
    """An all-real space's `unit_to_embed` is U as it stands: the values and
    the gradient of the column-by-column stack (the general path), through
    no level table and no copy where U is contiguous; a strided U comes back
    contiguous, as the hand-written Matern kernel takes it. `quantize_unit`
    only clamps. Both equal the JAX package's on the same unit points."""
    enc = bo_torch.RealSpace([[-5, 5]] * d, var_name="x").encoding()
    U0 = torch.rand(7, d, generator=torch.Generator().manual_seed(d))
    base = U0.T.contiguous().T if transposed else U0.clone()
    U = base.requires_grad_(True)
    enc._levels_t = enc._discrete_t = None  # the level tables must not be read
    E = enc.unit_to_embed(U)
    assert E.is_contiguous() and E.shape == (7, d)
    assert (E.data_ptr() == U.data_ptr()) is not transposed
    stack = torch.stack([U[..., j] for j in range(d)], dim=-1)
    assert torch.equal(E, stack)
    w = torch.linspace(-1.0, 2.0, 7 * d).reshape(7, d)
    (g_fast,) = torch.autograd.grad((torch.sin(E) * w).sum(), U)
    (g_stack,) = torch.autograd.grad((torch.sin(stack) * w).sum(), U)
    assert torch.equal(g_fast, g_stack)
    outside = U0 * 3.0 - 1.0
    assert torch.equal(enc.quantize_unit(outside), outside.clamp(0.0, 1.0))
    enc_j = bo_jax.RealSpace([[-5, 5]] * d, var_name="x").encoding()
    assert np.array_equal(E.detach().numpy(), np.asarray(enc_j.unit_to_embed(jnp.asarray(U0.numpy()))))

"""bayesian_optimization_tpu_torch/ops/linalg against the JAX package's
ops/linalg on the CPU: values, gradients, the hybrid factorisation and the
small buckets. Same numpy inputs to both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_optimization_tpu.ops import linalg as jl
from bayesian_optimization_tpu_torch.ops import linalg as tl

torch.set_num_threads(1)  # one thread per pytest worker: more oversubscribe the cores


def _spd(n, seed=0, cond="easy"):
    rng = np.random.default_rng(seed)
    if cond == "easy":
        X = rng.standard_normal((n, 16))
        return ((X @ X.T / 16 + np.eye(n) * n) / n).astype(np.float32)
    Z = rng.uniform(0, 1, (n, 4))
    D = ((Z[:, None, :] - Z[None, :, :]) ** 2).sum(-1)
    return (np.exp(-5.0 * D) + 1e-4 * np.eye(n)).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("n", [16, 64, 256])
def test_whiten_value_and_grad_match_jax(n):
    R = _spd(n, seed=4)
    B = np.random.default_rng(5).standard_normal((n, 2)).astype(np.float32)

    def f_jax(R_):
        d, W, _ = jl.whiten(R_, jnp.asarray(B))
        return jnp.sum(jnp.log(d)) + jnp.sum(W ** 2)

    v_j, g_j = jax.value_and_grad(f_jax)(jnp.asarray(R))
    Rt = torch.tensor(R, requires_grad=True)
    d, W, piv = tl.whiten(Rt, torch.tensor(B))
    v_t = torch.log(d).sum() + (W ** 2).sum()
    v_t.backward()
    assert float(piv) > 0.0
    assert abs(v_t.item() - float(v_j)) < 1e-4 * max(1.0, abs(float(v_j)))
    assert _rel(Rt.grad.numpy(), g_j) < 1e-3


def test_whiten_batched_lanes_are_independent():
    """Restart lanes share one batched call: each lane's value and gradient
    equal the unbatched ones."""
    Rs = np.stack([_spd(128, seed=s, cond="kernel") for s in range(3)])
    B = np.random.default_rng(0).standard_normal((128, 2)).astype(np.float32)
    Rt = torch.tensor(Rs, requires_grad=True)
    d, W, piv = tl.whiten(Rt, torch.tensor(B))
    (torch.log(d).sum() + (W ** 2).sum()).backward()
    for i in range(3):
        Ri = torch.tensor(Rs[i], requires_grad=True)
        di, Wi, pi = tl.whiten(Ri, torch.tensor(B))
        (torch.log(di).sum() + (Wi ** 2).sum()).backward()
        assert _rel(W[i].detach().numpy(), Wi.detach().numpy()) < 1e-6
        assert _rel(Rt.grad[i].numpy(), Ri.grad.numpy()) < 1e-5
        assert float(piv[i]) == float(pi)


def test_factor_hybrid_matches_jax_and_f64():
    """The hybrid factorisation at n=512 with 256-wide superpanels against
    the JAX _factor_hybrid in Pallas interpret mode and the f64 Cholesky,
    with the Dinv layout and the solve it carries."""
    import scipy.linalg as sla

    n, sb = 512, 256
    R = _spd(n, seed=3, cond="kernel")
    B = np.random.default_rng(0).standard_normal((n, 3)).astype(np.float32)
    L64 = np.linalg.cholesky(R.astype(np.float64))
    Lj, Dj, pj = jl._factor_hybrid(jnp.asarray(R), super_block=sb, interpret=True)
    L, Dinv, piv, W = tl._factor_hybrid(torch.tensor(R)[None], torch.tensor(B)[None], super_block=sb)
    L, Dinv, piv, W = L[0].numpy(), Dinv[0].numpy(), float(piv[0]), W[0].numpy()
    assert _rel(L, L64) < 1e-3
    assert _rel(L, np.asarray(Lj)) < 1e-3
    assert piv > 0.0 and float(pj) > 0.0
    assert Dinv.shape == tuple(Dj.shape) == (n // 128, 128, 128)
    for k in range(n // 128):
        blk = L[k * 128:(k + 1) * 128, k * 128:(k + 1) * 128]
        assert np.abs(Dinv[k] @ blk - np.eye(128)).max() < 1e-3
    # the carried solve is consistent with the factor (as test_linalg.py checks)
    W_ref = sla.solve_triangular(L.astype(np.float64), B.astype(np.float64), lower=True)
    assert np.abs(W - W_ref).max() < 1e-3 * max(1.0, np.abs(W_ref).max())


@pytest.mark.parametrize("n", [16, 64, 256])
def test_chol_inv_whiten_matches_jax(n):
    R = _spd(n, seed=n, cond="kernel" if n >= 128 else "easy")
    B = np.random.default_rng(1).standard_normal((n, 2)).astype(np.float32)
    L, Li, W, piv = (t.numpy() for t in tl.chol_inv_whiten(torch.tensor(R), torch.tensor(B)))
    Lj, Lij, Wj, pivj = (np.asarray(t) for t in jl.chol_inv_whiten(jnp.asarray(R), jnp.asarray(B)))
    L64 = np.linalg.cholesky(R.astype(np.float64))
    assert _rel(L, Lj) < 1e-3 and _rel(L, L64) < 1e-3
    assert np.abs(Li.astype(np.float64) @ L64 - np.eye(n)).max() < 1e-2
    assert _rel(W, Wj) < 1e-3
    assert float(piv) > 0.0 and float(pivj) > 0.0


def test_whiten_flags_indefinite_like_jax():
    n = 128
    R = _spd(n, seed=7).astype(np.float64)
    R[0, 0] = -1.0
    R = R.astype(np.float32)
    _, _, piv = tl.whiten(torch.tensor(R), torch.ones(n, 1))
    _, _, pivj = jl.whiten(jnp.asarray(R), jnp.ones((n, 1), jnp.float32))
    assert float(piv) <= 0.0 and float(pivj) <= 0.0

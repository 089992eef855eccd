"""The port's kernel twins (bayesian_optimization_tpu_torch/ops/hopper_kernels)
against the JAX package's Pallas kernels, on the CPU.

The Pallas kernels run in interpret mode, as tests/test_pallas.py runs
them; the same numpy inputs go to both packages. The CUDA kernels
themselves are held against these twins on the card by
tests/test_torch_cuda_kernels.py and chip_smoke.py.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_optimization_tpu.models.kernels import matern, squared_exponential
from bayesian_optimization_tpu.ops.pallas_kernels import matern_pallas, whiten_fused as whiten_pallas
from bayesian_optimization_tpu_torch.ops.hopper_kernels import (
    matern_fused, matern_plain, reset_launch_counts, whiten_fused, whiten_plain,
)

torch.set_num_threads(1)  # one thread per pytest worker: more oversubscribe the cores

rng = np.random.default_rng(0)
X_NP = rng.uniform(0, 1, (128, 5)).astype(np.float32)
Y_NP = rng.uniform(0, 1, (256, 5)).astype(np.float32)
THETA_NP = np.asarray([0.5, 1.0, 2.0, 0.1, 3.0], np.float32)

NUS = [0.5, 1.5, 2.5, math.inf]  # inf: the RBF map (matern_pallas takes any other nu)


def _jax_kernel(nu):
    if math.isinf(nu):
        return squared_exponential
    return lambda th, X, Y=None: matern(th, X, Y, nu=nu)


@pytest.mark.parametrize("nu", NUS)
@pytest.mark.parametrize("sym", [True, False])
def test_matern_plain_matches_pallas_and_xla(nu, sym):
    Y = None if sym else Y_NP
    K_t = matern_plain(torch.tensor(THETA_NP), torch.tensor(X_NP),
                       None if sym else torch.tensor(Y_NP), nu=nu).numpy()
    jY = None if sym else jnp.asarray(Y)
    K_p = np.asarray(matern_pallas(jnp.asarray(THETA_NP), jnp.asarray(X_NP), jY,
                                   nu=-1.0 if math.isinf(nu) else nu, interpret=True))
    K_x = np.asarray(_jax_kernel(nu)(jnp.asarray(THETA_NP), jnp.asarray(X_NP), jY))
    assert np.abs(K_t - K_p).max() < 5e-6
    assert np.abs(K_t - K_x).max() < 5e-6
    if sym:
        assert np.abs(np.diagonal(K_t) - 1.0).max() == 0.0


@pytest.mark.parametrize("nu", NUS)
@pytest.mark.parametrize("fn", [matern_plain, matern_fused], ids=["plain", "fused"])
def test_matern_gradients_match_jax(nu, fn):
    """theta-gradient of the training matrix (likelihood) and query-point
    gradient of the cross matrix (argmax): the twin's autograd and the
    wrapper's hand-written backward, both against jax.grad."""
    G_sym = np.random.default_rng(1).standard_normal((128, 128)).astype(np.float32)
    G_x = np.random.default_rng(2).standard_normal((128, 256)).astype(np.float32)
    kern = _jax_kernel(nu)

    def jf(th, Xq):
        return (jnp.sum(kern(th, jnp.asarray(X_NP)) * G_sym)
                + jnp.sum(kern(th, Xq, jnp.asarray(Y_NP)) * G_x))

    g_th_j, g_x_j = jax.grad(jf, argnums=(0, 1))(jnp.asarray(THETA_NP), jnp.asarray(X_NP))

    th = torch.tensor(THETA_NP, requires_grad=True)
    Xq = torch.tensor(X_NP, requires_grad=True)
    out = ((fn(th, torch.tensor(X_NP), nu=nu) * torch.tensor(G_sym)).sum()
           + (fn(th, Xq, torch.tensor(Y_NP), nu=nu) * torch.tensor(G_x)).sum())
    out.backward()
    for got, want in ((th.grad, g_th_j), (Xq.grad, g_x_j)):
        want = np.asarray(want, np.float64)
        rel = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert rel < 1e-4, rel


def _kernel_like(n, seed, jitter=1e-2):
    r = np.random.default_rng(seed)
    Z = r.uniform(0, 1, (n, 4))
    D2 = ((Z[:, None, :] - Z[None, :, :]) ** 2).sum(-1)
    return (np.exp(-5 * D2) + jitter * np.eye(n)).astype(np.float32)


def test_whiten_plain_matches_pallas_and_f64():
    from scipy.linalg import solve_triangular

    n, m = 256, 3
    R = _kernel_like(n, 0)
    B = np.random.default_rng(0).standard_normal((n, m)).astype(np.float32)
    d, W, piv, L, Dinv = (t.numpy() for t in whiten_plain(torch.tensor(R), torch.tensor(B)))
    dj, Wj, pivj, Lj, Dinvj = (np.asarray(t) for t in whiten_pallas(
        jnp.asarray(R), jnp.asarray(B), interpret=True))
    L64 = np.linalg.cholesky(R.astype(np.float64))
    Wt = solve_triangular(L64, B.astype(np.float64), lower=True)
    for Lx, dx, Wx in ((L, d, W), (Lj, dj, Wj)):
        assert np.abs(Lx.astype(np.float64) - L64).max() < 1e-4
        assert np.abs(dx - np.diag(L64)).max() < 1e-4
        assert np.abs(Wx.astype(np.float64) - Wt).max() < 1e-3 * max(1.0, np.abs(Wt).max())
    assert Dinv.shape == Dinvj.shape == (2, 128, 128)
    for k in range(n // 128):
        blk = L[k * 128:(k + 1) * 128, k * 128:(k + 1) * 128]
        assert np.abs(Dinv[k] @ blk - np.eye(128)).max() < 1e-3
    assert piv > 0.0 and abs(piv - pivj) < 1e-3 * abs(pivj)


def test_whiten_plain_flags_indefinite_and_keeps_r():
    n = 128
    A = np.random.default_rng(1).standard_normal((n, 16)).astype(np.float32)
    R = A @ A.T / 16 + np.eye(n, dtype=np.float32)
    R[0, 0] = -1.0
    Rt = torch.tensor(R)
    _, _, piv, _, _ = whiten_plain(Rt, torch.ones(n, 1))
    _, _, pivj, _, _ = whiten_pallas(jnp.asarray(R), jnp.ones((n, 1), jnp.float32), interpret=True)
    assert not (float(piv) > 0.0)
    assert not (float(pivj) > 0.0)
    assert np.array_equal(Rt.numpy(), R)


def test_cpu_tensors_never_launch():
    reset_launch_counts()
    X = torch.tensor(X_NP)
    matern_fused(torch.tensor(THETA_NP), X)
    whiten_fused(torch.tensor(_kernel_like(64, 2)), torch.ones(64, 1))
    assert matern_fused.launches == 0
    assert whiten_fused.launches == 0

"""The port's CUDA kernels against their plain twins, on the card.

Every test here needs an NVIDIA GPU and skips without one. They import no
JAX, so they run on a machine that has only PyTorch:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda_kernels.py -q
"""
import math

import numpy as np
import pytest
import torch

from bayesian_optimization_tpu_torch.ops.hopper_kernels import (
    matern_fused, matern_plain, whiten_fused, whiten_plain,
)

pytestmark = pytest.mark.cuda

NUS = [0.5, 1.5, 2.5, math.inf]  # inf selects the RBF map


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _kernel_like(n, batch, seed, jitter=1e-2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(batch):
        Z = rng.uniform(0, 1, (n, 4))
        D2 = ((Z[:, None, :] - Z[None, :, :]) ** 2).sum(-1)
        out.append(np.exp(-5 * D2) + jitter * np.eye(n))
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("nu", NUS)
@pytest.mark.parametrize("shape", [(1024, None), (25, 1024), (37, 53)])
def test_matern_kernel_matches_twin(dev, nu, shape):
    rng = np.random.default_rng(0)
    N, M = shape
    X = torch.tensor(rng.uniform(0, 1, (N, 5)), dtype=torch.float32, device=dev)
    Y = None if M is None else torch.tensor(rng.uniform(0, 1, (M, 5)), dtype=torch.float32, device=dev)
    theta = torch.tensor(10 ** rng.uniform(-1, 1, (10, 5)), dtype=torch.float32, device=dev)
    before = matern_fused.launches
    K = matern_fused(theta, X, Y, nu=nu)
    torch.cuda.synchronize()
    assert matern_fused.launches == before + 1
    K_ref = matern_plain(theta, X, Y, nu=nu)
    assert float((K - K_ref).abs().max()) < 5e-6
    if M is None:
        assert float((K.diagonal(dim1=-2, dim2=-1) - 1.0).abs().max()) == 0.0


@pytest.mark.parametrize("nu", NUS)
def test_matern_kernel_gradients_match_twin(dev, nu):
    rng = np.random.default_rng(1)
    X = torch.tensor(rng.uniform(0, 1, (300, 5)), dtype=torch.float32, device=dev)
    Xq0 = rng.uniform(0, 1, (40, 5))
    G = torch.tensor(rng.standard_normal((3, 40, 300)), dtype=torch.float32, device=dev)
    th0 = 10 ** rng.uniform(-1, 1, (3, 5))
    grads = []
    for fn in (matern_fused, matern_plain):
        th = torch.tensor(th0, dtype=torch.float32, device=dev, requires_grad=True)
        Xq = torch.tensor(Xq0, dtype=torch.float32, device=dev, requires_grad=True)
        (fn(th, Xq, X, nu=nu) * G).sum().backward()
        grads.append((th.grad, Xq.grad))
    for a, b in zip(*grads):
        assert float((a - b).abs().max() / b.abs().max()) < 1e-4


@pytest.mark.parametrize("n", [16, 64, 256, 1024])
def test_whiten_kernel_matches_twin(dev, n):
    R = torch.tensor(_kernel_like(n, 3, seed=n), device=dev)
    B = torch.tensor(np.random.default_rng(n).standard_normal((3, n, 3)), dtype=torch.float32, device=dev)
    R_before = R.clone()
    before = whiten_fused.launches
    d, W, piv, L, Dinv = whiten_fused(R, B)
    torch.cuda.synchronize()
    assert whiten_fused.launches == before + 1
    assert torch.equal(R, R_before)
    d0, W0, piv0, L0, Dinv0 = whiten_plain(R, B)
    assert Dinv.shape == Dinv0.shape == (3, max(1, n // 128), min(n, 128), min(n, 128))
    assert float((L - L0).abs().max() / L0.abs().max()) < 1e-4
    assert float((d - d0).abs().max()) < 1e-4
    assert float((W - W0).abs().max()) < 1e-3 * max(1.0, float(W0.abs().max()))
    assert bool(torch.all(piv > 0)) and float(((piv - piv0) / piv0).abs().max()) < 1e-2
    T = min(n, 128)
    for k in range(n // T):
        blk = L[:, k * T:(k + 1) * T, k * T:(k + 1) * T]
        eye = torch.eye(T, device=dev)
        assert float((Dinv[:, k] @ blk - eye).abs().max()) < 1e-3
    assert float(torch.triu(L, 1).abs().max()) == 0.0


def test_whiten_kernel_flags_indefinite(dev):
    R = _kernel_like(256, 2, seed=3)
    R[1, 0, 0] = -1.0
    R = torch.tensor(R, device=dev)
    _, W, piv, L, _ = whiten_fused(R, torch.ones(2, 256, 1, device=dev))
    torch.cuda.synchronize()
    assert float(piv[0]) > 0.0
    assert not (float(piv[1]) > 0.0)
    # the failed lane does not disturb its neighbour in the batch
    L0 = torch.linalg.cholesky(R[0])
    assert float((L[0] - L0).abs().max()) < 1e-4


def test_kernels_refuse_what_they_do_not_take(dev):
    X = torch.rand(64, 5, device=dev)
    with pytest.raises(NotImplementedError):
        matern_fused(torch.ones(5, device=dev, dtype=torch.float64), X.double())
    with pytest.raises(ValueError):
        matern_fused(torch.ones(5, device=dev), X.t().contiguous().t())
    R = torch.eye(200, device=dev)
    with pytest.raises(ValueError):
        whiten_fused(R, torch.ones(200, 1, device=dev))
    with pytest.raises(NotImplementedError):
        whiten_fused(R[:128, :128].double(), torch.ones(128, 1, device=dev, dtype=torch.float64))


def test_float64_gp_option_raises_on_the_card(dev):
    from bayesian_optimization_tpu_torch.models import GaussianProcess

    with pytest.raises(NotImplementedError):
        GaussianProcess(thetaL=[1e-3], thetaU=[1e3], device=dev, dtype="f64")

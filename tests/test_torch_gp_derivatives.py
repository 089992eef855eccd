"""The port's GaussianProcess.gradient / Hessian and ops/linalg.chol_and_inv
against the JAX package's on the CPU: gradient and Hessian of the posterior
mean and MSE on one fitted posterior carried across, in float64; their
shape errors; chol_and_inv's values and VJP in float64 and float32."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_optimization_tpu.models import GaussianProcess as JGP
from bayesian_optimization_tpu.models import constant_trend as j_const
from bayesian_optimization_tpu.ops.linalg import chol_and_inv as j_chol_and_inv
from bayesian_optimization_tpu_torch.models import GaussianProcess as TGP
from bayesian_optimization_tpu_torch.ops import hopper_kernels
from bayesian_optimization_tpu_torch.ops.linalg import chol_and_inv as t_chol_and_inv

torch.set_num_threads(1)  # one thread per pytest worker: more oversubscribe the cores

DIM = 3


@pytest.fixture(scope="module", params=["matern", "squared_exponential", ("matern", 3.5),
                                        "absolute_exponential"], ids=str)
def fitted(request):
    """A float64 JAX fit (n=40, d=3) and the port's float64 GP loaded with
    its posterior."""
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 1, (40, DIM))
    y = np.sin(3 * X).sum(1) + 0.05 * rng.standard_normal(40)
    kw = dict(corr=request.param, thetaL=1e-2 * np.ones(DIM), thetaU=1e2 * np.ones(DIM),
              nugget=1e-6, random_start=4, random_state=0, dtype="f64")
    jgp = JGP(mean=j_const(DIM), **kw).fit(X, y)
    tgp = TGP(device="cpu", **kw)
    tgp.load_fitted(jgp.theta_, {k: np.asarray(v) for k, v in jgp.posterior._asdict().items()},
                    jgp.config._asdict())
    return jgp, tgp


POINTS = np.random.default_rng(1).uniform(0.05, 0.95, (3, DIM))


def test_gradient_matches_jax(fitted):
    jgp, tgp = fitted
    for x in POINTS:
        for gj, gt in zip(jgp.gradient(x), tgp.gradient(x)):
            assert gt.shape == (DIM, 1)
            np.testing.assert_allclose(gt, gj, rtol=1e-8, atol=1e-8 * np.abs(gj).max())


@pytest.mark.parametrize("of", ["mean", "mse"])
def test_hessian_matches_jax(fitted, of):
    jgp, tgp = fitted
    for x in POINTS:
        Hj, Ht = jgp.Hessian(x, of=of), tgp.Hessian(x, of=of)
        assert Ht.shape == (DIM, DIM)
        np.testing.assert_allclose(Ht, Hj, rtol=1e-8, atol=1e-8 * np.abs(Hj).max())
    Hj = jgp.Hessian(POINTS[0], of=of)  # a (1, dim) row is one point too
    np.testing.assert_allclose(tgp.Hessian(POINTS[:1], of=of), Hj, rtol=1e-8,
                               atol=1e-8 * np.abs(Hj).max())


def test_hessian_float32_runs_through_the_twin(monkeypatch):
    """A float32 Matern GP on the CPU: its Hessian's second derivative goes
    through matern_bwd2_plain, the twin of the second-derivative kernel
    that the card launches, the same numbers as float64 within float32's
    error, and symmetric."""
    calls = []
    twin = hopper_kernels.matern_bwd2_plain
    monkeypatch.setattr(hopper_kernels, "matern_bwd2_plain",
                        lambda *a: calls.append(a[0].dtype) or twin(*a))
    rng = np.random.default_rng(2)
    X = rng.uniform(0, 1, (30, DIM))
    y = np.sin(3 * X).sum(1)
    kw = dict(thetaL=1e-2 * np.ones(DIM), thetaU=1e2 * np.ones(DIM), random_start=3,
              random_state=0, device="cpu")
    g32 = TGP(**kw).fit(X, y)
    g64 = TGP(dtype="f64", **kw)
    g64.load_fitted(g32.theta_, {k: v.double().numpy() for k, v in g32.posterior._asdict().items()},
                    g32.config._asdict())
    x = POINTS[0]
    H32, H64 = g32.Hessian(x), g64.Hessian(x)
    assert calls.count(torch.float32) == DIM and calls.count(torch.float64) == DIM
    assert np.abs(H32 - H64).max() <= 1e-3 * np.abs(H64).max()
    assert np.allclose(H32, H32.T, atol=1e-5 * np.abs(H32).max())


def test_shape_errors(fitted):
    _, tgp = fitted
    with pytest.raises(ValueError, match="of must be"):
        tgp.Hessian(POINTS[0], of="var")
    with pytest.raises(ValueError, match="single point"):
        tgp.Hessian(POINTS[:2])
    with pytest.raises(ValueError, match="right size"):
        tgp.Hessian(np.zeros(DIM + 1))


def _spd(n, seed=0, cond="easy"):
    """tests/test_linalg.py's SPD matrices."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 16))
    if cond == "easy":
        return (X @ X.T / 16 + np.eye(n) * n) / n
    Z = rng.uniform(0, 1, (n, 4))
    D = ((Z[:, None, :] - Z[None, :, :]) ** 2).sum(-1)
    return np.exp(-5.0 * D) + 1e-4 * np.eye(n)


@pytest.mark.parametrize("n", [16, 128, 256])
def test_chol_and_inv_matches_jax_float64(n):
    """Values and the VJP (cotangents on L and on L^-1) at 1e-10."""
    R = _spd(n, seed=n, cond="kernel")
    rng = np.random.default_rng(5)
    Lb, Lib = rng.standard_normal((n, n)), rng.standard_normal((n, n))
    with jax.enable_x64():
        (Lj, Lij, pj), vjp = jax.vjp(j_chol_and_inv, jnp.asarray(R))
        (Rbj,) = vjp((jnp.asarray(Lb), jnp.asarray(Lib), jnp.zeros(())))
    Rt = torch.tensor(R, requires_grad=True)
    Lt, Lit, pt = t_chol_and_inv(Rt)
    (Rbt,) = torch.autograd.grad([Lt, Lit], Rt, [torch.tensor(Lb), torch.tensor(Lib)])
    for got, want in ((Lt, Lj), (Lit, Lij), (Rbt, Rbj)):
        want = np.asarray(want)
        assert np.abs(got.detach().numpy() - want).max() <= 1e-10 * np.abs(want).max()
    assert float(pt) == pytest.approx(float(pj), rel=1e-10)


@pytest.mark.parametrize("n", [16, 128, 256])
def test_chol_and_inv_float32(n):
    """float32, as tests/test_linalg.py holds the JAX function: L within
    1e-5 of float64 numpy, L^-1 L within 1e-4 of I; the batched call
    agrees with the unbatched one; the CPU launches no kernel."""
    R = _spd(n).astype(np.float32)
    L_ref = np.linalg.cholesky(R.astype(np.float64))
    hopper_kernels.reset_launch_counts()
    L, Li, piv = t_chol_and_inv(torch.tensor(R))
    assert hopper_kernels.whiten_fused.launches == 0
    assert np.abs(L.numpy().astype(np.float64) - L_ref).max() / np.abs(L_ref).max() < 1e-5
    assert np.abs(Li.numpy().astype(np.float64) @ L_ref - np.eye(n)).max() < 1e-4
    assert float(piv) > 0.0
    Lb, Lib, pb = t_chol_and_inv(torch.tensor(np.stack([R, R])))
    assert torch.equal(Lb[1], L) and torch.equal(Lib[0], Li) and pb.shape == (2,)

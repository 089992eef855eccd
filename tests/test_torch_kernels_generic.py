"""Every covariance of the port's `_KERNELS` (models/kernels.py) against the
JAX package's on the CPU: each name and both tuple families in float64 with
batched theta, Y=None and Y given; the generic-nu Bessel path and its theta
gradient; and the likelihood of an absolute-exponential and a nu=7/2 GP at
fixed theta."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_optimization_tpu.models import kernels as jker
from bayesian_optimization_tpu.models import likelihood as jlik
from bayesian_optimization_tpu_torch.models import kernels as tker
from bayesian_optimization_tpu_torch.models import likelihood as tlik
from bayesian_optimization_tpu_torch.ops import hopper_kernels

torch.set_num_threads(1)  # one thread per pytest worker: more oversubscribe the cores

NAMES = sorted(jker._KERNELS) + [("matern", 3.5), ("matern", 4.5), ("matern", 0.5),
                                 ("generalized_exponential", 1.2)]


def _inputs(seed=0, B=3, N=7, M=5, D=3):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.2, 3.0, (B, D)), rng.uniform(0, 1, (N, D)), rng.uniform(0, 1, (M, D)))


@pytest.mark.parametrize("with_y", [False, True])
@pytest.mark.parametrize("name", NAMES, ids=str)
def test_kernel_matches_jax_float64(name, with_y):
    """Batched theta (B, D) -> (B, N, M), each lane the JAX kernel at its
    theta row, and one theta vector -> (N, M); float64, 1e-10."""
    theta, X, Y = _inputs()
    Yj = Y if with_y else None
    with jax.enable_x64():
        fj = jker.kernel_fn(name)
        want = np.stack([np.asarray(fj(jnp.asarray(t), jnp.asarray(X),
                                       None if Yj is None else jnp.asarray(Yj))) for t in theta])
    ft = tker.kernel_fn(name)
    Yt = None if Yj is None else torch.tensor(Yj)
    got = ft(torch.tensor(theta), torch.tensor(X), Yt).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)
    one = ft(torch.tensor(theta[1]), torch.tensor(X), Yt).numpy()
    np.testing.assert_allclose(one, want[1], rtol=1e-10, atol=1e-10)
    if not with_y:
        assert np.all(np.diagonal(got, axis1=-2, axis2=-1) == 1.0)


def test_float64_special_nu_launches_nothing():
    """float64 takes matern_fused's twins, chosen by dtype: the launch
    counters do not move (on the CPU they never do; on the card a float64
    tensor handed to the wrapper raises, tests/test_torch_cuda_kernels.py)."""
    hopper_kernels.reset_launch_counts()
    theta, X, _ = _inputs()
    tker.matern(torch.tensor(theta), torch.tensor(X), nu=2.5)
    tker.squared_exponential(torch.tensor(theta), torch.tensor(X))
    assert hopper_kernels.matern_fused.launches == 0


@pytest.mark.parametrize("nu", [0.7, 2.2])
def test_generic_nu_matches_jax(nu):
    """The host Bessel path in float32 against the JAX package's callback, at
    tests/test_kernels_generic.py's 2e-4/2e-5, and its theta gradient
    against jax.grad."""
    rng = np.random.default_rng(1)
    X = rng.uniform(0, 1, (10, 2)).astype(np.float32)
    theta = np.array([1.5, 0.7], np.float32)
    W = np.arange(100.0, dtype=np.float32).reshape(10, 10) / 100.0
    want = np.asarray(jker.matern(jnp.asarray(theta), jnp.asarray(X), nu=nu))
    gj = np.asarray(jax.grad(lambda t: jnp.sum(jker.matern(t, jnp.asarray(X), nu=nu) * W))(
        jnp.asarray(theta)))
    tt = torch.tensor(theta, requires_grad=True)
    K = tker.matern(tt, torch.tensor(X), nu=nu)
    (gt,) = torch.autograd.grad((K * torch.tensor(W)).sum(), tt)
    np.testing.assert_allclose(K.detach().numpy(), want, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(gt.numpy(), gj, rtol=2e-4, atol=2e-5)
    assert np.allclose(np.diag(K.detach().numpy()), 1.0)


def test_generic_nu_second_derivative_raises():
    """The Bessel path is once differentiable, as the JAX package's
    callback: a backward that would build a second derivative raises
    instead of dropping the Bessel term."""
    X = torch.tensor(np.random.default_rng(2).uniform(0, 1, (4, 2)))
    x = torch.tensor([0.3, 0.4], dtype=torch.float64, requires_grad=True)
    k = tker.matern(torch.ones(2, dtype=torch.float64), x[None], X, nu=1.7).sum()
    (g,) = torch.autograd.grad(k, x, retain_graph=True)  # the first derivative runs
    assert torch.isfinite(g).all()
    with pytest.raises(RuntimeError, match="no second derivative"):
        torch.autograd.grad(k, x, create_graph=True)


def test_kernel_fn_names():
    assert isinstance(tker.kernel_fn(("generalized_exponential", 1.2)), type(tker.kernel_fn("matern")))
    with pytest.raises(ValueError):
        tker.kernel_fn(("nope", 1.0))
    with pytest.raises(ValueError):
        tker.kernel_fn("nope")
    with pytest.raises(ValueError):
        tker.matern(torch.ones(2), torch.zeros(3, 2), nu=-1.0)


@pytest.mark.parametrize("kernel", ["absolute_exponential", ("matern", 3.5)], ids=str)
@pytest.mark.parametrize("mode", ["noisy", "noiseless"])
def test_likelihood_matches_jax_float64(kernel, mode):
    """The concentrated likelihood and its gradient at fixed log10 theta of
    an absolute-exponential and a nu=7/2 GP, three restart lanes, float64,
    1e-10 relative."""
    rng = np.random.default_rng(3)
    n, n_pad, D = 50, 64, 3
    X = np.zeros((n_pad, D))
    X[:n] = rng.uniform(0, 1, (n, D))
    Y = np.zeros((n_pad, 1))
    Y[:n, 0] = np.sin(3 * X[:n]).sum(1) + 0.1 * rng.standard_normal(n)
    mask = np.zeros(n_pad)
    mask[:n] = 1.0
    pars = rng.uniform(-0.5, 0.8, (3, D + (mode != "noiseless")))
    nv = 1e-6 if mode == "noisy" else 0.0
    with jax.enable_x64():
        cfg = jlik.GPConfig(kernel=kernel, mode=mode)

        def jnll(p):
            return jlik.neg_log_likelihood(
                p, jnp.asarray(X), jnp.asarray(Y), jnp.asarray(mask[:, None]), jnp.asarray(mask),
                jnp.asarray(float(n)), jnp.asarray(nv), jnp.zeros((1, 1)), cfg)

        vj = np.asarray(jax.vmap(jnll)(jnp.asarray(pars)))
        gj = np.asarray(jax.vmap(jax.grad(jnll))(jnp.asarray(pars)))
    p = torch.tensor(pars, requires_grad=True)
    vt = tlik.neg_log_likelihood(p, torch.tensor(X), torch.tensor(Y), torch.tensor(mask[:, None]),
                                 torch.tensor(mask), n, nv, torch.zeros(1, 1, dtype=torch.float64),
                                 tlik.GPConfig(kernel=kernel, mode=mode))
    (gt,) = torch.autograd.grad(vt.sum(), p)
    assert np.all(np.abs(vj) < 1e11)  # no lane in the penalty
    np.testing.assert_allclose(vt.detach().numpy(), vj, rtol=1e-10)
    assert np.abs(gt.numpy() - gj).max() <= 1e-10 * np.abs(gj).max()

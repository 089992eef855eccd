"""The port's SMC-resampled CMA chains against the JAX package on the CPU:
systematic resampling and chain resampling given the JAX package's uniform
offset give identical indices, the engine finds the optimum of
tests/test_smc.py's multimodal function, and BO and ParallelBO run on it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesian_optimization_tpu_torch as tbo
from bayesian_optimization_tpu.optim import cma as jcma
from bayesian_optimization_tpu.optim import smc as jsmc
from bayesian_optimization_tpu_torch.models.convert import cma_state_from_numpy
from bayesian_optimization_tpu_torch.optim import smc as tsmc

torch.set_num_threads(1)  # one thread per pytest worker: more oversubscribe the cores

_j_resample = jax.jit(jsmc.systematic_resample)


def _u0(key, P):
    """The uniform offset JAX's systematic_resample draws from `key`."""
    return np.float32(jax.random.uniform(key, (), jnp.float32)) / np.float32(P)


@pytest.mark.parametrize("P", [16, 64])
def test_systematic_resample_given_jax_offset(P):
    rng = np.random.default_rng(P)
    for s in range(5):
        log_w = (rng.normal(0, 3, P) * (s + 1)).astype(np.float32)
        key = jax.random.PRNGKey(s)
        want = np.asarray(_j_resample(key, jnp.asarray(log_w)))
        got = tsmc.systematic_resample(None, torch.tensor(log_w), u0=torch.tensor(_u0(key, P)))
        assert np.array_equal(got.numpy(), want), (P, s)


def _chains(f):
    P, d = len(f), 3
    x = np.zeros((P, d), np.float32)
    x[:, 0] = np.arange(P)  # the chain's own index: shows where a row came from
    fields = dict(x=x, f=np.asarray(f, np.float32), sigma=np.linspace(0.1, 0.4, P),
                  A=np.broadcast_to(np.eye(d), (P, d, d)) * np.arange(1, P + 1)[:, None, None],
                  A_inv=np.broadcast_to(np.eye(d), (P, d, d)), pc=np.ones((P, d)) * np.arange(P)[:, None],
                  success_rate=np.linspace(0.0, 1.0, P))
    fields = {k: np.asarray(v, np.float32) for k, v in fields.items()}
    js = jcma.CMAState(**{k: jnp.asarray(v) for k, v in fields.items()}, key=jax.random.PRNGKey(0))
    return js, cma_state_from_numpy(fields, torch.Generator(), "cpu")


@pytest.mark.parametrize("rho", [2.0, 50.0])
def test_resample_chains_with_ties_and_inf(rho):
    """Non-finite f maps to +inf and ties; the stable double argsort must
    rank the ties as jnp.argsort does, or other chains are copied."""
    f = [3.0, 1.0, np.inf, 1.0, np.nan, 0.5, 1.0, -np.inf, 3.0, 2.0, np.inf, 0.5, 7.0, 1.0, 2.0, 9.0]
    js, ts = _chains(f)
    key = jax.random.PRNGKey(7)
    want = jax.jit(jsmc.resample_chains)(key, js, jnp.asarray(rho, jnp.float32))
    got = tsmc.resample_chains(None, ts, rho, u0=torch.tensor(_u0(key, len(f))))
    for name in jcma.CMAState._fields[:-1]:
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert np.array_equal(g, w, equal_nan=True), name


def test_resample_chains_stays_within_each_group():
    _, ts = _chains(np.r_[np.arange(8.0), np.arange(8.0)[::-1]])
    got = tsmc.resample_chains(torch.Generator().manual_seed(0), ts, 50.0, groups=2)
    src = got.x[:, 0].long()
    assert bool((src[:8] < 8).all()) and bool((src[8:] >= 8).all())
    # near-greedy rho: most slots copy the best chain of their group (0 and 15)
    assert int((src[:8] == 0).sum()) >= 6 and int((src[8:] == 15).sum()) >= 6


def _multimodal(U):
    z = (U - 0.3) * 8.0
    return (z**2 - 2.0 * torch.cos(3 * z)).sum(-1)


@pytest.mark.parametrize("groups", [1, 2])
def test_run_smc_finds_global_optimum_multimodal(groups):
    """tests/test_smc.py's bar, for one population and for two of 64 chains
    each (how a q = 2 batch runs)."""
    d = 4
    x0 = torch.rand((64 * groups, d), generator=torch.Generator().manual_seed(0))
    xb, fb, X, F = tsmc.run_smc(torch.Generator().manual_seed(1), _multimodal, x0, torch.zeros(d),
                                torch.ones(d), n_rounds=6, n_moves=12, groups=groups)
    # global minimum is -2d = -8 at U = 0.3 exactly
    assert float(fb.max()) < -7.9, fb
    assert np.allclose(xb.numpy(), 0.3, atol=0.02)
    assert X.shape == (64 * groups, d) and F.shape == (64 * groups,)
    assert xb.shape == ((d,) if groups == 1 else (groups, d))


def _sphere_gp():
    return tbo.GaussianProcess(mean=tbo.constant_trend(2), corr="matern", thetaL=1e-3 * np.ones(2),
                               thetaU=1e3 * np.ones(2), nugget=1e-6, random_state=0, device="cpu")


def test_bo_with_smc_engine():
    """tests/test_smc.py's BO on the SMC engine, on the port."""
    opt = tbo.BO(search_space=tbo.RealSpace([[-5, 5]] * 2, random_seed=0),
                 obj_fun=lambda x: float(np.sum(np.asarray(x) ** 2)), model=_sphere_gp(), DoE_size=5,
                 max_FEs=15, random_seed=0, acquisition_optimization={"optimizer": "SMC"}, device="cpu")
    assert opt._argmax.method == "SMC"
    xopt, fopt, _ = opt.run()
    assert opt.eval_count == 15
    assert fopt[0] < 1.0, fopt


def test_parallelbo_q4_with_smc_engine():
    """4 MGFI criteria maximized as one SMC population; distinct points."""
    opt = tbo.ParallelBO(search_space=tbo.RealSpace([[-5, 5]] * 2, random_seed=0),
                         obj_fun=lambda x: float(np.sum(np.asarray(x) ** 2)), model=_sphere_gp(), n_point=4,
                         acquisition_fun="MGFI", acquisition_par={"t": 2.0}, DoE_size=4, max_FEs=16,
                         random_seed=0, acquisition_optimization={"optimizer": "SMC"}, device="cpu")
    opt.run()
    assert opt.eval_count == 16
    assert float(opt.xopt.fitness.ravel()[0]) < 5.0

"""The port's population (1+1)-Cholesky-CMA and its penalty helpers (box
reflection, dynamic penalty) against the JAX package on the CPU: the same
states and draws through both, the engine on the JAX package's own
benchmarks (tests/test_optim.py), and the host-facing class."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_optimization_tpu.optim import cma as jcma
from bayesian_optimization_tpu.utils.penalty import dynamic_penalty as j_penalty
from bayesian_optimization_tpu.utils.penalty import reflect_into_box as j_reflect
from bayesian_optimization_tpu_torch import RealSpace
from bayesian_optimization_tpu_torch.models.convert import cma_state_from_numpy
from bayesian_optimization_tpu_torch.optim import cma as tcma
from bayesian_optimization_tpu_torch.utils.penalty import dynamic_penalty as t_penalty
from bayesian_optimization_tpu_torch.utils.penalty import eval_constraints_host
from bayesian_optimization_tpu_torch.utils.penalty import reflect_into_box as t_reflect

torch.set_num_threads(1)  # one thread per pytest worker: more oversubscribe the cores

P, D = 8, 3
LO, HI = np.array([0.0, -1.0, 2.0]), np.array([1.0, 3.0, 2.5])


def test_reflect_into_box_far_outside_both_sides():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-40.0, -1.0, (30, D)), rng.uniform(3.0, 40.0, (30, D)),
                        rng.uniform(-1.0, 3.0, (30, D))]).astype(np.float32)
    want = np.asarray(j_reflect(jnp.asarray(x), LO, HI))
    got = t_reflect(torch.tensor(x), LO, HI).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.all((got >= LO - 1e-6) & (got <= HI + 1e-6))


@pytest.mark.parametrize("parts,minimize", [("h", True), ("g", True), ("hg", False)])
def test_dynamic_penalty_matches_jax(parts, minimize):
    """Violations of |h| > 0.01 and g > 0 across a batch of 12 points."""
    r = np.random.default_rng(len(parts))
    h = r.normal(0, 0.05, (12, 2)).astype(np.float32) if "h" in parts else None
    g = r.normal(0, 1.0, (12, 3)).astype(np.float32) if "g" in parts else None
    want = np.asarray(jax.jit(j_penalty, static_argnames="minimize")(
        None if h is None else jnp.asarray(h), None if g is None else jnp.asarray(g), 7.0,
        minimize=minimize))
    got = t_penalty(None if h is None else torch.tensor(h), None if g is None else torch.tensor(g),
                    7.0, minimize=minimize).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    hv, gv = eval_constraints_host([1.0, 2.0], lambda x: x[0] - 1.0, lambda x: [x[1], -x[0]])
    assert hv.tolist() == [0.0] and gv.tolist() == [2.0, -1.0]


def _state(seed: int):
    """A JAX CMAState with non-trivial factors, and its numpy fields."""
    r = np.random.default_rng(seed)
    A = np.tril(r.normal(0, 0.3, (P, D, D)), -1) + np.eye(D) * r.uniform(0.5, 1.5, (P, 1, D))
    fields = dict(
        x=r.uniform(LO, HI, (P, D)), f=r.normal(0, 1, P), sigma=r.uniform(0.05, 0.5, P),
        A=A, A_inv=np.linalg.inv(A), pc=r.normal(0, 0.2, (P, D)),
        success_rate=r.uniform(0.1, 0.6, P),
    )
    fields = {k: v.astype(np.float32) for k, v in fields.items()}
    js = jcma.CMAState(**{k: jnp.asarray(v) for k, v in fields.items()},
                       key=jax.random.PRNGKey(seed))
    return js, fields


def test_host_propose_given_jax_draw():
    js, fields = _state(1)
    _, x_j = jax.jit(lambda s: jcma._host_propose(s, LO, HI))(js)
    _, sub = jax.random.split(js.key)
    z = np.asarray(jax.random.normal(sub, (P, D), jnp.float32))
    ts = cma_state_from_numpy(fields, torch.Generator(), "cpu")
    _, x_t = tcma._host_propose(ts, torch.tensor(LO), torch.tensor(HI), z=torch.tensor(z))
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=0, atol=1e-6)


def test_host_generation_matches_jax_on_every_kind_of_lane():
    """Lanes 0-1 accepted, 2-3 rejected, 4 degenerate by its step size, 5 by
    a non-finite factor, 6-7 with non-finite offspring values."""
    js, fields = _state(2)
    r = np.random.default_rng(3)
    x_new = r.uniform(LO, HI, (P, D)).astype(np.float32)
    f_new = fields["f"].copy()
    f_new[[0, 1, 4]] -= 1.0
    f_new[[2, 3, 5]] += 1.0
    f_new[6], f_new[7] = np.nan, np.inf
    fields["sigma"][4] = 1e-10
    fields["A"][5, 1, 0] = np.inf
    js = js._replace(sigma=jnp.asarray(fields["sigma"]), A=jnp.asarray(fields["A"]))
    consts = jcma._constants(D)
    want = jax.jit(lambda s, xn, fn: jcma._host_generation(s, xn, fn, consts, LO, HI))(
        js, jnp.asarray(x_new), jnp.asarray(f_new))
    ts = cma_state_from_numpy(fields, torch.Generator(), "cpu")
    got = tcma._host_generation(ts, torch.tensor(x_new), torch.tensor(f_new),
                                tcma._constants(D), LO, HI)
    for name in jcma.CMAState._fields[:-1]:
        w, g = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert np.all(np.isfinite(g)), name
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7, err_msg=name)
    # the degenerate lanes restarted from the identity with sigma 0.25
    assert np.array_equal(got.A[4].numpy(), np.eye(D)) and np.array_equal(got.A[5].numpy(), np.eye(D))
    assert float(got.sigma[4]) == float(got.sigma[5]) == 0.25


def test_run_cma_sphere():
    fun = lambda X: ((X - 0.7) ** 2).sum(-1)
    x0 = torch.rand((32, 3), generator=torch.Generator().manual_seed(0))
    xb, fb, xs, fs = tcma.run_cma(torch.Generator().manual_seed(1), fun, x0, torch.zeros(3),
                                  torch.ones(3), 150)
    assert float(fb) < 1e-4
    assert np.allclose(xb.numpy(), 0.7, atol=0.02)
    assert xs.shape == (32, 3) and fs.shape == (32,)


def test_run_cma_ellipsoid_conditioning():
    # needs covariance adaptation, not just step-size control
    w = torch.tensor([1.0, 25.0, 100.0])
    fun = lambda X: (w * (X - 0.5) ** 2).sum(-1)
    x0 = torch.rand((32, 3), generator=torch.Generator().manual_seed(2))
    _, fb, _, _ = tcma.run_cma(torch.Generator().manual_seed(3), fun, x0, torch.zeros(3),
                               torch.ones(3), 250)
    assert float(fb) < 1e-3


def test_cma_class_host_objective():
    space = RealSpace([[-5, 5]] * 2, random_seed=0)
    opt = tcma.OnePlusOne_Cholesky_CMA(
        search_space=space, obj_fun=lambda x: float(np.sum(np.asarray(x) ** 2)),
        max_FEs=3000, ftarget=1e-5, n_chains=16, random_seed=0, device="cpu",
    )
    xopt, fopt, stop = opt.run()
    assert fopt < 1e-3
    assert opt.eval_count <= 3100


def test_cma_class_with_constraint():
    space = RealSpace([[-5, 5]] * 2, random_seed=0)
    opt = tcma.OnePlusOne_Cholesky_CMA(
        search_space=space,
        obj_fun=lambda x: float(np.sum((np.asarray(x) - 1.0) ** 2)),
        g=lambda x: float(x[0] + x[1]),  # feasible: x0 + x1 <= 0
        max_FEs=4000, n_chains=16, random_seed=0, device="cpu",
    )
    xopt, fopt, _ = opt.run()
    assert xopt[0] + xopt[1] <= 0.3  # near-feasible (dynamic penalty)


def test_cma_class_default_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError):
        tcma.OnePlusOne_Cholesky_CMA(search_space=RealSpace([[-1, 1]]), obj_fun=lambda x: 0.0)

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


@pytest.mark.parametrize("n", [384, 512])
def test_whiten_grad_hybrid_matches_jax(n, monkeypatch):
    """Above SUPER rows the backward solves by superpanel inverses (here 256
    wide, so n=384 ends on a 128-wide superpanel): value and gradient of two
    batched lanes against the JAX VJP, at the tolerances of the other sizes."""
    monkeypatch.setattr(tl, "SUPER", 256)
    Rs = np.stack([_spd(n, seed=s) for s in (1, 2)])
    B = np.random.default_rng(6).standard_normal((n, 2)).astype(np.float32)

    def f_jax(R_):
        d, W, _ = jl.whiten(R_, jnp.asarray(B))
        return jnp.sum(jnp.log(d)) + jnp.sum(W ** 2)

    Rt = torch.tensor(Rs, requires_grad=True)
    d, W, piv = tl.whiten(Rt, torch.tensor(B))
    (torch.log(d).sum(-1) + (W ** 2).sum((-2, -1))).sum().backward()
    assert bool((piv > 0).all())
    for i in range(2):
        v_j, g_j = jax.value_and_grad(f_jax)(jnp.asarray(Rs[i]))
        v_t = float(torch.log(d[i]).sum() + (W[i] ** 2).sum())
        assert abs(v_t - float(v_j)) < 1e-4 * max(1.0, abs(float(v_j)))
        assert _rel(Rt.grad[i].numpy(), g_j) < 1e-3


@pytest.mark.parametrize("n, sb", [(100, 256), (256, 256), (512, 256), (640, 256)])
def test_upper_t_solves_match_f64(n, sb):
    """The backward's solve (one superpanel up to SUPER rows, L^-1 from
    Dinv) and the superpanel form at width sb, against the float64
    triangular solve, in float64."""
    import scipy.linalg as sla

    R = _spd(n, seed=n, cond="kernel").astype(np.float64)
    B = np.random.default_rng(n).standard_normal((2, n, 5))
    _, _, _, L, Dinv = tl.whiten_fused(torch.tensor(R).expand(2, n, n), torch.tensor(B))
    want = np.stack([sla.solve_triangular(L[i].numpy().T, B[i], lower=False) for i in range(2)])
    got = tl.tri_solve_upper_t_super(L, tl._super_inv(L, Dinv, tl.SUPER), torch.tensor(B), tl.SUPER).numpy()
    got_s = tl.tri_solve_upper_t_super(L, tl._super_inv(L, Dinv, sb), torch.tensor(B), sb).numpy()
    assert _rel(got, want) < 1e-10 and _rel(got_s, want) < 1e-10


def _ill_conditioned(n, log10_theta):
    """Float64 Matern-3/2 on n uniform points in 5-D at one theta, nugget
    1e-6, as the fits reach with theta at its bounds: cond(R) 2.5e6 (n=256,
    10^-1) to 6.4e7 (10^-2)."""
    from bayesian_optimization_tpu_torch.ops.hopper_kernels import matern_plain

    X = torch.tensor(np.random.default_rng(0).uniform(0, 1, (n, 5)))
    theta = torch.full((1, 5), 10.0 ** log10_theta, dtype=torch.float64)
    return (matern_plain(theta, X, nu=1.5) + 1e-6 * torch.eye(n, dtype=torch.float64))[0].numpy()


@pytest.mark.parametrize("log10_theta", [-1.0, -2.0])
@pytest.mark.parametrize("solver", ["trsm", "substitution", "inverse"])
def test_backward_solvers_at_ill_conditioned_r(solver, log10_theta):
    """At cond(R) 2.5e6-6.4e7 each L^T solver the backward could use (torch's
    triangular solve, cuBLAS trsm on the card; the blocked substitution over
    Dinv; the explicit inverse the backward runs) adds under 1e-5 of the
    gradient: against the float64 VJP of the same float32 factor."""
    from bayesian_optimization_tpu_torch.tools.whiten_bwd_variants import SOLVERS

    n = 256
    R64 = _ill_conditioned(n, log10_theta)
    B = np.random.default_rng(1).standard_normal((n, 2))
    R, B32 = torch.tensor(R64, dtype=torch.float32)[None], torch.tensor(B, dtype=torch.float32)[None]
    d, W, piv, L, Dinv = tl._whiten_parts(R, B32)
    assert bool((piv > 0).all())
    Ld, Wd = L.double(), W.double()
    own = tl.whiten_vjp(Ld, Wd, lambda X: torch.linalg.solve_triangular(Ld.mT, X, upper=True),
                        1.0 / d.double(), 2.0 * Wd)[0][0].numpy()
    g = tl.whiten_vjp(L, W, SOLVERS[solver](L, Dinv), 1.0 / d, 2.0 * W)[0][0].numpy()
    assert _rel(g, own) < 1e-5


def _f64_grad(R64, B):
    Rr = torch.tensor(R64, requires_grad=True)
    L64 = torch.linalg.cholesky(Rr)
    W64 = torch.linalg.solve_triangular(L64, torch.tensor(B), upper=False)
    (torch.log(L64.diagonal()).sum() + (W64 ** 2).sum()).backward()
    return Rr.grad.numpy()


@pytest.mark.parametrize("log10_theta", [0.0, -0.5])
def test_whiten_grad_at_ill_conditioned_r_matches_jax(log10_theta):
    """At cond(R) 5.4e4 and 4.0e5 (n=256) whiten's gradient (the backward's
    own solver) is within 1.1x of the JAX float32 whiten's error against
    float64 autograd: the float32 factor's error, alike in both packages."""
    n = 256
    R64 = _ill_conditioned(n, log10_theta)
    B = np.random.default_rng(1).standard_normal((n, 2))
    ref = _f64_grad(R64, B)
    Rt = torch.tensor(R64, dtype=torch.float32, requires_grad=True)
    d, W, _ = tl.whiten(Rt, torch.tensor(B, dtype=torch.float32))
    (torch.log(d).sum() + (W ** 2).sum()).backward()

    def f_jax(R_):
        d_, W_, _ = jl.whiten(R_, jnp.asarray(B, jnp.float32))
        return jnp.sum(jnp.log(d_)) + jnp.sum(W_ ** 2)

    g_j = jax.grad(f_jax)(jnp.asarray(R64, jnp.float32))
    assert _rel(Rt.grad.numpy(), ref) <= 1.1 * _rel(g_j, ref)


def test_whiten_factors_where_jax_flags_the_pivot():
    """At cond(R) 2.5e6 (n=256, theta 0.1, nugget 1e-6) the JAX package's
    float32 whiten on the CPU reports a failed factorisation (pivot <= 0,
    W not finite), while the port's factors R (pivot > 0) and its gradient
    is finite and within 1e-2 of float64 autograd (ROADMAP Queue 3)."""
    R64 = _ill_conditioned(256, -1.0)
    B = np.random.default_rng(1).standard_normal((256, 2))
    _, Wj, pj = jl.whiten(jnp.asarray(R64, jnp.float32), jnp.asarray(B, jnp.float32))
    assert not float(pj) > 0.0 and not bool(jnp.isfinite(Wj).all())
    Rt = torch.tensor(R64, dtype=torch.float32, requires_grad=True)
    d, W, piv = tl.whiten(Rt, torch.tensor(B, dtype=torch.float32))
    (torch.log(d).sum() + (W ** 2).sum()).backward()
    assert float(piv) > 0.0 and bool(torch.isfinite(Rt.grad).all())
    assert _rel(Rt.grad.numpy(), _f64_grad(R64, B)) < 1e-2

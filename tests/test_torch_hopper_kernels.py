"""The port's kernel twins (bayesian_optimization_tpu_torch/ops/hopper_kernels)
against the JAX package's Pallas kernels, on the CPU.

The Pallas kernels run in interpret mode, as tests/test_pallas.py runs
them; the same numpy inputs go to both packages. The CUDA kernels
themselves are held against these twins on the card by
tests/test_torch_cuda_kernels.py.
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
    _d2k_dr2, _dk_dr2, _nu_code, matern_bwd2_plain, matern_bwd_plain, matern_fused, matern_plain,
    reset_launch_counts, whiten_fused, whiten_plain,
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


def _bwd_case(case):
    """(theta (B, D), X (N, D), Y (M, D) or None for the training matrix,
    G (B, N, M)) for one case the backward kernel must handle."""
    r = np.random.default_rng(7)
    B, N, M = {"lanes3": (3, 40, 60), "masked": (2, 48, None), "gated": (2, 30, 45),
               "duplicates": (1, 40, None), "ragged": (2, 37, 53), "same": (2, 50, None)}[case]
    theta = (10 ** r.uniform(-1, 1, (B, 5))).astype(np.float32)
    X = r.uniform(0, 1, (N, 5)).astype(np.float32)
    Y = None if M is None else r.uniform(0, 1, (M, 5)).astype(np.float32)
    G = r.standard_normal((B, N, N if M is None else M)).astype(np.float32)
    if case == "masked":  # as _masked_correlation: padded rows/cols and the diagonal
        mask = (np.arange(N) < N - 9).astype(np.float32)
        G = G * (np.outer(mask, mask) * (1.0 - np.eye(N, dtype=np.float32)))
    if case == "gated":  # w = max(theta, 0): no gradient through a zero or negative entry
        theta[0, 1], theta[1, 3] = 0.0, -0.5
    if case == "duplicates":  # off-diagonal r2 = 0
        X[5] = X[3]
        X[11] = X[3]
    return theta, X, Y, G


@pytest.mark.parametrize("nu", NUS)
@pytest.mark.parametrize("case", ["lanes3", "masked", "gated", "duplicates", "ragged", "same"])
def test_matern_bwd_plain_matches_jax(case, nu):
    """The plain backward (matern_bwd_plain, through matern_fused's autograd
    on the CPU) against jax.grad of the JAX package's kernel, lane by lane,
    on the cases the backward kernel must handle: theta, X and (cross) Y
    gradients within 1e-4 relative; gradients of a theta entry <= 0 are
    exactly 0 (the JAX package's sqrt(max(theta, 0)) gives NaN there)."""
    theta, X, Y, G = _bwd_case(case)
    kern = _jax_kernel(nu)
    jY = None if Y is None else jnp.asarray(Y)

    def jf(th, x, y):
        return sum(jnp.sum(kern(th[b], x, y) * G[b]) for b in range(G.shape[0]))

    want = jax.grad(jf, argnums=(0, 1) if Y is None else (0, 1, 2))(
        jnp.asarray(theta), jnp.asarray(X), jY)

    th = torch.tensor(theta, requires_grad=True)
    x = torch.tensor(X, requires_grad=True)
    y = None if Y is None else torch.tensor(Y, requires_grad=True)
    (matern_fused(th, x, y, nu=nu) * torch.tensor(G)).sum().backward()
    got = (th.grad, x.grad) if Y is None else (th.grad, x.grad, y.grad)
    live = theta > 0
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w, np.float64)
        assert np.isfinite(g).all()
        if g.shape == theta.shape:
            assert (g[~live] == 0.0).all()
            g, w = g[live], w[live]
        assert np.abs(g - w).max() / np.abs(w).max() < 1e-4


def _bwd_plan(B, N, M, D, sms, mode, max_rows=4, warps=8, tile_n=128):
    """A copy of csrc/matern.cu's bwd_plan for matern_bwd_kernel (change
    both together): (rows a tile, row tiles, column tiles, blocks a row
    tile) on a card of `sms` SMs, two blocks an SM in modes 0 (dtheta alone)
    and 1 (with dX), one in mode 2 (with dY) and in mode 1 at 8 features or
    more. The wrapper sizes its buffers from the C plan itself
    (botorch_matern_bwd_scratch, botorch_matern_bwd_row_tiles), not from
    this copy."""
    blocks = (1 if mode == 2 or (mode == 1 and D >= 8) else 2) * max(sms, 1)
    n_jt = -(-M // tile_n)
    E = B * n_jt
    rows = max_rows
    while rows > 1 and -(-N // (warps * rows)) * E < blocks:
        rows //= 2
    n_it = -(-N // (warps * rows))
    return warps * rows, n_it, n_jt, max(1, min(E, -(-blocks // n_it)))


def _emulate_matern_bwd(theta, X, Y, G, code, sym, sms, mode, tile_n=128):
    """The backward kernel's schedule (csrc/matern.cu, matern_bwd_kernel) in
    torch: block (s, it) takes row tile it's tiles [s E / S, (s + 1) E / S)
    of its E = B nJt (lane by lane), keeping its dtheta sums per lane
    (Pt[blk][b]) and its rows' dX sums weighted by w_bk across them (Px[s]),
    and writing each tile's column sums (dY) weighted by w_bk; then the last
    block's sums over the blocks and tiles, and the gate."""
    B, D = theta.shape
    N, M = X.shape[0], Y.shape[0]
    w = theta.clamp_min(0.0)
    tile_m, n_it, n_jt, S = _bwd_plan(B, N, M, D, sms, mode)
    E = B * n_jt
    Pt = torch.zeros(n_it, S, B, D, dtype=X.dtype)
    Px = torch.zeros(S, N, D, dtype=X.dtype)
    Py = torch.zeros(B, n_it, M, D, dtype=X.dtype)
    seen = torch.zeros(n_it, E, dtype=torch.int64)
    for it in range(n_it):
        i = torch.arange(it * tile_m, min(N, (it + 1) * tile_m))
        for s in range(S):
            for e in range(E * s // S, E * (s + 1) // S):
                seen[it, e] += 1
                b, jt = divmod(e, n_jt)
                j = torch.arange(jt * tile_n, min(M, (jt + 1) * tile_n))
                d = X[i, None, :] - Y[None, j, :]
                r2 = (w[b] * d * d).sum(-1)
                A = G[b][i[:, None], j[None, :]] * _dk_dr2(r2, torch.exp(-r2), code)
                if sym:
                    A = torch.where(i[:, None] == j[None, :], torch.zeros_like(A), A)
                Pt[it, s, b] += (A[..., None] * d * d).sum((0, 1))
                Px[s, i] += w[b] * (A[..., None] * d).sum(1)
                Py[b, it, j] = w[b] * (A[..., None] * d).sum(0)
    assert bool((seen == 1).all())  # every tile of every row tile once
    return Pt.sum((0, 1)) * (theta > 0), 2.0 * Px.sum(0), -2.0 * Py.sum((0, 1))


def _emulate_matern_bwd_square(theta, X, G, code, sym, sms, tile=64):
    """The dtheta kernel of K(X, X) (csrc/matern.cu, matern_bwd_sym_kernel)
    in torch: block (p, b) walks the units [p U / P, (p + 1) U / P) of lane
    b's: the pairs of blocks (I, J), I < J, then the diagonal blocks two at a
    time, adding (G_ij + G_ji) h d^2 over each pair's block (I, J) and over
    each diagonal block's strict upper triangle, folded to the pairs
    (i, (i + o) mod 64), o in [1, 32]; then the sum over the blocks'
    partials, and the gate."""
    B, D = theta.shape
    N = X.shape[0]
    w = theta.clamp_min(0.0)
    nT = -(-N // tile)
    units = ([[(I, J)] for I in range(nT) for J in range(I + 1, nT)]
             + [[(I, I), (I + 1, I + 1)][:2 if I + 1 < nT else 1] for I in range(0, nT, 2)])
    U = len(units)
    P = max(1, min(U, 2 * max(sms, 1) // B))
    i_f = torch.arange(tile)[:, None].expand(tile, tile // 2)          # folded rows
    o_f = torch.arange(1, tile // 2 + 1)[None, :].expand(tile, tile // 2)
    keep = (o_f < tile // 2) | (i_f < tile // 2)
    Pt = torch.zeros(P, B, D, dtype=X.dtype)
    for b in range(B):
        for p in range(P):
            for unit in units[U * p // P:U * (p + 1) // P]:
                for I, J in unit:
                    if I != J:
                        i = torch.arange(I * tile, min(N, (I + 1) * tile))[:, None]
                        j = torch.arange(J * tile, min(N, (J + 1) * tile))[None, :]
                    else:  # the folded strict upper triangle of block I
                        i = I * tile + i_f[keep]
                        j = I * tile + (i_f + o_f)[keep] % tile
                        inside = (i < N) & (j < N)
                        i, j = i[inside], j[inside]
                    d = X[i] - X[j]
                    r2 = (w[b] * d * d).sum(-1)
                    A = (G[b][i, j] + G[b][j, i]) * _dk_dr2(r2, torch.exp(-r2), code)
                    Pt[p, b] += (A[..., None] * d * d).reshape(-1, D).sum(0)
    return Pt.sum(0) * (theta > 0)


@pytest.mark.parametrize("sms", [1, 4, 132])
@pytest.mark.parametrize("nu", NUS)
@pytest.mark.parametrize("case", ["lanes3", "masked", "gated", "duplicates", "ragged", "same"])
def test_matern_bwd_schedule_matches_twin(case, nu, sms):
    """The backward kernel's decomposition (its work split on a card of
    `sms` SMs, the blocks' partials, then their sums) against the plain
    backward, both in float64, on the kernel's cases: the split of dtheta
    alone (for K(X, X) the pairs of blocks above the diagonal and the
    diagonal blocks' upper triangles, with G + G^T) for dtheta, of dX alone
    and of everything for dX and dY."""
    theta, X, Y, G = (None if a is None else torch.tensor(a, dtype=torch.float64)
                      for a in _bwd_case(case))
    same = Y is None
    Yv = X if same else Y
    code = _nu_code(nu)
    K = matern_plain(theta, X, Yv, nu=nu, sym=same)
    g_t = (_emulate_matern_bwd_square(theta, X, G, code, same, sms) if same else
           _emulate_matern_bwd(theta, X, Yv, G, code, same, sms, mode=0)[0])
    _, g_x, g_y = _emulate_matern_bwd(theta, X, Yv, G, code, same, sms, mode=2)
    if not same:  # the argmax's mode, dX without dY: its own split
        assert float((_emulate_matern_bwd(theta, X, Yv, G, code, same, sms, mode=1)[1] - g_x)
                     .abs().max()) <= 1e-12 * float(g_x.abs().max())
    if same:  # Y is X: both sides of the distance move with X
        g_x, g_y = g_x + g_y, None
    want = matern_bwd_plain(theta, X, Yv, K, G, code, same, same, (True, True, not same))
    for got, w in zip((g_t, g_x, g_y), want):
        assert (got is None) == (w is None)
        if w is not None:
            assert float((got - w).abs().max() / w.abs().max()) < 1e-9


def _row_splits(B, N, M, sms, blocks_per_sm=2, threads=256):
    """A copy of csrc/matern_bwd2.cu's row_splits (change both together):
    blocks per row of X."""
    return max(1, min(-(-B * M // threads), blocks_per_sm * max(sms, 1) // max(N, 1)))


def _emulate_matern_bwd2(theta, X, Y, G, V, code, sym, sms):
    """The second-derivative kernel's schedule (csrc/matern_bwd2.cu) in
    torch: block s of row i takes the pairs [s P / S, (s + 1) P / S) of the
    row's P = B M, writes gG per pair and its gX partial; then the sum of
    each row's S partials."""
    B, D = theta.shape
    N, M = X.shape[0], Y.shape[0]
    w = theta.clamp_min(0.0)
    S = _row_splits(B, N, M, sms)
    gG = torch.full((B, N, M), math.nan, dtype=X.dtype)
    part = torch.zeros(S, N, D, dtype=X.dtype)
    for i in range(N):
        for s in range(S):
            pairs = torch.arange(B * M * s // S, B * M * (s + 1) // S)
            b, j = pairs // M, pairs % M
            d = X[i] - Y[j]                                   # (pairs, D)
            c = (w[b] * d * V[i]).sum(-1)
            h, h2 = _d2k_dr2((w[b] * d * d).sum(-1), code)
            if sym:
                h, h2 = (torch.where(j == i, torch.zeros_like(t), t) for t in (h, h2))
            gG[b, i, j] = 2.0 * h * c
            Gv = G[b, i, j]
            part[s, i] = (w[b] * (2.0 * (Gv * h)[:, None] * V[i] + 4.0 * (Gv * h2 * c)[:, None] * d)).sum(0)
    return S, gG, part.sum(0)


@pytest.mark.parametrize("nu", NUS)
@pytest.mark.parametrize("shape", [(1, 1, 1024, 5, False, 132), (8, 1, 1021, 5, False, 132),
                                   (2, 3, 53, 5, False, 132), (8, 3, 517, 6, False, 16),
                                   (2, 40, 40, 3, True, 132), (1, 2, 300, 11, False, 4)], ids=str)
def test_matern_bwd2_schedule_matches_twin(shape, nu):
    """The second-derivative kernel's decomposition (each row's pairs split
    over S blocks, their partials summed) against matern_bwd2_plain, both in
    float64; S > 1 at the Hessian's shapes."""
    B, N, M, D, sym, sms = shape
    r = np.random.default_rng(N + M + D)
    t = lambda a: torch.tensor(a, dtype=torch.float64)  # noqa: E731
    theta = t(10 ** r.uniform(-1, 1.5, (B, D)))
    X = t(r.uniform(0, 1, (N, D)))
    Y = X.clone() if sym else t(r.uniform(0, 1, (M, D)))
    G, V = t(r.standard_normal((B, N, M))), t(r.standard_normal((N, D)))
    code = _nu_code(nu)
    S, gG, gX = _emulate_matern_bwd2(theta, X, Y, G, V, code, sym, sms)
    assert S > 1 or N > 1
    want_G, want_X = matern_bwd2_plain(theta, X, Y, G, V, code, sym, (True, True))
    assert float((gG - want_G).abs().max() / want_G.abs().max()) < 1e-9
    assert float((gX - want_X).abs().max() / want_X.abs().max()) < 1e-9


@pytest.mark.parametrize("nu", NUS)
@pytest.mark.parametrize("case", ["lanes3", "gated", "ragged", "sym"])
@pytest.mark.parametrize("fn", [matern_plain, matern_fused], ids=["plain", "fused"])
def test_matern_second_derivative_matches_jax(fn, case, nu):
    """The second derivative of a cross-covariance in its first argument,
    as a Hessian takes it: for s = <d/dX sum(G * K(X, Y)), V>, ds/dX and
    ds/dG against jax.grad of jax.grad of the JAX package's kernel (1e-4
    relative). Through matern_fused on the CPU that is the backward's own
    backward, matern_bwd2_plain, the twin of the second-derivative kernel;
    through matern_plain torch's autograd of the twin's ops. With sym (Y
    a copy of X) the unit diagonal carries no derivative."""
    theta, X, Y, G = _bwd_case("lanes3" if case == "sym" else case)
    if case == "sym":
        Y = X.copy()
        G = G[:, :, :X.shape[0]] * (1.0 - np.eye(X.shape[0], dtype=np.float32))
    V = np.random.default_rng(8).standard_normal(X.shape).astype(np.float32)
    kern = _jax_kernel(nu)

    def s_of(x, g):
        gx = jax.grad(lambda xx: sum(jnp.sum(kern(theta[b], xx, jnp.asarray(Y)) * g[b])
                                     for b in range(g.shape[0])))(x)
        return jnp.sum(gx * V)

    want = jax.grad(s_of, argnums=(0, 1))(jnp.asarray(X), jnp.asarray(G))
    x = torch.tensor(X, requires_grad=True)
    g = torch.tensor(G, requires_grad=True)
    K = fn(torch.tensor(theta), x, torch.tensor(Y), nu=nu, sym=case == "sym")
    (gx,) = torch.autograd.grad((K * g).sum(), x, create_graph=True)
    got = torch.autograd.grad((gx * torch.tensor(V)).sum(), (x, g))
    for a, w in zip(got, want):
        a, w = a.numpy(), np.asarray(w, np.float64)
        assert np.isfinite(a).all()
        assert np.abs(a - w).max() / np.abs(w).max() < 1e-4


def test_matern_second_derivative_refuses_theta_y_and_k_xx():
    """The second-derivative kernel differentiates the X gradient of a
    cross-covariance in G and X only: through theta, through Y, or of K(X, X)
    the wrapper raises on the CPU as on the card. Nothing launches on CPU
    tensors."""
    reset_launch_counts()
    X = torch.tensor(X_NP[:20], requires_grad=True)
    Y = torch.tensor(Y_NP[:30])
    th = torch.tensor(THETA_NP)
    for theta, y in ((th.clone().requires_grad_(True), Y), (th, Y.clone().requires_grad_(True)),
                     (th, None)):
        (gx,) = torch.autograd.grad(matern_fused(theta, X, y, nu=1.5).sum(), X, create_graph=True)
        with pytest.raises(NotImplementedError, match="second derivative"):
            torch.autograd.grad(gx.sum(), X)
    assert matern_fused.bwd2_launches == 0 and matern_fused.launches == 0


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


# ---------------------------------------------------------------------------
# The arithmetic of csrc/whiten.cu, emulated step for step in torch: the
# diagonal block by 32-wide sub-blocks (a warp's register column sweep, the
# sub-panel, the trailing update and the blocked inverse assembly), then the
# panel solve and trailing update over the workspace [R; B^T]. It catches an
# error in the schedule or the inverse formula on the CPU, where the CUDA
# kernel cannot run; tests/test_torch_cuda_kernels.py holds the kernel itself
# to the twin on the card.
# ---------------------------------------------------------------------------

SUB = 32


def _nan_min(a, b):
    return a if math.isnan(a) else b if math.isnan(b) else min(a, b)


def _emulate_sub_block_sweep(blk, w):
    """One warp's sweep over a (32, 32) register block whose lanes >= w hold
    identity rows: (L_ss, X_ss, raw pivots of the w live columns)."""
    row = torch.eye(SUB)
    row[:w, :w] = blk
    x = torch.eye(SUB)
    lanes = torch.arange(SUB)
    pivots, invs = [], []
    for j in range(SUB):
        raw = float(row[j, j])
        if j < w:
            pivots.append(raw)
        p = torch.tensor(raw if raw > 1e-12 else 1e-12)
        inv = torch.rsqrt(p)                      # d = p / sqrt(p), from one rsqrt
        d = p * inv
        lcol = row[:, j] * inv                    # each lane's l
        below = lanes > j
        # the rows below eliminate with l / d times lane j's unscaled row of
        # the inverse; each row is scaled by its own 1 / d after the sweep
        x[j + 1:, : j + 1] -= (lcol[j + 1:] * inv)[:, None] * x[j, None, : j + 1]
        invs.append(inv)
        row[j, j] = d
        row[below, j] = lcol[below]
        row[j + 1:, j + 1:] -= lcol[j + 1:, None] * lcol[None, j + 1:]
    x = x * torch.stack(invs)[:, None]
    return torch.tril(row[:w, :w]), x[:w, :w], pivots


def _emulate_diag_block(S):
    """chol_diag_kernel on one (T, T) block: (L_kk, Dinv_k, min raw pivot)."""
    T = S.shape[0]
    A = torch.tril(S).clone()
    X = torch.zeros_like(A)  # finished rows: the inverse; rows below: pending sums P
    pmin = math.inf
    for s0 in range(0, T, SUB):
        w = min(SUB, T - s0)
        e = s0 + w
        Lss, Xss, pivots = _emulate_sub_block_sweep(A[s0:e, s0:e], w)
        for p in pivots:
            pmin = _nan_min(pmin, p)
        A[s0:e, s0:e] = Lss
        X[s0:e, s0:e] = Xss
        if e < T:                                 # 1b: the sub-panel below
            A[e:, s0:e] = A[e:, s0:e] @ Xss.T
        if s0 > 0:                                # 1b: X_sj = -X_ss P_sj, j < s
            X[s0:e, :s0] = -(Xss @ X[s0:e, :s0])
        if e < T:                                 # 1c: trailing update, pending sums
            L21 = A[e:, s0:e]
            A[e:, e:] -= torch.tril(L21 @ L21.T)
            X[e:, :e] += L21 @ X[s0:e, :e]
    return torch.tril(A), X, pmin


def _emulate_whiten(R, B):
    """The launch sequence of botorch_whiten on one matrix: (d, W, piv, L, Dinv)."""
    n, mb = R.shape[0], B.shape[1]
    T = min(n, 128)
    ws = torch.cat([R, B.T]).clone()
    dinv, piv = [], math.inf
    for kb in range(0, n, T):
        ke = kb + T
        Lkk, Xk, p = _emulate_diag_block(ws[kb:ke, kb:ke])
        piv = _nan_min(piv, p)
        ws[kb:ke, kb:] = 0.0
        ws[kb:ke, kb:ke] = Lkk
        dinv.append(Xk)
        ws[ke:, kb:ke] = ws[ke:, kb:ke] @ Xk.T    # panel solve, RHS rows included
        upd = ws[ke:, kb:ke] @ ws[ke:n, kb:ke].T  # trailing update
        keep = torch.ones_like(upd, dtype=torch.bool)
        keep[: n - ke] = torch.tril(keep[: n - ke])
        ws[ke:, ke:n] -= torch.where(keep, upd, torch.zeros_like(upd))
    L = ws[:n]
    return L.diagonal(), ws[n:].T, torch.tensor(piv), L, torch.stack(dinv)


def _jax_factor_and_solve(R, B):
    """The JAX package's reference for the same pair: the Pallas kernel in
    interpret mode where it applies (n % 128 == 0), else its blocked XLA
    factorisation and forward solve (n <= 128, any n)."""
    from bayesian_optimization_tpu.ops.linalg import _factor, tri_solve_lower

    if R.shape[0] % 128 == 0:
        _, W, piv, L, Dinv = whiten_pallas(jnp.asarray(R), jnp.asarray(B), interpret=True)
    else:
        L, Dinv, piv = _factor(jnp.asarray(R))
        W = tri_solve_lower(L, Dinv, jnp.asarray(B))
    return tuple(np.asarray(t, np.float64) for t in (W, piv, L, Dinv))


@pytest.mark.parametrize("n", [16, 37, 64, 100, 128, 256])
def test_whiten_schedule_matches_twin_and_jax(n):
    R = _kernel_like(n, n)
    B = np.random.default_rng(n).standard_normal((n, 3)).astype(np.float32)
    d, W, piv, L, Dinv = _emulate_whiten(torch.tensor(R), torch.tensor(B))
    d0, W0, piv0, L0, Dinv0 = whiten_plain(torch.tensor(R), torch.tensor(B))
    Wj, pivj, Lj, Dinvj = _jax_factor_and_solve(R, B)
    T = min(n, 128)
    assert Dinv.shape == Dinv0.shape == Dinvj.shape == (n // T, T, T)
    for Lr, Wr, pr in ((L0.double().numpy(), W0.double().numpy(), float(piv0)), (Lj, Wj, float(pivj))):
        assert np.abs(L.numpy() - Lr).max() / np.abs(Lr).max() < 1e-4
        assert np.abs(W.numpy() - Wr).max() < 1e-3 * max(1.0, np.abs(Wr).max())
        assert abs(float(piv) - pr) < 1e-3 * abs(pr)
    assert np.abs(d.numpy() - d0.numpy()).max() < 1e-4
    assert float(torch.triu(L, 1).abs().max()) == 0.0
    for k in range(n // T):
        blk = L[k * T:(k + 1) * T, k * T:(k + 1) * T]
        assert float((Dinv[k] @ blk - torch.eye(T)).abs().max()) < 1e-3
        assert float(torch.triu(Dinv[k], 1).abs().max()) == 0.0


@pytest.mark.parametrize("n", [37, 256])
@pytest.mark.parametrize("fault", ["indefinite", "nan"])
def test_whiten_schedule_flags_a_failed_factorisation(n, fault):
    """A -1 pivot reads as not (piv > 0), as in the twin and the JAX
    package; a NaN in the lower triangle wins the pivot minimum."""
    R = _kernel_like(n, 1)
    if fault == "indefinite":
        R[n // 2, n // 2] = -1.0
    else:
        R[n - 2, 3] = R[3, n - 2] = np.nan
    B = np.ones((n, 1), np.float32)
    _, _, piv, _, _ = _emulate_whiten(torch.tensor(R), torch.tensor(B))
    assert not (float(piv) > 0.0)
    if fault == "nan":
        assert math.isnan(float(piv))
    else:
        _, _, piv0, _, _ = whiten_plain(torch.tensor(R), torch.tensor(B))
        _, pivj, _, _ = _jax_factor_and_solve(R, B)
        assert not (float(piv0) > 0.0) and not (float(pivj) > 0.0)


def test_cpu_tensors_never_launch():
    reset_launch_counts()
    X = torch.tensor(X_NP)
    th = torch.tensor(THETA_NP, requires_grad=True)
    matern_fused(th, X).sum().backward()
    whiten_fused(torch.tensor(_kernel_like(64, 2)), torch.ones(64, 1))
    assert matern_fused.launches == 0
    assert matern_fused.bwd_launches == 0
    assert whiten_fused.launches == 0

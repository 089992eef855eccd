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
    _nu_code, matern_bwd2_fused, matern_bwd2_plain, matern_bwd_fused, matern_bwd_plain,
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
@pytest.mark.parametrize("shape", [(2, 1024, None), (1, 25, 1024)])
def test_matern_kernel_main_path_shapes(dev, nu, shape):
    """The fit's training matrix (2 lanes at n = 1024) and the argmax's cross
    matrix (25 queries, one theta vector) against the twin."""
    rng = np.random.default_rng(2)
    B, N, M = shape
    X = torch.tensor(rng.uniform(0, 1, (N, 5)), dtype=torch.float32, device=dev)
    Y = None if M is None else torch.tensor(rng.uniform(0, 1, (M, 5)), dtype=torch.float32,
                                            device=dev)
    theta = torch.tensor(10 ** rng.uniform(-1, 2, (B, 5)), dtype=torch.float32, device=dev)
    for th in (theta, theta[0]) if B == 1 else (theta,):
        K = matern_fused(th, X, Y, nu=nu)
        K_ref = matern_plain(th, X, Y, nu=nu)
        torch.cuda.synchronize()
        assert K.shape == K_ref.shape
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
        before = matern_fused.bwd_launches
        (fn(th, Xq, X, nu=nu) * G).sum().backward()
        assert matern_fused.bwd_launches == before + (fn is matern_fused)
        grads.append((th.grad, Xq.grad))
    for a, b in zip(*grads):
        assert float((a - b).abs().max() / b.abs().max()) < 1e-4


# every combination of (theta, X, Y) gradients asked
ALL_NEEDS = [(True, False, False), (False, True, False), (False, False, True), (True, True, False),
             (True, False, True), (False, True, True), (True, True, True)]
# case -> (B, N, M or None for the training matrix, D): the fit's and the
# argmax's calls, the ensemble's 8 lanes and the ladder's 10, ragged N and M
# (M % 4 != 0, and M % 4 == 0 with ragged N), D from 1 to past two 8-feature
# chunks, G as an unaligned view, and the training matrix (the fit's dtheta
# kernel of K(X, X)) at D = 1, 3, 5, 8 and ragged blocks of 64, with a full G
# (nonzero in its last rows and columns) but in "masked", "fit" and "ladder"
BWD_CASES = {"lanes3": (3, 40, 60, 5), "masked": (2, 48, None, 5), "gated": (2, 30, 45, 5),
             "duplicates": (1, 40, None, 5), "ragged": (2, 37, 53, 5), "same": (2, 50, None, 5),
             "fit": (2, 1024, None, 5), "argmax": (1, 25, 1024, 5),
             "ensemble": (8, 25, 1024, 5), "ladder": (10, 256, None, 5),
             "d1": (2, 37, 53, 1), "d6": (1, 37, 53, 6), "d8": (2, 37, 53, 8),
             "d9": (2, 37, 53, 9), "d17": (1, 37, 53, 17), "m4": (8, 37, 52, 5),
             "same_d9": (2, 45, None, 9), "same_d17": (1, 30, None, 17),
             "unaligned": (2, 37, 52, 5), "unaligned_m53": (1, 29, 53, 6),
             "b10_ragged": (10, 19, 133, 5), "same_d1": (2, 70, None, 1),
             "same_d3": (4, 80, None, 3), "same_d8": (2, 130, None, 8),
             "same_ragged": (2, 70, None, 5), "same_130": (1, 130, None, 5)}


def _bwd_case(case, dev):
    """(theta (B, D), X, Y or None for the training matrix, G (B, N, M),
    the gradients asked for) for one case the backward kernel must handle."""
    r = np.random.default_rng(7)
    B, N, M, D = BWD_CASES[case]
    theta = 10 ** r.uniform(-1, 2, (B, D))
    X = r.uniform(0, 1, (N, D))
    Y = None if M is None else r.uniform(0, 1, (M, D))
    G = r.standard_normal((B, N, N if M is None else M))
    if case in ("masked", "fit", "ladder"):  # as _masked_correlation: padding and diagonal
        mask = (np.arange(N) < N - 9).astype(float)
        G = G * (np.outer(mask, mask) * (1.0 - np.eye(N)))
    if case == "gated":
        theta[0, 1], theta[1, 3] = 0.0, -0.5
    if case in ("d9", "b10_ragged"):
        theta[0, 0], theta[-1, -1] = 0.0, -0.5
    if case == "duplicates":
        X[5] = X[3]
        X[11] = X[3]
    needs = {"fit": [(True, False, False)], "ladder": [(True, False, False)],
             "argmax": [(False, True, False)], "ensemble": [(False, True, False)]}.get(
        case, ALL_NEEDS)

    def t(a):
        return None if a is None else torch.tensor(a, dtype=torch.float32, device=dev)

    G = t(G)
    if case.startswith("unaligned"):  # a contiguous view one float past a 16-byte boundary
        flat = torch.empty(G.numel() + 1, dtype=torch.float32, device=dev)
        flat[1:] = G.flatten()
        G = flat[1:].view(G.shape)
        assert G.is_contiguous() and G.data_ptr() % 16 != 0
    return t(theta), t(X), t(Y), G, needs


@pytest.mark.parametrize("nu", NUS)
@pytest.mark.parametrize("case", list(BWD_CASES))
def test_matern_bwd_kernel_matches_twin(dev, case, nu):
    """The backward kernel against matern_bwd_plain run in float64 on the same
    inputs (the float32 twin's GEMM expansion of r2 cancels, worst near
    r = 0 for nu = 1/2), within 1e-4 relative to the largest magnitude, for
    every combination of gradients asked; bit-identical from call to call;
    one count per call; exact zeros where theta <= 0."""
    theta, X, Y, G, needs = _bwd_case(case, dev)
    same = Y is None
    Yv = X if same else Y
    code = _nu_code(nu)
    K64 = matern_plain(theta.double(), X.double(), Yv.double(), nu=nu, sym=same)
    for need in needs:
        before = matern_fused.bwd_launches
        got = matern_bwd_fused(theta, X, Yv, G, code, same, same, need)
        again = matern_bwd_fused(theta, X, Yv, G, code, same, same, need)
        torch.cuda.synchronize()
        assert matern_fused.bwd_launches == before + 2
        want = matern_bwd_plain(theta.double(), X.double(), Yv.double(), K64, G.double(), code,
                                same, same, need)
        for a, a2, w, asked in zip(got, again, want, (need[0], need[1], need[2] and not same)):
            assert (a is not None) == asked and (w is not None) == asked
            if a is None:
                continue
            assert torch.equal(a, a2)
            assert bool(torch.isfinite(a).all())
            assert float((a.double() - w).abs().max() / w.abs().max()) < 1e-4
        if need[0]:
            assert bool((got[0][theta <= 0] == 0).all())


def _launches_a_call(fn, calls=10, sessions=5):
    """(kernel launches a call of fn(), what each profiler session saw): the
    most over `sessions` sessions, since the profiler now and then drops a
    session's kernel records, some or all (it never adds one)."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(sessions):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        seen.append((len(names), sorted(set(n.split("(")[0][-40:] for n in names))))
    if not max(n for n, _ in seen):
        pytest.fail(f"the profiler traced no kernel in {sessions} sessions")
    return max(n for n, _ in seen) / calls, seen


@pytest.mark.parametrize("case", ["fit", "ladder", "argmax", "ensemble", "d9", "same_d9",
                                  "unaligned"])
def test_matern_bwd_is_one_launch_a_call(dev, case):
    """Every backward call is one kernel launch, as the profiler counts it,
    whatever the shapes and the gradients asked."""
    theta, X, Y, G, needs = _bwd_case(case, dev)
    same = Y is None
    for need in needs:
        n, seen = _launches_a_call(lambda: matern_bwd_fused(theta, X, X if same else Y, G, 3, same,
                                                            same, need))
        assert n == 1.0, seen


@pytest.mark.parametrize("case", ["fit", "ensemble", "d17", "same"])
def test_matern_bwd_bit_identical_over_100_calls(dev, case):
    """100 calls in a row give the same bits: the arrival counter is back to
    0 after every call, and the partials are summed in a fixed order."""
    from bayesian_optimization_tpu_torch.ops.hopper_kernels import _launch_context

    theta, X, Y, G, needs = _bwd_case(case, dev)
    same = Y is None
    need = needs[-1]
    first = matern_bwd_fused(theta, X, X if same else Y, G, 5, same, same, need)
    for _ in range(100):
        again = matern_bwd_fused(theta, X, X if same else Y, G, 5, same, same, need)
        for a, b in zip(first, again):
            assert (a is None and b is None) or torch.equal(a, b)
    torch.cuda.synchronize()
    assert not bool(_launch_context(X)[1].any())


@pytest.mark.parametrize("case", ["fit", "ensemble", "d9"])
def test_matern_bwd_two_streams_in_flight(dev, case):
    """Calls in flight at once on two streams (each with its own arrival
    counter) give the bits of the same calls made one after another."""
    theta, X, Y, G, needs = _bwd_case(case, dev)
    same = Y is None
    Yv = X if same else Y
    need = needs[-1]
    serial = [matern_bwd_fused(theta, X, Yv, G, c, same, same, need) for c in (3, 5)]
    streams = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(dev))
    outs = []
    for _ in range(20):  # alternate, so that the two streams' launches overlap
        for s, c in zip(streams, (3, 5)):
            with torch.cuda.stream(s):
                outs.append((c, matern_bwd_fused(theta, X, Yv, G, c, same, same, need)))
    torch.cuda.synchronize()
    for c, got in outs:
        for a, b in zip(got, serial[c == 5]):
            assert (a is None and b is None) or torch.equal(a, b)


def _check_whiten(R, B):
    """whiten_fused against the twin: L within 1e-4 relative, W within 1e-3,
    the diagonal-block inverses within 1e-3 of I, exact zeros above L's
    diagonal, and the caller's R untouched."""
    R_before = R.clone()
    before = whiten_fused.launches
    d, W, piv, L, Dinv = whiten_fused(R, B)
    torch.cuda.synchronize()
    assert whiten_fused.launches == before + 1
    assert torch.equal(R, R_before)
    d0, W0, piv0, L0, Dinv0 = whiten_plain(R, B)
    Bt, n = R.shape[:2]
    T = min(n, 128)
    assert Dinv.shape == Dinv0.shape == (Bt, n // T, T, T)
    assert float((L - L0).abs().max() / L0.abs().max()) < 1e-4
    assert float((d - d0).abs().max()) < 1e-4
    assert float((W - W0).abs().max()) < 1e-3 * max(1.0, float(W0.abs().max()))
    assert bool(torch.all(piv > 0)) and float(((piv - piv0) / piv0).abs().max()) < 1e-2
    for k in range(n // T):
        blk = L[:, k * T:(k + 1) * T, k * T:(k + 1) * T]
        eye = torch.eye(T, device=R.device)
        assert float((Dinv[:, k] @ blk - eye).abs().max()) < 1e-3
        assert float(torch.triu(Dinv[:, k], 1).abs().max()) == 0.0
    assert float(torch.triu(L, 1).abs().max()) == 0.0


@pytest.mark.parametrize("batch", [1, 2, 10])
@pytest.mark.parametrize("n", [1, 16, 37, 64, 100, 128, 384, 1024])
def test_whiten_kernel_matches_twin(dev, n, batch):
    R = torch.tensor(_kernel_like(n, batch, seed=n), device=dev)
    B = torch.tensor(np.random.default_rng(n).standard_normal((batch, n, 3)), dtype=torch.float32, device=dev)
    _check_whiten(R, B)


def test_whiten_kernel_hybrid_panel_shape(dev):
    """The hybrid factorisation's call: a 1024 block against its subdiagonal
    panel as extra RHS rows (here the panel of a 2048 matrix, plus y)."""
    R = torch.tensor(_kernel_like(2048, 2, seed=7), device=dev)
    S = R[:, :1024, :1024].contiguous()
    B = torch.cat([R[:, 1024:, :1024].mT, torch.ones((2, 1024, 1), device=dev)], dim=-1)
    _check_whiten(S, B.contiguous())


def test_whiten_kernel_nan_lane(dev):
    """A NaN in one lane's lower triangle makes that lane's pivot NaN and
    leaves the other lanes as they were."""
    R = _kernel_like(256, 3, seed=4)
    R[1, 200, 7] = R[1, 7, 200] = np.nan
    R = torch.tensor(R, device=dev)
    _, _, piv, L, _ = whiten_fused(R, torch.ones(3, 256, 1, device=dev))
    torch.cuda.synchronize()
    assert math.isnan(float(piv[1]))
    assert float(piv[0]) > 0.0 and float(piv[2]) > 0.0
    for b in (0, 2):
        assert float((L[b] - torch.linalg.cholesky(R[b])).abs().max()) < 1e-4


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


# (N queries, M training rows, D): the batch and engine paths' cross
# matrices -- 8 criteria x 25 restarts of the batched L-BFGS, a CMA/SMC
# generation of 32 chains, a MIES generation on parity config 4's mixed
# space (6 embedded features)
ENGINE_SHAPES = [(200, 1024, 5), (32, 1024, 5), (60, 1024, 6)]


@pytest.mark.parametrize("nu", NUS)
@pytest.mark.parametrize("shape", ENGINE_SHAPES)
def test_matern_kernel_engine_shapes(dev, nu, shape):
    """Forward against the twin (5e-6) and the dX backward against the twin
    in float64 (1e-4 relative), one theta vector as the argmax gives it."""
    N, M, D = shape
    r = np.random.default_rng(N + D)
    theta = torch.tensor(10 ** r.uniform(-1, 2, (1, D)), dtype=torch.float32, device=dev)
    X = torch.tensor(r.uniform(0, 1, (N, D)), dtype=torch.float32, device=dev)
    Y = torch.tensor(r.uniform(0, 1, (M, D)), dtype=torch.float32, device=dev)
    K = matern_fused(theta[0], X, Y, nu=nu)
    assert float((K - matern_plain(theta[0], X, Y, nu=nu)).abs().max()) < 5e-6
    G = torch.tensor(r.standard_normal((1, N, M)), dtype=torch.float32, device=dev)
    code = _nu_code(nu)
    _, g_x, _ = matern_bwd_fused(theta, X, Y, G, code, False, False, (False, True, False))
    K64 = matern_plain(theta.double(), X.double(), Y.double(), nu=nu)
    _, w_x, _ = matern_bwd_plain(theta.double(), X.double(), Y.double(), K64, G.double(), code,
                                 False, False, (False, True, False))
    torch.cuda.synchronize()
    assert float((g_x.double() - w_x).abs().max() / w_x.abs().max()) < 1e-4


# (lanes B, n, D): the training matrices the new paths fit -- the parity
# configs' small buckets (10 starts at 16 and 64 rows, D = 5 and the mixed
# space's D = 6), the mixed space's ladder at n = 1000 (its own compile-time
# D = 6 variant of the symmetric kernel), 10 lanes at 1024 rows, D = 6, and
# the samplers' 8 chains on the n/4 warm-up subset and on all 1024 rows
FIT_SHAPES = [(10, 16, 5), (10, 64, 5), (10, 16, 6), (10, 64, 6), (10, 256, 6), (6, 512, 6),
              (2, 1024, 6), (10, 1024, 6), (8, 256, 5), (8, 1024, 5)]


@pytest.mark.parametrize("nu", NUS)
@pytest.mark.parametrize("shape", FIT_SHAPES)
def test_matern_kernel_fit_shapes(dev, nu, shape):
    """The training matrix against the twin (5e-6, the exact unit diagonal)
    and the dtheta backward against the twin in float64 (1e-4 relative),
    G masked as _masked_correlation masks it."""
    B, N, D = shape
    r = np.random.default_rng(B + N + D)
    theta = torch.tensor(10 ** r.uniform(-1, 2, (B, D)), dtype=torch.float32, device=dev)
    X = torch.tensor(r.uniform(0, 1, (N, D)), dtype=torch.float32, device=dev)
    K = matern_fused(theta, X, nu=nu)
    torch.cuda.synchronize()
    assert float((K - matern_plain(theta, X, nu=nu)).abs().max()) < 5e-6
    assert float((K.diagonal(dim1=-2, dim2=-1) - 1.0).abs().max()) == 0.0
    mask = (np.arange(N) < N - N // 4).astype(float)
    G = torch.tensor(r.standard_normal((B, N, N)) * (np.outer(mask, mask) * (1.0 - np.eye(N))),
                     dtype=torch.float32, device=dev)
    code = _nu_code(nu)
    g_t, _, _ = matern_bwd_fused(theta, X, X, G, code, True, True, (True, False, False))
    K64 = matern_plain(theta.double(), X.double(), X.double(), nu=nu, sym=True)
    w_t, _, _ = matern_bwd_plain(theta.double(), X.double(), X.double(), K64, G.double(), code,
                                 True, True, (True, False, False))
    torch.cuda.synchronize()
    assert float((g_t.double() - w_t).abs().max() / w_t.abs().max()) < 1e-4


# the cell f8d20-mle.seq's shapes: the warm refit's 2 lanes at bucket 4096
# (1800 live rows, the rest padding) and an argmax trip's 100 lanes against
# them, 20 features (the chunked paths past 8)
D20_SHAPES = [(2, 4096, None), (1, 100, 4096)]


@pytest.mark.parametrize("nu", NUS)
@pytest.mark.parametrize("shape", D20_SHAPES, ids=str)
def test_matern_kernel_d20_cell_shapes(dev, nu, shape):
    """The forward against the twin (5e-6; the exact unit diagonal of the
    training matrix) and the backward the path asks there (the fit's
    dtheta of K(X, X), G masked as _masked_correlation masks it; the
    argmax's dX) against the twin in float64 (1e-4 relative). theta as a
    fit in 20 features leaves it (log10 in [-2, 0]: r^2 ~ 1, so K spans
    its range)."""
    B, N, M = shape
    r = np.random.default_rng(20 + N)
    theta = torch.tensor(10 ** r.uniform(-2, 0, (B, 20)), dtype=torch.float32, device=dev)
    X = torch.tensor(r.uniform(0, 1, (N, 20)), dtype=torch.float32, device=dev)
    same = M is None
    Y = X if same else torch.tensor(r.uniform(0, 1, (M, 20)), dtype=torch.float32, device=dev)
    K = matern_fused(theta if same else theta[0], X, None if same else Y, nu=nu)
    torch.cuda.synchronize()
    assert K.shape == ((B, N, N) if same else (N, M))
    K_ref = matern_plain(theta if same else theta[0], X, None if same else Y, nu=nu)
    assert float((K - K_ref).abs().max()) < 5e-6
    if same:
        assert float((K.diagonal(dim1=-2, dim2=-1) - 1.0).abs().max()) == 0.0
        mask = (np.arange(N) < 1800).astype(float)
        G = r.standard_normal((B, N, N)) * (np.outer(mask, mask) * (1.0 - np.eye(N)))
    else:
        G = r.standard_normal((B, N, M))
    G = torch.tensor(G, dtype=torch.float32, device=dev)
    need = (True, False, False) if same else (False, True, False)
    code = _nu_code(nu)
    got = matern_bwd_fused(theta, X, Y, G, code, same, same, need)
    K64 = matern_plain(theta.double(), X.double(), Y.double(), nu=nu, sym=same)
    want = matern_bwd_plain(theta.double(), X.double(), Y.double(), K64, G.double(), code, same,
                            same, need)
    torch.cuda.synchronize()
    a, w = (got[0], want[0]) if same else (got[1], want[1])
    assert bool(torch.isfinite(a).all())
    assert float((a.double() - w).abs().max() / w.abs().max()) < 1e-4


@pytest.mark.parametrize("nu", NUS)
def test_matern_kernel_ensemble_query_shape(dev, nu):
    """The ensemble predict's cross matrices: 8 members' theta, 25 queries
    against 1024 training rows, one launch. The forward against the twin
    (5e-6) and the query gradient, summed over the 8 lanes, against the twin
    in float64 (1e-4 relative)."""
    r = np.random.default_rng(8)
    theta = torch.tensor(10 ** r.uniform(-1, 2, (8, 5)), dtype=torch.float32, device=dev)
    Xq = torch.tensor(r.uniform(0, 1, (25, 5)), dtype=torch.float32, device=dev)
    X = torch.tensor(r.uniform(0, 1, (1024, 5)), dtype=torch.float32, device=dev)
    K = matern_fused(theta, Xq, X, nu=nu)
    assert K.shape == (8, 25, 1024)
    assert float((K - matern_plain(theta, Xq, X, nu=nu)).abs().max()) < 5e-6
    G = torch.tensor(r.standard_normal((8, 25, 1024)), dtype=torch.float32, device=dev)
    code = _nu_code(nu)
    _, g_x, _ = matern_bwd_fused(theta, Xq, X, G, code, False, False, (False, True, False))
    K64 = matern_plain(theta.double(), Xq.double(), X.double(), nu=nu)
    _, w_x, _ = matern_bwd_plain(theta.double(), Xq.double(), X.double(), K64, G.double(), code,
                                 False, False, (False, True, False))
    torch.cuda.synchronize()
    assert g_x.shape == (25, 5)
    assert float((g_x.double() - w_x).abs().max() / w_x.abs().max()) < 1e-4


@pytest.mark.parametrize("n", [256, 1024])
def test_whiten_kernel_ensemble_shapes(dev, n):
    """8 chains' factorisations: every leapfrog's likelihood on the n/4
    warm-up subset (256) and on all rows (1024)."""
    R = torch.tensor(_kernel_like(n, 8, seed=n + 8), device=dev)
    B = torch.tensor(np.random.default_rng(n).standard_normal((8, n, 2)), dtype=torch.float32, device=dev)
    _check_whiten(R, B)


def test_chol_inv_whiten_ensemble_state(dev):
    """The stacked posterior state of 8 members at 1024 rows: (L, L^-1, W,
    piv) of chol_inv_whiten on the card against its plain path (whiten_plain
    and the same block inversion) on the same card; L within 1e-4 and L^-1
    within 1e-3 relative, L^-1 L within 1e-3 of I."""
    from bayesian_optimization_tpu_torch.ops.hopper_kernels import whiten_plain as plain
    from bayesian_optimization_tpu_torch.ops.linalg import _block_tri_inv, chol_inv_whiten

    R = torch.tensor(_kernel_like(1024, 8, seed=81), device=dev)
    B = torch.tensor(np.random.default_rng(81).standard_normal((1024, 2)), dtype=torch.float32, device=dev)
    before = whiten_fused.launches
    L, L_inv, W, piv = chol_inv_whiten(R, B)
    torch.cuda.synchronize()
    assert whiten_fused.launches == before + 1
    _, W0, piv0, L0, Dinv0 = plain(R, B.expand(8, 1024, 2))
    L_inv0 = _block_tri_inv(L0, Dinv0)
    assert float((L - L0).abs().max() / L0.abs().max()) < 1e-4
    assert float((L_inv - L_inv0).abs().max() / L_inv0.abs().max()) < 1e-3
    assert float((W - W0).abs().max()) < 1e-3 * max(1.0, float(W0.abs().max()))
    eye = torch.eye(1024, device=dev)
    assert float((L_inv @ L - eye).abs().max()) < 1e-3
    assert bool((piv > 0).all())


@pytest.mark.parametrize("method", ["BFGS", "OnePlusOne_Cholesky_CMA", "SMC"])
def test_batch_argmax_launches_the_kernels(dev, method):
    """AcquisitionArgmax.batch on the card: 3 MGFI criteria as one
    population; the Matern forward launches on every engine, its backward
    on the batched L-BFGS; each value is the CPU criterion's at its winner."""
    from bayesian_optimization_tpu_torch import AcquisitionArgmax, GaussianProcess, RealSpace
    from bayesian_optimization_tpu_torch.models.trend import constant_trend

    r = np.random.default_rng(0)
    X = r.uniform(0, 1, (60, 5))
    y = ((X - 0.35) ** 2).sum(1)
    y = (y - y.mean()) / y.std()
    gp = GaussianProcess(mean=constant_trend(5), thetaL=1e-3 * np.ones(5), thetaU=1e3 * np.ones(5),
                         nugget=1e-6, random_state=0, device=dev)
    gp.fit(X, y)
    enc = RealSpace([[0.0, 1.0]] * 5).encoding()
    pars = [{"plugin": float(y.min()), "t": t} for t in (0.5, 1.0, 2.0)]
    fwd, bwd = matern_fused.launches, matern_fused.bwd_launches
    us, vals = AcquisitionArgmax(enc, method=method, n_restart=8, seed=0, device=dev).batch(
        gp.posterior, gp.config, "MGFI", pars)
    assert matern_fused.launches > fwd
    assert (matern_fused.bwd_launches > bwd) == (method == "BFGS")
    cpu = GaussianProcess(thetaL=1e-3 * np.ones(5), thetaU=1e3 * np.ones(5), device="cpu")
    cpu.load_fitted(gp.theta_, {k: v.cpu().numpy() for k, v in gp.posterior._asdict().items()},
                    gp.config._asdict())
    from bayesian_optimization_tpu_torch.optim.argmax import make_unit_criterion

    for u, v, p in zip(us, vals, pars):
        crit = make_unit_criterion(enc, cpu.posterior, cpu.config, "MGFI",
                                   {k: torch.tensor(x) for k, x in p.items()})
        with torch.no_grad():
            want = float(crit(torch.tensor(u[None], dtype=torch.float32))[0])
        assert abs(v - want) <= 1e-4 * abs(want), (v, want)


def test_nuts_fit_and_ensemble_argmax_launch_the_kernels(dev):
    """A NUTS fit (n = 60, d = 5, 8 chains) and the BFGS EI argmax over its
    ensemble on the card: every kernel launches on the fit, the Matern
    forward and backward on the argmax, and the mixture at 16 points agrees
    with the same state's on the CPU (1e-4 relative)."""
    from bayesian_optimization_tpu_torch import AcquisitionArgmax, GaussianProcess, RealSpace
    from bayesian_optimization_tpu_torch.models.trend import constant_trend
    from bayesian_optimization_tpu_torch.ops.hopper_kernels import reset_launch_counts

    r = np.random.default_rng(0)
    X = r.uniform(0, 1, (60, 5))
    y = ((X - 0.35) ** 2).sum(1)
    y = (y - y.mean()) / y.std()
    gp = GaussianProcess(mean=constant_trend(5), thetaL=1e-3 * np.ones(5), thetaU=1e3 * np.ones(5),
                         nugget=1e-6, random_state=0, optimizer="NUTS", device=dev)
    gp.hmc_warmup, gp.n_ensemble = 16, 8
    reset_launch_counts()
    gp.fit(X, y)
    assert matern_fused.launches > 0 and matern_fused.bwd_launches > 0 and whiten_fused.launches > 0
    assert gp.config.n_ensemble == 8 and gp.posterior.L.shape == (8, 64, 64)
    reset_launch_counts()
    u, v = AcquisitionArgmax(RealSpace([[0.0, 1.0]] * 5).encoding(), method="BFGS", n_restart=8,
                             seed=0, device=dev)(gp.posterior, gp.config, "EI", {"plugin": float(y.min())})
    assert matern_fused.launches > 0 and matern_fused.bwd_launches > 0 and np.isfinite(v)
    cpu = GaussianProcess(thetaL=1e-3 * np.ones(5), thetaU=1e3 * np.ones(5), device="cpu")
    cpu.load_fitted(gp.theta_, {k: v.cpu().numpy() for k, v in gp.posterior._asdict().items()},
                    gp.config._asdict())
    Xq = r.uniform(0, 1, (16, 5))
    (mu, var), (mu0, var0) = gp.predict(Xq, eval_MSE=True), cpu.predict(Xq, eval_MSE=True)
    assert np.abs(mu - mu0).max() <= 1e-4 * np.abs(mu0).max()
    assert np.abs(var - var0).max() <= 1e-4 * np.abs(var0).max()


@pytest.mark.parametrize("batch, n", [(8, 1024), (2, 256), (2, 2048)])
def test_whiten_gradient_against_float64(dev, batch, n):
    """The gradient of whiten (the kernel's forward, the backward over its
    Dinv: the explicit inverses of L's 1024-wide diagonal blocks, then
    GEMMs) against float64 autograd through torch's Cholesky on the card,
    within 1e-3 of the largest entry (tests/test_linalg.py's tolerance for
    the JAX VJP); no cuBLAS trsm runs in the backward."""
    from torch.autograd import DeviceType

    from bayesian_optimization_tpu_torch.ops.linalg import whiten

    R = torch.tensor(_kernel_like(n, batch, seed=n + batch), device=dev)
    B = torch.tensor(np.random.default_rng(n).standard_normal((batch, n, 2)), dtype=torch.float32,
                     device=dev)
    Rt = R.clone().requires_grad_(True)
    d, W, piv = whiten(Rt, B)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        (torch.log(d).sum() + (W ** 2).sum()).backward()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert not any("trsm" in k for k in names), names
    R64 = R.double().requires_grad_(True)
    L64 = torch.linalg.cholesky(R64)
    W64 = torch.linalg.solve_triangular(L64, B.double(), upper=False)
    (torch.log(L64.diagonal(dim1=-2, dim2=-1)).sum() + (W64 ** 2).sum()).backward()
    assert bool((piv > 0).all())
    assert float((Rt.grad.double() - R64.grad).abs().max() / R64.grad.abs().max()) < 1e-3


def test_whiten_parts_at_the_cell_bucket(dev):
    """The factorisation of the cell f8d20-mle.seq's warm refit as the size
    bucket laid it out: (2, 4096) with 1800 live rows, the padding
    decoupled as _masked_correlation leaves it, through `_whiten_parts` (the
    hybrid: 4 superpanels, the first solving 3,072 columns of C^T beside
    B). L and W no farther from float64 than 4 times `whiten_plain`'s own
    float32 error (cuSOLVER on the card; the Schur updates round once more
    a panel), the pivots within 1e-3 of its, Dinv inverting L's 128-wide
    blocks; inside a phase one `linalg.hybrid` span and 4 panels counted.
    The gradient through the superpanel backward within 1e-3 of float64
    autograd (as at (8, 1024) above)."""
    _check_whiten_parts_with_padding(dev, 4096, 1800)


def test_whiten_parts_at_the_cell_layout(dev):
    """The same at the fit's layout, the next 128-multiple: (2, 1920) with
    1800 live rows, 2 superpanels (1024 + 896), the same limits."""
    _check_whiten_parts_with_padding(dev, 1920, 1800)


def _check_whiten_parts_with_padding(dev, n, live):
    from bayesian_optimization_tpu_torch.ops.linalg import SUPER, _whiten_parts, whiten
    from bayesian_optimization_tpu_torch.utils import logging as tracing
    from bayesian_optimization_tpu_torch.utils.logging import PhaseTimer

    panels = -(-n // SUPER)
    R = torch.eye(n).repeat(2, 1, 1)
    R[:, :live, :live] = torch.tensor(_kernel_like(live, 2, seed=18))
    R = R.to(dev)
    B = torch.tensor(np.random.default_rng(18).standard_normal((2, n, 2)), dtype=torch.float32)
    B[:, live:] = 0.0
    B = B.to(dev)
    timer = PhaseTimer()
    token = tracing._PHASE.set((timer, "fit"))
    try:
        before = whiten_fused.launches
        d, W, piv, L, Dinv = _whiten_parts(R, B)
        torch.cuda.synchronize()
    finally:
        tracing._PHASE.reset(token)
    snap = timer.snapshot()
    assert whiten_fused.launches == before + panels
    assert snap["fit/linalg.hybrid:n"] == 1 and snap["fit/linalg.hybrid_panels"] == panels
    _, W0, piv0, L0, _ = whiten_plain(R, B)
    L64 = torch.linalg.cholesky(R.double())
    W64 = torch.linalg.solve_triangular(L64, B.double(), upper=False)

    def rel(a, b):
        return float((a.double() - b).abs().max() / b.abs().max())

    assert rel(L, L64) <= 4.0 * rel(L0, L64) and rel(W, W64) <= 4.0 * rel(W0, W64)
    assert bool((piv > 0).all()) and float(((piv - piv0) / piv0).abs().max()) < 1e-3
    assert Dinv.shape == (2, n // 128, 128, 128)
    eye = torch.eye(128, device=dev)
    for k in range(n // 128):
        blk = L[:, k * 128:(k + 1) * 128, k * 128:(k + 1) * 128]
        assert float((Dinv[:, k] @ blk - eye).abs().max()) < 1e-3
    assert float(torch.triu(L, 1).abs().max()) == 0.0
    Rt = R.clone().requires_grad_(True)
    d, W, _ = whiten(Rt, B)
    (torch.log(d).sum() + (W ** 2).sum()).backward()
    R64 = R.double().requires_grad_(True)
    L64 = torch.linalg.cholesky(R64)
    W64 = torch.linalg.solve_triangular(L64, B.double(), upper=False)
    (torch.log(L64.diagonal(dim1=-2, dim2=-1)).sum() + (W64 ** 2).sum()).backward()
    assert float((Rt.grad.double() - R64.grad).abs().max() / R64.grad.abs().max()) < 1e-3


def test_d20_fit_at_the_layout_keeps_the_bucket_likelihood(dev, monkeypatch):
    """A 20-D fit at n = 1800 (the cell f8d20-mle.seq's size) lays its data
    out at 1920 rows: every factorisation of the fit is a hybrid at 1920,
    the posterior has 1920 rows, and the fit's log likelihood equals, within
    the cell's `ll_gap` limit (2e-6 a row), the likelihood at the same
    hyperparameters on the bucket's 4096 rows on the card and in float64."""
    from bayesian_optimization_tpu_torch.models import GaussianProcess, constant_trend
    from bayesian_optimization_tpu_torch.models.likelihood import neg_log_likelihood
    from bayesian_optimization_tpu_torch.ops import linalg
    from bench_port.bbob import BBOBFunction

    D, n = 20, 1800
    rng = np.random.default_rng(1800)
    U = rng.uniform(0, 1, (n, D))
    y = BBOBFunction(8, D, 7)(-5.0 + 10.0 * U)
    y = ((y - y.mean()) / y.std()).reshape(-1, 1)
    shapes = []
    real = linalg._factor_hybrid
    monkeypatch.setattr(linalg, "_factor_hybrid", lambda *a: shapes.append(a[0].shape) or real(*a))
    gp = GaussianProcess(mean=constant_trend(D), corr="matern", thetaL=1e-2 * np.ones(D),
                         thetaU=1e4 * np.ones(D), nugget=1e-6, random_start=4, max_iter=8,
                         random_state=0, device=dev)
    gp.fit(U, y)
    assert shapes and all(s[-1] == 1920 for s in shapes)
    assert gp.posterior.X.shape[0] == 1920

    def ll_at(rows, dtype, device):
        Xp, Yp, mask = np.zeros((rows, D)), np.zeros((rows, 1)), np.zeros(rows)
        Xp[:n], Yp[:n], mask[:n] = U, y, 1.0
        X_, Y_, m_ = (torch.tensor(a, dtype=dtype, device=device) for a in (Xp, Yp, mask))
        par = torch.tensor(gp._map_par_log10, dtype=dtype, device=device)
        with torch.no_grad():
            nll = neg_log_likelihood(par, X_, Y_, m_[:, None], m_, float(n), gp.noise_var,
                                     torch.zeros(1, 1, dtype=dtype, device=device), gp.config)
        return -float(nll)

    ll_bucket, ll64 = ll_at(4096, torch.float32, dev), ll_at(1920, torch.float64, "cpu")
    assert abs(gp.log_likelihood_ - ll_bucket) / n < 2e-6
    assert abs(gp.log_likelihood_ - ll64) / n < 2e-6 and abs(ll_bucket - ll64) / n < 2e-6


@pytest.mark.parametrize("log10_theta", [-0.5, -1.0, -1.5])
@pytest.mark.parametrize("solver", ["trsm", "substitution", "inverse"])
def test_whiten_backward_solvers_at_ill_conditioned_r(dev, solver, log10_theta):
    """At the conditioning the fits reach with theta at its bounds (R
    (2, 1024), Matern-3/2, nugget 1e-6: cond 4e6 to 1.5e8), the VJP on the
    kernel's float32 factor with each L^T solver (cuBLAS trsm, the blocked
    substitution over Dinv, the backward's explicit inverse) is within 1e-5
    of the float64 VJP of that factor: the solver adds nothing to the
    float32 factor's own error. whiten's gradient is no farther from float64
    autograd than the trsm backward's."""
    from bayesian_optimization_tpu_torch.ops.linalg import _whiten_parts, whiten, whiten_vjp
    from bayesian_optimization_tpu_torch.tools.whiten_bwd_variants import SOLVERS, ill_conditioned

    R64 = ill_conditioned(2, 1024, log10_theta, dev)
    B = torch.tensor(np.random.default_rng(1).standard_normal((2, 1024, 2)), device=dev)
    Rr = R64.clone().requires_grad_(True)
    L64 = torch.linalg.cholesky(Rr)
    W64 = torch.linalg.solve_triangular(L64, B, upper=False)
    (torch.log(L64.diagonal(dim1=-2, dim2=-1)).sum() + (W64 ** 2).sum()).backward()
    d, W, piv, L, Dinv = _whiten_parts(R64.float(), B.float())
    assert bool((piv > 0).all())
    Ld, Wd = L.double(), W.double()
    own = whiten_vjp(Ld, Wd, SOLVERS["trsm"](Ld, None), 1.0 / d.double(), 2.0 * Wd)[0]
    g = whiten_vjp(L, W, SOLVERS[solver](L, Dinv), 1.0 / d, 2.0 * W)[0].double()
    assert float((g - own).abs().max() / own.abs().max()) < 1e-5

    def rel(a):
        return float((a.double() - Rr.grad).abs().max() / Rr.grad.abs().max())

    Rt = R64.float().requires_grad_(True)
    dt, Wt, _ = whiten(Rt, B.float())
    (torch.log(dt).sum() + (Wt ** 2).sum()).backward()
    trsm = whiten_vjp(L, W, SOLVERS["trsm"](L, Dinv), 1.0 / d, 2.0 * W)[0]
    assert rel(Rt.grad) <= 1.1 * rel(trsm)


@pytest.mark.parametrize("method", ["BFGS", "OnePlusOne_Cholesky_CMA", "SMC", "MIES"])
def test_constrained_argmax_on_the_card(dev, method):
    """AcquisitionArgmax(constraints=...) on the card, every engine: a traced
    inequality (written with numpy) keeps EI's winner feasible, the Matern
    forward launches, and the card's penalized criterion at the winner is
    the CPU path's."""
    from bayesian_optimization_tpu_torch import (
        AcquisitionArgmax, ConstraintProgram, GaussianProcess, RealSpace,
    )
    from bayesian_optimization_tpu_torch.optim.argmax import make_unit_criterion

    r = np.random.default_rng(0)
    X = r.uniform(0, 1, (60, 5))
    y = ((X - 0.7) ** 2).sum(1)
    y = (y - y.mean()) / y.std()
    gp = GaussianProcess(thetaL=1e-3 * np.ones(5), thetaU=1e3 * np.ones(5), random_state=0, device=dev)
    gp.fit(X, y)
    enc = RealSpace([[0.0, 1.0]] * 5).encoding()

    def g(x):
        return np.sum(x) - 1.5

    cp = ConstraintProgram(enc, g=g, device=dev)
    assert cp.traceable
    params = {"plugin": float(y.min()), "_penalty_t": 1e3}
    fwd = matern_fused.launches
    u, v = AcquisitionArgmax(enc, method=method, n_restart=8, seed=0, constraints=cp, device=dev)(
        gp.posterior, gp.config, "EI", params)
    assert matern_fused.launches > fwd and g(u) <= 1e-6
    cpu = GaussianProcess(thetaL=1e-3 * np.ones(5), thetaU=1e3 * np.ones(5), device="cpu")
    cpu.load_fitted(gp.theta_, {k: v_.cpu().numpy() for k, v_ in gp.posterior._asdict().items()},
                    gp.config._asdict())
    crit = make_unit_criterion(enc, cpu.posterior, cpu.config, "EI",
                               {k: torch.tensor(x) for k, x in params.items()},
                               constraints=ConstraintProgram(enc, g=g, device="cpu"))
    with torch.no_grad():
        want = float(crit(torch.tensor(u[None], dtype=torch.float32))[0])
    assert abs(v - want) <= 1e-4 * max(abs(want), 1e-6), (v, want)


def test_pcabo_runs_on_the_card(dev):
    """PCABO on the card (8-D ellipsoid, 3 components, 16 evaluations):
    every kernel launches, every point lies in the box."""
    from bayesian_optimization_tpu_torch import PCABO, RealSpace
    from bayesian_optimization_tpu_torch.ops.hopper_kernels import reset_launch_counts

    def elli(x):
        x = np.asarray(x, dtype=float)
        return float(np.sum(10 ** np.linspace(0, 2, len(x)) * x ** 2))

    opt = PCABO(search_space=RealSpace([[-5.0, 5.0]] * 8, random_seed=0), obj_fun=elli,
                n_components=3, DoE_size=8, max_FEs=16, random_seed=0, device=dev)
    reset_launch_counts()
    opt.run()
    assert matern_fused.launches > 0 and matern_fused.bwd_launches > 0 and whiten_fused.launches > 0
    V = np.asarray(opt.data.values, dtype=float)
    assert opt.eval_count == 16 and V.min() >= -5 - 1e-6 and V.max() <= 5 + 1e-6


def _f64_problem(n=300, d=3, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 1, (n, d))
    return X, np.sin(3 * X).sum(1) + 0.05 * rng.standard_normal(n)


@pytest.mark.parametrize("kernel", ["matern", "absolute_exponential", ("matern", 3.5)])
def test_float64_gp_on_the_card(dev, kernel):
    """The float64 option runs on the card (it once raised there) and takes
    the plain torch stack, chosen by dtype: its likelihood at fixed theta equals the CPU float64 path's
    (1e-10 relative), and neither kernel's counter moves across a fit."""
    from bayesian_optimization_tpu_torch import GaussianProcess
    from bayesian_optimization_tpu_torch.models.likelihood import GPConfig, neg_log_likelihood

    X, y = _f64_problem()
    n_pad = 1024
    Xp = np.zeros((n_pad, 3))
    Xp[:300] = X
    Yp = np.zeros((n_pad, 1))
    Yp[:300, 0] = (y - y.mean()) / y.std()
    mask = (np.arange(n_pad) < 300).astype(float)
    pars = np.random.default_rng(1).uniform(-0.5, 1.0, (4, 4))
    vals = {}
    before = (matern_fused.launches, matern_fused.bwd_launches, whiten_fused.launches)
    for d in ("cpu", dev):
        def t(a):
            return torch.tensor(a, dtype=torch.float64, device=d)

        vals[str(d)] = neg_log_likelihood(t(pars), t(Xp), t(Yp), t(mask[:, None]), t(mask), 300,
                                          1e-6, t(np.zeros((1, 1))), GPConfig(kernel=kernel)).cpu().numpy()
    gp = GaussianProcess(corr=kernel, thetaL=1e-2 * np.ones(3), thetaU=1e2 * np.ones(3),
                         random_start=4, random_state=0, dtype="f64", device=dev).fit(X, y)
    torch.cuda.synchronize()
    assert (matern_fused.launches, matern_fused.bwd_launches, whiten_fused.launches) == before
    assert np.abs(vals["cuda"] - vals["cpu"]).max() <= 1e-10 * np.abs(vals["cpu"]).max()
    assert gp.dtype == torch.float64 and gp.posterior.L.device.type == "cuda"
    assert np.isfinite(gp.log_likelihood_) and gp.posterior.L.dtype == torch.float64


def test_float64_tensors_still_raise_in_the_wrappers(dev):
    X = torch.rand(64, 3, dtype=torch.float64, device=dev)
    with pytest.raises(NotImplementedError, match="float32"):
        matern_fused(torch.ones(3, dtype=torch.float64, device=dev), X)
    R = torch.eye(64, dtype=torch.float64, device=dev)
    with pytest.raises(NotImplementedError, match="float32"):
        whiten_fused(R, X)


@pytest.mark.parametrize("n", [16, 128, 1024])
def test_chol_and_inv_on_the_card(dev, n):
    """chol_and_inv launches whiten_fused and agrees with its CPU path
    (L within 1e-5 relative, L^-1 L within 1e-4 of I), with its VJP."""
    from bayesian_optimization_tpu_torch.ops.linalg import chol_and_inv

    R = _kernel_like(n, 1, 7, jitter=1.0)[0] / 2.0
    before = whiten_fused.launches
    Rd = torch.tensor(R, device=dev, requires_grad=True)
    L, Li, piv = chol_and_inv(Rd)
    (g,) = torch.autograd.grad((L.sum() + Li.sum()), Rd)
    torch.cuda.synchronize()
    assert whiten_fused.launches == before + 1
    Rc = torch.tensor(R, requires_grad=True)
    Lc, Lic, pc = chol_and_inv(Rc)
    (gc,) = torch.autograd.grad((Lc.sum() + Lic.sum()), Rc)
    L64 = np.linalg.cholesky(R.astype(np.float64))
    assert float((L.cpu() - Lc).abs().max()) <= 1e-5 * float(Lc.abs().max())
    assert np.abs(Li.detach().cpu().double().numpy() @ L64 - np.eye(n)).max() < 1e-4
    assert float((g.cpu() - gc).abs().max()) <= 1e-4 * float(gc.abs().max())
    assert float(piv) > 0


def test_forest_grown_on_the_card(dev):
    """A forest grown on the card: the card's traversal equals the CPU's on
    the same forest (1e-6), and a second growth from the seed is
    identical."""
    from bayesian_optimization_tpu_torch import RandomForest
    from bayesian_optimization_tpu_torch.models.random_forest import RFState, rf_predict

    rng = np.random.default_rng(3)
    X = rng.uniform(0, 1, (1000, 6))
    y = np.sin(4 * X).sum(1) + 0.1 * rng.standard_normal(1000)
    rf = RandomForest(feature_space="embedding", random_state=0, device=dev).fit(X, y)
    again = RandomForest(feature_space="embedding", random_state=0, device=dev).fit(X, y)
    for a, b in zip(rf.posterior, again.posterior):
        assert torch.equal(a, b)
    Xq = torch.tensor(rng.uniform(0, 1, (500, 6)), dtype=torch.float32)
    mu_d, var_d = rf_predict(rf.posterior, Xq.to(dev), rf.config)
    cpu = RFState(*(t.cpu() for t in rf.posterior))
    mu_c, var_c = rf_predict(cpu, Xq, rf.config)
    assert float((mu_d.cpu() - mu_c).abs().max()) <= 1e-6
    assert float((var_d.cpu() - var_c).abs().max()) <= 1e-6
    assert rf.posterior.feature.shape[0] == 100 and rf.config.max_depth > 5


# (B, N, M, D, sym): a Hessian's cross matrix (one query, the padded
# training rows), an ensemble's 8 members, D past one 8-feature chunk, a
# ragged batch of rows, a unit diagonal, and 8 members at ragged M (each
# row's pairs split over many blocks)
BWD2_SHAPES = [(1, 1, 1024, 5, False), (8, 1, 1024, 5, False), (1, 1, 300, 11, False),
               (2, 37, 53, 5, False), (2, 40, 40, 3, True), (8, 1, 1021, 5, False),
               (8, 3, 517, 6, False), (8, 2, 1000, 11, False)]


@pytest.mark.parametrize("nu", NUS)
@pytest.mark.parametrize("shape", BWD2_SHAPES, ids=str)
def test_matern_bwd2_kernel_matches_twin(dev, nu, shape):
    """The second-derivative kernel against matern_bwd2_plain run in
    float64 (1e-4 relative, as the backward), both outputs, and two calls
    bit-identical."""
    B, N, M, D, sym = shape
    r = np.random.default_rng(N + M + D)
    theta = torch.tensor(10 ** r.uniform(-1, 1.5, (B, D)), dtype=torch.float32, device=dev)
    X = torch.tensor(r.uniform(0, 1, (N, D)), dtype=torch.float32, device=dev)
    Y = X.clone() if sym else torch.tensor(r.uniform(0, 1, (M, D)), dtype=torch.float32, device=dev)
    G = torch.tensor(r.standard_normal((B, N, M)), dtype=torch.float32, device=dev)
    V = torch.tensor(r.standard_normal((N, D)), dtype=torch.float32, device=dev)
    code = _nu_code(nu)
    before = matern_fused.bwd2_launches
    got = matern_bwd2_fused(theta, X, Y, G, V, code, sym, (True, True))
    again = matern_bwd2_fused(theta, X, Y, G, V, code, sym, (True, True))
    want = matern_bwd2_plain(*(t.double() for t in (theta, X, Y, G, V)), code, sym, (True, True))
    torch.cuda.synchronize()
    assert matern_fused.bwd2_launches == before + 2
    for a, a2, w in zip(got, again, want):
        assert torch.equal(a, a2)
        assert float((a.double() - w).abs().max() / w.abs().max()) < 1e-4


@pytest.mark.parametrize("shape", [(1, 1, 1024, 5), (8, 1, 1024, 5)], ids=str)
def test_matern_bwd2_one_launch_bit_identical(dev, shape):
    """A Hessian row is one launch, as the profiler counts it, and 100 calls
    give the same bits (the row's blocks' partials summed in a fixed order)."""
    B, N, M, D = shape
    g = torch.Generator(device=dev).manual_seed(0)
    theta = 10 ** (torch.rand((B, D), generator=g, device=dev) * 2 - 1)
    X, Y = (torch.rand((k, D), generator=g, device=dev) for k in (N, M))
    G = torch.randn((B, N, M), generator=g, device=dev)
    V = torch.randn((N, D), generator=g, device=dev)

    def call():
        return matern_bwd2_fused(theta, X, Y, G, V, 3, False, (True, True))

    n, seen = _launches_a_call(call)
    assert n == 1.0, seen
    first = call()
    for _ in range(100):
        assert all(torch.equal(a, b) for a, b in zip(first, call()))


def test_matern_second_derivative_on_the_card_refuses(dev):
    """On the card as on the CPU: no second derivative through theta, and
    the kernel refuses a float64 tensor."""
    X = torch.rand(4, 3, device=dev, requires_grad=True)
    Y = torch.rand(9, 3, device=dev)
    theta = torch.ones(3, device=dev, requires_grad=True)
    (gx,) = torch.autograd.grad(matern_fused(theta, X, Y).sum(), X, create_graph=True)
    with pytest.raises(NotImplementedError, match="second derivative"):
        torch.autograd.grad(gx.sum(), X)
    t64 = lambda *shape: torch.rand(*shape, device=dev, dtype=torch.float64)  # noqa: E731
    with pytest.raises(NotImplementedError):
        matern_bwd2_fused(t64(1, 3), t64(4, 3), t64(9, 3), t64(1, 4, 9), t64(4, 3), 3, False,
                          (True, True))


def test_gradient_and_hessian_on_the_card(dev):
    """A float32 Matern GP on the card: gradient (through the Matern
    backward kernel) and Hessian (through the forward, backward and
    second-derivative kernels, the last once per dimension) against the CPU
    path on the same posterior."""
    from bayesian_optimization_tpu_torch import GaussianProcess

    X, y = _f64_problem(200)
    kw = dict(thetaL=1e-2 * np.ones(3), thetaU=1e2 * np.ones(3), random_start=4, random_state=0)
    gp = GaussianProcess(device=dev, **kw).fit(X, y)
    cpu = GaussianProcess(device="cpu", **kw).load_fitted(
        gp.theta_, {k: v.cpu().numpy() for k, v in gp.posterior._asdict().items()}, gp.config._asdict())
    x = np.array([0.3, 0.6, 0.4])
    before = matern_fused.bwd_launches
    for gd, gc in zip(gp.gradient(x), cpu.gradient(x)):
        assert np.abs(gd - gc).max() <= 1e-3 * np.abs(gc).max()
    assert matern_fused.bwd_launches > before
    for of in ("mean", "mse"):
        before = matern_fused.bwd2_launches
        Hd, Hc = gp.Hessian(x, of=of), cpu.Hessian(x, of=of)
        assert matern_fused.bwd2_launches == before + 3
        assert np.abs(Hd - Hc).max() <= 1e-3 * np.abs(Hc).max()


@pytest.mark.parametrize("mb", [3, 4])
@pytest.mark.parametrize("batch, n", [(10, 256), (6, 512), (2, 1024), (1, 1024)])
def test_whiten_kernel_multi_output_rhs(dev, batch, n, mb):
    """A multi-output fit's right-hand sides: m objectives and the constant
    trend, mb = m + 1 = 3 and 4 (rows [n, n + mb) of the workspace)."""
    R = torch.tensor(_kernel_like(n, batch, seed=n + mb), device=dev)
    B = torch.tensor(np.random.default_rng(mb).standard_normal((batch, n, mb)), dtype=torch.float32,
                     device=dev)
    _check_whiten(R, B)


def _mo_problem(n, d, levels, seed):
    X = np.random.default_rng(seed).uniform(0, 1, (n, d))
    F = np.stack([((X - c) ** 2).sum(1) for c in levels], axis=1)
    return X, -(F - F.min(0)) / (F.max(0) - F.min(0))


@pytest.mark.parametrize("m", [2, 3])
def test_ehvi_and_qehvi_on_the_card(dev, m):
    """EHVI and qEHVI on float32 card tensors against the CPU in float64,
    with their gradient in mu."""
    from bayesian_optimization_tpu_torch.ops.box_decomposition import NondominatedPartitioning
    from bayesian_optimization_tpu_torch.ops.ehvi import ehvi, qehvi

    _, y = _mo_problem(200, 3, np.linspace(0.2, 0.8, m), 0)
    part = NondominatedPartitioning(y.min(0) * 0.8 - 1e-6, y)
    r = np.random.default_rng(1)
    mu, sd = r.uniform(-0.6, 0.1, (64, m)), r.uniform(0.01, 0.2, (64, m))
    eps = r.standard_normal((256, 3, m))

    def run(device, dtype):
        t = lambda a: torch.tensor(a, dtype=dtype, device=device)  # noqa: E731
        mu_t = t(mu).requires_grad_(True)
        e = ehvi(mu_t, t(sd), t(part.cell_lower), t(part.cell_upper))
        (g,) = torch.autograd.grad(e.sum(), mu_t)
        qv = qehvi(t(mu[:48].reshape(16, 3, m)), t(sd[:48].reshape(16, 3, m)), t(part.cell_lower),
                   t(part.cell_upper), t(eps))
        return [a.detach().double().cpu().numpy() for a in (e, g, qv)]

    for got, want in zip(run(dev, torch.float32), run("cpu", torch.float64)):
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_mobo_asks_on_the_card(dev):
    """One MOBO ask (2-output GP, BFGS EHVI) and one MOBO_qEHVI ask (q = 2,
    CMA) on the card: every kernel of the fit launches, and the card's
    criterion at each winner is the CPU path's in float64 within 1e-4, or
    within 10 times the CPU float32 path's own error where that is larger
    (this near-interpolating posterior's float32 mean is what limits it).
    That error is float32's rounding of a cancelling sum, which scatters
    from point to point: one point can be a lucky draw of it (6.8e-6 at one
    EHVI maximum, 2.6e-5 at its mirror), so its scale is the largest over
    the winner and 32 points within 1e-2 of it."""
    from bayesian_optimization_tpu_torch import MOBO, MOBO_qEHVI, RealSpace
    from bayesian_optimization_tpu_torch.optim.argmax import make_unit_criterion
    from bayesian_optimization_tpu_torch.ops.hopper_kernels import reset_launch_counts

    X = np.random.default_rng(2).uniform(0, 1, (80, 3))
    F = np.c_[((X - 0.2) ** 2).sum(1), ((X - 0.8) ** 2).sum(1)]
    for cls, q in ((MOBO, 1), (MOBO_qEHVI, 2)):
        opt = cls(search_space=RealSpace([[0.0, 1.0]] * 3, random_seed=0), n_obj=2, n_point=q,
                  DoE_size=10, max_FEs=10 ** 4, random_seed=0, device=dev)
        reset_launch_counts()
        opt.tell(X.tolist(), F)
        assert matern_fused.bwd_launches > 0 and whiten_fused.launches > 0
        if q == 1:
            par, am, name = opt._acq_par_defaults({}), opt._argmax, "EHVI"
        else:
            par, am, name = opt._qehvi_par(q), opt._q_argmax(q), f"qEHVI{q}"
        u, v = am(opt.model.posterior, opt.model.config, name, par)
        near = np.clip(u + np.random.default_rng(3).uniform(-1e-2, 1e-2, (32, u.size)), 0.0, 1.0)
        U = np.vstack([u[None], near])
        cpu = {}
        for dt in (torch.float32, torch.float64):
            post = type(opt.model.posterior)(*(t.cpu().to(dt) for t in opt.model.posterior))
            crit = make_unit_criterion(type(am.encoding)(am.encoding.space, dtype=dt), post,
                                       opt.model.config, name,
                                       {k: torch.tensor(np.asarray(x), dtype=dt) for k, x in par.items()})
            with torch.no_grad():
                cpu[dt] = crit(torch.tensor(U, dtype=dt)).double().numpy()
        want = cpu[torch.float64]
        f32_err = np.abs(cpu[torch.float32] - want) / abs(want[0])
        tol = max(1e-4, 10 * float(f32_err.max()))
        assert v > 0 and abs(v - want[0]) <= tol * abs(want[0]), (name, v, want[0], f32_err.max())
        assert len(opt.ask()) == q


@pytest.mark.parametrize("method", ["BFGS", "OnePlusOne_Cholesky_CMA", "SMC"])
def test_sharded_argmax_on_a_two_entry_mesh(dev, method):
    """The BFGS, CMA and SMC engines with a 10-lane pool split over two
    entries on one card (padded to 10: no zero rows), against the same
    engine unsharded from the same pool and generator: the winner's value
    within 1e-4 relative (float32 lanes round by batch size), the kernels
    launched and the mesh's gathers as the CPU tests hold them."""
    from bayesian_optimization_tpu_torch import GaussianProcess, RealSpace, constant_trend
    from bayesian_optimization_tpu_torch.optim import argmax as am
    from bayesian_optimization_tpu_torch.optim.cma import run_cma
    from bayesian_optimization_tpu_torch.optim.smc import run_smc
    from bayesian_optimization_tpu_torch.ops.hopper_kernels import reset_launch_counts
    from bayesian_optimization_tpu_torch.parallel import make_particle_mesh, shard_population

    rng = np.random.default_rng(0)
    X = rng.uniform(0, 1, (60, 3))
    y = np.sin(3 * X).sum(1)
    gp = GaussianProcess(mean=constant_trend(3), corr="matern", thetaL=1e-3 * np.ones(3),
                         thetaU=1e3 * np.ones(3), nugget=1e-6, random_start=4, random_state=0,
                         device=dev)
    gp.fit(X, (y - y.mean()) / y.std())
    crit = am.make_unit_criterion(RealSpace([[0.0, 1.0]] * 3).encoding(), gp.posterior, gp.config,
                                  "EI", {"plugin": torch.tensor(-1.0, device=dev)})
    mesh = make_particle_mesh(devices=["cuda:0"] * 2)
    x0 = torch.rand((10, 3), generator=torch.Generator().manual_seed(1)).to(dev)
    pop = shard_population(x0, mesh)
    zeros = torch.zeros(3, device=dev)

    def neg(U):
        return -crit(U)

    def gen():
        return torch.Generator(device=dev).manual_seed(5)

    reset_launch_counts()
    with torch.no_grad():
        if method == "BFGS":
            ref = am._bfgs_lanes(crit, x0, 40)[1].max()
            got = am._bfgs_lanes([crit] * 2, pop, 40)[1].max()
            want_gathers = 1
        elif method == "SMC":
            ref = -run_smc(gen(), neg, x0, zeros, zeros + 1.0, 3, 5)[1]
            got = -run_smc(gen(), [neg] * 2, pop, zeros, zeros + 1.0, 3, 5)[1]
            want_gathers = 4
        else:
            ref = -run_cma(gen(), neg, x0, zeros, zeros + 1.0, 30)[1]
            got = -run_cma(gen(), [neg] * 2, pop, zeros, zeros + 1.0, 30)[1]
            want_gathers = 1
    assert mesh.gathers == want_gathers and matern_fused.launches > 0
    assert abs(float(got - ref)) <= 1e-4 * abs(float(ref)), (float(got), float(ref))


# (R, d, m) of the L-BFGS update kernel: the argmax's 25 lanes, the warm
# refit's 2, the cold ladder's first rung, a q = 8 argmax's 200, and wide
# or short-history lanes (d past one and two warps' width, m = 4); the cell
# f8d20-mle.seq's argmax (100 lanes of 20) and warm refit (2 lanes of 21
# hyperparameters: 20 thetas and the process variance)
LBFGS_SHAPES = [(25, 5, 10), (2, 6, 10), (10, 6, 10), (200, 5, 10), (25, 40, 10), (3, 70, 4),
                (100, 20, 10), (2, 21, 10)]
LBFGS_DECISIONS = ("k", "n_probe", "n_accept", "done", "t")
LBFGS_VALUES = ("z", "f", "g", "S", "Y", "rho", "gamma", "p", "gTp")


def _lbfgs_trip(dev, R, d, m, seed, live):
    from test_torch_optimize_update import random_trip
    return random_trip(R, d, m, seed, live=live, dtype=torch.float32, device=dev)


@pytest.mark.parametrize("live", [1.0, 0.5])
@pytest.mark.parametrize("shape", LBFGS_SHAPES, ids=str)
def test_lbfgs_update_kernel_matches_twin(dev, shape, live):
    """One launch against the twin (float32, on the card) on the same random
    states: the same accept, probe, curvature and stall decisions, the
    values within float32 rounding (the moved points, gradients and stored
    pairs exactly), the lanes that are not live untouched, and a second
    launch on the same inputs the same bits."""
    from bayesian_optimization_tpu_torch.ops import hopper_kernels as hk
    from bayesian_optimization_tpu_torch.ops.optimize import LBFGS_C1, lbfgs_update_plain

    R, d, m = shape
    for seed in range(3):
        st, idx, f_a, g_a, z_trial, _ = _lbfgs_trip(dev, R, d, m, seed, live)
        twin, again = (_lbfgs_trip(dev, R, d, m, seed, live)[0] for _ in range(2))
        before = {n: getattr(st, n).clone() for n in LBFGS_DECISIONS + LBFGS_VALUES}
        launches = hk.lbfgs_update_fused.launches
        hk.lbfgs_update_fused(st, idx, f_a, g_a, z_trial, 20, LBFGS_C1)
        hk.lbfgs_update_fused(again, idx, f_a, g_a, z_trial, 20, LBFGS_C1)
        lbfgs_update_plain(twin, idx, f_a, g_a, z_trial, 20)
        torch.cuda.synchronize()
        assert hk.lbfgs_update_fused.launches == launches + 2
        assert torch.equal(st.ws.nan_to_num(nan=7.0), again.ws.nan_to_num(nan=7.0))
        assert torch.equal(st.iws, again.iws)
        for name in LBFGS_DECISIONS + ("z", "g", "S", "Y"):
            assert torch.equal(getattr(st, name), getattr(twin, name)), (seed, name)
        for name in ("f", "rho", "gamma", "p", "gTp"):
            got, want = getattr(st, name), getattr(twin, name)
            scale = want.abs().reshape(R, -1).amax(-1).clamp_min(1.0)
            err = (got - want).abs().reshape(R, -1).amax(-1)
            assert bool((err <= 2e-5 * scale).all()), (seed, name, float((err / scale).max()))
        out = torch.ones(R, dtype=torch.bool, device=dev)
        out[idx] = False
        for name, old in before.items():
            assert torch.equal(getattr(st, name)[out], old[out]), (seed, name)


def _convex_quartic(X):
    w = torch.tensor([1.0, 2.0, 3.0, 5.0, 8.0], dtype=X.dtype, device=X.device)
    return (0.5 * w * (X - 0.5) ** 2 + 0.25 * (X - 0.5) ** 4).sum(-1)


def _rosenbrock(X):
    return (100.0 * (X[:, 1:] - X[:, :-1] ** 2) ** 2 + (1.0 - X[:, :-1]) ** 2).sum(-1)


def _whole_run(fun, x0, max_iter):
    """(objective calls, the batch sizes they saw, `minimize_restarts`'
    result, the phase's counters, kernel launches) of one run in a phase."""
    from bayesian_optimization_tpu_torch.ops import hopper_kernels as hk
    from bayesian_optimization_tpu_torch.ops import optimize
    from bayesian_optimization_tpu_torch.utils import logging as tracing
    from bayesian_optimization_tpu_torch.utils.logging import PhaseTimer

    rows = []

    def counted(X):
        rows.append(X.shape[0])
        return fun(X)

    timer = PhaseTimer()
    launches = hk.lbfgs_update_fused.launches
    token = tracing._PHASE.set((timer, "probe"))
    try:
        res = optimize.minimize_restarts(counted, x0, -3.0, 3.0, max_iter=max_iter)
    finally:
        tracing._PHASE.reset(token)
    torch.cuda.synchronize()
    return rows, res, timer.snapshot(), hk.lbfgs_update_fused.launches - launches


# (objective, steps): a convex quartic, and Rosenbrock's valley part way
# along it (20 steps: the lanes still moving) and at its end (60 steps:
# every lane at a minimum, stepping on in place until its stall exit)
WHOLE_RUNS = [(_convex_quartic, 6), (_rosenbrock, 20), (_rosenbrock, 60)]


@pytest.mark.parametrize("fun, max_iter", WHOLE_RUNS, ids=lambda v: getattr(v, "__name__", str(v)))
def test_lbfgs_whole_run_kernel_against_twin(dev, monkeypatch, fun, max_iter):
    """`minimize_restarts` (25 restarts in 5-D) with the kernel, and with
    its twin in its place: one launch and one `lbfgs.fused_updates` a trip
    with the kernel, none with the twin, and the ends as close as the
    twin's own: within twice the farthest the twin's ends move when each
    start moves by one ulp (8 such runs), plus 8 float32 ulps of the box's
    edge (x) or of the value (f, relative past 1): the float32 path cannot
    tell that from the kernel's other rounding. Where those runs keep the
    twin's trips (the lanes still moving), the kernel keeps them too; at a
    minimum a lane steps on in place until its stall exit, and rounding
    sets how long (Rosenbrock at 60 steps: hundreds of trips either way)."""
    from bayesian_optimization_tpu_torch.ops import optimize

    x0 = torch.rand((25, 5), generator=torch.Generator().manual_seed(3)).to(dev) * 4.0 - 2.0
    rows_k, res_k, snap, fused = _whole_run(fun, x0, max_iter)
    assert fused == len(rows_k) == snap["probe/lbfgs.trips"] == snap["probe/lbfgs.fused_updates"]
    monkeypatch.setattr(optimize, "_update", optimize.lbfgs_update_plain)
    rows_t, res_t, snap, fused = _whole_run(fun, x0, max_iter)
    assert fused == 0 and "probe/lbfgs.fused_updates" not in snap
    assert snap["probe/lbfgs.trips"] == len(rows_t)
    spread_x, spread_f, same_trips = 0.0, 0.0, True
    for s in range(8):
        up = torch.rand(x0.shape, generator=torch.Generator().manual_seed(100 + s)).to(dev) < 0.5
        moved = torch.nextafter(x0, torch.where(up, 9.0, -9.0))
        rows_w, res_w, _, _ = _whole_run(fun, moved, max_iter)
        spread_x = max(spread_x, float((res_w.x - res_t.x).abs().max()))
        spread_f = max(spread_f, float(((res_w.fun - res_t.fun).abs()
                                        / res_t.fun.abs().clamp_min(1.0)).max()))
        same_trips &= rows_w == rows_t
    gap_x = float((res_k.x - res_t.x).abs().max())
    gap_f = float(((res_k.fun - res_t.fun).abs() / res_t.fun.abs().clamp_min(1.0)).max())
    if same_trips:
        assert rows_k == rows_t
    eps = torch.finfo(torch.float32).eps
    assert gap_x <= 2.0 * spread_x + 8 * 3.0 * eps, (gap_x, spread_x)
    assert gap_f <= 2.0 * spread_f + 8 * eps, (gap_f, spread_f)


def test_lbfgs_update_float64_on_the_card_runs_the_twin(dev):
    from bayesian_optimization_tpu_torch.ops import hopper_kernels as hk
    from bayesian_optimization_tpu_torch.ops.optimize import _update, lbfgs_state

    st, idx, f_a, g_a, z_trial, _ = _lbfgs_trip(dev, 25, 5, 10, 0, 0.75)
    st64 = lbfgs_state(st.z.double(), 10)
    launches = hk.lbfgs_update_fused.launches
    _update(st64, idx, f_a.double(), g_a.double(), z_trial.double(), 20)
    assert hk.lbfgs_update_fused.launches == launches
    with pytest.raises(NotImplementedError):
        _update(lbfgs_state(st.z.half(), 10), idx, f_a, g_a, z_trial.half(), 20)

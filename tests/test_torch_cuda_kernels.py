"""The port's CUDA kernels against their plain twins, and the paths that
call them against the CPU path (the twins), on the card.

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
@pytest.mark.parametrize("shape", [(2, 1024, None), (1, 25, 1024), (1, 1024, None), (2, 512, None),
                                   (1, 25, 512)])
def test_matern_kernel_main_path_shapes(dev, nu, shape):
    """The fit's training matrix (2 lanes at n = 1024) and the argmax's cross
    matrix (25 queries, one theta vector) against the twin; the posterior
    state's one theta at 1024 rows; the cell f8d5-mle.seq's refit at its
    512-row layout and its argmax trip against it."""
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


@pytest.mark.parametrize("mb", [3, 2])
@pytest.mark.parametrize("batch", [1, 2, 10])
@pytest.mark.parametrize("n", [1, 16, 37, 64, 100, 128, 256, 384, 512, 1024])
def test_whiten_kernel_matches_twin(dev, n, batch, mb):
    """Ragged blocks (n <= 128 is one block of width n), the MLE ladder's
    lanes at each bucket and rung size, with y and the trend (2 right-hand
    sides) or 3."""
    R = torch.tensor(_kernel_like(n, batch, seed=n), device=dev)
    B = torch.tensor(np.random.default_rng(n).standard_normal((batch, n, mb)), dtype=torch.float32, device=dev)
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
# generation of 32 chains, MIES generations of 6 and 5 restarts on parity
# config 4's mixed space (6 embedded features), parity config 6's argmax
# trip (10 lanes, 2 features, bucket 16) and config 5's (25 lanes, bucket
# 64), a qEHVI CMA generation (80 chains x q = 4), and argmax trips at 7 and
# 8 features, where ptxas reports spills
ENGINE_SHAPES = [(200, 1024, 5), (32, 1024, 5), (60, 1024, 6), (50, 1024, 6), (10, 16, 2), (25, 64, 5),
                 (320, 1024, 5), (25, 1024, 7), (25, 1024, 8)]


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
# the samplers' 8 chains on the n/4 warm-up subset and on all 1024 rows;
# the cold ladder's first two rungs at D = 5, the mixed posterior state,
# parity config 6's fit (2 features, bucket 16), and fits at 7 and 8
# features, where ptxas reports spills
FIT_SHAPES = [(10, 16, 5), (10, 64, 5), (10, 16, 6), (10, 64, 6), (10, 256, 6), (6, 512, 6),
              (2, 1024, 6), (10, 1024, 6), (8, 256, 5), (8, 1024, 5), (10, 256, 5), (6, 512, 5),
              (1, 1024, 6), (10, 16, 2), (2, 1024, 7), (2, 1024, 8)]


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
# and at the fit's layout, 1920 rows (1800 live rows, the rest padding),
# and an argmax trip's 100 lanes against them, 20 features (the chunked
# paths past 8)
D20_SHAPES = [(2, 4096, None), (1, 100, 4096), (2, 1920, None), (1, 100, 1920)]


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
    blocks; inside a phase one `linalg.hybrid` span and 4 launches.
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
    assert snap["fit/linalg.hybrid:n"] == 1
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
    every kernel launches, every point lies in the box, and the result is
    below the DoE's best."""
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
    assert opt.fopt < float(np.min(opt.data.fitness[:8]))


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
@pytest.mark.parametrize("batch, n", [(10, 256), (6, 512), (2, 1024), (1, 1024), (10, 512)])
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


# ---------------------------------------------------------------------------
# The port's paths on the card, each against the CPU path (the plain twins)
# or checked for what it must produce. d = 5 on [0, 1]^5 with y = sum
# sin(3 x) + noise, standardized, as the GP paths' data.

def _sin_data(n, d=5, seed=1):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 1, (n, d))
    y = np.sin(3 * X).sum(1) + 0.1 * rng.standard_normal(n)
    return X, (y - y.mean()) / y.std()


def _gp(dev, d=5, **kw):
    from bayesian_optimization_tpu_torch import GaussianProcess
    from bayesian_optimization_tpu_torch.models.trend import constant_trend

    kw = {"mean": constant_trend(d), "corr": "matern", "thetaL": 1e-3 * np.ones(d),
          "thetaU": 1e3 * np.ones(d), "nugget": 1e-6, "random_start": 10, "random_state": 0, **kw}
    return GaussianProcess(device=dev, **kw)


def _counts():
    from bayesian_optimization_tpu_torch.ops.hopper_kernels import lbfgs_update_fused

    return {"matern_fused": matern_fused.launches, "matern_fused_bwd": matern_fused.bwd_launches,
            "whiten_fused": whiten_fused.launches, "lbfgs_update_fused": lbfgs_update_fused.launches}


def _launched(c0, names=("matern_fused", "matern_fused_bwd", "whiten_fused")):
    """Whether every named kernel launched since the counts c0."""
    c1 = _counts()
    return all(c1[k] > c0[k] for k in names)


def _cpu_criterion(state, config, enc, acq, params, U, dtype=torch.float32, prior=None):
    """The CPU path's criterion at unit points U from a model state carried
    to the CPU in dtype (a forest's thresholds as grown), with a
    NonparametricTrend's forest `prior` carried too."""
    from bayesian_optimization_tpu_torch.models.random_forest import RFState
    from bayesian_optimization_tpu_torch.optim.argmax import make_unit_criterion

    def carry(st):
        moved = type(st)(*(t.cpu() for t in st))
        if isinstance(moved, RFState):
            return moved._replace(value=moved.value.to(dtype))
        return type(moved)(*(t.to(dtype) for t in moved))

    params = {k: torch.tensor(np.asarray(v), dtype=dtype) for k, v in params.items()}
    if prior is not None:
        params.update(_prior_state=carry(prior.posterior), _prior_depth=prior.config.max_depth)
    crit = make_unit_criterion(type(enc)(enc.space, dtype=dtype), carry(state), config, acq, params)
    with torch.no_grad():
        return crit(torch.tensor(np.atleast_2d(U), dtype=dtype)).double().numpy()


def _likelihood_vs_cpu(dev, X, y, n_pad, pars, noise_var=1e-6, f64=False, kernel="matern"):
    """The concentrated likelihood and its gradient for a batch of lanes at
    fixed log10 parameters, on the card and on the CPU path: "err_v" and
    "err_g" relative to the CPU's largest magnitude, "abs_g" the gradient's
    largest absolute error, "scale_g" the CPU gradient's largest entry,
    "nll" the card's values; with f64 "err_v64" the card's value error
    against the CPU path in float64."""
    from bayesian_optimization_tpu_torch.models.likelihood import GPConfig, neg_log_likelihood

    n = X.shape[0]
    Xp, Yp, mask = np.zeros((n_pad, X.shape[1])), np.zeros((n_pad, 1)), np.zeros(n_pad)
    Xp[:n], Yp[:n, 0], mask[:n] = X, y, 1.0
    out = {}
    for d, dt in [(dev, torch.float32), ("cpu", torch.float32)] + [("cpu", torch.float64)] * f64:
        def t(a):
            return torch.tensor(a, dtype=dt, device=d)

        p = t(pars).requires_grad_(True)
        v = neg_log_likelihood(p, t(Xp), t(Yp), t(mask[:, None]), t(mask), n, noise_var,
                               t(np.zeros((1, 1))), GPConfig(kernel=kernel))
        (g,) = torch.autograd.grad(v.sum(), p)
        out[str(d), dt] = (v.detach().cpu().double().numpy(), g.cpu().double().numpy())
    (v_k, g_k), (v_p, g_p) = out[str(dev), torch.float32], out["cpu", torch.float32]
    res = {"err_v": float(np.abs(v_k - v_p).max() / np.abs(v_p).max()),
           "err_g": float(np.abs(g_k - g_p).max() / np.abs(g_p).max()),
           "abs_g": float(np.abs(g_k - g_p).max()), "scale_g": float(np.abs(g_p).max()), "nll": v_k}
    if f64:
        v64 = out["cpu", torch.float64][0]
        res["err_v64"] = float(np.abs(v_k - v64).max() / np.abs(v64).max())
    return res


def _lanes(seed, k=4, d=5):
    """k log10 parameter rows (theta in [1e-1, 1e2], noise in [1e-5, 1e-1])."""
    rng = np.random.default_rng(seed)
    return np.c_[rng.uniform(-1.0, 2.0, (k, d)), rng.uniform(-5.0, -1.0, k)]


@pytest.fixture(scope="module")
def abs_tols():
    """(value, gradient) absolute tolerances: 1e-4 of the largest value and
    1e-3 of the largest gradient entry of the likelihood at 4 random lanes,
    n = 1000 (bucket 1024), where the card is held to them relatively. The
    paths near an optimum, where the gradient nearly vanishes and a value is
    a small difference of large float32 sums, are held to these in absolute
    terms."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    X, y = _sin_data(1000)
    r = _likelihood_vs_cpu(torch.device("cuda"), X, y, 1024, _lanes(4))
    return 1e-4 * float(np.abs(r["nll"]).max()), 1e-3 * r["scale_g"]


@pytest.mark.parametrize("n, rows, kernel", [(200, 256, "matern"), (1000, 1024, "matern"),
                                             (200, 256, "absolute_exponential"),
                                             (200, 256, ("matern", 3.5))], ids=str)
def test_likelihood_and_gradient_against_the_cpu(dev, n, rows, kernel):
    """The concentrated likelihood at 4 random lanes on the card against
    the CPU path: the value within 1e-4 relative, the Matern's gradient
    within 1e-3 of its largest entry."""
    X, y = _sin_data(n)
    r = _likelihood_vs_cpu(dev, X, y, rows, _lanes(4 if n == 1000 else 3), kernel=kernel)
    assert r["err_v"] < 1e-4, r
    if kernel == "matern":
        assert r["err_g"] < 1e-3, r


def test_fit_and_ei_argmax_on_the_card(dev, monkeypatch):
    """The main path at n = 200: a cold fit, a warm refit and the BFGS EI
    argmax (25 restarts). Every kernel launches, the L-BFGS update once a
    trip (the fits' trips counted at the objective, the graphed argmax's by
    its phase counter), the factorisation is sound (min pivot above
    PIV_TOL, finite likelihood and gamma), the mean is within 0.1 of y at
    64 training points, and the winner is finite."""
    from bayesian_optimization_tpu_torch import AcquisitionArgmax, RealSpace
    from bayesian_optimization_tpu_torch.models.likelihood import PIV_TOL
    from bayesian_optimization_tpu_torch.ops import optimize

    X, y = _sin_data(200)
    gp = _gp(dev)
    argmax = AcquisitionArgmax(RealSpace([[0.0, 1.0]] * 5).encoding(), method="BFGS", n_restart=25,
                               seed=0, device=dev)
    trips, inner = [0], optimize._value_and_grad

    def counted(*args):
        trips[0] += 1
        return inner(*args)

    monkeypatch.setattr(optimize, "_value_and_grad", counted)
    c0 = _counts()
    gp.fit(X, y)
    gp.fit(X, y)
    phase = _InPhase()
    u, val = phase.run(argmax, gp.posterior, gp.config, "EI", {"plugin": float(y.min())})
    torch.cuda.synchronize()
    argmax_trips = phase.counter("lbfgs.trips")
    assert _launched(c0) and argmax_trips > 0 and phase.counter("lbfgs.graph_replays") > 0
    assert _counts()["lbfgs_update_fused"] - c0["lbfgs_update_fused"] == trips[0] + argmax_trips
    assert trips[0] > 0
    assert u.shape == (5,) and np.all(np.isfinite(u)) and np.isfinite(val)
    assert float(gp.posterior.min_pivot) > PIV_TOL
    assert np.isfinite(gp.log_likelihood_) and bool(torch.isfinite(gp.posterior.gamma).all())
    assert float(np.abs(gp.predict(X[:64]) - y[:64]).max()) < 0.1


def test_fmin_on_the_card(dev):
    """fmin on the 2-D sphere (parity config 1 cut to 10 of its 30
    evaluations, seed 42): every evaluation made, the result below the
    DoE's best."""
    from bayesian_optimization_tpu_torch import fmin

    def sphere(x):
        return float(np.sum(np.asarray(x, dtype=float) ** 2))

    xopt, fopt, _, evals, hist = fmin(sphere, [-5.0] * 2, [5.0] * 2, max_FEs=10, x0=5, seed=42, device=dev)
    assert evals == 10 and fopt < min(sphere(x) for x in hist[0])


def _mixed_space():
    """Parity config 4's space (benchmark/parity.py:100-107), seed 0."""
    from bayesian_optimization_tpu_torch import DiscreteSpace, IntegerSpace, RealSpace

    s = (RealSpace([[-3.0, 3.0]] * 2, var_name="r") + IntegerSpace([0, 10], var_name="i")
         + DiscreteSpace(["A", "B", "C"], var_name="c"))
    s.random_seed = 0
    return s


def _mixed_obj(x):
    """Parity config 4's objective (benchmark/parity.py:43-48); minimum 0."""
    return (float(x[0]) ** 2 + float(x[1]) ** 2 + abs(int(x[2]) - 5) / 5.0
            + {"A": 0.0, "B": 0.7, "C": 1.5}[x[3]])


def _mixed_data(n):
    """(encoding, embedded rows (n, 6), standardized y) of n LHS samples."""
    space = _mixed_space()
    enc = space.encoding()
    raw = space.sample(n, method="LHS")
    y = np.array([_mixed_obj(list(r)) for r in raw])
    return enc, enc.unit_to_embed_np(enc.encode_unit(raw)), (y - y.mean()) / y.std()


def test_mixed_space_fit_against_float64(dev):
    """The mixed space's fit (parity config 4's, 200 observations, 6
    embedded features): every kernel launches, and the card's likelihood at
    the fit's hyperparameters is within 3e-4 of the CPU path's in float64
    (the fit can end on an ill-conditioned R, theta at its bounds, where
    each float32 path is ~1e-4 off float64 in its own direction)."""
    _, X, y = _mixed_data(200)
    gp = _gp(dev, d=6)
    c0 = _counts()
    gp.fit(X, y)
    assert _launched(c0) and np.isfinite(gp.log_likelihood_)
    par = np.r_[np.log10(gp.theta_), np.log10(gp.sigma2)][None]
    r = _likelihood_vs_cpu(dev, X, y, gp.posterior.X.shape[0], par, gp.noise_var, f64=True)
    assert r["err_v64"] < 3e-4, r


@pytest.mark.parametrize("method, model", [("OnePlusOne_Cholesky_CMA", "gp"), ("SMC", "gp"),
                                           ("MIES", "gp"), ("MIES", "forest")])
def test_engine_argmax_against_the_cpu(dev, method, model):
    """The derivative-free engines' EI (MGFI on the forest) argmax on the
    card: CMA and SMC on a d = 5 GP, MIES on the mixed space's GP and on a
    100-tree forest; the winner's value is the CPU path's criterion there
    (1e-4 relative; MIES on the GP against the CPU path in float64: its fit
    can end on an ill-conditioned R, theta at its bounds, where each
    float32 path is off float64 in its own direction; at n = 1000, where
    the CPU float32 path is within 1e-6 of float64, at n = 200 it is 1.2e-4
    off), the Matern forward launched on a GP."""
    from bayesian_optimization_tpu_torch import AcquisitionArgmax, RandomForest, RealSpace

    if method == "MIES":
        enc, X, y = _mixed_data(1000 if model == "gp" else 200)
    else:
        enc, (X, y) = RealSpace([[0.0, 1.0]] * 5).encoding(), _sin_data(200)
    m = _gp(dev, d=X.shape[1]) if model == "gp" else RandomForest(feature_space="embedding",
                                                                    random_state=0, device=dev)
    m.fit(X, y)
    acq, params = ("EI", {"plugin": float(y.min())}) if model == "gp" else ("MGFI", {"plugin": float(y.min()),
                                                                                     "t": 2.0})
    c0 = _counts()
    u, v = AcquisitionArgmax(enc, method=method, seed=0, device=dev)(m.posterior, m.config, acq, params)
    assert model == "forest" or _launched(c0, ("matern_fused",))
    dtype = torch.float64 if (method, model) == ("MIES", "gp") else torch.float32
    want = _cpu_criterion(m.posterior, m.config, enc, acq, params, u, dtype)[0]
    assert np.isfinite(v) and abs(v - want) < 1e-4 * abs(want), (v, want)


def test_cma_fit_against_the_cpu(dev, abs_tols):
    """The CMA hyperparameter fit at n = 200: the Matern forward and the
    factorisation launch, the fit is sound, and at its hyperparameters the
    card's likelihood is the CPU's within 1e-4 relative and its gradient
    within the absolute tolerance of abs_tols (at an optimum the gradient
    nearly vanishes: its own largest entry is no yardstick)."""
    from bayesian_optimization_tpu_torch.models.likelihood import PIV_TOL

    X, y = _sin_data(200)
    gp = _gp(dev, optimizer="CMA")
    c0 = _counts()
    gp.fit(X, y)
    assert _launched(c0, ("matern_fused", "whiten_fused"))
    assert np.isfinite(gp.log_likelihood_) and float(gp.posterior.min_pivot) > PIV_TOL
    par = np.r_[np.log10(gp.theta_), np.log10(gp.sigma2)][None]
    r = _likelihood_vs_cpu(dev, X, y, gp.posterior.X.shape[0], par, gp.noise_var)
    assert r["err_v"] < 1e-4 and r["abs_g"] < abs_tols[1], r


def _sphere(x):
    return float(np.sum(np.asarray(x, dtype=float) ** 2))


def _con_obj(x):
    """Parity config 6's objective (benchmark/parity.py:244-246)."""
    x = np.asarray(x, dtype=float)
    return float(np.sum(x ** 2) + 5 * np.sum(x) + 10)


@pytest.mark.parametrize("config", [3, 4, 6])
def test_parity_configs_end_to_end(dev, config):
    """Parity configs end to end on the card, seed 0 (benchmark/parity.py):
    3 (ParallelBO MGFI, q = 8, 5-D sphere) cut to 24 of its 48 evaluations
    (two batches: a tell, a refit and a second batch ask; each batch holds
    distinct points) and 4 (the mixed
    space, MIES) cut to 16 of 40, each below its DoE's best with every
    evaluation made; 6 (h = sum x - 1, BFGS) cut to 12 of its 20: |h| <=
    0.1 and the result within the reference's worst seed over all 20
    (PARITY_6_constrained.json).
    The GP's kernels launch on each."""
    from bayesian_optimization_tpu_torch import BO, GaussianProcess, ParallelBO, RealSpace
    from bayesian_optimization_tpu_torch.models.trend import constant_trend

    c0 = _counts()
    if config == 3:
        gp = GaussianProcess(mean=constant_trend(5), corr="matern", thetaL=1e-2 * np.ones(5),
                             thetaU=1e4 * np.ones(5), nugget=1e-6, random_state=0, device=dev)
        opt = ParallelBO(search_space=RealSpace([[-5.0, 5.0]] * 5, random_seed=0), obj_fun=_sphere,
                         model=gp, n_point=8, acquisition_fun="MGFI", acquisition_par={"t": 2.0},
                         DoE_size=8, max_FEs=24, random_seed=0, device=dev)
        opt.run()
        assert opt.eval_count == 24 and opt.fopt < float(np.min(opt.data.fitness[:8]))
        V = np.asarray(opt.data.values, dtype=float)
        assert all(len({tuple(np.round(v, 6)) for v in V[k:k + 8]}) > 1 for k in (8, 16))
        assert _launched(c0)
    elif config == 4:
        opt = BO(search_space=_mixed_space(), obj_fun=_mixed_obj, DoE_size=8, max_FEs=16,
                 acquisition_fun="MGFI", acquisition_par={"t": 2.0}, random_seed=0, device=dev)
        assert opt._argmax.method == "MIES"
        opt.run()
        assert opt.eval_count == 16 and np.isfinite(opt.fopt)
        assert opt.fopt <= float(np.min(opt.data.fitness[:8]))
        assert _launched(c0, ("matern_fused",))
    else:
        model = GaussianProcess(corr="squared_exponential", thetaL=1e-5 * np.ones(2), thetaU=np.ones(2),
                                nugget=1e-1, random_state=0, device=dev)
        opt = BO(search_space=RealSpace([0, 1]) * 2, obj_fun=_con_obj, eq_fun=lambda x: np.sum(x) - 1,
                 model=model, max_FEs=12, DoE_size=3, acquisition_fun="MGFI", acquisition_par={"t": 2},
                 acquisition_optimization={"optimizer": "BFGS"}, random_seed=0, device=dev)
        assert opt._constraints.traceable and opt._optimizer_name == "BFGS"
        xopt, fopt, _ = opt.run()
        assert abs(float(np.sum(np.asarray(xopt, dtype=float)) - 1)) <= 0.1
        assert float(fopt[0]) <= 15.5057 and opt.eval_count == 12
        assert _launched(c0)


def test_sampler_target_against_the_cpu(dev, abs_tols):
    """A NUTS fit (n = 60, 8 chains) on the card; the sampler's target and
    its gradient at the chains' states on the card against the CPU path,
    within abs_tols (near an optimum the target is a small difference of
    large float32 sums and the gradient nearly vanishes)."""
    from bayesian_optimization_tpu_torch.models.hmc import _value_and_grad
    from bayesian_optimization_tpu_torch.models.likelihood import neg_log_likelihood

    X, y = _sin_data(60)
    gp = _gp(dev, optimizer="NUTS")
    gp.hmc_warmup, gp.n_ensemble = 16, 8
    gp.fit(X, y)
    x_box = gp.sample_chains_[-1]  # (chains, parameters)
    rows = gp.posterior.X.shape[-2]
    Xp, Yp, mask = np.zeros((rows, 5)), np.zeros((rows, 1)), np.zeros(rows)
    Xp[:60], Yp[:60, 0], mask[:60] = X, y, 1.0
    b = gp._hyper_bounds(5, y)
    out = []
    for d in (dev, "cpu"):
        def t(a):
            return torch.tensor(a, dtype=torch.float32, device=d)

        Xt, Yt, mt, lo, hi = t(Xp), t(Yp), t(mask), t(b[:, 0]), t(b[:, 1])
        config = gp.config._replace(n_ensemble=0)

        def logp(p):
            return -neg_log_likelihood(p, Xt, Yt, mt[:, None], mt, 60, gp.noise_var, t(np.zeros((1, 1))),
                                       config, prior_lo=lo, prior_hi=hi)

        frac = ((t(x_box) - lo) / (hi - lo)).clamp(1e-6, 1 - 1e-6)  # as ops/optimize.from_box
        lp, g = _value_and_grad(logp, lo, hi)(torch.log(frac) - torch.log1p(-frac))
        out.append((lp.detach().cpu().double().numpy(), g.cpu().double().numpy()))
    (lp_k, g_k), (lp_c, g_c) = out
    assert np.abs(lp_k - lp_c).max() < abs_tols[0] and np.abs(g_k - g_c).max() < abs_tols[1]


def test_constrained_criterion_and_gradient_against_the_cpu(dev):
    """The BFGS EI argmax under a traced inequality (sum x <= 1.5, written
    with numpy) on the card: the winner is feasible, and the card's
    penalized criterion and its gradient at the winner and 8 random points
    are the CPU path's (1e-4 relative; the gradient within 1e-3 of its
    largest entry)."""
    from bayesian_optimization_tpu_torch import AcquisitionArgmax, ConstraintProgram, RealSpace
    from bayesian_optimization_tpu_torch.optim.argmax import make_unit_criterion

    def g(x):
        return np.sum(x) - 1.5

    X, y = _sin_data(200)
    gp = _gp(dev).fit(X, y)
    enc = RealSpace([[0.0, 1.0]] * 5).encoding()
    cp = ConstraintProgram(enc, g=g, device=dev)
    am = AcquisitionArgmax(enc, method="BFGS", n_restart=25, seed=0, constraints=cp, device=dev)
    params = {"plugin": float(y.min()), "_penalty_t": 10.0 + am.max_FEs}
    u, _ = am(gp.posterior, gp.config, "EI", params)
    assert g(u) <= 0.0, u
    cpu_state = type(gp.posterior)(*(t.cpu() for t in gp.posterior))
    U = np.r_[u[None], np.random.default_rng(12).uniform(0, 1, (8, 5))]
    vals = []
    for d, state, prog in ((dev, gp.posterior, cp), ("cpu", cpu_state, ConstraintProgram(enc, g=g, device="cpu"))):
        crit = make_unit_criterion(enc, state, gp.config, "EI",
                                   {k: torch.tensor(v, dtype=torch.float32, device=d) for k, v in params.items()},
                                   constraints=prog)
        Ut = torch.tensor(U, dtype=torch.float32, device=d, requires_grad=True)
        val = crit(Ut)
        (grad,) = torch.autograd.grad(val.sum(), Ut)
        vals.append((val.detach().cpu().double().numpy(), grad.cpu().double().numpy()))
    (v_k, g_k), (v_c, g_c) = vals
    assert np.abs(v_k - v_c).max() < 1e-4 * np.abs(v_c).max()
    assert np.abs(g_k - g_c).max() < 1e-3 * np.abs(g_c).max()


def test_gei_against_the_cpu(dev):
    """One BO iteration with GEI (g = 2) on the card at n = 200: the refit
    and the argmax launch every kernel, and the criterion at the winner is
    the CPU path's (1e-4 relative)."""
    from bayesian_optimization_tpu_torch import BO, RealSpace

    X, y = _sin_data(200)
    gp = _gp(dev)
    opt = BO(search_space=RealSpace([[0.0, 1.0]] * 5), obj_fun=_sphere, model=gp, acquisition_fun="GEI",
             acquisition_par={"g": 2}, random_seed=0, device=dev)
    c0 = _counts()
    opt.tell([list(r) for r in X], list(y))
    cands, vals = opt.arg_max_acquisition(return_value=True)
    assert _launched(c0)
    enc = RealSpace([[0.0, 1.0]] * 5).encoding()
    u = enc.encode_unit(np.asarray(cands, dtype=object))
    want = _cpu_criterion(gp.posterior, gp.config, enc, "GEI2", {"plugin": opt.fmin}, u)
    assert np.all(np.isfinite(vals)) and np.max(np.abs(np.asarray(vals) - want) / np.abs(want)) < 1e-4


def test_nonparametric_trend_argmax_against_the_cpu(dev):
    """A GP under a NonparametricTrend (a 100-tree forest) at n = 200 and
    the BFGS EI argmax with the forest in the criterion (plugin at y's 10th
    percentile: at min(y) the residual GP's EI underflows and no lane
    moves): every kernel launches, the winner beats every start and lies
    away from them, and its criterion is the CPU path's (1e-4 relative)."""
    from bayesian_optimization_tpu_torch import AcquisitionArgmax, NonparametricTrend, RandomForest, RealSpace

    X, y = _sin_data(200)
    forest = RandomForest(feature_space="embedding", random_state=0, device=dev)
    gp = _gp(dev, mean=NonparametricTrend(forest, device=dev))
    am = AcquisitionArgmax(RealSpace([[0.0, 1.0]] * 5).encoding(), method="BFGS", n_restart=25, seed=0,
                           device=dev)
    c0 = _counts()
    forest.fit(X, y)
    gp.fit(X, y)
    params = {"plugin": float(np.quantile(y, 0.1))}
    gen = torch.Generator().set_state(am._gen.get_state())  # the argmax's own starts
    starts = torch.rand((am.n_restart, 5), generator=gen, dtype=am.encoding.dtype).numpy()
    u, v = am(gp.posterior, gp.config, "EI",
              {**params, "_prior_state": forest.posterior, "_prior_depth": forest.config.max_depth})
    assert _launched(c0)
    at_starts = _cpu_criterion(gp.posterior, gp.config, am.encoding, "EI", params, starts, prior=forest)
    assert v > float(at_starts.max()) and float(np.sqrt(((starts - u) ** 2).sum(1)).min()) > 1e-3
    want = _cpu_criterion(gp.posterior, gp.config, am.encoding, "EI", params, u, prior=forest)[0]
    assert abs(v - want) < 1e-4 * abs(want), (v, want)


@pytest.mark.parametrize("case", ["conditional", "forest"])
def test_tree_surrogate_bo_end_to_end(dev, case):
    """ConditionalBO on tests/test_extensions.py's conditional space (16
    evaluations, seed 0: every evaluation made, a finite result), and BO
    with a RandomForest on parity config 4's mixed problem (40 evaluations,
    seed 0: below the DoE's best), on the card."""
    from bayesian_optimization_tpu_torch import BO, ConditionalBO, RandomForest, SearchSpace
    from bayesian_optimization_tpu_torch.space import Discrete, Integer, Real

    if case == "conditional":
        space = SearchSpace([Integer([1, 3], "x"), Discrete(["A", "B", "C"], "y1", conditions="x == 1"),
                             Discrete(["A", "B", "C"], "y2", conditions="x == 2"), Real([-5, 5], "z")])

        def fitness(p):
            return float(p["x"] ** 2 + p["z"] ** 2 + (p.get("y1") == "B") + (p.get("y2") == "A"))

        opt = ConditionalBO(search_space=space, obj_fun=fitness, DoE_size=4, max_FEs=16, random_seed=0,
                            device=dev)
        opt.run()
        assert opt.eval_count == 16 and np.isfinite(opt.fopt)
    else:
        opt = BO(search_space=_mixed_space(), obj_fun=_mixed_obj,
                 model=RandomForest(feature_space="embedding", random_state=0, device=dev), DoE_size=8,
                 max_FEs=40, acquisition_fun="MGFI", acquisition_par={"t": 2.0}, random_seed=0, device=dev)
        assert opt._argmax.method == "MIES"
        opt.run()
        assert opt.eval_count == 40 and opt.fopt < float(np.min(opt.data.fitness[:8]))


def _bi_sphere(d=3):
    return [lambda x, c=c: float(np.sum((np.asarray(x, dtype=float) - c) ** 2)) for c in (0.2, 0.8)]


def test_ehvi_argmax_beats_its_starts(dev):
    """MOBO's BFGS EHVI argmax on the card (80 bi-sphere points, d = 3):
    every kernel of the 2-output fit launches, and the winner's EHVI is at
    least the best of the pool of starts it drew, on the card's criterion."""
    from bayesian_optimization_tpu_torch import MOBO, RealSpace
    from bayesian_optimization_tpu_torch.optim.argmax import make_unit_criterion

    X = np.random.default_rng(2).uniform(0, 1, (80, 3))
    F = np.c_[((X - 0.2) ** 2).sum(1), ((X - 0.8) ** 2).sum(1)]
    opt = MOBO(search_space=RealSpace([[0.0, 1.0]] * 3, random_seed=0), obj_fun=_bi_sphere(), n_obj=2,
               DoE_size=10, max_FEs=10 ** 4, random_seed=0, device=dev)
    c0 = _counts()
    opt.tell(X.tolist(), F)
    am, par = opt._argmax, opt._acq_par_defaults({})
    pool = am._gen.get_state()
    Xw, vals = opt.arg_max_acquisition(return_value=True)
    assert _launched(c0)
    starts = torch.rand((1, am.n_restart, 3), generator=torch.Generator().set_state(pool))[0]
    crit = make_unit_criterion(opt.encoding, opt.model.posterior, opt.model.config, "EHVI", am._lane_params(par))
    with torch.no_grad():
        at_starts = crit(starts.to(dev)).cpu().double().numpy()
    assert float(vals[0]) >= at_starts.max()


@pytest.mark.parametrize("case", ["gp", "forest", "constrained"])
def test_mobo_end_to_end_on_the_card(dev, case):
    """MOBO on the bi-sphere in d = 2, seed 0, on the card: with the GP
    (DoE 10, 24 objective evaluations: 2 asks), a 30-tree RandomForest
    (MIES over a multi-output forest, DoE 6, 20) and under x0 + x1 <= 1
    (DoE 6, 16):
    every evaluation made, the final front's hypervolume above its DoE's on
    the final normalization, every constrained point feasible."""
    from bayesian_optimization_tpu_torch import MOBO, RandomForest, RealSpace
    from bayesian_optimization_tpu_torch.ops.box_decomposition import NondominatedPartitioning

    kw = {"gp": {"DoE_size": 10, "max_FEs": 24},
          "forest": {"DoE_size": 6, "max_FEs": 20,
                     "model": RandomForest(n_estimators=30, random_state=0, feature_space="embedding",
                                           device=dev)},
          "constrained": {"DoE_size": 6, "max_FEs": 16, "ineq_fun": lambda x: x[0] + x[1] - 1.0}}[case]
    opt = MOBO(search_space=RealSpace([[0.0, 1.0]] * 2, random_seed=0), obj_fun=_bi_sphere(), n_obj=2,
               random_seed=0, device=dev, **kw)
    assert (opt._argmax.method == "MIES") == (case == "forest")
    opt.run()
    doe = NondominatedPartitioning(opt.ref_point, opt.y[:kw["DoE_size"]]).compute_hypervolume()
    assert opt._last_hv > doe and opt.eval_count == kw["max_FEs"]
    if case == "constrained":
        assert float(np.asarray(opt.data.values, dtype=float).sum(1).max()) <= 1.0 + 1e-6


def _http(url, payload=None):
    """One request (POST with a payload); a reply carrying "error" fails."""
    import json
    import urllib.request

    req = url if payload is None else urllib.request.Request(
        url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        out = json.loads(r.read())
    assert "error" not in out, (url, out)
    return out


@pytest.fixture
def card_server(dev):
    import threading

    from bayesian_optimization_tpu_torch.service.http_server import serve

    server = serve(port=0, device=dev)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}"
    server.shutdown()
    server.server_close()
    thread.join()


def test_http_service_on_the_card(card_server):
    """The HTTP service with device cuda on [0, 1]^5: a DoE ask, a tell of
    200 points (a cold fit on the card) and the BFGS EI ask, which launch
    every kernel; the point lies in the box, recommend's fopt is the
    smallest told y, status counts the tells, finalize answers."""
    url = card_server
    X, y = _sin_data(200)
    job = _http(url, {"search_param": {"x": {"type": "r", "range": [0, 1], "N": 5}},
                      "bo_param": {"DoE_size": 5, "max_iter": 2000, "random_seed": 0}})["job_id"]
    assert len(_http(f"{url}/?ask=null&job_id={job}")["X"]) == 5
    c0 = _counts()
    _http(url, {"job_id": job, "X": [{f"x{j}": float(v) for j, v in enumerate(r)} for r in X],
                "y": y.tolist()})
    asked = _http(f"{url}/?ask=null&job_id={job}")["X"]
    assert _launched(c0)
    u = np.array([[x[f"x{j}"] for j in range(5)] for x in asked])
    assert u.shape == (1, 5) and np.all((u >= 0) & (u <= 1))
    assert _http(f"{url}/?recommend=null&job_id={job}")["fopt"] == [float(y.min())]
    st = _http(f"{url}/?status=null&job_id={job}")["job"]
    assert st["eval_count"] == len(X) and st["fopt"] == float(y.min())
    assert _http(f"{url}/?finalize=null&job_id={job}")["finalized"]


def test_two_service_jobs_at_once_on_the_card(card_server):
    """A ParallelBO job (q = 4) and a mixed-space (MIES) job from two client
    threads at once, 3 ask/tell rounds each, with device cuda: each asks
    its DoE then its batches, and the GP's kernels launch."""
    import threading

    url = card_server
    jobs = {"parallel": ({"x": {"type": "r", "range": [-5, 5], "N": 5}},
                         {"n_point": 4, "DoE_size": 8, "max_iter": 10, "random_seed": 0},
                         lambda x: _sphere([x[f"x{j}"] for j in range(5)])),
            "mixed": ({"r": {"type": "r", "range": [-3, 3], "N": 2}, "i": {"type": "i", "range": [0, 10]},
                       "c": {"type": "c", "range": ["A", "B", "C"]}},
                      {"DoE_size": 8, "max_iter": 10, "random_seed": 0},
                      lambda x: _mixed_obj([x["r0"], x["r1"], x["i"], x["c"]]))}
    sizes, errors = {}, []

    def client(name):
        try:
            space, bo, f = jobs[name]
            job = _http(url, {"search_param": space, "bo_param": bo})["job_id"]
            sizes[name] = []
            for _ in range(3):
                X = _http(f"{url}/?ask=null&job_id={job}")["X"]
                sizes[name].append(len(X))
                _http(url, {"job_id": job, "X": X, "y": [f(x) for x in X]})
            _http(f"{url}/?finalize=null&job_id={job}")
        except BaseException as e:  # re-raised in the test's thread
            errors.append(e)

    c0 = _counts()
    threads = [threading.Thread(target=client, args=(name,)) for name in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    torch.cuda.synchronize()
    assert _launched(c0)
    assert sizes == {"parallel": [8, 4, 4], "mixed": [8, 1, 1]}, sizes


def test_daemon_on_the_card(dev):
    """`python -m ...simple_http_server -d --device cuda`: it answers
    health, runs a job's DoE ask, tell and ask (a fit on the card), stops
    by its pidfile, and its pid and pidfile are gone."""
    import os
    import signal
    import socket
    import subprocess
    import sys
    import time
    import urllib.error

    from bayesian_optimization_tpu_torch.service import daemon
    from bayesian_optimization_tpu_torch.service.http_server import pidfile_for

    def gone(pid):
        try:
            with open(f"/proc/{pid}/stat") as f:
                return f.read().rsplit(")", 1)[1].split()[0] == "Z"
        except FileNotFoundError:
            return True

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    pidfile = pidfile_for(port)
    assert not os.path.exists(pidfile)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    launcher = subprocess.run([sys.executable, "-m", "bayesian_optimization_tpu_torch.simple_http_server",
                               "-d", "--device", "cuda", "-w", str(port)], env=env, capture_output=True,
                              text=True, timeout=120)
    assert launcher.returncode == 0, launcher.stderr
    pid, url = None, f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 120
        while True:
            pid = pid or daemon.read_pid(pidfile)
            try:
                health = _http(f"{url}/health")
                break
            except (urllib.error.URLError, ConnectionError):
                assert time.monotonic() < deadline, "the daemon never answered"
                time.sleep(0.2)
        pid = daemon.read_pid(pidfile)
        assert health["status"] == "ok" and pid is not None and daemon.status(pidfile)
        job = _http(url, {"search_param": {"x": {"type": "r", "range": [-5, 5], "N": 2}},
                          "bo_param": {"DoE_size": 5, "random_seed": 0}})["job_id"]
        X = _http(f"{url}/?ask=null&job_id={job}")["X"]
        _http(url, {"job_id": job, "X": X, "y": [x["x0"] ** 2 + x["x1"] ** 2 for x in X]})
        nxt = _http(f"{url}/?ask=null&job_id={job}")["X"]
        assert len(nxt) == 1 and all(-5 <= v <= 5 for v in nxt[0].values()), nxt
        assert daemon.stop(pidfile)
        deadline = time.monotonic() + 60
        while not (gone(pid) and not os.path.exists(pidfile)):
            assert time.monotonic() < deadline, "the daemon outlived SIGTERM"
            time.sleep(0.1)
    finally:
        if pid is not None and not gone(pid):
            os.kill(pid, signal.SIGKILL)  # this exact pid, never by pattern
        if pid is not None and os.path.exists(pidfile):
            os.remove(pidfile)


def test_default_mesh_argmax_equals_the_unsharded(dev):
    """The default particle mesh's BFGS EI argmax from one pool of 25
    starts: one gather, and on one card the same winner as the unsharded
    argmax (on more cards within 1e-4 relative)."""
    from bayesian_optimization_tpu_torch import AcquisitionArgmax, RealSpace
    from bayesian_optimization_tpu_torch.parallel import make_particle_mesh

    X, y = _sin_data(200)
    gp = _gp(dev).fit(X, y)
    enc = RealSpace([[0.0, 1.0]] * 5).encoding()
    mesh = make_particle_mesh()
    pool = np.random.default_rng(9).uniform(0, 1, (25, 5))
    args = (gp.posterior, gp.config, "EI", {"plugin": float(y.min())})
    u1, v1 = AcquisitionArgmax(enc, method="BFGS", n_restart=25, seed=0, mesh=mesh, device=dev)(*args, x0_seed=pool)
    u0, v0 = AcquisitionArgmax(enc, method="BFGS", n_restart=25, seed=0, device=dev)(*args, x0_seed=pool)
    assert mesh.gathers == 1
    if mesh.size == 1:
        assert np.array_equal(u1, u0) and v1 == v0
    else:
        assert abs(v1 - v0) <= 1e-4 * abs(v0)


def test_entry_against_the_cpu(dev, abs_tols):
    """entry() on the card (8 theta x n = 24 padded to 32, d = 3): every
    kernel launches, the values within 1e-4 relative of the CPU path's, the
    gradient within abs_tols and within 1e-3 of its largest entry; and
    dryrun_multidevice(2) runs on the card twice over."""
    from bayesian_optimization_tpu_torch.entry import dryrun_multidevice, entry

    c0 = _counts()
    fn, args = entry(dev)
    vals, grads = fn(*args)
    torch.cuda.synchronize()
    assert _launched(c0)
    fn_c, args_c = entry(device="cpu")
    vals_c, grads_c = fn_c(*args_c)
    abs_g = float((grads.cpu() - grads_c).abs().max())
    assert float(((vals.cpu() - vals_c).abs() / vals_c.abs()).max()) < 1e-4
    assert abs_g < abs_tols[1] and abs_g / float(grads_c.abs().max()) < 1e-3
    dryrun_multidevice(2, devices=[dev] * 2)


def _unit_bo(dev, cls=None, **kw):
    """cls (BO) on [0, 1]^5 (variables x0..x4) on the card with the default
    model, seed 0, a DoE of 10, minimizing sum sin(3 x)."""
    from bayesian_optimization_tpu_torch import BO, RealSpace

    return (cls or BO)(search_space=RealSpace([[0.0, 1.0]] * 5, var_name="x", random_seed=0),
                       obj_fun=kw.pop("obj_fun", _sin_sum), DoE_size=10, random_seed=0, device=dev, **kw)


def _sin_sum(x):
    return float(np.sin(3 * np.asarray(x, dtype=float)).sum())


@pytest.mark.parametrize("flavor", ["NoisyBO", "AnnealingBO", "SelfAdaptiveBO", "MultiAcquisitionBO"])
def test_bo_flavors_on_the_card(dev, flavor):
    """A batch BO flavour on the card, q = 2, the DoE and one batch: the
    GP's kernels launch, every evaluation is made, and the criterion at
    each winner of the last ask (MultiAcquisitionBO: of the last two calls)
    is the CPU path's in float64 at the same posterior, within 1e-4 of
    |value| (of max(|value|, 1) for UCB, which crosses 0), or within 10
    times the CPU float32 path's own error where that is larger; on these
    near-interpolating posteriors float32's error scatters from point to
    point, so its scale is the largest over the winner and 32 points within
    1e-2 of it."""
    import bayesian_optimization_tpu_torch as bo

    noise = np.random.default_rng(3)
    kw = {"NoisyBO": {"obj_fun": lambda x: _sin_sum(x) + 0.1 * float(noise.standard_normal())},
          "AnnealingBO": {"t0": 2.0, "tf": 0.1}}.get(flavor, {})
    opt = _unit_bo(dev, getattr(bo, flavor), n_point=2, max_FEs=12, **kw)
    calls, batch = [], opt._argmax.batch

    def recorder(state, config, acq, pars, **k):
        us, vals = batch(state, config, acq, pars, **k)
        calls.append((acq, pars, us, vals, type(state)(*(t.clone() for t in state)), config))
        return us, vals

    opt._argmax.batch = recorder
    c0 = _counts()
    opt.run()
    assert _launched(c0) and opt.eval_count >= 12
    for acq, pars, us, vals, state, config in calls[-2:] if flavor == "MultiAcquisitionBO" else calls[-1:]:
        for p, u, v in zip(pars, us, vals):
            near = np.clip(u + np.random.default_rng(0).uniform(-1e-2, 1e-2, (32, u.size)), 0.0, 1.0)
            U = np.vstack([u, near])
            c32, c64 = (_cpu_criterion(state, config, opt.encoding, acq, p, U, dt)
                        for dt in (torch.float32, torch.float64))
            scale = max(abs(c64[0]), 1.0 if acq == "UCB" else 1e-30)
            tol = max(1e-4, 10.0 * float(np.abs(c32 - c64).max()) / scale)
            assert np.isfinite(v) and abs(v - c64[0]) / scale <= tol, (acq, v, c64[0], tol)


def test_checkpoints_on_the_card(dev, tmp_path):
    """A BO on the card after its DoE: save -> load in this process puts the
    loaded BO and its posterior on the card, and its ask and tell launch
    the GP's kernels; save_state -> a fresh BO -> load_state gives the same
    theta (1e-6 in log10) and counters."""
    opt = _unit_bo(dev, max_FEs=100)
    X = opt.ask()
    opt.tell(X, [_sin_sum(x) for x in X])
    theta0, counters0 = opt.model.theta_.copy(), (opt.iter_count, opt.eval_count)
    opt.save(str(tmp_path / "bo.pkl"))
    opt.save_state(str(tmp_path / "bo.json"))
    loaded = type(opt).load(str(tmp_path / "bo.pkl"))
    fresh = _unit_bo(dev, max_FEs=100)
    fresh.load_state(str(tmp_path / "bo.json"))
    assert loaded.device.type == loaded.model.device.type == loaded.model.posterior.L.device.type == "cuda"
    c0 = _counts()
    (x,) = loaded.ask()
    loaded.tell([x], [_sin_sum(x)])
    assert _launched(c0)
    assert float(np.abs(np.log10(fresh.model.theta_) - np.log10(theta0)).max()) <= 1e-6
    assert (fresh.iter_count, fresh.eval_count) == counters0


def test_fixed_ask_and_warm_data_on_the_card(dev):
    """ask(fixed={"x0": 0.5}) on the card, through the argmax (after a DoE)
    and through the DoE: every row at x0 = 0.5, the rest in [0, 1]; warm
    data with eval_type="dict": the warm rows are the data and no
    evaluation is counted, the fit launches the GP's kernels, a run adds
    its evaluations and an ask returns dicts."""
    opt = _unit_bo(dev, max_FEs=100)
    X = opt.ask()
    opt.tell(X, [_sin_sum(x) for x in X])
    c0 = _counts()
    Xf = opt.ask(fixed={"x0": 0.5})
    opt.tell(Xf, [_sin_sum(x) for x in Xf])
    assert _launched(c0)
    for x in Xf + _unit_bo(dev, max_FEs=100).ask(fixed={"x0": 0.5}):
        assert abs(float(x[0]) - 0.5) <= 1e-6 and all(0.0 <= float(v) <= 1.0 for v in x), x
    X0 = np.random.default_rng(1).uniform(0, 1, (20, 5))
    c0 = _counts()
    warm = _unit_bo(dev, obj_fun=lambda d: _sin_sum([d[f"x{i}"] for i in range(5)]), eval_type="dict",
                    max_FEs=2, warm_data=(X0.tolist(), [_sin_sum(x) for x in X0]))
    assert _launched(c0) and warm.data.N == 20 and warm.eval_count == 0 and warm.model.is_fitted
    warm.run()
    asked = warm.ask()
    assert isinstance(asked[0], dict) and sorted(asked[0]) == [f"x{i}" for i in range(5)]
    assert warm.eval_count == 2 and warm.data.N == 22


@pytest.mark.parametrize("mode", ["noise_estim", "duplicates", "escalation"])
def test_gp_modes_on_the_card(dev, mode):
    """A noise-estimating fit (n = 200: finite, a positive MSE), a noiseless
    fit of duplicated, conflicting rows (finite), and a noiseless fit whose
    correlation float32 cannot factor at any theta in its bounds (theta in
    [1e-4, 1e-3], n = 512), which must escalate to the noisy mode; each on
    the card, launching the GP's kernels."""
    from bayesian_optimization_tpu_torch import GaussianProcess

    rng = np.random.default_rng(1)
    X = rng.uniform(0, 1, (512 if mode == "escalation" else 200, 5))
    y = np.sin(3 * X).sum(1) + 0.1 * rng.standard_normal(len(X))
    if mode == "noise_estim":
        gp = GaussianProcess(thetaL=1e-2 * np.ones(5), thetaU=1e2 * np.ones(5), noise_estim=True, nugget=1e-6,
                             random_state=2, device=dev)
    else:
        if mode == "duplicates":
            X, y = np.vstack([X[:100], X[:100]]), np.concatenate([y[:100], y[:100] + 0.5])
        lo, hi = (1e-4, 1e-3) if mode == "escalation" else (1e-2, 1e2)
        gp = _gp(dev, thetaL=lo * np.ones(5), thetaU=hi * np.ones(5), nugget=0.0, random_start=4)
    escalations, escalate = [], gp._escalate_nugget
    gp._escalate_nugget = lambda *a: escalations.append(gp.estimation_mode) or escalate(*a)
    c0 = _counts()
    gp.fit(X, y)
    mu, mse = gp.predict(X[:8], eval_MSE=True)
    assert _launched(c0) and np.isfinite(gp.log_likelihood_) and np.all(np.isfinite(mu)) and np.all(mse >= 0)
    if mode == "noise_estim":
        assert float(np.mean(gp.predict(X, eval_MSE=True)[1])) > 1e-8
    if mode == "escalation":
        assert escalations and gp.estimation_mode == "noisy", escalations


@pytest.mark.parametrize("path", ["hmc_fit", "vi_fit", "absolute_exponential_fit", "matern_3.5_fit",
                                  "host_constraint", "constrained_batch", "mobo_three_objectives"])
def test_paths_run_on_the_card(dev, path):
    """Paths whose card check is that they run, stay finite and launch the
    kernels they reach (and, under a constraint, stay feasible): the HMC
    and VI fits (n = 200, 8 chains or lanes; the Matern forward and
    backward and the factorisation), fits with the absolute-exponential and
    nu = 7/2 kernels (plain torch covariances: the factorisation), the EI
    argmax under a constraint that runs on the host (BFGS asked, CMA run)
    and a q = 8 MGFI batch under a traced one (sum x <= 1.5), and MOBO's
    ask on the tri-sphere (n = 120: a 3-output fit, whiten's 4 right-hand
    sides)."""
    from bayesian_optimization_tpu_torch import (
        BO, MOBO, AcquisitionArgmax, ConstraintProgram, RealSpace,
    )

    X, y = _sin_data(200)
    enc = RealSpace([[0.0, 1.0]] * 5).encoding()
    c0 = _counts()
    names = ("matern_fused", "matern_fused_bwd", "whiten_fused")
    if path in ("hmc_fit", "vi_fit"):
        gp = _gp(dev, optimizer=path[:-4].upper())
        gp.hmc_warmup, gp.n_ensemble, gp.vi_steps = 16, 8, 100
        gp.fit(X, y)
        assert np.isfinite(gp.log_likelihood_) and np.all(np.isfinite(gp.theta_samples_))
    elif path.endswith("_fit"):
        gp = _gp(dev, corr="absolute_exponential" if path.startswith("absolute") else ("matern", 3.5))
        gp.fit(X, y)
        assert np.isfinite(gp.log_likelihood_)
        names = ("whiten_fused",)
    elif path == "host_constraint":
        def g_host(x):  # through np.array: it runs on the host
            return float(np.sum(np.array(list(x), dtype=float))) - 1.5

        gp = _gp(dev).fit(X, y)
        opt = BO(search_space=RealSpace([[0.0, 1.0]] * 5), obj_fun=_sphere, ineq_fun=g_host, model=gp,
                 acquisition_optimization={"optimizer": "BFGS"}, random_seed=0, device=dev)
        assert not opt._constraints.traceable and opt._optimizer_name == "OnePlusOne_Cholesky_CMA"
        am = opt._argmax
        u, v = am(gp.posterior, gp.config, "EI", {"plugin": float(y.min()), "_penalty_t": 10.0 + am.max_FEs})
        assert g_host(u) <= 0.0 and np.isfinite(v)
        names = ("matern_fused", "whiten_fused")
    elif path == "constrained_batch":
        gp = _gp(dev).fit(X, y)
        cp = ConstraintProgram(enc, g=lambda x: np.sum(x) - 1.5, device=dev)
        am = AcquisitionArgmax(enc, method="BFGS", n_restart=25, seed=0, constraints=cp, device=dev)
        pars = [{"plugin": float(y.min()), "t": t, "_penalty_t": 10.0 + am.max_FEs}
                for t in np.linspace(0.5, 4.0, 8)]
        us, vs = am.batch(gp.posterior, gp.config, "MGFI", pars)
        assert all(np.sum(u) - 1.5 <= 0.0 for u in us) and np.all(np.isfinite(vs))
    else:
        opt = MOBO(search_space=RealSpace([[0.0, 1.0]] * 5, random_seed=0),
                   obj_fun=[lambda x, c=c: float(np.sum((np.asarray(x) - c) ** 2)) for c in (0.2, 0.5, 0.8)],
                   n_obj=3, DoE_size=10, max_FEs=10 ** 6, random_seed=0, device=dev)
        Xm = np.random.default_rng(16).uniform(0, 1, (120, 5))
        opt.tell(Xm.tolist(), np.stack([((Xm - c) ** 2).sum(1) for c in (0.2, 0.5, 0.8)], axis=1))
        assert len(opt.ask()) == 1
    torch.cuda.synchronize()
    assert _launched(c0, names)


class _InPhase:
    """Runs a call as the phase "arg_max_acquisition", so that the port's
    spans and counters record under it."""

    def __init__(self):
        from bayesian_optimization_tpu_torch.utils.logging import PhaseTimer

        self._timer = PhaseTimer()

    def run(self, fn, *args, **kw):
        from bayesian_optimization_tpu_torch.utils.logging import timed_phase

        return timed_phase("arg_max_acquisition")(lambda self: fn(*args, **kw))(self)

    def counter(self, name):
        return self._timer.snapshot().get(f"arg_max_acquisition/{name}", 0)


def _cell_posterior(dev, d, n, dtype=torch.float32):
    """A GP posterior on log-Rosenbrock data at n points in [0, 1]^d (the
    cells' F8 shape), laid out at the next 128-multiple of n as a fit lays
    its rows out; and its plugin, the data's minimum."""
    from bayesian_optimization_tpu_torch.models.likelihood import GPConfig, posterior_state

    rng = np.random.default_rng(d)
    X = rng.uniform(0.0, 1.0, (n, d))
    x = 10.0 * X - 5.0
    y = np.log1p((100.0 * (x[:, :-1] ** 2 - x[:, 1:]) ** 2 + (x[:, :-1] - 1.0) ** 2).sum(1))
    y = (y - y.mean()) / y.std()
    n_pad = 128 * math.ceil(n / 128)
    Xp, Yp = np.zeros((n_pad, d)), np.zeros((n_pad, 1))
    Xp[:n], Yp[:n, 0] = X, y
    mask = (np.arange(n_pad) < n).astype(float)
    par = np.concatenate([rng.uniform(-0.3, 0.3, d) + math.log10(12.0 / d), [0.0]])

    def t(a):
        return torch.tensor(a, dtype=dtype, device=dev)

    config = GPConfig()
    state = posterior_state(t(par), t(Xp), t(Yp), t(mask[:, None]), t(mask), n, 1e-6,
                            t(np.zeros((1, 1))), config)
    return state, config, float(y.min())


# the cells' argmax: (d, n, lanes, argmax_ascent's limit)
ARGMAX_CELLS = [(5, 475, 25, 1e-2), (20, 1800, 100, 1e-3)]


@pytest.mark.parametrize("d, n, R, limit", ARGMAX_CELLS, ids=["f8d5", "f8d20"])
def test_graphed_argmax_against_the_eager_loop(dev, monkeypatch, d, n, R, limit):
    """The BFGS EI argmax at each cell's shapes (25 lanes of 5 against 512
    rows, 100 of 20 against 1920), three asks from one seed: the graphed run
    against the eager live-lane loop (`_lbfgs_batched` put in its place) on
    the same posterior and pools. The winners' EI agree within the cell's
    `argmax_ascent` limit (relative); every trip after an ask's first is a
    replay (`lbfgs.graph_replays` = trips - 1 an ask); the Matern backward
    and the update kernel launch once a trip, and `lbfgs.fused_updates`
    counts every trip."""
    from bayesian_optimization_tpu_torch import AcquisitionArgmax, RealSpace
    from bayesian_optimization_tpu_torch.ops import hopper_kernels as hk
    from bayesian_optimization_tpu_torch.ops import optimize

    state, config, plugin = _cell_posterior(dev, d, n)
    enc = RealSpace([[0.0, 1.0]] * d).encoding()
    args = (state, config, "EI", {"plugin": plugin})
    graphed = AcquisitionArgmax(enc, method="BFGS", n_restart=R, seed=11, device=dev)
    phase = _InPhase()
    vals = []
    for _ in range(3):
        trips0, replays0 = phase.counter("lbfgs.trips"), phase.counter("lbfgs.graph_replays")
        bwd0, upd0 = hk.matern_fused.bwd_launches, hk.lbfgs_update_fused.launches
        vals.append(phase.run(graphed, *args)[1])
        trips = phase.counter("lbfgs.trips") - trips0
        assert phase.counter("lbfgs.graph_replays") - replays0 == trips - 1 > 0
        assert hk.matern_fused.bwd_launches - bwd0 == trips
        assert hk.lbfgs_update_fused.launches - upd0 == trips
    assert phase.counter("lbfgs.fused_updates") == phase.counter("lbfgs.trips")
    assert phase.counter("lbfgs.capture:n") == 3  # one capture an ask
    monkeypatch.setattr(optimize, "_lbfgs_graphed", optimize._lbfgs_batched)
    eager = AcquisitionArgmax(enc, method="BFGS", n_restart=R, seed=11, device=dev)
    phase_e = _InPhase()
    for v in vals:
        ve = phase_e.run(eager, *args)[1]
        assert abs(v - ve) <= limit * max(abs(v), abs(ve)) and v > 0, (v, ve)
    assert phase_e.counter("lbfgs.graph_replays") == 0 and phase_e.counter("lbfgs.trips") > 0


def test_graphed_argmax_under_the_profiler(dev):
    """A graphed argmax under torch.profiler captures, replays and traces:
    the update kernel's device events are one a trip, and the winner is the
    bits of the same run without the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from bayesian_optimization_tpu_torch import AcquisitionArgmax, RealSpace

    state, config, plugin = _cell_posterior(dev, 5, 475)
    enc = RealSpace([[0.0, 1.0]] * 5).encoding()
    args = (state, config, "EI", {"plugin": plugin})
    plain = AcquisitionArgmax(enc, method="BFGS", n_restart=25, seed=5, device=dev)(*args)
    phase = _InPhase()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced = phase.run(AcquisitionArgmax(enc, method="BFGS", n_restart=25, seed=5, device=dev),
                           *args)
        torch.cuda.synchronize()
    assert np.array_equal(traced[0], plain[0]) and traced[1] == plain[1]
    updates = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and "lbfgs_update_kernel" in e.name]
    assert phase.counter("lbfgs.graph_replays") > 0
    assert len(updates) == phase.counter("lbfgs.trips")


@pytest.mark.parametrize("case", ["constrained", "float64", "sharded"])
def test_argmaxes_that_take_the_eager_loop(dev, monkeypatch, case):
    """A constrained criterion, a float64 state and a two-entry mesh run the
    eager live-lane loop: the graphed loop is never called."""
    from bayesian_optimization_tpu_torch import AcquisitionArgmax, ConstraintProgram, RealSpace
    from bayesian_optimization_tpu_torch.ops import optimize
    from bayesian_optimization_tpu_torch.parallel import make_particle_mesh

    def refuse(*a):
        raise AssertionError("the graphed loop ran")

    monkeypatch.setattr(optimize, "_lbfgs_graphed", refuse)
    dtype = torch.float64 if case == "float64" else torch.float32
    state, config, plugin = _cell_posterior(dev, 5, 200, dtype)
    enc = RealSpace([[0.0, 1.0]] * 5).encoding(dtype=dtype)
    kw = {"constrained": {"constraints": ConstraintProgram(enc, g=lambda x: np.sum(x) - 2.0,
                                                           device=dev)},
          "float64": {}, "sharded": {"mesh": make_particle_mesh(devices=["cuda:0"] * 2)}}[case]
    phase = _InPhase()
    u, v = phase.run(AcquisitionArgmax(enc, method="BFGS", n_restart=10, seed=0, device=dev, **kw),
                     state, config, "EI", {"plugin": plugin})
    assert np.all(np.isfinite(u)) and np.isfinite(v) and phase.counter("lbfgs.trips") > 0
    assert phase.counter("lbfgs.graph_replays") == 0


@pytest.mark.parametrize("shape", [(25, 5, 10), (100, 20, 10), (7, 3, 4)], ids=str)
def test_lbfgs_update_kernel_minus_one_guard(dev, shape):
    """The kernel on a full-width index, its lanes that are not live named
    -1 and their values and gradients NaN (never read): those lanes keep
    their state bit for bit, and the others end with the bits of the
    kernel's live-lane launch, and with the decisions of the twin on the
    same index, run on a copy of the state on the CPU (where the twin
    defines the -1 guard; its own test is a CPU test)."""
    from bayesian_optimization_tpu_torch.ops import hopper_kernels as hk
    from bayesian_optimization_tpu_torch.ops.optimize import (
        LBFGS_C1, lbfgs_state, lbfgs_update_plain,
    )

    R, d, m = shape
    for seed in range(3):
        st, idx, f_a, g_a, z_trial, _ = _lbfgs_trip(dev, R, d, m, seed, 0.6)
        live = _lbfgs_trip(dev, R, d, m, seed, 0.6)[0]
        twin = lbfgs_state(st.z.cpu(), m)
        twin.ws.copy_(st.ws.cpu())
        twin.iws.copy_(st.iws.cpu())
        named = torch.zeros(R, dtype=torch.bool, device=dev)
        named[idx] = True
        full = torch.where(named, torch.arange(R, device=dev), -1)
        f_full = torch.full((R,), math.nan, device=dev).index_put((idx,), f_a)
        g_full = torch.full((R, d), math.nan, device=dev).index_put((idx,), g_a)
        before = {n: getattr(st, n).clone() for n in LBFGS_DECISIONS + LBFGS_VALUES}
        hk.lbfgs_update_fused(st, full, f_full, g_full, z_trial, 20, LBFGS_C1)
        hk.lbfgs_update_fused(live, idx, f_a, g_a, z_trial, 20, LBFGS_C1)
        lbfgs_update_plain(twin, full.cpu(), f_full.cpu(), g_full.cpu(), z_trial.cpu(), 20)
        torch.cuda.synchronize()
        assert torch.equal(st.ws.nan_to_num(nan=7.0), live.ws.nan_to_num(nan=7.0))
        assert torch.equal(st.iws, live.iws)
        for name in LBFGS_DECISIONS:
            assert torch.equal(getattr(st, name).cpu(), getattr(twin, name)), (seed, name)
        for name, old in before.items():
            assert torch.equal(getattr(st, name)[~named].nan_to_num(nan=7.0),
                               old[~named].nan_to_num(nan=7.0)), (seed, name)


def _quadratic_lanes(dev, R=16, d=4):
    """A convex quadratic over lanes, (R, d) -> (R,), launching device work
    only; starts in its box [-2, 2]^d."""
    gen = torch.Generator().manual_seed(3)
    A = torch.randn(d, d, generator=gen)
    A = (A @ A.T / d + 0.5 * torch.eye(d)).to(dev)
    b = torch.randn(d, generator=gen).to(dev)
    x0 = (4.0 * torch.rand((R, d), generator=gen) - 2.0).to(dev)
    return (lambda x: 0.5 * ((x @ A) * x).sum(-1) - x @ b), x0


def test_graphed_loop_after_a_failed_capture(dev):
    """An objective marked capturable that reads the device (`.item()`)
    runs its eager first trip, then its capture raises. On the same thread
    the next graphed runs still capture and replay, both where the failed
    capture was the thread's first (no graph held its pool) and where a
    graph was held from before: each such run ends with the bits of the
    same run on a thread that never failed."""
    import threading

    from bayesian_optimization_tpu_torch.ops.optimize import minimize_restarts

    fun, x0 = _quadratic_lanes(dev)

    def reads(x):
        return fun(x) + 0.0 * float(x.sum().item())

    def graphed(f):
        phase = _InPhase()
        res = phase.run(minimize_restarts, f, x0, -2.0, 2.0, max_iter=30, capturable=True)
        torch.cuda.synchronize()
        return res, phase.counter("lbfgs.graph_replays")

    def on_a_thread(steps):
        out, errors = [], []

        def body():
            try:
                for step in steps:
                    if step == "fails":
                        with pytest.raises(RuntimeError):
                            graphed(reads)
                        out.append(None)
                    else:
                        out.append(graphed(fun))
            except BaseException as e:  # reported on the test's thread
                errors.append(e)

        t = threading.Thread(target=body)
        t.start()
        t.join()
        if errors:
            raise errors[0]
        return out

    clean = on_a_thread(["runs"])[0]
    runs = [r for r in on_a_thread(["fails", "runs", "fails", "runs"]) if r is not None]
    assert clean[1] > 0 and len(runs) == 2
    for res, replays in runs:
        assert replays == clean[1]
        assert torch.equal(res.x, clean[0].x) and torch.equal(res.fun, clean[0].fun)

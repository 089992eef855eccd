"""The port's hand-written kernels on one NVIDIA GPU: build, check, time.

    python3 chip_smoke.py

Phases, each printing on its own lines; any failure raises and exits
non-zero, and no phase's exception is caught:
  1. device: require a Hopper GPU; print its name, power limit and versions;
  2. build: compile the hand-written kernels of csrc/ (nvcc, sm_90a) and
     print ptxas's registers and spills per kernel;
  3. each kernel alone against its plain PyTorch twin on the card, at the
     shapes the benchmark's cells run (bench_port/, BENCHMARK.json):
     f8d5-mle.seq lays its fit out at 512 rows (n = 450-475, d = 5) and
     runs a 25-lane EI argmax; f8d20-mle.seq lays it out at 1920 rows
     (n = 1800-1825, d = 20: the hybrid factorisation, superpanels 1024 +
     896) and runs a 100-lane argmax. For each shape: the error against the
     twin and its tolerance, ms a call by CUDA events around 10 calls
     (median of 7 windows), ms on the device from the profiler (a session
     that traced no kernel retried, "not measured" if every try was empty:
     device times are printed, never checked), the bound and the kernel's
     share of it. The kernels: matern_fused's forward and backward at the
     warm refit's training matrix (dtheta, G masked as the likelihood masks
     it) and the argmax trip's cross matrix (dX); its second derivative at
     a Hessian row's shape (no cell runs it); whiten_fused at the d = 5
     refit and, through the hybrid, at the d = 20 refit; chol_inv_whiten at
     both posterior states; the L-BFGS update at both cells' argmax and
     refit lanes, on a state that the twin's own trips on Rosenbrock's
     function built.
Then the kernels' JSON line (each kernel's numbers at its first shape, and
a row a shape), the card's name and power limit, and last the result line
{"ok": true, "device": {...}}.

The paths that call the kernels are checked on the card by
tests/test_torch_cuda_kernels.py (marked `cuda`), and timed end to end by
the benchmark.

Bounds: the least time the card could take for a call, the larger of its
bytes (each input read once, each output written once) over 3.35 TB/s and
its FP32 operations over 67 TFLOP/s (an H100 SXM's published peaks).
"""
import json
import math
import re
import statistics
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType

from bayesian_optimization_tpu_torch import require_cuda
from bayesian_optimization_tpu_torch.ops import _build, optimize
from bayesian_optimization_tpu_torch.ops.hopper_kernels import (
    _nu_code, lbfgs_update_fused, matern_bwd2_fused, matern_bwd2_plain, matern_bwd_fused,
    matern_bwd_plain, matern_fused, matern_plain, whiten_fused, whiten_plain,
)
from bayesian_optimization_tpu_torch.ops.linalg import SUPER, _block_tri_inv, _whiten_parts, chol_inv_whiten

MATERN_TOL = 5e-6      # absolute, as tests/test_pallas.py holds matern_pallas
MATERN_BWD_TOL = 1e-4  # max |g - g_twin| / max |g_twin|, the twin in float64
WHITEN_L_TOL = 1e-4    # max |L - L_twin| / max |L_twin|
WHITEN_W_TOL = 1e-3    # max |W - W_twin| / max(1, max |W_twin|)
CHOL_INV_TOL = 1e-3    # max |L^-1 - plain| / max |plain|
LBFGS_TOL = 2e-5       # max |v - v_twin| / max(1, max |v_twin|) a lane, as the card's tests hold it
# the L-BFGS state's fields that the update kernel must leave as its twin
# does, bit for bit (its decisions, the moved points and gradients, the
# stored pairs), and those it computes in another order
LBFGS_EXACT = ("k", "n_probe", "n_accept", "done", "t", "z", "g", "S", "Y")
LBFGS_CLOSE = ("f", "rho", "gamma", "p", "gTp")
PALLAS = "bayesian_optimization_tpu/ops/pallas_kernels.py"
HBM_BYTES_PER_S = 3.35e12   # H100 SXM
FP32_FLOP_PER_S = 67e12     # H100 SXM, outside the tensor cores

# the cells' shapes. (label, lanes B, rows N, M or None for the training
# matrix, D, live rows): the warm refit's two lanes on the fit's layout,
# its padding masked, and an argmax trip's lanes against it (one theta
# vector, as the argmax calls it)
MATERN_SHAPES = (("f8d5 warm refit", 2, 512, None, 5, 475), ("f8d5 argmax trip", 1, 25, 512, 5, None),
                 ("f8d20 warm refit", 2, 1920, None, 20, 1800),
                 ("f8d20 argmax trip", 1, 100, 1920, 20, None))
# (label, B, N, M, D): a Hessian's cross matrix, one query against 1024 rows
MATERN_BWD2_SHAPES = (("Hessian row", 1, 1, 1024, 5),)
# (label, batch, rows, live rows, right-hand sides: y and the constant trend)
WHITEN_SHAPES = (("f8d5 warm refit", 2, 512, 475, 2), ("f8d20 warm refit, hybrid 1024 + 896", 2, 1920, 1800, 2))
CHOL_INV_SHAPES = (("f8d5 posterior state", 512, 475), ("f8d20 posterior state", 1920, 1800))
# (label, lanes R, d, history m): the argmax's lanes over the d features and
# the refit's two over d thetas and the process variance
LBFGS_SHAPES = (("f8d5 EI argmax", 25, 5, 10), ("f8d5 warm refit", 2, 6, 10),
                ("f8d20 EI argmax", 100, 20, 10), ("f8d20 warm refit", 2, 21, 10))


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, windows: int = 7, calls: int = 10) -> float:
    """ms per call of fn(), by CUDA events around `calls` back-to-back calls,
    median over `windows` windows after a warm-up. The wrapper's host work
    is inside the window: where it outlasts the device work, this is the
    host's enqueue rate, which device_ms tells apart."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


PROFILE_TRIES = 5
# profiler sessions run and those that traced no kernel: now and then the
# profiler delivers no kernel record for up to three sessions in a row, so
# an empty session is retried, and device times are "not measured" only if
# every try is empty
PROFILER_SESSIONS = {"run": 0, "empty": 0}


def fmt(x, spec: str = ".4f") -> str:
    return "not measured" if x is None else format(x, spec)


def ratio(a, b):
    """a / b, None where either was not measured."""
    return None if a is None or b is None else a / b


def device_ms_by_kernel(fn, calls: int = 10):
    """Device ms per call of fn(), by kernel name: the summed duration of the
    kernels of each name the profiler traced over `calls` calls, divided by
    `calls`; None if PROFILE_TRIES sessions in a row traced no kernel."""
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        PROFILER_SESSIONS["run"] += 1
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / calls
        if by_name:
            return by_name
        PROFILER_SESSIONS["empty"] += 1
    log(f"  (the profiler traced no kernel in {PROFILE_TRIES} sessions: device times not measured)")
    return None


def device_ms(fn, calls: int = 10):
    """Device ms per call of fn(): every traced kernel's time, summed; None
    if not measured."""
    by_name = device_ms_by_kernel(fn, calls)
    return None if by_name is None else sum(by_name.values())


def bound(nbytes: float, flops: float):
    """(bound ms, what sets it) for a call that moves nbytes and does flops."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def matern_bound(B: int, N: int, M, D: int):
    """The forward's bound: K written once, theta, X and Y read once; per
    element 4 D FP32 operations for the distance (sub, mul, fma) and ~8 for
    the map."""
    m = N if M is None else M
    return bound(4 * (B * N * m + B * D + N * D + (0 if M is None else m * D)),
                 B * N * m * (4 * D + 8))


def matern_bwd_bound(B: int, N: int, M, need, D: int):
    """The backward's bound: G read once, theta, X, Y read once, the asked
    gradients written once; per element 4 D + 9 operations for the distance,
    the map's derivative and A, 4 D for dtheta, 2 D for each of dX, dY."""
    m = N if M is None else M
    out = need[0] * B * D + need[1] * N * D + (need[2] and M is not None) * m * D
    per = 4 * D + 9 + 4 * D * need[0] + 2 * D * (need[1] + need[2])
    return bound(4 * (B * N * m + B * D + N * D + (0 if M is None else m * D) + out),
                 B * N * m * per)


def matern_bwd2_bound(B: int, N: int, M: int, D: int):
    """The second derivative's bound: G read and gG written once, theta, X,
    Y and V read once, gX written once; per element 4 D operations for r2
    and c, ~15 for the map's two derivatives and the scalars, 4 D for gX."""
    return bound(4 * (2 * B * N * M + B * D + 3 * N * D + M * D), B * N * M * (8 * D + 15))


def whiten_bound(batch: int, n: int, mb: int):
    """whiten_fused's bound: R and B read, L, W, Dinv and piv written; the
    Cholesky (n^3/3), the forward solve (n^2 mb) and the 128-block inverses
    (T^3/3 each), per matrix."""
    T = min(n, 128)
    return bound(4 * batch * (n * n + n * mb + n * n + n * mb + n * T + 1),
                 batch * (n ** 3 / 3 + n * n * mb + (n // T) * T ** 3 / 3))


def chol_inv_bound(batch: int, n: int, mb: int):
    """chol_inv_whiten's bound: R and B read, L, L^-1 and W written; the
    Cholesky (n^3/3), the triangular inverse (n^3/3) and the forward solve
    (n^2 mb), per matrix."""
    return bound(4 * batch * (3 * n * n + 2 * n * mb + 1), batch * (2 * n ** 3 / 3 + n * n * mb))


def lbfgs_bound(R: int, d: int, m: int):
    """The L-BFGS update's bound: each lane's state (z, g, p, S, Y, rho,
    the recursion's scratch, f, gamma, gTp, t: 3 d + 2 m d + 2 m + 4 floats;
    4 int64 counters) read and written once, its value, gradient and trial
    point and its index read once; 8 m d operations for the two-loop
    recursion and ~12 d for the tests and the pair."""
    floats = 3 * d + 2 * m * d + 2 * m + 4
    return bound(R * (2 * (4 * floats + 8 * 4) + 4 * (1 + 2 * d) + 8), R * (8 * m * d + 12 * d))


WHITEN_PARTS = (("diagonal", "chol_diag_kernel"), ("panel", "panel_solve_kernel"),
                ("trailing", "trailing_update_kernel"))


def whiten_split(by_name):
    """A factorisation's device ms split into whiten_fused's three kernels
    (by name) and everything else it ran (the workspace copies, the
    hybrid's Schur GEMMs)."""
    split = dict.fromkeys([part for part, _ in WHITEN_PARTS] + ["other"], 0.0)
    for name, ms in by_name.items():
        split[next((p for p, k in WHITEN_PARTS if k in name), "other")] += ms
    return split


def kernel_like(batch: int, n: int, live: int, seed: int) -> torch.Tensor:
    """SPD correlation matrices like the GP's (Matern-3/2 on random points,
    with the 1e-2 jitter of the matrices tests/test_pallas.py holds
    whiten_fused to: the W tolerance assumes that conditioning) on the
    first `live` rows, the padding decoupled (the identity) as the
    likelihood leaves it."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.rand((live, 5), generator=g, device="cuda")
    theta = 10 ** (torch.rand((batch, 5), generator=g, device="cuda") * 2 - 1)
    R = torch.eye(n, device="cuda").repeat(batch, 1, 1)
    R[:, :live, :live] = matern_plain(theta, X, nu=1.5) + 1e-2 * torch.eye(live, device="cuda")
    return R


def right_hand_sides(batch: int, n: int, live: int, seed: int) -> torch.Tensor:
    """(batch, n, 2): y and the constant trend on the live rows, 0 below."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    B = torch.ones((batch, n, 2), device="cuda")
    B[..., 0] = torch.randn((batch, n), generator=g, device="cuda")
    B[:, live:] = 0.0
    return B


def matern_inputs(B: int, N: int, M, D: int, seed: int):
    """(theta (B, D), X, Y): the training matrix's rows (Y = X) or the
    argmax's queries X against the training rows Y; theta as a fit leaves it
    (log10 in [-1, 1] at d = 5, in [-2, 0] at d = 20: r^2 ~ 1, so K spans
    its range)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.rand((N, D), generator=g, device="cuda")
    Y = X if M is None else torch.rand((M, D), generator=g, device="cuda")
    lo = -1.0 if D <= 8 else -2.0
    theta = 10 ** (lo + 2 * torch.rand((B, D), generator=g, device="cuda"))
    return theta, X, Y


def shape_row(label, shape, err, t_k, t_p, b_ms, b_by, d_k, d_p) -> dict:
    """One shape's numbers for the kernels' JSON line: ms a call by events
    (kernel and twin), ms on the device, and the bound."""
    return {"path": label, "shape": list(shape), "max_abs_err": err, "ms": t_k, "plain_ms": t_p,
            "device_ms": d_k, "plain_device_ms": d_p, "bound_ms": b_ms, "bound_by": b_by,
            "share_of_bound": ratio(b_ms, d_k)}


def log_row(name: str, row: dict, errs: str) -> None:
    log(f"  {name} {row['path']} {tuple(row['shape'])}: {errs}; kernel {row['ms']:.4f} ms/call "
        f"({fmt(row['device_ms'])} ms on the device), bound {row['bound_ms']:.4g} ms ({row['bound_by']}), "
        f"share of bound {fmt(row['share_of_bound'], '.4f')}; twin {row['plain_ms']:.4f} ms/call "
        f"({fmt(row['plain_device_ms'])} ms on the device)")


def check_matern():
    """The forward at each cell shape and nu against the twin (the exact
    unit diagonal of the training matrix); its backward there, the
    gradients the path asks (the fit's dtheta of K(X, X), G masked as
    _masked_correlation masks it; the argmax's dX), against the twin in
    float64 for every nu. Times at nu = 3/2. Returns the forward's and the
    backward's rows."""
    fwd, bwd = [], []
    for label, B, N, M, D, live in MATERN_SHAPES:
        theta, X, Y = matern_inputs(B, N, M, D, seed=N + D)
        same = M is None
        args = (theta, X) if same else (theta[0], X, Y)
        err = 0.0
        for nu in (0.5, 1.5, 2.5, math.inf):
            K = matern_fused(*args, nu=nu)
            K0 = matern_plain(*args, nu=nu)
            torch.cuda.synchronize()
            err = max(err, float((K - K0).abs().max()))
            assert err < MATERN_TOL, (label, nu, err)
            if same:
                assert float((K.diagonal(dim1=-2, dim2=-1) - 1).abs().max()) == 0.0, (label, nu)
        b_ms, b_by = matern_bound(B, N, M, D)
        row = shape_row(label, (B, N, Y.shape[0], D), err,
                        time_ms(lambda: matern_fused(*args, nu=1.5)),
                        time_ms(lambda: matern_plain(*args, nu=1.5)), b_ms, b_by,
                        device_ms(lambda: matern_fused(*args, nu=1.5)),
                        device_ms(lambda: matern_plain(*args, nu=1.5)))
        fwd.append(row)
        log_row("matern_fused", row, f"max|K-K_twin| over the four maps {err:.3e} (tol {MATERN_TOL})")

        g = torch.Generator(device="cuda").manual_seed(N + 1)
        G = torch.randn((B, N, Y.shape[0]), generator=g, device="cuda")
        if same:
            mask = (torch.arange(N, device="cuda") < live).float()
            G = G * (torch.outer(mask, mask) * (1 - torch.eye(N, device="cuda")))
        need = (True, False, False) if same else (False, True, False)
        at = 0 if same else 1
        errs, worst = [], 0.0
        for nu in (0.5, 1.5, 2.5, math.inf):
            code = _nu_code(nu)
            got = matern_bwd_fused(theta, X, Y, G, code, same, same, need)[at]
            K64 = matern_plain(theta.double(), X.double(), Y.double(), nu=nu, sym=same)
            want = matern_bwd_plain(theta.double(), X.double(), Y.double(), K64, G.double(), code,
                                    same, same, need)[at]
            torch.cuda.synchronize()
            e = float((got.double() - want).abs().max())
            rel = e / float(want.abs().max())
            worst = max(worst, e)
            errs.append(f"nu={nu} {rel:.2e}")
            assert bool(torch.isfinite(got).all()) and rel < MATERN_BWD_TOL, (label, nu, rel)
        code = _nu_code(1.5)
        K32 = matern_plain(theta, X, Y, nu=1.5, sym=same)

        def kernel():
            return matern_bwd_fused(theta, X, Y, G, code, same, same, need)

        def twin():
            return matern_bwd_plain(theta, X, Y, K32, G, code, same, same, need)

        b_ms, b_by = matern_bwd_bound(B, N, M, need, D)
        row = shape_row(label, (B, N, Y.shape[0], D), worst, time_ms(kernel), time_ms(twin), b_ms, b_by,
                        device_ms(kernel), device_ms(twin))
        bwd.append(row)
        log_row("matern backward, d" + ("theta" if same else "X"), row,
                f"rel err against the float64 twin {'; '.join(errs)} (tol {MATERN_BWD_TOL})")
    return fwd, bwd


def check_matern_bwd2():
    """The second-derivative kernel against matern_bwd2_plain in float64,
    both outputs (gG, gX), every map; times at nu = 3/2. Returns its rows."""
    rows = []
    for label, B, N, M, D in MATERN_BWD2_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(3)
        theta = 10 ** (torch.rand((B, D), generator=g, device="cuda") * 2.5 - 1)
        X, Y = (torch.rand((k, D), generator=g, device="cuda") for k in (N, M))
        G = torch.randn((B, N, M), generator=g, device="cuda")
        V = torch.randn((N, D), generator=g, device="cuda")
        errs, worst = [], 0.0
        for nu in (0.5, 1.5, 2.5, math.inf):
            code = _nu_code(nu)
            got = matern_bwd2_fused(theta, X, Y, G, V, code, False, (True, True))
            want = matern_bwd2_plain(*(t.double() for t in (theta, X, Y, G, V)), code, False,
                                     (True, True))
            torch.cuda.synchronize()
            for name, a, w in zip(("gG", "gX"), got, want):
                e = float((a.double() - w).abs().max())
                rel = e / float(w.abs().max())
                worst = max(worst, e)
                errs.append(f"nu={nu} {name} {rel:.2e}")
                assert rel < MATERN_BWD_TOL, (label, nu, name, rel)
        code = _nu_code(1.5)

        def kernel():
            return matern_bwd2_fused(theta, X, Y, G, V, code, False, (True, True))

        def twin():
            return matern_bwd2_plain(theta, X, Y, G, V, code, False, (True, True))

        b_ms, b_by = matern_bwd2_bound(B, N, M, D)
        row = shape_row(label, (B, N, M, D), worst, time_ms(kernel), time_ms(twin), b_ms, b_by,
                        device_ms(kernel), device_ms(twin))
        rows.append(row)
        log_row("matern second derivative", row,
                f"rel err against the float64 twin {'; '.join(errs)} (tol {MATERN_BWD_TOL})")
    return rows


HYBRID_FACTOR = 4.0  # the hybrid's error against float64 over the twin's own, as the card's tests hold it


def rel(a, b) -> float:
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


def factor_checks(label: str, n: int, R, B, got: dict, plain: dict) -> str:
    """The factorisation's outputs `got` (L, W, and L^-1 where asked)
    against the plain path's `plain` on the same card. Up to one
    whiten_fused call (SUPER rows): L within WHITEN_L_TOL of the twin's
    largest entry, W within WHITEN_W_TOL of max(1, its largest), L^-1
    within CHOL_INV_TOL. Above it (the hybrid's superpanels, whose Schur
    updates round once more a panel): each no farther from float64 than
    HYBRID_FACTOR times the twin's own float32 error. Returns the errors."""
    if n <= SUPER:
        errs = {"L": rel(got["L"], plain["L"]),
                "W": float((got["W"] - plain["W"]).abs().max()) / max(1.0, float(plain["W"].abs().max()))}
        tol = {"L": WHITEN_L_TOL, "W": WHITEN_W_TOL}
        if "L_inv" in got:
            errs["L^-1"], tol["L^-1"] = rel(got["L_inv"], plain["L_inv"]), CHOL_INV_TOL
        assert all(errs[k] < tol[k] for k in errs), (label, errs)
        return ", ".join(f"{k} {errs[k]:.3e} (tol {tol[k]})" for k in errs)
    L64 = torch.linalg.cholesky(R.double())
    want = {"L": L64, "W": torch.linalg.solve_triangular(L64, B.double(), upper=False)}
    if "L_inv" in got:
        want["L_inv"] = torch.linalg.solve_triangular(L64, torch.eye(n, dtype=torch.float64, device=R.device),
                                                      upper=False)
    errs = {k: (rel(got[k], w), rel(plain[k], w)) for k, w in want.items()}
    assert all(e <= HYBRID_FACTOR * e0 for e, e0 in errs.values()), (label, errs)
    return ", ".join(f"{k} {e:.3e} (the twin's {e0:.3e}, tol x{HYBRID_FACTOR:g})"
                     for k, (e, e0) in errs.items()) + " against float64"


def check_whiten():
    """The refits' factorisation against whiten_plain: one whiten_fused call
    at 512 rows, the hybrid (`_whiten_parts`: whiten_fused a superpanel
    and the Schur updates between them) at 1920; the device time split by
    kernel name. Returns its rows."""
    rows = []
    for label, batch, n, live, mb in WHITEN_SHAPES:
        R = kernel_like(batch, n, live, seed=n)
        B = right_hand_sides(batch, n, live, seed=n)
        R_before = R.clone()
        before = whiten_fused.launches
        _, W, piv, L, _ = _whiten_parts(R, B)
        torch.cuda.synchronize()
        assert whiten_fused.launches == before + -(-n // SUPER), (label, whiten_fused.launches - before)
        assert torch.equal(R, R_before), "the factorisation wrote the caller's R"
        assert bool((piv > 0).all()), (label, piv)
        _, W0, _, L0, _ = whiten_plain(R, B)
        errs = factor_checks(label, n, R, B, {"L": L, "W": W}, {"L": L0, "W": W0})
        err = max(float((L - L0).abs().max()), float((W - W0).abs().max()))
        by_name = device_ms_by_kernel(lambda: _whiten_parts(R, B))
        b_ms, b_by = whiten_bound(batch, n, mb)
        row = shape_row(label, (batch, n, n, mb), err, time_ms(lambda: _whiten_parts(R, B)),
                        time_ms(lambda: whiten_plain(R, B)), b_ms, b_by,
                        None if by_name is None else sum(by_name.values()),
                        device_ms(lambda: whiten_plain(R, B)))
        rows.append(row)
        log_row("whiten_fused", row, f"relerr {errs}; min piv {float(piv.min()):.3e}")
        if by_name is not None:
            log("    device split: " + ", ".join(f"{part} {ms:.4f} ms"
                                                  for part, ms in whiten_split(by_name).items()))
    for label, n, live in CHOL_INV_SHAPES:
        rows.append(check_chol_inv_whiten(label, n, live))
    return rows


def check_chol_inv_whiten(label: str, n: int, live: int) -> dict:
    """chol_inv_whiten for a posterior state (R (n, n), B (n, 2)) against its
    plain path (whiten_plain and the same block inversion) on the card, as
    factor_checks holds it; returns its row."""
    R = kernel_like(1, n, live, seed=n + 1)[0]
    B = right_hand_sides(1, n, live, seed=n + 1)[0]

    def plain():
        _, W0, piv0, L0, Dinv0 = whiten_plain(R[None], B[None])
        return L0[0], _block_tri_inv(L0, Dinv0)[0], W0[0], piv0

    L, L_inv, W, piv = chol_inv_whiten(R, B)
    L0, L_inv0, W0, _ = plain()
    torch.cuda.synchronize()
    assert float(piv) > 0, (label, piv)
    errs = factor_checks(label, n, R, B, {"L": L, "W": W, "L_inv": L_inv},
                         {"L": L0, "W": W0, "L_inv": L_inv0})
    err = max(float((L - L0).abs().max()), float((W - W0).abs().max()))
    b_ms, b_by = chol_inv_bound(1, n, 2)
    row = shape_row(f"chol_inv_whiten, {label}", (1, n, n, 2), err,
                    time_ms(lambda: chol_inv_whiten(R, B), windows=5, calls=3), time_ms(plain, windows=5, calls=3),
                    b_ms, b_by, device_ms(lambda: chol_inv_whiten(R, B), calls=3), device_ms(plain, calls=3))
    log_row("chol_inv_whiten", row, f"relerr {errs}")
    return row


def rosenbrock_grad(Z: torch.Tensor):
    """(f, g) of Rosenbrock's function at each row of Z."""
    Z = Z.detach().requires_grad_(True)
    f = (100.0 * (Z[:, 1:] - Z[:, :-1] ** 2) ** 2 + (1.0 - Z[:, :-1]) ** 2).sum(-1)
    (g,) = torch.autograd.grad(f.sum(), Z)
    return f.detach(), g


def lbfgs_trip(R: int, d: int, m: int, seed: int, trips: int = 30):
    """(state, idx, f_a, g_a, z_trial) of a trip part way through a run:
    R lanes of the twin's own L-BFGS on Rosenbrock's function from random
    starts in [-2, 2]^d after `trips` trips (the histories filled and
    wrapped, the lanes still moving), every lane live."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    st = optimize.lbfgs_state(4 * torch.rand((R, d), generator=g, device="cuda") - 2, m)
    idx = torch.arange(R, device="cuda")
    for trip in range(trips + 1):
        z_trial = (st.z + st.t[:, None] * st.p).clamp(-optimize._Z_CLIP, optimize._Z_CLIP)
        f_a, g_a = rosenbrock_grad(z_trial)
        if trip == trips:
            return st, idx, f_a, g_a, z_trial
        optimize.lbfgs_update_plain(st, idx, f_a, g_a, z_trial, 20)


def lbfgs_gap(got, want) -> float:
    """The largest of |got - want| / max(1, max |want|) over the lanes (the
    leading axis), where both are finite; inf where they are not finite at
    the same entries or differ there."""
    fin = torch.isfinite(want)
    if not torch.equal(fin, torch.isfinite(got)) or not torch.equal(
            got[~fin].nan_to_num(nan=7.0), want[~fin].nan_to_num(nan=7.0)):
        return math.inf
    R = want.shape[0]
    g, w = (torch.where(fin, v, torch.zeros_like(v)).reshape(R, -1) for v in (got, want))
    return float(((g - w).abs().amax(-1) / w.abs().amax(-1).clamp_min(1.0)).max())


def check_lbfgs_update():
    """The update kernel against its twin from one state at each cell shape:
    the same decisions and moved points bit for bit, the other values
    within LBFGS_TOL a lane, two launches the same bits; timed with the
    state's restore inside each call. Returns its rows."""
    rows = []
    for label, R, d, m in LBFGS_SHAPES:
        st, idx, f_a, g_a, z_trial = lbfgs_trip(R, d, m, seed=R + d)
        ws0, iws0 = st.ws.clone(), st.iws.clone()

        def state():
            s = optimize.lbfgs_state(torch.zeros((R, d), device="cuda"), m)
            s.ws.copy_(ws0)
            s.iws.copy_(iws0)
            return s

        a, b, t = state(), state(), state()
        lbfgs_update_fused(a, idx, f_a, g_a, z_trial, 20, optimize.LBFGS_C1)
        lbfgs_update_fused(b, idx, f_a, g_a, z_trial, 20, optimize.LBFGS_C1)
        optimize.lbfgs_update_plain(t, idx, f_a, g_a, z_trial, 20)
        torch.cuda.synchronize()
        assert torch.equal(a.ws.nan_to_num(nan=7.0), b.ws.nan_to_num(nan=7.0)) and torch.equal(
            a.iws, b.iws), f"the L-BFGS update kernel is not bit-identical over two launches ({label})"
        for name in LBFGS_EXACT:
            assert torch.equal(getattr(a, name).nan_to_num(nan=7.0),
                               getattr(t, name).nan_to_num(nan=7.0)), (label, name)
        gap = max(lbfgs_gap(getattr(a, name), getattr(t, name)) for name in LBFGS_CLOSE)
        assert gap <= LBFGS_TOL, (label, gap)
        moved = int((a.n_accept > iws0.view(4, R)[2]).sum())

        def kernel():
            st.ws.copy_(ws0)
            st.iws.copy_(iws0)
            lbfgs_update_fused(st, idx, f_a, g_a, z_trial, 20, optimize.LBFGS_C1)

        def twin():
            st.ws.copy_(ws0)
            st.iws.copy_(iws0)
            optimize.lbfgs_update_plain(st, idx, f_a, g_a, z_trial, 20)

        by_name = device_ms_by_kernel(kernel)
        d_k = None if by_name is None else sum(ms for name, ms in by_name.items() if "lbfgs" in name)
        b_ms, b_by = lbfgs_bound(R, d, m)
        row = shape_row(label, (R, d, m), gap, time_ms(kernel), time_ms(twin), b_ms, b_by, d_k,
                        device_ms(twin))
        row["max_rel_err"] = row.pop("max_abs_err")
        rows.append(row)
        log(f"  lbfgs_update_fused {label} (R, d, m) = ({R}, {d}, {m}), {moved} of {R} lanes concluding "
            f"their step: decisions and moved points equal to the twin's, worst gap {gap:.2e} (tol "
            f"{LBFGS_TOL}), two launches bit-identical; kernel {row['ms']:.4f} ms/call with the state's "
            f"restore ({fmt(d_k)} ms on the device, the kernel alone), bound {b_ms:.3g} ms ({b_by}), "
            f"share {fmt(row['share_of_bound'], '.4f')}; twin {row['plain_ms']:.4f} ms/call")
    return rows


def ptxas_summary(log_text: str):
    """One line per kernel of the build's ptxas report: registers and spill
    bytes. Of the Matern kernels' instantiations (per feature chunk DC and
    map) only those of D = 5 are listed, and any that spills."""
    kernels, name = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            kernels[name] = [0, 0]
        elif name and "spill stores" in line:
            kernels[name][1] = int(re.search(r"(\d+) bytes spill stores", line).group(1))
        elif name and "Used" in line:
            kernels[name][0] = int(re.search(r"Used (\d+) registers", line).group(1))
    out = []
    for mangled, (regs, spill) in kernels.items():
        # _ZN <namespace> <name> [I <template args> E] E <parameters>
        i, parts = mangled.index("_ZN") + 3, []
        for _ in range(2):
            n = re.match(r"\d+", mangled[i:]).group()
            parts.append(mangled[i + len(n):i + len(n) + int(n)])
            i += len(n) + int(n)
        short = parts[1]
        args = re.findall(r"L[ib](\d+)E", mangled[i:].split("EEv")[0]) if mangled[i] == "I" else []
        if short.startswith("matern") and args and args[0] != "5" and not spill:
            continue
        out.append(f"{short}<{','.join(args)}>: {regs} registers, {spill} B spill stores")
    return len(kernels), out


def kernel_entry(name: str, source: str, replaces, rows: list) -> dict:
    """A kernel's entry of the JSON line: its numbers at its first shape,
    and every shape's row. No single PyTorch call computes any of them."""
    head = rows[0]
    err = "max_rel_err" if "max_rel_err" in head else "max_abs_err"
    return {"name": name, "route": "cuda", "source": f"bayesian_optimization_tpu_torch/csrc/{source}",
            "replaces": replaces, err: max(r[err] for r in rows), "ms": head["ms"],
            "plain_ms": head["plain_ms"], "device_ms": head["device_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": None, "shapes": rows}


def main() -> None:
    t_start = time.perf_counter()
    # 1. device
    require_cuda()
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    log(f"[1] device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | python {sys.version.split()[0]}")

    # 2. build
    t0 = time.perf_counter()
    _build.load_library()
    log(f"[2] kernels built from csrc/ in {time.perf_counter() - t0:.2f} s -> {_build.library_path().name}")
    n_kernels, lines = ptxas_summary(_build.build_log())
    log(f"  ptxas: {n_kernels} kernels")
    for line in lines:
        log(f"  ptxas: {line}")

    # 3. each kernel against its twin at the cells' shapes
    log(f"[3] kernels vs plain twins on the card, at the cells' shapes "
        f"(starts at {time.perf_counter() - t_start:.1f} s)")
    m_rows, b_rows = check_matern()
    h_rows = check_matern_bwd2()
    w_rows = check_whiten()
    l_rows = check_lbfgs_update()
    log(f"  profiler sessions: {PROFILER_SESSIONS['run']}, of which {PROFILER_SESSIONS['empty']} traced "
        f"no kernel")

    # the L-BFGS update replaces no TPU kernel: XLA fused the JAX loop's update
    kernels = [kernel_entry("matern_fused", "matern.cu", f"{PALLAS}:98", m_rows),
               kernel_entry("matern_fused_bwd", "matern.cu", f"{PALLAS}:98", b_rows),
               kernel_entry("matern_fused_bwd2", "matern_bwd2.cu", f"{PALLAS}:98", h_rows),
               kernel_entry("whiten_fused", "whiten.cu", f"{PALLAS}:278", w_rows),
               kernel_entry("lbfgs_update_fused", "lbfgs.cu", None, l_rows)]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

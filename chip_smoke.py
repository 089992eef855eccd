"""End-to-end smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing on its own lines; any failure raises and exits
non-zero, and no phase's exception is caught:
  1. device: require a Hopper GPU; print its name, power limit and versions;
  2. build: compile the hand-written kernels of csrc/ (nvcc, sm_90a);
  3. each kernel against its plain PyTorch twin on the card, at the main
     path's shapes (whiten_fused also at ragged blocks of n <= 128 and at
     the hybrid factorisation's panel shape): max error against the stated
     tolerance, and both times (ms per call by CUDA events around 10 calls,
     median of 7 windows; ms on the device from the profiler); matern_fused's
     forward at every main-path shape with its share of the bound, and its
     backward kernel against the torch backward it replaces (error against
     the twin in float64, bit-identical repeats, device ms of both);
     whiten_fused's device time split by kernel name into its diagonal,
     panel and trailing kernels at (2, 1024), (10, 1024) and the hybrid
     panel; a failed lane (indefinite, NaN) flagged by its pivot; then the
     card's likelihood and gradient against the plain path on the CPU, on
     a small input;
  4. the main path at bench size (bench.py: n=1000, d=5): GaussianProcess.fit
     plus the BFGS EI argmax with 25 restarts, 2 warm-ups and 5 timed reps;
     the launch counters are zeroed just before and read just after, and
     every kernel (the Matern backward included) must have launched; one
     backward call is one L-BFGS trip, so the counters also give the trips;
     then the likelihood and gradient at this size against the plain path
     on the CPU;
  5. one fit at n=4000 (bucket 4096, the hybrid factorisation);
  6. fmin on the 2-D sphere (30 evaluations, seed 42);
then the kernels' JSON line, the card's name and power limit, and last the
result line {"ok": true, "device": {...}}.

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

import numpy as np
import torch
from torch.autograd import DeviceType

from bayesian_optimization_tpu_torch import AcquisitionArgmax, GaussianProcess, RealSpace, fmin
from bayesian_optimization_tpu_torch import constant_trend, require_cuda
from bayesian_optimization_tpu_torch.models.likelihood import PIV_TOL, GPConfig, neg_log_likelihood
from bayesian_optimization_tpu_torch.ops import _build
from bayesian_optimization_tpu_torch.ops.hopper_kernels import (
    _nu_code, matern_bwd_fused, matern_bwd_plain, matern_fused, matern_plain,
    reset_launch_counts, whiten_fused, whiten_plain,
)

DIM = 5
MATERN_TOL = 5e-6      # absolute, as tests/test_pallas.py holds matern_pallas
MATERN_BWD_TOL = 1e-4  # max |g - g_twin| / max |g_twin|, the twin in float64
WHITEN_L_TOL = 1e-4    # max |L - L_twin| / max |L_twin|
WHITEN_W_TOL = 1e-3    # max |W - W_twin| / max(1, max |W_twin|)
PALLAS = "bayesian_optimization_tpu/ops/pallas_kernels.py"
HBM_BYTES_PER_S = 3.35e12   # H100 SXM
FP32_FLOP_PER_S = 67e12     # H100 SXM, outside the tensor cores

# (label, lanes B, N, M or None for the training matrix): the shapes the
# main path gives matern_fused
MATERN_SHAPES = (("cold ladder rung 1", 10, 256, None), ("cold ladder rung 2", 6, 512, None),
                 ("warm refit", 2, 1024, None), ("posterior state", 1, 1024, None),
                 ("argmax trip", 1, 25, 1024), ("headline", 10, 1024, None))


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


def kernel_profile(fn, calls: int = 10) -> dict:
    """Per call of fn(), by kernel name: [device ms, launches], the summed
    duration and count of the kernels of each name the profiler traced over
    `calls` calls, divided by `calls`."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms_n = by_name.setdefault(e.name, [0.0, 0.0])
            ms_n[0] += e.time_range.elapsed_us() / 1e3 / calls
            ms_n[1] += 1 / calls
    assert by_name, "the profiler traced no kernel"
    return by_name


def device_ms_by_kernel(fn, calls: int = 10) -> dict:
    """Device ms per call of fn(), by kernel name."""
    return {name: ms for name, (ms, _) in kernel_profile(fn, calls).items()}


def device_ms(fn, calls: int = 10) -> float:
    """Device ms per call of fn(): every traced kernel's time, summed."""
    return sum(device_ms_by_kernel(fn, calls).values())


def bound(nbytes: float, flops: float):
    """(bound ms, what sets it) for a call that moves nbytes and does flops."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def matern_bound(B: int, N: int, M, D: int = DIM):
    """The forward's bound: K written once, theta, X and Y read once; per
    element 4 D FP32 operations for the distance (sub, mul, fma) and ~8 for
    the map."""
    m = N if M is None else M
    return bound(4 * (B * N * m + B * D + N * D + (0 if M is None else m * D)),
                 B * N * m * (4 * D + 8))


def matern_bwd_bound(B: int, N: int, M, need, D: int = DIM):
    """The backward's bound: G read once, theta, X, Y read once, the asked
    gradients written once; per element 4 D + 9 operations for the distance,
    the map's derivative and A, 4 D for dtheta, 2 D for each of dX, dY."""
    m = N if M is None else M
    out = need[0] * B * D + need[1] * N * D + (need[2] and M is not None) * m * D
    per = 4 * D + 9 + 4 * D * need[0] + 2 * D * (need[1] + need[2])
    return bound(4 * (B * N * m + B * D + N * D + (0 if M is None else m * D) + out),
                 B * N * m * per)


def whiten_bound(batch: int, n: int, mb: int):
    """whiten_fused's bound: R and B read, L, W, Dinv and piv written; the
    Cholesky (n^3/3), the forward solve (n^2 mb) and the 128-block inverses
    (T^3/3 each), per matrix."""
    T = min(n, 128)
    return bound(4 * batch * (n * n + n * mb + n * n + n * mb + n * T + 1),
                 batch * (n ** 3 / 3 + n * n * mb + (n // T) * T ** 3 / 3))


WHITEN_PARTS = (("diagonal", "chol_diag_kernel"), ("panel", "panel_solve_kernel"),
                ("trailing", "trailing_update_kernel"))


def whiten_split(fn, calls: int = 10) -> dict:
    """whiten_fused's device ms per call split into its three kernels (by
    name), and what else the call ran on the device (the workspace copies)."""
    split = dict.fromkeys([part for part, _ in WHITEN_PARTS] + ["other"], 0.0)
    for name, ms in device_ms_by_kernel(fn, calls).items():
        part = next((p for p, k in WHITEN_PARTS if k in name), "other")
        split[part] += ms
    return split


def bench_raw(n: int):
    """bench.py's problem: X ~ U[0,1]^5, y = sum(sin(3x)) + noise."""
    rng = np.random.default_rng(1)
    X = rng.uniform(0, 1, (n, DIM))
    return X, np.sin(3 * X).sum(1) + 0.1 * rng.standard_normal(n)


def bench_data(n: int):
    """bench.py's problem, y standardized."""
    X, y = bench_raw(n)
    return X, (y - y.mean()) / y.std()


def held_out(k: int):
    """k fresh points of the noiseless function, in the standardisation of
    bench_data(1000)."""
    _, y0 = bench_raw(1000)
    X = np.random.default_rng(5).uniform(0, 1, (k, DIM))
    return X, (np.sin(3 * X).sum(1) - y0.mean()) / y0.std()


def kernel_like(batch: int, n: int, seed: int) -> torch.Tensor:
    """SPD correlation matrices like the GP's (Matern-3/2 on random points),
    with the 1e-2 jitter of the matrices tests/test_pallas.py holds
    whiten_fused to (the W tolerance assumes that conditioning)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.rand((n, DIM), generator=g, device="cuda")
    theta = 10 ** (torch.rand((batch, DIM), generator=g, device="cuda") * 2 - 1)
    R = matern_plain(theta, X, nu=1.5)
    return R + 1e-2 * torch.eye(n, device="cuda")


def matern_inputs(B: int, N: int, M, seed: int = 0):
    """(theta, X, Y) for a main-path shape: the training matrix of B lanes
    (theta (B, D), Y None) or the argmax's cross matrix (theta (D,))."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.rand((N, DIM), generator=g, device="cuda")
    Y = None if M is None else torch.rand((M, DIM), generator=g, device="cuda")
    theta = 10 ** (torch.rand((B, DIM), generator=g, device="cuda") * 2 - 1)
    return (theta, X) if M is None else (theta[0].contiguous(), X, Y)


def check_matern():
    """The forward at every main-path shape and nu against the twin; at
    nu = 3/2 its times and share of the bound. Returns (worst error, per-call
    ms, twin per-call ms, bound ms, bound_by) at the headline shape."""
    worst, head = 0.0, None
    for label, B, N, M in MATERN_SHAPES:
        args = matern_inputs(B, N, M)
        for nu in (0.5, 1.5, 2.5, math.inf):
            K = matern_fused(*args, nu=nu)
            K0 = matern_plain(*args, nu=nu)
            torch.cuda.synchronize()
            err = float((K - K0).abs().max())
            worst = max(worst, err)
            assert err < MATERN_TOL, (nu, label, err)
            if M is None:
                assert float((K.diagonal(dim1=-2, dim2=-1) - 1).abs().max()) == 0.0
        t_k = time_ms(lambda: matern_fused(*args, nu=1.5))
        d_k = device_ms(lambda: matern_fused(*args, nu=1.5))
        d_p = device_ms(lambda: matern_plain(*args, nu=1.5))
        b_ms, b_by = matern_bound(B, N, M)
        log(f"  matern_fused {label} ({B}, {N}, {N if M is None else M}): max|K-K_twin| over the "
            f"four maps {err:.3e} (tol {MATERN_TOL}); nu=1.5: kernel {t_k:.4f} ms/call "
            f"({d_k:.4f} ms on the device), bound {b_ms:.4f} ms ({b_by}), share of bound "
            f"{b_ms / d_k:.3f}; twin {d_p:.4f} ms on the device")
        if label == "headline":
            for nu in (0.5, 2.5, math.inf):
                d_nu = device_ms(lambda: matern_fused(*args, nu=nu))
                log(f"    nu={nu}: kernel {d_nu:.4f} ms on the device")
            head = (worst, t_k, time_ms(lambda: matern_plain(*args, nu=1.5)), b_ms, b_by)
    return head


# (label, B, N, M or None, gradients asked): the backward's main-path calls
# (the fit asks for theta alone, the argmax for the query points alone)
MATERN_BWD_SHAPES = (("warm refit", 2, 1024, None, (True, False, False)),
                     ("cold ladder rung 1", 10, 256, None, (True, False, False)),
                     ("cold ladder rung 2", 6, 512, None, (True, False, False)),
                     ("argmax trip", 1, 25, 1024, (False, True, False)))


def check_matern_bwd():
    """The backward kernel against matern_bwd_plain: the twin in float64 is
    the yardstick (the float32 twin's GEMM expansion of r2 cancels, worst
    near r = 0 for nu = 1/2; its error is printed beside);
    two calls bit-identical; at nu = 3/2 the device ms of the kernel (both
    launches) and of the torch backward it replaces. G is masked as
    _masked_correlation masks it. Returns (worst abs error, per-call ms,
    twin per-call ms, bound ms, bound_by) at the warm refit's shape."""
    worst, head = 0.0, None
    for label, B, N, M, need in MATERN_BWD_SHAPES:
        theta, X, *rest = matern_inputs(B, N, M, seed=1)
        theta = theta.reshape(-1, DIM)
        Y = rest[0] if rest else X
        same = M is None
        g = torch.Generator(device="cuda").manual_seed(2)
        G = torch.randn((B, N, Y.shape[0]), generator=g, device="cuda")
        if same:
            mask = (torch.arange(N, device="cuda") < N - 24).float()
            G = G * (torch.outer(mask, mask) * (1 - torch.eye(N, device="cuda")))
        errs = []
        for nu in (0.5, 1.5, 2.5, math.inf):
            code = _nu_code(nu)
            got = matern_bwd_fused(theta, X, Y, G, code, same, same, need)
            again = matern_bwd_fused(theta, X, Y, G, code, same, same, need)
            K64 = matern_plain(theta.double(), X.double(), Y.double(), nu=nu, sym=same)
            want = matern_bwd_plain(theta.double(), X.double(), Y.double(), K64, G.double(), code,
                                    same, same, need)
            K32 = matern_plain(theta, X, Y, nu=nu, sym=same)
            want32 = matern_bwd_plain(theta, X, Y, K32, G, code, same, same, need)
            torch.cuda.synchronize()
            for a, a2, w, w32 in zip(got, again, want, want32):
                if w is None:
                    assert a is None
                    continue
                assert torch.equal(a, a2), f"backward not bit-identical ({label}, nu={nu})"
                scale = float(w.abs().max())
                rel, rel32 = (float((a.double() - w).abs().max()) / scale,
                              float((w32.double() - w).abs().max()) / scale)
                worst = max(worst, float((a.double() - w).abs().max()))
                errs.append(f"nu={nu} {rel:.2e} (float32 twin {rel32:.2e})")
                assert rel < MATERN_BWD_TOL, (label, nu, rel)
        code = _nu_code(1.5)
        K32 = matern_plain(theta, X, Y, nu=1.5, sym=same)
        t_k = time_ms(lambda: matern_bwd_fused(theta, X, Y, G, code, same, same, need))
        t_p = time_ms(lambda: matern_bwd_plain(theta, X, Y, K32, G, code, same, same, need))
        p_k = kernel_profile(lambda: matern_bwd_fused(theta, X, Y, G, code, same, same, need))
        p_p = kernel_profile(lambda: matern_bwd_plain(theta, X, Y, K32, G, code, same, same, need))
        (d_k, n_k), (d_p, n_p) = ([sum(v[i] for v in p.values()) for i in (0, 1)]
                                  for p in (p_k, p_p))
        b_ms, b_by = matern_bwd_bound(B, N, M, need)
        asked = "/".join(n for n, f in zip(("theta", "X", "Y"), need) if f)
        log(f"  matern backward {label} ({B}, {N}, {Y.shape[0]}), d{asked}: rel err against the "
            f"float64 twin {'; '.join(errs)} (tol {MATERN_BWD_TOL}); bit-identical repeats; "
            f"nu=1.5: kernel {t_k:.4f} ms/call ({d_k:.4f} ms on the device in {n_k:g} launches: "
            + ", ".join(f"{name.split('(')[0][-40:]} {v[0]:.4f}" for name, v in p_k.items())
            + f"), bound {b_ms:.4f} ms ({b_by}), share of bound {b_ms / d_k:.3f}; torch backward "
            f"{t_p:.4f} ms/call ({d_p:.4f} ms on the device in {n_p:g} launches)")
        if label == "warm refit":
            head = (worst, t_k, t_p, b_ms, b_by)
    return head


def log_whiten_split(label: str, split: dict, nb: int) -> None:
    log(f"  whiten_fused {label} device split: " + ", ".join(
        f"{part} {ms:.4f} ms" for part, ms in split.items())
        + f"; diagonal {split['diagonal'] * 1e3 / nb:.2f} us per 128 block")


def check_whiten():
    worst, head = 0.0, None
    # (batch, n): the MLE ladder's lanes at each bucket/rung size, and
    # ragged blocks (any n <= 128 is one block of width n)
    for batch, n in ((10, 16), (10, 37), (10, 64), (10, 100), (2, 128), (10, 256), (6, 512),
                     (2, 1024), (10, 1024)):
        R = kernel_like(batch, n, seed=n + batch)
        B = torch.randn((batch, n, 2), device="cuda", generator=torch.Generator(device="cuda").manual_seed(n))
        R_before = R.clone()
        d, W, piv, L, Dinv = whiten_fused(R, B)
        torch.cuda.synchronize()
        assert torch.equal(R, R_before), "whiten_fused wrote the caller's R"
        d0, W0, piv0, L0, Dinv0 = whiten_plain(R, B)
        errL = float((L - L0).abs().max() / L0.abs().max())
        errW = float((W - W0).abs().max()) / max(1.0, float(W0.abs().max()))
        worst = max(worst, float((L - L0).abs().max()), float((W - W0).abs().max()))
        t_k = time_ms(lambda: whiten_fused(R, B))
        t_p = time_ms(lambda: whiten_plain(R, B))
        d_k = device_ms(lambda: whiten_fused(R, B))
        d_p = device_ms(lambda: whiten_plain(R, B))
        b_ms, b_by = whiten_bound(batch, n, B.shape[-1])
        log(f"  whiten_fused ({batch}, {n}, {n}): relerr L {errL:.3e} (tol {WHITEN_L_TOL}), "
            f"W {errW:.3e} (tol {WHITEN_W_TOL}), min piv {float(piv.min()):.3e}; "
            f"kernel {t_k:.4f} ms/call ({d_k:.4f} ms on the device), bound {b_ms:.4f} ms "
            f"({b_by}), share of bound {b_ms / d_k:.3f}; "
            f"twin {t_p:.4f} ms/call ({d_p:.4f} ms on the device)")
        assert errL < WHITEN_L_TOL and errW < WHITEN_W_TOL, (n, errL, errW)
        assert bool((piv > 0).all()) and Dinv.shape == Dinv0.shape
        if n == 1024:
            log_whiten_split(f"({batch}, {n}, {n})", whiten_split(lambda: whiten_fused(R, B)), n // 128)
        if (batch, n) == (2, 1024):
            # no single PyTorch call computes (L, W, Dinv, piv); the Cholesky
            # alone is a subset of the work, timed as a yardstick only
            t_c = time_ms(lambda: torch.linalg.cholesky_ex(R))
            d_c = device_ms(lambda: torch.linalg.cholesky_ex(R))
            log(f"    torch.linalg.cholesky_ex alone (a subset of the work, not a port call): "
                f"{t_c:.4f} ms/call ({d_c:.4f} ms on the device)")
            head = (t_k, t_p, b_ms, b_by)
    # _factor_hybrid's first superpanel at n=4096: S (2, 1024, 1024) against
    # [C^T, y], C the (3072, 1024) subdiagonal panel
    R4 = kernel_like(2, 4096, seed=4)
    S = R4[:, :1024, :1024].contiguous()
    B = torch.cat([R4[:, 1024:, :1024].mT, torch.ones((2, 1024, 1), device="cuda")], dim=-1).contiguous()
    del R4
    d, W, piv, L, Dinv = whiten_fused(S, B)
    d0, W0, piv0, L0, Dinv0 = whiten_plain(S, B)
    errL = float((L - L0).abs().max() / L0.abs().max())
    errW = float((W - W0).abs().max()) / max(1.0, float(W0.abs().max()))
    worst = max(worst, float((L - L0).abs().max()), float((W - W0).abs().max()))
    t_k = time_ms(lambda: whiten_fused(S, B), windows=5, calls=2)
    t_p = time_ms(lambda: whiten_plain(S, B), windows=5, calls=2)
    split = whiten_split(lambda: whiten_fused(S, B), calls=4)
    d_p = device_ms(lambda: whiten_plain(S, B), calls=4)
    log(f"  whiten_fused hybrid panel (2, 1024, 1024) x (2, 1024, {B.shape[-1]}): relerr L "
        f"{errL:.3e} (tol {WHITEN_L_TOL}), W {errW:.3e} (tol {WHITEN_W_TOL}), min piv "
        f"{float(piv.min()):.3e}; kernel {t_k:.4f} ms/call ({sum(split.values()):.4f} ms on the "
        f"device), twin {t_p:.4f} ms/call ({d_p:.4f} ms on the device)")
    log_whiten_split("hybrid panel", split, 8)
    assert errL < WHITEN_L_TOL and errW < WHITEN_W_TOL, ("hybrid", errL, errW)
    assert bool((piv > 0).all())
    # a failed lane: an indefinite pivot reads as not (piv > 0), a NaN wins
    # the pivot minimum; the healthy lane in the same batch is untouched
    R = kernel_like(3, 256, seed=9)
    R[1, 0, 0] = -1.0
    R[2, 200, 7] = R[2, 7, 200] = math.nan
    _, _, piv, _, _ = whiten_fused(R, torch.ones((3, 256, 1), device="cuda"))
    torch.cuda.synchronize()
    log(f"  whiten_fused failed lanes: indefinite piv = {float(piv[1]):.3e}, NaN piv = "
        f"{float(piv[2])} (healthy lane {float(piv[0]):.3e})")
    assert float(piv[0]) > 0 and not (float(piv[1]) > 0) and math.isnan(float(piv[2]))
    return worst, head


def padded(X, y, n_pad: int):
    n = X.shape[0]
    Xp = np.zeros((n_pad, X.shape[1]))
    Xp[:n] = X
    Yp = np.zeros((n_pad, 1))
    Yp[:n, 0] = y
    mask = np.zeros(n_pad)
    mask[:n] = 1.0
    return Xp, Yp, mask


def likelihood_vs_cpu(X, y, n_pad: int, pars: np.ndarray):
    """The concentrated likelihood and its gradient for a batch of restart
    lanes at fixed log10 parameters, on the card (both kernels and both
    backwards) and on the plain path on the CPU: (rel err value, rel err
    gradient), each relative to the CPU's largest magnitude."""
    n = X.shape[0]
    Xp, Yp, mask = padded(X, y, n_pad)
    out = {}
    for dev in ("cuda", "cpu"):
        def t(a):
            return torch.tensor(a, dtype=torch.float32, device=dev)

        p = t(pars).requires_grad_(True)
        v = neg_log_likelihood(p, t(Xp), t(Yp), t(mask[:, None]), t(mask), n, 1e-6,
                               t(np.zeros((1, 1))), GPConfig())
        (g,) = torch.autograd.grad(v.sum(), p)
        out[dev] = (v.detach().cpu().double().numpy(), g.cpu().double().numpy())
    (v_k, g_k), (v_p, g_p) = out["cuda"], out["cpu"]
    err_v = float(np.abs(v_k - v_p).max() / np.abs(v_p).max())
    err_g = float(np.abs(g_k - g_p).max() / np.abs(g_p).max())
    return err_v, err_g


def lanes(rng, k: int) -> np.ndarray:
    """k log10 parameter rows (theta in [1e-1, 1e2], noise in [1e-5, 1e-1])."""
    return np.c_[rng.uniform(-1.0, 2.0, (k, DIM)), rng.uniform(-5.0, -1.0, k)]


def check_reference():
    """The card's likelihood and gradient against the plain path on the CPU,
    for four restart lanes at n=200 (bucket 256)."""
    X, y = bench_data(200)
    err_v, err_g = likelihood_vs_cpu(X, y, 256, lanes(np.random.default_rng(3), 4))
    log(f"  likelihood at 4 lanes, n=200 (bucket 256): rel err value {err_v:.3e} (tol 1e-4), "
        f"gradient {err_g:.3e} (tol 1e-3)")
    assert err_v < 1e-4 and err_g < 1e-3, (err_v, err_g)


def main_path(X, y):
    gp = GaussianProcess(
        mean=constant_trend(DIM), corr="matern",
        thetaL=1e-3 * np.ones(DIM), thetaU=1e3 * np.ones(DIM),
        nugget=1e-6, random_start=10, random_state=0,
    )
    argmax = AcquisitionArgmax(RealSpace([[0.0, 1.0]] * DIM).encoding(), method="BFGS",
                               n_restart=5 * DIM, seed=0)
    out = {}

    def one_iter():
        """One BO iteration; returns (fit seconds, argmax seconds)."""
        t0 = time.perf_counter()
        gp.fit(X, y)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out["u"], out["val"] = argmax(gp.posterior, gp.config, "EI", {"plugin": float(y.min())})
        torch.cuda.synchronize()
        return t1 - t0, time.perf_counter() - t1

    reset_launch_counts()
    cold = one_iter()  # cold fit: the full MLE ladder
    one_iter()  # the warm-refit path, first time
    parts = [one_iter() for _ in range(5)]
    launches = {"matern_fused": matern_fused.launches,
                "matern_fused_bwd": matern_fused.bwd_launches,
                "whiten_fused": whiten_fused.launches}
    return gp, out, cold, parts, launches


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
        if short.startswith("matern") and args and args[0] != str(DIM) and not spill:
            continue
        out.append(f"{short}<{','.join(args)}>: {regs} registers, {spill} B spill stores")
    return len(kernels), out


def main() -> None:
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

    # 3. kernels against their twins
    log("[3] kernels vs plain twins on the card")
    m_err, m_ms, m_plain, m_bound, m_by = check_matern()
    b_err, b_ms, b_plain, b_bound, b_by = check_matern_bwd()
    w_err, (w_ms, w_plain, w_bound, w_by) = check_whiten()
    log("[3b] the card's path against the plain path on the CPU, on a small input")
    check_reference()

    # 4. main path at bench size
    X, y = bench_data(1000)
    gp, out, cold, parts, launches = main_path(X, y)
    times = [f + a for f, a in parts]
    log(f"[4] fit + EI argmax, n=1000 d=5: median {statistics.median(times):.4f} s, "
        f"min {min(times):.4f} s over {len(times)} reps {[round(t, 4) for t in times]}; "
        f"fit {[round(f, 4) for f, _ in parts]} s, argmax {[round(a, 4) for _, a in parts]} s; "
        f"cold first iteration: fit {cold[0]:.4f} s, argmax {cold[1]:.4f} s; launches {launches}")
    assert all(v > 0 for v in launches.values()), launches
    trips = launches["matern_fused_bwd"]  # one Matern backward per L-BFGS trip (fit or argmax)
    log(f"  L-BFGS trips over the 7 iterations (fit and argmax): {trips}, "
        f"{trips / 7:.1f} per iteration; matern_fused forward launches per trip "
        f"{launches['matern_fused'] / trips:.3f}")
    u, val = out["u"], out["val"]
    assert np.all(np.isfinite(u)) and math.isfinite(val) and u.shape == (DIM,)
    state = gp.posterior
    min_piv = float(state.min_pivot)
    assert min_piv > PIV_TOL, min_piv
    assert np.isfinite(gp.log_likelihood_) and bool(torch.isfinite(state.gamma).all())
    fit_err = float(np.abs(gp.predict(X[:64]) - y[:64]).max())
    log(f"  log-likelihood {gp.log_likelihood_:.4f}, theta {np.round(gp.theta_, 4).tolist()}, "
        f"min pivot {min_piv:.3e}, max |mu - y| on 64 training points {fit_err:.4f}, "
        f"EI argmax value {val:.4e} at {np.round(u, 4).tolist()}")
    assert fit_err < 0.1, fit_err
    X_h, y_h = held_out(200)
    log(f"  max |mu - y| on 200 held-out points {float(np.abs(gp.predict(X_h) - y_h).max()):.4f}")
    err_v, err_g = likelihood_vs_cpu(X, y, 1024, lanes(np.random.default_rng(4), 4))
    log(f"  likelihood at 4 lanes, n=1000 (bucket 1024) against the CPU: rel err value "
        f"{err_v:.3e} (tol 1e-4), gradient {err_g:.3e} (tol 1e-3)")
    assert err_v < 1e-4 and err_g < 1e-3, (err_v, err_g)

    # 5. hybrid factorisation
    X4, y4 = bench_data(4000)
    gp4 = GaussianProcess(
        mean=constant_trend(DIM), corr="matern",
        thetaL=1e-3 * np.ones(DIM), thetaU=1e3 * np.ones(DIM),
        nugget=1e-6, random_start=10, random_state=0,
    )
    t0 = time.perf_counter()
    gp4.fit(X4, y4)
    torch.cuda.synchronize()
    t4 = time.perf_counter() - t0
    piv4 = float(gp4.posterior.min_pivot)
    log(f"[5] fit n=4000 (bucket 4096, hybrid): {t4:.4f} s (first call), "
        f"log-likelihood {gp4.log_likelihood_:.4f}, min pivot {piv4:.3e}, noise {gp4.noise_var:.1e}")
    assert np.isfinite(gp4.log_likelihood_) and piv4 > PIV_TOL

    # 6. fmin end to end (parity config 1)
    def sphere(x):
        return float(np.sum(np.asarray(x) ** 2))

    t0 = time.perf_counter()
    xopt, fopt, iters, evals, hist = fmin(sphere, [-5.0] * 2, [5.0] * 2, max_FEs=30, x0=5, seed=42)
    doe_best = min(sphere(x) for x in hist[0])
    log(f"[6] fmin 2-D sphere, 30 FEs, seed 42: regret {fopt:.6g} (DoE-only best {doe_best:.6g}), "
        f"{evals} evaluations in {time.perf_counter() - t0:.2f} s")
    assert fopt < doe_best and evals == 30

    # ms, plain_ms and bound_ms: matern_fused at (10, 1024, 1024), its
    # backward at (2, 1024, 1024) (theta only), whiten_fused at (2, 1024);
    # no single PyTorch call computes any of the three functions
    kernels = [
        {"name": "matern_fused", "route": "cuda",
         "source": "bayesian_optimization_tpu_torch/csrc/matern.cu",
         "replaces": f"{PALLAS}:98", "launches": launches["matern_fused"],
         "max_abs_err": m_err, "ms": m_ms, "plain_ms": m_plain, "bound_ms": m_bound,
         "bound_by": m_by, "library_ms": None},
        {"name": "matern_fused_bwd", "route": "cuda",
         "source": "bayesian_optimization_tpu_torch/csrc/matern.cu",
         "replaces": f"{PALLAS}:98", "launches": launches["matern_fused_bwd"],
         "max_abs_err": b_err, "ms": b_ms, "plain_ms": b_plain, "bound_ms": b_bound,
         "bound_by": b_by, "library_ms": None},
        {"name": "whiten_fused", "route": "cuda",
         "source": "bayesian_optimization_tpu_torch/csrc/whiten.cu",
         "replaces": f"{PALLAS}:278", "launches": launches["whiten_fused"],
         "max_abs_err": w_err, "ms": w_ms, "plain_ms": w_plain, "bound_ms": w_bound,
         "bound_by": w_by, "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

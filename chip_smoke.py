"""End-to-end smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing on its own lines; any failure raises and exits
non-zero, and no phase's exception is caught:
  1. device: require a Hopper GPU; print its name, power limit and versions;
  2. build: compile the hand-written kernels of csrc/ (nvcc, sm_90a);
  3. each kernel against its plain PyTorch twin on the card, at the main
     path's shapes (whiten_fused also at the hybrid factorisation's panel
     shape): max error against the stated tolerance, and both times (ms per
     call by CUDA events around 10 calls, median of 7 windows; ms on the
     device from the profiler); then the card's likelihood and gradient
     against the plain path on the CPU, on a small input;
  4. the main path at bench size (bench.py: n=1000, d=5): GaussianProcess.fit
     plus the BFGS EI argmax with 25 restarts, 2 warm-ups and 5 timed reps;
     the launch counters are zeroed just before and read just after, and
     every kernel must have launched; then the likelihood and gradient at
     this size against the plain path on the CPU;
  5. one fit at n=4000 (bucket 4096, the hybrid factorisation);
  6. fmin on the 2-D sphere (30 evaluations, seed 42);
then the kernels' JSON line, the card's name and power limit, and last the
result line {"ok": true, "device": {...}}.
"""
import json
import math
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
    matern_fused, matern_plain, reset_launch_counts, whiten_fused, whiten_plain,
)

DIM = 5
MATERN_TOL = 5e-6      # absolute, as tests/test_pallas.py holds matern_pallas
WHITEN_L_TOL = 1e-4    # max |L - L_twin| / max |L_twin|
WHITEN_W_TOL = 1e-3    # max |W - W_twin| / max(1, max |W_twin|)
PALLAS = "bayesian_optimization_tpu/ops/pallas_kernels.py"


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


def device_ms(fn, calls: int = 10) -> float:
    """Device ms per call of fn(): the summed duration of every kernel the
    profiler traced over `calls` calls, divided by `calls`."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.time_range.elapsed_us() for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    assert total_us > 0, "the profiler traced no kernel"
    return total_us / 1e3 / calls


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


def check_matern():
    g = torch.Generator(device="cuda").manual_seed(0)
    X = torch.rand((1024, DIM), generator=g, device="cuda")
    Xq = torch.rand((25, DIM), generator=g, device="cuda")
    theta_b = 10 ** (torch.rand((10, DIM), generator=g, device="cuda") * 2 - 1)
    theta_1 = theta_b[0].contiguous()
    worst, head = 0.0, None
    for nu in (0.5, 1.5, 2.5, math.inf):
        for label, args in (("sym (10, 1024, 1024)", (theta_b, X)),
                            ("cross (25, 1024)", (theta_1, Xq, X))):
            K = matern_fused(*args, nu=nu)
            K0 = matern_plain(*args, nu=nu)
            torch.cuda.synchronize()
            err = float((K - K0).abs().max())
            worst = max(worst, err)
            t_k = time_ms(lambda: matern_fused(*args, nu=nu))
            t_p = time_ms(lambda: matern_plain(*args, nu=nu))
            d_k = device_ms(lambda: matern_fused(*args, nu=nu))
            d_p = device_ms(lambda: matern_plain(*args, nu=nu))
            log(f"  matern_fused nu={nu} {label}: max|K-K_twin|={err:.3e} (tol {MATERN_TOL}) "
                f"kernel {t_k:.4f} ms/call ({d_k:.4f} ms on the device), "
                f"twin {t_p:.4f} ms/call ({d_p:.4f} ms on the device)")
            assert err < MATERN_TOL, (nu, label, err)
            if label.startswith("sym"):
                assert float((K.diagonal(dim1=-2, dim2=-1) - 1).abs().max()) == 0.0
            if nu == 1.5 and label.startswith("sym"):
                head = (t_k, t_p)
    return worst, head


def check_whiten():
    worst, head = 0.0, None
    # (batch, n): the MLE ladder's lanes at each bucket/rung size
    for batch, n in ((10, 16), (10, 64), (10, 256), (6, 512), (2, 1024), (10, 1024)):
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
        log(f"  whiten_fused ({batch}, {n}, {n}): relerr L {errL:.3e} (tol {WHITEN_L_TOL}), "
            f"W {errW:.3e} (tol {WHITEN_W_TOL}), min piv {float(piv.min()):.3e}; "
            f"kernel {t_k:.4f} ms/call ({d_k:.4f} ms on the device), "
            f"twin {t_p:.4f} ms/call ({d_p:.4f} ms on the device)")
        assert errL < WHITEN_L_TOL and errW < WHITEN_W_TOL, (n, errL, errW)
        assert bool((piv > 0).all()) and Dinv.shape == Dinv0.shape
        if (batch, n) == (2, 1024):
            head = (t_k, t_p)
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
    log(f"  whiten_fused hybrid panel (2, 1024, 1024) x (2, 1024, {B.shape[-1]}): relerr L "
        f"{errL:.3e} (tol {WHITEN_L_TOL}), W {errW:.3e} (tol {WHITEN_W_TOL}), min piv "
        f"{float(piv.min()):.3e}; kernel {t_k:.4f} ms/call, twin {t_p:.4f} ms/call")
    assert errL < WHITEN_L_TOL and errW < WHITEN_W_TOL, ("hybrid", errL, errW)
    assert bool((piv > 0).all())
    R = kernel_like(2, 256, seed=9)
    R[1, 0, 0] = -1.0
    _, _, piv, _, _ = whiten_fused(R, torch.ones((2, 256, 1), device="cuda"))
    torch.cuda.synchronize()
    log(f"  whiten_fused indefinite lane: piv = {float(piv[1]):.3e} (healthy lane {float(piv[0]):.3e})")
    assert float(piv[0]) > 0 and not (float(piv[1]) > 0)
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
    launches = {"matern_fused": matern_fused.launches, "whiten_fused": whiten_fused.launches}
    return gp, out, cold, parts, launches


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
    for line in _build.build_log().splitlines():
        if "Used" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # 3. kernels against their twins
    log("[3] kernels vs plain twins on the card")
    m_err, (m_ms, m_plain) = check_matern()
    w_err, (w_ms, w_plain) = check_whiten()
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

    kernels = [
        {"name": "matern_fused", "route": "cuda",
         "source": "bayesian_optimization_tpu_torch/csrc/matern.cu",
         "replaces": f"{PALLAS}:98", "launches": launches["matern_fused"],
         "max_abs_err": m_err, "ms": m_ms, "plain_ms": m_plain},
        {"name": "whiten_fused", "route": "cuda",
         "source": "bayesian_optimization_tpu_torch/csrc/whiten.cu",
         "replaces": f"{PALLAS}:278", "launches": launches["whiten_fused"],
         "max_abs_err": w_err, "ms": w_ms, "plain_ms": w_plain},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

"""The backward of `whiten` (ops/linalg.py), three ways: time, accuracy and
the fits it steers.

    python bayesian_optimization_tpu_torch/tools/whiten_bwd_variants.py [--reps N]
    python bayesian_optimization_tpu_torch/tools/whiten_bwd_variants.py --fits
    python bayesian_optimization_tpu_torch/tools/whiten_bwd_variants.py --basins \
        [--device cuda|cpu] [--dtype f32|f64] [--data mixed,n4000]

The VJP (`whiten_vjp`) needs three solves with L^T a call. Each variant
gives it another solver:
- "trsm": torch.linalg.solve_triangular (cuBLAS trsm on the card), the
  backward before it was built on the kernel's Dinv;
- "substitution": blocked back substitution over Dinv (the JAX package's
  `tri_solve_upper_t`, kept here only), one GEMM a 128-block;
- "inverse": the backward's own: the explicit inverses of L's 1024-wide
  diagonal blocks from Dinv (`_super_inv`, all of L^-1 up to 1024 rows),
  then one GEMM pair a superpanel a solve ("superpanel" above 1024 rows).

Default: at the samplers' (8, 1024), the warm refit's (2, 1024), the CMA
fit's (10, 1024) and the hybrid (1, 4096) (superpanel form against trsm
only), ms a call by CUDA events (median of 7 windows), device ms from the
profiler by kernel name, and the error of Rbar against the VJP in float64
(relative to its largest entry); then, at (2, 1024) matrices of cond(R)
4e6 to 1.5e8 (Matern-3/2, theta 10^-0.5 to 10^-1.5, nugget 1e-6, as the
fits reach with theta at its bounds), each variant's gradient against
float64 autograd and against the float64 VJP of the same float32 factor
(the solver's own error). --fits: a BFGS warm refit and a NUTS carried
refit at n=1000, d=5 (chip_smoke.py's data) with the substitution and the
inverse in turns (s, i, i, s, s, i), wall per L-BFGS trip or leapfrog
(counted by the Matern backward's launches). --basins: chip_smoke.py's
phase-8 mixed fit (n=1000, D=6) and phase-5 fit (n=4000), cold, under each
solver and both forms of the constant trend's GLS (the closed form the
likelihood runs, and the QR with its triangular solve it replaced), on
--device in --dtype (f64: the CPU, the kept form only): the
log-likelihood, the theta and how many theta sit at a bound. The swaps
hold only inside each run (`unittest.mock.patch.object`). Last, the card's
name and power limit where a card ran. Default and --fits need a GPU.
"""
import argparse
import contextlib
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch
from torch.autograd import DeviceType

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # the checkout's root

from bayesian_optimization_tpu_torch import require_cuda  # noqa: E402
from bayesian_optimization_tpu_torch.models import likelihood  # noqa: E402
from bayesian_optimization_tpu_torch.ops import linalg  # noqa: E402
from bayesian_optimization_tpu_torch.ops.hopper_kernels import matern_plain  # noqa: E402


def kernel_like(batch: int, n: int, seed: int) -> torch.Tensor:
    g = torch.Generator(device="cuda").manual_seed(seed)
    X = torch.rand((n, 5), generator=g, device="cuda")
    theta = 10 ** (torch.rand((batch, 5), generator=g, device="cuda") * 2 - 1)
    return matern_plain(theta, X, nu=1.5) + 1e-2 * torch.eye(n, device="cuda")


def ill_conditioned(batch: int, n: int, log10_theta: float, device, seed: int = 0) -> torch.Tensor:
    """Float64 Matern-3/2 correlations on n uniform points in 5-D, every
    theta 10^log10_theta, nugget 1e-6: cond(R) ~2.5e6 (n=256) to 2.8e7
    (n=1024) at 10^-1."""
    X = torch.tensor(np.random.default_rng(seed).uniform(0, 1, (n, 5)), device=device)
    theta = torch.full((batch, 5), 10.0 ** log10_theta, dtype=torch.float64, device=device)
    return matern_plain(theta, X, nu=1.5) + 1e-6 * torch.eye(n, dtype=torch.float64, device=device)


def time_ms(fn, windows: int = 7, calls: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(windows):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / calls)
    return statistics.median(out)


def device_split(fn, calls: int = 5):
    """Device ms a call by kernel name (largest first); None if the profiler
    traced no kernel in 5 sessions."""
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        by = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by[e.name] = by.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / calls
        if by:
            return sorted(by.items(), key=lambda kv: -kv[1])
    return None


def trsm_solver(L, Dinv):
    return lambda X: torch.linalg.solve_triangular(L.mT, X, upper=True)


def substitution_solver(L, Dinv):
    """X -> L^-T X by blocked back substitution over Dinv (Bt, nb, T, T):
    nb steps from the last block up, one GEMM against the rows already
    solved and one T x T GEMM each."""
    n, T = L.shape[-1], Dinv.shape[-1]

    def solve(B):
        X = torch.empty(B.shape, dtype=B.dtype, device=B.device)
        for j in range(Dinv.shape[-3] - 1, -1, -1):
            s, e = j * T, (j + 1) * T
            Bj = B[:, s:e]
            if e < n:
                Bj = torch.baddbmm(Bj, L[:, e:, s:e].mT, X[:, e:], alpha=-1.0)
            torch.bmm(Dinv[:, j].mT, Bj, out=X[:, s:e])
        return X

    return solve


def inverse_solver(L, Dinv):
    """The backward's own solve: superpanel inverses from Dinv, then GEMMs."""
    Dsup = linalg._super_inv(L, Dinv, linalg.SUPER)
    return lambda X: linalg.tri_solve_upper_t_super(L, Dsup, X, linalg.SUPER)


SOLVERS = {"trsm": trsm_solver, "substitution": substitution_solver, "inverse": inverse_solver}


@contextlib.contextmanager
def backward_solver(name: str):
    """whiten's backward with the named solver, inside the block only."""
    make = SOLVERS[name]

    def backward(ctx, dbar, Wbar, _pivbar):
        L, W, Dinv = ctx.saved_tensors
        return linalg.whiten_vjp(L, W, make(L, Dinv), dbar, Wbar)

    with mock.patch.object(linalg._Whiten, "backward", staticmethod(backward)):
        yield


def _gls_qr(Yt, Ft, beta0, estimate_trend: bool):
    """The constant trend's GLS as it was before its closed form: a QR of
    L^-1 F and a triangular solve for beta, for every p."""
    if not estimate_trend:
        return _gls_kept(Yt, Ft, beta0, estimate_trend)
    Q, G = torch.linalg.qr(Ft, mode="reduced")
    beta = torch.linalg.solve_triangular(G, Q.mT @ Yt, upper=True)
    return G, beta, Yt - Ft @ beta


_gls_kept = likelihood._gls


def variants(L, W, Dinv, dbar, Wbar) -> dict:
    """name -> a call of the VJP whose solver is built inside the call, as
    the backward builds it."""
    n = L.shape[-1]

    def vjp(make_solver):
        return lambda: linalg.whiten_vjp(L, W, make_solver(L, Dinv), dbar, Wbar)

    out = {"trsm": vjp(trsm_solver)}
    if n <= linalg.SUPER:
        out["substitution"] = vjp(substitution_solver)
    out["superpanel" if n > linalg.SUPER else "inverse"] = vjp(inverse_solver)
    return out


def accuracy(device) -> None:
    """Each solver's gradient at ill-conditioned R against float64."""
    for log10_theta in (-0.5, -1.0, -1.5):
        R64 = ill_conditioned(2, 1024, log10_theta, device)
        ev = torch.linalg.eigvalsh(R64[0])
        B = torch.tensor(np.random.default_rng(1).standard_normal((2, 1024, 2)), device=device)
        Rr = R64.clone().requires_grad_(True)
        L64 = torch.linalg.cholesky(Rr)
        W64 = torch.linalg.solve_triangular(L64, B, upper=False)
        (torch.log(L64.diagonal(dim1=-2, dim2=-1)).sum() + (W64 ** 2).sum()).backward()
        d, W, piv, L, Dinv = linalg._whiten_parts(R64.float(), B.float())
        Ld, Wd = L.double(), W.double()
        own = linalg.whiten_vjp(Ld, Wd, trsm_solver(Ld, None), 1.0 / d.double(), 2.0 * Wd)[0]
        rows = []
        for name, make in SOLVERS.items():
            g = linalg.whiten_vjp(L, W, make(L, Dinv), 1.0 / d, 2.0 * W)[0].double()
            rows.append(f"{name} {float((g - Rr.grad).abs().max() / Rr.grad.abs().max()):.3e} "
                        f"({float((g - own).abs().max() / own.abs().max()):.3e})")
        print(f"(2, 1024) cond(R) {float(ev[-1] / ev[0]):.3e}, theta 10^{log10_theta}, min pivot "
              f"{float(piv.min()):.3e}: rel err of Rbar against float64 autograd (the solver's own, "
              f"against the float64 VJP of the float32 factor): " + "; ".join(rows), flush=True)


def timings(reps: int) -> None:
    for batch, n in ((8, 1024), (2, 1024), (10, 1024), (1, 4096)):
        R = kernel_like(batch, n, seed=n + batch)
        B = torch.randn((batch, n, 2), device="cuda", generator=torch.Generator(device="cuda").manual_seed(1))
        d, W, piv, L, Dinv = linalg._whiten_parts(R, B)
        g = torch.Generator(device="cuda").manual_seed(2)
        dbar = torch.randn(d.shape, device="cuda", generator=g)
        Wbar = torch.randn(W.shape, device="cuda", generator=g)
        L64, W64 = L.double(), W.double()
        ref, _ = linalg.whiten_vjp(L64, W64, trsm_solver(L64, None), dbar.double(), Wbar.double())
        scale = float(ref.abs().max())
        for name, call in variants(L, W, Dinv, dbar, Wbar).items():
            err = float((call()[0].double() - ref).abs().max()) / scale
            ms = time_ms(call, windows=reps)
            split = device_split(call)
            dev = None if split is None else sum(v for _, v in split)
            top = "not measured" if split is None else "; ".join(
                f"{k.split('(')[0][-40:]} {v:.4f}" for k, v in split[:5])
            print(f"({batch}, {n}) {name}: {ms:.4f} ms/call, "
                  f"{'not measured' if dev is None else f'{dev:.4f}'} ms on the device "
                  f"[{top}]; rel err of Rbar against float64 {err:.3e}", flush=True)


def fits() -> None:
    """End-to-end fits with the backward's solver swapped in turns."""
    from bayesian_optimization_tpu_torch import GaussianProcess, constant_trend
    from bayesian_optimization_tpu_torch.ops.hopper_kernels import matern_fused
    from chip_smoke import bench_data

    X, y = bench_data(1000)

    def gp(optimizer):
        g = GaussianProcess(mean=constant_trend(5), corr="matern", thetaL=1e-3 * np.ones(5),
                            thetaU=1e3 * np.ones(5), nugget=1e-6, random_start=10, random_state=0,
                            optimizer=optimizer)
        g.hmc_warmup, g.n_ensemble = 64, 8
        return g.fit(X, y)  # cold fit, the kept solver

    for optimizer, unit in (("BFGS", "trip"), ("NUTS", "leapfrog")):
        g = gp(optimizer)
        out = {"substitution": [], "inverse": []}
        for name in ("substitution", "inverse", "inverse", "substitution", "substitution", "inverse"):
            with backward_solver(name):
                torch.cuda.synchronize()
                b0, t0 = matern_fused.bwd_launches, time.perf_counter()
                g.fit(X, y)
                torch.cuda.synchronize()
                wall, work = time.perf_counter() - t0, matern_fused.bwd_launches - b0
            out[name].append((wall, work))
        for name, runs in out.items():
            print(f"{optimizer} refit, n=1000, {name}: " + ", ".join(
                f"{w:.4f} s / {k} {unit}s = {w / k * 1e3:.2f} ms" for w, k in runs), flush=True)


def basins(device: str, dtype: str, which: list) -> None:
    """chip_smoke.py's phase-8 and phase-5 fits under each solver and trend
    form: where each cold fit ends."""
    from bayesian_optimization_tpu_torch import GaussianProcess, constant_trend
    from chip_smoke import MIXED_D, bench_data, mixed_obj, mixed_space

    data = {}
    if "mixed" in which:
        space = mixed_space()
        enc = space.encoding()
        raw = space.sample(1000, method="LHS")
        y = np.array([mixed_obj(list(r)) for r in raw])
        data["mixed fit (phase 8), n=1000, D=6"] = (enc.unit_to_embed_np(enc.encode_unit(raw)),
                                                   (y - y.mean()) / y.std(), MIXED_D)
    if "n4000" in which:
        data["bench fit (phase 5), n=4000, D=5"] = (*bench_data(4000), 5)
    turns = ([("closed", "inverse")] if dtype == "f64" else
             [(t, s) for t in ("closed", "qr") for s in SOLVERS])
    for label, (X, y, dim) in data.items():
        for trend, solver in turns:
            gp = GaussianProcess(mean=constant_trend(dim), corr="matern", thetaL=1e-3 * np.ones(dim),
                                 thetaU=1e3 * np.ones(dim), nugget=1e-6, random_start=10, random_state=0,
                                 device=device, dtype=dtype)
            with backward_solver(solver), mock.patch.object(
                    likelihood, "_gls", _gls_kept if trend == "closed" else _gls_qr):
                t0 = time.perf_counter()
                gp.fit(X, y)
                wall = time.perf_counter() - t0
            at_bound = int(np.sum(np.abs(np.abs(np.log10(gp.theta_)) - 3.0) < 0.01))  # within 2.3%
            print(f"{label}, {device} {dtype}, {trend} trend, {solver} backward: log-likelihood "
                  f"{gp.log_likelihood_:.4f}, theta {np.round(gp.theta_, 4).tolist()} ({at_bound} of {dim} "
                  f"at a bound), {wall:.2f} s", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--fits", action="store_true")
    ap.add_argument("--basins", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="f32", choices=("f32", "f64"))
    ap.add_argument("--data", default="mixed,n4000")
    args = ap.parse_args()
    if args.basins:
        device = "cpu" if args.dtype == "f64" else args.device
        if device != "cpu":
            require_cuda()
        basins(device, args.dtype, args.data.split(","))
    else:
        require_cuda()
        if args.fits:
            fits()
        else:
            timings(args.reps)
            accuracy("cuda")
    if torch.cuda.is_available():
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()

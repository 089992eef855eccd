"""The backward of `whiten` (ops/linalg.py), three ways: time and accuracy.

    python bayesian_optimization_tpu_torch/tools/whiten_bwd_variants.py [--reps N]

The VJP (`whiten_vjp`) needs three solves with L^T a call. Each variant
gives it another solver:
- "trsm": torch.linalg.solve_triangular (cuBLAS trsm on the card), the
  backward before it was built on the kernel's Dinv;
- "substitution": blocked back substitution over Dinv (the JAX package's
  `tri_solve_upper_t`, kept here only), one GEMM a 128-block;
- "inverse": the backward's own: the explicit inverses of L's 1024-wide
  diagonal blocks from Dinv (`_super_inv`, all of L^-1 up to 1024 rows),
  then one GEMM pair a superpanel a solve ("superpanel" above 1024 rows).

At the samplers' (8, 1024), the warm refit's (2, 1024), the CMA fit's
(10, 1024) and the hybrid (1, 4096) (superpanel form against trsm only),
ms a call by CUDA events (median of 7 windows), device ms from the
profiler by kernel name, and the error of Rbar against the VJP in float64
(relative to its largest entry); then, at (2, 1024) matrices of cond(R)
4e6 to 1.5e8 (Matern-3/2, theta 10^-0.5 to 10^-1.5, nugget 1e-6, as the
fits reach with theta at its bounds), each variant's gradient against
float64 autograd and against the float64 VJP of the same float32 factor
(the solver's own error). Last, the card's name and power limit. Needs a
GPU; the card tests import `SOLVERS` and `ill_conditioned` from here.
"""
import argparse
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))  # the checkout's root

from bayesian_optimization_tpu_torch import require_cuda  # noqa: E402
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


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args()
    require_cuda()
    timings(args.reps)
    accuracy("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])

if __name__ == "__main__":
    main()

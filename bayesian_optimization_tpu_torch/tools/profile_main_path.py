"""Time and profile the port's main path (GP fit + EI argmax at n=1000, d=5,
chip_smoke.py's phase 4) on one NVIDIA GPU.

    python bayesian_optimization_tpu_torch/tools/profile_main_path.py [--root DIR] [--no-profile]

--root is the directory that holds the `bayesian_optimization_tpu_torch`
package to measure (default: the checkout this file is in), so that another
commit's package, unpacked with `git archive` into a git-ignored directory,
can be measured by the same script on the same card. Prints one JSON line:
- "timed": the cold iteration and the first warm refit as warm-ups, then 5
  timed iterations: fit + argmax seconds (median, min, each), and the
  package's launch counters over all 7 iterations;
- "fit", "argmax" (unless --no-profile): one more warm fit and one argmax
  under torch.profiler: host wall ms, device ms (the kernels' summed durations), idle share
  1 - device / wall, kernel launches, L-BFGS trips (one Matern backward per
  trip), the Matern op's share (device ms and launches of the kernels
  launched inside its forward `_MaternFn` and its backward
  `_MaternFnBackward`), and the 10 kernels with the most device time.
The profiler lengthens the host wall it traces.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path


def bench_data(n: int, dim: int = 5):
    """bench.py's problem, X ~ U[0,1]^5, y = sum(sin(3x)) + noise, y
    standardized (as chip_smoke.py makes it)."""
    import numpy as np

    rng = np.random.default_rng(1)
    X = rng.uniform(0, 1, (n, dim))
    y = np.sin(3 * X).sum(1) + 0.1 * rng.standard_normal(n)
    return X, (y - y.mean()) / y.std()


def _subtree(ev):
    """(device ms, launches) of the kernels launched inside a CPU op."""
    ms, n = sum(k.duration for k in ev.kernels) / 1e3, len(ev.kernels)
    for ch in ev.cpu_children:
        a, b = _subtree(ch)
        ms, n = ms + a, n + b
    return ms, n


def _profile(fn) -> dict:
    import torch
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name, device, launches = {}, 0.0, 0
    share = {"forward": [0.0, 0], "backward": [0.0, 0]}
    trips = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3
            device, launches = device + ms, launches + 1
            entry = by_name.setdefault(e.name, [0.0, 0])
            entry[0] += ms
            entry[1] += 1
            continue
        part = ("backward" if "_MaternFnBackward" in e.name
                else "forward" if e.name == "_MaternFn" else None)
        if part is None:
            continue
        p = e.cpu_parent
        while p is not None and "_MaternFn" not in p.name:
            p = p.cpu_parent
        if p is not None:  # counted with the enclosing Matern op
            continue
        ms, n = _subtree(e)
        share[part][0] += ms
        share[part][1] += n
        trips += part == "backward"
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    return {
        "wall_ms": wall, "device_ms": device, "idle_share": 1.0 - device / wall,
        "launches": launches, "trips": trips,
        "matern": {part: {"device_ms": ms, "launches": n} for part, (ms, n) in share.items()},
        "top_kernels": [{"name": k[:90], "device_ms": v[0], "launches": v[1]} for k, v in top],
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--no-profile", action="store_true", help="time the iterations only")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import numpy as np
    import torch

    import bayesian_optimization_tpu_torch as pkg
    from bayesian_optimization_tpu_torch.ops import hopper_kernels as hk

    pkg.require_cuda()
    dim = 5
    X, y = bench_data(1000, dim)
    gp = pkg.GaussianProcess(
        mean=pkg.constant_trend(dim), corr="matern",
        thetaL=1e-3 * np.ones(dim), thetaU=1e3 * np.ones(dim),
        nugget=1e-6, random_start=10, random_state=0,
    )
    argmax = pkg.AcquisitionArgmax(pkg.RealSpace([[0.0, 1.0]] * dim).encoding(),
                                   method="BFGS", n_restart=5 * dim, seed=0)

    def fit():
        gp.fit(X, y)

    def acquire():
        argmax(gp.posterior, gp.config, "EI", {"plugin": float(y.min())})

    def one_iter():
        t0 = time.perf_counter()
        fit()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        acquire()
        torch.cuda.synchronize()
        return t1 - t0, time.perf_counter() - t1

    hk.reset_launch_counts()
    one_iter()
    one_iter()
    parts = [one_iter() for _ in range(5)]
    counters = {"matern_fused": hk.matern_fused.launches,
                "matern_fused_bwd": getattr(hk.matern_fused, "bwd_launches", None),
                "whiten_fused": hk.whiten_fused.launches}
    times = [f + a for f, a in parts]
    out = {
        "root": args.root, "device": torch.cuda.get_device_name(0),
        "timed": {"median_s": statistics.median(times), "min_s": min(times), "iters_s": times,
                  "fit_s": [f for f, _ in parts], "argmax_s": [a for _, a in parts],
                  "launch_counters_7_iters": counters},
        "log_likelihood": gp.log_likelihood_,
    }
    if not args.no_profile:
        out["fit"], out["argmax"] = _profile(fit), _profile(acquire)
    print(json.dumps(out))


if __name__ == "__main__":
    main()

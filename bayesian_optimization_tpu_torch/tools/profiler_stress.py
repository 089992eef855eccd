"""Count the torch.profiler sessions that trace no kernel, on one NVIDIA GPU.

    python bayesian_optimization_tpu_torch/tools/profiler_stress.py [--root DIR] [--sessions N]

Runs N short profiler sessions of 10 calls each, as chip_smoke.py's
kernel_profile does, for a torch kernel (an in-place add over 2^20 floats)
and for the port's matern_bwd_fused at the warm refit's shape (2, 1024,
1024), dtheta only. Prints each empty session as it happens, then per
function the sessions run, the empty ones, the longest run of empty
sessions in a row (what a retry has to outlast) and the ms a session.
--root is the directory that holds the `bayesian_optimization_tpu_torch`
package (default: the checkout this file is in).
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--sessions", type=int, default=500)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    from torch.autograd import DeviceType

    from bayesian_optimization_tpu_torch.ops.hopper_kernels import _nu_code, matern_bwd_fused

    x = torch.rand(1 << 20, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    theta = torch.rand((2, 5), generator=g, device="cuda") + 0.5
    X = torch.rand((1024, 5), generator=g, device="cuda")
    G = torch.randn((2, 1024, 1024), generator=g, device="cuda")
    code = _nu_code(1.5)
    fns = {"torch add": lambda: x.add_(1.0),
           "matern_bwd_fused": lambda: matern_bwd_fused(theta, X, X, G, code, True, True,
                                                        (True, False, False))}
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        empty, streak, longest, t0 = 0, 0, 0, time.perf_counter()
        for i in range(args.sessions):
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    fn()
                torch.cuda.synchronize()
            if any(e.device_type == DeviceType.CUDA for e in prof.events()):
                streak = 0
                continue
            empty, streak = empty + 1, streak + 1
            longest = max(longest, streak)
            print(f"  {name}: session {i} traced no kernel", flush=True)
        print(f"{name}: {args.sessions} sessions, {empty} traced no kernel, longest empty run "
              f"{longest}, {(time.perf_counter() - t0) / args.sessions * 1e3:.1f} ms a session",
              flush=True)


if __name__ == "__main__":
    main()

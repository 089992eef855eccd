"""Readings for the limits of the check of `correct`: the program's numbers
over many seeds, the control's, and the faults'.

    python3 bench_port/control.py --workload <cell> --seeds 1,2,3 --seconds 20 [--fault <name>]

For each seed, in one process (the kernel library loads once): the cell's
set-up and a window of --seconds, then the numbers of `reference/judge.py`
for the port's outputs. Without --fault these are the lower reading's runs,
and the control (the reference itself in TF32, the precision below the
configuration's, in the port's place) and, as a witness, the reference in
float32 are read beside them. With --fault the fault is planted in the port
once set-up is done, so that the window runs the broken path:

- `argmax_1_trip`: the acquisition argmax stops after one L-BFGS trip of
  its restarts (it returns, in effect, the best of its restart points).

One JSON line a seed. The benchmark's own runs never run the control.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bench_port import harness, traffic  # noqa: E402
from bench_port.reference import judge  # noqa: E402


def plant(fault: str):
    """Plant a named fault in the port; returns the function that removes it."""
    from bayesian_optimization_tpu_torch.optim import argmax as argmax_mod

    if fault != "argmax_1_trip":
        raise ValueError(f"unknown fault {fault!r}")
    real = argmax_mod._bfgs_argmax
    argmax_mod._bfgs_argmax = (lambda crit, x0, q, max_iter, constraints=None:
                               real(crit, x0, q, 1, constraints))
    return lambda: setattr(argmax_mod, "_bfgs_argmax", real)


def readings(cell: str, seed: int, seconds: float, fault: str | None = None,
             device: str = "cuda", overrides: dict | None = None) -> dict:
    import torch

    t0 = time.perf_counter()
    _, cfg, tr = harness.cell_files(harness.load_manifest(), cell)
    tr = {**tr, **(overrides or {})}
    dev = torch.device(device)
    loop = traffic.Loop(cfg, tr, dev, seed)
    loop.setup()
    setup_s = time.perf_counter() - t0
    with contextlib.ExitStack() as stack:
        if fault:
            stack.callback(plant(fault))
        iterations, _ = harness.measure(loop, seconds)
    window_s = iterations[-1]["end"]
    lb, ub = loop.problem.lb, loop.problem.ub
    loop.release()
    model = cfg["model"]
    t1 = time.perf_counter()
    rows = judge.program_rows(iterations, model, lb, ub, dev, seed, int(tr["quality_sample"]))
    out = {"seed": seed, "fault": fault, "setup_s": setup_s, "window_s": window_s,
           "iterations": len(iterations), "reference_s": time.perf_counter() - t1,
           "program": judge.worst(rows), "correct": judge.verdict(judge.worst(rows), tr["limits"]),
           "rows": [{k: v for k, v in r.items() if v is not None} for r in rows],
           "walls": [r["wall"] for r in iterations],
           "argmax_grad_calls": [r["argmax_grad_calls"] for r in iterations],
           "fit_grad_calls": [r["fit_grad_calls"] for r in iterations]}
    if not fault:
        out["control_tf32"] = judge.control_numbers(iterations, model, lb, ub, dev, "tf32")
        out["control_correct"] = judge.verdict(out["control_tf32"], tr["limits"], partial=True)
        out["reference_f32"] = judge.control_numbers(iterations, model, lb, ub, dev, "float32")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for s in args.seeds.split(","):
        print(json.dumps(readings(args.workload, int(s), args.seconds, args.fault)), flush=True)
    found = harness.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())

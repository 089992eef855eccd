"""One run of one cell: set-up, the measured window, the check of
`correct`, and the result's line.

Everything a cell needs is found by name: its entry in BENCHMARK.json, its
file `workloads/<cell>.json` (the loop's parameters, the limits of the
check), its configuration's file, and a reader `metrics/<metric>.py` for
each metric that BENCHMARK.json gives the cell. A new cell, configuration
or metric is new files and entries; no file here changes.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names that must not be loaded by the run: JAX and the
# JAX package the port was made from (compared whole, so the port's own
# name, which begins with the JAX package's, is not one of them)
FORBIDDEN = ("jax", "jaxlib", "flax", "bayesian_optimization_tpu")


def forbidden_modules() -> list:
    """The forbidden top-level names among the loaded modules."""
    tops = {name.partition(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_files(manifest: dict, cell: str, root: Path = ROOT):
    """(workload entry, configuration (its file's contents), the cell's traffic
    file's contents) of a cell named in BENCHMARK.json."""
    entry = next((w for w in manifest["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise KeyError(f"no workload named {cell!r} in BENCHMARK.json")
    conf = next(c for c in manifest["configs"] if c["name"] == entry["config"])
    cfg = json.loads((root / conf["file"]).read_text())
    tr = json.loads((BENCH / "workloads" / f"{cell}.json").read_text())
    if tr["config"] != entry["config"]:
        raise ValueError(f"workloads/{cell}.json runs {tr['config']!r}, BENCHMARK.json {entry['config']!r}")
    return entry, cfg, tr


def cell_metrics(manifest: dict, cell: str, trace: bool) -> list:
    """The metrics a run of the cell reports: its end-to-end ones without a
    trace, its per-layer ones with (each per-layer metric where it lists
    the cell, or, without a list, where the cell reports what it moves)."""
    def applies(m):
        return cell in m["workloads"] if "workloads" in m else True

    e2e = [m for m in manifest["end_to_end"] if applies(m)]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if (applies(m) if "workloads" in m else m["moves"] in reported)]


def load_reader(name: str):
    """The module `metrics/<name>.py`, which has read(ctx) -> value or None."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_port_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Context:
    """What the metric readers read."""

    def __init__(self, setup_s, window_s, iterations, trace):
        """window_s: the measured window's length; iterations: the records of
        `measure`, each with its start and end in the window (a traced
        one's in the trace's own span, before the window)."""
        self.setup_s = setup_s
        self.window_s = window_s
        self.iterations = iterations
        self.steady = [r for r in iterations if not r.get("traced")]
        self.trace = trace


def measure(loop, seconds: float, trace_iters: int = 0, ops=()):
    """The measured window of `seconds`: an iteration starts while the
    window is open, and the one still running when it closes runs to its
    end (its outputs are judged too). Each record gets its start and end
    from the window's opening. With trace_iters, that many iterations run
    under the profiler before the window opens (a session that recorded
    nothing is tried once more), the loop is then rewound to where set-up
    left it, and the window runs the same untraced iterations as a run
    without a trace, for the phase metrics; the trace is reduced once the
    window has closed. Returns (records, the trace's reduction or None)."""
    import torch

    iterations, summary, traced = [], None, None

    def timed(w0):
        rec = loop.iterate()
        rec["start"] = rec.pop("t0") - w0
        rec["end"] = rec["start"] + rec["wall"]
        return rec

    if trace_iters:
        from . import trace as tracing

        for _ in range(2):
            batch, t0 = [], time.perf_counter()
            with tracing.Profiler() as prof:
                for _ in range(trace_iters):
                    with torch.profiler.record_function(tracing.MARKER):
                        rec = timed(t0)
                    rec["traced"] = True
                    batch.append(rec)
            iterations += batch
            if tracing.recorded(prof.events()):
                traced = (prof, len(batch))
                break
        loop.rewind()
    w0 = time.perf_counter()
    while time.perf_counter() - w0 < seconds:
        iterations.append(timed(w0))
    if traced is not None:
        summary = tracing.summarize(traced[0].events(), ops, traced[1])
    return iterations, summary


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: float | None = None, overrides: dict | None = None,
             root: Path = ROOT):
    """One run; returns (result, exit code). `overrides` replaces entries of
    the cell's traffic (the tests' small sizes)."""
    t_start = time.perf_counter() if t_start is None else t_start
    manifest = load_manifest(root)
    entry, cfg, tr = cell_files(manifest, cell, root)
    tr = {**tr, **(overrides or {})}
    metrics = cell_metrics(manifest, cell, trace)
    readers = {m["name"]: load_reader(m["name"]) for m in metrics}

    import torch

    from . import traffic
    from .reference import judge

    dev = torch.device(device)
    loop = traffic.Loop(cfg, tr, dev, seed)
    loop.setup()
    setup_s = time.perf_counter() - t_start

    ops = sorted({r.RANGE for r in readers.values() if hasattr(r, "RANGE")})
    iterations, summary = measure(loop, seconds, int(tr["trace_iters"]) if trace else 0, ops)

    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return None, 3
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    lb, ub = loop.problem.lb, loop.problem.ub
    loop.release()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    rows = judge.program_rows(iterations, cfg["model"], lb, ub, dev, seed, int(tr["quality_sample"]))
    numbers = judge.worst(rows)
    failed = sum(not judge.row_verdict(r, tr["limits"]) for r in rows)
    correct = judge.verdict(numbers, tr["limits"])

    ctx = Context(setup_s, seconds, iterations, summary)
    values = {}
    for m in metrics:
        v = readers[m["name"]].read(ctx)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    devinfo = {"platform": "gpu" if dev.type == "cuda" else dev.type,
               "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
               "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(iterations), "failed": int(failed),
              "metrics": values, "device": devinfo}
    if summary:  # a session that stayed empty is not measured: no 0 in its place
        devinfo["busy_s"], devinfo["window_s"] = summary["busy_s"], summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["setup_parts"] = loop.parts
    result["checks"] = {k: {"value": numbers[k], "limit": tr["limits"][k]}
                        for k in judge.compared(tr["limits"])}
    return result, 0


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description="One run of one benchmark cell on the card.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    entry, _, _ = cell_files(load_manifest(), args.workload)
    chips = int(entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result, code = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                            t_start=t_start)
    if code:
        return code
    it = result["attempted"]
    print(f"{args.workload}: {it} iterations in the window, seed {args.seed}", file=sys.stderr)
    print("set-up: " + ", ".join(f"{k} {v!r}" for k, v in result.pop("setup_parts").items()),
          file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0

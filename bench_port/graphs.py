"""The CUDA graph replays of a traced run: each replay's kernels by name,
and the shapes of the argmax trip it replays.

The port replays the acquisition argmax's L-BFGS trip as one CUDA graph
(bayesian_optimization_tpu_torch/ops/optimize.py `_lbfgs_graphed`), each
replay inside the profiler range `lbfgs.graph`; the profiler links the
kernels of a graph's launch to the range it was launched in, as it links
an operator's kernels to the operator. No `_MaternFn` range holds a
replayed build. The run's first trip, which the graph repeats, runs
eagerly inside the span `lbfgs.forward` of the phase
`arg_max_acquisition`, and its `_MaternFn` range records the covariance
build's shapes there: theta (1, D), the lanes (R, D), the rows (M, D).

The metric readers that import this module wrap `trace.summarize` once, so
that a traced run's reduction holds, under "graphs", one entry a replay:
its kernels' device seconds and launches by name ("kernels"), and the
shapes of the `_MaternFn` calls of the latest eager argmax trip before it
("builds"). A port without the range has no replays, and the readers read
nothing.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

from bench_port import trace as tracing

RANGE = "lbfgs.graph"
FORWARD, PHASE, BUILD = "lbfgs.forward", "arg_max_acquisition", "_MaternFn"


def _inside(starts, ranges, s, t) -> bool:
    """Whether [s, t] lies inside one of the ranges (sorted, disjoint)."""
    k = bisect.bisect_right(starts, s) - 1
    return k >= 0 and ranges[k][1] >= t


def reduce(events):
    """The replays of the traced window (a list, empty without any)."""
    marks = [(e.start_ns(), e.end_ns(), e.start_thread_id()) for e in events
             if not tracing._is_device(e) and e.name() == tracing.MARKER]
    if not marks:
        return []
    w0, w1, main = min(m[0] for m in marks), max(m[1] for m in marks), marks[0][2]
    replays, by_name = {}, defaultdict(list)
    device = []
    for e in events:
        if tracing._is_device(e):
            if not tracing._is_annotation(e):
                device.append(e)
            continue
        s, t = e.start_ns(), e.end_ns()
        if e.start_thread_id() != main or s < w0 or t > w1:
            continue
        name = e.name()
        if name == RANGE and e.linked_correlation_id() == 0:
            replays[e.correlation_id()] = {"start": s, "kernels": {}, "builds": []}
        elif name in (FORWARD, PHASE, BUILD):
            by_name[name].append((s, t, e.shapes() if name == BUILD else None))
    if not replays:
        return []

    phases = sorted(by_name[PHASE])
    phase_starts = [p[0] for p in phases]
    forwards = sorted(f for f in by_name[FORWARD] if _inside(phase_starts, phases, f[0], f[1]))
    fwd_starts = [f[0] for f in forwards]
    trips = defaultdict(list)  # an eager argmax trip's forward start -> its builds' shapes
    for s, t, shapes in by_name[BUILD]:
        k = bisect.bisect_right(fwd_starts, s) - 1
        if k >= 0 and forwards[k][1] >= t:
            trips[forwards[k][0]].append(shapes)
    trip_starts = sorted(trips)

    for e in device:
        r = replays.get(e.linked_correlation_id())
        if r is None:
            continue
        name = e.name()[:100]
        secs, n = r["kernels"].get(name, (0.0, 0))
        r["kernels"][name] = (secs + (e.end_ns() - e.start_ns()) / 1e9, n + 1)
    out = []
    for r in sorted(replays.values(), key=lambda r: r["start"]):
        k = bisect.bisect_right(trip_starts, r["start"]) - 1
        r["builds"] = trips[trip_starts[k]] if k >= 0 else []
        out.append(r)
    return out


def _with_graphs(inner):
    def summarize(events, op_names, n_iters):
        out = inner(events, op_names, n_iters)
        if out is not None:
            out["graphs"] = reduce(events)
        return out

    summarize.takes_graphs = True
    return summarize


if not getattr(tracing.summarize, "takes_graphs", False):
    tracing.summarize = _with_graphs(tracing.summarize)


def kernel_share(ctx, kernel: str, bound_s):
    """100 x the least time over the device time of the kernels whose name
    holds `kernel`, over the replays: bound_s(builds, launches) is a
    replay's least time for them, from the shapes of the eager trip it
    repeats and their launches in it. None where no replay ran such a
    kernel or where a bound cannot be worked out."""
    bound = dev = 0.0
    for r in (ctx.trace or {}).get("graphs") or []:
        runs = [(s, n) for name, (s, n) in r["kernels"].items() if kernel in name]
        if not runs:
            continue
        b = bound_s(r["builds"], sum(n for _, n in runs))
        if b is None:
            return None
        bound += b
        dev += sum(s for s, _ in runs)
    return 100.0 * bound / dev if dev > 0 else None


def lanes_and_features(builds):
    """(R, D) of the argmax's lanes from its eager trip's builds: the X
    operand (R, D) of each, which must agree; None if none or not so."""
    found = {tuple(b[1]) for b in builds if len(b) >= 3 and len(b[1]) == 2}
    return found.pop() if len(found) == 1 else None

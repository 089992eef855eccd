"""The device trace of a run's traced iterations, reduced to what the
per-layer metrics read.

`torch.profiler` records the host's operator ranges (with their input
shapes), the CUDA runtime's calls and the device's kernels and copies of the
traced iterations, each iteration inside a `bench.iteration` range. The raw
events (`kineto_results`) are read in one pass, without building the
profiler's event tree:

- the traced window: from the first `bench.iteration` range's start to the
  last one's end; `busy_s`, the union of the device's activity intervals in
  it (kernels and copies; the device-side mirrors of host ranges are not
  activity); its gaps, each named by the innermost host range that
  encloses its middle on the iterating thread (`bench.iteration` itself:
  the benchmark's own loop), summed by name;
- the kernels launched inside a named operator's range (`_MaternFn`,
  `_Whiten`, ...): each device event belongs to the innermost operator that
  launched it (its linked correlation id), and that operator's range lies
  inside the named one on the same thread. This is the `_subtree` accounting
  of bayesian_optimization_tpu_torch/tools/profile_main_path.py (an
  operator's kernels and those of its children), over the raw events.
"""
from __future__ import annotations

import bisect
from collections import defaultdict

from .stats import gaps, union_length

MARKER = "bench.iteration"
_COPIES = ("Memcpy", "Memset")


def _span_ns(e):
    return e.start_ns(), e.end_ns()


def _is_device(e) -> bool:
    from torch.autograd import DeviceType

    return e.device_type() == DeviceType.CUDA


def _is_annotation(e) -> bool:
    """A host range's mirror on the device's timeline (gpu_user_annotation):
    not device activity."""
    if getattr(e, "is_user_annotation", lambda: False)():
        return True
    return "annotation" in str(getattr(e, "activity_type", lambda: "")()).lower()


class Profiler:
    """A profiler session over CPU and CUDA activity, shapes recorded."""

    def __init__(self):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts, record_shapes=True)

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        return False

    def events(self):
        return self.prof.profiler.kineto_results.events()


def _innermost(ranges, queries):
    """For each query time, the name of the innermost range that holds it
    (ranges (start, end, name) on one thread, nested or disjoint)."""
    order = sorted(ranges, key=lambda r: (r[0], -r[1]))
    out, stack, i = {}, [], 0
    for q in sorted(set(queries)):
        while i < len(order) and order[i][0] <= q:
            while stack and stack[-1][1] <= order[i][0]:
                stack.pop()
            stack.append(order[i])
            i += 1
        while stack and stack[-1][1] < q:
            stack.pop()
        out[q] = stack[-1][2] if stack else "(no host range)"
    return out


def recorded(events) -> bool:
    """Whether a session holds the traced iterations and device activity
    (the profiler now and then hands back an empty one)."""
    marked = active = False
    for e in events:
        if _is_device(e):
            active = active or not _is_annotation(e)
        else:
            marked = marked or e.name() == MARKER
        if marked and active:
            return True
    return False


def summarize(events, op_names, n_iters: int):
    """The traced window's reduction (a dict), or None where the session
    recorded no device activity inside it (an empty session)."""
    marks = [(_span_ns(e), e.start_thread_id()) for e in events
             if not _is_device(e) and e.name() == MARKER]
    if not marks:
        return None
    w0 = min(s for (s, _), _ in marks)
    w1 = max(t for (_, t), _ in marks)
    main_thread = marks[0][1]

    frontend = {}   # correlation id -> (start, end, thread) of host operators
    host_main = []  # (start, end, name) on the iterating thread
    named = {name: defaultdict(list) for name in op_names}  # name -> thread -> calls
    device = []
    for e in events:
        if _is_device(e):
            if not _is_annotation(e):
                device.append(e)
            continue
        s, t = _span_ns(e)
        if e.linked_correlation_id() == 0:
            frontend[e.correlation_id()] = (s, t, e.start_thread_id())
        if e.start_thread_id() == main_thread and s >= w0 and t <= w1:
            host_main.append((s, t, e.name()))
        if e.name() in named:
            named[e.name()][e.start_thread_id()].append([s, t, e.shapes(), 0.0])

    for calls_by_thread in named.values():
        for calls in calls_by_thread.values():
            calls.sort(key=lambda c: c[0])
    starts = {name: {th: [c[0] for c in calls] for th, calls in by.items()}
              for name, by in named.items()}

    intervals, by_kernel, n_kernels = [], defaultdict(float), 0
    for e in device:
        s, t = _span_ns(e)
        if t <= w0 or s >= w1:
            continue
        intervals.append((s, t))
        name = e.name()
        by_kernel[name[:100]] += (t - s) / 1e9
        if name.startswith(_COPIES):
            continue
        n_kernels += 1
        parent = frontend.get(e.linked_correlation_id())
        if parent is None:
            continue
        ps, pt, th = parent
        for op, by in named.items():
            calls = by.get(th)
            if not calls:
                continue
            k = bisect.bisect_right(starts[op][th], ps) - 1
            if k >= 0 and calls[k][1] >= pt:
                calls[k][3] += (t - s) / 1e9
    if not intervals:
        return None

    holes = gaps(intervals, w0, w1)
    names = _innermost(host_main, [(a + b) // 2 for a, b in holes])
    idle = defaultdict(float)
    for a, b in holes:
        idle[names[(a + b) // 2]] += (b - a) / 1e9
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": union_length(intervals, w0, w1) / 1e9,
        "n_iters": n_iters,
        "kernels": n_kernels,
        "ops": {op: [(c[2], c[3]) for calls in by.values() for c in calls]
                for op, by in named.items()},
        "device_ops": top(by_kernel),
        "idle_gaps": top(idle),
    }

"""The benchmark's reading of CUDA graph replays (bench_port/graphs.py) on a
hand-made trace: which kernels a replay ran, which eager argmax trip it
repeats, and the two roofline shares that read them
(`argmax_cov_build_roofline`, `argmax_lbfgs_update_roofline`). A trace
with graph replays needs a card; the events here carry what the
profiler's would."""
import pytest
from torch.autograd import DeviceType

from bench_port import graphs, harness, trace, work

MAIN, ENGINE = 1, 2


class Event:
    """One profiler event, as `trace.summarize` and `graphs.reduce` read it."""

    _next = [1000]

    def __init__(self, name, start, end, thread=MAIN, shapes=(), device=False, linked=0):
        self._name, self._s, self._t, self._th = name, start, end, thread
        self._shapes, self._device, self._linked = [list(s) for s in shapes], device, linked
        Event._next[0] += 1
        self._corr = Event._next[0]

    def name(self):
        return self._name

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._t

    def start_thread_id(self):
        return self._th

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._linked

    def shapes(self):
        return self._shapes

    def device_type(self):
        return DeviceType.CUDA if self._device else DeviceType.CPU

    def is_user_annotation(self):
        return False


def kernel(name, start, dur, op):
    return Event(name, start, start + dur, device=True, linked=op.correlation_id())


ARGMAX_BUILD = ((1, 5), (25, 5), (512, 5))


def _events(with_graphs=True):
    """Two traced iterations' worth: a fit (its own forward and build), an
    argmax whose first trip runs eagerly (its build's shapes ARGMAX_BUILD),
    a capture (a build outside any forward span) and two replays inside
    `lbfgs.forward`, each running the Matern forward, the update and one
    other kernel; an eager kernel of the first trip besides."""
    ev = [Event(trace.MARKER, 0, 10_000)]
    fit = Event("fit", 10, 1_000)
    fit_fwd = Event("lbfgs.forward", 20, 200)
    fit_build = Event("_MaternFn", 30, 100, shapes=((2, 5), (512, 5), (512, 5)))
    ev += [fit, fit_fwd, fit_build, kernel("matern_fwd_kernel<5, 1>", 40, 30, fit_build)]
    ev.append(Event("arg_max_acquisition", 2_000, 9_000))
    fwd = Event("lbfgs.forward", 2_100, 2_400)
    build = Event("_MaternFn", 2_150, 2_300, shapes=ARGMAX_BUILD)
    ev += [fwd, build, kernel("matern_fwd_kernel<5, 1>", 2_200, 3, build)]
    ev.append(Event("_MaternFn", 3_000, 3_100, shapes=((1, 5), (99, 5), (512, 5))))  # the capture
    if with_graphs:
        for k, start in enumerate((4_000, 6_000)):
            outer = Event("lbfgs.forward", start, start + 100)
            replay = Event(graphs.RANGE, start + 10, start + 90)
            ev += [outer, replay,
                   kernel("void (anonymous namespace)::matern_fwd_kernel<5, 1>(float const*)",
                          start + 20, 4 + k, replay),
                   kernel("(anonymous namespace)::lbfgs_update_kernel(State, long long const*)",
                          start + 40, 20, replay),
                   kernel("void at::native::elementwise_kernel<128, 2>", start + 70, 2, replay)]
    return ev


def test_reduce_finds_each_replays_kernels_and_trip():
    replays = graphs.reduce(_events())
    assert [r["start"] for r in replays] == [4_010, 6_010]
    for k, r in enumerate(replays):
        assert r["builds"] == [[list(s) for s in ARGMAX_BUILD]]
        fwd = [v for name, v in r["kernels"].items() if "matern_fwd_kernel" in name]
        upd = [v for name, v in r["kernels"].items() if "lbfgs_update_kernel" in name]
        assert fwd == [((4 + k) / 1e9, 1)] and upd == [(20 / 1e9, 1)] and len(r["kernels"]) == 3
    assert graphs.reduce(_events(with_graphs=False)) == []


def _ctx(events):
    summary = trace.summarize(events, ["_MaternFn"], 2)
    return harness.Context(1.0, 1.0, [], summary)


def test_readers_work_out_the_roofline_shares():
    """The two shares from the argmax's shapes: the build's bound at
    (1, 25, 512, 5) over the two replays' Matern forward (4 + 5 ns), the
    update's bound for 25 lanes of 5 variables and a history of 10 over
    its two launches (2 x 20 ns). Without replays (a port before the
    graphed loop) both read nothing, while `summarize` still reduces the
    trace."""
    cov = harness.load_reader("argmax_cov_build_roofline")
    upd = harness.load_reader("argmax_lbfgs_update_roofline")
    assert trace.summarize.takes_graphs
    ctx = _ctx(_events())
    want_cov = 100.0 * 2 * work.cov_build_bound_s(1, 25, 512, 5) / 9e-9
    assert cov.read(ctx) == pytest.approx(want_cov, rel=1e-12)
    assert upd.read(ctx) == pytest.approx(100.0 * 2 * upd.bound_s(25, 5) / 40e-9, rel=1e-12)
    assert 0.0 < upd.read(ctx) < 100.0 and 0.0 < cov.read(ctx)
    bare = _ctx(_events(with_graphs=False))
    assert bare.trace is not None and bare.trace["graphs"] == []
    assert cov.read(bare) is None and upd.read(bare) is None
    assert cov.read(harness.Context(1.0, 1.0, [], None)) is None


def test_update_bound_counts_the_state_once():
    """At the d = 20 argmax's (100, 20, 10) the bound is the state's bytes
    (410,800 B at 3.35 TB/s), not its operations."""
    upd = harness.load_reader("argmax_lbfgs_update_roofline")
    assert upd.bound_s(100, 20) == pytest.approx(410_800 / work.HBM_BYTES_PER_S, rel=1e-12)

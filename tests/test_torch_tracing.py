"""The port's spans and counters (`utils/logging.py`): their keys under the
running phase, the L-BFGS trip's counts against the objective's own calls,
no change to any number, no profiler range without a profiler, and (on the
card) one `host_syncs` a synchronisation that CUDA's sync debug mode sees.

Imports no JAX: the card runs it with

    python -m pytest --noconftest -o addopts="" tests/test_torch_tracing.py -q
"""
import pickle
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from bayesian_optimization_tpu_torch import BO, RealSpace
from bayesian_optimization_tpu_torch.ops.optimize import minimize_restarts
from bayesian_optimization_tpu_torch.utils import logging as tracing
from bayesian_optimization_tpu_torch.utils.logging import PhaseTimer, count, host_sync, span

TRIP = ("lbfgs.forward", "lbfgs.backward", "lbfgs.update", "host_sync")


def _sphere(x):
    return float(np.sum(np.asarray(x, float) ** 2))


def _bo(device="cpu", seed=3):
    space = RealSpace([[-5.0, 5.0]] * 2, random_seed=seed)
    return BO(search_space=space, obj_fun=_sphere, DoE_size=6, max_FEs=20,
              acquisition_optimization={"optimizer": "BFGS", "n_restart": 4},
              random_seed=seed, device=device)


def _told(device="cpu", seed=3):
    """A BO told its design: the GP fitted, the next ask the argmax's."""
    opt = _bo(device, seed)
    X = opt.ask()
    opt.tell(X, [_sphere(x) for x in X])
    return opt


class _Phase:
    """A phase of `timer` around a block, as `timed_phase` sets it."""

    def __init__(self, timer, name="probe"):
        self.timer, self.name = timer, name

    def __enter__(self):
        self.token = tracing._PHASE.set((self.timer, self.name))
        return self.timer

    def __exit__(self, *exc):
        tracing._PHASE.reset(self.token)


def _quadratic(calls, A, b):
    """A float64 convex quadratic over a batch of rows; each call appends its
    row count to `calls`."""
    def fun(X):
        calls.append(X.shape[0])
        return 0.5 * torch.einsum("ri,ij,rj->r", X, A, X) - X @ b
    return fun


def _problem(R, d=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    M = torch.randn(d, d, generator=g, dtype=torch.float64)
    A = M @ M.T + d * torch.eye(d, dtype=torch.float64)
    b = torch.randn(d, generator=g, dtype=torch.float64)
    x0 = torch.rand(R, d, generator=g, dtype=torch.float64) * 4.0 - 2.0
    return A, b, x0


def test_spans_and_counters_of_a_tell_and_an_ask_sit_under_their_phases():
    opt = _told()
    before = opt._timer.snapshot()
    opt.ask()
    snap = opt._timer.snapshot()
    for phase in ("fit", "arg_max_acquisition"):
        for name in TRIP:
            assert snap[f"{phase}/{name}:s"] > 0.0 and snap[f"{phase}/{name}:n"] >= 1
        for name in ("lbfgs.trips", "lbfgs.lane_evals", "lbfgs.steps", "host_syncs"):
            assert snap[f"{phase}/{name}"] >= 1
        trips = snap[f"{phase}/lbfgs.trips"]
        # one forward, backward and update a trip; one exit test more a run
        for name in TRIP[:3]:
            assert snap[f"{phase}/{name}:n"] == trips
        assert snap[f"{phase}/host_syncs"] > trips
    # the ask added to the argmax's keys only
    grew = {k for k in snap if snap[k] != before.get(k, 0)}
    assert any(k.startswith("arg_max_acquisition/") for k in grew)
    assert not any(k.startswith("fit/") for k in grew)
    # the phases' own seconds hold their spans'
    spans = sum(v for k, v in snap.items() if k.startswith("fit/") and k.endswith(":s"))
    assert spans <= snap["fit:s"]
    # every key is "<phase>/<name>" for a phase that ran, or a phase
    phases = {k[:-2] for k in snap if "/" not in k and k.endswith(":s")}
    assert {k.split("/")[0] for k in snap if "/" in k} <= phases


@pytest.mark.parametrize("R", [1, 4, 9])
@pytest.mark.parametrize("max_iter", [1, 5, 30])
def test_trips_equal_the_objectives_calls(R, max_iter):
    A, b, x0 = _problem(R, seed=R * 100 + max_iter)
    calls = []
    timer = PhaseTimer()
    with _Phase(timer):
        minimize_restarts(_quadratic(calls, A, b), x0, -3.0, 3.0, max_iter=max_iter)
    snap = timer.snapshot()
    assert snap["probe/lbfgs.trips"] == len(calls)
    assert snap["probe/lbfgs.lane_evals"] == sum(calls)
    # every trip reads the live lanes once; the run's end reads the exit
    # test, the steps and the best lane (2)
    assert snap["probe/host_syncs"] == len(calls) + 1 + 1 + 2
    # each lane concludes at most max_iter + 1 steps, the first its start
    assert R <= snap["probe/lbfgs.steps"] <= R * (max_iter + 1)


@pytest.mark.parametrize("R, max_iter", [(1, 4), (6, 12), (12, 40)])
def test_trips_count_the_objectives_calls_as_the_lbfgs_runs_them(R, max_iter):
    """The counters against an objective that counts itself: its calls and
    its rows, over a run whose line searches backtrack."""
    A, b, x0 = _problem(R, d=4, seed=7)
    seen = {"calls": 0, "rows": 0}

    def fun(X):
        seen["calls"] += 1
        seen["rows"] += X.shape[0]
        return (X ** 4).sum(-1) - 3.0 * (X ** 2).sum(-1) + X @ b

    timer = PhaseTimer()
    with _Phase(timer):
        minimize_restarts(fun, x0, -3.0, 3.0, max_iter=max_iter)
    snap = timer.snapshot()
    assert (snap["probe/lbfgs.trips"], snap["probe/lbfgs.lane_evals"]) == (seen["calls"], seen["rows"])
    assert snap["probe/lbfgs.forward:n"] == snap["probe/lbfgs.backward:n"] == seen["calls"]


@pytest.mark.parametrize("max_linesearch_steps", [0, 3, 20])
def test_steps_and_probes_make_up_the_lane_evaluations(max_linesearch_steps):
    A, b, x0 = _problem(8, seed=11)
    calls = []
    timer = PhaseTimer()
    with _Phase(timer):
        minimize_restarts(_quadratic(calls, 100.0 * A, b), x0, -3.0, 3.0, max_iter=20,
                          max_linesearch_steps=max_linesearch_steps)
    snap = timer.snapshot()
    steps, evals = snap["probe/lbfgs.steps"], snap["probe/lbfgs.lane_evals"]
    probes = evals - steps
    assert steps + probes == evals == sum(calls) and probes >= 0
    if max_linesearch_steps == 0:  # every evaluation concludes its step
        assert probes == 0
    else:  # the steep quadratic's first steps overshoot: some probes
        assert probes > 0


@pytest.mark.parametrize("R, max_iter", [(5, 30), (16, 8)])
def test_lbfgs_results_are_bit_identical_with_and_without_a_timer(R, max_iter):
    A, b, x0 = _problem(R, seed=5)
    bare = minimize_restarts(_quadratic([], A, b), x0, -3.0, 3.0, max_iter=max_iter)
    with _Phase(PhaseTimer()):
        timed = minimize_restarts(_quadratic([], A, b), x0, -3.0, 3.0, max_iter=max_iter)
    for u, v in zip(bare, timed):
        assert torch.equal(u, v)


def test_a_bo_asks_the_same_point_with_and_without_its_timer():
    a, b = _told(seed=8), _told(seed=8)
    b._timer = None  # no phase becomes current: every span records nothing
    assert np.array_equal(np.asarray(a.ask(), float), np.asarray(b.ask(), float))
    assert a._timer.snapshot()["arg_max_acquisition/lbfgs.trips"] > 0


def test_no_profiler_range_opens_without_a_profiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    opt = _told()
    opt.ask()
    assert opt._timer.snapshot()["fit/lbfgs.trips"] > 0


def test_spans_are_profiler_ranges_under_a_profiler():
    A, b, x0 = _problem(3, seed=2)
    timer = PhaseTimer()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with _Phase(timer):
            minimize_restarts(_quadratic([], A, b), x0, -3.0, 3.0, max_iter=3)
    names = {e.name for e in prof.events()}
    assert set(TRIP) <= names
    runs = {e.name: 0 for e in prof.events()}
    for e in prof.events():
        runs[e.name] += 1
    assert runs["lbfgs.backward"] == timer.snapshot()["probe/lbfgs.trips"]


def test_a_phase_is_a_profiler_range_under_a_profiler():
    opt = _told()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        opt.ask()
    names = {e.name for e in prof.events()}
    assert {"ask", "arg_max_acquisition", "lbfgs.update", "host_sync"} <= names


def test_spans_and_counters_outside_a_phase_record_nothing():
    timer = PhaseTimer()
    assert tracing._PHASE.get() is None and not tracing.in_phase()
    with span("lbfgs.forward"), host_sync(3):
        count("lbfgs.trips", 5)
    A, b, x0 = _problem(4)
    minimize_restarts(_quadratic([], A, b), x0, -3.0, 3.0, max_iter=5)
    assert timer.snapshot() == {}
    # and a phase's timer takes nothing once the phase has ended
    with _Phase(timer):
        count("c")
    with span("late"):
        count("c")
    assert timer.snapshot() == {"probe/c": 1}


def test_a_span_keeps_its_own_seconds_and_its_inner_spans_theirs():
    timer = PhaseTimer()
    with _Phase(timer, "p"):
        with span("outer"):
            time.sleep(0.02)
            with host_sync(2):
                time.sleep(0.03)
    snap = timer.snapshot()
    assert 0.02 <= snap["p/outer:s"] < 0.03 <= snap["p/host_sync:s"]
    assert snap["p/outer:n"] == snap["p/host_sync:n"] == 1 and snap["p/host_syncs"] == 2


def test_a_phase_in_another_thread_is_not_this_threads():
    timer, other = PhaseTimer(), PhaseTimer()

    def work():
        with _Phase(other, "q"):
            count("c")

    with _Phase(timer):
        t = threading.Thread(target=work)
        t.start()
        t.join()
        count("c")
    assert timer.snapshot() == {"probe/c": 1} and other.snapshot() == {"q/c": 1}


def test_a_timer_pickled_before_spans_existed_loads():
    timer = PhaseTimer()
    timer.record("fit", 0.5)
    old = pickle.loads(pickle.dumps(timer))
    for key in ("span_s", "span_n", "counters"):
        del old.__dict__[key]
    loaded = pickle.loads(pickle.dumps(old))
    with _Phase(loaded, "fit"):
        with host_sync():
            pass
    snap = loaded.snapshot()
    assert snap["fit:s"] == 0.5 and snap["fit/host_syncs"] == 1 and loaded.history == {"fit": [0.5]}


@pytest.mark.cuda
def test_host_syncs_are_the_synchronisations_cuda_sees():
    """One iteration on the card: every synchronising call that CUDA's sync
    debug mode reports is one `host_syncs` of the port, and no other."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    opt = _told("cuda")
    X = opt.ask()
    y = [_sphere(x) for x in X]
    torch.cuda.synchronize()
    before = opt._timer.snapshot()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            opt.tell(X, y)
            opt.ask()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    after = opt._timer.snapshot()
    # (the mode's own notice, that it is a prototype, is no synchronisation)
    seen = [f"{w.filename}:{w.lineno}" for w in caught
            if "called a synchronizing CUDA operation" in str(w.message)]
    counted = {k: v - before.get(k, 0) for k, v in after.items() if k.endswith("/host_syncs")}
    trips = after["arg_max_acquisition/lbfgs.trips"] - before.get("arg_max_acquisition/lbfgs.trips", 0)
    assert sum(counted.values()) == len(seen), (counted, sorted(set(seen)))
    assert len(seen) > trips > 0


@pytest.mark.parametrize("device, dtype", [
    ("cpu", torch.float32), ("cpu", torch.float64),
    pytest.param("cuda", torch.float32, marks=pytest.mark.cuda),
    pytest.param("cuda", torch.float64, marks=pytest.mark.cuda)])
def test_fused_updates_count_the_trips_the_kernel_runs(device, dtype):
    """`lbfgs.fused_updates` is one a trip where the update is the CUDA
    kernel (a CUDA float32 run) and 0 where its twin runs (the CPU, and
    float64 on any device)."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    A, b, x0 = (v.to(device=device, dtype=dtype) for v in _problem(6, d=4, seed=13))
    calls = []
    timer = PhaseTimer()
    with _Phase(timer):
        minimize_restarts(_quadratic(calls, A, b), x0, -3.0, 3.0, max_iter=12)
    snap = timer.snapshot()
    fused = device == "cuda" and dtype == torch.float32
    assert snap["probe/lbfgs.trips"] == len(calls) > 0
    assert snap.get("probe/lbfgs.fused_updates", 0) == (len(calls) if fused else 0)

"""A whole run on the CPU at a small size (the chip's look skipped): the
result's line, the whole-name check for JAX, and `correct` coming out
false when the timed path is broken underneath."""
import json
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from bench_port import harness, traffic

SMALL = {"n0": 40, "replay": 3, "histories": 2, "quality_sample": 1, "trace_iters": 1}
ROOT = Path(harness.__file__).resolve().parent.parent


def _run(cell, trace=False, seconds=0.5, **over):
    result, code = harness.run_cell(cell, 2**31 + 11, seconds, trace, device="cpu",
                                    overrides={**SMALL, **over})
    assert code == 0
    return result


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_shape(trace):
    r = _run("f8d5-mle.seq", trace)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["attempted"] >= 1 and r["failed"] == 0
    names = {m["name"]: m for m in harness.cell_metrics(harness.load_manifest(), "f8d5-mle.seq", trace)}
    assert set(r["metrics"]) <= set(names)
    for k, v in r["metrics"].items():
        assert set(v) == {"value", "unit"} and v["unit"] == names[k]["unit"]
        assert isinstance(v["value"], float)
    if not trace:
        assert {"iter_s", "setup_s"} == set(r["metrics"])
    else:  # the CPU records no device trace: its metrics are left out, never 0
        # every other per-layer metric is read, however long the trace took
        # against the window (here a traced iteration outlasts the window)
        host = {k for k, m in names.items() if m["source"] != "device_trace"}
        assert host and host <= set(r["metrics"])
        assert "idle_share" not in r["metrics"] and "breakdown" not in r
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(r)


def test_forbidden_modules_are_matched_by_whole_top_level_name(monkeypatch):
    assert harness.forbidden_modules() == []
    for ok in ("bayesian_optimization_tpu_torch", "bayesian_optimization_tpu_torch.ops", "jaxtyping"):
        monkeypatch.setitem(sys.modules, ok, types.ModuleType(ok))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "bayesian_optimization_tpu.core", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["bayesian_optimization_tpu"]
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("y"))
    assert harness.forbidden_modules() == ["bayesian_optimization_tpu", "jax"]


def test_a_run_that_loaded_jax_prints_no_result(monkeypatch):
    real = harness.forbidden_modules
    monkeypatch.setattr(harness, "forbidden_modules", lambda: real() + ["jax"])
    result, code = harness.run_cell("f8d5-mle.seq", 5, 0.1, False, device="cpu", overrides=SMALL)
    assert result is None and code != 0


def test_run_exits_without_a_card_and_prints_nothing():
    p = subprocess.run([sys.executable, "bench_port/run.py", "--workload", "f8d5-mle.seq",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_the_harness_alone_does_not_run(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench_port", tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "bench_port/run.py", "--workload", "f8d5-mle.seq",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


# -- faults planted in the port under a run: each must make `correct` false --

def _after_setup(monkeypatch, fault):
    """Plant `fault()` once the cell's set-up is done, so that the window's
    iterations run the broken path."""
    real = traffic.Loop.setup

    def setup(self):
        real(self)
        fault()

    monkeypatch.setattr(traffic.Loop, "setup", setup)


def test_fault_refit_leaves_the_state_unchanged(monkeypatch):
    from bayesian_optimization_tpu_torch import GaussianProcess

    _after_setup(monkeypatch, lambda: monkeypatch.setattr(GaussianProcess, "fit", lambda self, X, y: self))
    assert _run("f8d5-mle.seq")["correct"] is False


def test_fault_fit_on_half_the_rows(monkeypatch):
    from bayesian_optimization_tpu_torch import GaussianProcess

    real = GaussianProcess.fit
    _after_setup(monkeypatch, lambda: monkeypatch.setattr(
        GaussianProcess, "fit", lambda self, X, y: real(self, np.asarray(X)[::2], np.asarray(y)[::2])))
    assert _run("f8d5-mle.seq")["correct"] is False


def test_fault_answer_altered_where_it_is_produced(monkeypatch):
    from bayesian_optimization_tpu_torch.optim.argmax import AcquisitionArgmax

    real = AcquisitionArgmax._run

    def altered(self, *a, **k):
        us, vals = real(self, *a, **k)
        # every coordinate moved a tenth of the box towards the centre
        return us + 0.1 * np.sign(0.5 - us), vals

    _after_setup(monkeypatch, lambda: monkeypatch.setattr(AcquisitionArgmax, "_run", altered))
    # at 100 rows of work_seed 1's histories the fit is sound (at 40 rows, or
    # on the cell's own histories cut to 100 rows, length scales sit on a
    # bound and the criterion is flat far from the data)
    assert _run("f8d5-mle.seq", n0=100, work_seed=1)["correct"] is False


def test_fault_argmax_cut_to_one_trip(monkeypatch):
    """control.py's fault, planted under a run: the winners are no maxima."""
    from bench_port.control import plant

    def fault():
        monkeypatch.setattr(traffic.Loop, "_remove_fault", plant("argmax_1_trip"), raising=False)

    _after_setup(monkeypatch, fault)
    try:
        assert _run("f8d5-mle.seq", n0=100, work_seed=1, quality_sample=3)["correct"] is False
    finally:
        traffic.Loop._remove_fault()


def test_control_plants_the_fault_and_removes_it():
    from bayesian_optimization_tpu_torch.optim import argmax as argmax_mod
    from bench_port.control import plant

    before = argmax_mod._bfgs_argmax
    remove = plant("argmax_1_trip")
    assert argmax_mod._bfgs_argmax is not before
    remove()
    assert argmax_mod._bfgs_argmax is before


def test_the_seed_orders_one_fixed_set_of_work():
    """Every seed runs the cell's histories (from its work_seed); seeds differ
    in the order of their turns."""
    import torch

    _, cfg, tr = harness.cell_files(harness.load_manifest(), "f8d5-mle.seq")
    loops = [traffic.Loop(cfg, {**tr, "histories": 6}, torch.device("cpu"), s)
             for s in (2**33 + 1, 2**33 + 2, 2**33 + 3)]
    assert all(sorted(lp.order) == list(range(6)) for lp in loops)
    assert len({tuple(lp.order) for lp in loops}) > 1
    rng = [traffic.stream(tr["work_seed"], 1, 0) for _ in range(2)]
    assert np.array_equal(rng[0].uniform(size=5), rng[1].uniform(size=5))


def test_the_traced_iterations_leave_the_window_the_work_of_a_plain_run():
    """The trace runs before the window and the loop is rewound: the window's
    iterations take the histories' turns from the start, as without a trace."""
    import torch

    _, cfg, tr = harness.cell_files(harness.load_manifest(), "f8d5-mle.seq")
    loop = traffic.Loop(cfg, {**tr, **SMALL}, torch.device("cpu"), 2**31 + 5)
    loop.setup()
    recs, _ = harness.measure(loop, 0.01, trace_iters=2)
    traced = [r for r in recs if r.get("traced")]
    steady = [r for r in recs if not r.get("traced")]
    assert len(traced) >= 2 and steady
    assert [r["history"] for r in traced[:2]] == loop.order[:2]
    assert steady[0]["history"] == loop.order[0] and steady[0]["start"] >= 0
    assert len(steady[0]["X"]) == len(traced[0]["X"]) == SMALL["n0"] + 1

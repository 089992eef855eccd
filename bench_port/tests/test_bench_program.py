"""The readers of the port's own spans and counters (`program.py`), each on
synthetic records with values worked out by hand, and the wrap that puts
the counters into a record."""
import types

import pytest

from bench_port import harness, program

ARG, FIT = "arg_max_acquisition", "fit"


def _rec(wall, trips, fwd, bwd, upd, sync, evals, steps, syncs, fit_trips, fit_sync_s, fit_syncs,
         traced=False):
    return {"wall": wall, "traced": traced, "program": {
        f"{ARG}/lbfgs.trips": trips, f"{ARG}/lbfgs.forward:s": fwd,
        f"{ARG}/lbfgs.backward:s": bwd, f"{ARG}/lbfgs.update:s": upd,
        f"{ARG}/host_sync:s": sync, f"{ARG}/lbfgs.lane_evals": evals,
        f"{ARG}/lbfgs.steps": steps, f"{ARG}/host_syncs": syncs,
        f"{FIT}/lbfgs.trips": fit_trips, f"{FIT}/host_sync:s": fit_sync_s,
        f"{FIT}/host_syncs": fit_syncs, f"{FIT}/lbfgs.update:s": 0.7, "tell:s": 9.0}}


RECORDS = [
    _rec(2.0, 100, 0.4, 0.3, 0.2, 0.1, 1000, 600, 105, 40, 0.05, 50),
    _rec(3.0, 300, 1.0, 1.0, 0.8, 0.2, 3000, 1400, 310, 60, 0.15, 70),
    # a traced iteration: read by none of them
    _rec(99.0, 7, 9.0, 9.0, 9.0, 9.0, 7, 1, 9, 9, 50.0, 9, traced=True),
]
# by hand: trips (100 + 300) / 2; fit (40 + 60) / 2; 1e3 * (1.0 + 3.0) / 400;
# 100 * (0.2 + 0.8) / 4.0; 100 * (4000 - 2000) / 4000;
# 100 * (0.1 + 0.05 + 0.2 + 0.15) / (2.0 + 3.0); (105 + 50 + 310 + 70) / 2
EXPECTED = {"argmax_trips": 200.0, "fit_trips": 50.0, "argmax_trip_ms": 10.0,
            "argmax_update_share": 25.0, "argmax_probe_share": 50.0,
            "sync_wait_share": 10.0, "host_syncs_per_iter": 267.5}


def _ctx(records):
    return harness.Context(1.0, 5.0, records, None)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_on_synthetic_records(name):
    assert harness.load_reader(name).read(_ctx(RECORDS)) == pytest.approx(EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_nothing_without_the_ports_counters(name):
    bare = [{k: v for k, v in r.items() if k != "program"} for r in RECORDS]
    assert harness.load_reader(name).read(_ctx(bare)) is None
    # one record without them is enough to read nothing
    assert harness.load_reader(name).read(_ctx([RECORDS[0], bare[1]])) is None
    assert harness.load_reader(name).read(_ctx([])) is None


def test_ratios_with_nothing_under_them_read_nothing():
    empty = [{"wall": 1.0, "program": {"tell:s": 1.0}}]
    for name in ("argmax_trip_ms", "argmax_update_share", "argmax_probe_share"):
        assert harness.load_reader(name).read(_ctx(empty)) is None
    assert harness.load_reader("argmax_trips").read(_ctx(empty)) == 0.0
    assert harness.load_reader("host_syncs_per_iter").read(_ctx(empty)) == 0.0


def test_the_record_takes_the_difference_across_the_iteration():
    class Timer:
        def __init__(self):
            self.state = {"fit/lbfgs.trips": 3, "fit:s": 1.0, "old": 5}

        def snapshot(self):
            return dict(self.state)

    timer = Timer()

    def inner(loop, c):
        timer.state["fit/lbfgs.trips"] += 4
        timer.state["fit:s"] += 0.5
        timer.state["arg_max_acquisition/host_syncs"] = 2
        return {"wall": 1.0}

    client = types.SimpleNamespace(opt=types.SimpleNamespace(_timer=timer))
    rec = program._with_program(inner)(None, client)
    assert rec["program"] == {"fit/lbfgs.trips": 4, "fit:s": 0.5, "arg_max_acquisition/host_syncs": 2}
    # a port whose timer keeps no spans: no key, as before
    old = types.SimpleNamespace(opt=types.SimpleNamespace(_timer=types.SimpleNamespace()))
    assert "program" not in program._with_program(lambda loop, c: {"wall": 1.0})(None, old)


def test_the_loop_is_wrapped_once():
    from bench_port import traffic

    wrapped = traffic.Loop._iterate
    assert wrapped.takes_program
    harness.load_reader("argmax_trips")
    harness.load_reader("fit_trips")
    assert traffic.Loop._iterate is wrapped

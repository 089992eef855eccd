"""The control of the check of `correct` on the card, at each cell's own
size: the port's own outputs pass, while the plain reference put in the
port's place in TF32 (the precision below the configuration's float32) and
each fault the cell's file names (planted by `control.py`) come out as not
correct. `control.py` reads the same over many seeds."""
import pytest

from bench_port import harness
from bench_port.control import readings
from bench_port.reference import judge

CELLS = [w["name"] for w in harness.load_manifest()["workloads"]]
FAULTS = [(c, f) for c in CELLS for f in harness.cell_files(harness.load_manifest(), c)[2]["faults"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_port_passes(card, cell):
    limits = harness.cell_files(harness.load_manifest(), cell)[2]["limits"]
    # the worst over several iterations, as a run judges: the control can pass
    # a single iteration whose fit leaves the points nearly uncorrelated
    r = readings(cell, 20260001, 8.0)
    assert judge.verdict(r["program"], limits), r["program"]
    assert not judge.verdict(r["control_tf32"], limits, partial=True), r["control_tf32"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,fault", FAULTS)
def test_each_fault_fails(card, cell, fault):
    limits = harness.cell_files(harness.load_manifest(), cell)[2]["limits"]
    r = readings(cell, 20260002, 8.0, fault=fault)
    assert not judge.verdict(r["program"], limits), r["program"]

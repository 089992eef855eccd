"""BENCHMARK.json against the contract's shape, and discovery by name."""
import json
import re
from pathlib import Path

import pytest

from bench_port import harness
from bench_port.reference import judge

ROOT = Path(harness.__file__).resolve().parent.parent
M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert M["command"][0] == "python3" and M["command"][1] == "bench_port/run.py"
    assert M["paths"] == ["bench_port"]
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    names = []
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench_port/") and (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and w["config"] in names
        names.append(w["name"])
    for m in M["end_to_end"] + M["per_layer"]:
        allowed = {"name", "unit", "better", "source", "workloads"}
        allowed |= {"bound"} if m in M["end_to_end"] else {"layer", "moves"}
        assert set(m) <= allowed
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert all(NAME.match(n) for n in names)
    for key in ("configs", "workloads"):
        assert len({x["name"] for x in M[key]}) == len(M[key])
    metric_names = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    texts = [c["source"] for c in M["configs"]] + [c["why"] for c in M["configs"]]
    texts += [w["why"] for w in M["workloads"]] + [m["layer"] for m in M["per_layer"]]
    assert all(1 <= len(t) <= 200 and "\n" not in t and "\t" not in t for t in texts)


def test_end_to_end_bounds_and_sources():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in M["workloads"]}
    for m in M["per_layer"]:
        assert m["moves"] in e2e and set(m.get("workloads", cells)) <= cells
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in M["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    layers = {m["layer"] for m in M["per_layer"]}
    assert all(len(x) <= 200 for x in layers)


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_cells_found_by_name(cell):
    entry, cfg, tr = harness.cell_files(M, cell, ROOT)
    assert tr["config"] == entry["config"] == cfg["name"]
    assert set(tr["limits"]) == set(judge.NUMBERS)
    assert tr["limits"]["out_of_box"] == 0 and judge.compared(tr["limits"])
    # every cell holds the argmax's answers to a quality number
    assert "argmax_ascent" in judge.compared(tr["limits"])
    e2e = harness.cell_metrics(M, cell, trace=False)
    layer = harness.cell_metrics(M, cell, trace=True)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layer
    for m in e2e + layer:
        assert callable(harness.load_reader(m["name"]).read)


def test_every_config_is_used_and_has_its_own_file():
    used = {w["config"] for w in M["workloads"]}
    assert used == {c["name"] for c in M["configs"]}
    assert len({c["file"] for c in M["configs"]}) == len(M["configs"])


def test_four_chip_cells_within_the_share():
    four = sum(w["chips"] == 4 for w in M["workloads"])
    assert four <= max(1, len(M["workloads"]) // 4)

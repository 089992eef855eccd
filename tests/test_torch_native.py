"""The port's host C++ WFG hypervolume (native/) against the exact algorithms
of the JAX package's ops/hypervolume.py, the cases of tests/test_native.py
with its tolerances, and `available()`, a query that never stands in for the
build's own error."""
import numpy as np
import pytest

from bayesian_optimization_tpu.ops.hypervolume import _hv_2d, _hv_grid
from bayesian_optimization_tpu_torch import native
from bayesian_optimization_tpu_torch.native import available, wfg_hypervolume
from bayesian_optimization_tpu_torch.ops import hypervolume as thv


def test_available_reports_the_build(monkeypatch, tmp_path):
    """True where g++ builds wfg.cpp; False for a source it cannot build,
    while the hypervolume path still raises g++'s error."""
    assert available() is True
    bad = tmp_path / "wfg.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "_build")
    native.load_library.cache_clear()
    try:
        assert available() is False
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            thv.hypervolume(np.random.default_rng(1).uniform(0.1, 1.0, (40, 4)), np.zeros(4))
    finally:
        native.load_library.cache_clear()


def test_wfg_matches_2d_sweep():
    Y = np.random.default_rng(0).uniform(0.1, 1.0, (15, 2))
    ref = np.zeros(2)
    assert wfg_hypervolume(Y, ref) == pytest.approx(_hv_2d(Y, ref), rel=1e-12)


@pytest.mark.parametrize("m", [3, 4])
def test_wfg_matches_grid(m):
    Y = np.random.default_rng(m).uniform(0.1, 1.0, (8, m))
    ref = np.zeros(m)
    assert wfg_hypervolume(Y, ref) == pytest.approx(_hv_grid(Y, ref), rel=1e-10)


def test_wfg_handles_dominated_and_below_ref():
    Y = np.array([[1.0, 1.0], [0.5, 0.5], [-1.0, 2.0]])
    assert wfg_hypervolume(Y, np.zeros(2)) == pytest.approx(1.0, rel=1e-12)


def test_dispatcher_uses_native_for_large_fronts(monkeypatch):
    """A 40 x 4 front goes to the WFG routine (the grid would take ~7 s)."""
    Y = np.random.default_rng(1).uniform(0.1, 1.0, (40, 4))
    ref = np.zeros(4)
    calls = []
    monkeypatch.setattr(thv, "wfg_hypervolume", lambda *a: calls.append(1) or wfg_hypervolume(*a))
    v = thv.hypervolume(Y, ref)
    assert calls == [1]
    assert v == pytest.approx(wfg_hypervolume(Y, ref), rel=1e-10)

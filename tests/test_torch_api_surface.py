"""The port's top-level API surface against the JAX package's, the cases of
tests/test_api_surface.py on the port's root: every name of the reference's
__all__ (REFERENCE_ALL, taken from that file), every name of the JAX
package's own __all__, and the names of each subpackage's __all__."""
import ast
import importlib
from pathlib import Path

import pytest

import bayesian_optimization_tpu as jbo
import bayesian_optimization_tpu_torch as pkg

REFERENCE_ALL = next(
    ast.literal_eval(node.value)
    for node in ast.parse(Path(__file__).with_name("test_api_surface.py").read_text()).body
    if isinstance(node, ast.Assign) and node.targets[0].id == "REFERENCE_ALL"
)


def test_reference_all_importable():
    missing = [n for n in REFERENCE_ALL if not hasattr(pkg, n)]
    assert not missing, f"missing top-level names: {missing}"


def test_all_list_consistent():
    missing = [n for n in pkg.__all__ if not hasattr(pkg, n)]
    assert not missing, f"__all__ names not actually exported: {missing}"
    # the port drops none of the JAX package's names
    assert not [n for n in jbo.__all__ if n not in pkg.__all__]


@pytest.mark.parametrize("sub", ["core", "models", "ops", "optim", "space", "utils", "parallel"])
def test_subpackage_all_matches_jax(sub):
    j = importlib.import_module(f"bayesian_optimization_tpu.{sub}")
    t = importlib.import_module(f"bayesian_optimization_tpu_torch.{sub}")
    assert not [n for n in j.__all__ if not hasattr(t, n)]


def test_trend_module_contents():
    assert callable(pkg.trend.constant_trend)
    assert callable(pkg.trend.linear_trend)
    assert callable(pkg.trend.quadratic_trend)


def test_acquisition_classes_constructible():
    for cls in (pkg.EI, pkg.PI, pkg.UCB, pkg.MGFI, pkg.GEI, pkg.EpsilonPI):
        obj = cls(model=None)
        assert obj.minimize is True


def test_optim_exports():
    from bayesian_optimization_tpu_torch.optim import (  # noqa: F401
        MIES, AcquisitionArgmax, OnePlusOne_Cholesky_CMA,
    )

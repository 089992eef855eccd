"""Percentiles, interval unions and gaps, the roofline's work counts, TF32 rounding."""

import numpy as np
import pytest
import torch

from bench_port import stats, work
from bench_port.reference import gp


@pytest.mark.parametrize("q", [0, 10, 50, 90, 95, 100])
@pytest.mark.parametrize("n", [1, 2, 7, 40])
def test_percentile_matches_numpy_linear(q, n):
    xs = np.random.default_rng(n).exponential(size=n)
    assert stats.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)), rel=1e-12)


def test_union_length_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 9)]
    assert stats.union_length(iv) == pytest.approx(5.0)
    assert stats.union_length(iv, 1.5, 8.5) == pytest.approx(1.5 + 1.0 + 0.5)
    assert stats.gaps(iv, 0, 10) == [(3, 5), (6, 8), (9, 10)]
    assert stats.gaps([], 0, 1) == [(0, 1)]
    assert stats.union_length([]) == 0.0


def test_cov_build_work_and_bound():
    flops, nbytes = work.cov_build(2, 1024, 1024, 5)
    assert flops == 2 * 1024 * 1024 * 20
    assert nbytes == 4 * (10 + 1024 * 5 + 2 * 1024 * 1024)
    # bytes bound it: K written once at 3.35 TB/s
    assert work.cov_build_bound_s(2, 1024, 1024, 5) == pytest.approx(nbytes / 3.35e12)


def test_factor_work_and_bound():
    flops, nbytes = work.factor(8, 1024, 2)
    assert flops == pytest.approx(8 * (1024 ** 3 / 3 + 1024 ** 2 * 2))
    assert nbytes == pytest.approx(4 * 8 * (1024 * 1025 + 2 * 1024 * 2))
    # operations bound it, at the float32-accurate tensor-core rate
    assert work.factor_bound_s(8, 1024, 2) == pytest.approx(flops / (495e12 / 3))
    # a small factorisation is bound by its bytes
    assert work.factor_bound_s(1, 16, 1) == pytest.approx(work.factor(1, 16, 1)[1] / 3.35e12)


def test_roofline_share_of_a_call_at_its_bound_is_100():
    from bench_port.harness import load_reader

    t = work.cov_build_bound_s(1, 25, 1024, 5)
    ctx = type("C", (), {"trace": {"ops": {"_MaternFn": [([[1, 5], [25, 5], [1024, 5]], t)]}}})()
    assert load_reader("cov_build_roofline").read(ctx) == pytest.approx(100.0)
    ctx.trace["ops"]["_MaternFn"] = [([[1, 5], [25, 5], [1024, 5]], 4 * t)]
    assert load_reader("cov_build_roofline").read(ctx) == pytest.approx(25.0)
    ctx.trace["ops"]["_MaternFn"] = []
    assert load_reader("cov_build_roofline").read(ctx) is None  # nothing to read: no value
    t = work.factor_bound_s(2, 1024, 2)
    ctx.trace["ops"]["_Whiten"] = [([[2, 1024, 1024], [2, 1024, 2]], 2 * t)]
    assert load_reader("factor_roofline").read(ctx) == pytest.approx(50.0)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -12, 3.14159265, -2.5e-7])
    r = gp._round_tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0 + 2.0 ** -10 and r[2] == 1.0
    assert torch.all(torch.abs(r - x) <= torch.abs(x) * 2.0 ** -11)
    a = torch.randn(64, 64)
    err = (gp.mm(a, a.T, "tf32") - a.double() @ a.double().T).abs().max()
    assert 1e-4 < float(err) < 1e-1


def test_reference_cholesky_and_solves_match_torch():
    g = torch.Generator().manual_seed(0)
    A = torch.randn(150, 150, generator=g, dtype=torch.float64)
    S = A @ A.T + 150 * torch.eye(150, dtype=torch.float64)
    L = gp.cholesky(S, "float64")
    assert torch.allclose(L, torch.linalg.cholesky(S), atol=1e-10)
    B = torch.randn(150, 3, generator=g, dtype=torch.float64)
    assert torch.allclose(L @ gp.solve_lower(L, B, "float64"), B, atol=1e-10)
    assert torch.allclose(L.T @ gp.solve_upper_t(L, B, "float64"), B, atol=1e-10)
    bad = S.clone()
    bad[100, 100] = -1.0
    assert torch.isnan(gp.cholesky(bad, "float64")).all()

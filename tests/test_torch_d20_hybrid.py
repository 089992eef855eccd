"""The 20-D path of the port at bucket sizes past one factorisation call,
against plain float64 references on the CPU.

Above `ops.linalg.SUPER` rows (1024 on the card) the port factors R in
superpanels (`_factor_hybrid`) and its backward solves with their explicit
inverses (`_super_inv`, `tri_solve_upper_t_super`). Here SUPER is cut to
128, 256 or 384 so that a few hundred rows run those paths, 384 with a ragged
last panel (1024 = 384 + 384 + 256). The GP is the configuration
`bbob-f8-d20-gp-mle`'s (Matern 3/2, constant trend, nugget 1e-6, 20
features), held against `bench_port/reference/gp.py`, the float64
reference that decides the benchmark cell's `correct`; the cell
`f8d20-mle.seq` itself runs through `bench_port.harness.run_cell` at a small
size.
"""
import numpy as np
import pytest
import torch

from bayesian_optimization_tpu_torch.ops import linalg
from bayesian_optimization_tpu_torch.ops.hopper_kernels import matern_plain, whiten_plain
from bayesian_optimization_tpu_torch.utils import logging as tracing
from bayesian_optimization_tpu_torch.utils.logging import PhaseTimer
from bench_port import harness
from bench_port.bbob import BBOBFunction
from bench_port.reference import gp as ref

D = 20
# (n, superpanel width): even panels, and a ragged last one
PANELS = [(384, 128), (640, 256), (1024, 384)]


def _correlation(n, batch, seed):
    """(batch, n, n) float32 Matern-3/2 correlations of 20-D points with a
    1e-3 nugget: the likelihood's R at a moderate theta."""
    rng = np.random.default_rng(seed)
    X = torch.tensor(rng.uniform(0, 1, (n, D)))
    theta = torch.tensor(10 ** rng.uniform(-0.5, 0.5, (batch, D)) / D)
    K = matern_plain(theta, X, nu=1.5)
    return (K + 1e-3 * torch.eye(n)).float()


def _in_phase(fn):
    """fn() inside a timed phase: (its result, the phase's snapshot)."""
    timer = PhaseTimer()
    token = tracing._PHASE.set((timer, "fit"))
    try:
        out = fn()
    finally:
        tracing._PHASE.reset(token)
    return out, timer.snapshot()


def _rel(a, b):
    return float((a.double() - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("n, sup", PANELS)
def test_hybrid_factorisation_matches_one_call(monkeypatch, n, sup):
    """`_whiten_parts` through the superpanels against float64, beside one
    float32 call of the twin on the whole matrix (LAPACK): L and W no
    farther from float64 than 4 times the twin's own error (the Schur
    updates round once more a panel: measured 1.4-2.7 times, at cond(R)
    6e4-2e5; a wrong panel is off by O(1)), the pivots within 1e-3 of the
    twin's, the 128-wide Dinv blocks inverting L's; the span records one
    call."""
    monkeypatch.setattr(linalg, "SUPER", sup)
    R = _correlation(n, 2, seed=n)
    B = torch.tensor(np.random.default_rng(1).standard_normal((2, n, 3)), dtype=torch.float32)
    (d, W, piv, L, Dinv), snap = _in_phase(lambda: linalg._whiten_parts(R, B))
    _, W0, piv0, L0, Dinv0 = whiten_plain(R, B)
    L64 = torch.linalg.cholesky(R.double())
    W64 = torch.linalg.solve_triangular(L64, B.double(), upper=False)
    assert snap["fit/linalg.hybrid:n"] == 1
    assert _rel(L, L64) <= 4.0 * _rel(L0, L64)
    assert _rel(W, W64) <= 4.0 * _rel(W0, W64)
    assert torch.equal(d, L.diagonal(dim1=-2, dim2=-1))
    assert float(((piv - piv0) / piv0).abs().max()) < 1e-3
    assert Dinv.shape == Dinv0.shape == (2, n // 128, 128, 128)
    for k in range(n // 128):
        blk = L[:, k * 128:(k + 1) * 128, k * 128:(k + 1) * 128]
        assert float((Dinv[:, k] @ blk - torch.eye(128)).abs().max()) < 1e-4
    assert float(torch.triu(L, 1).abs().max()) == 0.0


def test_no_hybrid_at_or_below_one_call(monkeypatch):
    """At SUPER rows and below, one call: no span."""
    monkeypatch.setattr(linalg, "SUPER", 256)
    R = _correlation(256, 1, seed=3)
    _, snap = _in_phase(lambda: linalg._whiten_parts(R, torch.ones(1, 256, 1)))
    assert snap == {}


def test_hybrid_span_is_an_operator_range_under_a_profiler(monkeypatch):
    """Under a profiler the span "linalg.hybrid" is an operator's range
    (not a user annotation) around every operator of the factorisation: the
    profiler links each kernel to the innermost operator that launched it,
    so the hand-written kernels' launches, which no aten operator wraps,
    belong to the span (bench_port/metrics/hybrid_share.py reads them)."""
    monkeypatch.setattr(linalg, "SUPER", 128)
    R = _correlation(384, 1, seed=5)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _in_phase(lambda: linalg._whiten_parts(R, torch.ones(1, 384, 1)))
    events = list(prof.profiler.kineto_results.events())
    spans = [e for e in events if e.name() == "linalg.hybrid"]
    assert len(spans) == 1 and not spans[0].is_user_annotation()
    s, t = spans[0].start_ns(), spans[0].end_ns()
    inner = [e for e in events if e.name() in ("aten::matmul", "aten::cat")]
    assert inner and all(s <= e.start_ns() and e.end_ns() <= t for e in inner)


@pytest.mark.parametrize("n, sup", PANELS)
def test_hybrid_backward_against_float64(monkeypatch, n, sup):
    """`whiten`'s gradient through the superpanel backward against float64
    autograd through torch's Cholesky: no farther than 2 times float32
    autograd through torch's Cholesky and triangular solve (measured 0.96-
    1.55 times: both carry the float32 factor's own error)."""
    monkeypatch.setattr(linalg, "SUPER", sup)
    R = _correlation(n, 2, seed=n)
    B = torch.tensor(np.random.default_rng(1).standard_normal((2, n, 3)), dtype=torch.float32)

    def grad(whiten, R):
        Rt = R.clone().requires_grad_(True)
        d, W = whiten(Rt, B.to(R.dtype))
        (torch.log(d).sum() + (W ** 2).sum()).backward()
        return Rt.grad

    def plain(R, B):
        L = torch.linalg.cholesky(R)
        return L.diagonal(dim1=-2, dim2=-1), torch.linalg.solve_triangular(L, B, upper=False)

    g, g32, g64 = grad(lambda R, B: linalg.whiten(R, B)[:2], R), grad(plain, R), grad(plain, R.double())
    assert _rel(g, g64) <= 2.0 * _rel(g32, g64)


def _f8_history(n, seed):
    """n uniform rows of [0, 1]^20 and standardized BBOB F8 values (the
    benchmark's history recipe, in the unit cube the GP fits)."""
    rng = np.random.default_rng(seed)
    f = BBOBFunction(8, D, 7)
    U = rng.uniform(0, 1, (n, D))
    y = f(-5.0 + 10.0 * U)
    return U, (y - y.mean()) / y.std()


# Limits of the 20-D fit and EI against the float64 reference, set from
# readings of 17 fits at n = 300 on the CPU (history seeds 0-6 and 384 at
# two SUPER widths, and seed 128 at SUPER 128, the tests' own two among
# them; the float32 port against the float64 reference, and the reference in
# emulated TF32 against it at the port's hyperparameters). Read first with
# the data at the bucket's 1024 rows (SUPER 128 and 384), then at the fit's
# 384-row layout (SUPER 128 and 256), whose readings are given second:
# - r^2: the port's worst 1.6e-10 / 1.6e-10, TF32's least 3.4e-8 / 3.4e-8.
#   3e-9 leaves ~18x for another CPU's BLAS, and TF32 fails it on every one
#   of the 17.
# - EI at the argmax winner, relative to |EI| + sd / 100 (the judge's
#   crit_gap): the port's worst 1.1e-5 / 1.5e-5, TF32's least 6.8e-5 /
#   7.5e-5.
# - log likelihood a row: the port's worst 1.7e-6 / 2.5e-6 (the float32
#   reference itself reaches 2.8e-6), TF32's least 1.2e-7 / 1.7e-7, so no
#   limit on it separates the two; 1e-5 holds float32 with ~4x room and
#   TF32 fails it on 9 / 7 of the 17.
LL_ROW, R2, EI_REL = 1e-5, 3e-9, 5e-5


@pytest.mark.parametrize("seed, sup", [(128, 128), (384, 256)], ids=["128", "384"])
def test_d20_gp_and_ei_against_the_reference(monkeypatch, seed, sup):
    """A seeded 20-D fit at n = 300 (384 rows: 3 superpanels of 128, or
    256 + 128) and the BFGS EI argmax on its posterior, against the
    float64 reference at the port's hyperparameters, within LL_ROW, R2 and
    EI_REL (their readings above); the reference in TF32, the precision below
    float32, at the same hyperparameters fails at least one of them, so a
    port that computed at TF32 precision would fail here. Fewer restarts and
    steps than the configuration's keep it short: the comparison is at
    whatever the fit ends on."""
    import bayesian_optimization_tpu_torch as bo
    from bayesian_optimization_tpu_torch.models.trend import constant_trend

    monkeypatch.setattr(linalg, "SUPER", sup)
    calls = []
    real = linalg._factor_hybrid
    monkeypatch.setattr(linalg, "_factor_hybrid", lambda *a: calls.append(a[0].shape) or real(*a))
    U, ys = _f8_history(300, seed=seed)
    gp = bo.GaussianProcess(mean=constant_trend(D), corr="matern", thetaL=1e-2 * np.ones(D),
                            thetaU=1e4 * np.ones(D), nugget=1e-6, random_start=4, max_iter=8,
                            random_state=0, device="cpu")
    gp.fit(U, ys.reshape(-1, 1))
    assert calls and all(s[-1] == 384 for s in calls)
    am = bo.AcquisitionArgmax(bo.RealSpace([[0.0, 1.0]] * D).encoding(), method="BFGS",
                              seed=0, device="cpu")
    assert am.n_restart == 5 * D
    u, v = am(gp.posterior, gp.config, "EI", {"plugin": float(ys.min())})

    def r2(mu):
        return 1.0 - ((ys - mu) ** 2).sum() / ((ys - ys.mean()) ** 2).sum()

    def reference(prec):
        """(log likelihood, r^2, EI at the winner, sd there) of the reference."""
        post = ref.Posterior(U, ys, gp._map_par_log10, gp.noise_var, 1e-6, prec, "cpu")
        mu, var = post.predict(np.atleast_2d(u))
        sd = torch.sqrt(var).double()
        ei = float(ref.expected_improvement(mu.double(), sd, float(ys.min()))[0])
        return post.log_likelihood, r2(post.predict(U)[0].double().numpy()), ei, float(sd[0])

    def gaps(ll, r2v, ei):
        return (abs(ll - ll64) / len(ys), abs(r2v - r2_64),
                abs(ei - ei64) / (abs(ei64) + sd64 / 100.0))

    ll64, r2_64, ei64, sd64 = reference("float64")
    port = gaps(gp.log_likelihood_, r2(np.asarray(gp.predict(U)).ravel()), v)
    assert port[0] < LL_ROW and port[1] < R2 and port[2] < EI_REL
    tf32 = gaps(*reference("tf32")[:3])
    assert tf32[0] > LL_ROW or tf32[1] > R2 or tf32[2] > EI_REL


def test_f8d20_cell_runs_correct_on_the_cpu(monkeypatch):
    """The cell `f8d20-mle.seq` through the benchmark's own run at a small
    size (n0 = 130, 2 histories, 2 replayed iterations), with SUPER cut to
    128 so that its 256 rows run the hybrid factorisation and its backward:
    the judge calls it correct against the cell's limits."""
    monkeypatch.setattr(linalg, "SUPER", 128)
    calls = []
    real = linalg._factor_hybrid
    monkeypatch.setattr(linalg, "_factor_hybrid", lambda *a: calls.append(1) or real(*a))
    # this suite's conftest loads JAX to hold the port against it; the
    # run's own check for JAX is bench_port/tests' (test_bench_run.py)
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])
    result, code = harness.run_cell(
        "f8d20-mle.seq", 2**31 + 29, 0.5, False, device="cpu",
        overrides={"n0": 130, "replay": 2, "histories": 2, "quality_sample": 1})
    assert code == 0 and calls
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"iter_s", "setup_s"}

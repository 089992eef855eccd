"""The port's multi-objective operators against the JAX package on the CPU:
Pareto masks and ranks, the hypervolume (grid, sweep and the port's own WFG
build), the box decomposition, EHVI and qEHVI, and the EHVI/qEHVI branches
of the acquisition criterion, on the same numpy-seeded inputs. Also every
operator case of tests/test_mo.py, run on the port.

qEHVI's samples come from jax.random in the JAX package and are an argument
(`eps`) of the port's qehvi: the parity cases rebuild JAX's samples from
its key and hand them to the port."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesian_optimization_tpu as jbo
import bayesian_optimization_tpu_torch as tbo
from bayesian_optimization_tpu.models import GaussianProcess as JGP
from bayesian_optimization_tpu.models import constant_trend as j_const
from bayesian_optimization_tpu.models.likelihood import PosteriorState as JState
from bayesian_optimization_tpu.models.random_forest import RandomForest as JRF
from bayesian_optimization_tpu.models.random_forest import RFState as JRFState
from bayesian_optimization_tpu.ops import box_decomposition as jbox
from bayesian_optimization_tpu.ops import ehvi as jehvi
from bayesian_optimization_tpu.ops import hypervolume as jhv
from bayesian_optimization_tpu.ops import pareto as jpareto
from bayesian_optimization_tpu.optim.argmax import AcquisitionArgmax as JArgmax
from bayesian_optimization_tpu.optim.argmax import make_unit_criterion as j_criterion
from bayesian_optimization_tpu_torch import native
from bayesian_optimization_tpu_torch.models import GaussianProcess as TGP
from bayesian_optimization_tpu_torch.models.convert import rf_state_from_numpy
from bayesian_optimization_tpu_torch.ops import box_decomposition as tbox
from bayesian_optimization_tpu_torch.ops import ehvi as tehvi
from bayesian_optimization_tpu_torch.ops import hypervolume as thv
from bayesian_optimization_tpu_torch.ops import pareto as tpareto
from bayesian_optimization_tpu_torch.optim import argmax as targmax
from bayesian_optimization_tpu_torch.optim.argmax import AcquisitionArgmax as TArgmax
from bayesian_optimization_tpu_torch.optim.argmax import make_unit_criterion as t_criterion

torch.set_num_threads(1)  # one thread per pytest worker: more oversubscribe the cores


def _front(rng, n, m):
    """n points on the positive unit sphere's shell: every one non-dominated."""
    Y = np.abs(rng.standard_normal((n, m)))
    return 0.2 + 0.8 * Y / np.linalg.norm(Y, axis=1, keepdims=True)


def _j64(a):
    return jnp.asarray(np.asarray(a), jnp.float64)


def _t64(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _jax_eps(key, S, q, m, dtype=jnp.float64):
    """The standard-normal samples JAX's qehvi draws from `key` in the
    moments' dtype (float32 draws are not float64 draws rounded)."""
    with jax.enable_x64():
        return np.asarray(jax.random.normal(key, (S, q, m), dtype))


# ------------------------------------------------------------------ Pareto
@pytest.mark.parametrize("m", [2, 3])
@pytest.mark.parametrize("dedup", [True, False])
def test_is_non_dominated_matches_jax(m, dedup):
    """Integer grids give ties in single coordinates and duplicate rows."""
    rng = np.random.default_rng(m)
    for _ in range(5):
        Y = rng.integers(0, 4, (40, m)).astype(float)
        Y[7] = Y[3]  # an exact duplicate of a row, kept or dropped with it
        want = np.asarray(jpareto.is_non_dominated(Y, deduplicate=dedup))
        got = tpareto.is_non_dominated(Y, deduplicate=dedup)
        assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("m", [2, 3])
def test_fast_non_dominated_sort_matches_jax(m):
    rng = np.random.default_rng(10 + m)
    Y = rng.integers(0, 5, (50, m)).astype(float)
    Y[9] = Y[2]
    got = tpareto.fast_non_dominated_sort(Y)
    assert np.array_equal(got, jpareto.fast_non_dominated_sort(Y)) and got.min() == 0


def test_is_non_dominated():
    Y = np.array([[1.0, 0.0], [0.0, 1.0], [0.5, 0.5], [0.4, 0.4], [1.0, 0.0]])
    assert tpareto.is_non_dominated(Y).tolist() == [True, True, True, False, False]


def test_fast_non_dominated_sort():
    rank = tpareto.fast_non_dominated_sort(np.array([[2.0, 2.0], [1.0, 1.0], [0.0, 0.0], [2.0, 0.0]]))
    assert rank.tolist() == [0, 1, 2, 1]


# ------------------------------------------------------------- hypervolume
@pytest.mark.parametrize("m, n", [(2, 30), (3, 12), (3, 40), (4, 8), (4, 40)])
def test_hypervolume_matches_jax(m, n):
    """Random points, some below the reference point, some dominated; the
    large fronts ((3, 40), (4, 40)) take the WFG routine in both packages."""
    rng = np.random.default_rng(100 + m * n)
    Y = rng.uniform(-0.2, 1.0, (n, m))
    ref = np.zeros(m)
    want = jhv.hypervolume(Y, ref)
    assert thv.hypervolume(Y, ref) == pytest.approx(want, rel=1e-12)
    assert thv.Hypervolume(ref).compute(Y) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("m", [3, 4])
def test_wfg_matches_grid(m):
    rng = np.random.default_rng(m)
    Y = rng.uniform(0.1, 1.0, (8, m))
    assert native.wfg_hypervolume(Y, np.zeros(m)) == pytest.approx(jhv._hv_grid(Y, np.zeros(m)),
                                                                    rel=1e-10)


def test_wfg_matches_2d_sweep_and_handles_points_below_ref():
    Y = np.random.default_rng(0).uniform(0.1, 1.0, (15, 2))
    assert native.wfg_hypervolume(Y, np.zeros(2)) == pytest.approx(jhv._hv_2d(Y, np.zeros(2)), rel=1e-12)
    Y = np.array([[1.0, 1.0], [0.5, 0.5], [-1.0, 2.0]])
    assert native.wfg_hypervolume(Y, np.zeros(2)) == pytest.approx(1.0, rel=1e-12)


def test_large_front_dispatches_to_the_ports_wfg(monkeypatch):
    """40 x 4 goes to the WFG routine (the grid would take ~7 s) and equals
    JAX's grid; the library is the port's, built into its _build/ under a
    name keyed by the source's hash."""
    rng = np.random.default_rng(1)
    Y = rng.uniform(0.1, 1.0, (40, 4))
    calls = []
    monkeypatch.setattr(thv, "wfg_hypervolume", lambda *a: calls.append(1) or native.wfg_hypervolume(*a))
    assert thv.hypervolume(Y, np.zeros(4)) == pytest.approx(jhv.hypervolume(Y, np.zeros(4)), rel=1e-10)
    assert calls == [1]
    path = native.library_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "bayesian_optimization_tpu_torch"
    assert not list((path.parent.parent / "native").glob("*.so"))


def test_failed_wfg_build_raises(monkeypatch, tmp_path):
    """A source g++ cannot build raises, in the dispatch too: no fallback."""
    bad = tmp_path / "wfg.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "_build")
    native.load_library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            thv.hypervolume(np.random.default_rng(1).uniform(0.1, 1.0, (40, 4)), np.zeros(4))
        assert not list((tmp_path / "_build").glob("*.so"))
    finally:
        native.load_library.cache_clear()


def test_hypervolume_goldens():
    assert thv.hypervolume(np.array([[1.0, 2.0], [2.0, 1.0]]), [0.0, 0.0]) == pytest.approx(3.0)
    assert thv.hypervolume(np.array([[1.0, 1.0, 1.0]]), [0.0, 0.0, 0.0]) == pytest.approx(1.0)
    Y2 = np.array([[1.0, 1.0, 1.0], [2.0, 0.5, 0.5]])
    assert thv.hypervolume(Y2, [0.0, 0.0, 0.0]) == pytest.approx(1.25)
    assert thv.hypervolume(np.array([[1.0, 1.0], [-1.0, -1.0]]), [0.0, 0.0]) == pytest.approx(1.0)


# ------------------------------------------------------ box decomposition
@pytest.mark.parametrize("m, n", [(2, 8), (2, 16), (3, 7), (3, 12), (4, 6)])
def test_partitioning_cells_equal_jax_in_order(m, n):
    """The same cells in the same order, on a true front plus dominated and
    below-reference points."""
    rng = np.random.default_rng(7 + m * n)
    Y = np.vstack([_front(rng, n, m), rng.uniform(0.0, 0.6, (n, m)), -rng.uniform(0, 1, (3, m))])
    ref = np.full(m, 0.05)
    j, t = jbox.NondominatedPartitioning(ref, Y), tbox.NondominatedPartitioning(ref, Y)
    np.testing.assert_array_equal(t.pareto_Y, j.pareto_Y)
    np.testing.assert_array_equal(t.get_hypercell_bounds(), j.get_hypercell_bounds())
    assert t.compute_hypervolume() == pytest.approx(j.compute_hypervolume(), rel=1e-12)
    assert tbox.FastNondominatedPartitioning is tbox.NondominatedPartitioning


@pytest.mark.parametrize("m, n", [(2, 8), (3, 7), (4, 5)])
def test_slab_cells_match_grid_golden(m, n):
    """tests/test_mo.py's golden on the port: the slab cells cover the grid
    oracle's region, and EHVI over either agrees."""
    rng = np.random.default_rng(7)
    Y = rng.uniform(0.2, 1.0, (n, m))
    ref = np.zeros(m)
    part = tbox.NondominatedPartitioning(ref, Y)
    P = part.pareto_Y[np.all(part.pareto_Y > ref, axis=1)]
    glo, ghi = tbox._grid_cells(ref, P)
    jlo, jhi = jbox._grid_cells(ref, P)
    np.testing.assert_array_equal(glo, jlo)
    np.testing.assert_array_equal(ghi, jhi)
    B = 1.5
    v_fast = np.sum(np.prod(np.maximum(np.minimum(part.cell_upper, B) - part.cell_lower, 0), axis=1))
    v_grid = np.sum(np.prod(np.maximum(np.minimum(ghi, B) - glo, 0), axis=1))
    assert v_fast == pytest.approx(v_grid, rel=1e-9) and len(part.cell_lower) <= len(glo)
    mu, sd = _t64(rng.uniform(0.3, 0.9, (4, m))), _t64(rng.uniform(0.05, 0.3, (4, m)))
    e_fast = tehvi.ehvi(mu, sd, _t64(part.cell_lower), _t64(part.cell_upper))
    e_grid = tehvi.ehvi(mu, sd, _t64(glo), _t64(ghi))
    np.testing.assert_allclose(e_fast.numpy(), e_grid.numpy(), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("m, B", [(2, 2.0), (3, 1.5)])
def test_partitioning_covers_complement(m, B):
    """Non-dominated cells + dominated hypervolume = total box volume."""
    Y = np.random.default_rng(m - 2).uniform(0.2, 1.0, (6 - (m - 2), m))
    part = tbox.NondominatedPartitioning(np.zeros(m), Y)
    lo, hi = part.cell_lower, np.minimum(part.cell_upper, B)
    vol_nd = np.sum(np.prod(np.maximum(hi - lo, 0), axis=1))
    assert vol_nd + thv.hypervolume(Y, np.zeros(m)) == pytest.approx(B ** m, rel=1e-9)


def test_slab_cells_polynomial_count_m3():
    rng = np.random.default_rng(3)
    Y = rng.dirichlet(np.ones(3), 200)
    Y = Y[tpareto.is_non_dominated(Y).numpy()][:50]
    assert len(Y) == 50
    part = tbox.NondominatedPartitioning(np.zeros(3), Y)
    assert len(part.cell_lower) <= 5000, len(part.cell_lower)
    lo, hi = part.cell_lower, np.minimum(part.cell_upper, 1.2)
    vol_nd = np.sum(np.prod(np.maximum(hi - lo, 0), axis=1))
    assert vol_nd + thv.hypervolume(Y, np.zeros(3)) == pytest.approx(1.2 ** 3, rel=1e-6)


# -------------------------------------------------------------- EHVI, qEHVI
def _cells(m, n=6, seed=0):
    rng = np.random.default_rng(seed)
    part = jbox.NondominatedPartitioning(np.zeros(m), _front(rng, n, m))
    return part.cell_lower, part.cell_upper


@pytest.mark.parametrize("m", [2, 3, 4])
def test_ehvi_and_its_gradient_match_jax_float64(m):
    lo, hi = _cells(m, seed=m)
    rng = np.random.default_rng(20 + m)
    mu, sd = rng.uniform(0.1, 1.2, (16, m)), rng.uniform(0.01, 0.4, (16, m))
    mu[0], sd[0] = 1.1, 0.0  # the sigma floor, at a point beyond the front
    with jax.enable_x64():
        want = np.asarray(jehvi.ehvi(_j64(mu), _j64(sd), _j64(lo), _j64(hi)))
        g_want = np.asarray(jax.grad(lambda a: jnp.sum(jehvi.ehvi(a, _j64(sd), _j64(lo), _j64(hi))))(
            _j64(mu)))
    mu_t = _t64(mu).requires_grad_(True)
    got = tehvi.ehvi(mu_t, _t64(sd), _t64(lo), _t64(hi))
    (g_got,) = torch.autograd.grad(got.sum(), mu_t)
    assert np.all(want > 0)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-10, atol=0)
    assert np.abs(g_got.numpy() - g_want).max() <= 1e-8 * np.abs(g_want).max()


@pytest.mark.parametrize("q", [1, 2, 3, 4])
def test_qehvi_matches_jax_on_the_same_samples(q):
    """JAX's samples rebuilt from its key and handed to the port; one lane
    and P lanes at once (each lane as alone)."""
    lo, hi = _cells(2, seed=q)
    rng = np.random.default_rng(30 + q)
    mu, sd = rng.uniform(0.1, 1.1, (5, q, 2)), rng.uniform(0.02, 0.4, (5, q, 2))
    key = jax.random.PRNGKey(q)
    eps = _jax_eps(key, 64, q, 2)
    with jax.enable_x64():
        want = np.array([float(jehvi.qehvi(_j64(a), _j64(b), _j64(lo), _j64(hi), key, n_samples=64))
                         for a, b in zip(mu, sd)])
    lanes = tehvi.qehvi(_t64(mu), _t64(sd), _t64(lo), _t64(hi), _t64(eps))
    alone = [float(tehvi.qehvi(_t64(a), _t64(b), _t64(lo), _t64(hi), _t64(eps))) for a, b in zip(mu, sd)]
    np.testing.assert_allclose(lanes.numpy(), want, rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(alone, want, rtol=1e-10, atol=1e-14)


def test_qehvi_chunks_lanes_with_the_same_values(monkeypatch):
    lo, hi = _cells(3, seed=5)
    rng = np.random.default_rng(5)
    mu, sd, eps = _t64(rng.uniform(0.1, 1.0, (9, 2, 3))), _t64(rng.uniform(0.05, 0.3, (9, 2, 3))), \
        _t64(rng.standard_normal((32, 2, 3)))
    whole = tehvi.qehvi(mu, sd, _t64(lo), _t64(hi), eps)
    monkeypatch.setattr(tehvi, "_QEHVI_CHUNK_ELEMENTS", 1)  # one lane a chunk
    np.testing.assert_array_equal(tehvi.qehvi(mu, sd, _t64(lo), _t64(hi), eps).numpy(), whole.numpy())


def test_qehvi_sigma_zero_is_the_exact_joint_improvement():
    """sigma -> 0: every sample is the mean (up to the 1e-9 sigma floor),
    for any sample count, and the value is the hypervolume the q means add
    to the front."""
    P = np.array([[0.2, 0.9], [0.5, 0.6], [0.8, 0.3]])
    part = tbox.NondominatedPartitioning(np.zeros(2), P)
    mu = np.array([[0.6, 0.7], [0.9, 0.25]])
    exact = thv.hypervolume(np.vstack([P, mu]), np.zeros(2)) - thv.hypervolume(P, np.zeros(2))
    rng = np.random.default_rng(0)
    vals = [float(tehvi.qehvi(_t64(mu), torch.zeros(2, 2, dtype=torch.float64), _t64(part.cell_lower),
                              _t64(part.cell_upper), _t64(rng.standard_normal((S, 2, 2)))))
            for S in (16, 256)]
    assert vals[0] == pytest.approx(exact, abs=1e-8) and vals[1] == pytest.approx(exact, abs=1e-8)


def test_qehvi_mc_accuracy():
    """tests/test_mo.py's golden on the port: q=1 against the closed form,
    q=2 at the shipped sample count against a 2^18-sample golden."""
    Y = np.array([[0.2, 0.9], [0.5, 0.6], [0.8, 0.3]])
    lo, up = (torch.tensor(b, dtype=torch.float32)
              for b in tbox.NondominatedPartitioning(np.zeros(2), Y).get_hypercell_bounds())
    gen = torch.Generator().manual_seed(0)

    def eps(S, q):
        return torch.randn((S, q, 2), generator=gen)

    mu1, sd1 = torch.tensor([[0.6, 0.7]]), torch.tensor([[0.2, 0.15]])
    exact = float(tehvi.ehvi(mu1, sd1, lo, up)[0])
    est = float(tehvi.qehvi(mu1, sd1, lo, up, eps(1 << 15, 1)))
    assert abs(est - exact) / exact < 0.02, (est, exact)
    mu2, sd2 = torch.tensor([[0.6, 0.7], [0.9, 0.25]]), torch.tensor([[0.2, 0.15], [0.1, 0.2]])
    gold = float(tehvi.qehvi(mu2, sd2, lo, up, eps(1 << 18, 2)))
    errs = [abs(float(tehvi.qehvi(mu2, sd2, lo, up, eps(tehvi.QEHVI_N_SAMPLES, 2))) - gold) / gold
            for _ in range(8)]
    assert np.median(errs) < 0.06, errs
    sd0 = torch.full((2, 2), 1e-9)
    assert abs(float(tehvi.qehvi(mu2, sd0, lo, up, eps(16, 2)))
               - float(tehvi.qehvi(mu2, sd0, lo, up, eps(256, 2)))) < 1e-5


def test_qehvi_q1_close_to_ehvi_and_ehvi_matches_mc():
    P = np.array([[0.6, 0.3], [0.3, 0.6]])
    part = tbox.NondominatedPartitioning(np.zeros(2), P)
    lo, hi = _t64(part.cell_lower), _t64(part.cell_upper)
    mu, sd = _t64([[0.55, 0.55]]), _t64([[0.15, 0.2]])
    exact = float(tehvi.ehvi(mu, sd, lo, hi)[0])
    eps = torch.randn((4096, 1, 2), generator=torch.Generator().manual_seed(0), dtype=torch.float64)
    assert float(tehvi.qehvi(mu, sd, lo, hi, eps)) == pytest.approx(exact, rel=0.05)
    rng = np.random.default_rng(2)
    hv0 = thv.hypervolume(P, np.zeros(2))
    samples = mu.numpy() + sd.numpy() * rng.standard_normal((20000, 2))
    mc = np.mean([thv.hypervolume(np.vstack([P, s]), np.zeros(2)) - hv0 for s in samples])
    assert exact == pytest.approx(mc, rel=0.05)


# ------------------------------------------------------- the criterion
@pytest.fixture(scope="module")
def mo_fit():
    """A JAX 2-output GP on the bi-sphere (n = 40, d = 3), maximization-
    oriented normalized targets, its cells, and the port's GP carrying the
    same posterior."""
    rng = np.random.default_rng(11)
    X = rng.uniform(0, 1, (40, 3))
    F = np.c_[((X - 0.2) ** 2).sum(1), ((X - 0.8) ** 2).sum(1)]
    y = -(F - F.min(0)) / (F.max(0) - F.min(0))
    jgp = JGP(mean=j_const(3), corr="matern", thetaL=1e-3 * np.ones(3), thetaU=1e3 * np.ones(3),
              nugget=1e-6, random_start=10, random_state=0)
    jgp.fit(X, y)
    tgp = TGP(thetaL=1e-3 * np.ones(3), thetaU=1e3 * np.ones(3), device="cpu")
    tgp.load_fitted(jgp.theta_, {k: np.asarray(v) for k, v in jgp.posterior._asdict().items()},
                    jgp.config._asdict())
    part = jbox.NondominatedPartitioning(y.min(0) * 0.8 - 1e-6, y)
    return jgp, tgp, part.cell_lower.astype(np.float32), part.cell_upper.astype(np.float32)


def _crit_pair(jgp, state_t, config_t, name, pars_np, space_j, space_t):
    """(JAX criterion in float64, the port's in float64) on one posterior."""
    with jax.enable_x64():
        if isinstance(jgp.posterior, JRFState):
            state_j = jgp.posterior
        else:
            state_j = JState(**{k: _j64(v) for k, v in jgp.posterior._asdict().items()})
        crit_j = j_criterion(space_j.encoding(dtype=jnp.float64), state_j, jgp.config, name,
                             {k: v if k == "key" else _j64(v) for k, v in pars_np.items()})
    crit_t = t_criterion(space_t.encoding(dtype=torch.float64), state_t, config_t, name,
                         {k: _t64(v) for k, v in pars_np.items() if k != "key"})
    return crit_j, crit_t


def test_ehvi_criterion_matches_jax_float64(mo_fit):
    jgp, tgp, lo, hi = mo_fit
    space_j, space_t = jbo.RealSpace([[0.0, 1.0]] * 3), tbo.RealSpace([[0.0, 1.0]] * 3)
    post = tgp.posterior._replace(**{k: v.double() for k, v in tgp.posterior._asdict().items()})
    crit_j, crit_t = _crit_pair(jgp, post, tgp.config, "EHVI", {"cell_lower": lo, "cell_upper": hi},
                                space_j, space_t)
    U = np.random.default_rng(3).uniform(0, 1, (64, 3))
    with jax.enable_x64():
        vj = np.asarray(crit_j(_j64(U)))
        gj = np.asarray(jax.grad(lambda u: jnp.sum(crit_j(u)))(_j64(U)))
    Ut = _t64(U).requires_grad_(True)
    vt = crit_t(Ut)
    (gt,) = torch.autograd.grad(vt.sum(), Ut)
    assert np.all(vj > 0)
    assert np.abs(vt.detach().numpy() - vj).max() <= 1e-8 * np.abs(vj).max()
    assert np.abs(gt.numpy() - gj).max() <= 1e-8 * np.abs(gj).max()


@pytest.mark.parametrize("q", [2, 3])
def test_qehvi_criterion_matches_jax_float64(mo_fit, q):
    """The joint criterion on the q-replicated space: P candidates of q * 3
    coordinates, one predict of P * q rows, qEHVI per lane on JAX's
    samples."""
    jgp, tgp, lo, hi = mo_fit
    key = jax.random.PRNGKey(7)
    eps = _jax_eps(key, tehvi.QEHVI_N_SAMPLES, q, 2)
    space_j, space_t = jbo.RealSpace([[0.0, 1.0]] * 3) * q, tbo.RealSpace([[0.0, 1.0]] * 3) * q
    post = tgp.posterior._replace(**{k: v.double() for k, v in tgp.posterior._asdict().items()})
    crit_j, crit_t = _crit_pair(jgp, post, tgp.config, f"qEHVI{q}",
                                {"cell_lower": lo, "cell_upper": hi, "key": key, "eps": eps},
                                space_j, space_t)
    U = np.random.default_rng(4).uniform(0, 1, (12, 3 * q))
    with jax.enable_x64():
        vj = np.asarray(crit_j(_j64(U)))
    vt = crit_t(_t64(U)).numpy()
    assert np.sum(vj > 0) >= len(vj) // 2
    np.testing.assert_allclose(vt, vj, rtol=1e-8, atol=1e-8 * np.abs(vj).max())


@pytest.mark.parametrize("name", ["EHVI", "qEHVI2"])
def test_mo_criteria_over_a_carried_jax_forest(name):
    """The criterion over a random forest's multi-output mean and across-tree
    variance: JAX's forest carried into the port (rf_state_from_numpy), float32."""
    rng = np.random.default_rng(12)
    X = rng.uniform(0, 1, (40, 2))
    y = -np.c_[((X - 0.2) ** 2).sum(1), ((X - 0.8) ** 2).sum(1)]
    jrf = JRF(n_estimators=20, feature_space="embedding", random_state=0).fit(X, y)
    state, config = rf_state_from_numpy({k: np.asarray(v) for k, v in jrf.posterior._asdict().items()},
                                        jrf.config.max_depth, "cpu")
    part = jbox.NondominatedPartitioning(y.min(0) * 0.8 - 1e-6, y)
    q = 2 if name == "qEHVI2" else 1
    key = jax.random.PRNGKey(1)
    pars = {"cell_lower": part.cell_lower.astype(np.float32), "cell_upper": part.cell_upper.astype(np.float32),
            "key": key, "eps": _jax_eps(key, tehvi.QEHVI_N_SAMPLES, 2, 2, jnp.float32)}
    if q == 1:
        pars = {k: pars[k] for k in ("cell_lower", "cell_upper")}
    space_j, space_t = jbo.RealSpace([[0.0, 1.0]] * 2) * q, tbo.RealSpace([[0.0, 1.0]] * 2) * q
    crit_j = j_criterion(space_j.encoding(), jrf.posterior, jrf.config, name,
                         {k: v if k == "key" else jnp.asarray(v, jnp.float32) for k, v in pars.items()})
    crit_t = t_criterion(space_t.encoding(), state, config, name,
                         {k: torch.tensor(np.asarray(v), dtype=torch.float32)
                          for k, v in pars.items() if k != "key"})
    U = rng.uniform(0, 1, (32, 2 * q)).astype(np.float32)
    vj = np.asarray(crit_j(jnp.asarray(U)))
    vt = crit_t(torch.tensor(U)).numpy()
    assert np.any(vj > 0)
    np.testing.assert_allclose(vt, vj, rtol=1e-4, atol=1e-6 * np.abs(vj).max())


def test_bfgs_ehvi_argmax_past_the_first_lanes_convergence(mo_fit, monkeypatch):
    """The L-BFGS engine evaluates only its live lanes: the hypercells must
    reach every lane unchanged after lanes drop out. The port's argmax from
    8 starts, in float64, against JAX's from the same starts; the
    criterion's row counts show lanes leaving at different trips."""
    jgp, tgp, lo, hi = mo_fit
    x0 = np.random.default_rng(5).uniform(0, 1, (8, 3))
    pars = {"cell_lower": lo, "cell_upper": hi}
    with jax.enable_x64():
        state = JState(**{k: _j64(v) for k, v in jgp.posterior._asdict().items()})
        u_j, v_j = JArgmax(jbo.RealSpace([[0.0, 1.0]] * 3).encoding(dtype=jnp.float64), method="BFGS",
                           n_restart=8, seed=0)(state, jgp.config, "EHVI",
                                                {k: _j64(v) for k, v in pars.items()}, x0_seed=x0)
    rows = []
    make = targmax.make_unit_criterion

    def counting(*a, **k):
        crit = make(*a, **k)
        return lambda U, idx=None: rows.append(U.shape[0]) or crit(U, idx)

    monkeypatch.setattr(targmax, "make_unit_criterion", counting)
    post = tgp.posterior._replace(**{k: v.double() for k, v in tgp.posterior._asdict().items()})
    enc = tbo.RealSpace([[0.0, 1.0]] * 3).encoding(dtype=torch.float64)
    u_t, v_t = TArgmax(enc, method="BFGS", n_restart=8, seed=0, device="cpu")(
        post, tgp.config, "EHVI", pars, x0_seed=x0)
    assert rows[0] == 8 and 0 < min(rows) < 8, rows
    assert abs(v_t - float(v_j)) <= 1e-6 * abs(float(v_j)), (v_t, float(v_j))
    np.testing.assert_allclose(u_t, np.asarray(u_j), rtol=0, atol=1e-3)
    # the winner improves on its best start, on the criterion itself
    crit = make(enc, post, tgp.config, "EHVI", {k: _t64(v) for k, v in pars.items()})
    assert v_t >= float(crit(_t64(x0)).max())
    assert float(crit(_t64(u_t[None]))[0]) == pytest.approx(v_t, rel=1e-9)


@pytest.mark.parametrize("method", ["OnePlusOne_Cholesky_CMA", "SMC", "MIES"])
def test_derivative_free_engines_maximize_ehvi(mo_fit, method):
    """CMA, SMC and MIES reach EHVI's value at the BFGS winner within 2%,
    over the GP; BFGS refuses a forest's EHVI, as for any criterion."""
    _, tgp, lo, hi = mo_fit
    enc = tbo.RealSpace([[0.0, 1.0]] * 3).encoding()
    pars = {"cell_lower": lo, "cell_upper": hi}
    _, v_bfgs = TArgmax(enc, method="BFGS", seed=0, device="cpu")(tgp.posterior, tgp.config, "EHVI", pars)
    u, v = TArgmax(enc, method=method, seed=0, device="cpu")(tgp.posterior, tgp.config, "EHVI", pars)
    assert u.shape == (3,) and v >= 0.98 * v_bfgs, (v, v_bfgs)


def test_batch_shares_the_cells_and_refuses_differing_ones(mo_fit):
    _, tgp, lo, hi = mo_fit
    am = TArgmax(tbo.RealSpace([[0.0, 1.0]] * 3).encoding(), method="BFGS", n_restart=4, seed=0,
                 device="cpu")
    x0 = np.random.default_rng(6).uniform(0, 1, (4, 3))
    pars = {"cell_lower": lo, "cell_upper": hi}
    us, vs = am.batch(tgp.posterior, tgp.config, "EHVI", [pars, pars], x0_seed=x0)
    _, v1 = am(tgp.posterior, tgp.config, "EHVI", pars, x0_seed=x0)
    assert all(abs(v - v1) <= 1e-5 * v1 for v in vs)
    with pytest.raises(ValueError):
        am.batch(tgp.posterior, tgp.config, "EHVI", [pars, {"cell_lower": lo * 0.5, "cell_upper": hi}])

"""The acquisition argmax's graphed L-BFGS loop on the CPU.

A CUDA graph needs a card, so these tests hold the parts it replays: the
update's twin with an index entry of -1 (a lane that is not live in a trip
at the full width of the lanes), the full-width masked trip itself
(`ops.optimize._masked_trip`) run eagerly against the live-lane loop
(`_lbfgs_batched`) on the argmax's EI criterion in float64, the same trip
against the JAX package's fixed-shape loop (`_lbfgs_compact`), and which
criteria `make_unit_criterion` marks capturable. The graph itself is held
to the eager loop on the card (tests/test_torch_cuda_kernels.py).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_optimization_tpu.ops import optimize as j_optimize

from bayesian_optimization_tpu_torch import RealSpace
from bayesian_optimization_tpu_torch.models.likelihood import GPConfig, posterior_state
from bayesian_optimization_tpu_torch.models.random_forest import RFConfig
from bayesian_optimization_tpu_torch.ops import optimize
from bayesian_optimization_tpu_torch.ops.optimize import (
    _Z_CLIP, _lbfgs_batched, _masked_trip, from_box, lbfgs_state, lbfgs_update_plain, to_box,
)
from bayesian_optimization_tpu_torch.optim.argmax import make_unit_criterion
from bayesian_optimization_tpu_torch.optim.constraints import ConstraintProgram
from bayesian_optimization_tpu_torch.space import DiscreteSpace

FIELDS = ("z", "f", "g", "S", "Y", "rho", "k", "gamma", "p", "gTp", "t", "n_probe", "n_accept", "done")


def _quadratic_state(R, d, m, trips, dtype, seed):
    """A state after `trips` live-lane trips on a random convex quadratic,
    its histories part full, and the next trip's trial points, values and
    gradients for every lane."""
    gen = torch.Generator().manual_seed(seed)
    A = torch.randn(d, d, generator=gen, dtype=torch.float64)
    A = (A @ A.T / d + 0.5 * torch.eye(d, dtype=torch.float64)).to(dtype)
    b = torch.randn(d, generator=gen, dtype=torch.float64).to(dtype)

    def fun(z):
        return 0.5 * ((z @ A) * z).sum(-1) - z @ b

    st = lbfgs_state(torch.randn(R, d, generator=gen, dtype=torch.float64).to(dtype), m)
    for _ in range(trips):
        idx = ((st.done == 0) & (st.n_accept < 50)).nonzero()[:, 0]
        z_trial = (st.z + st.t[:, None] * st.p).clamp(-_Z_CLIP, _Z_CLIP)
        zz = z_trial[idx].requires_grad_(True)
        f = fun(zz)
        (g,) = torch.autograd.grad(f.sum(), zz)
        lbfgs_update_plain(st, idx, f.detach(), g, z_trial, 20)
    z_trial = (st.z + st.t[:, None] * st.p).clamp(-_Z_CLIP, _Z_CLIP)
    zz = z_trial.clone().requires_grad_(True)
    f = fun(zz)
    (g,) = torch.autograd.grad(f.sum(), zz)
    return st, f.detach(), g, z_trial


def _fields(st):
    return {n: getattr(st, n).clone() for n in FIELDS}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("dropped", [(0,), (7,), (2, 3, 6), (0, 7), tuple(range(8))],
                         ids=["first", "last", "middle", "ends", "all"])
def test_twin_leaves_a_minus_one_lane_alone(dtype, dropped):
    """The twin on a full-width index whose entries `dropped` are -1: those
    lanes' state is left as it was, bit for bit, and every other lane ends
    exactly where the twin's live-lane call (the -1 entries left out) puts
    it."""
    R, d, m = 8, 5, 4
    st, f, g, z_trial = _quadratic_state(R, d, m, 7, dtype, seed=3)
    masked, live = lbfgs_state(st.z, m), lbfgs_state(st.z, m)
    for s in (masked, live):
        s.ws.copy_(st.ws)
        s.iws.copy_(st.iws)
    before = _fields(st)
    lanes = torch.arange(R)
    keep = torch.tensor([r not in dropped for r in range(R)])
    lbfgs_update_plain(masked, torch.where(keep, lanes, -1), f, g, z_trial, 20)
    lbfgs_update_plain(live, lanes[keep], f[keep], g[keep], z_trial, 20)
    after_m, after_l = _fields(masked), _fields(live)
    for name in FIELDS:
        assert torch.equal(after_m[name][~keep], before[name][~keep]), name
        assert torch.equal(after_m[name], after_l[name]), name
    if len(dropped) < R:  # the trip moved the others
        assert not torch.equal(after_m["n_accept"] + after_m["n_probe"],
                               before["n_accept"] + before["n_probe"])


def _ei_criterion(d, n, seed, dtype=torch.float64):
    """The argmax's EI criterion (a maximisation) on a GP posterior
    at n points of log-Rosenbrock data in [0, 1]^d (BBOB F8's shape), laid
    out at the next 128-multiple of n as a fit lays its rows out; EI below
    the data's 10% quantile, so that it is far from 0 over much of the
    cube."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(0.0, 1.0, (n, d))
    x = 8.0 * X - 4.0
    y = np.log1p((100.0 * (x[:, :-1] ** 2 - x[:, 1:]) ** 2 + (x[:, :-1] - 1.0) ** 2).sum(1))
    y = (y - y.mean()) / y.std()
    n_pad = 128 * math.ceil(n / 128)
    Xp, Yp = np.zeros((n_pad, d)), np.zeros((n_pad, 1))
    Xp[:n], Yp[:n, 0] = X, y
    mask = (np.arange(n_pad) < n).astype(float)
    par = np.concatenate([rng.uniform(-0.5, 0.5, d) - 0.5 * math.log10(d / 5.0), [0.0]])

    def t(a):
        return torch.tensor(a, dtype=dtype)

    config = GPConfig()
    state = posterior_state(t(par), t(Xp), t(Yp), t(mask[:, None]), t(mask), n, 1e-6,
                            t(np.zeros((1, 1))), config)
    enc = RealSpace([[0.0, 1.0]] * d).encoding(dtype=dtype)
    return make_unit_criterion(enc, state, config, "EI", {"plugin": t(np.quantile(y, 0.1))})


def _both_loops(d, R, full_width: bool, monkeypatch):
    """The argmax's run (40 iterations, history 10) of the EI criterion at
    d from R seeded starts, by `_lbfgs_batched` and by `_masked_trip` run
    eagerly until its live count reads 0: (the live-lane loop's state,
    trips and objective widths, then the masked trip's). With full_width
    both evaluate the criterion on all R rows, the live-lane loop keeping
    its live ones."""
    crit = _ei_criterion(d, 300, seed=d)
    lo, hi = torch.zeros(d, dtype=torch.float64), torch.ones(d, dtype=torch.float64)
    lanes = torch.arange(R)
    widths = []

    def zfun(z, idx):
        widths.append(idx.numel())
        if full_width and idx.numel() < R:
            full = torch.zeros((R, d), dtype=z.dtype).index_put((idx,), z)
            return -crit(to_box(full, lo, hi), lanes)[idx]
        return -crit(to_box(z, lo, hi), idx)

    z0 = from_box(torch.rand((R, d), generator=torch.Generator().manual_seed(d),
                             dtype=torch.float64), lo, hi)
    states = []
    make = optimize.lbfgs_state
    monkeypatch.setattr(optimize, "lbfgs_state", lambda *a: states.append(make(*a)) or states[-1])
    _lbfgs_batched(zfun, z0, 40, 10, 20)
    live = (states[0], len(widths), set(widths))
    widths.clear()
    st = make(z0, 10)
    trips = 0
    while True:
        trips += 1
        if int(_masked_trip(zfun, st, lanes, 40, 20)) == 0:
            break
    return live, (st, trips, set(widths))


@pytest.mark.parametrize("d, R", [(5, 25), (20, 100)])
def test_masked_trip_makes_the_live_lane_loops_decisions(d, R, monkeypatch):
    """The full-width masked trip, run eagerly trip after trip, against
    `_lbfgs_batched`'s live-lane loop on the argmax's EI criterion (d = 5
    with 25 lanes and d = 20 with 100, n = 300, float64): the same trips,
    the same concluded steps and done flags in every lane, and the same
    points and values within 1e-12. Both evaluate the criterion at the
    full width (the live-lane loop keeps its live rows): on the CPU a sum
    over the posterior's rows rounds by the number of columns beside it
    (predict's (rt * rt).sum(-2), 4.4e-16 at d = 20), and a lane near its
    stall decides on such a difference (the next test)."""
    (st_l, trips_l, widths_l), (st_m, trips_m, widths_m) = _both_loops(d, R, True, monkeypatch)
    assert widths_m == {R} and len(widths_l) > 1  # the live-lane loop narrowed
    assert trips_m == trips_l > 40
    assert torch.equal(st_m.n_accept, st_l.n_accept) and bool((st_m.n_accept > 1).all())
    assert torch.equal(st_m.done, st_l.done)
    assert float((st_m.z - st_l.z).abs().max()) <= 1e-12
    assert float((st_m.f - st_l.f).abs().max()) <= 1e-12


@pytest.mark.parametrize("d, R", [(5, 25), (20, 100)])
def test_masked_trip_finds_the_live_lane_loops_winner(d, R, monkeypatch):
    """Each loop evaluating the criterion at its own width (the argmax's
    eager and graphed runs as they are): the same best value within 1e-12
    (relative). Lanes near their stalls may decide otherwise, since the
    CPU's sums round by the width (the test above)."""
    (st_l, _, _), (st_m, _, widths_m) = _both_loops(d, R, False, monkeypatch)
    assert widths_m == {R}
    best_l, best_m = float(st_l.f.min()), float(st_m.f.min())
    assert abs(best_m - best_l) <= 1e-12 * abs(best_l) and best_l < -1e-3


def _jax_loop(zfun, z0, max_iter, m, max_ls):
    """The JAX package's `_lbfgs_compact` over the rows of z0, vmapped as its
    `minimize_restarts` runs it, on the objective zfun(z (R, d), lanes) of
    the port (a host callback, handed every lane each trip, as the vmapped
    loop evaluates them): each lane's final z and f, its concluded steps
    and done flag (the loop's final state) and its trips (the loop body's
    passes that lane took part in)."""
    R, d = z0.shape
    lanes = torch.arange(R)

    def value_and_grad(z):
        zz = torch.tensor(np.asarray(z)).reshape(R, d).requires_grad_(True)
        f = zfun(zz, lanes)
        (g,) = torch.autograd.grad(f.sum(), zz)
        return f.detach().numpy(), g.numpy()

    def call(z):
        shapes = (jax.ShapeDtypeStruct(z.shape[:-1], z.dtype), jax.ShapeDtypeStruct(z.shape, z.dtype))
        return jax.pure_callback(value_and_grad, shapes, z, vmap_method="broadcast_all")

    @jax.custom_vjp
    def objective(z):
        return call(z)[0]

    objective.defvjp(call, lambda g, ct: (ct * g,))
    seen, while_loop = {}, jax.lax.while_loop

    def counted(cond, body, init):
        out, trips = while_loop(lambda c: cond(c[0]), lambda c: (body(c[0]), c[1] + 1), (init, 0))
        seen.update(st=out, trips=trips)
        return out

    def one(z):
        jax.lax.while_loop = counted
        try:
            z_end, f_end = j_optimize._lbfgs_compact(objective, z, max_iter, m, max_ls)
        finally:
            jax.lax.while_loop = while_loop
        return z_end, f_end, seen["st"].n_accept, seen["st"].done, seen["trips"]

    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)  # the callback's thread reads it too
    try:
        out = jax.jit(jax.vmap(one))(jnp.asarray(z0.numpy()))
        return [np.asarray(v) for v in out]
    finally:
        jax.config.update("jax_enable_x64", x64)


def _three_loops(d, R, dtype, monkeypatch):
    """The argmax's run (40 iterations, history 10, 20 halvings) of the EI
    criterion at d and n = 300 from R seeded starts, in dtype, by the masked
    trip run eagerly trip after trip, by the JAX package's loop (reading
    the same criterion, `_jax_loop`) and by `_lbfgs_batched`, which
    evaluates the live lanes only: for each, (its state or the JAX loop's
    (z, f, n_accept, done), its trips)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # the CPU's sums round by their split over threads
    try:
        crit = _ei_criterion(d, 300, seed=d, dtype=dtype)
        lo, hi = torch.zeros(d, dtype=dtype), torch.ones(d, dtype=dtype)

        def zfun(z, idx):
            return -crit(to_box(z, lo, hi), idx)

        z0 = from_box(torch.rand((R, d), generator=torch.Generator().manual_seed(d),
                                 dtype=torch.float64).to(dtype), lo, hi)
        st, lanes = lbfgs_state(z0, 10), torch.arange(R)
        trips = 0
        while True:
            trips += 1
            if int(_masked_trip(zfun, st, lanes, 40, 20)) == 0:
                break
        z_j, f_j, n_accept_j, done_j, trips_j = _jax_loop(zfun, z0, 40, 10, 20)
        states, calls = [], []
        make = optimize.lbfgs_state
        monkeypatch.setattr(optimize, "lbfgs_state", lambda *a: states.append(make(*a)) or states[-1])
        _lbfgs_batched(lambda z, idx: calls.append(1) or zfun(z, idx), z0, 40, 10, 20)
    finally:
        torch.set_num_threads(threads)
    return ((st, trips), ((z_j, f_j, n_accept_j, done_j.astype(np.int64)), int(trips_j.max())),
            (states[0], len(calls)))


def _capped_and_stalled(n_accept, done):
    n_accept, done = np.asarray(n_accept), np.asarray(done)
    return int((n_accept == 41).sum()), int(done.sum())


@pytest.mark.parametrize("d, R", [(5, 25), (20, 100)])
def test_masked_trip_against_the_jax_loop(d, R, monkeypatch):
    """Float64: the masked trip against the JAX package's fixed-shape loop
    from the same starts, both reading the same objective, the port's EI
    criterion at every lane (a callback on the JAX side), so that the
    loops differ only in their own arithmetic. Every lane ends at the same
    value within 1e-12 (relative) and the same point within 1e-6, and the
    two loops run as many lanes to the 40-iteration cap within 15% of the
    lanes (when written, over 3 posteriors and 2 thread counts: 21-24 of
    25 against 20-25, 78-87 of 100 against 78-88). Lane by lane the
    decisions are not the same to the end (68-84% of the lanes end with
    the same concluded steps and done flag): the packages' L-BFGS
    arithmetic rounds apart (sums, fused multiply-adds), and whether a
    converged lane's trial reads its value to the bit (its step then
    concludes as improving, and it replays to the cap) or a bit above it
    (the stall exit) turns on the last bit."""
    (st, _), ((z_j, f_j, n_accept_j, done_j), _), _ = _three_loops(d, R, torch.float64, monkeypatch)
    f = st.f.numpy()
    assert np.abs(f - f_j).max() <= 1e-12 * np.abs(f).max() and f.min() < -1e-3
    assert np.abs(st.z.numpy() - z_j).max() <= 1e-6
    capped = _capped_and_stalled(st.n_accept, st.done)[0]
    assert abs(capped - _capped_and_stalled(n_accept_j, done_j)[0]) <= 0.15 * R


@pytest.mark.parametrize("d, R", [(5, 25), (20, 100)])
def test_converged_lanes_replay_to_the_cap_as_in_the_jax_loop(d, R, monkeypatch):
    """Float32, the argmax's precision, the three loops on the same
    criterion: the JAX package's fixed-shape loop and the masked trip run
    nearly every lane to the 40-iteration cap (at least 90%) and stall at
    most 10% of them, since a converged lane's trial reads its value to
    the bit at a width that does not change; the live-lane loop, whose
    width changes from trip to trip and with it the criterion's rounding,
    stalls more lanes than the masked trip (in all 18 posteriors and
    thread counts tried when written: 2-24 lanes against 0-9). The trips,
    the most that any one lane takes, are not compared: a single lane that
    replays to the cap sets them in each loop."""
    (st, _), ((_, _, n_accept_j, done_j), _), (st_l, _) = _three_loops(d, R, torch.float32,
                                                                     monkeypatch)
    capped, stalled = _capped_and_stalled(st.n_accept, st.done)
    capped_j, stalled_j = _capped_and_stalled(n_accept_j, done_j)
    _, stalled_l = _capped_and_stalled(st_l.n_accept, st_l.done)
    assert min(capped, capped_j) >= 0.9 * R and max(stalled, stalled_j) <= 0.1 * R
    assert stalled_l > stalled


def _cap(enc, config, acq="EI", params=None, **kw):
    crit = make_unit_criterion(enc, None, config, acq, {"plugin": 0.0} if params is None else params,
                               **kw)
    return getattr(crit, "capturable", False)


def test_make_unit_criterion_marks_the_capturable_criteria():
    """Capturable exactly: the point GP posterior's criterion under a named
    scalar acquisition (EI, PI, EpsilonPI, UCB, MGFI, GEI<g>), with or
    without PCA-BO's box penalty, on an all-real space with a named kernel
    and a constant or linear trend. Not: a ConstraintProgram, a random
    forest's posterior, a NonparametricTrend's forest, an ensemble, EHVI,
    qEHVI, a kernel tuple, the quadratic trend, a space with a discrete
    variable."""
    enc = RealSpace([[0.0, 1.0]] * 3).encoding()
    gp = GPConfig()
    for acq in ("EI", "PI", "EpsilonPI", "UCB", "MGFI", "GEI", "GEI3"):
        assert _cap(enc, gp, acq), acq
    for kernel in ("matern", "matern52", "squared_exponential", "absolute_exponential", "cubic"):
        assert _cap(enc, gp._replace(kernel=kernel)), kernel
    assert _cap(enc, gp._replace(trend="linear"))
    pca = {"plugin": 0.0, "_pca_C": torch.eye(3), "_pca_offset": torch.zeros(3),
           "_box_lo": torch.zeros(3), "_box_hi": torch.ones(3), "_red_lo": torch.zeros(3),
           "_red_hi": torch.ones(3)}
    assert _cap(enc, gp, "EI", pca)
    assert _cap(enc, gp, "EI", minimize=False)
    assert _cap(enc, gp, "EI", fixed_mask=torch.tensor([1.0, 0.0, 0.0]),
                fixed_vals=torch.tensor([0.5, 0.0, 0.0]))

    cons = ConstraintProgram(enc, g=lambda x: float(x[0]) - 0.5, device="cpu")
    assert not _cap(enc, gp, constraints=cons)
    assert not _cap(enc, RFConfig(max_depth=4))
    assert not _cap(enc, gp, "EI", {"plugin": 0.0, "_prior_state": object(), "_prior_depth": 3})
    assert not _cap(enc, gp._replace(n_ensemble=4))
    assert not _cap(enc, gp, "EHVI", {"cell_lower": torch.zeros(1, 2), "cell_upper": torch.ones(1, 2)})
    assert not _cap(enc, gp, "qEHVI2", {"cell_lower": torch.zeros(1, 2),
                                        "cell_upper": torch.ones(1, 2), "eps": torch.zeros(4, 2, 2)})
    assert not _cap(enc, gp._replace(kernel=("matern", 2.5)))
    assert not _cap(enc, gp._replace(trend="quadratic"))
    mixed = (RealSpace([[0.0, 1.0]] * 2) + DiscreteSpace(["a", "b", "c"])).encoding()
    assert not _cap(mixed, gp)

"""One trip's update of the batched L-BFGS (`ops.optimize.lbfgs_update_plain`,
the twin of the CUDA kernel `hopper_kernels.lbfgs_update_fused`) against the full-mask form
it replaces: the same arithmetic over every lane, each field rebuilt with
`torch.where` on the lanes whose step concluded. Applied to the live lanes
only, the twin has to leave the state exactly as that form does, on random
float64 states that probe, hit the line search's cap, stall, reject a
curvature pair, wrap the history, see non-finite gradients and trial
points, and leave lanes out; and whole runs of `minimize_restarts` have to
end where a loop of the full-mask form ends."""
import math

import pytest
import torch

from bayesian_optimization_tpu_torch.ops import hopper_kernels as hk
from bayesian_optimization_tpu_torch.ops import optimize
from bayesian_optimization_tpu_torch.ops.optimize import (
    _Z_CLIP, _direction, from_box, lbfgs_state, lbfgs_update_plain, minimize_restarts, to_box,
)

FIELDS = ("z", "f", "g", "S", "Y", "rho", "k", "gamma", "p", "gTp", "t", "n_probe", "n_accept", "done")
SCENARIOS = ("armijo", "probe", "cap_good", "cap_stall", "nan_f", "neg_curv", "nonfinite_g", "nan_z")


def _full_mask_update(s: dict, active, f_a, g_a, z_trial, max_ls: int, c1: float = 1e-4) -> dict:
    """The update as the loop body wrote it over all R lanes: scatter the
    live lanes' values and gradients, test and rebuild every field with a
    mask. Returns the new fields."""
    z, f, g, S, Y, rho, k, gamma, p, gTp, t, n_probe, n_accept, done = (s[n] for n in FIELDS)
    R, m, d = S.shape
    dt, dev = z.dtype, z.device
    lanes = torch.arange(R, device=dev)
    idx = active.nonzero()[:, 0]
    f_t = torch.full((R,), float("inf"), dtype=dt, device=dev)
    g_t = torch.zeros((R, d), dtype=dt, device=dev)
    f_t[idx] = f_a
    g_t[idx] = torch.where(torch.isfinite(g_a), g_a, torch.zeros_like(g_a))
    armijo = f_t <= f + c1 * t * gTp
    stop = armijo | (n_probe >= max_ls)
    good = torch.isfinite(f_t) & (f_t <= f) & torch.isfinite(z_trial).all(-1)
    z_new = torch.where(good[:, None], z_trial, z)
    f_new = torch.where(good, f_t, f)
    g_new = torch.where(good[:, None], g_t, g)
    s_ = z_new - z
    y = g_new - g
    sy = (s_ * y).sum(-1)
    curv_ok = good & (sy > 1e-10 * s_.norm(dim=-1) * y.norm(dim=-1) + 1e-30)
    slot = torch.remainder(k, m)
    S_new, Y_new, rho_new = S.clone(), Y.clone(), rho.clone()
    S_new[lanes, slot] = torch.where(curv_ok[:, None], s_, S[lanes, slot])
    Y_new[lanes, slot] = torch.where(curv_ok[:, None], y, Y[lanes, slot])
    rho_new[lanes, slot] = torch.where(curv_ok, 1.0 / sy.clamp_min(1e-30), rho[lanes, slot])
    k_new = k + curv_ok.long()
    gamma_new = torch.where(curv_ok, sy / (y * y).sum(-1).clamp_min(1e-30), gamma)
    p_new = _direction(g_new, S_new, Y_new, rho_new, k_new, gamma_new, m)
    acc = active & stop
    probe = active & ~stop
    a1, a2 = acc[:, None], acc[:, None, None]
    return {
        "z": torch.where(a1, z_new, z), "f": torch.where(acc, f_new, f),
        "g": torch.where(a1, g_new, g), "S": torch.where(a2, S_new, S),
        "Y": torch.where(a2, Y_new, Y), "rho": torch.where(a1, rho_new, rho),
        "k": torch.where(acc, k_new, k), "gamma": torch.where(acc, gamma_new, gamma),
        "p": torch.where(a1, p_new, p), "gTp": torch.where(acc, (g_new * p_new).sum(-1), gTp),
        "t": torch.where(acc, torch.ones_like(t), torch.where(probe, 0.5 * t, t)),
        "n_probe": torch.where(acc, torch.zeros_like(n_probe), n_probe + probe.long()),
        "n_accept": n_accept + acc.long(),
        "done": torch.where(acc, (~good).long(), done),
    }


def random_trip(R, d, m, seed, max_ls=20, live=0.75, dtype=torch.float64, device="cpu"):
    """(state, idx, f_a, g_a, z_trial, scenario of each lane): a state part
    way through a run, with histories of random depth (k up to 3 m, so
    slots wrap) and a trip whose outcome each lane's scenario (SCENARIOS, in
    turn) sets; about `live` of the lanes are live. The state is made in
    `dtype` on `device`, the trip from it."""
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64)

    def uni(*shape):
        return torch.rand(*shape, generator=gen, dtype=torch.float64)

    st = lbfgs_state(rnd(R, d).clamp(-3, 3).to(dtype=dtype, device=device), m)
    k = torch.randint(0, 3 * m + 1, (R,), generator=gen)
    S = rnd(R, m, d)
    Y = S * (0.5 + 1.5 * uni(R, m, 1)) + 0.1 * rnd(R, m, d)
    stored = torch.arange(m)[None, :] < k[:, None]  # slots never written stay 0
    S, Y = S * stored[..., None], Y * stored[..., None]
    rho = torch.where(stored, 1.0 / (S * Y).sum(-1).clamp_min(1e-3), torch.zeros(()))
    g = rnd(R, d)
    p = -g * (0.2 + uni(R, 1))
    t = 0.5 ** torch.randint(0, 5, (R,), generator=gen).double()
    n_probe = torch.randint(0, max_ls, (R,), generator=gen)
    scen = [SCENARIOS[i % len(SCENARIOS)] for i in range(R)]
    for r, sc in enumerate(scen):
        if sc in ("cap_good", "cap_stall"):
            n_probe[r] = max_ls
    for name, v in (("k", k), ("S", S), ("Y", Y), ("rho", rho), ("g", g), ("p", p),
                    ("gTp", (g * p).sum(-1)), ("f", 10.0 * rnd(R)), ("gamma", 0.5 + uni(R)),
                    ("t", t), ("n_probe", n_probe),
                    ("n_accept", torch.randint(1, 30, (R,), generator=gen))):
        getattr(st, name).copy_(v)
    z_trial = (st.z + st.t[:, None] * st.p).clamp(-_Z_CLIP, _Z_CLIP)
    f_t = st.f.clone()
    g_t = rnd(R, d).to(dtype=dtype, device=device)
    for r, sc in enumerate(scen):
        dec = st.t[r] * st.gTp[r]  # < 0
        step = z_trial[r] - st.z[r]
        if sc in ("armijo", "neg_curv", "nonfinite_g", "nan_z"):
            f_t[r] = st.f[r] + 0.5 * dec
        elif sc in ("probe", "cap_stall"):
            f_t[r] = st.f[r] + 1.0 + float(uni(()))
        elif sc == "cap_good":  # too little decrease for Armijo, but no worse
            f_t[r] = st.f[r] + 0.5e-4 * dec
        else:
            f_t[r] = math.nan
        if sc in ("armijo", "cap_good", "nonfinite_g"):  # positive curvature
            g_t[r] = st.g[r] + (0.5 + float(uni(()))) * step
        elif sc == "neg_curv":
            g_t[r] = st.g[r] - step
        if sc == "nonfinite_g":
            g_t[r, 0] = math.inf
            g_t[r, -1] = math.nan
        if sc == "nan_z":
            z_trial[r, d // 2] = math.nan
    idx = torch.sort(torch.randperm(R, generator=gen)[: max(1, round(live * R))]).values
    idx = idx.to(device)
    return st, idx, f_t[idx], g_t[idx], z_trial, scen


def _fields(st) -> dict:
    return {n: getattr(st, n).clone() for n in FIELDS}


@pytest.mark.parametrize("R, d, m", [(25, 5, 10), (2, 6, 10), (10, 6, 10), (40, 5, 10),
                                     (25, 40, 10), (9, 70, 4), (16, 3, 1)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_twin_on_the_live_lanes_equals_the_full_mask_form(R, d, m, seed):
    st, idx, f_a, g_a, z_trial, scen = random_trip(R, d, m, seed)
    before = _fields(st)
    active = torch.zeros(R, dtype=torch.bool)
    active[idx] = True
    want = _full_mask_update(before, active, f_a, g_a, z_trial, max_ls=20)
    lbfgs_update_plain(st, idx, f_a, g_a, z_trial, 20)
    for name in FIELDS:
        got = getattr(st, name)
        assert torch.equal(torch.nan_to_num(got, nan=7.0), torch.nan_to_num(want[name], nan=7.0)), name
    # lanes that were not live are untouched
    out = ~active
    for name in FIELDS:
        assert torch.equal(getattr(st, name)[out], before[name][out]), name
    # the trip covered what it was built to cover
    acc = st.n_accept != before["n_accept"]
    probed = active & ~acc
    assert bool((st.t[probed] == 0.5 * before["t"][probed]).all())
    assert bool((st.n_probe[probed] == before["n_probe"][probed] + 1).all())
    live_scen = {scen[r] for r in idx.tolist()}
    if "probe" in live_scen:
        assert bool(probed.any())
    for r in idx.tolist():
        if scen[r] in ("cap_stall", "nan_z") or (scen[r] == "nan_f" and before["n_probe"][r] >= 20):
            assert acc[r] and st.done[r] == 1 and torch.equal(st.z[r], before["z"][r])
        if scen[r] in ("armijo", "cap_good", "nonfinite_g"):
            assert acc[r] and st.done[r] == 0 and st.k[r] == before["k"][r] + 1
            assert st.t[r] == 1.0 and st.n_probe[r] == 0
            assert bool(torch.isfinite(st.g[r]).all())
        if scen[r] == "neg_curv":  # accepted, but the pair is not stored
            assert acc[r] and st.done[r] == 0 and st.k[r] == before["k"][r]
            assert torch.equal(st.S[r], before["S"][r])


def test_the_trips_cover_every_case():
    """Over the seeds of the test above, every scenario occurs on a live lane
    with a history that has wrapped (k > m)."""
    seen = set()
    for seed in range(3):
        st, idx, *_, scen = random_trip(25, 5, 10, seed)
        seen |= {scen[r] for r in idx.tolist() if st.k[r] > 10}
    assert seen == set(SCENARIOS)


def test_twin_from_a_fresh_state_takes_the_starts():
    """The first trip: f = +inf and p = 0 accept the starts themselves, store
    no pair (s = 0) and take the steepest descent."""
    R, d, m = 6, 4, 5
    z0 = torch.randn(R, d, dtype=torch.float64)
    st = lbfgs_state(z0, m)
    idx = torch.arange(R)
    f_a = torch.randn(R, dtype=torch.float64)
    g_a = torch.randn(R, d, dtype=torch.float64)
    want = _full_mask_update(_fields(st), torch.ones(R, dtype=torch.bool), f_a, g_a, z0.clone(), 20)
    lbfgs_update_plain(st, idx, f_a, g_a, z0.clone(), 20)
    for name in FIELDS:
        assert torch.equal(getattr(st, name), want[name]), name
    assert torch.equal(st.p, -g_a) and torch.equal(st.f, f_a) and bool((st.k == 0).all())
    assert bool((st.n_accept == 1).all()) and bool((st.done == 0).all())


def test_the_state_is_two_workspaces():
    st = lbfgs_state(torch.zeros(7, 3, dtype=torch.float32), 4)
    assert st.ws.numel() == 7 * (3 * 3 + 2 * 4 * 3 + 2 * 4 + 4) and st.iws.numel() == 4 * 7
    base = st.ws.untyped_storage().data_ptr()
    for name in ("z", "g", "p", "S", "Y", "rho", "alpha", "f", "gamma", "gTp", "t"):
        v = getattr(st, name)
        assert v.is_contiguous() and v.untyped_storage().data_ptr() == base
    for name in ("k", "n_probe", "n_accept", "done"):
        assert getattr(st, name).untyped_storage().data_ptr() == st.iws.untyped_storage().data_ptr()
    assert bool(torch.isinf(st.f).all()) and bool((st.t == 1).all()) and bool((st.gamma == 1).all())


def _full_mask_minimize(fun, x0, lo, hi, max_iter, m, max_ls):
    """`minimize_restarts`'s loop with the full-mask update, as the port ran it."""
    lo = torch.as_tensor(lo, dtype=x0.dtype)
    hi = torch.as_tensor(hi, dtype=x0.dtype)
    z0 = from_box(x0, lo, hi)
    R, d = z0.shape
    s = _fields(lbfgs_state(z0, m))
    while True:
        active = (s["done"] == 0) & (s["n_accept"] < max_iter + 1)
        idx = active.nonzero()[:, 0]
        if idx.numel() == 0:
            break
        z_trial = (s["z"] + s["t"][:, None] * s["p"]).clamp(-_Z_CLIP, _Z_CLIP)
        zz = z_trial[idx].detach().requires_grad_(True)
        with torch.enable_grad():
            f = fun(to_box(zz, lo, hi))
            (g,) = torch.autograd.grad(f.sum(), zz)
        s = _full_mask_update(s, active, f.detach(), g, z_trial, max_ls)
    return to_box(s["z"], lo, hi), s["f"]


def _styblinski(X):
    return 0.5 * (X ** 4 - 16.0 * X ** 2 + 5.0 * X).sum(-1)


def _rosenbrock(X):
    return (100.0 * (X[:, 1:] - X[:, :-1] ** 2) ** 2 + (1.0 - X[:, :-1]) ** 2).sum(-1)


@pytest.mark.parametrize("fun", [_styblinski, _rosenbrock])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("R, d, m, max_iter, max_ls", [(25, 5, 10, 60, 20), (2, 6, 10, 30, 20),
                                                      (7, 3, 2, 40, 3)])
def test_minimize_restarts_ends_where_the_full_mask_loop_ends(fun, dtype, R, d, m, max_iter, max_ls):
    gen = torch.Generator().manual_seed(R * 10 + d)
    x0 = (torch.rand(R, d, generator=gen, dtype=torch.float64) * 4.0 - 2.0).to(dtype)
    res = minimize_restarts(fun, x0, -3.0, 3.0, max_iter=max_iter, memory_size=m,
                            max_linesearch_steps=max_ls)
    x_ref, f_ref = _full_mask_minimize(fun, x0, -3.0, 3.0, max_iter, m, max_ls)
    assert torch.equal(res.x, x_ref)
    assert torch.equal(res.fun, torch.where(torch.isfinite(f_ref), f_ref, torch.full_like(f_ref, math.inf)))


def test_the_cpu_update_launches_nothing():
    """On the CPU the trip's update is the twin, float32 as float64, and the
    kernel's wrapper refuses a CPU state."""
    for dtype in (torch.float32, torch.float64):
        st, idx, f_a, g_a, z_trial, _ = random_trip(8, 5, 10, 4, dtype=dtype)
        ref = random_trip(8, 5, 10, 4, dtype=dtype)[0]
        before = hk.lbfgs_update_fused.launches
        optimize._update(st, idx, f_a, g_a, z_trial, 20)
        assert hk.lbfgs_update_fused.launches == before
        lbfgs_update_plain(ref, idx, f_a, g_a, z_trial, 20)
        for name in FIELDS:
            assert torch.equal(torch.nan_to_num(getattr(st, name), nan=7.0),
                               torch.nan_to_num(getattr(ref, name), nan=7.0)), name
        with pytest.raises(ValueError):
            hk.lbfgs_update_fused(st, idx, f_a, g_a, z_trial, 20, optimize.LBFGS_C1)
    hk.reset_launch_counts()
    assert hk.lbfgs_update_fused.launches == 0

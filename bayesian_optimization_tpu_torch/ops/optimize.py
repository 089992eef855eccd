"""Batched box-constrained L-BFGS for hyperparameter fitting and the
gradient-based acquisition argmax.

Counterpart of bayesian_optimization_tpu/ops/optimize.py. All restarts run
at once as lanes of one state machine: every trip of the loop evaluates the
objective for all live lanes in ONE batched call, `fun(X[R, d]) -> f[R]`,
and takes the gradient by autograd of the sum over lanes (the lanes are
independent, so d(sum)/dx_r is lane r's gradient). Each lane carries its own
done flag; the loop ends when every lane is done or out of iterations.

The per-lane logic is the JAX package's `_lbfgs_compact`, step for step --
the two-loop-recursion L-BFGS direction, Armijo backtracking, a sigmoid
box x = lo + (hi - lo) sigmoid(z), non-finite gradients zeroed, and the
stall exit `done = not good` kept as it is (it misses an accepted step
that does not move; see ROADMAP Queue 3), so evaluation counts match the
reference.

Inside a timed phase (utils/logging.py) each trip is timed by the spans
"lbfgs.forward", "lbfgs.backward", "lbfgs.update" and "host_sync" (the
live-lane read) and counted in "lbfgs.trips" and "lbfgs.lane_evals"; a
run's concluded steps, "lbfgs.steps", are read once at its end. Outside a
phase none of it costs more than a lookup, and no number changes.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..utils.logging import count, host_sync, in_phase, span

_Z_CLIP = 12.0  # |z| beyond this is numerically saturated in f32


def to_box(z: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    return lo + (hi - lo) * torch.sigmoid(z)


def from_box(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    frac = ((x - lo) / (hi - lo).clamp_min(1e-30)).clamp(1e-6, 1.0 - 1e-6)
    return (torch.log(frac) - torch.log1p(-frac)).clamp(-_Z_CLIP, _Z_CLIP)


class MinimizeResult(NamedTuple):
    x: torch.Tensor        # (R, d) final points, in box coordinates
    fun: torch.Tensor      # (R,) final objective values
    x_best: torch.Tensor   # (d,) best point over restarts
    fun_best: torch.Tensor # () best value


def _value_and_grad(zfun, z, t, p, idx: torch.Tensor):
    """One trip's objective: the trial points z + t p of every lane (clipped),
    the values of the live lanes idx there (the span "lbfgs.forward") and
    their gradients by autograd ("lbfgs.backward")."""
    with span("lbfgs.forward"), torch.enable_grad():
        z_trial = (z + t[:, None] * p).clamp(-_Z_CLIP, _Z_CLIP)
        zz = z_trial[idx].detach().requires_grad_(True)
        f = zfun(zz, idx)
        total = f.sum()
    with span("lbfgs.backward"):
        (g,) = torch.autograd.grad(total, zz)
    return z_trial, f.detach(), g


def _direction(g, S, Y, rho, k, gamma, m: int):
    """-H g for each lane by the two-loop recursion of the JAX package's
    `_lbfgs_compact.direction`, step for step, with the lanes as a leading
    batch axis: H0 = gamma I and the lane's stored (s, y, rho) triples in
    the circular history S, Y (R, m, d), rho (R, m). The history is first
    gathered into age order, so step i of the backward loop reads the
    (i+1)-th newest pair, slot (k - 1 - i) mod m, as the reference does.
    The per-step scalar factors (valid * rho for the dot products, valid for
    the updates) are folded into the gathered vectors once, which leaves
    two launches per backward step and three per forward step."""
    R_, d = g.shape
    nv = torch.clamp(k, max=m)
    pos = torch.arange(m, device=g.device)
    slot = torch.remainder(k[:, None] - 1 - pos[None, :], m)  # newest .. oldest
    valid = (pos[None, :] < nv[:, None]).to(g.dtype)           # (R, m)
    vr = (valid * rho.gather(1, slot))[..., None]
    idx = slot[..., None].expand(R_, m, d)
    S_n, Y_n = S.gather(1, idx), Y.gather(1, idx)
    S_rho, Y_rho, S_valid = S_n * vr, Y_n * vr, S_n * valid[..., None]

    q = g
    alphas = []
    for i in range(m):
        a = torch.linalg.vecdot(S_rho[:, i], q)       # valid * rho * <s, q>
        q = torch.addcmul(q, a[:, None], Y_n[:, i], value=-1.0)
        alphas.append(a)
    r = gamma[:, None] * q
    for i in range(m - 1, -1, -1):  # oldest-to-newest = reverse of bwd order
        b = torch.linalg.vecdot(Y_rho[:, i], r)       # valid * rho * <y, r>
        r = torch.addcmul(r, (alphas[i] - b)[:, None], S_valid[:, i])
    # fall back to steepest descent until history exists / if not a
    # descent direction
    p = -r
    ok = (k > 0) & ((p * g).sum(-1) < 0.0) & torch.isfinite(p).all(-1)
    return torch.where(ok[:, None], p, -g)


def _lbfgs_batched(zfun, z0, max_iter: int, memory_size: int, max_linesearch_steps: int):
    R, d = z0.shape
    m = memory_size
    dt, dev = z0.dtype, z0.device
    c1 = 1e-4
    lanes = torch.arange(R, device=dev)
    z = z0.clone()
    f = torch.full((R,), float("inf"), dtype=dt, device=dev)
    g = torch.zeros((R, d), dtype=dt, device=dev)
    S = torch.zeros((R, m, d), dtype=dt, device=dev)
    Y = torch.zeros((R, m, d), dtype=dt, device=dev)
    rho = torch.zeros((R, m), dtype=dt, device=dev)
    k = torch.zeros((R,), dtype=torch.long, device=dev)
    gamma = torch.ones((R,), dtype=dt, device=dev)
    # the first trip evaluates z0 itself: p = 0 and f = +inf force acceptance
    p = torch.zeros((R, d), dtype=dt, device=dev)
    gTp = torch.zeros((R,), dtype=dt, device=dev)
    t = torch.ones((R,), dtype=dt, device=dev)
    n_probe = torch.zeros((R,), dtype=torch.long, device=dev)
    n_accept = torch.zeros((R,), dtype=torch.long, device=dev)
    done = torch.zeros((R,), dtype=torch.bool, device=dev)

    while True:
        with host_sync():
            active = ~done & (n_accept < max_iter + 1)
            idx = active.nonzero()[:, 0]
            n_live = idx.numel()
        if n_live == 0:
            break
        count("lbfgs.trips")
        count("lbfgs.lane_evals", n_live)
        z_trial, f_a, g_a = _value_and_grad(zfun, z, t, p, idx)
        with span("lbfgs.update"):
            f_t = torch.full((R,), float("inf"), dtype=dt, device=dev)
            g_t = torch.zeros((R, d), dtype=dt, device=dev)
            f_t[idx] = f_a
            g_t[idx] = torch.where(torch.isfinite(g_a), g_a, torch.zeros_like(g_a))

            armijo = f_t <= f + c1 * t * gTp
            stop = armijo | (n_probe >= max_linesearch_steps)

            # step concludes: accept if finite and improving
            good = torch.isfinite(f_t) & (f_t <= f) & torch.isfinite(z_trial).all(-1)
            z_new = torch.where(good[:, None], z_trial, z)
            f_new = torch.where(good, f_t, f)
            g_new = torch.where(good[:, None], g_t, g)
            s = z_new - z
            y = g_new - g
            sy = (s * y).sum(-1)
            curv_ok = good & (sy > 1e-10 * s.norm(dim=-1) * y.norm(dim=-1) + 1e-30)
            slot = torch.remainder(k, m)
            S_new, Y_new, rho_new = S.clone(), Y.clone(), rho.clone()
            S_new[lanes, slot] = torch.where(curv_ok[:, None], s, S[lanes, slot])
            Y_new[lanes, slot] = torch.where(curv_ok[:, None], y, Y[lanes, slot])
            rho_new[lanes, slot] = torch.where(curv_ok, 1.0 / sy.clamp_min(1e-30), rho[lanes, slot])
            k_new = k + curv_ok.long()
            gamma_new = torch.where(curv_ok, sy / (y * y).sum(-1).clamp_min(1e-30), gamma)
            p_new = _direction(g_new, S_new, Y_new, rho_new, k_new, gamma_new, m)

            acc = active & stop      # lanes whose step concluded this trip
            probe = active & ~stop   # lanes still backtracking: halve t
            a1, a2 = acc[:, None], acc[:, None, None]
            z = torch.where(a1, z_new, z)
            f = torch.where(acc, f_new, f)
            g = torch.where(a1, g_new, g)
            S = torch.where(a2, S_new, S)
            Y = torch.where(a2, Y_new, Y)
            rho = torch.where(a1, rho_new, rho)
            k = torch.where(acc, k_new, k)
            gamma = torch.where(acc, gamma_new, gamma)
            p = torch.where(a1, p_new, p)
            gTp = torch.where(acc, (g_new * p_new).sum(-1), gTp)
            t = torch.where(acc, torch.ones_like(t), torch.where(probe, 0.5 * t, t))
            n_probe = torch.where(acc, torch.zeros_like(n_probe), n_probe + probe.long())
            n_accept = n_accept + acc.long()
            # the stall exit, as the reference has it: a concluded step that did
            # not improve leaves the lane at a fixed point
            done = torch.where(acc, ~good, done)
    if in_phase():  # the lanes' concluded steps, read once a run
        with host_sync():
            count("lbfgs.steps", int(n_accept.sum()))
    return z, f


def minimize_restarts(
    fun: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    lo,
    hi,
    max_iter: int = 60,
    memory_size: int = 10,
    max_linesearch_steps: int = 20,
    lane_index: bool = False,
) -> MinimizeResult:
    """Minimize `fun` from each row of x0 (R, d) inside [lo, hi], all
    restarts in parallel. `fun` maps a batch (R', d) -> (R',) and must be
    differentiable by autograd; lanes must not interact. A trip evaluates
    only the live lanes, so an objective whose parameters differ per lane
    (the q criteria of a batch, flattened into one run) asks for
    lane_index=True and is called as fun(X, idx), idx (R',) the lanes' rows
    of x0."""
    lo = torch.as_tensor(lo, dtype=x0.dtype, device=x0.device)
    hi = torch.as_tensor(hi, dtype=x0.dtype, device=x0.device)

    def zfun(z, idx):
        return fun(to_box(z, lo, hi), idx) if lane_index else fun(to_box(z, lo, hi))

    zs, vals = _lbfgs_batched(zfun, from_box(x0, lo, hi), max_iter, memory_size,
                              max_linesearch_steps)
    xs = to_box(zs, lo, hi)
    vals = torch.where(torch.isfinite(vals), vals, torch.full_like(vals, float("inf")))
    best = torch.argmin(vals)
    with host_sync(2):  # indexing by a 0-d device tensor reads it, twice
        x_best, fun_best = xs[best], vals[best]
    return MinimizeResult(x=xs, fun=vals, x_best=x_best, fun_best=fun_best)


def maximize_restarts(fun, x0, lo, hi, **kw) -> MinimizeResult:
    """Maximization convenience wrapper (negates fun and the results)."""
    res = minimize_restarts(lambda *a: -fun(*a), x0, lo, hi, **kw)
    return MinimizeResult(x=res.x, fun=-res.fun, x_best=res.x_best, fun_best=-res.fun_best)

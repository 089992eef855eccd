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
reference. The lanes' state lives in two workspaces allocated once a run
(`lbfgs_state`), and a trip's update of it -- acceptance, curvature
history, the two-loop direction -- is one launch of a CUDA kernel on a CUDA
float32 state (`hopper_kernels.lbfgs_update_fused`), its plain twin
`lbfgs_update_plain`, which defines it, on the CPU and in float64.

An objective that launches only device work and keeps its lanes apart (the
acquisition argmax's plain GP criterion, `capturable`) has a loop of its
own on a CUDA float32 state, `_lbfgs_graphed`: every trip runs at the full
width of the lanes under a device-side mask of the live ones, so its shapes
never change, and after the run's first trip it is one CUDA graph, captured
once a run and replayed once a trip. The host then issues one launch a trip
and reads the next trip's live count, which the graph writes to pinned host
memory, in place of the ~110 launches of the objective, its autograd
backward and the update.

Inside a timed phase (utils/logging.py) each trip is timed by the spans
"lbfgs.forward", "lbfgs.backward", "lbfgs.update" and "host_sync" (the
live-lane read) and counted in "lbfgs.trips", "lbfgs.lane_evals" and, where
the kernel runs the update, "lbfgs.fused_updates"; a run's concluded steps,
"lbfgs.steps", are read once at its end. A replayed trip is the span
"lbfgs.forward" (the replay) and "host_sync" (the live count), and counts
one "lbfgs.graph_replays" besides; a graphed run's first trip is timed as
an eager trip, and "lbfgs.capture" times its capture alone. Outside a
phase none of it costs more than a lookup, and no number changes.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Callable, NamedTuple

import torch

from ..utils.logging import count, host_sync, in_phase, no_phase, profiler_range, span
from .hopper_kernels import add_launch_counts, launch_counts, lbfgs_update_fused

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


# the lanes' state, field after field in two workspaces (csrc/lbfgs.cu reads
# the same layout): name -> shape after the lane axis, "d" and "m" the
# variables and the history length
_LBFGS_FLOAT_FIELDS = (("z", "d"), ("g", "d"), ("p", "d"), ("S", "md"), ("Y", "md"),
                       ("rho", "m"), ("alpha", "m"), ("f", ""), ("gamma", ""), ("gTp", ""),
                       ("t", ""))
_LBFGS_INT_FIELDS = ("k", "n_probe", "n_accept", "done")


class LbfgsState(NamedTuple):
    """The lanes' state of a batched L-BFGS run: views into one float
    workspace `ws` (the run's dtype) and one int64 workspace `iws`, which a
    trip's update rewrites in place. z, g, p (R, d): point, gradient and
    search direction; S, Y (R, m, d), rho (R, m): the circular curvature
    history; alpha (R, m): the kernel's scratch for the recursion; f, gamma,
    gTp, t (R,): value, H0 scale, g.p and step length; k (R,): pairs stored
    so far; n_probe, n_accept (R,): backtracks of the current step and
    concluded steps; done (R,): 1 once a concluded step did not improve."""
    ws: torch.Tensor
    iws: torch.Tensor
    z: torch.Tensor
    g: torch.Tensor
    p: torch.Tensor
    S: torch.Tensor
    Y: torch.Tensor
    rho: torch.Tensor
    alpha: torch.Tensor
    f: torch.Tensor
    gamma: torch.Tensor
    gTp: torch.Tensor
    t: torch.Tensor
    k: torch.Tensor
    n_probe: torch.Tensor
    n_accept: torch.Tensor
    done: torch.Tensor


def lbfgs_state(z0: torch.Tensor, m: int) -> LbfgsState:
    """A run's state for the starts z0 (R, d) and a history of m, allocated
    once: f = +inf and p = 0, so the first trip evaluates z0 itself and
    accepts it; t = 1, gamma = 1, everything else 0."""
    R, d = z0.shape
    dims = {"": (), "d": (d,), "m": (m,), "md": (m, d)}
    shapes = [(R, *dims[kind]) for _, kind in _LBFGS_FLOAT_FIELDS]
    sizes = [math.prod(s) for s in shapes]
    ws = torch.zeros(sum(sizes), dtype=z0.dtype, device=z0.device)
    iws = torch.zeros(len(_LBFGS_INT_FIELDS) * R, dtype=torch.long, device=z0.device)
    floats = {name: v.view(s) for (name, _), v, s in zip(_LBFGS_FLOAT_FIELDS, ws.split(sizes), shapes)}
    st = LbfgsState(ws, iws, **floats, **dict(zip(_LBFGS_INT_FIELDS, iws.split(R))))
    st.z.copy_(z0)
    st.f.fill_(math.inf)
    st.gamma.fill_(1.0)
    st.t.fill_(1.0)
    return st


def _direction(g, S, Y, rho, k, gamma, m: int):
    """-H g for each lane by the two-loop recursion of the JAX package's
    `_lbfgs_compact.direction`, step for step, with the lanes as a leading
    batch axis: H0 = gamma I and the lane's stored (s, y, rho) triples in
    the circular history S, Y (R, m, d), rho (R, m). The history is first
    gathered into age order, so step i of the backward loop reads the
    (i+1)-th newest pair, slot (k - 1 - i) mod m, as the reference does.
    The per-step scalar factors (valid * rho for the dot products, valid for
    the updates) are folded into the gathered vectors once."""
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


LBFGS_C1 = 1e-4  # the Armijo constant


def lbfgs_update_plain(st: LbfgsState, idx, f_a, g_a, z_trial, max_linesearch_steps: int,
                       c1: float = LBFGS_C1) -> None:
    """Plain twin of `hopper_kernels.lbfgs_update_fused`: one trip's update of the live
    lanes idx (n_live,), in place in st, from their values f_a (n_live,)
    and gradients g_a (n_live, d) at the trial points z_trial (R, d) = z +
    t p (clipped). Non-finite gradients count as 0. A lane whose trial
    passes Armijo, or whose line search reached its cap, concludes its step:
    it moves to the trial point if that is finite and not worse (else it
    stays, and is done: the stall exit of the reference), stores the pair
    (s, y) in slot k mod m if its curvature holds, and takes its next
    direction by `_direction`, with t = 1. Every other live lane halves t.
    Lanes outside idx are not touched, nor is an entry of -1 on the CPU: it
    names no lane, and the twin drops it first. (On the card a trip at the
    full width of the lanes runs the kernel, and the twin is handed live
    lanes only: dropping an entry there would read the device.)"""
    if idx.device.type == "cpu":
        keep = idx >= 0
        idx, f_a, g_a = idx[keep], f_a[keep], g_a[keep]
    m = st.S.shape[1]
    dt = st.ws.dtype
    z, f, g, S, Y, rho, k, gamma, p, gTp, t, n_probe, n_accept, done = (
        x[idx] for x in (st.z, st.f, st.g, st.S, st.Y, st.rho, st.k, st.gamma, st.p, st.gTp,
                         st.t, st.n_probe, st.n_accept, st.done))
    z_t = z_trial[idx]
    f_t = f_a.to(dt)
    g_t = g_a.to(dt)
    g_t = torch.where(torch.isfinite(g_t), g_t, torch.zeros_like(g_t))

    armijo = f_t <= f + c1 * t * gTp
    stop = armijo | (n_probe >= max_linesearch_steps)

    # step concludes: accept if finite and improving
    good = torch.isfinite(f_t) & (f_t <= f) & torch.isfinite(z_t).all(-1)
    z_new = torch.where(good[:, None], z_t, z)
    f_new = torch.where(good, f_t, f)
    g_new = torch.where(good[:, None], g_t, g)
    s = z_new - z
    y = g_new - g
    sy = (s * y).sum(-1)
    curv_ok = good & (sy > 1e-10 * s.norm(dim=-1) * y.norm(dim=-1) + 1e-30)
    slot = torch.remainder(k, m)
    lanes = torch.arange(idx.numel(), device=idx.device)
    S_new, Y_new, rho_new = S.clone(), Y.clone(), rho.clone()
    S_new[lanes, slot] = torch.where(curv_ok[:, None], s, S[lanes, slot])
    Y_new[lanes, slot] = torch.where(curv_ok[:, None], y, Y[lanes, slot])
    rho_new[lanes, slot] = torch.where(curv_ok, 1.0 / sy.clamp_min(1e-30), rho[lanes, slot])
    k_new = k + curv_ok.long()
    gamma_new = torch.where(curv_ok, sy / (y * y).sum(-1).clamp_min(1e-30), gamma)
    p_new = _direction(g_new, S_new, Y_new, rho_new, k_new, gamma_new, m)

    # lanes whose step concluded take it; the others (probes) halve t
    a1, a2 = stop[:, None], stop[:, None, None]
    st.z[idx] = torch.where(a1, z_new, z)
    st.f[idx] = torch.where(stop, f_new, f)
    st.g[idx] = torch.where(a1, g_new, g)
    st.S[idx] = torch.where(a2, S_new, S)
    st.Y[idx] = torch.where(a2, Y_new, Y)
    st.rho[idx] = torch.where(a1, rho_new, rho)
    st.k[idx] = torch.where(stop, k_new, k)
    st.gamma[idx] = torch.where(stop, gamma_new, gamma)
    st.p[idx] = torch.where(a1, p_new, p)
    st.gTp[idx] = torch.where(stop, (g_new * p_new).sum(-1), gTp)
    st.t[idx] = torch.where(stop, torch.ones_like(t), 0.5 * t)
    st.n_probe[idx] = torch.where(stop, torch.zeros_like(n_probe), n_probe + 1)
    st.n_accept[idx] = n_accept + stop.long()
    # the stall exit, as the reference has it: a concluded step that did
    # not improve leaves the lane at a fixed point
    st.done[idx] = torch.where(stop, (~good).long(), done)


def _update(st: LbfgsState, idx, f_a, g_a, z_trial, max_linesearch_steps: int) -> None:
    """One trip's update of the live lanes: one launch of csrc/lbfgs.cu
    (`hopper_kernels.lbfgs_update_fused`, counted in "lbfgs.fused_updates")
    on a CUDA state, the twin on the CPU and in float64 on any device. A
    CUDA state in another dtype, a failed build or a failed launch raises."""
    if st.ws.device.type == "cpu" or st.ws.dtype == torch.float64:
        lbfgs_update_plain(st, idx, f_a, g_a, z_trial, max_linesearch_steps)
        return
    lbfgs_update_fused(st, idx, f_a, g_a, z_trial, max_linesearch_steps, LBFGS_C1)
    count("lbfgs.fused_updates")


def _lbfgs_batched(zfun, z0, max_iter: int, memory_size: int, max_linesearch_steps: int):
    st = lbfgs_state(z0, memory_size)  # the first trip evaluates and accepts z0
    while True:
        with host_sync():
            active = (st.done == 0) & (st.n_accept < max_iter + 1)
            idx = active.nonzero()[:, 0]
            n_live = idx.numel()
        if n_live == 0:
            break
        count("lbfgs.trips")
        count("lbfgs.lane_evals", n_live)
        z_trial, f_a, g_a = _value_and_grad(zfun, st.z, st.t, st.p, idx)
        with span("lbfgs.update"):
            _update(st, idx, f_a, g_a, z_trial, max_linesearch_steps)
    _count_steps(st)
    return st.z, st.f


def _count_steps(st: LbfgsState) -> None:
    if in_phase():  # the lanes' concluded steps, read once a run
        with host_sync():
            count("lbfgs.steps", int(st.n_accept.sum()))


def _masked_trip(zfun, st: LbfgsState, lanes, max_iter: int, max_linesearch_steps: int):
    """One trip at the full width of the R lanes (lanes = arange(R)), its
    shapes the same every trip: the live lanes are a device-side mask,
    handed to the update as the index where(live, lane, -1), and every
    lane's trial point is evaluated and differentiated. What a lane that is
    not live computes is thrown away; the lanes are independent, so a live
    lane computes what the live-lane loop's trip computes. Timed by the
    spans of `_lbfgs_batched`'s trip. Returns the next trip's live count, a
    0-d device tensor."""
    def live():
        return (st.done == 0) & (st.n_accept < max_iter + 1)

    with span("lbfgs.forward"), torch.enable_grad():
        idx = torch.where(live(), lanes, -1)
        z_trial = (st.z + st.t[:, None] * st.p).clamp(-_Z_CLIP, _Z_CLIP)
        zz = z_trial.detach().requires_grad_(True)
        f = zfun(zz, lanes)
        total = f.sum()
    with span("lbfgs.backward"):
        (g,) = torch.autograd.grad(total, zz)
    with span("lbfgs.update"):
        _update(st, idx, f.detach(), g, z_trial, max_linesearch_steps)
        return live().sum()


# a thread's capture context a CUDA device (_capture_context)
_CAPTURE = threading.local()


class _CaptureContext:
    """What a thread's graphed runs on one device share: the side stream a
    run's first trip and its capture run on (so the stream's workspaces and
    the Matern backward's arrival counters exist before the capture), the
    memory pool every capture allocates from, the pinned word a graph writes
    the next trip's live count to, and the last run's graph, held until the
    next capture: a pool is shared only while a graph holds it, and the
    last graph's memory is the next one's."""

    def __init__(self, device):
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.live = torch.zeros((), dtype=torch.long, pin_memory=True)
        self.graph = None


def _capture_context(device) -> _CaptureContext:
    by_device = _CAPTURE.__dict__.setdefault("by_device", {})
    if device not in by_device:
        by_device[device] = _CaptureContext(device)
    return by_device[device]


def _capture_trip(ctx: _CaptureContext, trip) -> torch.cuda.CUDAGraph:
    """One trip, `trip()` (its live count copied to ctx.live), captured into
    a CUDA graph on ctx's stream and pool, and held in ctx until the next
    capture. A capture that raises (the objective read the device) takes
    the pool with it, since the allocator may still count it as the failed
    graph's: the next capture takes a fresh one, and a graph held from
    before keeps its own."""
    graph = torch.cuda.CUDAGraph()
    with no_phase():
        graph.capture_begin(pool=ctx.pool, capture_error_mode="thread_local")
        try:
            ctx.live.copy_(trip(), non_blocking=True)
            graph.capture_end()
        except BaseException:
            with contextlib.suppress(RuntimeError):
                graph.capture_end()
            ctx.pool = torch.cuda.graph_pool_handle()
            raise
    ctx.graph = graph
    return graph


def _lbfgs_graphed(zfun, z0, max_iter: int, memory_size: int, max_linesearch_steps: int):
    """`_lbfgs_batched` on a CUDA float32 state for an objective that launches
    only device work: the same lanes and steps, every trip a
    `_masked_trip`. A lane's values then round alike at every trip (the
    width never changes), as the JAX package's fixed-shape loop rounds
    them, so a lane at its optimum seldom stalls on a rounding difference
    and replays to `max_iter` as there. The run's first trip runs eagerly
    on a side stream (it warms up what the capture needs), timed as an
    eager trip; then one trip is captured into a CUDA graph (the span
    "lbfgs.capture"), with the forward, the backward on the autograd
    engine's thread and the update launch, and every later trip is one
    replay of it, inside the profiler range "lbfgs.graph". The graph also
    copies the next trip's live count to pinned host memory, which the host
    reads once a trip; it stops at 0. A replay adds to the kernels' launch
    counters what the capture launched, which the capture itself does not
    count."""
    st = lbfgs_state(z0, memory_size)
    device = z0.device
    lanes = torch.arange(z0.shape[0], device=device)
    n_live = z0.shape[0] if max_iter >= 0 else 0
    ctx = _capture_context(device)
    main = torch.cuda.current_stream(device)

    def trip():
        return _masked_trip(zfun, st, lanes, max_iter, max_linesearch_steps)

    ctx.stream.wait_stream(main)
    with torch.cuda.stream(ctx.stream):
        if n_live:
            count("lbfgs.trips")
            count("lbfgs.lane_evals", n_live)
            ctx.live.copy_(trip(), non_blocking=True)
            with host_sync():
                ctx.stream.synchronize()
                n_live = int(ctx.live)
        if n_live:
            with span("lbfgs.capture"):
                before = launch_counts()
                graph = _capture_trip(ctx, trip)
                per_trip = tuple(a - b for a, b in zip(launch_counts(), before))
                add_launch_counts(per_trip, -1)
    main.wait_stream(ctx.stream)
    while n_live:
        count("lbfgs.trips")
        count("lbfgs.lane_evals", n_live)
        count("lbfgs.graph_replays")
        count("lbfgs.fused_updates")
        with span("lbfgs.forward"), profiler_range("lbfgs.graph"):
            graph.replay()
            add_launch_counts(per_trip)
        with host_sync():
            main.synchronize()
            n_live = int(ctx.live)
    _count_steps(st)
    return st.z, st.f


def minimize_restarts(
    fun: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    lo,
    hi,
    max_iter: int = 60,
    memory_size: int = 10,
    max_linesearch_steps: int = 20,
    lane_index: bool = False,
    capturable: bool = False,
) -> MinimizeResult:
    """Minimize `fun` from each row of x0 (R, d) inside [lo, hi], all
    restarts in parallel. `fun` maps a batch (R', d) -> (R',) and must be
    differentiable by autograd; lanes must not interact. A trip evaluates
    only the live lanes, so an objective whose parameters differ per lane
    (the q criteria of a batch, flattened into one run) asks for
    lane_index=True and is called as fun(X, idx), idx (R',) the lanes' rows
    of x0. capturable=True says that `fun` and its backward launch only
    device work, with no read of the device and no copy from the host: a
    CUDA float32 run then replays its trips as one CUDA graph over every
    lane (`_lbfgs_graphed`), which calls fun on all R rows."""
    lo = torch.as_tensor(lo, dtype=x0.dtype, device=x0.device)
    hi = torch.as_tensor(hi, dtype=x0.dtype, device=x0.device)

    def zfun(z, idx):
        return fun(to_box(z, lo, hi), idx) if lane_index else fun(to_box(z, lo, hi))

    graphed = capturable and x0.device.type == "cuda" and x0.dtype == torch.float32
    run = _lbfgs_graphed if graphed else _lbfgs_batched
    zs, vals = run(zfun, from_box(x0, lo, hi), max_iter, memory_size, max_linesearch_steps)
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

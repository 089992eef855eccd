"""Population-vectorized (1+1)-Cholesky-CMA-ES.

Counterpart of bayesian_optimization_tpu/optim/cma.py: 2/11 success-rule
step-size control (ccov = 2/(d^2+6), cp = 1/12, cc = 2/(d+2), damping
d_s = 1 + d/2, threshold 0.44), evolution-path covariance learning, and the
rank-one update of the Cholesky factor A and of A^-1 without
refactorization (ref parity: one_plus_one_cma_es.py:17-468). Box handling
by reflection, reset of degenerate chains.

P independent chains advance together: each generation evaluates one
(P, d) candidate batch in a single call of the objective (on the card, one
batched GP predict for an acquisition, one batched likelihood for the MLE),
and the generations are a Python loop. Draws come from the state's
`torch.Generator`, on the state's device; `_host_propose` also takes the
(P, d) normal draw itself, which is how the tests hand it the JAX
package's draw.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .._device import DEFAULT_DEVICE, resolve_device
from ..parallel.mesh import as_population
from ..utils.expr import evaluate_size
from ..utils.penalty import reflect_into_box, violation_host


class CMAState(NamedTuple):
    x: torch.Tensor             # (P, d) current parents
    f: torch.Tensor             # (P,) parent objective values (minimized)
    sigma: torch.Tensor         # (P,)
    A: torch.Tensor             # (P, d, d) Cholesky factor of C
    A_inv: torch.Tensor         # (P, d, d)
    pc: torch.Tensor            # (P, d) evolution path
    success_rate: torch.Tensor  # (P,)
    gen: torch.Generator        # draws of every later generation


def _constants(dim: int) -> dict:
    return dict(
        prob_target=2.0 / 11.0,
        threshold=0.44,
        d_damp=1.0 + dim / 2.0,
        ccov=2.0 / (dim**2 + 6.0),
        cp=1.0 / 12.0,
        cc=2.0 / (dim + 2.0),
    )


def _eye(P: int, d: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(d, dtype=like.dtype, device=like.device).expand(P, d, d)


def init_chains(gen: torch.Generator, x0: torch.Tensor, f0: torch.Tensor, sigma0: float) -> CMAState:
    P, d = x0.shape
    eye = _eye(P, d, x0)
    return CMAState(
        x=x0,
        f=f0,
        sigma=torch.full((P,), float(sigma0), dtype=x0.dtype, device=x0.device),
        A=eye,
        A_inv=eye,
        pc=torch.zeros((P, d), dtype=x0.dtype, device=x0.device),
        success_rate=torch.full((P,), 2.0 / 11.0, dtype=x0.dtype, device=x0.device),
        gen=gen,
    )


def _finite_or_inf(f: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(f), f, torch.full_like(f, float("inf")))


def best_per_group(x: torch.Tensor, f: torch.Tensor, groups: int, largest: bool = False):
    """The best lane of each of `groups` equal populations of x (P, d),
    f (P,): (x (groups, d), f (groups,)), the smallest f unless `largest`."""
    f = f.reshape(groups, -1)
    i = torch.argmax(f, dim=1) if largest else torch.argmin(f, dim=1)
    rows = torch.arange(groups, device=f.device)
    return x.reshape(groups, f.shape[1], -1)[rows, i], f[rows, i]


def run_cma(
    gen: torch.Generator,
    fun,
    x0,
    lo,
    hi,
    n_generations: int,
    sigma0: float = 0.25,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Minimize `fun` ((P, d) -> (P,)) with P parallel (1+1)-Cholesky
    chains; returns (x_best[d], f_best, x_final[P, d], f_final[P]) after
    `n_generations`.

    x0 is a (P, d) tensor or a `ShardedPopulation` (parallel/mesh.py),
    `fun` one objective or one per local mesh entry; a tensor runs as the
    one-entry mesh on its device. Each entry runs its chains' whole loop on
    its device. Every generation's draw is taken for the whole padded
    population from the one generator and each entry gets its rows, so a
    chain draws what it draws unsharded. The chains meet once, in the
    gather of the final population."""
    pop = as_population(x0)
    mesh = pop.mesh
    consts = _constants(pop.shape[-1])
    zs = mesh.split(draw_noise(gen, n_generations, pop.shape, pop.chunks[0].dtype), dim=1)

    def one(fun, x, z):
        state = init_chains(gen, x, _finite_or_inf(fun(x)), sigma0)
        return run_generations(state, fun, lo, hi, consts, z)

    states = mesh.map(one, mesh.per_entry(fun), pop.chunks, zs)
    x, f = mesh.gather([s.x for s in states], [s.f for s in states])
    best = torch.argmin(f)
    return x[best], f[best], x, f


def draw_noise(gen: torch.Generator, n: int, shape, dtype) -> torch.Tensor:
    """(n, *shape) standard normal draws, n generations' worth, taken from
    `gen` one generation at a time."""
    return torch.stack([torch.randn(shape, generator=gen, dtype=dtype, device=gen.device)
                        for _ in range(n)])


def run_generations(state: CMAState, fun: Callable, lo, hi, consts: dict, zs) -> CMAState:
    """len(zs) generations of every chain from the given draws zs (n, P, d)."""
    for z in zs:
        state, x_new = _host_propose(state, lo, hi, z)
        state = _host_generation(state, x_new, fun(x_new), consts, lo, hi)
    return state


def _host_propose(state: CMAState, lo, hi, z: Optional[torch.Tensor] = None):
    """First half of a generation: the offspring batch x + sigma A z,
    reflected into the box. z is the (P, d) standard normal draw, taken
    from the state's generator unless given."""
    if z is None:
        z = torch.randn(state.x.shape, generator=state.gen, dtype=state.x.dtype,
                        device=state.x.device)
    step = (state.A @ z[..., None])[..., 0]
    return state, reflect_into_box(state.x + state.sigma[:, None] * step, lo, hi)


def _host_generation(state: CMAState, x_new, f_new, consts, lo, hi) -> CMAState:
    """Accept/update half of a generation (x_new, f_new given)."""
    P, d = state.x.shape
    success = f_new <= state.f
    pt = consts["prob_target"]
    sr = (1.0 - consts["cp"]) * state.success_rate + consts["cp"] * success.to(state.x.dtype)
    sigma = state.sigma * torch.exp((sr - pt) / (1.0 - pt) / consts["d_damp"])
    cc, ccov = consts["cc"], consts["ccov"]
    coeff = cc * (2.0 - cc)
    below = sr < consts["threshold"]
    y = (x_new - state.x) / state.sigma[:, None].clamp_min(1e-20)
    pc_miss = (1.0 - cc) * state.pc
    pc_new = torch.where(below[:, None], pc_miss + np.sqrt(coeff) * y, pc_miss)
    ca = torch.where(below, torch.full_like(sr, 1.0 - ccov),
                     torch.full_like(sr, 1.0 - ccov + ccov * coeff))
    w = (state.A_inv @ pc_new[..., None])[..., 0]
    w_ = (state.A_inv.mT @ w[..., None])[..., 0]
    L = (w * w).sum(-1).clamp_min(1e-20)
    root = torch.sqrt(1.0 + L * ccov / ca)
    sqrt_ca = torch.sqrt(ca)[:, None, None]
    A_upd = (state.A + ((root - 1.0) / L)[:, None, None] * (pc_new[:, :, None] * w[:, None, :])) * sqrt_ca
    Ainv_upd = (state.A_inv - ((1.0 - 1.0 / root) / L)[:, None, None]
                * (w[:, :, None] * w_[:, None, :])) / sqrt_ca
    succ = success[:, None, None]
    A = torch.where(succ, A_upd, state.A)
    A_inv = torch.where(succ, Ainv_upd, state.A_inv)
    pc = torch.where(success[:, None], pc_new, pc_miss)
    # degenerate chains restart from the identity with a fresh step size
    bad = (sigma < 1e-8) | (sigma > 1e8) | ~torch.isfinite(A.reshape(P, -1).sum(-1))
    eye = _eye(P, d, state.x)
    A = torch.where(bad[:, None, None], eye, A)
    A_inv = torch.where(bad[:, None, None], eye, A_inv)
    pc = torch.where(bad[:, None], torch.zeros_like(pc), pc)
    sigma = torch.where(bad, torch.full_like(sigma, 0.25), sigma)
    x = torch.where(success[:, None], x_new, state.x)
    f = torch.minimum(_finite_or_inf(f_new), state.f)
    return CMAState(x=x, f=f, sigma=sigma, A=A, A_inv=A_inv, pc=pc, success_rate=sr, gen=state.gen)


# ---------------------------------------------------------------------------
# Reference-compatible host-facing optimizer class
# ---------------------------------------------------------------------------
class OnePlusOne_Cholesky_CMA:
    """Drop-in style wrapper matching the reference optimizer surface
    (search_space, obj_fun, h/g, max_FEs, ftarget, minimize, ...) for
    black-box host objectives; the chain arithmetic is the batched code
    above, on `device`; the objective is called once per generation on the
    whole chain batch."""

    def __init__(
        self,
        search_space=None,
        obj_fun: Callable = None,
        h: Callable = None,
        g: Callable = None,
        x0=None,
        sigma0: Optional[float] = None,
        ftarget: Optional[float] = None,
        max_FEs: float = np.inf,
        minimize: bool = True,
        xtol: float = 1e-4,
        ftol: float = 1e-4,
        n_chains: int = 16,
        verbose: bool = False,
        random_seed: int = 42,
        device=DEFAULT_DEVICE,
        **kwargs,
    ):
        self.device = resolve_device(device)
        bounds = np.asarray(search_space.bounds, dtype=float)
        self.search_space = search_space
        self.dim = search_space.dim
        self.lb, self.ub = bounds[:, 0], bounds[:, 1]
        self.obj_fun = obj_fun
        self.h, self.g = h, g
        self.minimize = minimize
        self.ftarget = ftarget
        self.max_FEs = float(
            np.inf if max_FEs is None else evaluate_size(max_FEs, self.dim)
        )
        self.xtol, self.ftol = xtol, ftol
        self.n_chains = int(n_chains)
        self.sigma0 = sigma0 if sigma0 is not None else 0.25 * float(np.max(self.ub - self.lb))
        self.verbose = verbose
        self.random_seed = random_seed
        self._rng = np.random.default_rng(random_seed)
        self.x0 = None if x0 is None else np.asarray(x0, dtype=float)
        self.eval_count = 0
        self.iter_count = 0
        self.xopt = None
        self.fopt = np.inf

    def _eval_batch(self, X: np.ndarray):
        """Host objective + raw constraint violation over a batch. Penalty
        weighting happens per generation with the *current* t on both
        parents and offspring (as the JAX package corrects the reference)."""
        vals = np.empty(len(X))
        viol = np.zeros(len(X))
        for i, x in enumerate(X):
            y = float(self.obj_fun(x))
            if not self.minimize:
                y = -y
            if self.h is not None or self.g is not None:
                viol[i] = violation_host(x, self.h, self.g)
            vals[i] = y
        self.eval_count += len(X)
        return vals, viol

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=self.device)

    def run(self):
        P, d = self.n_chains, self.dim
        lo, hi = self._t(self.lb), self._t(self.ub)
        consts = _constants(d)
        x0 = self._rng.uniform(self.lb, self.ub, (P, d))
        if self.x0 is not None:
            x0[0] = self.x0
        obj_p, viol_p = self._eval_batch(x0)
        gen = torch.Generator(device=self.device).manual_seed(int(self.random_seed))
        state = init_chains(gen, self._t(x0), self._t(obj_p + 0.5 * viol_p), self.sigma0)

        max_gens = int(max(1, self.max_FEs // P))
        n_restart = 0
        best_x, best_f, best_viol = None, np.inf, np.inf
        for gen_i in range(max_gens):
            self.iter_count = gen_i
            state, x_new = _host_propose(state, lo, hi)
            obj_n, viol_n = self._eval_batch(x_new.cpu().double().numpy())
            # dynamic penalty with the CURRENT weight on both sides
            w = 0.5 * (gen_i + 1)
            f_parent = self._t(obj_p + w * viol_p)
            f_new = self._t(obj_n + w * viol_n)
            accepted = (f_new <= f_parent).cpu().numpy()
            state = _host_generation(state._replace(f=f_parent), x_new, f_new, consts, lo, hi)
            obj_p = np.where(accepted, obj_n, obj_p)
            viol_p = np.where(accepted, viol_n, viol_p)
            # running champion across restarts: feasible-first ranking
            feas_rank = np.where(viol_p > 1e-9, viol_p * 1e6, 0.0) + obj_p
            i = int(np.argmin(feas_rank))
            best_rank = (best_viol * 1e6 if best_viol > 1e-9 else 0.0) + best_f
            if feas_rank[i] < best_rank:
                best_x = state.x[i].cpu().double().numpy()
                best_f, best_viol = float(obj_p[i]), float(viol_p[i])
            if self.ftarget is not None and best_f <= (self.ftarget if self.minimize else -self.ftarget):
                break
            if self.eval_count >= self.max_FEs:
                break
            # per-chain restart on step-size collapse: a chain whose sigma
            # shrank below xtol (relative to the box) has converged; its
            # best is already the champion's candidate, so reseed it
            # uniformly (the reference's restart-on-stop, per chain)
            sig = state.sigma.cpu().numpy()
            sig_restart = self.xtol * float(np.min(self.ub - self.lb))
            if self.ftarget is not None and self.ftarget > 0:
                # keep reseeding below the step size a chain needs to reach
                # ftarget, or it would be killed on final approach
                sig_restart = min(sig_restart, 1e-2 * np.sqrt(self.ftarget))
            done = sig < sig_restart
            if np.any(done):
                n_restart += int(done.sum())
                x0 = state.x.cpu().double().numpy()
                x0[done] = self._rng.uniform(self.lb, self.ub, (int(done.sum()), d))
                obj_r, viol_r = self._eval_batch(x0[done])
                obj_p[done], viol_p[done] = obj_r, viol_r
                m = self._t(done) > 0
                eye = _eye(P, d, state.x)
                state = state._replace(
                    x=torch.where(m[:, None], self._t(x0), state.x),
                    f=torch.where(m, self._t(obj_p + 0.5 * viol_p), state.f),
                    sigma=torch.where(m, torch.full_like(state.sigma, self.sigma0), state.sigma),
                    A=torch.where(m[:, None, None], eye, state.A),
                    A_inv=torch.where(m[:, None, None], eye, state.A_inv),
                    pc=torch.where(m[:, None], torch.zeros_like(state.pc), state.pc),
                    success_rate=torch.where(m, torch.full_like(state.success_rate, 2.0 / 11.0),
                                             state.success_rate),
                )
        self.xopt = best_x
        self.fopt = best_f * (1.0 if self.minimize else -1.0)
        self.stop_dict = {"FEs": self.eval_count, "n_restart": n_restart}
        return self.xopt, self.fopt, self.stop_dict

"""SMC-resampling population argmax.

Counterpart of bayesian_optimization_tpu/optim/smc.py: blocks of batched
(1+1)-Cholesky-CMA generations (optim/cma.py) interleaved with systematic
resampling of whole chains -- position, step size, Cholesky factors,
evolution path -- by annealed rank-based weights exp(-rho * rank / P),
rho growing from round to round. Ranks keep the weights scale-free.

The chains may form `groups` independent populations of equal size, each
ranked and resampled within itself: that is how the q criteria of a batch
run as one population of q * P chains, where the JAX package vmaps one
program per criterion. Draws come from the state's `torch.Generator`;
`systematic_resample` also takes its uniform offset, which is how the
tests hand it the JAX package's draw.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..parallel.mesh import as_population
from .cma import (
    CMAState, _constants, _finite_or_inf, best_per_group, draw_noise, init_chains,
    run_generations,
)


def systematic_resample(gen: Optional[torch.Generator], log_w: torch.Tensor,
                        u0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Systematic resampling of each row of log_w (G, P) (or one row (P,)):
    indices into the row, drawn with one offset u0 in [0, 1/P) per row."""
    P = log_w.shape[-1]
    cdf = torch.cumsum(torch.softmax(log_w, dim=-1), dim=-1)
    if u0 is None:
        u0 = torch.rand(log_w.shape[:-1], generator=gen, dtype=log_w.dtype,
                        device=log_w.device) / P
    u0 = torch.as_tensor(u0, dtype=log_w.dtype, device=log_w.device).expand(log_w.shape[:-1])
    pos = u0[..., None] + torch.arange(P, dtype=log_w.dtype, device=log_w.device) / P
    # jnp.searchsorted's default side='left'
    return torch.searchsorted(cdf.contiguous(), pos.contiguous(), right=False).clamp(0, P - 1)


def resample_chains(gen: Optional[torch.Generator], state: CMAState, rho, groups: int = 1,
                    u0: Optional[torch.Tensor] = None) -> CMAState:
    """Resample every per-chain field of the CMA state by annealed
    rank-based weights exp(-rho * rank / P) (rank 0 = best chain), within
    each of `groups` equal populations. The ranks come from a stable double
    argsort, as jnp.argsort's: non-finite f maps to +inf and ties."""
    f = _finite_or_inf(state.f).reshape(groups, -1)
    P = f.shape[1]
    ranks = torch.argsort(torch.argsort(f, dim=-1, stable=True), dim=-1, stable=True).to(f.dtype)
    idx = systematic_resample(gen, -rho * ranks / P, u0)
    idx = (idx + P * torch.arange(groups, device=idx.device)[:, None]).reshape(-1)
    return CMAState(*(a[idx] for a in state[:-1]), gen=state.gen)


def _rho(rho0: float, rho_growth: float, rnd: int, dtype) -> float:
    """The annealing ladder's rho in round rnd, in the chains' dtype."""
    return float(torch.tensor(rho0, dtype=dtype) * torch.tensor(rho_growth, dtype=dtype) ** rnd)


def run_smc(
    gen: torch.Generator,
    fun,
    x0,
    lo,
    hi,
    n_rounds: int,
    n_moves: int,
    sigma0: float = 0.25,
    rho0: float = 2.0,
    rho_growth: float = 1.6,
    groups: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Minimize `fun` ((P, d) -> (P,)) with P CMA chains resampled between
    move blocks; returns (x_best, f_best, x_final, f_final). With groups=1,
    x_best is (d,) and f_best a scalar; otherwise (groups, d) and (groups,),
    the best of each population.

    x0 and `fun` are as `run_cma` takes them: each mesh entry runs its
    chains' move blocks on its device, from draws taken for the whole
    padded population from the one generator. Resampling permutes the whole
    chain axis: once a round the chain states are gathered, resampled where
    they land and split again -- the collective of the JAX program -- and
    one last gather ends the run, so a run gathers n_rounds + 1 times (the
    initial states ride in the first)."""
    pop = as_population(x0)
    mesh = pop.mesh
    consts = _constants(pop.shape[-1])
    dtype = pop.chunks[0].dtype
    funs = mesh.per_entry(fun)
    n_fields = len(CMAState._fields) - 1

    def move_block(states):
        zs = mesh.split(draw_noise(gen, n_moves, pop.shape, dtype), dim=1)
        return mesh.map(lambda st, fun, z: run_generations(st, fun, lo, hi, consts, z),
                        states, funs, zs)

    states = mesh.map(lambda fun, x: init_chains(gen, x, _finite_or_inf(fun(x)), sigma0),
                      funs, pop.chunks)
    init = ([s.x for s in states], [s.f for s in states])
    for rnd in range(n_rounds + 1):
        states = move_block(states)
        out = mesh.gather(*([s[i] for s in states] for i in range(n_fields)),
                          *(init if rnd == 0 else ()))
        full = CMAState(*out[:n_fields], gen=gen)
        if rnd == 0:
            best_x, best_f = best_per_group(out[n_fields], out[n_fields + 1], groups)
        xi, fi = best_per_group(full.x, full.f, groups)
        better = fi < best_f
        best_x = torch.where(better[:, None], xi, best_x)
        best_f = torch.where(better, fi, best_f)
        if rnd == n_rounds:
            # the final move block runs un-resampled so the last
            # exploitation sweep's improvements are kept
            break
        full = resample_chains(gen, full, _rho(rho0, rho_growth, rnd, dtype), groups)
        states = [CMAState(*fields, gen=gen) for fields in zip(*(mesh.split(a) for a in full[:-1]))]
    if groups == 1:
        return best_x[0], best_f[0], full.x, full.f
    return best_x, best_f, full.x, full.f

"""Acquisition argmax over a search space's unit cube.

Counterpart of bayesian_optimization_tpu/optim/argmax.py, with its four
engines: batched multi-start L-BFGS ('BFGS', and 'auto' on an all-real
space), the population (1+1)-Cholesky-CMA-ES ('OnePlusOne_Cholesky_CMA'),
CMA chains with systematic resampling ('SMC'), and the mixed-integer ES
('MIES', and 'auto' on a mixed space). Restarts and chains are lanes of one
population: every L-BFGS trip or ES generation evaluates the criterion for
all of them at once -- one shared posterior, so one (P, n_pad)
cross-covariance through the hand Matern kernel.

`batch` maximizes q criteria (one acquisition, q parameter sets) as ONE
population of q x P lanes, where the JAX package vmaps one program per
criterion: each lane carries its own criterion's parameters (per-lane
tensors, ops/acquisition.py), and the engines keep every lane (BFGS) or
every criterion's population (SMC) apart, so flattening changes nothing a
lane computes. The derivative-free engines evaluate the criterion under
`torch.no_grad()`: a generation needs no gradient, and a graph kept alive
would hold every generation's saved tensors.

The restart and chain pools are drawn from a torch.Generator seeded from
`seed` (on the CPU, so a seed gives the same pool on every device);
`x0_seed` overwrites each pool's head, which is how the parity tests hand
both packages the same starts. The chains' own draws come from a generator
on the device, seeded from the same stream. A posterior may be the stacked
state of a hyperparameter ensemble (GPConfig.n_ensemble > 0): the criterion
then sees the mixture's mean and variance, and every engine runs on it
unchanged.

Constraints (a `ConstraintProgram`, optim/constraints.py) subtract their
dynamic penalty inside the criterion, and every engine then prefers the best
feasible final lane of each criterion's population (`_select_feasible`),
as the JAX package does. Parameters whose names start with "_" are not
acquisition parameters and are shared by every lane: the penalty's time
`_penalty_t` and PCABO's out-of-box penalty (`_pca_C`, `_pca_offset`,
`_box_lo`, `_box_hi`, `_red_lo`, `_red_hi`), and a NonparametricTrend's
forest (`_prior_state`, an RFState, and `_prior_depth`), whose traversal is
added to the residual GP's mean. "GEI<g>" names generalized EI of order g.
A posterior may also be a random forest's (`RFState` with its `RFConfig`):
the criterion then takes the forest's mean and across-tree variance, and
the engines that need no gradient (CMA, SMC, MIES) maximize it.

The multi-objective criteria: "EHVI" takes the (P, m)
moments of a multi-output posterior into `ops/ehvi.ehvi`; "qEHVI<q>" is a
joint criterion over a q-replicated space, whose (P, q * dim) candidates are
reshaped to P * q rows for one predict, then `qehvi` over the P lanes on
fixed standard-normal samples, minus the per-copy penalties summed. Their
parameters `cell_lower`, `cell_upper` (K, m) and `eps` (S, q, m) are shared
by every lane, as the reserved ones are: never repeated or indexed by lane.

A `mesh` (parallel/mesh.py) shards the BFGS, CMA and SMC pools of a single
criterion, as the JAX package does (MIES and `batch` run unsharded, on the
mesh's first device): the pool is padded with zeros to a multiple of the
mesh size, the posterior and parameters are copied to each entry's device
once a call, and each entry runs its lanes' whole engine loop there. The
chains' draws are taken for the whole padded population from the one
generator and handed out by rows, so a lane draws what it draws unsharded.
The lanes meet once, in one gather of the final population before the
best-of-population reduce; SMC's resampling, which permutes the whole chain
axis, also gathers once a round.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .._device import DEFAULT_DEVICE, resolve_device
from ..models.likelihood import GPConfig, PosteriorState, predict_gp, trend_basis
from ..models.random_forest import RFConfig, rf_predict
from ..ops.acquisition import acquisition_fn, gei
from ..ops.ehvi import ehvi, qehvi
from ..ops.optimize import maximize_restarts
from ..parallel.mesh import ParticleMesh, as_population, replicated, shard_population
from ..utils.logging import host_sync
from .cma import best_per_group, run_cma
from .mies import MIESSpec, run_mies
from .smc import run_smc


def _inject_seeds(x0: torch.Tensor, x0_seed) -> torch.Tensor:
    """Overwrite the head of a restart/chain pool (last two dims (P, dim),
    optionally with a leading q axis) with caller-supplied unit-cube rows;
    the rest of the pool stays random."""
    if x0_seed is None:
        return x0
    seeds = torch.as_tensor(np.atleast_2d(np.asarray(x0_seed, float)), dtype=x0.dtype,
                            device=x0.device)
    s = min(seeds.shape[0], x0.shape[-2])
    x0 = x0.clone()
    x0[..., :s, :] = seeds[:s]
    return x0


_PCA_KEYS = ("_pca_C", "_pca_offset", "_box_lo", "_box_hi", "_red_lo", "_red_hi")
_PRIOR_KEYS = ("_prior_state", "_prior_depth")
# the multi-objective criteria's hypercells and qEHVI's samples: one value
# for every lane, whatever its shape
_MO_KEYS = ("cell_lower", "cell_upper", "eps")


def _shared(key: str) -> bool:
    """Whether a parameter is shared by every lane (never per-lane)."""
    return key.startswith("_") or key in _MO_KEYS


def make_unit_criterion(
    encoding,
    state: PosteriorState,
    config: GPConfig,
    acq_name: str,
    acq_params: Dict,
    minimize: bool = True,
    fixed_mask: Optional[torch.Tensor] = None,
    fixed_vals: Optional[torch.Tensor] = None,
    constraints=None,
) -> Callable:
    """crit(U[P, dim], idx=None) -> value[P]: unit cube -> embed -> GP
    posterior -> acquisition. Larger is better. A parameter may be a
    per-lane tensor (L,); `idx` (P,) then names the lanes of U's rows
    (L-BFGS evaluates only the live lanes), and without it U has all L.
    Shared parameters (reserved "_" ones, the hypercells, qEHVI's samples)
    are never indexed by lane.

    constraints: optional `ConstraintProgram`; its dynamic penalty is
    subtracted from the criterion (ref parity: the `Penalized` wrapper of
    optim/__init__.py:33-52, with autograd in place of the reference's
    finite-difference penalty gradient when the callables trace).

    The criterion's `capturable` is True where it and its gradient launch
    only device work, with no read of the device and no copy from the host,
    so that an L-BFGS trip over it can be captured in a CUDA graph: the
    point GP posterior's criterion under a named acquisition (EI, PI,
    EpsilonPI, UCB, MGFI, GEI<g>), with or without PCA-BO's box penalty,
    on an all-real space, a named kernel and a constant or linear trend.
    Not so: a ConstraintProgram (its callables may read the device), a
    forest (a random forest's posterior or a NonparametricTrend's), a
    hyperparameter ensemble, EHVI and qEHVI, a kernel given as a tuple (a
    generic nu evaluates scipy on the host), the quadratic trend (it
    indexes with a host array) and a space with a discrete variable (its
    level tables are copied to the device)."""
    reserved = {k: v for k, v in acq_params.items() if k.startswith("_")}
    pca = {k: reserved[k] for k in _PCA_KEYS if k in reserved}
    penalty_t = reserved.get("_penalty_t", 10.0)
    prior_state = reserved.get("_prior_state")
    prior_config = None if prior_state is None else RFConfig(max_depth=int(reserved["_prior_depth"]))
    acq_params = {k: v for k, v in acq_params.items() if not k.startswith("_")}

    def apply_penalty(value: torch.Tensor, U2d: torch.Tensor) -> torch.Tensor:
        """value (P,) minus the dynamic penalty of unit rows (P', dim), P' an
        integer multiple of P (a joint-q criterion sums per-copy terms)."""
        if constraints is None:
            return value
        pen = constraints.penalty(U2d, penalty_t)
        if pen.shape[0] != value.shape[0]:
            pen = pen.reshape(value.shape[0], -1).sum(1)
        return value - pen

    def box_penalty(U: torch.Tensor) -> torch.Tensor:
        """Minus the total violation of the original box after inverse PCA."""
        z = pca["_red_lo"] + U * (pca["_red_hi"] - pca["_red_lo"])
        x = z @ pca["_pca_C"] + pca["_pca_offset"]
        return -((pca["_box_lo"] - x).clamp_min(0.0).sum(1) + (x - pca["_box_hi"]).clamp_min(0.0).sum(1))

    def moments(E: torch.Tensor):
        """(mu, var) (P, m) at embedded points: the GP's, plus a
        NonparametricTrend's forest mean; or a random forest's."""
        if isinstance(config, RFConfig):
            return rf_predict(state, E, config)
        mu, var = predict_gp(state, E, trend_basis(config, E), config, True)
        if prior_state is not None:  # the residual GP plus its prior's forest
            mu = mu + rf_predict(prior_state, E, prior_config)[0].reshape(mu.shape)
        return mu, var

    def subst_fixed(U: torch.Tensor) -> torch.Tensor:
        return U if fixed_mask is None else torch.where(fixed_mask[None, :] > 0, fixed_vals[None, :], U)

    if acq_name == "EHVI":
        def crit(U: torch.Tensor, idx: Optional[torch.Tensor] = None) -> torch.Tensor:
            Uf = subst_fixed(U)
            mu, var = moments(encoding.unit_to_embed(Uf))  # (P, m), maximization-oriented
            value = ehvi(mu, var.clamp_min(0.0).sqrt(), acq_params["cell_lower"],
                         acq_params["cell_upper"])
            return apply_penalty(value, Uf)

        return crit

    if acq_name.startswith("qEHVI"):
        q = int(acq_name[5:] or 1)  # the joint batch size rides in the name ("qEHVI4")

        def crit(U: torch.Tensor, idx: Optional[torch.Tensor] = None) -> torch.Tensor:
            # U: (P, q * dim) joint candidates on the replicated space; its
            # embedding is the concatenation of q per-copy blocks
            P = U.shape[0]
            Uf = subst_fixed(U)
            mu, var = moments(encoding.unit_to_embed(Uf).reshape(P * q, -1))
            value = qehvi(mu.reshape(P, q, -1), var.clamp_min(0.0).sqrt().reshape(P, q, -1),
                          acq_params["cell_lower"], acq_params["cell_upper"], acq_params["eps"])
            # per-copy constraint penalties summed over the q block
            return apply_penalty(value, Uf.reshape(P * q, -1))

        return crit

    if acq_name.startswith("GEI"):
        # the improvement order rides in the name ("GEI3"), as in the JAX package
        fn = partial(gei, g=int(acq_name[3:] or 2))
    else:
        fn = acquisition_fn(acq_name)

    def crit(U: torch.Tensor, idx: Optional[torch.Tensor] = None) -> torch.Tensor:
        Uf = subst_fixed(U)
        mu, var = moments(encoding.unit_to_embed(Uf))
        mu0, sd0 = mu[:, 0], torch.sqrt(var[:, 0].clamp_min(0.0))
        if not minimize:
            mu0 = -mu0
        params = acq_params
        if idx is not None:
            params = {k: v[idx] if torch.is_tensor(v) and v.ndim else v for k, v in params.items()}
        value = fn(mu0, sd0, **params)
        if pca:
            pen = box_penalty(U)
            value = torch.where(pen < 0.0, pen, value)
        return apply_penalty(value, Uf)

    crit.capturable = (isinstance(config, GPConfig) and config.n_ensemble == 0
                       and prior_state is None and constraints is None
                       and isinstance(config.kernel, str) and config.trend in ("constant", "linear")
                       and bool(np.all(encoding.is_real)))
    return crit


def _select_feasible(constraints, X, F, x_fallback, f_fallback, groups: int = 1):
    """The best FEASIBLE final lane of each of `groups` equal populations of
    X (groups * P, dim) with maximized values F (groups * P,); a group with
    no feasible lane keeps its fallback (x_fallback (groups, dim), f_fallback
    (groups,); or (dim,) and () for one group), the penalized best
    (ref parity: optim/__init__.py:124-126 feasibility filter). Masking is
    per group, so one criterion's feasible lanes never stand in for
    another's. On a q-replicated space (a joint-q criterion's X is
    (P, q * dim)) a lane is feasible when all its copies are. Returns
    ((groups, dim), (groups,))."""
    d = constraints.encoding.dim
    if X.shape[-1] != d:  # a q-replicated space: every copy must be feasible
        feas = constraints.feasible_in_program(X.reshape(-1, d)).reshape(X.shape[0], -1).all(1)
    else:
        feas = constraints.feasible_in_program(X)
    masked = torch.where(feas, F, torch.full_like(F, -math.inf))
    xb, fb = best_per_group(X, masked, groups, largest=True)
    any_f = feas.reshape(groups, -1).any(1)
    xf, ff = x_fallback.reshape(groups, -1), f_fallback.reshape(groups)
    return torch.where(any_f[:, None], xb, xf), torch.where(any_f, fb, ff)


def _bfgs_lanes(crit, x0, max_iter: int):
    """Every lane's end (x, value) of one batched L-BFGS from x0. x0 and
    `crit` are as `run_cma` takes them: each mesh entry runs its lanes on
    its device (the lanes are independent), then one gather. On the
    one-entry mesh a `capturable` criterion's CUDA float32 run replays its
    trips as a CUDA graph (ops/optimize.py `_lbfgs_graphed`)."""
    pop = as_population(x0)
    one_entry = pop.mesh.size == 1

    def lanes(crit, x):
        zeros = torch.zeros(x.shape[-1], dtype=x.dtype, device=x.device)
        res = maximize_restarts(crit, x, zeros, zeros + 1.0, max_iter=max_iter, lane_index=True,
                                capturable=one_entry and getattr(crit, "capturable", False))
        return res.x, res.fun

    ends = pop.mesh.map(lanes, pop.mesh.per_entry(crit), pop.chunks)
    return tuple(pop.mesh.gather([e[0] for e in ends], [e[1] for e in ends]))


def _bfgs_argmax(crit, x0, q: int, max_iter: int, constraints=None):
    """q criteria x R restarts (x0 (q * R, d)) as one batched L-BFGS;
    returns each criterion's winner and value, (q, d) and (q,)."""
    x, f = _bfgs_lanes(crit, x0, max_iter)
    # non-finite lanes are +inf in the minimization, so -inf here
    xb, fb = best_per_group(x, f, q, largest=True)
    if constraints is not None:
        with torch.no_grad():
            xb, fb = _select_feasible(constraints, x, f, xb, fb, q)
    return xb, fb


def _es_select(constraints, xb, fb, xs, fs, q: int):
    """Each group's winner of a minimizing ES (best xb (q, d), fb (q,); final
    population xs, fs), preferring feasible finals; returns the maximized
    criterion's winner and value."""
    if constraints is not None:
        xb, nfb = _select_feasible(constraints, xs, -fs, xb, -fb, q)
        return xb, nfb
    return xb, -fb


def _negated(crits):
    return [lambda U, crit=crit: -crit(U) for crit in crits]


# the ES engines' box is the unit cube, as numbers: a bound carries no device
@torch.no_grad()
def _cma_argmax(gen, crits, x0, q: int, n_generations: int, constraints=None):
    _, _, xs, fs = run_cma(gen, _negated(crits), x0, 0.0, 1.0, n_generations)
    xb, fb = best_per_group(xs, fs, q, largest=False)
    return _es_select(constraints, xb, fb, xs, fs, q)


@torch.no_grad()
def _smc_argmax(gen, crits, x0, q: int, n_rounds: int, n_moves: int, constraints=None):
    xb, fb, xs, fs = run_smc(gen, _negated(crits), x0, 0.0, 1.0, n_rounds, n_moves, groups=q)
    return _es_select(constraints, xb.reshape(q, -1), fb.reshape(q), xs, fs, q)


@torch.no_grad()
def _mies_argmax(gen, crit, spec, n_restarts: int, n_generations: int, dtype, device,
                 constraints=None):
    xb, fb, xs, fs = run_mies(gen, lambda U: -crit(U), spec, n_restarts=n_restarts,
                              n_generations=n_generations, dtype=dtype, device=device)
    return _es_select(constraints, xb[None], fb[None], xs, fs, 1)


class AcquisitionArgmax:
    """Maximizes acquisition criteria over a `SpaceEncoding`'s unit cube.

    method: 'BFGS' (gradient multi-start; continuous spaces),
            'OnePlusOne_Cholesky_CMA' (population ES; any space),
            'MIES' (mixed-integer ES, optim/mies.py),
            'SMC' (CMA chains with annealed systematic resampling between
            move blocks, optim/smc.py),
            'auto' -- BFGS for all-real spaces, MIES otherwise.
    Any other name runs the CMA engine, as in the JAX package.

    constraints: optional `ConstraintProgram` applied to every criterion
    this instance maximizes: the dynamic penalty inside the criterion and
    the reference's feasibility preference on the final lanes.
    """

    def __init__(
        self,
        encoding,
        method: str = "auto",
        n_restart: Optional[int] = None,
        max_FEs: Optional[int] = None,
        n_chains: Optional[int] = None,
        seed: int = 0,
        mesh=None,
        constraints=None,
        device=DEFAULT_DEVICE,
    ):
        self.device = resolve_device(device, mesh)
        self.mesh = mesh
        self.constraints = constraints
        self.encoding = encoding
        dim = encoding.dim
        if method == "auto":
            method = "BFGS" if bool(np.all(encoding.is_real)) else "MIES"
        self.method = method
        self.n_restart = n_restart or 5 * dim
        # ES budget ~1000*dim evals split over chains x generations
        self.n_chains = n_chains or max(32, 4 * dim)
        budget = max_FEs or (1000 * dim if method != "BFGS" else 100 * dim)
        self.max_FEs = budget
        self.n_generations = max(16, int(budget // self.n_chains))
        self.max_iter = 40
        # SMC: the same chain budget split into resampling rounds x move blocks
        self.n_smc_rounds = 6
        self.n_smc_moves = max(4, self.n_generations // (self.n_smc_rounds + 1))
        self._spec = MIESSpec.from_encoding(encoding)
        # MIES: n_restart runs of a (4, 10)-ES; lambda evals a generation
        self.n_mies_restarts = max(4, (n_restart or 5 * dim) // 4)
        self.n_mies_generations = max(16, int(budget // (10 * self.n_mies_restarts)))
        self._gen = torch.Generator().manual_seed(int(seed))

    def _fixed(self, fixed):
        if not fixed:
            return None, None
        dim = self.encoding.dim
        fm, fv = np.zeros(dim), np.zeros(dim)
        for j, u in fixed.items():
            fm[j], fv[j] = 1.0, u
        with host_sync(2):
            return (torch.as_tensor(fm, dtype=self.encoding.dtype, device=self.device),
                    torch.as_tensor(fv, dtype=self.encoding.dtype, device=self.device))

    def _pool(self, q: int, P: int, x0_seed) -> torch.Tensor:
        """(q * P, dim) starts from the CPU generator, seeds at each head."""
        x0 = torch.rand((q, P, self.encoding.dim), generator=self._gen, dtype=self.encoding.dtype)
        x0 = _inject_seeds(x0, x0_seed).reshape(q * P, -1)
        with host_sync():
            return x0.to(self.device)

    def _chain_gen(self) -> torch.Generator:
        seed = int(torch.randint(0, 2**62, (1,), generator=self._gen))
        return torch.Generator(device=self.device).manual_seed(seed)

    def _run(self, state, config, acq_name, params: Dict, q: int, minimize, fixed, x0_seed,
             batch: bool):
        """Every engine on q criteria whose parameters are per-lane tensors
        (numbers outside a batch); returns (u (q, dim) on the host, values (q,))."""
        if self.method == "BFGS" and isinstance(config, RFConfig):
            raise ValueError("the BFGS engine needs a gradient, and a random forest's "
                             "criterion is piecewise constant: use MIES, CMA or SMC")
        fixed_mask, fixed_vals = self._fixed(fixed)
        cons = self.constraints
        # a single criterion's BFGS, CMA or SMC pool shards over the mesh;
        # MIES and batches run as the one-entry mesh on self.device
        sharded = self.mesh is not None and not batch and self.method != "MIES"
        mesh = self.mesh if sharded else ParticleMesh([self.device])
        # the posterior, parameters and fixed values: one copy a device a call
        put = replicated(mesh).put
        crits = [make_unit_criterion(self.encoding, s, config, acq_name, p, minimize, fm, fv, cons)
                 for s, p, fm, fv in zip(put(state), put(params), put(fixed_mask), put(fixed_vals))]

        def pool(P):
            return shard_population(self._pool(q, P, x0_seed), mesh)

        if self.method == "BFGS":
            us, vals = _bfgs_argmax(crits, pool(self.n_restart), q, self.max_iter, cons)
        elif self.method == "SMC":
            us, vals = _smc_argmax(self._chain_gen(), crits, pool(self.n_chains), q,
                                   self.n_smc_rounds, self.n_smc_moves, cons)
        elif self.method == "MIES" and not batch:
            us, vals = _mies_argmax(self._chain_gen(), crits[0], self._spec, self.n_mies_restarts,
                                    self.n_mies_generations, self.encoding.dtype, self.device, cons)
        else:  # the CMA engine; a batch under MIES runs it too, as in the JAX package
            us, vals = _cma_argmax(self._chain_gen(), crits, pool(self.n_chains), q,
                                   self.n_generations, cons)
        if fixed_mask is not None:
            us = torch.where(fixed_mask > 0, fixed_vals, us)
        us = self.encoding.quantize_unit(us).clamp(0.0, 1.0)
        with host_sync(2):
            us, vals = us.detach().cpu(), vals.detach().cpu()
        return us.numpy(), vals.double().numpy()

    def _lane_params(self, acq_params: Dict, reps: int = 1) -> Dict:
        """Parameters as tensors on the device; a list of q values becomes a
        per-lane vector, each value repeated for its criterion's `reps`
        lanes. Shared parameters (reserved "_" ones, the hypercells and
        qEHVI's samples) pass to every lane as they are."""
        def one(k, v):
            if k in _PRIOR_KEYS:  # a prior's forest passes unchanged
                return v
            t = torch.as_tensor(np.asarray(v, dtype=np.float64), dtype=self.encoding.dtype)
            t = t.repeat_interleave(reps) if t.ndim and not _shared(k) else t
            with host_sync():
                return t.to(self.device)

        return {k: one(k, v) for k, v in acq_params.items()}

    def __call__(
        self,
        state: PosteriorState,
        config: GPConfig,
        acq_name: str,
        acq_params: Dict,
        minimize: bool = True,
        fixed: Optional[Dict[int, float]] = None,
        x0_seed: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, float]:
        """Returns (u_best[dim] on the unit cube, criterion value).
        x0_seed: optional (s, dim) unit-cube rows injected at the head of
        the restart/chain pool (MIES draws its own population)."""
        us, vals = self._run(state, config, acq_name, self._lane_params(acq_params), 1,
                             minimize, fixed, x0_seed, batch=False)
        return us[0], float(vals[0])

    def batch(
        self,
        state: PosteriorState,
        config: GPConfig,
        acq_name: str,
        acq_params_list: List[Dict],
        minimize: bool = True,
        fixed: Optional[Dict[int, float]] = None,
        x0_seed: Optional[np.ndarray] = None,
    ):
        """q criteria (same acquisition, different parameters) maximized as
        one population. Returns (list of q unit vectors, list of q values).
        x0_seed rows are injected at the head of EVERY criterion's pool."""
        q = len(acq_params_list)
        keys = set(acq_params_list[0])
        if any(set(p) != keys for p in acq_params_list):
            raise ValueError("all parameter dicts must share the same keys")
        shared = {k: acq_params_list[0][k] for k in keys if _shared(k)}
        if any(p[k] is not v and (k == "_prior_state" or not np.array_equal(np.asarray(p[k]),
                                                                             np.asarray(v)))
               for p in acq_params_list for k, v in shared.items()):
            raise ValueError("shared parameters (reserved '_' ones, hypercells, samples) must be "
                             "the same for every criterion")
        P = {"BFGS": self.n_restart}.get(self.method, self.n_chains)
        lanes = {k: [p[k] for p in acq_params_list] for k in keys if not _shared(k)}
        params = self._lane_params({**lanes, **shared}, reps=P)
        us, vals = self._run(state, config, acq_name, params, q, minimize, fixed, x0_seed,
                             batch=True)
        return [us[i] for i in range(q)], [float(v) for v in vals]

"""Population-vectorized Mixed-Integer Evolution Strategy (MIES).

Counterpart of bayesian_optimization_tpu/optim/mies.py: a (mu=4,
lambda=10)-ES over mixed real/integer/categorical spaces (ref parity:
mies.py:14-344); genome = x ++ per-real sigma ++ per-int eta ++ categorical
flip probability; self-adaptive log-normal strategy mutation with
tau = 1/sqrt(2 N), tau' = 1/sqrt(2 sqrt(N)); Gaussian real mutation with
the |dx/N| step-size correction, double-geometric integer mutation, logistic
flip-probability mutation clipped to [1/(3 N_d), 1/2]; dominant
recombination for x, intermediate for the strategy parameters; (mu, lambda)
selection with optional elitism.

R independent restarts x lambda offspring form one (R, lambda, dim) batch
on the unit-cube representation of the space: one criterion evaluation per
generation for the whole population. Draws come from the state's
`torch.Generator`; `_variation` also takes its thirteen draws as a
`MIESDraws`, which is how the tests hand it the JAX package's streams.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .._device import DEFAULT_DEVICE, resolve_device
from ..utils.penalty import reflect_into_box, violation_host


class MIESState(NamedTuple):
    x: torch.Tensor         # (R, mu, dim) unit-cube parents
    strength: torch.Tensor  # (R, mu, dim) sigma/eta/P per column type
    f: torch.Tensor         # (R, mu)
    gen: torch.Generator


class MIESSpec(NamedTuple):
    """Static per-dimension type info derived from a SpaceEncoding."""

    real_mask: tuple
    int_mask: tuple
    cat_mask: tuple
    n_levels: tuple

    @classmethod
    def from_encoding(cls, enc) -> "MIESSpec":
        real = enc.is_real
        ordered = (~enc.is_real) & (~enc.is_onehot)
        cat = (~enc.is_real) & enc.is_onehot
        return cls(
            real_mask=tuple(bool(b) for b in real),
            int_mask=tuple(bool(b) for b in ordered),
            cat_mask=tuple(bool(b) for b in cat),
            n_levels=tuple(int(n) for n in enc.n_levels),
        )


class MIESDraws(NamedTuple):
    """The random draws of one `_variation`, in the JAX package's key order:
    parents p1, p2 (R, lam) in [0, mu); uniforms dom (R, lam, dim); normals
    g_r, g_i, g_d (R, lam, 1) and l_r, l_i, Z (R, lam, dim); the two
    geometric samplers' uniforms geo1, geo2 in [1e-12, 1); uniforms flip,
    u_new (R, lam, dim)."""

    p1: torch.Tensor
    p2: torch.Tensor
    dom: torch.Tensor
    g_r: torch.Tensor
    l_r: torch.Tensor
    g_i: torch.Tensor
    l_i: torch.Tensor
    g_d: torch.Tensor
    Z: torch.Tensor
    geo1: torch.Tensor
    geo2: torch.Tensor
    flip: torch.Tensor
    u_new: torch.Tensor


def _taus(n: int) -> Tuple[float, float]:
    if n == 0:
        return 0.0, 0.0
    return float(1.0 / np.sqrt(2.0 * n)), float(1.0 / np.sqrt(2.0 * np.sqrt(n)))


def _geometric(u: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Geometric(p) samples by inverse CDF from uniforms u in (0, 1)."""
    return torch.floor(torch.log(u) / torch.log1p(-p.clamp(1e-12, 1 - 1e-12))) + 1.0


def _draw(gen: torch.Generator, R: int, lam: int, mu: int, dim: int, like: torch.Tensor) -> MIESDraws:
    kw = dict(generator=gen, dtype=like.dtype, device=like.device)
    big, one = (R, lam, dim), (R, lam, 1)

    def geo_u():
        return 1e-12 + (1.0 - 1e-12) * torch.rand(big, **kw)

    return MIESDraws(
        p1=torch.randint(0, mu, (R, lam), generator=gen, device=like.device),
        p2=torch.randint(0, mu, (R, lam), generator=gen, device=like.device),
        dom=torch.rand(big, **kw), g_r=torch.randn(one, **kw), l_r=torch.randn(big, **kw),
        g_i=torch.randn(one, **kw), l_i=torch.randn(big, **kw), g_d=torch.randn(one, **kw),
        Z=torch.randn(big, **kw), geo1=geo_u(), geo2=geo_u(),
        flip=torch.rand(big, **kw), u_new=torch.rand(big, **kw),
    )


def _masks(spec: MIESSpec, like: torch.Tensor):
    def t(v):
        return torch.as_tensor(np.asarray(v, dtype=np.float64), dtype=like.dtype, device=like.device)

    return t(spec.real_mask), t(spec.int_mask), t(spec.cat_mask), t(spec.n_levels)


def init_mies(gen: torch.Generator, spec: MIESSpec, R: int, mu: int, dtype=torch.float32,
              fun: Optional[Callable] = None, x0: Optional[torch.Tensor] = None,
              device=None) -> MIESState:
    dim = len(spec.real_mask)
    if x0 is None:
        x = torch.rand((R, mu, dim), generator=gen, dtype=dtype, device=device or gen.device)
    else:
        x = x0
    real, intm, catm, nlev = _masks(spec, x)
    n_cat = max(1, int(sum(spec.cat_mask)))
    # sigma0 = 0.05 of unit range; eta0 = 0.05 * n_levels; P0 = 1/N_d
    strength = real * 0.05 + intm * 0.05 * nlev.clamp_min(1.0) + catm * (1.0 / n_cat)
    strength = strength.expand(R, mu, dim)
    if fun is not None:
        f = fun(x.reshape(R * mu, dim)).reshape(R, mu)
    else:
        f = torch.full((R, mu), float("inf"), dtype=x.dtype, device=x.device)
    return MIESState(x=x, strength=strength, f=f, gen=gen)


def mies_generation(state: MIESState, fun: Callable, spec: MIESSpec, lam: int,
                    elitism: bool = False) -> MIESState:
    """One (mu, lambda) generation for all R restarts at once; `fun` maps
    (N, dim) unit batches to (N,) values to MINIMIZE."""
    R, mu, dim = state.x.shape
    state, x_off, s_off = _variation(state, spec, lam)
    f_off = fun(x_off.reshape(R * lam, dim)).reshape(R, lam)
    return _mies_select(state, x_off, s_off, f_off, elitism)


def run_mies(
    gen: torch.Generator,
    fun: Callable,
    spec: MIESSpec,
    n_restarts: int = 8,
    n_generations: int = 50,
    mu: int = 4,
    lam: int = 10,
    elitism: bool = False,
    dtype=torch.float32,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Minimize `fun` over the unit cube with R parallel (mu, lambda)-MIES
    runs; returns (x_best[dim], f_best, final_x[R*mu, dim], final_f[R*mu])."""
    state = init_mies(gen, spec, n_restarts, mu, dtype, fun=fun, device=device)
    for _ in range(n_generations):
        state = mies_generation(state, fun, spec, lam, elitism)
    flat_f = state.f.reshape(-1)
    flat_x = state.x.reshape(-1, state.x.shape[-1])
    best = torch.argmin(flat_f)
    return flat_x[best], flat_f[best], flat_x, flat_f


def _variation(state: MIESState, spec: MIESSpec, lam: int, draws: Optional[MIESDraws] = None):
    """Recombination and mutation: (state, x_off (R, lam, dim), s_off)."""
    R, mu, dim = state.x.shape
    real, intm, catm, nlev = _masks(spec, state.x)
    nlev = nlev.clamp_min(1.0)
    n_r, n_i, n_d = int(sum(spec.real_mask)), int(sum(spec.int_mask)), int(sum(spec.cat_mask))
    tau_r, taup_r = _taus(n_r)
    tau_i, taup_i = _taus(n_i)
    tau_d, _ = _taus(n_d)
    dr = draws if draws is not None else _draw(state.gen, R, lam, mu, dim, state.x)

    def take(arr, idx):
        return torch.gather(arr, 1, idx.long()[:, :, None].expand(R, lam, dim))

    x1, x2 = take(state.x, dr.p1), take(state.x, dr.p2)
    s1, s2 = take(state.strength, dr.p1), take(state.strength, dr.p2)
    x = torch.where(dr.dom > 0.5, x2, x1)
    strength = 0.5 * (s1 + s2)
    sigma = strength * torch.exp(tau_r * dr.g_r + taup_r * dr.l_r)
    eta = torch.minimum(strength * torch.exp(tau_i * dr.g_i + taup_i * dr.l_i), nlev)
    P = 1.0 / (1.0 + (1.0 - strength) / strength.clamp(1e-8, 1.0) * torch.exp(-tau_d * dr.g_d))
    P = P.clamp(1.0 / (3.0 * max(n_d, 1)), 0.5)
    x_real_new = reflect_into_box(x + sigma * dr.Z, 0.0, 1.0)
    Z_safe = torch.where(dr.Z.abs() > 1e-12, dr.Z, torch.ones_like(dr.Z))
    sigma_corr = ((x_real_new - x) / Z_safe).abs()
    lev = torch.minimum(torch.floor(x.clamp(0, 1) * nlev), nlev - 1.0)
    eta_n = eta / max(n_i, 1)
    p_geo = 1.0 - eta_n / (1.0 + torch.sqrt(1.0 + eta_n**2))
    step = _geometric(dr.geo1, p_geo) - _geometric(dr.geo2, p_geo)
    lev_new = reflect_into_box(lev + step, 0.0, nlev - 1.0)
    x_int_new = (torch.round(lev_new) + 0.5) / nlev  # round half to even, as jnp.round
    x_cat_new = torch.where(dr.flip < P, dr.u_new, x)
    x_off = real * x_real_new + intm * x_int_new + catm * x_cat_new
    s_off = real * sigma_corr + intm * eta + catm * P
    return state, x_off, s_off


def _mies_select(state: MIESState, x_off, s_off, f_off, elitism: bool) -> MIESState:
    """(mu, lambda) or, with elitism, (mu + lambda) selection per restart;
    a stable sort, as jnp.argsort's, so ties keep their pool order."""
    mu = state.x.shape[1]
    f_off = torch.where(torch.isfinite(f_off), f_off, torch.full_like(f_off, float("inf")))
    if elitism:
        pool_x = torch.cat([state.x, x_off], dim=1)
        pool_s = torch.cat([state.strength, s_off], dim=1)
        pool_f = torch.cat([state.f, f_off], dim=1)
    else:
        pool_x, pool_s, pool_f = x_off, s_off, f_off
    order = torch.argsort(pool_f, dim=1, stable=True)[:, :mu]
    idx = order[:, :, None].expand(-1, -1, pool_x.shape[-1])
    return MIESState(
        x=torch.gather(pool_x, 1, idx), strength=torch.gather(pool_s, 1, idx),
        f=torch.gather(pool_f, 1, order), gen=state.gen,
    )


class MIES:
    """Host-facing optimizer with the reference's surface (search_space,
    obj_func, eq/ineq constraints, max_eval) for black-box objectives; the
    population arithmetic is the batched code above, on `device`, with one
    host callback per generation for the whole offspring batch."""

    def __init__(
        self,
        search_space,
        obj_func: Callable,
        eq_func: Optional[Callable] = None,
        ineq_func: Optional[Callable] = None,
        x0=None,
        ftarget: Optional[float] = None,
        max_eval: float = np.inf,
        minimize: bool = True,
        elitism: bool = False,
        mu_: int = 4,
        lambda_: int = 10,
        n_restarts: int = 1,
        verbose: bool = False,
        eval_type: str = "list",
        random_seed: int = 0,
        device=DEFAULT_DEVICE,
    ):
        self.device = resolve_device(device)
        self.space = search_space
        self.encoding = search_space.encoding()
        self.spec = MIESSpec.from_encoding(self.encoding)
        self.obj_func = obj_func
        self.eq_func, self.ineq_func = eq_func, ineq_func
        self.minimize = minimize
        self.ftarget = ftarget
        self.max_eval = float(max_eval)
        self.elitism = elitism
        self.mu_, self.lambda_ = mu_, lambda_
        self.n_restarts = n_restarts
        self.eval_count = 0
        self.iter_count = 0
        self._eval_type = eval_type
        self.verbose = verbose
        self.stop_dict = {}
        self._gen = torch.Generator(device=self.device).manual_seed(int(random_seed))
        self._x0 = x0
        self.xopt, self.fopt = None, np.inf

    def _eval_host(self, U: np.ndarray) -> np.ndarray:
        X = self.encoding.decode_unit(U)
        vals = np.empty(len(X))
        for i, row in enumerate(X):
            x = list(row)
            if self._eval_type == "dict":
                x = dict(zip(self.space.var_name, x))
            y = float(self.obj_func(x))
            if not self.minimize:
                y = -y
            if self.eq_func is not None or self.ineq_func is not None:
                pen = violation_host(list(row), self.eq_func, self.ineq_func)
                y += 0.5 * (self.iter_count + 1) * pen
            vals[i] = y
        self.eval_count += len(X)
        return vals

    def _f(self, vals: np.ndarray, *shape) -> torch.Tensor:
        return torch.as_tensor(vals, dtype=torch.float32, device=self.device).reshape(*shape)

    def optimize(self):
        R, mu, lam = self.n_restarts, self.mu_, self.lambda_
        dim = self.encoding.dim
        x0 = None
        if self._x0 is not None:
            u0 = self.encoding.encode_unit(np.atleast_2d(np.asarray(self._x0, dtype=object)))
            x0 = self._f(u0[0], dim).expand(R, mu, dim)
        state = init_mies(self._gen, self.spec, R, mu, x0=x0, device=self.device)
        f0 = self._eval_host(state.x.reshape(R * mu, dim).cpu().double().numpy())
        state = state._replace(f=self._f(f0, R, mu))
        while self.eval_count < self.max_eval:
            self.iter_count += 1
            state, x_off, s_off = _variation(state, self.spec, lam)
            f_off = self._eval_host(x_off.reshape(R * lam, dim).cpu().double().numpy())
            state = _mies_select(state, x_off, s_off, self._f(f_off, R, lam), self.elitism)
            fbest = float(state.f.min())
            if self.ftarget is not None and fbest <= (self.ftarget if self.minimize else -self.ftarget):
                self.stop_dict["ftarget"] = fbest
                break
        self.stop_dict.setdefault("max_eval", self.eval_count >= self.max_eval)
        flat_f = state.f.reshape(-1).cpu().double().numpy()
        i = int(np.argmin(flat_f))
        u = state.x.reshape(-1, dim)[i].cpu().double().numpy()
        self.xopt = list(self.encoding.decode_unit(u[None, :])[0])
        self.fopt = float(flat_f[i]) * (1.0 if self.minimize else -1.0)
        return self.xopt, self.fopt, self.stop_dict

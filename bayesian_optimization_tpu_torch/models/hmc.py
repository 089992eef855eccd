"""Adaptive HMC, NUTS and mean-field VI over GP hyperparameters.

Counterpart of bayesian_optimization_tpu/models/hmc.py: dual-averaging
step-size adaptation to a target acceptance rate (Hoffman & Gelman 2014:
gamma 0.05, t0 10, kappa 0.75), a diagonal mass from the Welford variance
of the warm-up draws, HMC trajectory lengths jittered in [L/2 + 1, L] and
shared by all chains, the iterative NUTS (a streaming leapfrog per leaf, a
power-of-two stack of block heads for the exact sub-tree U-turn checks,
progressive multinomial selection within a sub-tree, biased progressive
selection across doublings), and ADVI with Adam. Box-bounded parameters are
sampled in unconstrained coordinates through a sigmoid, with its
log-Jacobian added to the target.

Where the JAX package vmapped a per-chain `log_prob_fn`, here
`log_prob_fn` is batched, (C, d) -> (C,): the C chains are lanes of one call
(on the card, one batched GP likelihood through both hand kernels), and the
gradient in z is one `torch.autograd.grad` over the sum, the lanes being
independent. The JAX package's device loops are Python loops. NUTS runs
each doubling for all C chains under an `active` mask and syncs with the
host once a doubling, never a leaf; a finished chain's tree is frozen by
`torch.where`, as vmap's select froze it. A leaf keeps its gradient for the
next leapfrog, so a leapfrog costs one likelihood and gradient (the JAX
package evaluated the gradient at both ends of every step).

Draws: a transition's randomness is one fixed-shape block taken from a
`Draws` object, by default over an explicit torch.Generator on the chains'
device -- HMC's momentum, trajectory length and accept uniforms; NUTS's
momentum, direction uniforms, accept uniforms and the leaf uniforms of
every doubling (2^max_depth - 1 at most); VI's normals of every step. An
object with the same methods can stand in for it, which is how the tests
replay the JAX package's draws.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

_GAMMA, _T0, _KAPPA = 0.05, 10.0, 0.75  # dual averaging (Hoffman & Gelman 2014)


class HMCResult(NamedTuple):
    samples: torch.Tensor       # (n_samples, n_chains, d) in box coordinates
    accept_rate: torch.Tensor   # (n_chains,)
    step_size: torch.Tensor     # (n_chains,)
    log_prob: torch.Tensor      # (n_samples, n_chains)
    inv_mass: torch.Tensor      # (n_chains, d) adapted diagonal inverse mass


class NUTSResult(NamedTuple):
    samples: torch.Tensor      # (n_samples, n_chains, d) box coordinates
    accept_rate: torch.Tensor  # (n_chains,) mean Metropolis alpha proxy
    step_size: torch.Tensor    # (n_chains,)
    log_prob: torch.Tensor     # (n_samples, n_chains)
    mean_depth: torch.Tensor   # (n_chains,) average tree depth
    inv_mass: torch.Tensor     # (n_chains, d), carried into the next refit's sampler


def effective_sample_size(samples) -> "np.ndarray":
    """Per-dimension multi-chain ESS (Geyer initial-positive-sequence
    estimator over the chain-mean autocorrelation), host-side numpy.

    samples: (S, C, d) array of draws. Returns (d,) ESS estimates. The
    reference has no sampler so no counterpart exists; this is the standard
    diagnostic the round-5 verdict asked `bench.py --nuts` to report."""
    x = np.asarray(samples, dtype=float)
    S, C, d = x.shape
    if S < 4:
        return np.full(d, float(S * C))
    x = x - x.mean(axis=0, keepdims=True)  # demean per chain
    ess = np.empty(d)
    nfft = int(2 ** np.ceil(np.log2(2 * S)))
    for j in range(d):
        f = np.fft.rfft(x[:, :, j], n=nfft, axis=0)
        acov = np.fft.irfft(f * np.conj(f), n=nfft, axis=0)[:S].real
        acov /= np.arange(S, 0, -1)[:, None]
        var0 = acov[0].mean()
        if var0 <= 0:
            ess[j] = float(S * C)
            continue
        rho = acov.mean(axis=1) / var0  # chain-averaged autocorrelation
        # Geyer: sum consecutive pairs while they stay positive
        tau = 1.0
        for t in range(1, S - 1, 2):
            pair = rho[t] + rho[t + 1]
            if pair < 0:
                break
            tau += 2.0 * pair
        ess[j] = S * C / max(tau, 1.0)
    return ess


class Draws:
    """The samplers' randomness, one fixed-shape block a call, from `gen`
    (a torch.Generator on the chains' device)."""

    def __init__(self, gen: torch.Generator):
        self.gen = gen

    def _uniform(self, shape, dtype) -> torch.Tensor:
        return torch.rand(shape, generator=self.gen, dtype=dtype, device=self.gen.device)

    def normal(self, shape, dtype) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen, dtype=dtype, device=self.gen.device)

    def hmc(self, C: int, d: int, n_leapfrog: int, dtype):
        """One HMC transition: momentum normals (C, d), the trajectory length
        in [n_leapfrog // 2 + 1, n_leapfrog] shared by all chains, accept
        uniforms (C,)."""
        normal = self.normal((C, d), dtype)
        L = torch.randint(n_leapfrog // 2 + 1, n_leapfrog + 1, (1,), generator=self.gen,
                          device=self.gen.device)
        return normal, int(L), self._uniform((C,), dtype)

    def nuts(self, C: int, d: int, max_depth: int, dtype):
        """One NUTS transition: momentum normals (C, d); direction uniforms
        (C, max_depth), doubling j to the right where < 0.5; accept uniforms
        (C, max_depth); leaf uniforms (C, 2^max_depth - 1), doubling j's 2^j
        at columns [2^j - 1, 2^(j+1) - 1)."""
        return (self.normal((C, d), dtype), self._uniform((C, max_depth), dtype),
                self._uniform((C, max_depth), dtype), self._uniform((C, 2 ** max_depth - 1), dtype))

    def vi(self, n_steps: int, n_mc: int, d: int, dtype) -> torch.Tensor:
        """The Monte-Carlo normals of every ADVI step, (n_steps, n_mc, d)."""
        return self.normal((n_steps, n_mc, d), dtype)


def _to_box(z, lo, hi):
    return lo + (hi - lo) * torch.sigmoid(z)


def _log_jac(z, lo, hi):
    """log |d box / d z| for the sigmoid reparameterization."""
    return (torch.log(hi - lo) + F.logsigmoid(z) + F.logsigmoid(-z)).sum(-1)


def _value_and_grad(log_prob_fn, lo, hi) -> Callable:
    """z (C, d) -> (logp (C,), d logp / dz (C, d)) of the unconstrained
    target: one batched call of log_prob_fn and one autograd.grad over the
    sum (the chains are independent lanes)."""

    def value_and_grad(z):
        with torch.enable_grad():
            z = z.detach().requires_grad_(True)
            lp = log_prob_fn(_to_box(z, lo, hi)) + _log_jac(z, lo, hi)
            (g,) = torch.autograd.grad(lp.sum(), z)
        return lp.detach(), g

    return value_and_grad


class _Chains(NamedTuple):
    z: torch.Tensor            # (C, d) unconstrained state
    logp: torch.Tensor         # (C,) target at z
    grad: torch.Tensor         # (C, d) its gradient, kept for the next leapfrog
    log_eps: torch.Tensor
    log_eps_bar: torch.Tensor
    h_bar: torch.Tensor
    m1: torch.Tensor           # Welford running mean of z (for the mass)
    m2: torch.Tensor           # running sum of squared deviations
    count: torch.Tensor
    inv_mass: torch.Tensor     # (C, d)


def _adapt(c: _Chains, alpha, it: int, mu_da, target_accept: float) -> _Chains:
    """Dual averaging of log eps on E[alpha], and the Welford update of the
    mass statistics, per chain."""
    t = it + 1.0 + _T0
    h_bar = (1.0 - 1.0 / t) * c.h_bar + (target_accept - alpha) / t
    log_eps = mu_da - math.sqrt(it + 1.0) / _GAMMA * h_bar
    w = (it + 1.0) ** (-_KAPPA)
    log_eps_bar = w * log_eps + (1.0 - w) * c.log_eps_bar
    count = c.count + 1.0
    delta = c.z - c.m1
    m1 = c.m1 + delta / count[:, None]
    m2 = c.m2 + delta * (c.z - m1)
    return c._replace(log_eps=log_eps, log_eps_bar=log_eps_bar, h_bar=h_bar, m1=m1, m2=m2,
                      count=count)


def _where(mask, new, old):
    """Per-chain select between two tensors whose leading axis is the chain."""
    return torch.where(mask.reshape(-1, *([1] * (new.ndim - 1))), new, old)


def _run_chains(step, value_and_grad, warm_vg, x0, lo, hi, n_warmup, n_samples, thin,
                init_inv_mass, init_step_size, n_warmup2, target_accept, fast_path):
    """The warm-up and sampling schedule shared by HMC and NUTS. step(c, vg)
    -> (c, alpha (C,), stat (C,)) is one transition on the target vg.
    Phase 1 adapts eps under the identity mass on the warm-up target while
    the draws' variance is collected, then the mass is frozen; phase 2
    (skipped on HMC's fast path) re-adapts eps from scratch on the true
    target; a carried mass skips phase 1. Returns the final chains, the
    recorded (z, logp) of every `thin`-th sampling transition, and the sums
    of alpha and stat over the sampling transitions."""
    C, d = x0.shape
    dtype, dev = x0.dtype, x0.device
    frac = ((x0 - lo) / (hi - lo).clamp_min(1e-30)).clamp(1e-4, 1 - 1e-4)
    z0 = torch.log(frac) - torch.log1p(-frac)
    eps0 = (torch.full((C,), 0.05, dtype=dtype, device=dev) if init_step_size is None
            else torch.as_tensor(init_step_size, dtype=dtype, device=dev).expand(C))
    mu_da = torch.log(10.0 * eps0)
    zeros = torch.zeros((C,), dtype=dtype, device=dev)

    def fresh(vg, inv_mass):
        lp, g = vg(z0)
        return _Chains(z=z0, logp=lp, grad=g, log_eps=torch.log(eps0), log_eps_bar=torch.log(eps0),
                       h_bar=zeros, m1=torch.zeros((C, d), dtype=dtype, device=dev),
                       m2=torch.ones((C, d), dtype=dtype, device=dev), count=zeros,
                       inv_mass=inv_mass)

    if init_inv_mass is not None:
        # carried adaptation state from the previous refit: skip phase 1
        c = fresh(value_and_grad,
                  torch.as_tensor(init_inv_mass, dtype=dtype, device=dev).expand(C, d))
    else:
        c = fresh(warm_vg, torch.ones((C, d), dtype=dtype, device=dev))
        for i in range(n_warmup):
            c, alpha, _ = step(c, warm_vg)
            c = _adapt(c, alpha, i, mu_da, target_accept)
        var = c.m2 / (c.count[:, None] - 1.0).clamp_min(1.0)
        c = c._replace(inv_mass=var.clamp(1e-4, 1e4))
        if warm_vg is not value_and_grad:  # re-score on the true target
            lp, g = value_and_grad(c.z)
            c = c._replace(logp=lp, grad=g)
    if not fast_path:
        c = c._replace(h_bar=zeros, log_eps=c.log_eps_bar)
        for i in range(n_warmup2 if n_warmup2 is not None else max(1, n_warmup // 2)):
            c, alpha, _ = step(c, value_and_grad)
            c = _adapt(c, alpha, i, mu_da, target_accept)
    c = c._replace(log_eps=c.log_eps_bar)
    zs, lps = [], []
    sum_alpha, sum_stat = zeros, zeros
    for k in range(n_samples * thin):
        c, alpha, stat = step(c, value_and_grad)
        sum_alpha, sum_stat = sum_alpha + alpha, sum_stat + stat
        if k % thin == 0:
            zs.append(c.z)
            lps.append(c.logp)
    zs = torch.stack(zs) if zs else torch.empty((0, C, d), dtype=dtype, device=dev)
    lps = torch.stack(lps) if lps else torch.empty((0, C), dtype=dtype, device=dev)
    return c, zs, lps, sum_alpha, sum_stat


def _leapfrog(z, p, g, eps, n_steps: int, value_and_grad, inv_mass):
    """n_steps leapfrog steps from (z, p) with the gradient g at z; returns
    the end state, its target value and its gradient."""
    e = eps[:, None]
    lp = None
    for _ in range(n_steps):
        p = p + 0.5 * e * g
        z = z + e * inv_mass * p
        lp, g = value_and_grad(z)
        p = p + 0.5 * e * g
    return z, p, lp, g


def _prepare(x0, lo, hi, log_prob_fn, warmup_log_prob_fn):
    lo = torch.as_tensor(lo, dtype=x0.dtype, device=x0.device)
    hi = torch.as_tensor(hi, dtype=x0.dtype, device=x0.device)
    vg = _value_and_grad(log_prob_fn, lo, hi)
    warm_vg = vg if warmup_log_prob_fn is None else _value_and_grad(warmup_log_prob_fn, lo, hi)
    return lo, hi, vg, warm_vg


def hmc_sample(
    gen: torch.Generator,
    log_prob_fn: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    lo,
    hi,
    n_warmup: int = 200,
    n_samples: int = 64,
    n_leapfrog: int = 16,
    target_accept: float = 0.8,
    thin: int = 1,
    warmup_log_prob_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    init_inv_mass=None,
    init_step_size=None,
    n_warmup2: Optional[int] = None,
    draws=None,
) -> HMCResult:
    """Sample box-constrained parameters with C parallel chains.

    log_prob_fn maps box-coordinate rows (C, d) to log densities (C,), all
    chains in one call. x0: (C, d) initial chain states. warmup_log_prob_fn
    (a cheap target for phase 1), init_inv_mass / init_step_size (carried
    adaptation state, which skips phase 1) and n_warmup2 are the same cost
    levers as in `nuts_sample`; without them the schedule is phase 1 and
    sampling. Draws come from `draws`, by default `Draws(gen)`."""
    C, d = x0.shape
    draws = Draws(gen) if draws is None else draws
    lo, hi, vg, warm_vg = _prepare(x0, lo, hi, log_prob_fn, warmup_log_prob_fn)

    def step(c: _Chains, target):
        normal, L, u = draws.hmc(C, d, n_leapfrog, x0.dtype)
        eps = torch.exp(c.log_eps)
        p0 = normal / torch.sqrt(c.inv_mass)
        z_new, p_new, lp_new, g_new = _leapfrog(c.z, p0, c.grad, eps, L, target, c.inv_mass)
        ke0 = 0.5 * (c.inv_mass * p0 * p0).sum(-1)
        ke1 = 0.5 * (c.inv_mass * p_new * p_new).sum(-1)
        log_alpha = torch.clamp_max((lp_new - ke1) - (c.logp - ke0), 0.0)
        log_alpha = torch.where(torch.isfinite(log_alpha), log_alpha,
                                torch.full_like(log_alpha, -math.inf))
        accept = torch.log(u) < log_alpha
        c = c._replace(z=_where(accept, z_new, c.z), logp=torch.where(accept, lp_new, c.logp),
                       grad=_where(accept, g_new, c.grad))
        return c, torch.exp(log_alpha), accept.to(x0.dtype)

    fast_path = warmup_log_prob_fn is None and init_inv_mass is None and n_warmup2 is None
    c, zs, lps, _, n_accept = _run_chains(
        step, vg, warm_vg, x0, lo, hi, n_warmup, n_samples, thin, init_inv_mass,
        init_step_size, n_warmup2, target_accept, fast_path)
    return HMCResult(
        samples=_to_box(zs, lo, hi),
        accept_rate=n_accept / max(1, n_samples * thin),
        step_size=torch.exp(c.log_eps),
        log_prob=lps,
        inv_mass=c.inv_mass,
    )


def fit_vi(
    gen: torch.Generator,
    log_prob_fn: Callable[[torch.Tensor], torch.Tensor],
    lo: torch.Tensor,
    hi: torch.Tensor,
    n_steps: int = 400,
    n_mc: int = 8,
    lr: float = 0.05,
    draws=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean-field Gaussian ADVI in the unconstrained space; returns (mean,
    log_std) of the variational posterior over z (map through the sigmoid
    for box coordinates). Each step's n_mc Monte-Carlo draws are one batched
    call of log_prob_fn; Adam is written out to optax's formula (b1 0.9, b2
    0.999, eps 1e-8 outside the square root, bias-corrected moments)."""
    draws = Draws(gen) if draws is None else draws
    d, dtype = lo.shape[0], lo.dtype
    normals = draws.vi(n_steps, n_mc, d, dtype)
    params = [torch.zeros(d, dtype=dtype, device=lo.device),
              torch.full((d,), -1.0, dtype=dtype, device=lo.device)]
    mom1 = [torch.zeros_like(p) for p in params]
    mom2 = [torch.zeros_like(p) for p in params]
    b1, b2, tiny = 0.9, 0.999, 1e-8
    half_log_2pi = 0.5 * math.log(2 * math.pi)
    for k in range(n_steps):
        eps = normals[k]
        with torch.enable_grad():
            mean, log_std = (p.detach().requires_grad_(True) for p in params)
            z = mean[None, :] + torch.exp(log_std)[None, :] * eps
            logq = (-0.5 * eps ** 2 - log_std[None, :] - half_log_2pi).sum(-1)
            logp = log_prob_fn(_to_box(z, lo, hi)) + _log_jac(z, lo, hi)
            grads = torch.autograd.grad((logq - logp).mean(), (mean, log_std))
        count = k + 1
        for i, g in enumerate(grads):
            mom1[i] = (1 - b1) * g + b1 * mom1[i]
            mom2[i] = (1 - b2) * g ** 2 + b2 * mom2[i]
            m_hat = mom1[i] / (1 - b1 ** count)
            v_hat = mom2[i] / (1 - b2 ** count)
            params[i] = params[i] + -lr * (m_hat / (torch.sqrt(v_hat) + tiny))
    return params[0], params[1]


# ---------------------------------------------------------------------------
# NUTS: dynamic (U-turn-terminated) trajectories, iterative formulation
# (Phan et al. 2019, as in numpyro/TFP and the JAX package)
# ---------------------------------------------------------------------------


class _Tree(NamedTuple):
    z_minus: torch.Tensor
    p_minus: torch.Tensor
    g_minus: torch.Tensor
    z_plus: torch.Tensor
    p_plus: torch.Tensor
    g_plus: torch.Tensor
    z_prop: torch.Tensor       # current multinomial proposal
    logp_prop: torch.Tensor
    g_prop: torch.Tensor
    log_sum_w: torch.Tensor    # total multinomial weight of the trajectory
    turning: torch.Tensor
    diverged: torch.Tensor
    sum_alpha: torch.Tensor
    n_alpha: torch.Tensor
    depth: torch.Tensor


def _uturn(dz, p_a, p_b, inv_mass):
    """U-turn criterion between trajectory ends (velocities = M^-1 p), per chain."""
    return ((dz * (inv_mass * p_a)).sum(-1) < 0.0) | ((dz * (inv_mass * p_b)).sum(-1) < 0.0)


def _subtree(vg, z, p, g, signed_eps, n_leaves: int, u_leaf, H0, inv_mass, max_depth: int):
    """Stream n_leaves leapfrog steps from (z, p) for every chain, with the
    exact block U-turn checks through the power-of-two stack. A chain whose
    sub-tree turned or diverged keeps its state (it still steps, as every
    vmapped lane did). Returns the end state, the sub-tree's proposal, its
    weight and its statistics, each per chain."""
    C, d = z.shape
    dtype, dev = z.dtype, z.device
    e = signed_eps[:, None]
    # the leaf i is the head of every block that OPENS at it (i % 2^l == 0);
    # the blocks that CLOSE at it ((i+1) % 2^l == 0, l > 0) are levels
    # 1..v, v the trailing zeros of i + 1, each checked for a U-turn between
    # its stored head and the leaf
    leaf = torch.arange(n_leaves, device=dev)[:, None]
    opens_at = (leaf % (2 ** torch.arange(max_depth + 1, device=dev))[None, :] == 0)[:, None, :, None]
    stack_z = torch.zeros((C, max_depth + 1, d), dtype=dtype, device=dev)
    stack_p = torch.zeros_like(stack_z)
    cand, g_cand = z, g
    logp_cand = torch.full((C,), -math.inf, dtype=dtype, device=dev)
    log_w = torch.full((C,), -math.inf, dtype=dtype, device=dev)
    turning = torch.zeros((C,), dtype=torch.bool, device=dev)
    diverged = torch.zeros_like(turning)
    sum_alpha = torch.zeros((C,), dtype=dtype, device=dev)
    n_alpha = torch.zeros_like(sum_alpha)
    for i in range(n_leaves):
        done = turning | diverged
        p1 = p + 0.5 * e * g
        z1 = z + e * inv_mass * p1
        lp, g1 = vg(z1)
        p1 = p1 + 0.5 * e * g1
        dH = (-lp + 0.5 * (inv_mass * p1 * p1).sum(-1)) - H0
        finite = torch.isfinite(dH)
        diverged = diverged | ~finite | (dH > 1000.0)
        logw = torch.where(finite, -dH, torch.full_like(dH, -math.inf))
        # streaming progressive multinomial within the sub-tree
        log_w_new = torch.logaddexp(log_w, logw)
        take = (torch.log(u_leaf[:, i]) < (logw - log_w_new)) & ~done
        cand, g_cand = _where(take, z1, cand), _where(take, g1, g_cand)
        logp_cand = torch.where(take, lp, logp_cand)
        log_w = torch.where(done, log_w, log_w_new)
        alpha = torch.clamp_max(torch.exp(-dH), 1.0)
        alpha = torch.where(torch.isfinite(alpha), alpha, torch.zeros_like(alpha))
        sum_alpha = sum_alpha + torch.where(done, torch.zeros_like(alpha), alpha)
        n_alpha = n_alpha + (~done).to(dtype)
        new_z = torch.where(opens_at[i], z1[:, None, :], stack_z)
        new_p = torch.where(opens_at[i], p1[:, None, :], stack_p)
        v = min(max_depth, ((i + 1) & -(i + 1)).bit_length() - 1)
        if v:
            dz = z1[:, None, :] - new_z[:, 1:v + 1]
            t_low = (dz * (inv_mass[:, None, :] * new_p[:, 1:v + 1])).sum(-1) < 0.0
            t_cur = (dz * (inv_mass * p1)[:, None, :]).sum(-1) < 0.0
            turning = turning | (~done & (t_low | t_cur).any(-1))
        z, p, g = _where(done, z, z1), _where(done, p, p1), _where(done, g, g1)
        stack_z, stack_p = _where(done, stack_z, new_z), _where(done, stack_p, new_p)
    return z, p, g, cand, logp_cand, g_cand, log_w, turning, diverged, sum_alpha, n_alpha


def _nuts_step(c: _Chains, vg, draws, max_depth: int):
    """One NUTS transition for all C chains: (chains, mean alpha, depth)."""
    C, d = c.z.shape
    dtype = c.z.dtype
    normal, u_dir, u_acc, u_leaf = draws.nuts(C, d, max_depth, dtype)
    eps = torch.exp(c.log_eps)
    inv_mass = c.inv_mass
    p0 = normal / torch.sqrt(inv_mass)
    H0 = -c.logp + 0.5 * (inv_mass * p0 * p0).sum(-1)  # joint energy of the initial leaf
    zeros = torch.zeros((C,), dtype=dtype, device=c.z.device)
    false = torch.zeros((C,), dtype=torch.bool, device=c.z.device)
    t = _Tree(z_minus=c.z, p_minus=p0, g_minus=c.grad, z_plus=c.z, p_plus=p0, g_plus=c.grad,
              z_prop=c.z, logp_prop=c.logp, g_prop=c.grad, log_sum_w=zeros, turning=false,
              diverged=false, sum_alpha=zeros, n_alpha=zeros, depth=zeros)
    for j in range(max_depth):
        active = ~(t.turning | t.diverged)
        if not bool(active.any()):  # the one host sync of a doubling
            break
        right = u_dir[:, j] < 0.5
        z_s, p_s, g_s, cand, logp_cand, g_cand, log_w, s_turn, s_div, s_alpha, s_n = _subtree(
            vg, _where(right, t.z_plus, t.z_minus), _where(right, t.p_plus, t.p_minus),
            _where(right, t.g_plus, t.g_minus), torch.where(right, eps, -eps), 2 ** j,
            u_leaf[:, 2 ** j - 1:2 ** (j + 1) - 1], H0, inv_mass, max_depth)
        ok = ~s_turn & ~s_div
        # biased progressive sampling toward the NEW sub-tree
        acc = torch.clamp_max(log_w - t.log_sum_w, 0.0)
        take = ok & (torch.log(u_acc[:, j]) < acc)
        z_minus, p_minus, g_minus = (_where(right, a, b) for a, b in
                                     ((t.z_minus, z_s), (t.p_minus, p_s), (t.g_minus, g_s)))
        z_plus, p_plus, g_plus = (_where(right, b, a) for a, b in
                                  ((t.z_plus, z_s), (t.p_plus, p_s), (t.g_plus, g_s)))
        new = _Tree(
            z_minus=z_minus, p_minus=p_minus, g_minus=g_minus,
            z_plus=z_plus, p_plus=p_plus, g_plus=g_plus,
            z_prop=_where(take, cand, t.z_prop), logp_prop=torch.where(take, logp_cand, t.logp_prop),
            g_prop=_where(take, g_cand, t.g_prop),
            log_sum_w=torch.where(ok, torch.logaddexp(t.log_sum_w, log_w), t.log_sum_w),
            turning=s_turn | _uturn(z_plus - z_minus, p_minus, p_plus, inv_mass),
            diverged=s_div, sum_alpha=t.sum_alpha + s_alpha, n_alpha=t.n_alpha + s_n,
            depth=t.depth + 1.0,
        )
        # a chain that had stopped keeps its tree, as vmap's select kept it
        t = _Tree(*(_where(active, a, b) for a, b in zip(new, t)))
    c = c._replace(z=t.z_prop, logp=t.logp_prop, grad=t.g_prop)
    return c, t.sum_alpha / t.n_alpha.clamp_min(1.0), t.depth


def nuts_sample(
    gen: torch.Generator,
    log_prob_fn: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    lo,
    hi,
    n_warmup: int = 200,
    n_samples: int = 64,
    max_depth: int = 6,
    target_accept: float = 0.8,
    thin: int = 1,
    warmup_log_prob_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    init_inv_mass=None,
    init_step_size=None,
    n_warmup2: Optional[int] = None,
    draws=None,
) -> NUTSResult:
    """No-U-Turn sampling of box-constrained parameters with C chains; the
    reparameterization, dual averaging and diagonal-mass warm-up of
    `hmc_sample`, with U-turn-terminated trajectories of at most
    2^max_depth leapfrogs a transition.

    Cost levers, as in the JAX package:
    - warmup_log_prob_fn: a cheap surrogate target (the GP likelihood on a
      data subset) for phase-1 adaptation only; phase 2 re-adapts the step
      size on the true target under the frozen mass.
    - init_inv_mass / init_step_size: the adapted state carried from the
      previous refit; phase 1 is skipped and phase 2 re-tunes the step size
      (n_warmup2 transitions, default n_warmup // 2).
    log_prob_fn is batched, (C, d) -> (C,); draws come from `draws`, by
    default `Draws(gen)`."""
    C, d = x0.shape
    draws = Draws(gen) if draws is None else draws
    lo, hi, vg, warm_vg = _prepare(x0, lo, hi, log_prob_fn, warmup_log_prob_fn)

    def step(c, target):
        return _nuts_step(c, target, draws, max_depth)

    c, zs, lps, sum_alpha, sum_depth = _run_chains(
        step, vg, warm_vg, x0, lo, hi, n_warmup, n_samples, thin, init_inv_mass,
        init_step_size, n_warmup2, target_accept, False)
    n_trans = max(1, n_samples * thin)
    return NUTSResult(
        samples=_to_box(zs, lo, hi),
        accept_rate=sum_alpha / n_trans,
        step_size=torch.exp(c.log_eps),
        log_prob=lps,
        mean_depth=sum_depth / n_trans,
        inv_mass=c.inv_mass,
    )

"""The port's HMC, NUTS and VI samplers (models/hmc.py) against the JAX
package on the CPU.

The JAX package draws from a PRNGKey tree; `JaxDraws` rebuilds that tree's
numbers with jax.random and hands them to the port through the samplers'
`draws` argument, so both packages take the same steps. On a correlated
Gaussian in float64: one transition of each sampler within 1e-10, short
whole runs (every warm-up variant) within 1e-8, the VI fit within 1e-8. The
moment tests of tests/test_hmc.py run again on the port's own generator."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_optimization_tpu.models import hmc as jhmc
from bayesian_optimization_tpu_torch.models import hmc as thmc

torch.set_num_threads(1)  # one thread per pytest worker: more oversubscribe the cores

@partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _hmc_block(key, C, d, n_leapfrog, dtype):
    k1, k2, k3, key = jax.random.split(key, 4)
    return (key, jax.random.normal(k1, (C, d), dtype),
            jax.random.randint(k2, (), n_leapfrog // 2 + 1, n_leapfrog + 1),
            jax.random.uniform(k3, (C,), dtype))


def _nuts_chain(chain_key, d, max_depth, dtype):
    k_mom, k_loop = jax.random.split(chain_key)
    u_dir, u_acc, leaves = [], [], []
    for j in range(max_depth):
        k_dir, k_sub, k_acc, k_loop = jax.random.split(k_loop, 4)
        # the direction is bernoulli(k_dir): hand the port 0 (right) or 1
        u_dir.append(jnp.where(jax.random.bernoulli(k_dir), 0.0, 1.0).astype(dtype))
        u_acc.append(jax.random.uniform(k_acc, (), dtype))
        for _ in range(2 ** j):
            k_sel, k_sub = jax.random.split(k_sub)
            leaves.append(jax.random.uniform(k_sel, (), dtype))
    return (jax.random.normal(k_mom, (d,), dtype), jnp.stack(u_dir), jnp.stack(u_acc),
            jnp.stack(leaves))


@partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _nuts_block(key, C, d, max_depth, dtype):
    key, *chain_keys = jax.random.split(key, C + 1)
    return (key, *jax.vmap(lambda k: _nuts_chain(k, d, max_depth, dtype))(jnp.stack(chain_keys)))


@partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _vi_block(key, n_steps, n_mc, d, dtype):
    return jax.vmap(lambda k: jax.random.normal(k, (n_mc, d), dtype))(jax.random.split(key, n_steps))


class JaxDraws:
    """The JAX package's draws from one key, in the layout of the port's
    `Draws`: HMC takes k1, k2, k3, key = split(key, 4) a transition; NUTS
    takes key, *chain_keys = split(key, C + 1), per chain k_mom, k_loop =
    split(chain_key), per doubling k_dir, k_sub, k_acc, k_loop = split(k_loop,
    4), per leaf k_sel, k_sub = split(k_sub); VI takes one normal a step from
    split(key, n_steps). With vi_split (the GP fit's layout) the VI key is
    k_fit of k_fit, k_sample = split(key), and `normal` draws from k_sample.
    A float64 draw is made in x64 mode, as the float64 sampler makes it."""

    def __init__(self, key, vi_split: bool = False):
        self.key = jax.random.PRNGKey(key) if isinstance(key, int) else key
        self.vi_split = vi_split

    @staticmethod
    def _run(dtype, fn, *args):
        if dtype == torch.float64:
            with jax.enable_x64():
                return fn(*args, jnp.float64)
        return fn(*args, jnp.float32)

    @staticmethod
    def _t(a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype)

    def hmc(self, C, d, n_leapfrog, dtype):
        self.key, normal, L, u = self._run(dtype, _hmc_block, self.key, C, d, n_leapfrog)
        return self._t(normal, dtype), int(L), self._t(u, dtype)

    def nuts(self, C, d, max_depth, dtype):
        self.key, *block = self._run(dtype, _nuts_block, self.key, C, d, max_depth)
        return tuple(self._t(b, dtype) for b in block)

    def vi(self, n_steps, n_mc, d, dtype):
        key = self.key
        if self.vi_split:
            key, self.key = jax.random.split(self.key)
        return self._t(self._run(dtype, _vi_block, key, n_steps, n_mc, d), dtype)

    def normal(self, shape, dtype):
        return self._t(self._run(dtype, lambda k, dt: jax.random.normal(k, shape, dt), self.key), dtype)


# the correlated Gaussian of tests/test_hmc.py, in a [-8, 8] box
MEAN = np.array([0.5, -0.3, 0.2])
COV = np.array([[1.0, 0.8, 0.2], [0.8, 1.0, 0.4], [0.2, 0.4, 0.5]])
PREC = np.linalg.inv(COV)
C, D = 4, 3
LO, HI = -8.0 * np.ones(D), 8.0 * np.ones(D)
X0 = np.array([[0.3, -1.2, 1.4], [-1.8, 0.9, 0.1], [1.1, 1.7, -0.6], [0.0, 0.2, 0.4]])
INV_MASS = np.array([[0.6, 1.4, 1.0], [1.0, 1.0, 1.0], [2.0, 0.5, 0.8], [0.3, 0.3, 3.0]])
STEP = np.array([0.05, 0.2, 0.45, 0.9])


def j_logp(scale=1.0):
    prec = jnp.asarray(PREC / scale)
    return lambda x: -0.5 * (x - MEAN) @ prec @ (x - MEAN)


def t_logp(scale=1.0):
    prec = torch.tensor(PREC / scale)
    return lambda x: -0.5 * (((x - torch.tensor(MEAN)) @ prec) * (x - torch.tensor(MEAN))).sum(-1)


def run_both(sampler: str, key: int, **kw):
    """The same run in both packages, float64: (JAX result, port result) as numpy."""
    warm = kw.pop("warm_scale", None)
    j_kw, t_kw = dict(kw), dict(kw)
    if warm is not None:
        t_kw["warmup_log_prob_fn"] = t_logp(warm)
    for name in ("init_inv_mass", "init_step_size"):
        if name in kw:  # numpy for JAX: it casts inside the sampler, in x64 mode
            t_kw[name] = torch.tensor(kw[name])
    with jax.enable_x64():  # every JAX array made in here, or it is float32
        if warm is not None:
            j_kw["warmup_log_prob_fn"] = j_logp(warm)
        fn = getattr(jhmc, sampler)
        want = fn(jax.random.PRNGKey(key), j_logp(), jnp.asarray(X0), jnp.asarray(LO),
                  jnp.asarray(HI), **j_kw)
        want = {k: np.asarray(v) for k, v in want._asdict().items()}
    got = getattr(thmc, sampler)(None, t_logp(), torch.tensor(X0), torch.tensor(LO), torch.tensor(HI),
                                 draws=JaxDraws(key), **t_kw)
    return want, {k: v.numpy() for k, v in got._asdict().items()}


@pytest.mark.parametrize("shape", [(50, 4, 3), (3, 4, 2), (20, 2, 2)])
def test_effective_sample_size_equals_jax(shape):
    """An AR(1) draw per chain (the (3, 4, 2) case below the 4-draw floor;
    the last a constant dimension)."""
    r = np.random.default_rng(shape[0])
    x = np.zeros(shape)
    for t in range(1, shape[0]):
        x[t] = 0.7 * x[t - 1] + r.standard_normal(shape[1:])
    if shape[0] == 20:
        x[..., 1] = 2.0
    np.testing.assert_allclose(thmc.effective_sample_size(x), jhmc.effective_sample_size(x),
                               rtol=1e-12, atol=0)


def test_one_hmc_transition_matches_jax():
    """One transition from X0 under a carried per-chain mass and step size:
    with n_warmup2 = 0 it is the one sampling transition (z, logp, accepted
    or not); with n_warmup2 = 1 and no samples it is the one adapting
    transition, whose alpha sets the step size the dual averaging leaves,
    log eps = log(10 eps0) - 20 (0.8 - alpha) / 11. Both within 1e-10."""
    carry = dict(init_inv_mass=INV_MASS, init_step_size=STEP, n_leapfrog=10)
    want, got = run_both("hmc_sample", 5, n_warmup2=0, n_samples=1, **carry)
    for k in ("samples", "log_prob", "accept_rate"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-10, atol=1e-10, err_msg=k)
    assert 0 < want["accept_rate"].sum() < C  # the step sizes accept some chains, not all
    want, got = run_both("hmc_sample", 5, n_warmup2=1, n_samples=0, **carry)

    def alpha(step):
        return 0.8 - (np.log(10 * STEP) - np.log(step)) * 11 / 20

    np.testing.assert_allclose(alpha(got["step_size"]), alpha(want["step_size"]), rtol=0, atol=1e-10)


def test_one_nuts_transition_matches_jax():
    """One NUTS transition of the JAX package's `_nuts_transition` (vmapped
    over the chains) and the port's `_nuts_step`, from the same chain keys:
    z, logp, mean alpha and depth within 1e-10. The step sizes and the key
    give the chains depths 6 (the cap), 4, 2 and 1 (a divergence)."""
    eps = np.array([0.002, 0.01, 0.05, 0.5])
    with jax.enable_x64():
        lo, hi = jnp.asarray(LO), jnp.asarray(HI)

        def logp_z(z):
            return j_logp()(jhmc._to_box(z, lo, hi)) + jhmc._log_jac(z, lo, hi)

        frac = (X0 - LO) / (HI - LO)
        z0 = jnp.asarray(np.log(frac) - np.log1p(-frac))
        key = jax.random.PRNGKey(13)
        _, *chain_keys = jax.random.split(key, C + 1)
        out = jax.jit(jax.vmap(jhmc._nuts_transition, in_axes=(0, 0, 0, 0, 0, None, None, None)),
                      static_argnums=(5, 6, 7))(
            jnp.stack(chain_keys), z0, jax.vmap(logp_z)(z0), jnp.log(jnp.asarray(eps)),
            jnp.asarray(INV_MASS), logp_z, jax.grad(logp_z), 6)
        want = [np.asarray(o) for o in out]
    vg = thmc._value_and_grad(t_logp(), torch.tensor(LO), torch.tensor(HI))
    z0_t = torch.tensor(np.asarray(z0))
    lp, g = vg(z0_t)
    zeros = torch.zeros(C, dtype=torch.float64)
    chains = thmc._Chains(z=z0_t, logp=lp, grad=g, log_eps=torch.log(torch.tensor(eps)),
                          log_eps_bar=zeros, h_bar=zeros, m1=z0_t, m2=z0_t, count=zeros,
                          inv_mass=torch.tensor(INV_MASS))
    c, alpha, depth = thmc._nuts_step(chains, vg, JaxDraws(key), 6)
    for name, a, b in zip(("z", "logp", "alpha", "depth"), (c.z, c.logp, alpha, depth), want):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-10, atol=1e-10, err_msg=name)
    assert want[3].tolist() == [6.0, 4.0, 2.0, 1.0] and want[2][3] < 1e-6


def test_nuts_left_subtree_turns_as_in_the_reference():
    """The reference's sub-tree U-turn check (bayesian_optimization_tpu/
    models/hmc.py:425-427) takes dz = leaf - head in whichever direction the
    sub-tree grows, so a sub-tree of 2 or more leaves built to the left reads
    as turning at its first closed block (ROADMAP Queue 3). The port keeps
    that, as its transitions equal the JAX package's: with a step too small
    to turn, each of 64 chains stops at its first left doubling after the
    first, depth j + 1 (6, the cap, if there is none)."""
    C64 = 64
    block = thmc.Draws(torch.Generator().manual_seed(0)).nuts(C64, D, 6, torch.float64)

    class Fixed:
        def nuts(self, *_):
            return block

    vg = thmc._value_and_grad(t_logp(), torch.tensor(LO), torch.tensor(HI))
    z = torch.zeros((C64, D), dtype=torch.float64)
    lp, g = vg(z)
    zeros = torch.zeros(C64, dtype=torch.float64)
    chains = thmc._Chains(z=z, logp=lp, grad=g, log_eps=zeros + np.log(1e-4), log_eps_bar=zeros,
                          h_bar=zeros, m1=z, m2=z, count=zeros, inv_mass=torch.ones_like(z))
    _, _, depth = thmc._nuts_step(chains, vg, Fixed(), 6)
    left = (block[1] >= 0.5).numpy()
    want = [next((j + 1 for j in range(1, 6) if left[c, j]), 6) for c in range(C64)]
    assert depth.tolist() == want


RUNS = {
    "fast path": dict(n_warmup=20, n_samples=10),
    "warm target": dict(n_warmup=20, n_warmup2=6, n_samples=8, thin=2, warm_scale=3.0),
    "carried": dict(n_warmup=20, n_warmup2=8, n_samples=8, thin=2, init_inv_mass=INV_MASS,
                    init_step_size=STEP),
}


@pytest.mark.parametrize("variant", list(RUNS))
@pytest.mark.parametrize("sampler", ["hmc_sample", "nuts_sample"])
def test_short_run_matches_jax(sampler, variant):
    """C = 4 chains, d = 3, 20 warm-up transitions (or a carried mass and
    step, which skips them): every recorded draw within 1e-8, and the
    adapted state. NUTS has no fast path: its "fast path" is phase 2 at the
    default n_warmup // 2. HMC runs trajectories of 5-8 leapfrogs: at 6-10
    two runs part by more (next test)."""
    extra = {"hmc_sample": {"n_leapfrog": 8}, "nuts_sample": {"max_depth": 6}}[sampler]
    want, got = run_both(sampler, 3, **RUNS[variant], **extra)
    assert got["samples"].shape == (RUNS[variant]["n_samples"], C, D)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-8, atol=1e-8, err_msg=k)


def test_hmc_run_parts_from_jax_only_as_its_own_rounding_does():
    """The fast path with trajectories of 6-10 leapfrogs: the port's draws
    end up to ~2e-6 from the JAX package's. A witness that this is the
    sampler's own amplification of rounding (its long trajectories make
    transitions chaotic), not a fault: the JAX package against itself, with
    X0 moved by 4 ulp, parts by as much (1.1e-6), and the port's gap is no
    larger than 10x that."""
    want, got = run_both("hmc_sample", 3, n_warmup=20, n_samples=10, n_leapfrog=10)
    with jax.enable_x64():
        moved = jhmc.hmc_sample(jax.random.PRNGKey(3), j_logp(),
                                jnp.asarray(X0 * (1 + 4 * np.finfo(np.float64).eps)), jnp.asarray(LO),
                                jnp.asarray(HI), n_warmup=20, n_samples=10, n_leapfrog=10)
        own = float(np.abs(np.asarray(moved.samples) - want["samples"]).max())
    gap = float(np.abs(got["samples"] - want["samples"]).max())
    print(f"\nport against JAX {gap:.2e}; JAX against itself, X0 moved by 4 ulp, {own:.2e}")
    assert own > 1e-8 and gap <= 10 * own


def test_fit_vi_matches_jax():
    """200 ADVI steps on an isotropic Gaussian (tests/test_hmc.py's VI
    target) from the same key: (mean, log_std) within 1e-8."""
    lo, hi = -10.0 * np.ones(2), 10.0 * np.ones(2)
    with jax.enable_x64():
        want = jhmc.fit_vi(jax.random.PRNGKey(2), lambda x: -0.5 * jnp.sum((x - 1.5) ** 2) / 0.25,
                           jnp.asarray(lo), jnp.asarray(hi), n_steps=200)
        want = [np.asarray(w) for w in want]
    got = thmc.fit_vi(None, lambda x: -0.5 * ((x - 1.5) ** 2).sum(-1) / 0.25, torch.tensor(lo),
                      torch.tensor(hi), n_steps=200, draws=JaxDraws(2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-8, atol=1e-8)


# the moment tests of tests/test_hmc.py, on the port's own generator


def test_hmc_recovers_gaussian_moments():
    cov = torch.tensor([[1.0, 0.6], [0.6, 0.8]])
    prec = torch.linalg.inv(cov)

    def logp(x):
        return -0.5 * (((x - 2.0) @ prec) * (x - 2.0)).sum(-1)

    x0 = torch.rand((8, 2), generator=torch.Generator().manual_seed(0)) * 8.0 - 2.0
    res = thmc.hmc_sample(torch.Generator().manual_seed(1), logp, x0, torch.full((2,), -10.0),
                          torch.full((2,), 10.0), n_warmup=300, n_samples=300, n_leapfrog=12)
    S = res.samples.reshape(-1, 2).double().numpy()
    assert bool((res.accept_rate > 0.4).all()), res.accept_rate
    assert np.allclose(S.mean(0), [2.0, 2.0], atol=0.15), S.mean(0)
    assert np.allclose(np.cov(S.T), cov.numpy(), atol=0.3), np.cov(S.T)


def test_vi_recovers_gaussian_mean():
    lo, hi = torch.full((2,), -10.0), torch.full((2,), 10.0)
    mean, log_std = thmc.fit_vi(torch.Generator().manual_seed(2),
                                lambda x: -0.5 * ((x - 1.5) ** 2).sum(-1) / 0.25, lo, hi, n_steps=500)
    assert np.allclose((lo + (hi - lo) * torch.sigmoid(mean)).numpy(), 1.5, atol=0.2)
    assert bool(torch.isfinite(log_std).all())


def test_nuts_moments_match_truth():
    mean = torch.tensor([0.5, -0.3, 0.2])
    cov = torch.tensor(COV, dtype=torch.float32)
    prec = torch.linalg.inv(cov)

    def logp(x):
        return -0.5 * (((x - mean) @ prec) * (x - mean)).sum(-1)

    x0 = torch.rand((8, 3), generator=torch.Generator().manual_seed(1)) * 4.0 - 2.0
    res = thmc.nuts_sample(torch.Generator().manual_seed(0), logp, x0, torch.full((3,), -8.0),
                           torch.full((3,), 8.0), n_warmup=300, n_samples=400, max_depth=6)
    s = res.samples.reshape(-1, 3).double().numpy()
    assert np.abs(s.mean(0) - mean.numpy()).max() < 0.08
    assert np.abs(s.var(0) - np.diag(COV)).max() < 0.15
    assert abs(float(np.cov(s.T)[0, 1]) - 0.8) < 0.15
    assert 0.6 < float(res.accept_rate.mean()) <= 1.0
    assert float(res.mean_depth.mean()) > 1.0  # dynamic trajectories engaged
    ess = thmc.effective_sample_size(res.samples.double().numpy())
    assert np.all(ess > 100), ess

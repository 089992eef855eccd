"""bayesian_optimization_tpu_torch/models/likelihood against the JAX
package's models/likelihood on the CPU: the negative log-likelihood and its
gradient in each mode, batched restart lanes, and predict from a posterior
state fitted by the JAX package and carried over by models/convert.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_optimization_tpu.models import likelihood as jlik
from bayesian_optimization_tpu_torch.models import likelihood as tlik
from bayesian_optimization_tpu_torch.models.convert import (
    gpconfig_from_fields, posterior_state_from_numpy,
)

torch.set_num_threads(1)  # one thread per pytest worker: more oversubscribe the cores

N, N_PAD, DIM = 200, 256, 5


def _data(seed=0):
    rng = np.random.default_rng(seed)
    X = np.zeros((N_PAD, DIM), np.float32)
    X[:N] = rng.uniform(0, 1, (N, DIM))
    y = np.sin(3 * X[:N]).sum(1) + 0.1 * rng.standard_normal(N)
    Y = np.zeros((N_PAD, 1), np.float32)
    Y[:N, 0] = (y - y.mean()) / y.std()
    mask = np.zeros(N_PAD, np.float32)
    mask[:N] = 1.0
    F = mask[:, None].copy()
    return X, Y, F, mask


CONFIGS = {
    "noisy": (jlik.GPConfig(mode="noisy"), 1e-6),
    "noiseless": (jlik.GPConfig(mode="noiseless"), 0.0),
    "reml": (jlik.GPConfig(mode="noisy", likelihood="restricted"), 1e-6),
    "map_prior": (jlik.GPConfig(mode="noisy", theta_prior_strength=0.5), 1e-6),
}


def _par(config, seed=1):
    rng = np.random.default_rng(seed)
    p = rng.uniform(-0.5, 0.8, DIM)
    if config.mode != "noiseless":
        p = np.append(p, -0.2)
    return p.astype(np.float32)


def _jax_nll(config, nv, X, Y, F, mask, lo, hi):
    beta0 = jnp.zeros((1, 1), jnp.float32)
    return lambda p: jlik.neg_log_likelihood(
        p, jnp.asarray(X), jnp.asarray(Y), jnp.asarray(F), jnp.asarray(mask),
        jnp.asarray(float(N), jnp.float32), jnp.asarray(nv, jnp.float32), beta0, config,
        prior_lo=lo, prior_hi=hi,
    )


@pytest.mark.parametrize("mode", sorted(CONFIGS))
def test_nll_value_and_grad_match_jax(mode):
    jcfg, nv = CONFIGS[mode]
    X, Y, F, mask = _data()
    par = _par(jcfg)
    lo = np.full(par.shape, -3.0, np.float32)
    hi = np.full(par.shape, 3.0, np.float32)
    v_j, g_j = jax.value_and_grad(_jax_nll(jcfg, nv, X, Y, F, mask, jnp.asarray(lo), jnp.asarray(hi)))(
        jnp.asarray(par)
    )
    tcfg = gpconfig_from_fields(jcfg._asdict())
    p = torch.tensor(par, requires_grad=True)
    v_t = tlik.neg_log_likelihood(
        p, torch.tensor(X), torch.tensor(Y), torch.tensor(F), torch.tensor(mask), N, nv,
        torch.zeros(1, 1), tcfg, prior_lo=torch.tensor(lo), prior_hi=torch.tensor(hi),
    )
    v_t.backward()
    assert float(v_j) < 1e11
    assert abs(v_t.item() - float(v_j)) < 1e-4 * abs(float(v_j))
    g_j = np.asarray(g_j, np.float64)
    assert np.abs(p.grad.numpy() - g_j).max() < 1e-3 * np.abs(g_j).max()


def test_nll_batched_lanes_match_jax_vmap():
    """Restart lanes as a batch axis: one torch call against jax.vmap, with
    one lane in the 1e12 penalty region (theta -> 0 makes the noiseless
    correlation all-ones: the f32 factorisation fails)."""
    jcfg, nv = CONFIGS["noiseless"]
    X, Y, F, mask = _data(3)
    pars = np.stack([_par(jcfg, s) for s in range(4)])
    pars[3] = -9.0
    v_j = jax.vmap(_jax_nll(jcfg, nv, X, Y, F, mask, None, None))(jnp.asarray(pars))
    v_t = tlik.neg_log_likelihood(
        torch.tensor(pars), torch.tensor(X), torch.tensor(Y), torch.tensor(F),
        torch.tensor(mask), N, nv, torch.zeros(1, 1), gpconfig_from_fields(jcfg._asdict()),
    )
    v_j = np.asarray(v_j, np.float64)
    assert v_t.shape == (4,)
    assert float(v_t[3]) == float(v_j[3]) == float(np.float32(1e12))
    assert np.abs(v_t.numpy()[:3] - v_j[:3]).max() < 1e-4 * np.abs(v_j[:3]).max()


@pytest.mark.parametrize("mode", ["noisy", "noiseless"])
def test_predict_from_carried_jax_posterior(mode):
    jcfg, nv = CONFIGS[mode]
    X, Y, F, mask = _data(5)
    par = _par(jcfg, 2)
    state = jlik.posterior_state(
        jnp.asarray(par), jnp.asarray(X), jnp.asarray(Y), jnp.asarray(F), jnp.asarray(mask),
        jnp.asarray(float(N), jnp.float32), jnp.asarray(nv, jnp.float32),
        jnp.zeros((1, 1), jnp.float32), jcfg,
    )
    Xq = np.random.default_rng(9).uniform(0, 1, (64, DIM)).astype(np.float32)
    Fq = np.ones((64, 1), np.float32)
    mu_j, mse_j = jlik.predict(state, jnp.asarray(Xq), jnp.asarray(Fq), jcfg)

    tstate = posterior_state_from_numpy(
        {k: np.asarray(v) for k, v in state._asdict().items()}, torch.device("cpu")
    )
    tcfg = gpconfig_from_fields(jcfg._asdict())
    mu_t, mse_t = tlik.predict(tstate, torch.tensor(Xq), torch.tensor(Fq), tcfg)
    assert np.abs(mu_t.numpy() - np.asarray(mu_j)).max() < 1e-4
    assert np.abs(mse_t.numpy() - np.asarray(mse_j)).max() < 1e-4

    # the port's own posterior state at the same parameters agrees too
    own = tlik.posterior_state(
        torch.tensor(par), torch.tensor(X), torch.tensor(Y), torch.tensor(F),
        torch.tensor(mask), N, nv, torch.zeros(1, 1), tcfg,
    )
    mu_o, mse_o = tlik.predict(own, torch.tensor(Xq), torch.tensor(Fq), tcfg)
    assert np.abs(mu_o.numpy() - np.asarray(mu_j)).max() < 1e-3
    assert np.abs(mse_o.numpy() - np.asarray(mse_j)).max() < 1e-3

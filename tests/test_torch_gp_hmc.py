"""The port's posterior-ensemble GP (optimizer="HMC" | "NUTS" | "VI") against
the JAX package on the CPU.

The fits run in float64 in both packages from the same random_state; the
port's samplers take the JAX package's draws (`JaxDraws` of
tests/test_torch_hmc.py, keyed by the integer both fits draw from their
numpy generator), so the chains take the same steps. Then the mixture
predict on a stacked state carried from the JAX package, and the
acquisition criterion and its BFGS argmax over that ensemble. The loop and
the n >= 512 branch of the fit are held in tests/test_torch_bo_hmc.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesian_optimization_tpu as jbo
import bayesian_optimization_tpu_torch as tbo
from bayesian_optimization_tpu.models import GaussianProcess as JGP
from bayesian_optimization_tpu.models import constant_trend as j_const
from bayesian_optimization_tpu.models import gp as jgp_module
from bayesian_optimization_tpu.models import likelihood as jlik
from bayesian_optimization_tpu.optim.argmax import AcquisitionArgmax as JArgmax
from bayesian_optimization_tpu.optim.argmax import make_unit_criterion as j_criterion
from bayesian_optimization_tpu_torch.models import GaussianProcess as TGP
from bayesian_optimization_tpu_torch.models import gp as tgp_module
from bayesian_optimization_tpu_torch.models import likelihood as tlik
from bayesian_optimization_tpu_torch.models.convert import carry_sampler_state
from bayesian_optimization_tpu_torch.models.trend import constant_trend as t_const
from bayesian_optimization_tpu_torch.optim.argmax import AcquisitionArgmax as TArgmax
from bayesian_optimization_tpu_torch.optim.argmax import make_unit_criterion as t_criterion
from test_torch_hmc import JaxDraws

torch.set_num_threads(1)  # one thread per pytest worker: more oversubscribe the cores

N, D = 30, 2
SETTINGS = {"HMC": {"hmc_warmup": 16}, "NUTS": {"hmc_warmup": 16}, "VI": {"vi_steps": 100}}


def data():
    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, (N, D))
    return X, np.sin(2 * X[:, 0]) + 0.5 * X[:, 1] + 0.05 * rng.standard_normal(N)


def make(pkg_gp, trend, optimizer, **kw):
    gp = pkg_gp(mean=trend(D), corr="matern", thetaL=1e-3 * np.ones(D), thetaU=1e3 * np.ones(D),
                nugget=1e-6, optimizer=optimizer, random_state=0, **kw)
    for k, v in SETTINGS[optimizer].items():
        setattr(gp, k, v)
    gp.n_ensemble = 8
    return gp


@pytest.fixture(scope="module")
def fits():
    """Each sampler's fit in both packages, float64, the port on the JAX
    package's draws; for HMC and NUTS also the JAX fit on X moved by 4 ulp
    (the same compiled program)."""
    X, y = data()
    out = {}
    draws = tgp_module.Draws
    tgp_module.Draws = lambda gen: JaxDraws(gen.initial_seed(), vi_split=True)
    try:
        for opt in SETTINGS:
            jgp = make(JGP, j_const, opt, dtype=jnp.float64)
            jgp.fit(X, y)
            moved = None
            if opt != "VI":
                moved = make(JGP, j_const, opt, dtype=jnp.float64)
                moved.fit(X * (1 + 4 * np.finfo(np.float64).eps), y)
            tgp = make(TGP, t_const, opt, dtype="f64", device="cpu")
            tgp.fit(X, y)
            out[opt] = (jgp, tgp, moved)
    finally:
        tgp_module.Draws = draws
    return out


def _rel(a, b) -> float:
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-12)))


@pytest.mark.parametrize("optimizer", list(SETTINGS))
def test_fit_matches_jax(fits, optimizer):
    """theta_samples_, the chains' draws and accept rates (or VI's (mean,
    log_std)), the ensemble's mean log likelihood, the posterior-median
    theta and the carried (inv_mass, step) against the JAX fit. VI within
    1e-10 relative. HMC and NUTS transitions amplify rounding (the two
    packages' float64 likelihoods agree to ~1e-15, yet the draws part by up
    to ~1e-6 relative), so each is held within 1e-8 or 10x what the JAX
    package's own fit moves when X moves by 4 ulp, the larger; both are
    printed. The numpy generators end in step."""
    jgp, tgp, moved = fits[optimizer]
    names = ["theta_samples_", "log_likelihood_", "theta_"] + (
        ["vi_params_"] if optimizer == "VI" else ["sample_chains_", "accept_rate_"])
    pairs = [(name, getattr(tgp, name), getattr(jgp, name),
              None if moved is None else getattr(moved, name)) for name in names]
    if optimizer != "VI":
        (inv_t, step_t, key_t), (inv_j, step_j, key_j) = tgp._sampler_carry, jgp._sampler_carry
        assert key_t == key_j == (optimizer, 64)
        pairs += [("inv_mass", inv_t, inv_j, moved._sampler_carry[0]),
                  ("step_size", step_t, step_j, moved._sampler_carry[1])]
    for name, got, want, own in pairs:
        gap = _rel(got, want)
        tol = 1e-10 if own is None else max(1e-8, 10 * _rel(own, want))
        print(f"\n{optimizer} {name}: port against JAX {gap:.2e}, tolerance {tol:.2e}")
        assert gap <= tol, (name, gap, tol)
    assert tgp.config.n_ensemble == jgp.config.n_ensemble == 8
    assert tgp.theta_samples_.shape == (8, D) and np.asarray(tgp.sigma2).shape == (8, 1)
    assert tgp._rng.bit_generator.state == jgp._rng.bit_generator.state
    if optimizer != "VI":
        assert tgp.sample_chains_.shape == (1, 8, D + 1)


def test_predict_matches_jax(fits):
    """The port's own NUTS fit predicts as the JAX fit does: the mixture
    mean and variance at 40 new points within 1e-6 (the fits' own
    agreement)."""
    jgp, tgp, _ = fits["NUTS"]
    Xq = np.random.default_rng(9).uniform(-1.5, 1.5, (40, D))
    with jax.enable_x64():
        mu_j, mse_j = jgp.predict(Xq, eval_MSE=True)
    mu_t, mse_t = tgp.predict(Xq, eval_MSE=True)
    np.testing.assert_allclose(mu_t, mu_j, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(mse_t, mse_j, rtol=1e-6, atol=1e-10)


# four log10 (theta_1, theta_2, sigma2) rows: a hyperparameter ensemble
PARS = np.log10([[0.3, 2.0, 0.5], [1.5, 0.2, 0.8], [4.0, 1.0, 0.3], [0.7, 0.7, 1.2]])


@pytest.fixture(scope="module")
def stacked():
    """A stacked (S = 4) JAX PosteriorState, float64, the JAX package's
    vmapped posterior over PARS, carried into a port model."""
    X, y = data()
    n_pad = 64
    Xp, Yp, mask = np.zeros((n_pad, D)), np.zeros((n_pad, 1)), np.zeros(n_pad)
    Xp[:N], Yp[:N, 0], mask[:N] = X, y, 1.0
    config = jlik.GPConfig(kernel="matern", mode="noisy", n_ensemble=4)
    with jax.enable_x64():
        _, state = jgp_module._ensemble_posterior(
            jnp.asarray(PARS), lambda p: jnp.float64(0.0), jnp.asarray(Xp), jnp.asarray(Yp),
            jnp.asarray(mask[:, None]), jnp.asarray(mask), jnp.float64(N), jnp.float64(1e-6),
            jnp.zeros((1, 1)), config)
        fields = {k: np.asarray(v) for k, v in state._asdict().items()}
    tgp = TGP(thetaL=1e-3 * np.ones(D), thetaU=1e3 * np.ones(D), dtype="f64", device="cpu")
    tgp.load_fitted(10 ** PARS[0, :D], fields, config._asdict())
    return fields, config, tgp


def test_predict_ensemble_on_a_carried_stacked_state(stacked):
    """predict_ensemble (mixture mean, law-of-total-variance variance) at
    50 points against the JAX package's, float64, within 1e-10; the port's
    stacked layout keeps one copy of X and mask."""
    fields, config, tgp = stacked
    assert tgp.posterior.L.shape == (4, 64, 64) and tgp.posterior.X.shape == (64, D)
    Xq = np.random.default_rng(4).uniform(-2, 2, (50, D))
    with jax.enable_x64():
        state = jlik.PosteriorState(**{k: jnp.asarray(v) for k, v in fields.items()})
        mu_j, var_j = jlik.predict_ensemble(state, jnp.asarray(Xq), jnp.ones((50, 1)), config)
    Xt = torch.tensor(Xq)
    mu_t, var_t = tlik.predict_ensemble(tgp.posterior, Xt, torch.ones((50, 1), dtype=torch.float64),
                                        tgp.config)
    np.testing.assert_allclose(mu_t.numpy(), np.asarray(mu_j), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(var_t.numpy(), np.asarray(var_j), rtol=1e-10, atol=1e-12)
    mu_p, var_p = tgp.predict(Xq, eval_MSE=True)  # the model's predict dispatches to it
    np.testing.assert_allclose(mu_p, np.asarray(mu_j)[:, 0], rtol=1e-10, atol=1e-10)
    # the mixture's variance exceeds the mean of its members' variances
    mus, vars_ = tlik.predict(tgp.posterior, Xt, torch.ones((50, 1), dtype=torch.float64),
                              tgp.config._replace(n_ensemble=0))
    assert mus.shape == (4, 50, 1) and bool((var_t >= vars_.mean(0) - 1e-12).all())


def test_criterion_and_argmax_over_an_ensemble(stacked):
    """EI through the ensemble's mixture: at 300 random points against the
    JAX criterion, and the BFGS argmax from the same pool of 10 starts
    (x0_seed), both in float64; values within 1e-6 relative, the gradient
    path (the Matern backward's dX over 4 lanes) included."""
    fields, config, tgp = stacked
    X, y = data()
    ymin = float(y.min())
    space_j, space_t = jbo.RealSpace([[-2.0, 2.0]] * D), tbo.RealSpace([[-2.0, 2.0]] * D)
    U = np.random.default_rng(5).uniform(0, 1, (300, D))
    pool = np.random.default_rng(6).uniform(0, 1, (10, D))
    with jax.enable_x64():
        state = jlik.PosteriorState(**{k: jnp.asarray(v) for k, v in fields.items()})
        enc_j = space_j.encoding()
        enc_j = type(enc_j)(space_j, dtype=jnp.float64)
        crit = jax.jit(j_criterion(enc_j, state, config, "EI", {"plugin": jnp.float64(ymin)}))
        v_j = np.asarray(crit(jnp.asarray(U)))
        u_j, best_j = JArgmax(enc_j, method="BFGS", n_restart=10, seed=0)(
            state, config, "EI", {"plugin": ymin}, x0_seed=pool)
    enc_t = type(space_t.encoding())(space_t, dtype=torch.float64)
    crit_t = t_criterion(enc_t, tgp.posterior, tgp.config, "EI",
                         {"plugin": torch.tensor(ymin, dtype=torch.float64)})
    with torch.no_grad():
        v_t = crit_t(torch.tensor(U)).numpy()
    top = v_j >= 1e-3 * v_j.max()
    np.testing.assert_allclose(v_t[top], v_j[top], rtol=1e-6)
    u_t, best_t = TArgmax(enc_t, method="BFGS", n_restart=10, seed=0, device="cpu")(
        tgp.posterior, tgp.config, "EI", {"plugin": ymin}, x0_seed=pool)
    assert abs(best_t - best_j) <= 1e-6 * abs(best_j), (best_t, best_j)
    np.testing.assert_allclose(u_t, u_j, atol=1e-4)


def test_carried_jax_sampler_state_is_taken_by_the_next_fit(fits):
    """carry_sampler_state hands a port model the JAX NUTS fit's carry
    (inv_mass, step size, (sampler, bucket)) and log10 posterior median; the
    port's next fit on data of the same bucket takes that carry (phase 1
    skipped, n_warmup2 = max(8, hmc_warmup // 4)) rather than dropping it."""
    jgp, _, _ = fits["NUTS"]
    tgp = make(TGP, t_const, "NUTS", dtype="f64", device="cpu")
    carry_sampler_state(tgp, jgp._sampler_carry, jgp._map_par_log10)
    X, y = data()
    bounds = tgp._hyper_bounds(D, y)
    _, warm_stage, carry, n_w2 = tgp._sampler_setup(np.zeros((10, D + 1)), bounds, 10, (None, None),
                                                    None, N, 64, None, None, 1e-6, None, None)
    assert warm_stage is None and n_w2 == 8
    np.testing.assert_array_equal(carry[0], np.asarray(jgp._sampler_carry[0], float))
    np.testing.assert_array_equal(carry[1], np.asarray(jgp._sampler_carry[1], float))
    np.testing.assert_array_equal(tgp._map_par_log10, np.asarray(jgp._map_par_log10, float))

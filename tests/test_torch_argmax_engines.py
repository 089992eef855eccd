"""The port's derivative-free argmax engines and its q-criteria batch
against the JAX package on the CPU, on posteriors the JAX package fitted
and the port loaded (models/convert.py): n = 60, d = 5 for CMA and SMC,
the parity-config-4 mixed space for MIES. The engines draw different
random streams in the two packages, so they are held on values.

A value is held against the JAX criterion run in float64 on the same
posterior: on the mixed posterior the JAX package's float32 criterion is
off by up to 3.6e-2 relative (its distance's GEMM expansion cancels at
large theta; ROADMAP Queue 3), the port's stays within 2.1e-5 of float64
(test_criterion_against_jax_float64 prints both).
The real-space posterior fits a smooth bowl: on a multimodal surface a
derivative-free engine's winner is a draw of which chains reach the best
basin, and an L-BFGS lane's end moves with the last bit of its arithmetic."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayesian_optimization_tpu as jbo
import bayesian_optimization_tpu_torch as tbo
from bayesian_optimization_tpu.models import GaussianProcess as JGP
from bayesian_optimization_tpu.models import constant_trend as j_const
from bayesian_optimization_tpu.models.likelihood import PosteriorState as JState
from bayesian_optimization_tpu.ops.optimize import maximize_restarts as j_maximize
from bayesian_optimization_tpu.optim.argmax import AcquisitionArgmax as JArgmax
from bayesian_optimization_tpu.optim.argmax import make_unit_criterion as j_criterion
from bayesian_optimization_tpu_torch.models import GaussianProcess as TGP
from bayesian_optimization_tpu_torch.ops.optimize import maximize_restarts as t_maximize
from bayesian_optimization_tpu_torch.optim.argmax import AcquisitionArgmax as TArgmax
from bayesian_optimization_tpu_torch.optim.argmax import make_unit_criterion as t_criterion

torch.set_num_threads(1)  # one thread per pytest worker: more oversubscribe the cores


def mixed_obj(x):
    r0, r1, i0, c0 = x[0], x[1], x[2], x[3]
    return float(r0) ** 2 + float(r1) ** 2 + abs(int(i0) - 5) / 5.0 + {"A": 0.0, "B": 0.7, "C": 1.5}[c0]


def mixed_space(pkg):
    s = (pkg.RealSpace([[-3.0, 3.0]] * 2, var_name="r") + pkg.IntegerSpace([0, 10], var_name="i")
         + pkg.DiscreteSpace(["A", "B", "C"], var_name="c"))
    s.random_seed = 0
    return s


def _carry(jgp):
    d = jgp.posterior.X.shape[1]
    tgp = TGP(thetaL=1e-3 * np.ones(d), thetaU=1e3 * np.ones(d), device="cpu")
    return tgp.load_fitted(jgp.theta_, {k: np.asarray(v) for k, v in jgp.posterior._asdict().items()},
                           jgp.config._asdict())


def _fit(X, y):
    """A JAX fit on standardized y, and the EI/MGFI plugin: the best y."""
    d = X.shape[1]
    gp = JGP(mean=j_const(d), corr="matern", thetaL=1e-3 * np.ones(d), thetaU=1e3 * np.ones(d),
             nugget=1e-6, random_start=10, random_state=0)
    y = (y - y.mean()) / y.std()
    gp.fit(X, y)
    return gp, float(y.min())


def _criterion64(jgp, enc_j, acq, params):
    """The JAX criterion in float64 on jgp's posterior: U (k, dim) -> (k,)."""
    with jax.enable_x64():
        state = JState(**{k: jnp.asarray(np.asarray(v), jnp.float64)
                          for k, v in jgp.posterior._asdict().items()})
        enc = type(enc_j)(enc_j.space, dtype=jnp.float64)
        crit = jax.jit(j_criterion(enc, state, jgp.config, acq,
                                   {k: jnp.float64(v) for k, v in params.items()}))

    def value(U):
        with jax.enable_x64():
            return np.asarray(crit(jnp.asarray(np.atleast_2d(U), jnp.float64)))

    return value


@pytest.fixture(scope="module")
def real_fit():
    X = np.random.default_rng(11).uniform(0, 1, (60, 5))
    jgp, ymin = _fit(X, ((X - 0.35) ** 2).sum(1))
    return jgp, _carry(jgp), jbo.RealSpace([[0.0, 1.0]] * 5).encoding(), \
        tbo.RealSpace([[0.0, 1.0]] * 5).encoding(), ymin


@pytest.fixture(scope="module")
def mixed_fit():
    space_j = mixed_space(jbo)
    enc_j = space_j.encoding()
    raw = space_j.sample(60, method="LHS")
    jgp, ymin = _fit(enc_j.unit_to_embed_np(enc_j.encode_unit(raw)),
                     np.array([mixed_obj(list(r)) for r in raw]))
    return jgp, _carry(jgp), enc_j, mixed_space(tbo).encoding(), ymin


@pytest.mark.parametrize("acq", ["EI", "MGFI"])
@pytest.mark.parametrize("space", ["real", "mixed"])
def test_criterion_against_jax_float64(real_fit, mixed_fit, space, acq):
    """The port's float32 criterion over 2000 random points, against the
    JAX criterion in float64, where the value is at least half the best;
    the JAX package's own float32 error there is printed beside (run with
    -s to read both)."""
    jgp, tgp, enc_j, enc_t, ymin = mixed_fit if space == "mixed" else real_fit
    params = {"plugin": ymin} if acq == "EI" else {"plugin": ymin, "t": 2.0}
    U = np.random.default_rng(0).uniform(0, 1, (2000, enc_t.dim)).astype(np.float32)
    v64 = _criterion64(jgp, enc_j, acq, params)(U)
    v_j = np.asarray(jax.jit(j_criterion(enc_j, jgp.posterior, jgp.config, acq,
                                         {k: jnp.float32(v) for k, v in params.items()}))(U))
    crit = t_criterion(enc_t, tgp.posterior, tgp.config, acq,
                       {k: torch.tensor(v, dtype=torch.float32) for k, v in params.items()})
    with torch.no_grad():
        v_t = crit(torch.tensor(U)).double().numpy()
    top = v64 >= 0.5 * v64.max()
    err_t, err_j = (np.abs(v - v64)[top] / np.abs(v64[top]) for v in (v_t, v_j))
    print(f"\n{space} {acq}: rel err against float64 over {int(top.sum())} points: port max "
          f"{err_t.max():.2e} median {np.median(err_t):.2e}; JAX float32 max {err_j.max():.2e} "
          f"median {np.median(err_j):.2e}")
    assert err_t.max() < 1e-4


@pytest.mark.parametrize("acq", ["EI", "MGFI"])
@pytest.mark.parametrize("method", ["OnePlusOne_Cholesky_CMA", "SMC", "MIES"])
def test_engine_reaches_the_jax_value(real_fit, mixed_fit, method, acq):
    jgp, tgp, enc_j, enc_t, ymin = mixed_fit if method == "MIES" else real_fit
    params = {"plugin": ymin} if acq == "EI" else {"plugin": ymin, "t": 2.0}
    u_j, v_j = JArgmax(enc_j, method=method, seed=0)(jgp.posterior, jgp.config, acq, params)
    am = TArgmax(enc_t, method=method, seed=0, device="cpu")
    u_t, v_t = am(tgp.posterior, tgp.config, acq, params)
    assert am.method == method and u_t.shape == (enc_t.dim,)
    assert np.all((u_t >= 0) & (u_t <= 1)) and np.isfinite(v_t)
    assert v_t >= 0.99 * v_j, (v_t, v_j)
    # the JAX criterion (in float64) at the port's winner gives the port's value
    v_jt = float(_criterion64(jgp, enc_j, acq, params)(u_t)[0])
    assert abs(v_jt - v_t) <= 1e-4 * abs(v_t), (v_jt, v_t)


def test_auto_picks_mies_on_the_mixed_space(mixed_fit):
    enc_t = mixed_fit[3]
    am = TArgmax(enc_t, seed=0, device="cpu")
    assert am.method == "MIES" and (am.n_mies_restarts, am.n_mies_generations) == (5, 80)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_batch_bfgs_matches_jax_lane_for_lane(real_fit, dtype):
    """q = 4 MGFI criteria with their own t, every criterion's pool the same
    full x0_seed, each value as _bfgs_argmax_batch gives it, in each
    package run in float32 and in float64. In float64 the winners are the
    same points within 1e-3 and the values agree within 1e-6. In float32
    the values agree within 1e-3 and the winners within 1e-2 only: the
    optima are flat at float32's resolution (at t = 4 the two winners lie
    2.7e-3 apart, where the float64 criterion differs by 1.8e-5 relative),
    so the lanes stop at different points of them; the float64 criterion
    at both winners agrees within 1e-4, which is that flatness."""
    jgp, tgp, enc_j, enc_t, ymin = real_fit
    pars = [{"plugin": ymin, "t": t} for t in (0.5, 1.0, 2.0, 4.0)]
    x0 = np.random.default_rng(3).uniform(0, 1, (25, 5))
    if dtype == "f64":
        with jax.enable_x64():
            state = JState(**{k: jnp.asarray(np.asarray(v), jnp.float64)
                              for k, v in jgp.posterior._asdict().items()})
            us_j, vs_j = JArgmax(type(enc_j)(enc_j.space, dtype=jnp.float64), method="BFGS",
                                 n_restart=25, seed=0).batch(state, jgp.config, "MGFI", pars,
                                                             x0_seed=x0)
        post = tgp.posterior._replace(**{k: v.double() for k, v in tgp.posterior._asdict().items()})
        enc = type(enc_t)(enc_t.space, dtype=torch.float64)
    else:
        us_j, vs_j = JArgmax(enc_j, method="BFGS", n_restart=25, seed=0).batch(
            jgp.posterior, jgp.config, "MGFI", pars, x0_seed=x0)
        post, enc = tgp.posterior, enc_t
    us_t, vs_t = TArgmax(enc, method="BFGS", n_restart=25, seed=0, device="cpu").batch(
        post, tgp.config, "MGFI", pars, x0_seed=x0)
    assert len(us_t) == len(vs_t) == 4
    v_tol, u_tol = (1e-6, 1e-3) if dtype == "f64" else (1e-3, 1e-2)
    for u_t, v_t, u_j, v_j, p in zip(us_t, vs_t, us_j, vs_j, pars):
        assert abs(v_t - v_j) <= v_tol * abs(v_j), (v_t, v_j)
        np.testing.assert_allclose(u_t, u_j, rtol=0, atol=u_tol)
        v_at_t, v_at_j = _criterion64(jgp, enc_j, "MGFI", p)(np.stack([u_t, u_j]))
        assert abs(v_at_t - v_t) <= 1e-4 * abs(v_t), (v_at_t, v_t)
        assert abs(v_at_t - v_at_j) <= 1e-4 * abs(v_at_j), (v_at_t, v_at_j)


@pytest.fixture(scope="module")
def sin_fit():
    """The multimodal posterior of tests/test_torch_bo.py (sum sin(3x), n = 60, d = 5)."""
    X = np.random.default_rng(11).uniform(0, 1, (60, 5))
    jgp, ymin = _fit(X, np.sin(3 * X).sum(1))
    return jgp, _carry(jgp), jbo.RealSpace([[0.0, 1.0]] * 5).encoding(), \
        tbo.RealSpace([[0.0, 1.0]] * 5).encoding(), ymin


def _lanes_apart(a, b, tol=1e-3):
    """Lanes whose end points or values differ beyond tol (values relative)."""
    (xa, fa), (xb, fb) = a, b
    far = (np.abs(xa - xb).max(-1) > tol) | (np.abs(fa - fb) > tol * np.abs(fa))
    return set(np.flatnonzero(far).tolist())


def test_batch_lanes_apart_from_jax_are_rounding_sensitive(sin_fit):
    """On the multimodal sin posterior the float32 batch and the JAX
    package's end in other optima (ROADMAP Queue 3). The witness that this
    is rounding, not a fault of the flattened batch: replayed in float64,
    lane by lane from the same 25 starts of each of q = 4 MGFI criteria,
    every lane that ends apart between the packages (or between the port's
    flattened q x R run and its per-criterion runs, whose GEMMs differ in
    width) is one that a 4-ulp move of its start sends elsewhere within one
    package alone; every other lane ends at the same point in all runs."""
    jgp, tgp, enc_j, enc_t, ymin = sin_fit
    ts = (0.5, 1.0, 2.0, 4.0)
    x0 = np.random.default_rng(3).uniform(0, 1, (25, 5))
    moved = x0 * (1 + 4 * np.finfo(np.float64).eps)
    fields = {k: np.asarray(v) for k, v in jgp.posterior._asdict().items()}
    with jax.enable_x64():
        state = JState(**{k: jnp.asarray(v, jnp.float64) for k, v in fields.items()})
        enc = type(enc_j)(enc_j.space, dtype=jnp.float64)
        lo, hi = jnp.zeros(5, jnp.float64), jnp.ones(5, jnp.float64)

        @jax.jit
        def j_run(x, t):
            crit = j_criterion(enc, state, jgp.config, "MGFI", {"plugin": jnp.float64(ymin), "t": t})
            res = j_maximize(lambda u: crit(u[None, :])[0], x, lo, hi, max_iter=40)
            return res.x, res.fun

        def jax_lanes(x):
            return [tuple(np.asarray(a, float) for a in j_run(jnp.asarray(x), jnp.float64(t)))
                    for t in ts]

        jax_ends, jax_moved = jax_lanes(x0), jax_lanes(moved)
    post = tgp.posterior._replace(**{k: torch.tensor(v, dtype=torch.float64) for k, v in fields.items()})
    enc64 = type(enc_t)(enc_t.space, dtype=torch.float64)
    zero = torch.zeros(5, dtype=torch.float64)

    def port_lanes(x, t_lanes, lane_index):
        crit = t_criterion(enc64, post, tgp.config, "MGFI",
                           {"plugin": torch.tensor(ymin, dtype=torch.float64),
                            "t": torch.tensor(t_lanes, dtype=torch.float64)})
        res = t_maximize(crit, torch.as_tensor(x, dtype=torch.float64), zero, zero + 1, max_iter=40,
                         lane_index=lane_index)
        return res.x.numpy(), res.fun.numpy()

    def flattened(x):
        xs, fs = port_lanes(np.tile(x, (4, 1)), np.repeat(ts, 25), True)
        return list(zip(xs.reshape(4, 25, 5), fs.reshape(4, 25)))

    port_ends, port_moved = flattened(x0), flattened(moved)
    apart = 0
    for i, t in enumerate(ts):
        sensitive = _lanes_apart(jax_ends[i], jax_moved[i]) | _lanes_apart(port_ends[i], port_moved[i])
        one = port_lanes(x0, t, False)
        for other in (jax_ends[i], one):
            lanes = _lanes_apart(port_ends[i], other)
            assert lanes <= sensitive, (t, sorted(lanes), sorted(sensitive))
            apart += len(lanes)
        # the winners' values agree, wherever the winning lane ends
        assert abs(port_ends[i][1].max() - jax_ends[i][1].max()) <= 1e-3 * jax_ends[i][1].max()
    assert apart > 0  # the posterior does have rounding-sensitive lanes


def test_batch_refuses_mismatched_parameter_keys(real_fit):
    _, tgp, _, enc_t, _ = real_fit
    with pytest.raises(ValueError):
        TArgmax(enc_t, method="BFGS", device="cpu").batch(
            tgp.posterior, tgp.config, "MGFI", [{"t": 1.0, "plugin": 0.0}, {"t": 2.0}])


@pytest.mark.parametrize("method", ["OnePlusOne_Cholesky_CMA", "SMC"])
def test_batch_derivative_free_gives_each_criterion_its_own_winner(real_fit, method):
    """q = 3 UCB criteria as one population: each value is its criterion's
    at its winner, and a larger alpha never gives a smaller value."""
    _, tgp, _, enc_t, _ = real_fit
    alphas = (0.1, 1.0, 4.0)
    us, vs = TArgmax(enc_t, method=method, seed=1, device="cpu").batch(
        tgp.posterior, tgp.config, "UCB", [{"alpha": a} for a in alphas])
    mu, mse = tgp.predict(np.stack(us), eval_MSE=True)
    np.testing.assert_allclose(vs, -mu + np.asarray(alphas) * np.sqrt(np.maximum(mse, 0)), rtol=1e-4,
                               atol=1e-5)
    assert vs[0] <= vs[1] <= vs[2]


def test_argmax_x0_seed_injection():
    """tests/test_optim.py's case: x0_seed overwrites the head of a pool
    (and of each criterion's pool in a batch); a seed at the criterion's
    optimum is never beaten by the random pool."""
    from bayesian_optimization_tpu.optim.argmax import _inject_seeds as j_inject
    from bayesian_optimization_tpu_torch.optim.argmax import _inject_seeds

    for shape, seeds in (((5, 3), np.full((2, 3), 0.5)), ((4, 5, 3), np.full((1, 3), 0.25))):
        got = _inject_seeds(torch.zeros(shape), seeds).numpy()
        want = np.asarray(j_inject(jnp.zeros(shape), seeds, jnp.float32))
        assert np.array_equal(got, want)
        assert np.all(got[..., :len(seeds), :] == seeds[0, 0]) and np.all(got[..., len(seeds):, :] == 0.0)

    rng = np.random.default_rng(0)
    X = rng.uniform(0, 1, (40, 2))
    y = ((X - 0.7) ** 2).sum(1)
    gp = TGP(mean=tbo.constant_trend(2), thetaL=1e-2 * np.ones(2), thetaU=1e2 * np.ones(2), nugget=1e-6,
             random_state=0, device="cpu").fit(X, (y - y.mean()) / y.std())
    enc = tbo.RealSpace([[0.0, 1.0]] * 2).encoding()
    pars = {"plugin": float(y.min())}
    _, v1 = TArgmax(enc, method="BFGS", n_restart=4, seed=0, device="cpu")(gp.posterior, gp.config, "EI", pars)
    _, v2 = TArgmax(enc, method="BFGS", n_restart=4, seed=0, device="cpu")(
        gp.posterior, gp.config, "EI", pars, x0_seed=np.asarray([[0.7, 0.7]]))
    assert v2 >= v1 - 1e-6, (v1, v2)

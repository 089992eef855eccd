"""The port's mixed-integer ES against the JAX package on the CPU: the
variation step given the JAX package's draws, the selection with ties and
non-finite values, and the engine and host class on tests/test_optim.py's
mixed space."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesian_optimization_tpu import (
    BoolSpace as JBool, DiscreteSpace as JDisc, IntegerSpace as JInt, OrdinalSpace as JOrd,
    RealSpace as JReal,
)
from bayesian_optimization_tpu.optim import mies as jmies
from bayesian_optimization_tpu_torch import BoolSpace, DiscreteSpace, IntegerSpace, OrdinalSpace, RealSpace
from bayesian_optimization_tpu_torch.models.convert import mies_state_from_numpy
from bayesian_optimization_tpu_torch.optim import mies as tmies

torch.set_num_threads(1)  # one thread per pytest worker: more oversubscribe the cores

R, MU, LAM = 3, 4, 10


def mixed_space(pkg_spaces):
    Real, Int, Ord, Disc, Bool = pkg_spaces
    return (
        Real([-3, 3], var_name="r") + Int([0, 10], var_name="i")
        + Ord(["a", "b", "c"], var_name="o") + Disc(["x", "y", "z"], var_name="c")
        + Bool(var_name="b")
    )


T_SPACES = (RealSpace, IntegerSpace, OrdinalSpace, DiscreteSpace, BoolSpace)
J_SPACES = (JReal, JInt, JOrd, JDisc, JBool)


def _jax_draws(key, dim):
    """The draws the JAX package's _variation makes from `key`, in its order."""
    keys = jax.random.split(key, 12)
    big, one = (R, LAM, dim), (R, LAM, 1)
    gk1, gk2 = jax.random.split(keys[9])
    geo = lambda k: jax.random.uniform(k, big, jnp.float32, minval=1e-12, maxval=1.0)
    raw = dict(
        p1=jax.random.randint(keys[0], (R, LAM), 0, MU), p2=jax.random.randint(keys[1], (R, LAM), 0, MU),
        dom=jax.random.uniform(keys[2], big), g_r=jax.random.normal(keys[3], one),
        l_r=jax.random.normal(keys[4], big), g_i=jax.random.normal(keys[5], one),
        l_i=jax.random.normal(keys[6], big), g_d=jax.random.normal(keys[7], one),
        Z=jax.random.normal(keys[8], big), geo1=geo(gk1), geo2=geo(gk2),
        flip=jax.random.uniform(keys[10], big), u_new=jax.random.uniform(keys[11], big),
    )
    return tmies.MIESDraws(**{k: torch.tensor(np.asarray(v)) for k, v in raw.items()})


@pytest.mark.parametrize("seed", [0, 1])
def test_variation_given_jax_draws(seed):
    enc_j = mixed_space(J_SPACES).encoding()
    spec_j = jmies.MIESSpec.from_encoding(enc_j)
    spec_t = tmies.MIESSpec.from_encoding(mixed_space(T_SPACES).encoding())
    assert tuple(spec_t) == tuple(spec_j)
    r = np.random.default_rng(seed)
    dim = enc_j.dim
    state0 = jmies.init_mies(jax.random.PRNGKey(seed), spec_j, R, MU)
    # strategy parameters spread around their initial values
    strength = np.asarray(state0.strength) * r.uniform(0.3, 3.0, (R, MU, dim))
    fields = dict(x=np.asarray(state0.x), strength=strength.astype(np.float32),
                  f=r.normal(0, 1, (R, MU)).astype(np.float32))
    js = state0._replace(strength=jnp.asarray(fields["strength"]), f=jnp.asarray(fields["f"]))
    _, x_j, s_j = jax.jit(lambda s: jmies._variation(s, spec_j, LAM))(js)
    ts = mies_state_from_numpy(fields, torch.Generator(), "cpu")
    _, x_t, s_t = tmies._variation(ts, spec_t, LAM, draws=_jax_draws(js.key, dim))
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("elitism", [False, True])
def test_mies_select_with_ties_and_inf(elitism):
    r = np.random.default_rng(4)
    dim = 5
    f_par = np.array([[1.0, 2.0, 2.0, np.inf], [0.5, 0.5, 3.0, 1.0], [np.nan, 4.0, 1.0, 1.0]], np.float32)
    f_off = np.round(r.normal(1.5, 1.0, (R, LAM)), 1).astype(np.float32)  # rounded: many ties
    f_off[0, [2, 5]] = np.inf
    f_off[1, 3] = np.nan
    f_off[2, 7] = -np.inf
    fields = dict(x=r.uniform(0, 1, (R, MU, dim)), strength=r.uniform(0, 1, (R, MU, dim)), f=f_par)
    fields = {k: np.asarray(v, np.float32) for k, v in fields.items()}
    x_off = r.uniform(0, 1, (R, LAM, dim)).astype(np.float32)
    s_off = r.uniform(0, 1, (R, LAM, dim)).astype(np.float32)
    js = jmies.MIESState(**{k: jnp.asarray(v) for k, v in fields.items()}, key=jax.random.PRNGKey(0))
    want = jax.jit(lambda s, x, st, f: jmies._mies_select(s, x, st, f, elitism))(
        js, jnp.asarray(x_off), jnp.asarray(s_off), jnp.asarray(f_off))
    got = tmies._mies_select(mies_state_from_numpy(fields, torch.Generator(), "cpu"),
                             torch.tensor(x_off), torch.tensor(s_off), torch.tensor(f_off), elitism)
    for name in ("x", "strength", "f"):
        assert np.array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                              equal_nan=True), name


def test_run_mies_mixed_unit():
    enc = mixed_space(T_SPACES).encoding()
    spec = tmies.MIESSpec.from_encoding(enc)

    # target: r=0, i level=5, o='b'(lvl 1), c='y'(lvl 1), b=True(lvl 1)
    def fun(U):
        lev = enc.unit_levels(U).to(U.dtype)
        r = U[:, 0] * 6 - 3
        return (r**2 + (lev[:, 1] - 5.0).abs() + (lev[:, 2] - 1.0).abs()
                + (lev[:, 3] - 1.0).abs() + (lev[:, 4] - 1.0).abs())

    xb, fb, X, F = tmies.run_mies(torch.Generator().manual_seed(0), fun, spec, n_restarts=8,
                                  n_generations=60)
    assert float(fb) < 0.05, float(fb)
    lev = enc.unit_levels(xb[None, :])[0].numpy()
    assert lev[1] == 5 and lev[2] == 1 and lev[3] == 1 and lev[4] == 1
    assert X.shape == (8 * MU, enc.dim) and F.shape == (8 * MU,)


def test_mies_class_host_mixed():
    space = mixed_space(T_SPACES)
    space.random_seed = 0

    def obj(x):
        r, i, o, c, b = x
        return float(r) ** 2 + abs(int(i) - 4) + (0 if o == "c" else 1) + (0 if c == "x" else 1) + (0 if b else 1)

    opt = tmies.MIES(space, obj, max_eval=600, n_restarts=4, random_seed=0, device="cpu")
    xopt, fopt, stop = opt.optimize()
    assert fopt < 1.5
    r, i, o, c, b = xopt
    assert isinstance(float(r), float) and float(i).is_integer()
    assert o in ("a", "b", "c") and c in ("x", "y", "z")
    assert stop.get("max_eval") or "ftarget" in stop


def test_mies_stops_on_max_eval():
    calls = {"n": 0}

    def obj(x):
        calls["n"] += 1
        return 0.0 if calls["n"] > 10 else 1.0

    opt = tmies.MIES(mixed_space(T_SPACES), obj, max_eval=200, n_restarts=2, random_seed=1, device="cpu")
    opt.optimize()
    assert opt.eval_count <= 200 + 2 * 10 * 2  # one generation of slack

"""The port's constraint programs (optim/constraints.py), the raw decode
they trace through (SpaceEncoding.unit_to_raw), the feasible-winner
selection and the penalized criterion, against the JAX package on the CPU.
Same numpy inputs to both packages, float64 in both unless stated. The
end-to-end constrained BO runs are in test_torch_constrained_bo.py."""
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
from bayesian_optimization_tpu.optim.argmax import _select_feasible as j_select
from bayesian_optimization_tpu.optim.argmax import make_unit_criterion as j_criterion
from bayesian_optimization_tpu.optim.constraints import ConstraintProgram as JCP
from bayesian_optimization_tpu.utils.exceptions import ConstraintEvaluationError as JCEE
from bayesian_optimization_tpu_torch.models import GaussianProcess as TGP
from bayesian_optimization_tpu_torch.optim.argmax import _select_feasible as t_select
from bayesian_optimization_tpu_torch.optim.argmax import make_unit_criterion as t_criterion
from bayesian_optimization_tpu_torch.optim.constraints import ConstraintProgram as TCP
from bayesian_optimization_tpu_torch.utils.exceptions import ConstraintEvaluationError as TCEE

torch.set_num_threads(1)  # one thread per pytest worker: more oversubscribe the cores


def _h(x):  # tests/test_constrained_bo.py's equality: numpy on the raw row
    return np.sum(x) - 1


def _h_host(x):  # np.array coercion: runs on the host in both packages
    return float(np.sum(np.array(list(x), dtype=float))) - 1.0


def _numeric_space(pkg):
    """The space of test_unit_to_raw_matches_decode: log10 real, real,
    integer, bool."""
    return (pkg.RealSpace([1e-3, 1e3], var_name="lr", scale="log10")
            + pkg.RealSpace([-5, 5], var_name="x")
            + pkg.IntegerSpace([2, 20], var_name="k")
            + pkg.BoolSpace(var_name="flag"))


def _levels_space(pkg):
    """Numeric and string level tables and the other real scales."""
    return (pkg.RealSpace([1e-2, 10.0], var_name="a", scale="log")
            + pkg.RealSpace([-3.0, 3.0], var_name="b", scale="bilog")
            + pkg.DiscreteSpace([0.5, 2.0, 8.0], var_name="c")
            + pkg.DiscreteSpace(["u", "v"], var_name="s"))


def _mixed_dict_space(pkg):
    """tests/test_constrained_bo.py's dict-eval space."""
    return (pkg.IntegerSpace([1, 10], var_name="mu") + pkg.IntegerSpace([1, 10], var_name="lam")
            + pkg.RealSpace([0, 1], var_name="pc") + pkg.RealSpace([0.005, 0.5], var_name="p"))


def _enc64(pkg, space):
    return space.encoding(dtype=jnp.float64 if pkg is jbo else torch.float64)


@pytest.mark.parametrize("space_fn", [_numeric_space, _levels_space])
def test_unit_to_raw_matches_jax_and_decode(space_fn):
    U = np.random.default_rng(3).uniform(0, 1, (16, 4))
    with jax.enable_x64():
        got_j = np.asarray(_enc64(jbo, space_fn(jbo)).unit_to_raw(jnp.asarray(U)))
    enc_t = _enc64(tbo, space_fn(tbo))
    got_t = enc_t.unit_to_raw(torch.tensor(U)).numpy()
    np.testing.assert_array_equal(np.isnan(got_t), np.isnan(got_j))
    ok = ~np.isnan(got_j)
    assert np.abs(got_t[ok] - got_j[ok]).max() <= 1e-10 * max(1.0, np.abs(got_j[ok]).max())
    want = enc_t.decode_unit(U)
    for j in range(enc_t.dim):
        if isinstance(want[0, j], str):
            assert np.isnan(got_t[:, j]).all()
            continue
        w = np.array([float(v) for v in want[:, j]])
        assert np.allclose(got_t[:, j], w, rtol=1e-4, atol=1e-4), f"col {j}"


def test_unit_to_raw_gradient_matches_jax():
    """Reals pass gradient through their scale; levels and the clamp outside
    [0, 1] pass none, as jnp.clip and the level lookup do."""
    U = np.random.default_rng(4).uniform(-0.2, 1.2, (12, 4))
    w = np.random.default_rng(5).standard_normal(4)
    with jax.enable_x64():
        enc_j = _enc64(jbo, _numeric_space(jbo))
        g_j = np.asarray(jax.grad(lambda u: jnp.sum(jnp.tanh(enc_j.unit_to_raw(u) * 1e-3) @ w))(
            jnp.asarray(U)))
    Ut = torch.tensor(U, requires_grad=True)
    enc_t = _enc64(tbo, _numeric_space(tbo))
    (torch.tanh(enc_t.unit_to_raw(Ut) * 1e-3) @ torch.tensor(w)).sum().backward()
    assert np.abs(Ut.grad.numpy() - g_j).max() <= 1e-10 * np.abs(g_j).max()
    assert np.all(Ut.grad.numpy()[:, 2:] == 0.0)


CALLABLES = {
    "np_sum_eq": (lambda pkg: pkg.RealSpace([0, 1]) * 2, dict(h=_h), "list"),
    "np_array_eq": (lambda pkg: pkg.RealSpace([0, 1]) * 2, dict(h=_h_host), "list"),
    "index_eq_list_ineq": (lambda pkg: pkg.RealSpace([0, 2]) * 3,
                           dict(h=lambda x: x[0] + x[1] - 1, g=lambda x: [x[2] - 1.5, -x[0]]),
                           "list"),
    "batch_ineq": (lambda pkg: pkg.RealSpace([0, 1]) * 3, dict(g=lambda x: x[0] + x[1] - 1.2), "list"),
    "dict_ineq": (_mixed_dict_space, dict(g=lambda x: [-x["pc"], x["mu"] - 1.9]), "dict"),
    "string_level_ineq": (lambda pkg: pkg.DiscreteSpace(["1", "2", "3"], var_name="lam")
                          + pkg.RealSpace([0, 1], var_name="pc"),
                          dict(g=lambda x: x[1] - 0.5), "list"),
}


@pytest.mark.parametrize("case", sorted(CALLABLES))
def test_program_shape_and_traceable_match_jax(case):
    space_fn, fns, eval_type = CALLABLES[case]
    sj, st = space_fn(jbo), space_fn(tbo)
    cj = JCP(sj.encoding(), eval_type=eval_type, var_names=sj.var_name, **fns)
    ct = TCP(st.encoding(), eval_type=eval_type, var_names=st.var_name, device="cpu", **fns)
    assert (ct.n_h, ct.n_g, ct.traceable) == (cj.n_h, cj.n_g, cj.traceable)


def test_crashing_constraint_raises_in_both():
    """tests/test_constrained_bo.py's bad constraint: squares a string."""
    def fn(x):
        return sum(np.array(list(x)) ** 2)

    for pkg, cp, err, kw in ((jbo, JCP, JCEE, {}), (tbo, TCP, TCEE, {"device": "cpu"})):
        space = (pkg.DiscreteSpace(["1", "2", "3"], var_name="lam") + pkg.RealSpace([0, 1], var_name="pc")
                 + pkg.RealSpace([0.005, 0.5], var_name="p"))
        with pytest.raises(err):
            cp(space.encoding(), g=fn, **kw)


def _programs64(case):
    space_fn, fns, eval_type = CALLABLES[case]
    sj, st = space_fn(jbo), space_fn(tbo)
    with jax.enable_x64():
        cj = JCP(_enc64(jbo, sj), eval_type=eval_type, var_names=sj.var_name, **fns)
    ct = TCP(_enc64(tbo, st), eval_type=eval_type, var_names=st.var_name, device="cpu", **fns)
    return cj, ct


@pytest.mark.parametrize("case", ["index_eq_list_ineq", "dict_ineq", "np_sum_eq"])
def test_h_g_penalty_and_gradient_match_jax(case):
    cj, ct = _programs64(case)
    U = np.random.default_rng(0).uniform(0, 1, (8, ct.encoding.dim))
    with jax.enable_x64():
        Uj = jnp.asarray(U)
        hj, gj = cj.h_unit(Uj), cj.g_unit(Uj)
        pj = np.asarray(cj.penalty(Uj, 30.0))
        dj = np.asarray(jax.grad(lambda u: jnp.sum(cj.penalty(u, 30.0)))(Uj))
    Ut = torch.tensor(U, requires_grad=True)
    for a, b in ((ct.h_unit(Ut), hj), (ct.g_unit(Ut), gj)):
        assert (a is None) == (b is None)
        if a is not None:
            assert np.abs(a.detach().numpy() - np.asarray(b)).max() <= 1e-10
    pt = ct.penalty(Ut, 30.0)
    (dt,) = torch.autograd.grad(pt.sum(), Ut)
    assert pj.max() > 0.0  # some rows violate
    assert np.abs(pt.detach().numpy() - pj).max() <= 1e-10 * max(1.0, pj.max())
    assert np.abs(dt.numpy() - dj).max() <= 1e-10 * max(1.0, np.abs(dj).max())


def test_penalty_gradient_numbers():
    """test_constraint_penalty_gradient_exists's numbers, float32: g = u0 +
    u1 - 1 = 0.8 at (0.9, 0.9), d/du (t C) g^2 = 5 * 2 g = 8; zero penalty
    and gradient where feasible."""
    cp = TCP((tbo.RealSpace([0, 1]) * 2).encoding(), g=lambda x: x[0] + x[1] - 1, device="cpu")
    for u, want in (([0.9, 0.9], 8.0), ([0.2, 0.2], 0.0)):
        U = torch.tensor([u], requires_grad=True)
        (g,) = torch.autograd.grad(cp.penalty(U, 10.0).sum(), U)
        assert np.allclose(g.numpy(), want, atol=1e-3)


@pytest.mark.parametrize("case", ["index_eq_list_ineq", "dict_ineq", "np_array_eq"])
def test_feasibility_matches_jax(case):
    cj, ct = _programs64(case)
    U = np.random.default_rng(1).uniform(0, 1, (32, ct.encoding.dim))
    with jax.enable_x64():
        fj = np.asarray(cj.feasible_in_program(jnp.asarray(U)))
    ft = ct.feasible_in_program(torch.tensor(U)).numpy()
    np.testing.assert_array_equal(ft, fj)
    assert 0 < fj.sum() < len(fj) or case == "np_array_eq"
    rows = [list(r) for r in ct.encoding.decode_unit(U)]
    np.testing.assert_array_equal(ct.feasible_rows(rows), cj.feasible_rows(rows))


def test_host_path_counts_its_syncs():
    cp = TCP((tbo.RealSpace([0, 1]) * 2).encoding(), h=_h_host, device="cpu")
    assert not cp.traceable and cp.host_calls == 0
    U = torch.rand(5, 2, dtype=torch.float64)
    hv = cp.h_unit(U)
    assert cp.host_calls == 1 and hv.shape == (5, 1)
    assert np.allclose(hv.numpy()[:, 0], U.numpy().sum(1) - 1.0, atol=1e-6)


def test_select_feasible_matches_jax():
    """JAX's three-row case (the best row infeasible) and the no-feasible
    fallback."""
    X = np.asarray([[0.9, 0.1], [0.3, 0.2], [0.1, 0.9]], np.float32)
    F = np.asarray([3.0, 1.0, 2.0], np.float32)
    for g, want_x, want_f in ((lambda x: x[0] - 0.5, [0.1, 0.9], 2.0),
                              (lambda x: x[0] + 10.0, [0.9, 0.1], 3.0)):
        cj = JCP((jbo.RealSpace([0, 1]) * 2).encoding(), g=g)
        ct = TCP((tbo.RealSpace([0, 1]) * 2).encoding(), g=g, device="cpu")
        xj, fj = j_select(cj, jnp.asarray(X), jnp.asarray(F), jnp.asarray(X[0]), jnp.asarray(F[0]))
        Xt, Ft = torch.tensor(X), torch.tensor(F)
        xt, ft = t_select(ct, Xt, Ft, Xt[0], Ft[0])
        assert xt.shape == (1, 2) and ft.shape == (1,)
        np.testing.assert_allclose(xt[0].numpy(), np.asarray(xj))
        assert float(ft[0]) == float(fj) == want_f
        np.testing.assert_allclose(xt[0].numpy(), want_x)


def test_select_feasible_per_group():
    """q = 3 criteria of 4 lanes each: each group picks its own best feasible
    lane; a group with none keeps its own fallback, never another group's
    feasible lane."""
    ct = TCP((tbo.RealSpace([0, 1]) * 2).encoding(), g=lambda x: x[0] - 0.5, device="cpu")
    X = torch.tensor([[0.9, 0.0], [0.4, 0.1], [0.2, 0.2], [0.8, 0.3],   # group 0
                      [0.7, 0.4], [0.6, 0.5], [0.9, 0.6], [0.95, 0.7],  # group 1: none feasible
                      [0.1, 0.8], [0.3, 0.9], [0.6, 1.0], [0.0, 0.1]])  # group 2
    F = torch.tensor([9.0, 2.0, 3.0, 8.0, 5.0, 7.0, 6.0, 1.0, 4.0, 6.0, 9.5, 1.0])
    fb_x = torch.tensor([[0.9, 0.0], [0.6, 0.5], [0.6, 1.0]])
    fb_f = torch.tensor([9.0, 7.0, 9.5])
    xb, fb = t_select(ct, X, F, fb_x, fb_f, groups=3)
    np.testing.assert_allclose(xb.numpy(), [[0.2, 0.2], [0.6, 0.5], [0.3, 0.9]])
    np.testing.assert_allclose(fb.numpy(), [3.0, 7.0, 6.0])


@pytest.fixture(scope="module")
def carried_fit():
    """A JAX fit on the constrained objective's samples over [0, 1]^2, the
    port's GP loaded with its posterior (models/convert.py)."""
    X = np.random.default_rng(2).uniform(0, 1, (30, 2))
    y = (X ** 2).sum(1) + 5 * X.sum(1) + 10
    y = (y - y.mean()) / y.std()
    jgp = JGP(mean=j_const(2), corr="matern", thetaL=1e-3 * np.ones(2), thetaU=1e3 * np.ones(2),
              nugget=1e-6, random_start=10, random_state=0)
    jgp.fit(X, y)
    tgp = TGP(thetaL=1e-3 * np.ones(2), thetaU=1e3 * np.ones(2), device="cpu")
    tgp.load_fitted(jgp.theta_, {k: np.asarray(v) for k, v in jgp.posterior._asdict().items()},
                    jgp.config._asdict())
    return jgp, tgp, float(y.min())


@pytest.mark.parametrize("acq", ["MGFI", "EI", "GEI3"])
def test_penalized_criterion_matches_jax(carried_fit, acq):
    """The penalized criterion (traced equality h = sum x - 1, penalty time
    30) and its gradient, on one posterior in both packages, in float64."""
    jgp, tgp, ymin = carried_fit
    params = {"plugin": ymin, "_penalty_t": 30.0}
    if acq == "MGFI":
        params["t"] = 2.0
    U = np.random.default_rng(6).uniform(0, 1, (16, 2))
    cj, ct = _programs64("np_sum_eq")
    with jax.enable_x64():
        state = JState(**{k: jnp.asarray(np.asarray(v), jnp.float64)
                          for k, v in jgp.posterior._asdict().items()})
        crit = j_criterion(cj.encoding, state, jgp.config, acq,
                           {k: jnp.float64(v) for k, v in params.items()}, constraints=cj)
        vj = np.asarray(crit(jnp.asarray(U)))
        gj = np.asarray(jax.grad(lambda u: jnp.sum(crit(u)))(jnp.asarray(U)))
    post = tgp.posterior._replace(**{k: v.double() for k, v in tgp.posterior._asdict().items()})
    crit_t = t_criterion(ct.encoding, post, tgp.config, acq,
                         {k: torch.tensor(v, dtype=torch.float64) for k, v in params.items()},
                         constraints=ct)
    Ut = torch.tensor(U, requires_grad=True)
    vt = crit_t(Ut)
    (gt,) = torch.autograd.grad(vt.sum(), Ut)
    scale = np.abs(vj).max()
    assert np.abs(vt.detach().numpy() - vj).max() <= 1e-8 * scale
    assert np.abs(gt.numpy() - gj).max() <= 1e-8 * np.abs(gj).max()
    # the penalty is what tells the two apart from the unconstrained criterion
    plain = t_criterion(ct.encoding, post, tgp.config, acq,
                        {k: torch.tensor(v, dtype=torch.float64) for k, v in params.items()})
    assert np.abs(plain(Ut).detach().numpy() - vt.detach().numpy()).max() > 1e-3 * scale

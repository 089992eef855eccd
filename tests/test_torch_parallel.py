"""The port's particle mesh (parallel/mesh.py) and the sharded argmax on an
8-entry CPU mesh, against the JAX package on tests/conftest.py's 8 forced
host devices, and against the port's own unsharded engines.

The sharded CMA and SMC engines draw every generation's noise for the whole
padded population from the one generator, so in float64 each lane is the
unsharded lane (held to 1e-10). An L-BFGS lane is independent of the
others, so a sharded run equals the unsharded engine run on each entry's
rows, bit for bit; against ONE unsharded run over the whole pool a lane can
move by up to ~5e-5 even in float64: the CPU's vectorized elementwise
math rounds a row by the batch's live-lane count (1e-16 in the gradient)
and a line-search decision amplifies that (ROADMAP Queue 3). The winner is
held there to 1e-10 relative."""
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
from bayesian_optimization_tpu.optim.argmax import AcquisitionArgmax as JArgmax
from bayesian_optimization_tpu.parallel import make_particle_mesh as j_mesh
from bayesian_optimization_tpu.parallel import shard_population as j_shard
from bayesian_optimization_tpu_torch.models.convert import gpconfig_from_fields, posterior_state_from_numpy
from bayesian_optimization_tpu_torch.optim import argmax as am
from bayesian_optimization_tpu_torch.optim.cma import run_cma
from bayesian_optimization_tpu_torch.optim.constraints import ConstraintProgram
from bayesian_optimization_tpu_torch.optim.smc import run_smc
from bayesian_optimization_tpu_torch.parallel import (
    PARTICLE_AXIS, make_particle_mesh, replicated, shard_population,
)
from bayesian_optimization_tpu_torch.parallel.mesh import ParticleMesh

torch.set_num_threads(1)  # one thread per pytest worker: more oversubscribe the cores

F64 = torch.float64
D = 3


def cpu_mesh(n=8):
    return make_particle_mesh(devices=["cpu"] * n)


@pytest.fixture(scope="module")
def fit():
    """A JAX fit (n = 40, d = 3), its posterior in float64 for both
    packages, and the EI plugin."""
    rng = np.random.default_rng(0)
    X = rng.uniform(0, 1, (40, D))
    y = np.sin(3 * X).sum(1)
    y = (y - y.mean()) / y.std()
    jgp = JGP(mean=j_const(D), corr="matern", thetaL=1e-3 * np.ones(D), thetaU=1e3 * np.ones(D),
              nugget=1e-6, random_start=4, random_state=0)
    jgp.fit(X, y)
    fields = {k: np.asarray(v, np.float64) for k, v in jgp.posterior._asdict().items()}
    t_state = posterior_state_from_numpy(fields, torch.device("cpu"), F64)
    return jgp, fields, t_state, gpconfig_from_fields(jgp.config._asdict()), float(y.min())


def t_encoding():
    enc = tbo.RealSpace([[0.0, 1.0]] * D).encoding()
    return type(enc)(enc.space, dtype=F64)


def t_criterion(fit):
    _, _, state, config, ymin = fit
    return am.make_unit_criterion(t_encoding(), state, config, "EI", {"plugin": torch.tensor(ymin, dtype=F64)})


def test_mesh_has_8_entries():
    mesh = cpu_mesh()
    assert mesh.size == 8 and len(mesh.devices) == 8 and mesh.axis_names == (PARTICLE_AXIS,)
    assert mesh.device == torch.device("cpu") and not mesh.distributed


def test_shard_population_pads_and_places():
    mesh = cpu_mesh()
    x = np.arange(20.0).reshape(10, 2)
    xs = shard_population(torch.tensor(x), mesh)
    assert xs.shape == (16, 2) and xs.spec == ("particles",)  # padded to a multiple of 8
    assert len(xs.chunks) == 8 and all(c.shape == (2, 2) for c in xs.chunks)
    full = torch.cat(xs.chunks).numpy()
    assert np.array_equal(full[:10], x) and not full[10:].any()  # zero tail rows
    js = j_shard(jnp.asarray(x, jnp.float32), j_mesh())
    assert js.shape == xs.shape and js.sharding.spec[0] == xs.spec[0]
    assert np.array_equal(np.asarray(js), full)


def test_sharded_argmin_matches_single_device():
    mesh = cpu_mesh()
    x = torch.tensor(np.random.default_rng(0).uniform(0, 1, (32, 4)))
    single = int(torch.argmin((x ** 2).sum(1)))
    pop = shard_population(x, mesh)
    (sq,) = mesh.gather([(c ** 2).sum(1) for c in pop.chunks])
    assert int(torch.argmin(sq)) == single and mesh.gathers == 1


def test_replicated_copies_a_state_to_every_entry(fit):
    mesh = cpu_mesh(4)
    copies = replicated(mesh).put(fit[2])
    assert len(copies) == 4 and all(type(c) is type(fit[2]) for c in copies)
    assert all(torch.equal(c.L, fit[2].L) for c in copies)


def test_bo_with_mesh_runs_and_matches_types():
    mesh = cpu_mesh()
    gp = tbo.GaussianProcess(
        mean=tbo.constant_trend(2), corr="matern",
        thetaL=1e-3 * np.ones(2), thetaU=1e3 * np.ones(2),
        nugget=1e-6, random_start=8, max_iter=25, random_state=0, device="cpu",
    )
    opt = tbo.BO(
        search_space=tbo.RealSpace([[-5, 5]] * 2, random_seed=0),
        obj_fun=lambda x: float(np.sum(np.asarray(x) ** 2)),
        model=gp, DoE_size=5, max_FEs=10, random_seed=0, mesh=mesh, device="cpu",
    )
    assert opt._argmax.mesh is mesh
    xopt, fopt, _ = opt.run()
    assert opt.eval_count == 10
    assert fopt[0] < 10.0
    assert mesh.gathers == 5  # one gather an ask of the BFGS argmax


def test_bo_device_must_be_the_mesh_device():
    with pytest.raises(ValueError):
        tbo.BO(search_space=tbo.RealSpace([[-5, 5]] * 2), obj_fun=np.sum,
               mesh=ParticleMesh(["cuda:0"]), device="cpu")


def test_bfgs_argmax_mesh_matches_jax_mesh(fit):
    """10 restarts from one fixed pool on both packages' 8-entry meshes,
    both padded to 16 lanes (six from the origin), in float64: winner and
    value within the port's BFGS parity tolerance, 1e-3 relative
    (tests/test_torch_bo.py)."""
    jgp, fields, state, config, ymin = fit
    x0 = np.random.default_rng(3).uniform(0, 1, (10, D))
    with jax.enable_x64():
        enc_j = jbo.RealSpace([[0.0, 1.0]] * D).encoding()
        enc_j = type(enc_j)(enc_j.space, dtype=jnp.float64)
        j_state = JState(**{k: jnp.asarray(v, jnp.float64) for k, v in fields.items()})
        u_j, v_j = JArgmax(enc_j, method="BFGS", n_restart=10, seed=0, mesh=j_mesh())(
            j_state, jgp.config, "EI", {"plugin": jnp.float64(ymin)}, x0_seed=x0)
    mesh = cpu_mesh()
    u_t, v_t = tbo.AcquisitionArgmax(t_encoding(), method="BFGS", n_restart=10, seed=0, mesh=mesh,
                                     device="cpu")(state, config, "EI", {"plugin": ymin}, x0_seed=x0)
    assert mesh.gathers == 1
    assert abs(v_t - v_j) < 1e-3 * abs(v_j), (v_t, v_j)
    assert np.allclose(u_t, np.asarray(u_j), atol=1e-3), (u_t, u_j)


def _pool(n=10, seed=1):
    return torch.rand((n, D), generator=torch.Generator().manual_seed(seed), dtype=F64)


def test_sharded_bfgs_lanes_equal_unsharded(fit):
    crit, mesh = t_criterion(fit), cpu_mesh()
    pop = shard_population(_pool(), mesh)
    x_s, f_s = am._bfgs_lanes([crit] * mesh.size, pop, 40)
    assert mesh.gathers == 1 and x_s.shape == pop.shape
    # each entry's lanes are the unsharded engine's on those rows, bit for bit
    for i, chunk in enumerate(pop.chunks):
        x_u, f_u = am._bfgs_lanes(crit, chunk, 40)
        assert torch.equal(x_u, x_s[2 * i:2 * i + 2]) and torch.equal(f_u, f_s[2 * i:2 * i + 2])
    # one unsharded run over the whole padded pool: the same winner
    x_u, f_u = am._bfgs_lanes(crit, torch.cat(pop.chunks), 40)
    assert abs(float(f_u.max() - f_s.max())) <= 1e-10 * abs(float(f_u.max()))
    assert torch.allclose(x_u[f_u.argmax()], x_s[f_s.argmax()], atol=1e-6)


@pytest.mark.parametrize("engine", ["CMA", "SMC"])
def test_sharded_es_lanes_equal_unsharded(fit, engine):
    crit, mesh = t_criterion(fit), cpu_mesh()
    pop = shard_population(_pool(), mesh)
    full = torch.cat(pop.chunks)
    zeros = torch.zeros(D, dtype=F64)

    def neg(U):
        return -crit(U)

    def gen():
        return torch.Generator().manual_seed(5)

    with torch.no_grad():
        if engine == "CMA":
            ref = run_cma(gen(), neg, full, zeros, zeros + 1.0, 30)
            got = run_cma(gen(), [neg] * mesh.size, pop, zeros, zeros + 1.0, 30)
            gathers = 1
        else:
            ref = run_smc(gen(), neg, full, zeros, zeros + 1.0, 3, 5)
            got = run_smc(gen(), [neg] * mesh.size, pop, zeros, zeros + 1.0, 3, 5)
            gathers = 3 + 1
    assert mesh.gathers == gathers
    for a, b in zip(ref, got):  # winner, its value, every final lane and value
        assert a.shape == b.shape and float((a - b).abs().max()) <= 1e-10


@pytest.mark.parametrize("method", ["BFGS", "OnePlusOne_Cholesky_CMA", "SMC", "MIES"])
def test_argmax_gathers(fit, method):
    """BFGS and CMA gather once a call, SMC once a round plus the final
    reduce; MIES and the batch run unsharded (the JAX package's split)."""
    _, _, state, config, ymin = fit
    mesh = cpu_mesh()
    opt = tbo.AcquisitionArgmax(t_encoding(), method=method, n_restart=10, n_chains=10, max_FEs=320,
                                seed=0, mesh=mesh, device="cpu")
    u, v = opt(state, config, "EI", {"plugin": ymin})
    assert u.shape == (D,) and np.all((u >= 0) & (u <= 1)) and np.isfinite(v)
    want = {"BFGS": 1, "OnePlusOne_Cholesky_CMA": 1, "SMC": opt.n_smc_rounds + 1, "MIES": 0}[method]
    assert mesh.gathers == want
    if method != "MIES":
        us, vs = opt.batch(state, config, "EI", [{"plugin": ymin}] * 2)
        assert len(us) == 2 and mesh.gathers == want


@pytest.mark.parametrize("method", ["OnePlusOne_Cholesky_CMA", "SMC"])
def test_constrained_es_argmax_on_a_mesh_equals_unsharded(fit, method):
    """A constrained argmax (the penalty inside each entry's criterion, the
    feasible preference over the gathered lanes) on the 8-entry mesh, 16
    chains (no padding), equals the unsharded run from the same seed in
    float64 (1e-10): a chain draws what it draws unsharded."""
    _, _, state, config, ymin = fit
    enc = t_encoding()
    cons = ConstraintProgram(enc, g=lambda x: x[0] + x[1] - 1.0, device="cpu")
    assert cons.traceable
    out = []
    for mesh in (cpu_mesh(), None):
        opt = tbo.AcquisitionArgmax(enc, method=method, n_chains=16, max_FEs=320, seed=0, mesh=mesh,
                                    constraints=cons, device="cpu")
        out.append(opt(state, config, "EI", {"plugin": ymin}))
    (u_s, v_s), (u_u, v_u) = out
    assert np.abs(u_s - u_u).max() <= 1e-10 and abs(v_s - v_u) <= 1e-10 * abs(v_u), (u_s, u_u, v_s, v_u)


def test_save_load_with_mesh(tmp_path):
    mesh = cpu_mesh()
    opt = tbo.BO(search_space=tbo.RealSpace([[-5, 5]] * 2, random_seed=0),
                 obj_fun=lambda x: float(np.sum(np.asarray(x) ** 2)), DoE_size=4, max_FEs=6,
                 random_seed=0, mesh=mesh, device="cpu")
    opt.run()
    path = tmp_path / "bo.dill"
    opt.save(str(path))
    assert opt._mesh is mesh and opt._argmax.mesh is mesh  # back after save
    assert b"ParticleMesh" not in path.read_bytes()
    loaded = tbo.BO.load(str(path))
    assert loaded._mesh is None and loaded._argmax.mesh is None  # a loaded BO runs unsharded
    assert loaded.eval_count == 6

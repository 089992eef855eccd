"""The port's posterior-ensemble GP in the loop, on the CPU: the JAX
package's end-to-end BO cases of tests/test_hmc.py (HMC, VI and NUTS
ensembles), one ParallelBO q = 2 ask on a NUTS ensemble, the n >= 512
branch of the fit (MAP-seeded chains, the n/4 warm-up subset, the carried
sampler state, every draw replayed from the same numpy seed as the JAX
package takes it), and the default device without a GPU."""
import numpy as np
import pytest
import torch

import bayesian_optimization_tpu_torch as tbo
from bayesian_optimization_tpu_torch.models import GaussianProcess as TGP
from bayesian_optimization_tpu_torch.models import gp as tgp_module
from bayesian_optimization_tpu_torch.models.hmc import NUTSResult
from bayesian_optimization_tpu_torch.models.trend import constant_trend as t_const

torch.set_num_threads(1)  # one thread per pytest worker: more oversubscribe the cores

D = 2


def test_large_n_branch_draw_order_chains_subset_and_carry(monkeypatch):
    """n = 512, NUTS, with the sampler replaced by a stub that records its
    arguments (the sampler itself is held above). First fit: a half-length
    MLE ladder seeds the chains, its optimum jittered by 0.1 of the bounds'
    width, from standard_normal((C, P)) drawn after the seed integer and the
    rung subsets; the warm-up target is the next n/4 = 256-row subset; no
    carry; n_warmup2 = max(8, n_warm // 4). Second fit: no ladder, the chains
    around the first fit's posterior median, the carried (inv_mass, step).
    Every draw replayed from the same seed."""
    X = np.random.default_rng(3).uniform(0, 1, (512, D))
    y = np.sin(3 * X).sum(1)
    gp = TGP(mean=t_const(D), thetaL=1e-3 * np.ones(D), thetaU=1e3 * np.ones(D), nugget=1e-6,
             optimizer="NUTS", random_state=0, device="cpu", max_iter=8)
    gp.hmc_warmup, gp.n_ensemble = 16, 4
    calls, ladders, subsets = [], [], []
    ladder, stage = gp._run_mle_ladder, gp._subset_stage

    def spy_ladder(*a, **kw):
        out = ladder(*a, **kw)
        ladders.append((kw.get("iters_scale"), out[0].double().numpy()))
        return out

    def spy_stage(Xp, Yp, idx):
        subsets.append(idx)
        return stage(Xp, Yp, idx)

    def stub(gen, logp, x0, lo, hi, **kw):
        calls.append(dict(kw, seed=gen.initial_seed(), x0=x0.double().numpy()))
        C, P = x0.shape
        S = kw["n_samples"]
        return NUTSResult(samples=x0[None].expand(S, C, P), accept_rate=torch.full((C,), 0.8),
                          step_size=torch.full((C,), 0.3), log_prob=torch.zeros(S, C),
                          mean_depth=torch.full((C,), 2.0), inv_mass=torch.full((C, P), 0.5))

    monkeypatch.setattr(gp, "_run_mle_ladder", spy_ladder)
    monkeypatch.setattr(gp, "_subset_stage", spy_stage)
    monkeypatch.setattr(tgp_module, "nuts_sample", stub)
    gp.fit(X, y)
    gp.fit(X, y)

    r = np.random.default_rng(0)
    bounds = np.r_[np.log10(np.c_[1e-3 * np.ones(D), 1e3 * np.ones(D)]),
                   np.log10([[1e-5, max(1e-3, float(np.std(y)) ** 2)]])]
    width = bounds[:, 1] - bounds[:, 0]
    assert len(ladders) == 1 and ladders[0][0] == 0.5 and len(calls) == 2 and len(subsets) == 4
    for k, call in enumerate(calls):
        r.uniform(bounds[:, 0], bounds[:, 1], size=(10, D + 1))  # the starts
        r.choice(512, size=256, replace=False)  # the median heuristic's rows
        assert call["seed"] == int(r.integers(0, 2**31 - 1))
        if k == 0:
            for got, ns in zip(subsets[:2], (256, 512)):  # the ladder's rungs
                np.testing.assert_array_equal(got, r.choice(512, size=ns, replace=False))
            center = ladders[0][1]
            assert "init_inv_mass" not in call
        else:  # the posterior median of the first fit's 4 samples
            center = np.median(calls[0]["x0"][:4], axis=0)
            np.testing.assert_allclose(call["init_inv_mass"].numpy(), 0.5)
            np.testing.assert_allclose(call["init_step_size"].numpy(), 0.3)
        want = np.clip(center[None] + 0.1 * width[None] * r.standard_normal((8, D + 1)),
                       bounds[:, 0], bounds[:, 1])
        np.testing.assert_allclose(call["x0"], want, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(subsets[2 + k], r.choice(512, size=256, replace=False))
        assert call["warmup_log_prob_fn"] is not None and call["n_warmup2"] == 8
        assert (call["n_warmup"], call["n_samples"], call["thin"], call["max_depth"]) == (16, 1, 2, 6)
    assert gp._rng.bit_generator.state == r.bit_generator.state
    assert gp._sampler_carry[0].shape == (8, D + 1) and gp._sampler_carry[2] == ("NUTS", 1024)


def _bo(optimizer, **settings):
    """tests/test_hmc.py's posterior GP, on the CPU."""
    gp = tbo.GaussianProcess(mean=tbo.constant_trend(2), corr="matern", thetaL=1e-3 * np.ones(2),
                             thetaU=1e3 * np.ones(2), nugget=1e-6, optimizer=optimizer, random_state=0,
                             device="cpu")
    for k, v in settings.items():
        setattr(gp, k, v)
    gp.n_ensemble = 4
    return gp


@pytest.mark.parametrize("optimizer,settings", [("HMC", {"hmc_warmup": 60}), ("VI", {"vi_steps": 200}),
                                                ("NUTS", {"hmc_warmup": 40})])
def test_bo_with_posterior_gp(optimizer, settings):
    """tests/test_hmc.py's test_bo_with_hmc_gp, test_bo_with_vi_gp and
    test_bo_with_nuts_gp on the port (float32, CPU)."""
    space = tbo.RealSpace([[-5, 5]] * 2, random_seed=0)
    opt = tbo.BO(search_space=space, obj_fun=lambda x: float(np.sum(np.asarray(x) ** 2)),
                 model=_bo(optimizer, **settings), DoE_size=5, max_FEs=10, random_seed=0,
                 device="cpu")
    xopt, fopt, _ = opt.run()
    assert opt.eval_count == 10
    assert fopt[0] < 10.0
    # the ensemble (posterior-mixture) path is what the argmax consumed
    assert opt.model._config_cache.n_ensemble == 4
    assert opt.model.theta_samples_.shape == (4, 2)


def test_parallel_bo_ask_with_a_nuts_gp():
    """One ParallelBO q = 2 ask on a NUTS ensemble: two distinct points in the box."""
    space = tbo.RealSpace([[-5, 5]] * 2, random_seed=0)
    opt = tbo.ParallelBO(search_space=space, obj_fun=lambda x: float(np.sum(np.asarray(x) ** 2)),
                         model=_bo("NUTS", hmc_warmup=20), n_point=2, DoE_size=6, max_FEs=8,
                         random_seed=0, device="cpu")
    X = opt.ask()  # the DoE
    opt.tell(X, [opt.obj_fun(x) for x in X])
    X = opt.ask()
    assert len(X) == 2 and not np.allclose(X[0], X[1])
    assert np.all(np.abs(np.asarray(X, float)) <= 5.0)
    assert opt.model.config.n_ensemble == 4


@pytest.mark.parametrize("optimizer", ["HMC", "NUTS", "VI"])
def test_posterior_gp_default_device_raises_without_a_gpu(optimizer):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError):
        TGP(thetaL=[1e-3], thetaU=[1e3], optimizer=optimizer)
    assert TGP(thetaL=[1e-3], thetaU=[1e3], optimizer=optimizer, device="cpu").optimizer == optimizer

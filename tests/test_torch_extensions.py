"""The port's batch flavors and LinearTransform end to end on the CPU, the
cases of tests/test_extensions.py that no other port test covers:
AnnealingBO's t falls from t0 along the JAX package's schedule,
SelfAdaptiveBO and MultiAcquisitionBO run their budget, and LinearTransform
round-trips. (tests/test_torch_parallel_bo.py holds the flavors' sampled
parameters to the JAX package's, ask for ask; tests/test_torch_pcabo.py
holds PCABO.)"""
import numpy as np
import pytest
import torch

import bayesian_optimization_tpu_torch as tbo
from bayesian_optimization_tpu_torch.core.extensions import LinearTransform
from bayesian_optimization_tpu_torch.ops.acquisition import MGFI_T_MAX

torch.set_num_threads(1)  # one thread per pytest worker: more oversubscribe the cores


def sphere(x):
    return float(np.sum(np.asarray(x) ** 2))


def make_opt(cls_name, **kw):
    gp = tbo.GaussianProcess(mean=tbo.constant_trend(2), corr="matern", thetaL=1e-3 * np.ones(2),
                             thetaU=1e3 * np.ones(2), nugget=1e-6, random_start=6, max_iter=30,
                             random_state=0, device="cpu")
    return getattr(tbo, cls_name)(search_space=tbo.RealSpace([[-5, 5]] * 2, random_seed=0), obj_fun=sphere,
                                  model=gp, DoE_size=5, max_FEs=13, n_point=2, random_seed=0,
                                  device="cpu", **kw)


def test_linear_transform_roundtrip():
    rng = np.random.default_rng(0)
    X = rng.uniform(-5, 5, (30, 6))
    pca = LinearTransform(n_components=3).fit(X, (X**2).sum(1))
    Z = pca.transform(X)
    assert Z.shape == (30, 3)
    X_rec = pca.inverse_transform(Z)
    assert X_rec.shape == X.shape
    assert np.allclose(pca.transform(X_rec), Z, atol=1e-8)  # projection is idempotent


@pytest.mark.parametrize("schedule", ["exp", "linear"])
def test_annealing_bo_t_decreases(schedule):
    opt = make_opt("AnnealingBO", t0=2.0, tf=0.1, schedule=schedule)
    ts = []
    opt._acquisition_callbacks.append(lambda: ts.append(opt._acquisition_par["t"]))
    opt.run()
    assert opt.eval_count >= 13 and len(ts) == 4
    assert all(b < a for a, b in zip([2.0] + ts, ts))  # falls every ask
    if schedule == "exp":  # t0 * (tf / t0) ** (k / max_iter), max_iter = (13 - 5) / 2
        assert np.allclose(ts, 2.0 * (0.1 / 2.0) ** (np.arange(1, 5) / 4.0), rtol=1e-12)


def test_self_adaptive_bo():
    opt = make_opt("SelfAdaptiveBO", acquisition_par={"t": 1.0})
    opt.run()
    assert opt.eval_count >= 13
    t = opt._acquisition_par["t"]
    assert 0.0 < t <= MGFI_T_MAX and t != 1.0  # adapted from the top half of each batch


def test_multi_acquisition_bo():
    opt = make_opt("MultiAcquisitionBO")
    names = []
    batch = opt._argmax.batch
    opt._argmax.batch = lambda state, config, name, pars, **kw: (
        names.append((name, len(pars))) or batch(state, config, name, pars, **kw))
    opt.run()
    assert opt.eval_count >= 13
    assert names == [("MGFI", 1), ("UCB", 1)] * 4  # the pool, round-robin, one slot each

"""bayesian_optimization_tpu_torch's GaussianProcess.fit against the JAX
package's on the CPU: the same random_state, over a fixed set of seeds, at
the default nugget."""
import numpy as np
import pytest
import torch

from bayesian_optimization_tpu.models import GaussianProcess as JGP
from bayesian_optimization_tpu.models import constant_trend as j_const
from bayesian_optimization_tpu_torch.models import GaussianProcess as TGP
from bayesian_optimization_tpu_torch.models import constant_trend as t_const
from bayesian_optimization_tpu_torch.models import likelihood as tlik

torch.set_num_threads(1)  # one thread per pytest worker: more oversubscribe the cores


def _problem(n, dim, seed):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 1, (n, dim))
    y = np.sin(3 * X).sum(1) + 0.1 * rng.standard_normal(n)
    return X, (y - y.mean()) / y.std()


def _gps(seed, dim, **kw):
    kw.update(corr="matern", thetaL=1e-3 * np.ones(dim), thetaU=1e3 * np.ones(dim),
              nugget=1e-6, random_start=10, random_state=seed)
    return JGP(mean=j_const(dim), **kw), TGP(mean=t_const(dim), device="cpu", **kw)


@pytest.mark.parametrize("seed", range(10))
def test_fit_matches_jax_from_the_same_random_state(seed):
    """The whole fit -- starts, L-BFGS lanes, nugget escalation, posterior --
    at the default nugget, in float64 in both packages. In float32 the two
    packages part ways on some seeds: a few lanes of this likelihood are
    sensitive to rounding, and which of them reach the interior basin
    differs between the packages and against the float64 replay, which
    agrees lane by lane (ROADMAP Queue 3)."""
    n, dim = 200, 3
    X, y = _problem(n + 64, dim, 2)
    jgp, tgp = _gps(seed, dim, dtype="f64")
    jgp.fit(X[:n], y[:n])
    tgp.fit(X[:n], y[:n])
    # both packages consumed exactly the same numpy draws (starts, subsets)
    assert jgp._rng.bit_generator.state == tgp._rng.bit_generator.state
    assert abs(tgp.log_likelihood_ - jgp.log_likelihood_) < 1e-3 * abs(jgp.log_likelihood_)
    mu_j = jgp.predict(X[n:])
    mu_t = tgp.predict(X[n:])
    assert np.abs(mu_t - mu_j).max() < 1e-2
    assert float(tgp.posterior.min_pivot) > tlik.PIV_TOL

"""fmin end to end in both packages on the CPU, compared on regret (the
two packages' f32 arithmetic differs, so their trajectories do too)."""
import numpy as np
import pytest
import torch

import bayesian_optimization_tpu as jbo
import bayesian_optimization_tpu_torch as tbo

torch.set_num_threads(1)  # one thread per pytest worker: more oversubscribe the cores


def sphere(x):
    return float(np.sum(np.asarray(x, float) ** 2))


@pytest.mark.parametrize("seed", [42, 7])
def test_fmin_sphere_beats_doe_in_both_packages(seed):
    """Parity config 1 (2-D sphere, 30 FEs, DoE of 5), compared on regret."""
    for pkg, extra in ((jbo, {}), (tbo, {"device": "cpu"})):
        xopt, fopt, iters, evals, hist = pkg.fmin(
            sphere, [-5.0] * 2, [5.0] * 2, max_FEs=30, x0=5, seed=seed, **extra
        )
        doe_best = min(sphere(x) for x in hist[0])
        assert evals == 30 and len(hist) == 26
        assert fopt < doe_best, (pkg.__name__, fopt, doe_best)
        assert abs(sphere(xopt) - fopt) < 1e-9

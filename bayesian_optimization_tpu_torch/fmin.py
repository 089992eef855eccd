"""scipy-style functional entry point.

Counterpart of bayesian_optimization_tpu/fmin.py: builds a RealSpace and a
Matern GP with theta bounds scaled to the box widths, runs sequential BO,
and returns (xopt, fopt, n_iterations, n_evaluations, per-iteration trial
points). n_point > 1 (ParallelBO) is not ported yet.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple, Union

import numpy as np

from ._device import DEFAULT_DEVICE
from .core.bo import BO
from .models.gp import GaussianProcess
from .models.trend import constant_trend
from .space import RealSpace


def fmin(
    func: Callable,
    lower: Union[float, List[float]],
    upper: Union[float, List[float]],
    x0=None,
    y0=None,
    n_point: int = 1,
    args: Tuple = (),
    max_FEs: Optional[int] = None,
    verbose: bool = False,
    seed: Optional[int] = None,
    device=DEFAULT_DEVICE,
    **kwargs,
):
    """Minimize `func` over the box [lower, upper] with Bayesian optimization."""
    if n_point != 1:
        raise NotImplementedError("fmin with n_point > 1 (ParallelBO) is not ported yet")
    obj_func = (lambda x: func(np.asarray(x, dtype=float), *args)) if args else (
        lambda x: func(np.asarray(x, dtype=float))
    )

    if np.ndim(lower) == 0 and np.ndim(upper) == 0:
        search_space = RealSpace([float(lower), float(upper)], random_seed=seed)
    else:
        lower, upper = list(lower), list(upper)
        if len(lower) != len(upper):
            raise ValueError("lower and upper must have the same length")
        search_space = RealSpace(list(zip(lower, upper)), random_seed=seed)

    dim = search_space.dim
    # theta bounds proportional to the RAW box widths; BaseBO rescales them
    # onto the unit embedding the GP fits on
    widths = np.asarray([hi - lo for lo, hi in search_space.bounds], dtype=float)
    model = GaussianProcess(
        mean=constant_trend(dim),
        corr="matern",
        thetaL=1e-3 * widths,
        thetaU=1e3 * widths,
        nugget=1e-6,
        noise_estim=False,
        optimizer="BFGS",
        wait_iter=3,
        random_start=max(10, dim),
        likelihood="concentrated",
        eval_budget=100 * dim,
        random_state=seed,
        device=device,
    )

    DoE_size = None
    warm_data = None
    if isinstance(x0, (int, np.integer)):
        DoE_size = int(x0)
    elif x0 is not None and hasattr(x0, "__iter__"):
        if y0 is None:
            y0 = [obj_func(x) for x in x0]
        warm_data = (x0, y0)

    opt = BO(
        search_space=search_space,
        obj_fun=obj_func,
        model=model,
        DoE_size=DoE_size,
        warm_data=warm_data,
        eval_type="list",
        max_FEs=max_FEs,
        verbose=verbose,
        n_point=n_point,
        random_seed=seed,
        device=device,
        **kwargs,
    )
    opt.run()

    N = opt._DoE_size
    data = opt.data
    data_per_iteration = [np.asarray(data.values[:N], dtype=float)]
    data_per_iteration += [np.asarray(data.values[i:i + 1], dtype=float) for i in range(N, len(data))]
    if verbose:
        print(
            "Optimization terminated successfully.\n"
            f"        Current function value: {opt.xopt.fitness.ravel()[0]}\n"
            f"        Iterations: {opt.iter_count}\n"
            f"        Function evaluations: {opt.eval_count}\n"
        )
    xopt = np.asarray(opt.xopt.values[0], dtype=float)
    return xopt, float(opt.xopt.fitness.ravel()[0]), opt.iter_count, opt.eval_count, data_per_iteration

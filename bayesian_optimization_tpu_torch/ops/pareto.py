"""Pareto-dominance utilities on tensors.

Counterpart of bayesian_optimization_tpu/ops/pareto.py (ref parity:
bayes_optim/utils/multi_objective/pareto.py -- `is_non_dominated`:82+,
`fast_non_dominated_sort` NSGA-II:36). Convention: MAXIMIZATION, as the
reference and BoTorch. `is_non_dominated` runs on the device of its input
(numpy input runs on the CPU): MOBO calls it on host data, inside the box
decomposition's slab recursion and for `xopt`.
"""
from __future__ import annotations

import numpy as np
import torch


def _dominates(Y: torch.Tensor) -> torch.Tensor:
    """(n, n) mask, [i, j]: row i dominates row j."""
    a, b = Y[:, None, :], Y[None, :, :]
    return (a >= b).all(-1) & (a > b).any(-1)


def is_non_dominated(Y, deduplicate: bool = True) -> torch.Tensor:
    """Boolean mask of the non-dominated (maximal) rows of Y[n, m].

    A point is dominated if another point is >= in every objective and > in
    at least one. With `deduplicate`, only the first of identical rows is
    kept (ref parity: pareto.py:82+).
    """
    Y = torch.as_tensor(Y)
    dominated = _dominates(Y).any(0)
    if not deduplicate:
        return ~dominated
    n = Y.shape[0]
    earlier = torch.ones((n, n), dtype=torch.bool, device=Y.device).tril(-1)
    dup = ((Y[:, None, :] == Y[None, :, :]).all(-1) & earlier).any(1)
    return ~dominated & ~dup


def fast_non_dominated_sort(Y) -> np.ndarray:
    """NSGA-II front ranks (0 = best front) for maximization
    (ref parity: pareto.py:36): each front's members are taken off their
    dominees' counts, and the rows whose count reaches 0 form the next."""
    Y = torch.as_tensor(Y)
    dom = _dominates(Y)
    n_dominators = dom.sum(0)
    rank = torch.full((Y.shape[0],), -1, dtype=torch.long, device=Y.device)
    current, r = n_dominators == 0, 0
    while bool(current.any()):
        rank[current] = r
        n_dominators = n_dominators - dom[current].sum(0)
        n_dominators[current] = -1
        current, r = n_dominators == 0, r + 1
    return rank.cpu().numpy()

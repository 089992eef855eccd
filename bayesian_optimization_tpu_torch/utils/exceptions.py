"""Exception hierarchy for the TPU-native Bayesian-optimization framework.

Capability parity with the reference's exception set
(ref: bayes_optim/utils/exception.py:4-78) — same names so users can port
`except` clauses unchanged — but defined independently with richer payloads.
"""
from __future__ import annotations

from typing import Any, Optional


class BayesOptError(Exception):
    """Base class for all framework errors."""


class AskEmptyError(BayesOptError):
    """Raised when `ask` cannot produce any feasible candidate point.

    ref parity: bayes_optim/utils/exception.py:4
    """

    def __init__(self, message: str = "ask yields no feasible point", n_requested: Optional[int] = None):
        self.n_requested = n_requested
        super().__init__(message)


class FlatFitnessError(BayesOptError):
    """Raised when the observed fitness values are (numerically) constant,
    which makes fitness standardization and surrogate fitting degenerate.

    ref parity: bayes_optim/utils/exception.py:22
    """


class RecommendationUnavailableError(BayesOptError):
    """Raised when `recommend` is called before any evaluated data exists.

    ref parity: bayes_optim/utils/exception.py:39
    """


class ObjectiveEvaluationError(BayesOptError):
    """Raised when the user objective function fails on a candidate.

    ref parity: bayes_optim/utils/exception.py:51
    """

    def __init__(self, message: str = "objective evaluation failed", x: Any = None):
        self.x = x
        super().__init__(message)


class ConstraintEvaluationError(BayesOptError):
    """Raised when a user constraint function fails on a candidate.

    ref parity: bayes_optim/utils/exception.py:66
    """

    def __init__(self, message: str = "constraint evaluation failed", x: Any = None):
        self.x = x
        super().__init__(message)

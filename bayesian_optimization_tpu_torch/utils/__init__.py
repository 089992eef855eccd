from .exceptions import (
    AskEmptyError,
    BayesOptError,
    ConstraintEvaluationError,
    FlatFitnessError,
    ObjectiveEvaluationError,
    RecommendationUnavailableError,
)
from .logging import PhaseTimer, get_logger, timed_phase
from .expr import ConditionExpression

__all__ = [
    "AskEmptyError", "BayesOptError", "ConstraintEvaluationError", "FlatFitnessError",
    "ObjectiveEvaluationError", "RecommendationUnavailableError",
    "PhaseTimer", "get_logger", "timed_phase", "ConditionExpression",
]

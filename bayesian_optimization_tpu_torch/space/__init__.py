"""Search-space layer: typed variables, space algebra, condition trees,
samplers, and the masked continuous embedding used by the tensor compute path."""
from .variables import Bool, Discrete, Integer, Ordinal, Real, Subset, Variable
from .space import (
    BoolSpace,
    DiscreteSpace,
    IntegerSpace,
    OrdinalSpace,
    RealSpace,
    SearchSpace,
    SubsetSpace,
)
from .node import Node
from .encoding import SpaceEncoding
from .samplers import SCMC

__all__ = [
    "Variable", "Real", "Integer", "Ordinal", "Discrete", "Bool", "Subset",
    "SearchSpace", "RealSpace", "IntegerSpace", "OrdinalSpace", "DiscreteSpace",
    "BoolSpace", "SubsetSpace", "Node", "SpaceEncoding", "SCMC",
]

"""Typed decision variables for mixed search spaces.

Capability parity with the reference's variable taxonomy — Real (with scale
transforms linear/log/log10/logit/bilog and decimal precision), Integer (with
step), Ordinal, Discrete (categorical), Bool, and Subset (powerset of a level
set), plus conditional activation strings
(ref: bayes_optim/search_space/variable.py:73-355) — implemented fresh.

Design difference from the reference: every variable knows how to *encode*
itself into the fixed-width continuous unit cube used by the TPU compute path
(see space/encoding.py). Sampling never mutates global RNG state; the
reference's `np.random.seed` side effects (ref: _base.py:150-155) are
deliberately not reproduced.
"""
from __future__ import annotations

import sys
from abc import ABC
from copy import deepcopy
from itertools import chain, combinations
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..utils.expr import ConditionExpression

_FMAX = sys.float_info.max


def _bilog(x):
    return np.sign(x) * np.log1p(np.abs(x))


def _bilog_inv(x):
    return np.sign(x) * np.expm1(np.abs(x))


def _logit(x):
    x = np.asarray(x, dtype=float)
    return np.log(x) - np.log1p(-x)


def _logit_inv(x):
    return 1.0 / (1.0 + np.exp(-np.asarray(x, dtype=float)))


#: scale name -> (forward, inverse, valid domain)  (ref parity: variable.py:40-53)
SCALE_TRANSFORMS = {
    "linear": (np.asarray, np.asarray, (-_FMAX, _FMAX)),
    "log": (np.log, np.exp, (1e-300, _FMAX)),
    "log10": (np.log10, lambda x: np.power(10.0, x), (1e-300, _FMAX)),
    "logit": (_logit, _logit_inv, (1e-300, 1.0)),
    "bilog": (_bilog, _bilog_inv, (-_FMAX, _FMAX)),
}


class Variable(ABC):
    """Base class for decision variables."""

    def __init__(
        self,
        bounds: Sequence,
        name: str,
        default_value: Any = None,
        conditions: Optional[str] = None,
        action: Union[Callable, int, float, str, None] = None,
    ):
        if len(bounds) > 0 and isinstance(bounds[0], list):
            bounds = bounds[0]
        self.name: str = name
        self.bounds: Tuple = tuple(bounds)
        self.set_default_value(default_value)
        self.set_conditions(conditions, action)

    # -- conditions -------------------------------------------------------
    def set_conditions(self, conditions: Optional[str], action=None) -> None:
        """Attach an activation condition: when it evaluates True on the other
        variables' values, this variable is considered inactive/overridden."""
        self.conditions = None
        if conditions is not None:
            expr = ConditionExpression(conditions)
            self.conditions = {"string": conditions, "expr": expr, "vars": expr.variables()}
        self.action = action

    def set_default_value(self, value) -> None:
        if value is not None and value not in self:
            raise ValueError(f"default value {value!r} not in range of {self.name}")
        self.default_value = value

    # -- container protocol ----------------------------------------------
    def __contains__(self, x) -> bool:  # pragma: no cover - overridden
        raise NotImplementedError

    def __eq__(self, other) -> bool:
        return (
            type(self) is type(other)
            and self.bounds == other.bounds
            and self.default_value == other.default_value
            and self.name == other.name
        )

    def __ne__(self, other) -> bool:
        return not self.__eq__(other)

    def __repr__(self):
        return self.__str__()

    def __str__(self):
        msg = f"{self.name} -> {type(self).__name__} | range: {self.bounds}"
        if self.default_value is not None:
            msg += f" | default: {self.default_value}"
        return msg

    def copyfrom(self, var: "Variable") -> None:
        if not isinstance(var, type(self)):
            raise TypeError(f"cannot copy from {type(var).__name__} into {type(self).__name__}")
        self.__dict__.update(**deepcopy(var.__dict__))

    # -- sampling / encoding hooks ---------------------------------------
    def sample(self, N: int = 1, rng: Optional[np.random.Generator] = None) -> List:
        """Draw N raw values (host-side, explicit Generator)."""
        raise NotImplementedError


class Real(Variable):
    """Real-valued variable on [lb, ub], optionally sampled on a transformed
    scale and rounded to a decimal precision."""

    def __init__(
        self,
        bounds: Tuple[float, float],
        name: str = "r",
        default_value: Optional[float] = None,
        precision: Optional[int] = None,
        scale: str = "linear",
        **kwargs,
    ):
        if not bounds[0] < bounds[1]:
            raise ValueError(f"invalid bounds {bounds} for Real variable {name!r}")
        if precision is not None and not isinstance(precision, int):
            raise ValueError("precision must be an int")
        super().__init__(bounds, name, default_value, **kwargs)
        self.precision = precision
        self.scale = scale

    def __hash__(self):
        return hash((self.name, self.bounds, self.default_value, self.precision, self.scale))

    def __contains__(self, x) -> bool:
        return self.bounds[0] <= x <= self.bounds[1]

    def __str__(self):
        msg = super().__str__()
        if self.precision:
            msg += f" | precision: .{self.precision}f"
        return msg + f" | scale: {self.scale}"

    @property
    def scale(self) -> str:
        return self._scale

    @scale.setter
    def scale(self, scale: Optional[str]) -> None:
        scale = scale or "linear"
        if scale not in SCALE_TRANSFORMS:
            raise ValueError(f"unknown scale {scale!r}; pick from {sorted(SCALE_TRANSFORMS)}")
        fwd, inv, domain = SCALE_TRANSFORMS[scale]
        lo, hi = self.bounds
        clipped_lo = min(max(lo, domain[0]), domain[1])
        clipped_hi = min(max(hi, domain[0]), domain[1])
        if (clipped_lo, clipped_hi) != (lo, hi):
            import warnings

            warnings.warn(
                f"bounds {self.bounds} clipped to {(clipped_lo, clipped_hi)} for scale {scale!r}"
            )
            self.bounds = (clipped_lo, clipped_hi)
        self._scale = scale
        self._trans = fwd
        self._inv_trans = inv
        self._bounds_transformed = (float(fwd(self.bounds[0])), float(fwd(self.bounds[1])))

    @property
    def bounds_transformed(self) -> Tuple[float, float]:
        return self._bounds_transformed

    def to_linear_scale(self, X):
        return X if self._scale == "linear" else self._inv_trans(X)

    def round(self, X):
        if self.precision is None:
            return X
        return np.clip(np.round(np.asarray(X, dtype=float), self.precision), *self.bounds)

    def sample(self, N: int = 1, rng: Optional[np.random.Generator] = None) -> List[float]:
        rng = rng or np.random.default_rng()
        lo, hi = self._bounds_transformed
        x = self.to_linear_scale(rng.uniform(lo, hi, N))
        return list(np.asarray(self.round(x), dtype=float))


class _Discrete(Variable):
    """Common machinery for level-indexed variables (Integer/Ordinal/Discrete/
    Bool/Subset): values are addressed by an integer index in [0, n_levels)."""

    def __init__(self, bounds, *args, **kwargs):
        bounds = list(dict.fromkeys(bounds))  # dedup, order-preserving
        super().__init__(bounds, *args, **kwargs)

    @property
    def n_levels(self) -> int:
        return len(self.bounds)

    def level_of(self, value) -> int:
        """Raw value -> integer level index."""
        return self.bounds.index(value)

    def value_of(self, level: int):
        """Integer level index -> raw value."""
        return self.bounds[int(level)]

    def __contains__(self, x) -> bool:
        return x in self.bounds

    def __hash__(self):
        return hash((self.name, self.bounds, self.default_value))

    def sample(self, N: int = 1, rng: Optional[np.random.Generator] = None) -> List:
        rng = rng or np.random.default_rng()
        return [self.value_of(i) for i in rng.integers(0, self.n_levels, N)]


class Discrete(_Discrete):
    """Categorical variable over an unordered finite level set."""

    is_ordered = False

    def __init__(self, bounds, name: str = "d", default_value=None, **kwargs):
        super().__init__(bounds, name, default_value, **kwargs)


class Subset(Discrete):
    """Categorical over the (non-empty) powerset of the given level set."""

    def __init__(self, bounds, name: str = "s", default_value=None, **kwargs):
        self._base_levels = list(bounds)
        enumerated = list(
            chain.from_iterable(combinations(self._base_levels, r) for r in range(1, len(self._base_levels) + 1))
        )
        super().__init__(enumerated, name, default_value, **kwargs)

    def __str__(self):
        msg = f"{self.name} -> {type(self).__name__} | range: 2 ^ {self._base_levels}"
        if self.default_value is not None:
            msg += f" | default: {self.default_value}"
        return msg


class Ordinal(_Discrete):
    """Ordered categorical variable."""

    is_ordered = True

    def __init__(self, bounds, name: str = "ordinal", default_value=None, **kwargs):
        super().__init__(bounds, name, default_value, **kwargs)


class Integer(_Discrete):
    """Integer variable on [lb, ub] with a step size."""

    is_ordered = True

    def __init__(
        self,
        bounds: Tuple[int, int],
        name: str = "i",
        default_value: Optional[int] = None,
        step: Union[int, float, None] = 1,
        **kwargs,
    ):
        super().__init__(bounds, name, default_value, **kwargs)
        if len(self.bounds) != 2 or not self.bounds[0] < self.bounds[1]:
            raise ValueError(f"invalid bounds {bounds} for Integer variable {name!r}")
        self.step = 1 if step is None else step

    @property
    def n_levels(self) -> int:
        return int(np.floor((self.bounds[1] - self.bounds[0]) / self.step) + 1)

    def level_of(self, value) -> int:
        return int(round((value - self.bounds[0]) / self.step))

    def value_of(self, level: int):
        v = self.bounds[0] + int(level) * self.step
        return int(v) if isinstance(self.step, int) else v

    def __contains__(self, x) -> bool:
        return self.bounds[0] <= x <= self.bounds[1]

    def __hash__(self):
        return hash((self.name, self.bounds, self.default_value, self.step))

    def __str__(self):
        return super().__str__() + f" | step: {self.step}"


class Bool(_Discrete):
    """Boolean variable."""

    is_ordered = True

    def __init__(self, name: str = "bool", default_value: Optional[bool] = True, **kwargs):
        kwargs.pop("bounds", None)
        if default_value is not None and not isinstance(default_value, bool):
            raise ValueError("default value of a Bool must be a bool")
        super().__init__((False, True), name, default_value, **kwargs)

    def value_of(self, level: int):
        return bool(level)

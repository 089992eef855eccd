"""Search-space containers: typed variable lists with algebra, sampling and
JSON serialization.

Capability parity with the reference's `SearchSpace` family
(ref: bayes_optim/search_space/search_space.py:39-869): direct-sum `+`,
replication `*`, removal `-`, `filter`/`concat`/`update`/`pop`/`remove`,
per-type masks and index arrays, uniform/LHS/Sobol sampling, constrained
sampling via SCMC + rejection, `round`, `to_linear_scale`, dict/JSON codecs
(type codes r/i/o/c/s/b), condition trees and
`get_unconditional_subspace`.

TPU-first design differences:
- RNG is an explicit per-space `numpy.random.Generator`; the reference's
  global `np.random.seed` side effect (ref: search_space.py:129-134) is not
  reproduced.
- LHS/Sobol are implemented natively (the reference depends on pyDOE and
  sobol_seq).
- Each space can compile itself into a `SpaceEncoding` (space/encoding.py):
  static arrays describing a masked continuous embedding so all downstream
  surrogate/acquisition math is a fixed-shape XLA program.
"""
from __future__ import annotations

import itertools
import json
from copy import deepcopy
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..utils.exceptions import ConstraintEvaluationError
from .node import Node
from .variables import Bool, Discrete, Integer, Ordinal, Real, Subset, Variable

__all__ = [
    "SearchSpace",
    "RealSpace",
    "IntegerSpace",
    "OrdinalSpace",
    "DiscreteSpace",
    "BoolSpace",
    "SubsetSpace",
]

_SUPPORTED_TYPES = (Real, Integer, Ordinal, Discrete, Bool, Subset)


def lhs_sample(
    n: int, dim: int, rng: np.random.Generator, criterion: str = "maximin", n_candidates: int = 8
) -> np.ndarray:
    """Latin-hypercube sample on the unit cube, with an optional maximin
    refinement (native replacement for pyDOE's `lhs`)."""
    def one() -> np.ndarray:
        # stratify each dimension into n cells, shuffle strata independently
        u = rng.uniform(size=(n, dim))
        cells = np.array([rng.permutation(n) for _ in range(dim)]).T
        return (cells + u) / n

    if criterion != "maximin" or n <= 2 or n_candidates <= 1:
        return one()
    best, best_score = None, -np.inf
    for _ in range(n_candidates):
        X = one()
        d2 = np.sum((X[:, None, :] - X[None, :, :]) ** 2, axis=-1)
        np.fill_diagonal(d2, np.inf)
        score = d2.min()
        if score > best_score:
            best, best_score = X, score
    return best


def sobol_sample(n: int, dim: int, rng: np.random.Generator) -> np.ndarray:
    """Scrambled Sobol sample on the unit cube (scipy QMC engine)."""
    from scipy.stats import qmc

    seed = int(rng.integers(0, 2**31 - 1))
    eng = qmc.Sobol(d=dim, scramble=True, seed=seed)
    return eng.random(n)


def _unit_samples(n: int, dim: int, method: str, rng: np.random.Generator) -> np.ndarray:
    if method == "uniform" or (method == "LHS" and n == 1):
        return rng.uniform(size=(n, dim))
    if method == "LHS":
        return lhs_sample(n, dim, rng)
    if method == "sobol":
        return sobol_sample(n, dim, rng)
    raise ValueError(f"unknown sampling method {method!r}")


class SearchSpace:
    """An ordered list of typed `Variable`s with set algebra and sampling."""

    def __init__(
        self,
        data: List[Variable],
        random_seed: Optional[int] = None,
        structure: Union[dict, List[Node], None] = None,
    ):
        self.random_seed = random_seed
        self._set_data(list(data))
        self._set_structure(structure)
        _narrow_type(self)

    # ------------------------------------------------------------------ RNG
    @property
    def random_seed(self) -> Optional[int]:
        return self._random_seed

    @random_seed.setter
    def random_seed(self, seed: Optional[int]):
        self._random_seed = int(seed) if seed is not None else None
        self._rng = np.random.default_rng(self._random_seed)

    # ----------------------------------------------------------- properties
    @property
    def var_name(self) -> List[str]:
        return self._var_name

    @var_name.setter
    def var_name(self, var_name: Union[str, List[str]]):
        if isinstance(var_name, str):
            var_name = [f"{var_name}{i}" for i in range(self.dim)]
        if len(var_name) != self.dim:
            raise ValueError("var_name length mismatch")
        for var, name in zip(self.data, var_name):
            var.name = name
        self._set_data(self.data)

    @property
    def var_type(self) -> List[str]:
        return self._var_type

    @property
    def bounds(self) -> List[tuple]:
        return self._bounds

    # -------------------------------------------------------------- set-up
    def _set_data(self, data: List[Variable]) -> None:
        names = [v.name for v in data]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicated variable names in {names}")
        if not all(isinstance(v, _SUPPORTED_TYPES) for v in data):
            raise TypeError("all items must be Variable instances")
        self.data = data
        self.dim = len(data)
        self._bounds = [v.bounds for v in data]
        self._var_type = [type(v).__name__ for v in data]
        self._var_name = names
        self._set_index()
        self._set_levels()

    def _set_index(self) -> None:
        types = np.asarray(self._var_type)
        for cls in _SUPPORTED_TYPES:
            nm = cls.__name__.lower()
            mask = types == cls.__name__ if self.dim else np.zeros(0, bool)
            setattr(self, f"{nm}_mask", mask)
            setattr(self, f"{nm}_id", np.nonzero(mask)[0])
        self.categorical_id = np.concatenate(
            [self.discrete_id, self.ordinal_id, self.bool_id, self.subset_id]
        ).astype(int)
        self.categorical_mask = (
            self.discrete_mask | self.ordinal_mask | self.bool_mask | self.subset_mask
            if self.dim
            else np.zeros(0, bool)
        )

    def _set_levels(self) -> None:
        self.levels = {int(i): self._bounds[i] for i in self.categorical_id}

    def _set_structure(self, structure: Union[dict, List[Node], None]) -> None:
        spec: Dict[str, List[dict]] = {}
        if isinstance(structure, list):
            for tree in structure:
                spec.update(tree.to_dict())
        elif isinstance(structure, dict):
            spec = dict(structure)
        # conditions declared on variables themselves join the structure
        for var in self.data:
            cond = getattr(var, "conditions", None)
            if cond is None:
                continue
            parent = cond["vars"][0]
            spec.setdefault(parent, []).append({"name": var.name, "condition": cond["string"]})
        forest = Node.from_dict(spec)
        self.structure = [t for t in (tr.remove(self.var_name, invert=True) for tr in forest) if t]

    # -------------------------------------------------------- dunder / algebra
    def __getitem__(self, index) -> Union["SearchSpace", Variable]:
        if isinstance(index, (int, np.integer)):
            return self.data[int(index)]
        if isinstance(index, str):
            return self.data[self._var_name.index(index)]
        if isinstance(index, slice):
            return SearchSpace(deepcopy(self.data[index]))
        if hasattr(index, "__iter__"):
            idx = list(index)
            if len(idx) and isinstance(idx[0], (bool, np.bool_)):
                idx = list(np.nonzero(idx)[0])
            vars_ = [
                self.data[self._var_name.index(i)] if isinstance(i, str) else self.data[int(i)]
                for i in idx
            ]
            return SearchSpace(deepcopy(vars_))
        raise KeyError(index)

    def __setitem__(self, index, value) -> None:
        if isinstance(index, str):
            index = self._var_name.index(index)
        data = list(self.data)
        data[int(index)] = value
        self._set_data(data)

    def __contains__(self, item) -> bool:
        if isinstance(item, str):
            return item in self._var_name
        if isinstance(item, Variable):
            return item in self.data
        if isinstance(item, SearchSpace):
            return all(v in self.data for v in item.data)
        if isinstance(item, dict):
            item = [item.get(name) for name in self._var_name]
        if hasattr(item, "__iter__"):
            values = list(item)
            if len(values) != self.dim:
                return False
            return all(v in var for v, var in zip(values, self.data))
        return False

    def __len__(self) -> int:
        return self.dim

    def __iter__(self):
        return iter(self.data)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, SearchSpace)
            and self.dim == other.dim
            and all(a == b for a, b in zip(self.data, other.data))
        )

    def __ne__(self, other) -> bool:
        return not self.__eq__(other)

    def __add__(self, other) -> "SearchSpace":
        if isinstance(other, Variable):
            other = SearchSpace([other])
        if not isinstance(other, SearchSpace):
            raise TypeError("can only add Variable or SearchSpace")
        return SearchSpace(deepcopy(self.data) + deepcopy(other.data), self._random_seed)

    def __radd__(self, other) -> "SearchSpace":
        if other == 0:  # support sum()
            return deepcopy(self)
        return self.__add__(other)

    def __iadd__(self, other) -> "SearchSpace":
        out = self.__add__(other)
        self.__dict__.update(out.__dict__)
        self.__class__ = out.__class__
        return self

    def __sub__(self, other) -> "SearchSpace":
        if isinstance(other, Variable):
            names = {other.name}
        elif isinstance(other, SearchSpace):
            names = set(other.var_name)
        elif isinstance(other, str):
            names = {other}
        elif hasattr(other, "__iter__"):
            names = set(other)
        else:
            raise TypeError(f"cannot subtract {other!r}")
        kept = [deepcopy(v) for v in self.data if v.name not in names]
        return SearchSpace(kept, self._random_seed)

    def __mul__(self, n: int) -> "SearchSpace":
        n = int(n)
        data = []
        for k in range(n):
            for v in self.data:
                vv = deepcopy(v)
                vv.name = f"{v.name}{k}"
                data.append(vv)
        return SearchSpace(data, self._random_seed)

    def __rmul__(self, n: int) -> "SearchSpace":
        return self.__mul__(n)

    def __repr__(self) -> str:
        return self.__str__()

    def __str__(self) -> str:
        return "\n".join([f"{type(self).__name__} of {self.dim} variables:"] + [str(v) for v in self.data])

    def pprint(self) -> None:
        print(self)
        for tree in self.structure:
            tree.pprint()

    # ------------------------------------------------------------- restructure
    def filter(self, keys: Sequence[str], invert: bool = False) -> "SearchSpace":
        keep = (lambda name: name not in keys) if invert else (lambda name: name in keys)
        return SearchSpace([deepcopy(v) for v in self.data if keep(v.name)], self._random_seed)

    @classmethod
    def concat(cls, *spaces: "SearchSpace") -> "SearchSpace":
        data = list(itertools.chain.from_iterable(deepcopy(s.data) for s in spaces))
        return SearchSpace(data)

    def pop(self, index: int = -1) -> Variable:
        data = list(self.data)
        var = data.pop(index)
        self._set_data(data)
        _narrow_type(self)
        return var

    def remove(self, index: Union[int, str]) -> "SearchSpace":
        if isinstance(index, str):
            index = self._var_name.index(index)
        data = list(self.data)
        del data[int(index)]
        self._set_data(data)
        _narrow_type(self)
        return self

    def update(self, other: "SearchSpace") -> "SearchSpace":
        data = list(self.data)
        for v in other.data:
            if v.name in self._var_name:
                data[self._var_name.index(v.name)] = deepcopy(v)
            else:
                data.append(deepcopy(v))
        self._set_data(data)
        _narrow_type(self)
        return self

    # --------------------------------------------------------------- sampling
    def sample(
        self,
        N: int = 1,
        method: str = "uniform",
        h: Optional[Callable] = None,
        g: Optional[Callable] = None,
        tol: float = 1e-2,
    ) -> np.ndarray:
        """Sample N points; with constraints h (equality) / g (inequality),
        sampling is delegated to the SCMC sampler + rejection filter
        (ref parity: search_space.py:500-554)."""
        if h is None and g is None:
            return self._sample(N, method)

        from .samplers import SCMC

        n = max(N, 10)
        S = SCMC(self, h=h, g=g, tol=tol).sample(n)
        try:
            ok = np.ones(len(S), bool)
            for i, x in enumerate(S):
                if h is not None:
                    ok[i] &= bool(np.all(np.isclose(np.abs(np.asarray(h(x), dtype=float)), 0, atol=tol)))
                if ok[i] and g is not None:
                    ok[i] &= bool(np.all(np.asarray(g(x), dtype=float) <= 0))
        except Exception as e:
            raise ConstraintEvaluationError(str(e)) from None
        S = S[ok]
        if len(S) > N:
            S = S[self._rng.choice(len(S), N, replace=False)]
        return S

    def _sample(self, N: int = 1, method: str = "uniform") -> np.ndarray:
        if self.dim == 0:
            return np.empty(0)
        N = max(int(N), 1)
        U = _unit_samples(N, self.dim, method, self._rng)
        X = np.empty((N, self.dim), dtype=object)
        for j, var in enumerate(self.data):
            X[:, j] = _decode_column(var, U[:, j])
        return X

    def round(self, X) -> np.ndarray:
        X = _as_2d_object(X)
        for j in np.nonzero(getattr(self, "real_mask", np.zeros(self.dim, bool)))[0]:
            X[:, j] = self.data[j].round(np.asarray(X[:, j], dtype=float))
        return X

    def to_linear_scale(self, X) -> np.ndarray:
        X = _as_2d_object(X)
        for j in np.nonzero(getattr(self, "real_mask", np.zeros(self.dim, bool)))[0]:
            X[:, j] = self.data[j].to_linear_scale(np.asarray(X[:, j], dtype=float))
        return X

    # ------------------------------------------------------------ serialization
    def to_dict(self) -> dict:
        out: dict = {}
        for var in self.data:
            entry: dict = {"range": list(var.bounds), "N": 1, "type": _TYPE_CODE[type(var).__name__]}
            if isinstance(var, Real):
                entry["precision"] = var.precision
                entry["scale"] = var.scale
            elif isinstance(var, Integer):
                entry["step"] = var.step
            if isinstance(var, Subset):
                entry["range"] = list(var._base_levels)
            if var.default_value is not None:
                entry["default"] = var.default_value
            if var.conditions is not None:
                entry["conditions"] = var.conditions["string"]
            out[var.name] = entry
        return out

    def to_json(self, file: str) -> None:
        with open(file, "w") as f:
            json.dump(self.to_dict(), f, default=str)

    @classmethod
    def from_dict(cls, param: dict) -> "SearchSpace":
        variables: List[Variable] = []
        for name, spec in param.items():
            bounds = spec.get("range", ())
            if len(bounds) and not (hasattr(bounds[0], "__iter__") and not isinstance(bounds[0], str)):
                bounds = tuple(bounds)
            n_copies = int(spec.get("N", 1))
            default = spec.get("default")
            conditions = spec.get("conditions")
            t = str(spec["type"]).lower()
            for k in range(n_copies):
                nm = name if n_copies == 1 else f"{name}{k}"
                kw = dict(name=nm, default_value=default, conditions=conditions)
                if t in ("r", "real"):
                    variables.append(
                        Real(bounds, precision=spec.get("precision"), scale=spec.get("scale", "linear"), **kw)
                    )
                elif t in ("i", "int", "integer"):
                    variables.append(Integer(bounds, step=spec.get("step", 1), **kw))
                elif t in ("o", "ordinal"):
                    variables.append(Ordinal(bounds, **kw))
                elif t in ("c", "cat", "discrete"):
                    variables.append(Discrete(bounds, **kw))
                elif t in ("s", "subset"):
                    variables.append(Subset(bounds, **kw))
                elif t in ("b", "bool"):
                    kw.pop("name")
                    variables.append(Bool(name=nm, default_value=default, conditions=conditions))
                else:
                    raise ValueError(f"unknown variable type code {t!r} for {name!r}")
        return SearchSpace(variables)

    @classmethod
    def from_json(cls, file: str) -> "SearchSpace":
        with open(file) as f:
            return cls.from_dict(json.load(f))

    # ------------------------------------------------------------- conditional
    def get_unconditional_subspace(self) -> List[Tuple[dict, "SearchSpace"]]:
        """Enumerate (conditioning-assignment, flat subspace) pairs
        (ref parity: search_space.py:698-721)."""
        if not self.structure:
            return [({}, self)]
        import ast as _ast

        structured = set(itertools.chain.from_iterable(t.get_all_name() for t in self.structure))
        isolated = [self[v] for v in self.var_name if v not in structured]
        per_tree_paths = [list(t.get_all_path().items()) for t in self.structure]
        out = []
        combined: Dict[tuple, List[str]] = {}
        for combo in itertools.product(*[range(len(p)) for p in per_tree_paths]):
            conds: tuple = ()
            names: List[str] = []
            for tree_i, path_i in enumerate(combo):
                c, v = per_tree_paths[tree_i][path_i]
                conds = conds + c
                names.extend(v)
            combined[conds] = names
        from ..utils.expr import ConditionExpression

        for conds, names in combined.items():
            key = {}
            for c in conds:
                expr = ConditionExpression(c)
                tree = _ast.parse(expr.normalized, mode="eval").body
                lhs_name = expr.variables()[0]
                val = tree.comparators[0] if isinstance(tree, _ast.Compare) else None
                key[lhs_name] = val.value if isinstance(val, _ast.Constant) else None
            out.append((key, SearchSpace(deepcopy(isolated) + [deepcopy(self[v]) for v in names])))
        return out

    # --------------------------------------------------------------- encoding
    def encoding(self, dtype=None):
        """Compile this space into a static `SpaceEncoding` for the XLA path."""
        from .encoding import SpaceEncoding

        return SpaceEncoding(self, dtype=dtype)


def _decode_column(var: Variable, u: np.ndarray):
    """Map unit-cube samples u in [0,1) to raw values of one variable."""
    if isinstance(var, Real):
        lo, hi = var.bounds_transformed
        return np.asarray(var.round(var.to_linear_scale(lo + (hi - lo) * u)), dtype=float)
    n = var.n_levels
    levels = np.minimum((u * n).astype(int), n - 1)
    return np.array([var.value_of(i) for i in levels], dtype=object)


def _as_2d_object(X) -> np.ndarray:
    if not isinstance(X, np.ndarray) or X.dtype != object:
        X = np.array(X, dtype=object)
    if X.ndim == 1:
        X = X.reshape(1, -1)
    return X


_TYPE_CODE = {
    "Real": "r",
    "Integer": "i",
    "Ordinal": "o",
    "Discrete": "c",
    "Subset": "s",
    "Bool": "b",
}


def _narrow_type(space: SearchSpace) -> SearchSpace:
    """If all variables share one type, narrow the instance's class so
    isinstance checks (e.g. RealSpace) work (ref parity: search_space.py:199-202)."""
    kinds = set(space._var_type)
    mapping = {
        "Real": RealSpace,
        "Integer": IntegerSpace,
        "Ordinal": OrdinalSpace,
        "Discrete": DiscreteSpace,
        "Bool": BoolSpace,
        "Subset": SubsetSpace,
    }
    space.__class__ = mapping[kinds.pop()] if len(kinds) == 1 else SearchSpace
    return space


def _ready_args(bounds, var_name, **kwargs) -> List[dict]:
    """Broadcast per-variable constructor arguments (ref parity:
    search_space.py:137-162)."""
    if len(bounds) and hasattr(bounds[0], "__iter__") and not isinstance(bounds[0], str):
        bounds = [tuple(b) for b in bounds]
    else:
        bounds = [tuple(bounds)]
    dim = len(bounds)
    if isinstance(var_name, str):
        names = [var_name] if dim == 1 else [f"{var_name}{i}" for i in range(dim)]
    else:
        names = list(var_name)
        if len(names) != dim:
            raise ValueError("var_name length mismatch")
    out = [{"bounds": bounds[i], "name": names[i]} for i in range(dim)]
    for key, val in kwargs.items():
        if val is None:
            continue
        vals = val if isinstance(val, (list, np.ndarray)) else [val] * dim
        if len(vals) != dim:
            raise ValueError(f"{key} length mismatch")
        for i in range(dim):
            out[i][key] = vals[i]
    return out


class RealSpace(SearchSpace):
    """All-Real search space."""

    def __init__(
        self,
        bounds: List,
        var_name: Union[str, List[str]] = "real",
        default_value=None,
        precision=None,
        scale=None,
        **kwargs,
    ):
        args = _ready_args(bounds, var_name, default_value=default_value, precision=precision, scale=scale)
        super().__init__([Real(**a) for a in args], **kwargs)


class _DiscreteSpace(SearchSpace):
    """Shared base for all level-indexed spaces."""


class IntegerSpace(_DiscreteSpace):
    def __init__(self, bounds: List, var_name="integer", default_value=None, step=1, **kwargs):
        args = _ready_args(bounds, var_name, default_value=default_value, step=step)
        super().__init__([Integer(**a) for a in args], **kwargs)


class OrdinalSpace(_DiscreteSpace):
    def __init__(self, bounds: List, var_name="ordinal", default_value=None, **kwargs):
        args = _ready_args(bounds, var_name, default_value=default_value)
        super().__init__([Ordinal(**a) for a in args], **kwargs)


class DiscreteSpace(_DiscreteSpace):
    def __init__(self, bounds: List, var_name="discrete", default_value=None, **kwargs):
        args = _ready_args(bounds, var_name, default_value=default_value)
        super().__init__([Discrete(**a) for a in args], **kwargs)


class SubsetSpace(_DiscreteSpace):
    def __init__(self, bounds: List, var_name="subset", default_value=None, **kwargs):
        args = _ready_args(bounds, var_name, default_value=default_value)
        super().__init__([Subset(**a) for a in args], **kwargs)


class BoolSpace(_DiscreteSpace):
    def __init__(self, var_name="bool", default_value=None, **kwargs):
        args = _ready_args((False, True), var_name, default_value=default_value)
        for a in args:
            a.pop("bounds")
        super().__init__([Bool(**a) for a in args], **kwargs)

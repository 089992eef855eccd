"""Candidate-solution data store.

Capability parity with the reference's `Solution` ndarray subclass
(ref: bayes_optim/solution.py:15-378): rows carry decision values plus
fitness / n_eval / index metadata that slice together, concatenation `+`,
replication `*`, `unique`, dict/CSV codecs, and tabulate pretty-printing.

TPU-first design difference: the reference subclasses `np.ndarray` with
attribute write-through via `__array_finalize__`; here the store is a plain
struct-of-arrays (decision values as an object ndarray; fitness/n_eval/index
as numeric arrays). Basic slicing returns views so metadata updates
propagate, and numeric-only accessors hand fixed-dtype arrays straight to
the XLA pipeline without object-array round trips.
"""
from __future__ import annotations

import csv
import os
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np


class Solution:
    """A batch of candidate solutions with per-row metadata."""

    def __init__(
        self,
        values,
        fitness=None,
        n_eval=None,
        index=None,
        var_name: Optional[Sequence[str]] = None,
        n_obj: int = 1,
    ):
        values = np.asarray(values, dtype=object)
        if values.ndim == 1:
            values = values.reshape(1, -1)
        self.values: np.ndarray = values
        N = len(values)
        self.n_obj = int(n_obj)

        if fitness is None:
            fitness = np.full((N, self.n_obj), np.nan)
        else:
            fitness = np.asarray(fitness, dtype=float)
            if fitness.ndim == 1:
                fitness = fitness.reshape(N, -1)
            self.n_obj = fitness.shape[1]
        self.fitness: np.ndarray = fitness

        self.n_eval: np.ndarray = (
            np.zeros(N, dtype=int) if n_eval is None else np.asarray(n_eval, dtype=int).reshape(N)
        )
        self.index: np.ndarray = (
            np.arange(N) if index is None else np.asarray(index, dtype=int).reshape(N)
        )
        self.var_name: List[str] = (
            list(var_name) if var_name is not None else [f"x{i}" for i in range(values.shape[1])]
        )

    # ------------------------------------------------------------ properties
    @property
    def N(self) -> int:
        return len(self.values)

    @property
    def dim(self) -> int:
        return self.values.shape[1]

    def __len__(self) -> int:
        return self.N

    # ------------------------------------------------------------- slicing
    def __getitem__(self, key) -> "Solution":
        if isinstance(key, tuple):
            rows, cols = key
            vals = self.values[rows, cols]
            sub = self._row_subset(rows)
            sub.values = np.atleast_2d(vals)
            return sub
        return self._row_subset(key)

    def _row_subset(self, rows) -> "Solution":
        if isinstance(rows, (int, np.integer)):
            rows = slice(int(rows), int(rows) + 1)
        out = Solution.__new__(Solution)
        out.values = np.atleast_2d(self.values[rows])
        out.fitness = np.atleast_2d(self.fitness[rows])
        out.n_eval = np.atleast_1d(self.n_eval[rows])
        out.index = np.atleast_1d(self.index[rows])
        out.var_name = self.var_name
        out.n_obj = self.n_obj
        return out

    def __iter__(self):
        for i in range(self.N):
            yield self._row_subset(i)

    # -------------------------------------------------------------- algebra
    def __add__(self, other: "Solution") -> "Solution":
        if not isinstance(other, Solution):
            other = Solution(other, var_name=self.var_name, n_obj=self.n_obj)
        return Solution(
            np.concatenate([self.values, other.values], axis=0),
            fitness=np.concatenate([self.fitness, other.fitness], axis=0),
            n_eval=np.concatenate([self.n_eval, other.n_eval]),
            index=np.concatenate([self.index, other.index]),
            var_name=self.var_name,
            n_obj=self.n_obj,
        )

    def __mul__(self, k: int) -> "Solution":
        k = int(k)
        return Solution(
            np.tile(self.values, (k, 1)),
            fitness=np.tile(self.fitness, (k, 1)),
            n_eval=np.tile(self.n_eval, k),
            index=np.tile(self.index, k),
            var_name=self.var_name,
            n_obj=self.n_obj,
        )

    __rmul__ = __mul__

    def unique(self) -> "Solution":
        seen, keep = set(), []
        for i in range(self.N):
            key = tuple(self.values[i])
            if key not in seen:
                seen.add(key)
                keep.append(i)
        return self._row_subset(keep)

    # ---------------------------------------------------------------- codecs
    def tolist(self) -> list:
        """Nested list of rows (N, dim) — always nested, even for N == 1;
        use `first()` for a flat single row."""
        return [list(row) for row in self.values]

    def first(self) -> list:
        """The first row as a flat list."""
        return list(self.values[0])

    def to_dict(self, orient: str = "index") -> dict:
        if orient == "var":
            return {name: list(self.values[:, j]) for j, name in enumerate(self.var_name)}
        return {
            int(self.index[i]): dict(zip(self.var_name, self.values[i])) for i in range(self.N)
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any], index=None) -> "Solution":
        names = list(d.keys())
        first = d[names[0]]
        if np.ndim(first) == 0:
            rows = [[d[k] for k in names]]
        else:
            rows = [[d[k][i] for k in names] for i in range(len(first))]
        return cls(rows, var_name=names, index=index)

    def to_csv(self, fname: str, header: bool = True, append: bool = False, show_attr: bool = True) -> None:
        mode = "a" if append else "w"
        write_header = header and not (append and os.path.exists(fname) and os.path.getsize(fname) > 0)
        with open(fname, mode, newline="") as f:
            w = csv.writer(f)
            if write_header:
                cols = ["index"] + self.var_name
                if show_attr:
                    cols += [f"f{k}" for k in range(self.n_obj)] + ["n_eval"]
                w.writerow(cols)
            for i in range(self.N):
                row = [self.index[i]] + list(self.values[i])
                if show_attr:
                    row += list(self.fitness[i]) + [self.n_eval[i]]
                w.writerow(row)

    @classmethod
    def from_csv(cls, fname: str) -> "Solution":
        with open(fname, newline="") as f:
            rows = list(csv.reader(f))
        header, body = rows[0], rows[1:]
        n_obj = sum(1 for c in header if c.startswith("f") and c[1:].isdigit())
        dim = len(header) - 2 - n_obj
        names = header[1 : 1 + dim]
        values = [r[1 : 1 + dim] for r in body]
        fitness = [[float(v) for v in r[1 + dim : 1 + dim + n_obj]] for r in body]
        n_eval = [int(r[-1]) for r in body]
        index = [int(r[0]) for r in body]
        return cls(values, fitness=fitness, n_eval=n_eval, index=index, var_name=names, n_obj=n_obj)

    # ---------------------------------------------------------------- repr
    def __str__(self) -> str:
        from tabulate import tabulate

        rows = [
            list(self.values[i]) + [self.fitness[i].tolist(), self.n_eval[i]]
            for i in range(self.N)
        ]
        return tabulate(
            rows,
            headers=self.var_name + ["fitness", "n_eval"],
            showindex=list(self.index),
            tablefmt="grid",
        )

    def __repr__(self) -> str:
        return self.__str__()

"""Constraint programs for the acquisition argmax.

Counterpart of bayesian_optimization_tpu/optim/constraints.py (ref parity:
bayes_optim/acquisition/optim/__init__.py:33-52 `Penalized` dynamic penalty
on the criterion, :124-126 feasibility filter on restart winners): a user's
black-box ``h``/``g`` callables become evaluators over unit-cube batches, so
the penalty is part of the criterion every engine maximizes.

Each callable is first tried as tensor code: it is called on the raw decode
of one row (`SpaceEncoding.unit_to_raw`), batched over the population with
`torch.func.vmap`, so one criterion evaluation runs it as a few batched ops
on the device and autograd flows through it (BFGS gets the penalty's exact
gradient). The row it receives takes numpy's reductions (`np.sum(x)` calls
`x.sum(axis=None, ...)`, as a jax array takes it), so a callable written with
numpy traces where it traces in the JAX package. The result is checked
against the host decoder on 4 probe points. When the call fails or disagrees
the callable runs on the host instead: once per criterion evaluation, U is
copied to the host, decoded and looped over row by row, and the values are
copied back (one device sync, counted in `host_calls`); the BO loop then
picks a derivative-free engine.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .._device import DEFAULT_DEVICE, resolve_device
from ..utils.exceptions import ConstraintEvaluationError
from ..utils.penalty import dynamic_penalty

#: feasibility tolerance on |h| for preferring restart winners
#: (ref parity: optim/__init__.py:124 `atol=1e-1`)
H_FEAS_ATOL = 1e-1


def _np_reduction(op):
    def method(self, axis=None, dtype=None, out=None, keepdims=False):
        if out is not None:
            raise TypeError("out= has no tensor counterpart")
        x = self.as_subclass(torch.Tensor)
        if axis is None:
            r = op(x.reshape(-1), 0, False)
            return r.reshape((1,) * x.ndim) if keepdims else r
        return op(x, axis, keepdims)

    return method


class _RawRow(torch.Tensor):
    """The raw row a traced constraint receives: numpy's reductions call the
    array's method with numpy's keywords (axis=, dtype=, out=, keepdims=),
    which torch's own methods do not take."""

    sum = _np_reduction(lambda x, d, k: torch.sum(x, d, keepdim=k))
    mean = _np_reduction(lambda x, d, k: torch.mean(x, d, keepdim=k))
    prod = _np_reduction(lambda x, d, k: torch.prod(x, d, keepdim=k))
    max = _np_reduction(lambda x, d, k: torch.amax(x, d, keepdim=k))
    min = _np_reduction(lambda x, d, k: torch.amin(x, d, keepdim=k))


def _as_vector(out, like: torch.Tensor) -> torch.Tensor:
    """A callable's result (number, tensor, or list/tuple of them) as a
    plain 1-d tensor of like's dtype and device."""
    if isinstance(out, (list, tuple)):
        return torch.stack([_as_vector(o, like).reshape(()) for o in out])
    t = out.as_subclass(torch.Tensor) if torch.is_tensor(out) else torch.as_tensor(out)
    return torch.atleast_1d(t.to(dtype=like.dtype, device=like.device))


class ConstraintProgram:
    """Batched unit-cube evaluators for eq/ineq constraints; `device` is
    where the traced callables are checked against the host decoder.

    Instances are immutable after construction; equality is identity, as
    in the JAX package (where they are static arguments of jitted code).
    """

    def __init__(
        self,
        encoding,
        h: Optional[Callable] = None,
        g: Optional[Callable] = None,
        eval_type: str = "list",
        var_names=None,
        device=DEFAULT_DEVICE,
    ):
        self.encoding = encoding
        self.h = h
        self.g = g
        self.eval_type = eval_type
        self.var_names = list(var_names or [v.name for v in encoding.space.data])
        self.dtype = encoding.dtype
        self.device = resolve_device(device)
        self.host_calls = 0  # host-path evaluations (one device sync each)

        # probe on one host-decoded point: determines output arity and
        # surfaces crashing constraints eagerly
        # (ref parity: utils/utils.py:328-336 ConstraintEvaluationError)
        U0 = np.full((1, encoding.dim), 0.5)
        self.n_h = self._probe(h, U0)
        self.n_g = self._probe(g, U0)

        self._h_traced = self._try_trace(h, self.n_h) if h is not None else None
        self._g_traced = self._try_trace(g, self.n_g) if g is not None else None

    # ------------------------------------------------------------- host path
    def _make_arg(self, row):
        """The user-visible argument from one row of per-variable values."""
        vals = list(row)
        if self.eval_type == "dict":
            return dict(zip(self.var_names, vals))
        return vals

    def _host_batch(self, fn: Callable, n_out: int, U_np) -> np.ndarray:
        X = self.encoding.decode_unit(np.asarray(U_np, dtype=float))
        out = np.empty((len(X), n_out), dtype=float)
        for i, row in enumerate(X):
            out[i] = np.atleast_1d(np.asarray(fn(self._make_arg(row)), dtype=float))
        return out

    def _probe(self, fn: Optional[Callable], U0) -> int:
        if fn is None:
            return 0
        try:
            row = self.encoding.decode_unit(U0)[0]
            v = np.atleast_1d(np.asarray(fn(self._make_arg(row)), dtype=float))
        except Exception as e:  # noqa: BLE001 - any user crash => parity error
            raise ConstraintEvaluationError(
                f"constraint {getattr(fn, '__name__', fn)!r} failed on a probe "
                f"point: {e}"
            ) from None
        return int(v.size)

    # ----------------------------------------------------------- traced path
    def _try_trace(self, fn: Callable, n_out: int) -> Optional[Callable]:
        """A batched evaluator U (P, dim) -> (P, n_out) running fn as tensor
        code, or None (=> host path)."""

        def traced_row(u_row):
            raw = self.encoding.unit_to_raw(u_row[None, :])[0].as_subclass(_RawRow)
            if self.eval_type == "dict":
                arg = dict(zip(self.var_names, [raw[j] for j in range(self.encoding.dim)]))
            else:
                arg = raw
            return _as_vector(fn(arg), u_row).reshape(n_out)

        batched = torch.func.vmap(traced_row)
        # numeric validation against the host decoder (catches NaN columns
        # from non-numeric variables and precision-rounding semantics)
        rng = np.random.default_rng(0)
        U = rng.uniform(0.05, 0.95, (4, self.encoding.dim))
        try:
            with torch.no_grad():
                got = batched(torch.as_tensor(U, dtype=self.dtype, device=self.device))
            got = got.cpu().double().numpy()
            want = self._host_batch(fn, n_out, U)
        except Exception:  # noqa: BLE001 - non-traceable user code
            return None
        if not np.all(np.isfinite(got)) or not np.allclose(got, want, rtol=1e-4, atol=1e-4):
            return None
        return batched

    @property
    def traceable(self) -> bool:
        """True iff every constraint runs as tensor code (=> autograd
        gradients exist and gradient-based argmax engines are usable)."""
        ok_h = self.h is None or self._h_traced is not None
        ok_g = self.g is None or self._g_traced is not None
        return ok_h and ok_g

    # -------------------------------------------------------- batched eval
    def _unit_vals(self, fn, traced, n_out, U: torch.Tensor) -> torch.Tensor:
        if traced is not None:
            return traced(U)
        self.host_calls += 1
        with torch.no_grad():
            vals = self._host_batch(fn, n_out, U.detach().cpu().double().numpy())
        return torch.as_tensor(vals, dtype=U.dtype, device=U.device)

    def h_unit(self, U: torch.Tensor) -> Optional[torch.Tensor]:
        if self.h is None:
            return None
        return self._unit_vals(self.h, self._h_traced, self.n_h, U)

    def g_unit(self, U: torch.Tensor) -> Optional[torch.Tensor]:
        if self.g is None:
            return None
        return self._unit_vals(self.g, self._g_traced, self.n_g, U)

    def penalty(self, U: torch.Tensor, t) -> torch.Tensor:
        """Positive dynamic-penalty values for a unit batch (P, dim) -> (P,)
        (ref parity: utils/utils.py:272-344 via utils/penalty.py)."""
        return dynamic_penalty(self.h_unit(U), self.g_unit(U), t, minimize=True)

    def feasible_in_program(self, U: torch.Tensor) -> torch.Tensor:
        """Boolean mask (P,): |h| <= 0.1 per component and g <= 0
        (ref parity: optim/__init__.py:124-126)."""
        feas = torch.ones(U.shape[0], dtype=torch.bool, device=U.device)
        hv = self.h_unit(U)
        if hv is not None:
            feas &= (hv.abs() <= H_FEAS_ATOL).all(-1)
        gv = self.g_unit(U)
        if gv is not None:
            feas &= (gv <= 0.0).all(-1)
        return feas

    # -------------------------------------------------------------- host API
    def feasible_rows(self, rows) -> np.ndarray:
        """Host-side winner filter over raw pheno rows (list of lists)."""
        out = np.ones(len(rows), dtype=bool)
        for i, row in enumerate(rows):
            arg = self._make_arg(list(row))
            try:
                if self.h is not None:
                    hv = np.atleast_1d(np.asarray(self.h(arg), dtype=float))
                    out[i] &= bool(np.all(np.abs(hv) <= H_FEAS_ATOL))
                if self.g is not None:
                    gv = np.atleast_1d(np.asarray(self.g(arg), dtype=float))
                    out[i] &= bool(np.all(gv <= 0.0))
            except Exception as e:  # noqa: BLE001
                raise ConstraintEvaluationError(
                    f"constraint evaluation failed on {row}: {e}"
                ) from None
        return out

    # identity hash/eq, as in the JAX package
    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other

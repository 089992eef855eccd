"""Masked continuous embedding of mixed search spaces.

Counterpart of bayesian_optimization_tpu/space/encoding.py. A `SearchSpace`
is compiled once into static arrays; two array representations of a batch:

- **unit** `U[N, dim]`: one column per variable in [0, 1] (reals on their
  transformed scale, discretes as level cells);
- **embed** `E[N, d_embed]`: the surrogate-facing features (reals and
  ordered discretes as scalars, categoricals one-hot).

`unit_to_embed`, `unit_to_raw`, `quantize_unit` and `sample_unit` work on
torch tensors on any device (`unit_to_embed` and `unit_to_raw` are
differentiable in the real columns); the raw <-> unit codecs are host-side
numpy, shared with the JAX package, so both packages draw the same DoE from
the same numpy generator.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.logging import host_sync
from .space import SearchSpace
from .variables import Bool, Integer, Ordinal, Real

_NUMERIC = (bool, int, float, np.integer, np.floating)


class SpaceEncoding:
    """Static description of a search space for the tensor path."""

    def __init__(self, space: SearchSpace, dtype=None):
        self.space = space
        self.dtype = dtype or torch.float32
        self.dim = space.dim

        is_real, n_levels, is_onehot = [], [], []
        lo_t, hi_t = [], []
        for var in space.data:
            if isinstance(var, Real):
                is_real.append(True)
                n_levels.append(0)
                is_onehot.append(False)
                lo, hi = var.bounds_transformed
                lo_t.append(lo)
                hi_t.append(hi)
            else:
                is_real.append(False)
                n_levels.append(var.n_levels)
                is_onehot.append(not isinstance(var, (Integer, Ordinal, Bool)))
                lo_t.append(0.0)
                hi_t.append(1.0)

        self.is_real = np.asarray(is_real)
        self.n_levels = np.asarray(n_levels, dtype=np.int32)
        self.is_onehot = np.asarray(is_onehot)
        self.lo_t = np.asarray(lo_t, dtype=np.float64)
        self.hi_t = np.asarray(hi_t, dtype=np.float64)

        widths = [int(n) if oh else 1 for n, oh in zip(self.n_levels, self.is_onehot)]
        self.emb_width = np.asarray(widths, dtype=np.int32)
        self.emb_offset = np.concatenate([[0], np.cumsum(widths)[:-1]]).astype(np.int32)
        self.d_embed = int(np.sum(widths))
        self._scalar_cols = [
            (j, int(self.emb_offset[j])) for j in range(self.dim) if not self.is_onehot[j]
        ]
        self._onehot_specs = [
            (j, int(self.emb_offset[j]), int(self.n_levels[j]))
            for j in range(self.dim) if self.is_onehot[j]
        ]

    def embed_widths(self):
        """Per-embedding-dim RAW widths: hi_t - lo_t for real scalar slots,
        1.0 for level/one-hot slots."""
        w = np.ones(self.d_embed)
        for j, off in self._scalar_cols:
            if self.is_real[j]:
                w[off] = float(self.hi_t[j] - self.lo_t[j])
        return w

    # --------------------------------------------------------- tensor codecs
    def _levels_t(self, like: torch.Tensor) -> torch.Tensor:
        with host_sync():  # a blocking copy to the device
            return torch.as_tensor(np.maximum(self.n_levels, 1), dtype=like.dtype, device=like.device)

    def _discrete_t(self, like: torch.Tensor) -> torch.Tensor:
        with host_sync():
            return torch.as_tensor(~self.is_real, device=like.device)

    def quantize_unit(self, U: torch.Tensor) -> torch.Tensor:
        """Snap discrete columns to their level midpoints (k + 0.5) / n."""
        U = U.clamp(0.0, 1.0)
        n = self._levels_t(U)
        lev = torch.minimum(torch.floor(U * n), n - 1.0)
        return torch.where(self._discrete_t(U), (lev + 0.5) / n, U)

    def unit_levels(self, U: torch.Tensor) -> torch.Tensor:
        """Integer level indices (discrete columns; zeros for reals)."""
        n = self._levels_t(U)
        lev = torch.minimum(torch.floor(U.clamp(0.0, 1.0) * n), n - 1.0)
        return torch.where(self._discrete_t(U), lev, torch.zeros_like(lev)).long()

    def unit_to_embed(self, U: torch.Tensor) -> torch.Tensor:
        """Unit batch [..., dim] -> surrogate features [..., d_embed];
        differentiable in the real columns."""
        levels = self.unit_levels(U)
        cols = [None] * self.d_embed
        for j, off in self._scalar_cols:
            if self.is_real[j]:
                cols[off] = U[..., j]
            else:
                denom = max(float(self.n_levels[j]) - 1.0, 1.0)
                cols[off] = levels[..., j].to(U.dtype) / denom
        for j, off, width in self._onehot_specs:
            oh = torch.nn.functional.one_hot(levels[..., j], width).to(U.dtype)
            for c in range(width):
                cols[off + c] = oh[..., c]
        return torch.stack(cols, dim=-1)

    def unit_to_raw(self, U: torch.Tensor) -> torch.Tensor:
        """Unit batch [..., dim] -> RAW numeric values [..., dim], the tensor
        mirror of `decode_unit` for numeric variables: reals through the
        inverse scale (no precision rounding), integers lo + level * step,
        bools 0/1, numeric ordinal/discrete levels from a table. Columns
        whose raw values are not numeric decode to NaN (`ConstraintProgram`
        checks the result against the host decoder). Differentiable in the
        real columns; the clamp passes gradient inside [0, 1] only."""
        levels = self.unit_levels(U)
        cols = []
        for j, var in enumerate(self.space.data):
            if isinstance(var, Real):
                lo, hi = float(self.lo_t[j]), float(self.hi_t[j])
                t = lo + (hi - lo) * U[..., j].clamp(0.0, 1.0)
                scale = var._scale
                if scale == "log":
                    t = torch.exp(t)
                elif scale == "log10":
                    t = torch.pow(10.0, t)
                elif scale == "logit":
                    t = torch.sigmoid(t)
                elif scale == "bilog":
                    t = torch.sign(t) * torch.expm1(t.abs())
                cols.append(t)
            elif isinstance(var, Integer):
                cols.append(float(var.bounds[0]) + levels[..., j].to(U.dtype) * float(var.step))
            elif isinstance(var, Bool):
                cols.append(levels[..., j].to(U.dtype))
            else:
                vals = [var.value_of(k) for k in range(int(self.n_levels[j]))]
                if all(isinstance(v, _NUMERIC) for v in vals):
                    table = torch.tensor([float(v) for v in vals], dtype=U.dtype, device=U.device)
                    cols.append(table[levels[..., j]])
                else:
                    cols.append(torch.full(U.shape[:-1], float("nan"), dtype=U.dtype, device=U.device))
        return torch.stack(cols, dim=-1)

    def unit_to_embed_np(self, U: np.ndarray) -> np.ndarray:
        """Host (numpy) mirror of `unit_to_embed` for ask/tell paths."""
        U = np.atleast_2d(np.asarray(U, dtype=np.float64))
        n = np.maximum(self.n_levels, 1).astype(np.float64)
        lev = np.minimum(np.floor(np.clip(U, 0.0, 1.0) * n), n - 1.0)
        E = np.zeros(U.shape[:-1] + (self.d_embed,), dtype=np.float64)
        for j, off in self._scalar_cols:
            if self.is_real[j]:
                E[..., off] = U[..., j]
            else:
                E[..., off] = lev[..., j] / max(n[j] - 1.0, 1.0)
        for j, off, width in self._onehot_specs:
            idx = lev[..., j].astype(np.int64)
            E[..., off:off + width] = np.eye(width)[idx]
        return E

    def sample_unit(self, generator: torch.Generator, n: int, method: str = "uniform",
                    device=None) -> torch.Tensor:
        """Sampler on the unit cube, 'uniform' or 'lhs', from an explicit
        torch.Generator (drawn on the generator's device, then moved)."""
        gdev = generator.device
        if method == "uniform":
            U = torch.rand((n, self.dim), generator=generator, device=gdev, dtype=self.dtype)
        elif method in ("lhs", "LHS"):
            u = torch.rand((n, self.dim), generator=generator, device=gdev, dtype=self.dtype)
            perms = torch.stack(
                [torch.randperm(n, generator=generator, device=gdev) for _ in range(self.dim)],
                dim=1,
            )
            U = (perms.to(self.dtype) + u) / n
        else:
            raise ValueError(f"unknown method {method!r}")
        return U if device is None else U.to(device)

    # ---------------------------------------------------------- host codecs
    def encode_unit(self, X_raw) -> np.ndarray:
        """Raw object array [N, dim] -> unit batch f64[N, dim]."""
        X_raw = np.asarray(X_raw, dtype=object)
        if X_raw.ndim == 1:
            X_raw = X_raw.reshape(1, -1)
        U = np.zeros((X_raw.shape[0], self.dim))
        for j, var in enumerate(self.space.data):
            col = X_raw[:, j]
            if isinstance(var, Real):
                x = var._trans(np.asarray(col, dtype=float))
                lo, hi = self.lo_t[j], self.hi_t[j]
                U[:, j] = np.clip((x - lo) / max(hi - lo, 1e-300), 0.0, 1.0)
            else:
                lev = np.array([var.level_of(v) for v in col])
                U[:, j] = (lev + 0.5) / self.n_levels[j]
        return U

    def decode_unit(self, U) -> np.ndarray:
        """Unit batch [N, dim] -> raw object array, applying the inverse scale
        transform, precision rounding and level lookup."""
        U = np.asarray(U, dtype=float)
        if U.ndim == 1:
            U = U.reshape(1, -1)
        X = np.empty((U.shape[0], self.dim), dtype=object)
        for j, var in enumerate(self.space.data):
            u = np.clip(U[:, j], 0.0, 1.0)
            if isinstance(var, Real):
                lo, hi = self.lo_t[j], self.hi_t[j]
                X[:, j] = np.asarray(var.round(var.to_linear_scale(lo + (hi - lo) * u)), dtype=float)
            else:
                n = self.n_levels[j]
                lev = np.minimum((u * n).astype(int), n - 1)
                X[:, j] = np.array([var.value_of(k) for k in lev], dtype=object)
        return X

    def embed_raw(self, X_raw) -> np.ndarray:
        """Raw object array -> surrogate features (host-side)."""
        return self.unit_to_embed_np(self.encode_unit(X_raw))

    @property
    def n_free_real(self) -> int:
        """The number of real variables."""
        return int(np.sum(self.is_real))

    def __repr__(self) -> str:
        return (
            f"SpaceEncoding(dim={self.dim}, d_embed={self.d_embed}, "
            f"reals={int(self.is_real.sum())}, discretes={int((~self.is_real).sum())})"
        )

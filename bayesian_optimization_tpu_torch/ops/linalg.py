"""GP linear algebra on the hand-written blocked Cholesky.

Counterpart of bayesian_optimization_tpu/ops/linalg.py. The JAX module
built the factorisation out of fixed-shape XLA loops to bound TPU code size,
and dispatched to the Pallas kernel only where R fitted VMEM. Here every
factorisation of float32 on the card goes through the hand kernel
`whiten_fused` (ops/hopper_kernels.py), at every bucket size:

- n <= 1024 (buckets 16, 64, 256, 1024 and the MLE ladder's subsets): one
  batched `whiten_fused` call;
- n > 1024: `_factor_hybrid`, Schur updates as torch.matmul and one
  `whiten_fused` call per 1024-wide diagonal block, which also solves that
  block's subdiagonal panel and right-hand side in the same launch sequence.
  Inside a timed phase it is the span "linalg.hybrid" (utils/logging.py).

The backward of `whiten` solves with L^T in the JAX package's superpanel
form (`_super_inv`, `tri_solve_upper_t_super`): the explicit inverses of
L's 1024-wide diagonal blocks, built from the kernel's 128-wide `Dinv` by
block-nilpotent squaring (up to 1024 rows, L^-1 itself), then one GEMM a
superpanel per solve. Its other form, blocked back substitution over `Dinv`
(one GEMM a 128-block, the JAX package's choice off the TPU), does fewer
FLOPs but twice the launches, and the fits that run the backward are
host-bound: it measured slower end to end on the card. Neither form is
less accurate than cuBLAS trsm: up to cond(R) ~1e8 each solve adds ~1e-6
of the gradient, where the float32 factor's own error is 1e-4 to 1e-1
(tools/whiten_bwd_variants.py). The TPU-only code-size workarounds of the
forward (the XLA column loops) have no counterpart.

float64 never reaches the kernel: `_whiten_parts` hands it to the plain twin
`whiten_plain` (torch's Cholesky and triangular solves), on the card as on
the CPU. This is the JAX package's own routing, not a fallback: its float64
takes the non-Pallas path by dtype (`_use_fused_whiten`,
`_use_hybrid_whiten`), as its Pallas kernel is float32 only; and
`whiten_fused` raises on a float64 CUDA tensor, so a float32 call always
reaches the kernel.

All functions take a leading batch axis (one matrix per restart lane) or
none. `min_pivot`/`piv` is the smallest raw pivot before the 1e-12 clamp:
piv <= ~0 (or NaN) means the clamped factorisation is wrong, and the
likelihood folds it into its 1e12 penalty.
"""
from __future__ import annotations

import math

import torch

from ..utils.logging import span
from .hopper_kernels import as_batch, whiten_fused, whiten_plain

SUPER = 1024  # width of the hybrid factorisation's diagonal blocks


def _factor_hybrid(R: torch.Tensor, B: torch.Tensor, super_block: int = SUPER):
    """Blocked Cholesky of R (Bt, n, n) in super_block-wide panels, with the
    forward solve of B (Bt, n, mb): returns (L, Dinv, piv, W) in the layout
    of `whiten_fused` (Dinv stacks the 128-wide diagonal-block inverses).

    Per panel k: S = R_kk - L_k,<k L_k,<k^T and the subdiagonal panel C and
    right-hand side updates are torch.matmul; one `whiten_fused` launch
    sequence then factors S and solves [C^T, B_k] against it, giving the
    subdiagonal block of L (as its transpose) and W_k together."""
    Bt, n, _ = R.shape
    mb = B.shape[-1]
    L = torch.zeros_like(R)
    W = torch.empty((Bt, n, mb), dtype=R.dtype, device=R.device)
    piv = torch.full((Bt,), math.inf, dtype=R.dtype, device=R.device)
    dinvs = []
    for kb in range(0, n, super_block):
        ke = min(kb + super_block, n)
        Lrow = L[:, kb:ke, :kb]
        S = R[:, kb:ke, kb:ke]
        C = R[:, ke:, kb:ke]
        Bk = B[:, kb:ke]
        if kb > 0:
            S = S - Lrow @ Lrow.mT
            C = C - L[:, ke:, :kb] @ Lrow.mT
            Bk = Bk - Lrow @ W[:, :kb]
        _d, Wk, pk, Lkk, Dk = whiten_fused(S, torch.cat([C.mT, Bk], dim=-1))
        piv = torch.minimum(piv, pk)
        L[:, kb:ke, kb:ke] = Lkk
        L[:, ke:, kb:ke] = Wk[..., : n - ke].mT
        W[:, kb:ke] = Wk[..., n - ke:]
        dinvs.append(Dk)
    return L, torch.cat(dinvs, dim=1), piv, W


def _whiten_parts(R: torch.Tensor, B: torch.Tensor):
    """(d, W, piv, L, Dinv) for batched R (Bt, n, n), B (Bt, n, mb). float64
    takes the plain twin, chosen here by dtype (see the module docstring)."""
    if R.dtype == torch.float64:
        return whiten_plain(R, B)
    n = R.shape[-1]
    if n > SUPER:
        with span("linalg.hybrid"):
            L, Dinv, piv, W = _factor_hybrid(R, B, SUPER)
        return L.diagonal(dim1=-2, dim2=-1), W, piv, L, Dinv
    return whiten_fused(R, B)


def _super_inv(L: torch.Tensor, Dinv: torch.Tensor, super_block: int) -> list:
    """Explicit inverses of the super_block-wide diagonal blocks of a blocked
    factor (L, Dinv), one (Bt, S, S) tensor a superpanel (the last may be
    narrower), each by `_block_tri_inv` over its own Dinv blocks."""
    n, T = L.shape[-1], Dinv.shape[-1]
    per = super_block // T
    return [_block_tri_inv(L[:, kb:kb + super_block, kb:kb + super_block],
                           Dinv[:, kb // T:kb // T + per])
            for kb in range(0, n, super_block)]


def tri_solve_upper_t_super(L: torch.Tensor, Dsup: list, B: torch.Tensor,
                            super_block: int) -> torch.Tensor:
    """Solve L^T X = B bottom-up in super_block-wide panels with their
    explicit inverses Dsup (`_super_inv`): one subdiagonal GEMM and one
    inverse GEMM a superpanel."""
    n = L.shape[-1]
    X = torch.empty(B.shape, dtype=B.dtype, device=B.device)
    for k in range(len(Dsup) - 1, -1, -1):
        kb, ke = k * super_block, min(n, (k + 1) * super_block)
        Bk = B[:, kb:ke]
        if ke < n:
            Bk = torch.baddbmm(Bk, L[:, ke:, kb:ke].mT, X[:, ke:], alpha=-1.0)
        torch.bmm(Dsup[k].mT, Bk, out=X[:, kb:ke])
    return X


class _Whiten(torch.autograd.Function):
    @staticmethod
    def forward(ctx, R, B):
        with torch.no_grad():
            d, W, piv, L, Dinv = _whiten_parts(R, B)
        ctx.save_for_backward(L, W, Dinv)
        ctx.mark_non_differentiable(piv)
        return d, W, piv

    @staticmethod
    def backward(ctx, dbar, Wbar, _pivbar):
        L, W, Dinv = ctx.saved_tensors
        Dsup = _super_inv(L, Dinv, SUPER)  # once; then a GEMM pair a superpanel a solve
        return whiten_vjp(L, W, lambda X: tri_solve_upper_t_super(L, Dsup, X, SUPER), dbar, Wbar)


def whiten_vjp(L, W, solve_ut, dbar, Wbar):
    """(Rbar, Bbar) of `whiten` from its cotangents (dbar, Wbar): the
    GEMM-only VJP of bayesian_optimization_tpu/ops/linalg._whiten_bwd, with
    `solve_ut` the map X -> L^-T X."""
    U = solve_ut(Wbar)
    Lbar = torch.diag_embed(dbar) - torch.tril(U @ W.mT)
    M = L.mT @ Lbar
    Phi = torch.tril(M) - 0.5 * torch.diag_embed(M.diagonal(dim1=-2, dim2=-1))
    Y1 = solve_ut(Phi)
    Y2 = solve_ut(Y1.mT).mT
    return 0.5 * (Y2 + Y2.mT), U


def whiten(R: torch.Tensor, B: torch.Tensor):
    """(diag(L), L^-1 B, min_pivot) for SPD R = L L^T, differentiable in R
    and B. R (Bt, n, n) with B (n, mb) or (Bt, n, mb); or unbatched."""
    R3, B3, squeeze = as_batch(R, B)
    d, W, piv = _Whiten.apply(R3, B3)
    return (d[0], W[0], piv[0]) if squeeze else (d, W, piv)


def _block_diag_apply(Binv: torch.Tensor, L: torch.Tensor, side: str) -> torch.Tensor:
    """Multiply (..., n, n) by a block-diagonal matrix stored as (..., nb, b, b)."""
    n = L.shape[-1]
    nb, b = Binv.shape[-3], Binv.shape[-2]
    lead = L.shape[:-2]
    if side == "left":  # D^-1 @ L : scale row blocks
        out = torch.einsum("...kij,...kjn->...kin", Binv, L.reshape(*lead, nb, b, n))
    else:  # L @ D^-1 : scale column blocks
        out = torch.einsum("...nkj,...kji->...nki", L.reshape(*lead, n, nb, b), Binv)
    return out.reshape(*lead, n, n)


def _block_tri_inv(L: torch.Tensor, Dinv: torch.Tensor) -> torch.Tensor:
    """Explicit L^-1 from a blocked factor (L, Dinv) by block-nilpotent
    squaring: log2(nb) GEMMs, the diagonal-block inverses already in Dinv."""
    nb = Dinv.shape[-3]
    if nb == 1:
        return Dinv[..., 0, :, :]
    n = L.shape[-1]
    N = _block_diag_apply(Dinv, L, "left")
    eye = torch.eye(n, dtype=L.dtype, device=L.device)
    T = eye - N
    Rm = eye + T
    P = T
    for _ in range(max(0, int(math.ceil(math.log2(nb))) - 1)):
        P = P @ P
        Rm = Rm + Rm @ P
    return _block_diag_apply(Dinv, Rm, "right")


def chol_inv_whiten(R: torch.Tensor, B: torch.Tensor):
    """(L, L_inv, W, piv): factor, explicit inverse and W = L^-1 B, for the
    posterior state. Not differentiable (posterior states never are)."""
    with torch.no_grad():
        R3, B3, squeeze = as_batch(R, B)
        _d, W, piv, L, Dinv = _whiten_parts(R3, B3)
        L_inv = _block_tri_inv(L, Dinv)
    if squeeze:
        return L[0], L_inv[0], W[0], piv[0]
    return L, L_inv, W, piv


class _CholAndInv(torch.autograd.Function):
    """(L, L^-1, piv) of batched R with the JAX package's GEMM-only VJP
    (bayesian_optimization_tpu/ops/linalg.py::_bwd)."""

    @staticmethod
    def forward(ctx, R):
        # one zero right-hand side: the factorisation's launch sequence
        # always solves at least one column
        L, L_inv, _W, piv = chol_inv_whiten(R, R.new_zeros(R.shape[0], R.shape[-1], 1))
        ctx.save_for_backward(L, L_inv)
        ctx.mark_non_differentiable(piv)
        return L, L_inv, piv

    @staticmethod
    def backward(ctx, Lb, Lib, _pivb):
        L, Li = ctx.saved_tensors
        Lb = torch.zeros_like(L) if Lb is None else Lb
        Lb_total = torch.tril(Lb)
        if Lib is not None:  # d(L^-1) = -L^-1 dL L^-1
            Lb_total = Lb_total - torch.tril(Li.mT @ Lib @ Li.mT)
        M = L.mT @ Lb_total
        Phi = torch.tril(M) - 0.5 * torch.diag_embed(M.diagonal(dim1=-2, dim2=-1))
        Rb = Li.mT @ Phi @ Li
        return 0.5 * (Rb + Rb.mT)


def chol_and_inv(R: torch.Tensor):
    """(L, L^-1, min_pivot) of SPD R (n, n) or batched (Bt, n, n), n <= 128
    or n % 128 == 0, differentiable in R through L and L^-1 (piv is a
    diagnostic, <= ~0 when the clamped factorisation is wrong). float32 on
    the card launches `whiten_fused`."""
    squeeze = R.ndim == 2
    L, L_inv, piv = _CholAndInv.apply(R[None] if squeeze else R)
    return (L[0], L_inv[0], piv[0]) if squeeze else (L, L_inv, piv)

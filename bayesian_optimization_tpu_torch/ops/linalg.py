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

The TPU-only code-size workarounds (the XLA column loops, nilpotent-squaring
solves, `_super_inv` and the superpanel solves) have no counterpart. The
backward of `whiten` uses torch.linalg.solve_triangular: those solves were
not a Pallas kernel in the JAX package either.

All functions take a leading batch axis (one matrix per restart lane) or
none. `min_pivot`/`piv` is the smallest raw pivot before the 1e-12 clamp:
piv <= ~0 (or NaN) means the clamped factorisation is wrong, and the
likelihood folds it into its 1e12 penalty.
"""
from __future__ import annotations

import math

import torch

from .hopper_kernels import as_batch, whiten_fused

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
    """(d, W, piv, L, Dinv) for batched R (Bt, n, n), B (Bt, n, mb)."""
    if R.shape[-1] > SUPER:
        L, Dinv, piv, W = _factor_hybrid(R, B)
        return L.diagonal(dim1=-2, dim2=-1), W, piv, L, Dinv
    return whiten_fused(R, B)


class _Whiten(torch.autograd.Function):
    @staticmethod
    def forward(ctx, R, B):
        with torch.no_grad():
            d, W, piv, L, _Dinv = _whiten_parts(R, B)
        ctx.save_for_backward(L, W)
        ctx.mark_non_differentiable(piv)
        return d, W, piv

    @staticmethod
    def backward(ctx, dbar, Wbar, _pivbar):
        # GEMM-only VJP of bayesian_optimization_tpu/ops/linalg._whiten_bwd;
        # the triangular solves with L^T go to torch.linalg.solve_triangular
        L, W = ctx.saved_tensors
        Lt = L.mT

        def solve_ut(X):  # L^-T X
            return torch.linalg.solve_triangular(Lt, X, upper=True)

        U = solve_ut(Wbar)
        Lbar = torch.diag_embed(dbar) - torch.tril(U @ W.mT)
        M = Lt @ Lbar
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

"""Hand-written Hopper kernels of the GP hot path, with their plain twins.

Counterpart of bayesian_optimization_tpu/ops/pallas_kernels.py. Each kernel
has three parts here:

- a wrapper (`matern_fused`, `whiten_fused`) that launches the CUDA kernel
  of csrc/ on a CUDA float32 tensor, and raises on any other CUDA input or a
  failed build or launch. A tensor on the CPU goes to the plain twin; that is
  the only case the twin runs in place of the kernel. There is no fallback;
- a plain PyTorch twin (`matern_plain`, `whiten_plain`) of the same function,
  which defines the semantics. The CPU tests hold it against the JAX
  package, and `chip_smoke.py` holds the kernel against it on the card;
- a launch counter, an int attribute on the wrapper (`matern_fused.launches`,
  `whiten_fused.launches`), raised by one where the kernel is launched and
  nowhere else.

The kernels are built at first use (ops/_build.py); nothing is compiled or
loaded when this module is imported.
"""
from __future__ import annotations

import math

import torch

from . import _build

TILE = 128  # width of the Cholesky panels and of the Dinv blocks


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------


def _nu_code(nu: float) -> int:
    """Kernel-map selector shared by the twin and the CUDA kernel:
    nu in {1/2, 3/2, 5/2} -> Matern, any other value -> RBF (as matern_pallas)."""
    return {0.5: 1, 1.5: 3, 2.5: 5}.get(float(nu), 0)


def _require_cuda_f32(name: str, **tensors) -> None:
    for arg, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is on {t.device}, expected a CUDA tensor")
        if t.dtype != torch.float32:
            raise NotImplementedError(f"{name}: {arg} is {t.dtype}; the kernel takes float32")


def _stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---------------------------------------------------------------------------
# Matern / RBF correlation matrix (replaces pallas_kernels.matern_pallas)
# ---------------------------------------------------------------------------


def _theta_2d(theta: torch.Tensor, D: int) -> torch.Tensor:
    """theta as (B, D): a scalar or (D,) vector is one lane."""
    theta = torch.as_tensor(theta)
    if theta.ndim <= 1:
        return theta.reshape(1, -1).expand(1, D)
    if theta.ndim != 2 or theta.shape[1] != D:
        raise ValueError(f"theta must be (D,) or (B, D) with D={D}, got {tuple(theta.shape)}")
    return theta


def _sq_dist_plain(theta2: torch.Tensor, X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """r2[b, i, j] = sum_d max(theta[b, d], 0) (X[i, d] - Y[j, d])^2, in the
    kernel's direct form: one (N, M) difference per feature, no expansion."""
    w = theta2.clamp_min(0.0)
    r2 = None
    for d in range(X.shape[1]):
        diff = X[:, d, None] - Y[None, :, d]
        term = w[:, d, None, None] * (diff * diff)[None]
        r2 = term if r2 is None else r2 + term
    return r2


def _kernel_map(r2: torch.Tensor, code: int) -> torch.Tensor:
    if code == 0:
        return torch.exp(-r2)
    r = torch.sqrt(r2.clamp_min(1e-30))
    if code == 1:
        return torch.exp(-r)
    if code == 3:
        s = math.sqrt(3.0) * r
        return (1.0 + s) * torch.exp(-s)
    s = math.sqrt(5.0) * r
    return (1.0 + s + s * s / 3.0) * torch.exp(-s)


def _dk_dr2(r2: torch.Tensor, K: torch.Tensor, code: int) -> torch.Tensor:
    """dK/dr2 of the map, with r = sqrt(max(r2, 1e-30)) as in the JAX
    package's _safe_sqrt: zero where r2 is below the clamp (for nu = 1/2 the
    derivative is singular at r -> 0)."""
    if code == 0:
        return -K
    live = r2 > 1e-30
    r = torch.sqrt(r2.clamp_min(1e-30))
    if code == 1:
        h = -torch.exp(-r) / (2.0 * r)
    elif code == 3:
        h = -1.5 * torch.exp(-math.sqrt(3.0) * r)
    else:
        s = math.sqrt(5.0) * r
        h = -(5.0 / 6.0) * (1.0 + s) * torch.exp(-s)
    return torch.where(live, h, torch.zeros_like(h))


def _matern_plain_batched(theta2, X, Y, code: int, sym: bool) -> torch.Tensor:
    K = _kernel_map(_sq_dist_plain(theta2, X, Y), code)
    if sym:
        eye = torch.eye(X.shape[0], Y.shape[0], dtype=torch.bool, device=X.device)
        K = torch.where(eye, torch.ones_like(K), K)
    return K


def matern_plain(theta, X, Y=None, nu: float = 1.5, sym=None) -> torch.Tensor:
    """Plain twin of `matern_fused`: (N, M) for theta (D,), (B, N, M) for
    theta (B, D). sym (default: Y is None) sets an exact unit diagonal."""
    if sym is None:
        sym = Y is None
    theta2 = _theta_2d(theta, X.shape[1]).to(X.dtype)
    K = _matern_plain_batched(theta2, X, X if Y is None else Y, _nu_code(nu), sym)
    return K if torch.as_tensor(theta).ndim == 2 else K[0]


def _launch_matern(theta2, X, Y, code: int, sym: bool) -> torch.Tensor:
    _require_cuda_f32("matern_fused", theta=theta2, X=X, Y=Y)
    for arg, t in (("theta", theta2), ("X", X), ("Y", Y)):
        if not t.is_contiguous():
            raise ValueError(f"matern_fused: {arg} must be contiguous")
    B, D = theta2.shape
    N, M = X.shape[0], Y.shape[0]
    if X.ndim != 2 or Y.ndim != 2 or Y.shape[1] != D:
        raise ValueError("matern_fused: X (N, D) and Y (M, D) must share D")
    if B > 65535:
        raise ValueError(f"matern_fused: batch {B} exceeds the grid limit 65535")
    K = torch.empty((B, N, M), dtype=torch.float32, device=X.device)
    if K.numel() == 0:
        return K
    lib = _build.load_library()
    err = lib.botorch_matern(
        theta2.data_ptr(), X.data_ptr(), Y.data_ptr(), K.data_ptr(),
        B, N, M, D, code, int(bool(sym)), _stream_ptr(X),
    )
    _build.check(err, "matern_fused")
    matern_fused.launches += 1
    return K


class _MaternFn(torch.autograd.Function):
    """Forward: the CUDA kernel (or the twin for CPU tensors). Backward: torch
    ops over the saved inputs -- the Pallas kernel had no backward. With
    A = dL/dK * dK/dr2 (B, N, M), every gradient is a reduction of A that
    expands into GEMMs (the JAX package's matmul form of the distance):
        dtheta = rowsum(A) X^2 + colsum(A) Y^2 - 2 sum_i X * (A Y),
        dX     = 2 sum_b theta_b * (rowsum(A_b) X - A_b Y),
        dY     = 2 sum_b theta_b * (colsum(A_b) Y - A_b^T X)."""

    @staticmethod
    def forward(ctx, theta2, X, Y, code, sym, same):
        with torch.no_grad():
            if X.device.type == "cpu":
                K = _matern_plain_batched(theta2, X, Y, code, sym)
            else:
                K = _launch_matern(theta2, X, Y, code, sym)
        ctx.save_for_backward(theta2, X, Y, K)
        ctx.code, ctx.sym, ctx.same = code, sym, same
        return K

    @staticmethod
    def backward(ctx, G):
        theta2, X, Y, K = ctx.saved_tensors
        code, sym, same = ctx.code, ctx.sym, ctx.same
        w = theta2.clamp_min(0.0)
        # r2 by the GEMM expansion, as the JAX package computes it
        Xw = X[None] * w[:, None, :]
        r2 = ((Xw * X[None]).sum(-1)[..., None] + (Y[None] * w[:, None, :] * Y[None]).sum(-1)[:, None, :]
              - 2.0 * Xw @ Y.T).clamp_min(0.0)
        A = G * _dk_dr2(r2, K, code)
        if sym:
            eye = torch.eye(X.shape[0], Y.shape[0], dtype=torch.bool, device=X.device)
            A = torch.where(eye, torch.zeros_like(A), A)
        row, col = A.sum(-1), A.sum(-2)       # (B, N), (B, M)
        AY = A @ Y                            # (B, N, D)
        g_theta = g_x = g_y = None
        if ctx.needs_input_grad[0]:
            g_theta = row @ (X * X) + col @ (Y * Y) - 2.0 * (X[None] * AY).sum(-2)
            g_theta = g_theta * (theta2 > 0)
        need_x = ctx.needs_input_grad[1]
        need_y = ctx.needs_input_grad[2] or (same and need_x)
        if need_x:
            g_x = 2.0 * (w[:, None, :] * (row[..., None] * X[None] - AY)).sum(0)
        if need_y:
            AtX = A.mT @ X
            g_y = 2.0 * (w[:, None, :] * (col[..., None] * Y[None] - AtX)).sum(0)
        if same:  # Y is X: both sides of the distance move with X
            g_x = g_x + g_y if need_x else None
            g_y = None
        return g_theta, g_x, g_y, None, None, None


def matern_fused(theta, X, Y=None, nu: float = 1.5, sym=None) -> torch.Tensor:
    """Fused Matern/RBF correlation matrix, the counterpart of matern_pallas.

    theta (D,) -> K (N, M); theta (B, D) -> K (B, N, M), X and Y shared by
    all B lanes. Any N and M (the ragged edge is masked in the kernel).
    sym (default: Y is None) sets an exact unit diagonal. Differentiable in
    theta, X and Y."""
    if sym is None:
        sym = Y is None
    squeeze = torch.as_tensor(theta).ndim < 2
    theta2 = _theta_2d(theta, X.shape[1]).to(X.dtype)
    if X.device.type == "cuda":
        theta2 = theta2.contiguous()
    Yv = X if Y is None else Y
    K = _MaternFn.apply(theta2, X, Yv, _nu_code(nu), bool(sym), Y is None)
    return K[0] if squeeze else K


matern_fused.launches = 0


# ---------------------------------------------------------------------------
# blocked Cholesky + forward solve (replaces pallas_kernels.whiten_fused)
# ---------------------------------------------------------------------------


def _block(n: int) -> int:
    """Diagonal-block width: 128, or n itself below 128 (the JAX layout)."""
    if n <= TILE:
        return n
    if n % TILE:
        raise ValueError(f"whiten_fused needs n <= {TILE} or n % {TILE} == 0, got n={n}")
    return TILE


def as_batch(R, B):
    """(R (Bt, n, n), B (Bt, n, mb), was_unbatched): an unbatched pair gets
    a batch of one; a shared (n, mb) B is broadcast over R's batch."""
    if R.ndim == 2:
        return R[None], B[None], True
    return R, B.expand(R.shape[0], *B.shape[-2:]), False


def _chol_clamped(R: torch.Tensor):
    """Column-sweep Cholesky with the kernel's 1e-12 pivot clamp, batched:
    (L, min raw pivot). Used by the twin where LAPACK reports failure."""
    n = R.shape[-1]
    L = torch.zeros_like(R)
    piv = torch.full(R.shape[:-2], math.inf, dtype=R.dtype, device=R.device)
    floor = torch.tensor(1e-12, dtype=R.dtype, device=R.device)
    for j in range(n):
        rj = L[:, j, :j]
        raw = R[:, j, j] - (rj * rj).sum(-1)
        piv = torch.minimum(piv, raw)
        d = torch.sqrt(torch.where(raw > 1e-12, raw, floor))
        L[:, j, j] = d
        if j + 1 < n:
            L[:, j + 1:, j] = (R[:, j + 1:, j] - (L[:, j + 1:, :j] @ rj[..., None])[..., 0]) / d[:, None]
    return L, piv


def _dinv_blocks(L: torch.Tensor, T: int) -> torch.Tensor:
    Bt, n, _ = L.shape
    nb = n // T
    blocks = torch.stack([L[:, k * T:(k + 1) * T, k * T:(k + 1) * T] for k in range(nb)], dim=1)
    eye = torch.eye(T, dtype=L.dtype, device=L.device).expand_as(blocks)
    return torch.linalg.solve_triangular(blocks, eye, upper=False)


def whiten_plain(R: torch.Tensor, B: torch.Tensor):
    """Plain twin of `whiten_fused`: (d, W, piv, L, Dinv) with R = L L^T,
    W = L^-1 B, d = diag L, Dinv the inverses of L's T-wide diagonal blocks
    (T = min(n, 128)), and piv the smallest raw pivot before the 1e-12 clamp.
    Batched over a leading axis of R and B, or unbatched."""
    with torch.no_grad():
        R3, B3, squeeze = as_batch(R, B)
        T = _block(R3.shape[-1])
        L, info = torch.linalg.cholesky_ex(R3)
        piv = L.diagonal(dim1=-2, dim2=-1).square().amin(-1)
        bad = info != 0
        if bool(bad.any()):
            idx = bad.nonzero()[:, 0]
            Lb, pb = _chol_clamped(R3[idx])
            L = L.clone()
            L[idx] = Lb
            piv[idx] = pb
        W = torch.linalg.solve_triangular(L, B3, upper=False)
        Dinv = _dinv_blocks(L, T)
        d = L.diagonal(dim1=-2, dim2=-1)
        out = (d, W, piv, L, Dinv)
    return tuple(o[0] for o in out) if squeeze else out


def whiten_fused(R: torch.Tensor, B: torch.Tensor):
    """Blocked Cholesky + forward solve, the counterpart of the TPU
    whiten_fused: (d, W, piv, L, Dinv) as `whiten_plain` defines them.

    R (Bt, n, n) SPD and B (Bt, n, mb), or unbatched (n, n), (n, mb);
    n <= 128 or n % 128 == 0. The caller's R and B are only read (they are
    copied into the kernel's workspace), so they may have any strides.
    L and W come back as views into that workspace."""
    if R.device.type == "cpu":
        return whiten_plain(R, B)
    _require_cuda_f32("whiten_fused", R=R, B=B)
    R3, B3, squeeze = as_batch(R, B)
    Bt, n, n2 = R3.shape
    if n != n2 or B3.shape[:2] != (Bt, n):
        raise ValueError(
            f"whiten_fused: R {tuple(R.shape)} and B {tuple(B.shape)} do not match"
        )
    if Bt > 65535:
        raise ValueError(f"whiten_fused: batch {Bt} exceeds the grid limit 65535")
    T = _block(n)
    mb = B3.shape[-1]
    ws = torch.empty((Bt, n + mb, n), dtype=torch.float32, device=R.device)
    ws[:, :n].copy_(R3)
    ws[:, n:].copy_(B3.transpose(-1, -2))
    dinv = torch.empty((Bt, n // T, T, T), dtype=torch.float32, device=R.device)
    piv = torch.full((Bt,), math.inf, dtype=torch.float32, device=R.device)
    lib = _build.load_library()
    err = lib.botorch_whiten(
        ws.data_ptr(), dinv.data_ptr(), piv.data_ptr(), Bt, n + mb, n, T, _stream_ptr(R)
    )
    _build.check(err, "whiten_fused")
    whiten_fused.launches += 1
    L = ws[:, :n]
    W = ws[:, n:].transpose(-1, -2)
    out = (L.diagonal(dim1=-2, dim2=-1), W, piv, L, dinv)
    return tuple(o[0] for o in out) if squeeze else out


whiten_fused.launches = 0


def reset_launch_counts() -> None:
    matern_fused.launches = 0
    whiten_fused.launches = 0

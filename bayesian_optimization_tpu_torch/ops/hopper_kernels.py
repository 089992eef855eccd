"""Hand-written Hopper kernels of the GP hot path, with their plain twins.

Counterpart of bayesian_optimization_tpu/ops/pallas_kernels.py. Each kernel
has three parts here:

- a wrapper (`matern_fused`, `whiten_fused`) that launches the CUDA kernel
  of csrc/ on a CUDA float32 tensor, and raises on any other CUDA input or a
  failed build or launch. A tensor on the CPU goes to the plain twin; that is
  the only case the twin runs in place of the kernel. There is no fallback.
  `matern_fused`'s backward is a kernel too (`matern_bwd_fused`), and so is
  that backward's own backward in G and X (`matern_bwd2_fused`), which a
  Hessian in the cross-covariance's first argument runs;
- a plain PyTorch twin (`matern_plain`, `matern_bwd_plain`,
  `matern_bwd2_plain`, `whiten_plain`) of the same function, which defines
  the semantics. The CPU tests hold it
  against the JAX package, and the card tests
  (tests/test_torch_cuda_kernels.py) hold the kernel against it on the
  card. `matern_twin` runs the Matern twins with their autograd on
  any device (the float64 route of models/kernels.py);
- a launch counter, an int attribute on the wrapper (`matern_fused.launches`,
  `whiten_fused.launches`), raised by one where the kernel is launched and
  nowhere else; `matern_fused.bwd_launches` counts the backward kernel's
  calls (one launch each), `matern_fused.bwd2_launches` the second
  derivative's (one launch each).

`lbfgs_update_fused` launches one trip's update of the batched L-BFGS
(csrc/lbfgs.cu) and nothing else: the optimizer's state, its twin
`lbfgs_update_plain` and the choice between them are ops/optimize.py's, as
the float64 route of the Matern covariance is models/kernels.py's. It
raises on any input but a CUDA float32 state; the card tests hold it
against the twin, and `lbfgs_update_fused.launches` counts it. An index
entry of -1 names no lane: the kernel leaves it alone, as the twin does.

The backward and the second derivative sum their blocks' partials in the
same launch: the last block to arrive adds them up, found through an
arrival counter in device memory that the kernel leaves at 0. Each (device,
stream) has its own counters (`_launch_context`), so calls in flight on two
streams never share one.

The kernels are built at first use (ops/_build.py); nothing is compiled or
loaded when this module is imported.
"""
from __future__ import annotations

import functools
import math
import threading

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


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# (device index, stream) -> int32 arrival counters: the backward's grid, the
# second derivative's grid, then the backward's row tiles
_COUNTERS: dict = {}
_COUNTERS_LOCK = threading.Lock()


def _launch_context(t: torch.Tensor, row_tiles: int = 0):
    """(stream pointer, counters, SM count) for a launch on t's device and
    current stream. The counters are zeroed int32s in device memory kept for
    that stream: the backward's, the second derivative's, then `row_tiles`
    more, one per row tile of the backward (as many as
    botorch_matern_bwd_row_tiles reports); each kernel's last blocks leave
    theirs at 0 for the next call, and a call on another stream has other
    counters."""
    stream = torch.cuda.current_stream(t.device)
    index = stream.device.index
    key = (index, stream.cuda_stream)
    size = 2 + row_tiles
    with _COUNTERS_LOCK:
        counters = _COUNTERS.get(key)
        if counters is None or counters.numel() < size:
            # zeroed on this stream, before any launch that uses them
            grown = size if counters is None else max(size, 2 * counters.numel())
            counters = _COUNTERS[key] = torch.zeros(grown, dtype=torch.int32, device=t.device)
    return stream.cuda_stream, counters, _sm_count(index)


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


def matern_bwd_plain(theta2, X, Y, K, G, code: int, sym: bool, same: bool, needs):
    """Plain twin of the backward kernel: (g_theta, g_x, g_y) of K =
    matern(theta2, X, Y) for G = dL/dK (B, N, M), each None unless `needs`
    (theta, X, Y) asks for it; with `same` (Y is X) g_x carries both sides.
    Torch ops over the inputs and K, with A = G * dK/dr2 (B, N, M): every
    gradient is a reduction of A that expands into GEMMs (the JAX package's
    matmul form of the distance):
        dtheta = rowsum(A) X^2 + colsum(A) Y^2 - 2 sum_i X * (A Y),
        dX     = 2 sum_b theta_b * (rowsum(A_b) X - A_b Y),
        dY     = 2 sum_b theta_b * (colsum(A_b) Y - A_b^T X)."""
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
    if needs[0]:
        g_theta = row @ (X * X) + col @ (Y * Y) - 2.0 * (X[None] * AY).sum(-2)
        g_theta = g_theta * (theta2 > 0)
    need_x = needs[1]
    need_y = needs[2] or (same and need_x)
    if need_x:
        g_x = 2.0 * (w[:, None, :] * (row[..., None] * X[None] - AY)).sum(0)
    if need_y:
        AtX = A.mT @ X
        g_y = 2.0 * (w[:, None, :] * (col[..., None] * Y[None] - AtX)).sum(0)
    if same:  # Y is X: both sides of the distance move with X
        g_x = g_x + g_y if need_x else None
        g_y = None
    return g_theta, g_x, g_y


def matern_bwd_fused(theta2, X, Y, G, code: int, sym: bool, same: bool, needs):
    """The backward kernel on CUDA tensors: (g_theta, g_x, g_y) as
    `matern_bwd_plain` defines them (without K), in one launch: the blocks'
    partial sums, then their sum in a fixed order by the last block, so
    repeated calls are bit-identical. Raises on a CPU or non-float32 tensor."""
    G = G.contiguous()
    _require_cuda_f32("matern_fused backward", theta=theta2, X=X, Y=Y, G=G)
    B, D = theta2.shape
    N, M = X.shape[0], Y.shape[0]
    if not (theta2.is_contiguous() and X.is_contiguous() and Y.is_contiguous()):
        raise ValueError("matern_fused backward: theta, X and Y must be contiguous")
    if G.shape != (B, N, M):
        raise ValueError(f"matern_fused backward: G is {tuple(G.shape)}, expected {(B, N, M)}")
    if B > 65535:
        raise ValueError(f"matern_fused backward: batch {B} exceeds the grid limit 65535")
    need_t, need_x = bool(needs[0]), bool(needs[1])
    need_y = bool(needs[2]) or (same and need_x)
    lib = _build.load_library()
    sms = _sm_count(X.device.index)
    plan = (B, N, M, D, int(same), int(need_x), int(need_y), sms)
    stream, counters, _ = _launch_context(X, lib.botorch_matern_bwd_row_tiles(*plan))
    scratch = torch.empty(lib.botorch_matern_bwd_scratch(*plan), dtype=torch.float32,
                          device=X.device)

    def out(flag, *shape):
        return torch.empty(shape, dtype=torch.float32, device=X.device) if flag else None

    g_theta, g_x, g_y = out(need_t, B, D), out(need_x, N, D), out(need_y and not same, M, D)
    err = lib.botorch_matern_bwd(
        theta2.data_ptr(), X.data_ptr(), Y.data_ptr(), G.data_ptr(), scratch.data_ptr(),
        counters.data_ptr(), counters[2:].data_ptr(),
        *(0 if t is None else t.data_ptr() for t in (g_theta, g_x, g_y)),
        B, N, M, D, code, int(sym), int(same), int(need_t), int(need_x), int(need_y), sms, stream,
    )
    _build.check(err, "matern_fused backward")
    matern_fused.bwd_launches += 1
    return g_theta, g_x, g_y


def _d2k_dr2(r2: torch.Tensor, code: int):
    """(dK/dr2, d2K/dr2^2) of the map, computed from r2 alone, both zero
    where r2 <= 1e-30 for Matern (as `_dk_dr2`)."""
    if code == 0:
        k = torch.exp(-r2)
        return -k, k
    live = r2 > 1e-30
    r = torch.sqrt(r2.clamp_min(1e-30))
    if code == 1:
        e = torch.exp(-r)
        h, h2 = -e / (2.0 * r), e * (1.0 + r) / (4.0 * r2.clamp_min(1e-30) * r)
    elif code == 3:
        e = torch.exp(-math.sqrt(3.0) * r)
        h, h2 = -1.5 * e, (0.75 * math.sqrt(3.0)) * e / r
    else:
        s = math.sqrt(5.0) * r
        e = torch.exp(-s)
        h, h2 = -(5.0 / 6.0) * (1.0 + s) * e, (25.0 / 12.0) * e
    zero = torch.zeros_like(h)
    return torch.where(live, h, zero), torch.where(live, h2, zero)


def matern_bwd2_plain(theta2, X, Y, G, V, code: int, sym: bool, needs):
    """Plain twin of the second-derivative kernel: the backward's own
    backward in G and X. For g_x = sum_{b,j} G_bij dK_bij/dX_i (the
    backward's X gradient) and V = dL/dg_x (N, D), returns (gG (B, N, M),
    gX (N, D)), each None unless `needs` (G, X) asks for it:
        gG[b, i, j] = 2 h c,   c = sum_l w_bl d_ijl V_il,
        gX[i, k]    = sum_b w_bk sum_j G_bij (2 h V_ik + 4 h2 c d_ijk),
    with d = x_i - y_j, w = max(theta, 0), h and h2 the map's first and
    second derivatives in r2 (zero on the unit diagonal with sym). r2 in the
    kernel's direct form."""
    w = theta2.clamp_min(0.0)
    h, h2 = _d2k_dr2(_sq_dist_plain(theta2, X, Y), code)
    if sym:
        eye = torch.eye(X.shape[0], Y.shape[0], dtype=torch.bool, device=X.device)
        h, h2 = (torch.where(eye, torch.zeros_like(t), t) for t in (h, h2))
    diffs = [X[:, d, None] - Y[None, :, d] for d in range(X.shape[1])]
    c = sum(w[:, d, None, None] * (diff * V[:, d, None])[None] for d, diff in enumerate(diffs))
    gG = 2.0 * h * c if needs[0] else None
    gX = None
    if needs[1]:
        P, Q = (G * h).sum(-1), G * h2 * c  # (B, N), (B, N, M)
        gX = torch.stack([(w[:, d, None] * (2.0 * V[None, :, d] * P + 4.0 * (Q * diff[None]).sum(-1))).sum(0)
                          for d, diff in enumerate(diffs)], -1)
    return gG, gX


BWD2_SMEM_BYTES = 226 * 1024  # the second derivative's shared memory (csrc/matern_bwd2.cu)


def matern_bwd2_fused(theta2, X, Y, G, V, code: int, sym: bool, needs):
    """The second-derivative kernel on CUDA tensors: (gG, gX) as
    `matern_bwd2_plain` defines them, in one launch, each row's pairs spread
    over several blocks and their partials summed in a fixed order by the
    last block, so repeated calls are bit-identical. Raises on a CPU or
    non-float32 tensor."""
    G, V = G.contiguous(), V.contiguous()
    _require_cuda_f32("matern_fused second derivative", theta=theta2, X=X, Y=Y, G=G, V=V)
    B, D = theta2.shape
    N, M = X.shape[0], Y.shape[0]
    if not (theta2.is_contiguous() and X.is_contiguous() and Y.is_contiguous()):
        raise ValueError("matern_fused second derivative: theta, X and Y must be contiguous")
    if G.shape != (B, N, M) or V.shape != (N, D):
        raise ValueError(f"matern_fused second derivative: G {tuple(G.shape)} and V "
                         f"{tuple(V.shape)}, expected {(B, N, M)} and {(N, D)}")
    if 4 * (B + 2) * D > BWD2_SMEM_BYTES:  # w and the row of X and of V, in shared memory
        raise ValueError(f"matern_fused second derivative: theta {(B, D)} exceeds the kernel's "
                         f"{BWD2_SMEM_BYTES} bytes of shared memory")
    lib = _build.load_library()
    stream, counters, sms = _launch_context(X)
    scratch = torch.empty(lib.botorch_matern_bwd2_scratch(B, N, M, D, sms), dtype=torch.float32,
                          device=X.device)

    def out(flag, *shape):
        return torch.empty(shape, dtype=torch.float32, device=X.device) if flag else None

    gG, gX = out(needs[0], B, N, M), out(needs[1], N, D)
    err = lib.botorch_matern_bwd2(
        theta2.data_ptr(), X.data_ptr(), Y.data_ptr(), G.data_ptr(), V.data_ptr(),
        *(0 if t is None else t.data_ptr() for t in (gG, gX)), scratch.data_ptr(),
        counters.data_ptr() + counters.element_size(), B, N, M, D, code, int(sym), sms, stream,
    )
    _build.check(err, "matern_fused second derivative")
    matern_fused.bwd2_launches += 1
    return gG, gX


class _MaternBwdFn(torch.autograd.Function):
    """`_MaternFn`'s backward as a function of its own, so that it can be
    differentiated: forward the backward kernel (with `plain`, its twin),
    backward the second-derivative kernel (its twin) for the derivative of
    g_x in G and X, the one a Hessian in a cross-covariance's first
    argument needs (GaussianProcess.Hessian). A second derivative through
    theta or Y, or of K(X, X) in X, has no kernel and raises."""

    @staticmethod
    def forward(ctx, G, theta2, X, Y, K, code, sym, same, needs, plain):
        with torch.no_grad():
            if plain:
                grads = matern_bwd_plain(theta2, X, Y, K, G, code, sym, same, needs)
            else:
                grads = matern_bwd_fused(theta2, X, Y, G, code, sym, same, needs)
        ctx.save_for_backward(G, theta2, X, Y)
        ctx.code, ctx.sym, ctx.same, ctx.plain = code, sym, same, plain
        ctx.set_materialize_grads(False)
        return grads

    @staticmethod
    def backward(ctx, gg_theta, gg_x, gg_y):
        G, theta2, X, Y = ctx.saved_tensors
        need_g, need_t, need_x, need_y = ctx.needs_input_grad[:4]
        if gg_theta is not None or gg_y is not None or ctx.same or need_t or need_y:
            raise NotImplementedError(
                "matern_fused: a second derivative through theta or Y, or of K(X, X), has no "
                "kernel; the second-derivative kernel differentiates the X gradient of a "
                "cross-covariance in G and X")
        gG = gX = None
        if gg_x is not None and (need_g or need_x):
            fn = matern_bwd2_plain if ctx.plain else matern_bwd2_fused
            gG, gX = fn(theta2, X, Y, G, gg_x, ctx.code, ctx.sym, (need_g, need_x))
        return gG, None, gX, None, None, None, None, None, None, None


class _MaternFn(torch.autograd.Function):
    """Forward: the CUDA kernel, backward: the backward kernel, itself
    differentiable in G and X through the second-derivative kernel
    (`_MaternBwdFn`); with `plain`, the twins of all three (the Pallas
    kernel had no derivative)."""

    @staticmethod
    def forward(ctx, theta2, X, Y, code, sym, same, plain):
        with torch.no_grad():
            if plain:
                K = _matern_plain_batched(theta2, X, Y, code, sym)
                ctx.save_for_backward(theta2, X, Y, K)  # the twin reads K (RBF)
            else:
                K = _launch_matern(theta2, X, Y, code, sym)
                ctx.save_for_backward(theta2, X, Y)  # the kernel recomputes r2
        ctx.code, ctx.sym, ctx.same, ctx.plain = code, sym, same, plain
        return K

    @staticmethod
    def backward(ctx, G):
        theta2, X, Y, *K = ctx.saved_tensors
        needs = ctx.needs_input_grad[:3]
        if not any(needs):
            return None, None, None, None, None, None, None
        grads = _MaternBwdFn.apply(G, theta2, X, Y, K[0] if K else None, ctx.code, ctx.sym,
                                   ctx.same, needs, ctx.plain)
        return (*grads, None, None, None, None)


def _matern_apply(theta, X, Y, nu, sym, plain: bool) -> torch.Tensor:
    if sym is None:
        sym = Y is None
    squeeze = torch.as_tensor(theta).ndim < 2
    theta2 = _theta_2d(theta, X.shape[1]).to(X.dtype)
    if X.device.type == "cuda":
        theta2 = theta2.contiguous()
    Yv = X if Y is None else Y
    K = _MaternFn.apply(theta2, X, Yv, _nu_code(nu), bool(sym), Y is None, plain)
    return K.squeeze(0) if squeeze else K  # a view: its backward launches nothing


def matern_fused(theta, X, Y=None, nu: float = 1.5, sym=None) -> torch.Tensor:
    """Fused Matern/RBF correlation matrix, the counterpart of matern_pallas.

    theta (D,) -> K (N, M); theta (B, D) -> K (B, N, M), X and Y shared by
    all B lanes. Any N and M (the ragged edge is masked in the kernel).
    sym (default: Y is None) sets an exact unit diagonal. Differentiable in
    theta, X and Y; twice in X, through the second-derivative kernel, where
    Y is given and neither theta nor Y needs a gradient."""
    return _matern_apply(theta, X, Y, nu, sym, plain=X.device.type == "cpu")


def matern_twin(theta, X, Y=None, nu: float = 1.5, sym=None) -> torch.Tensor:
    """`matern_fused`'s function through its twins on any device and dtype:
    forward `matern_plain`, backward `matern_bwd_plain` (its own backward
    `matern_bwd2_plain`), what a CPU tensor
    runs. Launches nothing; the float64 route of models/kernels.py."""
    return _matern_apply(theta, X, Y, nu, sym, plain=True)


matern_fused.launches = 0
matern_fused.bwd_launches = 0
matern_fused.bwd2_launches = 0


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


# ---------------------------------------------------------------------------
# one trip's update of the batched L-BFGS (no TPU counterpart: XLA fused it)
# ---------------------------------------------------------------------------

def lbfgs_update_fused(st, idx, f_a, g_a, z_trial, max_linesearch_steps: int, c1: float) -> None:
    """One trip's update of the live lanes idx of a batched L-BFGS state st
    (`ops.optimize.LbfgsState`: a CUDA float32 workspace `ws` and an int64
    one `iws`, laid out as csrc/lbfgs.cu reads them), as
    `ops.optimize.lbfgs_update_plain` defines it, in one launch: one warp an
    entry of idx, the state rewritten in place; an entry of -1 is left
    alone. Any other device or dtype raises, as does a failed build or
    launch. Each launch adds one to `lbfgs_update_fused.launches`."""
    ws = st.ws
    _require_cuda_f32("lbfgs_update_fused", ws=ws, z_trial=z_trial)
    # the values and gradients in the state's dtype, as the twin takes them
    idx = idx.contiguous()
    f_a = f_a.to(torch.float32).contiguous()
    g_a = g_a.to(torch.float32).contiguous()
    R, m, d = st.S.shape
    n_live = idx.numel()
    if idx.dtype != torch.long or f_a.shape != (n_live,) or g_a.shape != (n_live, d) \
            or z_trial.shape != (R, d) or not z_trial.is_contiguous() \
            or not (idx.device == f_a.device == g_a.device == ws.device):
        raise ValueError(f"lbfgs_update_fused: idx {tuple(idx.shape)} {idx.dtype}, f_a "
                         f"{tuple(f_a.shape)}, g_a {tuple(g_a.shape)} and z_trial "
                         f"{tuple(z_trial.shape)} (contiguous) do not fit {R} lanes of {d} "
                         f"on {ws.device}")
    err = _build.load_library().botorch_lbfgs_update(
        ws.data_ptr(), st.iws.data_ptr(), idx.data_ptr(), f_a.data_ptr(), g_a.data_ptr(),
        z_trial.data_ptr(), n_live, R, d, m, float(c1), int(max_linesearch_steps), _stream_ptr(ws),
    )
    _build.check(err, "lbfgs_update_fused")
    lbfgs_update_fused.launches += 1


lbfgs_update_fused.launches = 0


# every launch counter: (wrapper, attribute)
_LAUNCH_COUNTERS = ((matern_fused, "launches"), (matern_fused, "bwd_launches"),
                    (matern_fused, "bwd2_launches"), (whiten_fused, "launches"),
                    (lbfgs_update_fused, "launches"))


def launch_counts() -> tuple:
    """Every launch counter's value, in a fixed order."""
    return tuple(getattr(fn, name) for fn, name in _LAUNCH_COUNTERS)


def add_launch_counts(counts, sign: int = 1) -> None:
    """Add `sign` x `counts` (as `launch_counts` orders them) to the counters:
    a replayed CUDA graph launches again what its capture launched, with no
    call of a wrapper, and a capture itself launches nothing."""
    for (fn, name), n in zip(_LAUNCH_COUNTERS, counts):
        setattr(fn, name, getattr(fn, name) + sign * n)


def reset_launch_counts() -> None:
    for fn, name in _LAUNCH_COUNTERS:
        setattr(fn, name, 0)

"""Peaks of the card and the work of each operation, counted from shapes.

A roofline share is the least time the chip could take for an operation,
the larger of its operations over the peak rate and its bytes over the
peak bandwidth, divided by the device time it took. Operations and bytes
are what the operation needs at its shapes, whatever kernel implements it:
every input read once, every output written once, and of a symmetric or
triangular matrix only its triangle. Counted so, the bound is a lower bound
on any implementation's time and the share cannot pass 1.

Peaks: NVIDIA's H100 SXM data sheet, dense rates, at the full 700 W limit.
"""
from __future__ import annotations

F32 = 4  # bytes
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
# a float32-accurate product on the tensor cores takes three TF32 products
# (3xTF32): the fastest rate at which a correct float32 factorisation runs
F32_ACCURATE_FLOPS = TF32_FLOPS / 3.0


def bound_s(flops: float, nbytes: float, flops_per_s: float) -> float:
    """The roofline's least time: the larger of compute and memory time."""
    return max(flops / flops_per_s, nbytes / HBM_BYTES_PER_S)


def cov_build(B: int, N: int, M: int, D: int) -> tuple:
    """(flops, bytes) of B Matern-3/2 correlation matrices K (N, M) of D
    features: per entry 3 D for the weighted squared distance and 5 for the
    map (sqrt, scale, exp, 1 + s, product); theta (B, D) and the points
    read once (X and Y may be one matrix, so max(N, M) rows), K written."""
    flops = B * N * M * (3 * D + 5)
    nbytes = F32 * (B * D + max(N, M) * D + B * N * M)
    return flops, nbytes


def cov_build_bound_s(B: int, N: int, M: int, D: int) -> float:
    return bound_s(*cov_build(B, N, M, D), FP32_FLOPS)


def factor(Bt: int, n: int, mb: int) -> tuple:
    """(flops, bytes) of Bt Cholesky factorisations of (n, n) with the
    forward solve of mb right-hand sides: n^3/3 + n^2 mb operations a
    member; the lower triangle of R and the right-hand sides read, the
    lower triangle of L and the solved columns written."""
    tri = n * (n + 1) / 2
    flops = Bt * (n ** 3 / 3.0 + n * n * mb)
    nbytes = F32 * Bt * (2 * tri + 2 * n * mb)
    return flops, nbytes


def factor_bound_s(Bt: int, n: int, mb: int) -> float:
    return bound_s(*factor(Bt, n, mb), F32_ACCURATE_FLOPS)

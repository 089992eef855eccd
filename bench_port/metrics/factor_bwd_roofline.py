"""factor_bwd_roofline: the factorisation's backward's share of its
roofline (%): the least time of every call (`bound_s` below, at the shapes
the trace records for the `_WhitenBackward` autograd range: the cotangents
dbar (Bt, n) and Wbar (Bt, n, mb)) summed, over the device time of the
kernels launched inside those ranges (on the autograd engine's thread) in
the traced iterations. Nothing to read: no value.

The count is a lower bound on any implementation of the Cholesky backward
in classical arithmetic, so the share cannot pass 100%:

- operations: n^3/3 + 2 n^2 mb a member. The backward of R = L L^T,
  W = L^-1 B needs Lbar = diag(dbar) - tril((L^-T Wbar) W^T): a triangular
  solve with mb columns (n^2 mb) and the lower triangle of an outer product
  over mb (n^2 mb); and Phi = tril(L^T Lbar), whose entry (i, j), i >= j,
  sums the n - i + 1 products L[k, i] Lbar[k, j], k >= i: n^3/3 in all.
  The two triangular solves that carry Phi to Rbar = sym(L^-T Phi L^-1)
  come on top and are not counted;
- bytes: each input read once and each output written once: the lower
  triangle of L, W and Wbar, dbar; the lower triangle of the symmetric
  Rbar and Bbar;
- rate: work.F32_ACCURATE_FLOPS (3xTF32), above the FP32 rate at which the
  port's GEMMs run (TF32 is off), so the bound is lower still.
"""
from bench_port import work

RANGE = "_WhitenBackward"


def bwd(Bt: int, n: int, mb: int) -> tuple:
    """(flops, bytes) of Bt members' Cholesky backward at n rows and mb
    right-hand sides (see the module docstring)."""
    tri = n * (n + 1) / 2
    flops = Bt * (n ** 3 / 3.0 + 2.0 * n * n * mb)
    nbytes = work.F32 * Bt * (2 * tri + n + 3 * n * mb)
    return flops, nbytes


def bound_s(Bt: int, n: int, mb: int) -> float:
    return work.bound_s(*bwd(Bt, n, mb), work.F32_ACCURATE_FLOPS)


def read(ctx):
    calls = (ctx.trace or {}).get("ops", {}).get(RANGE) or []
    bound = dev = 0.0
    for shapes, dev_s in calls:
        if len(shapes) < 2 or len(shapes[1]) != 3:
            return None
        Bt, n, mb = shapes[1]
        bound += bound_s(Bt, n, mb)
        dev += dev_s
    return 100.0 * bound / dev if dev > 0 else None

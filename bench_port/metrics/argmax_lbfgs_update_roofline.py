"""argmax_lbfgs_update_roofline: the share (%) of its roofline at which the
L-BFGS update kernel (csrc/lbfgs.cu, `lbfgs_update_kernel`) runs inside the
acquisition argmax's CUDA graph replays, where the span `lbfgs.update` no
longer times it: a launch's least time for the argmax's R lanes of D
variables and its history of HISTORY pairs (R and D the X operand of the
eager trip's `_MaternFn` build that the replay repeats), each lane's state
read and written once, its value, gradient, trial point and index read
once, against 8 m D + 12 D operations a lane, summed over the replays' launches,
over their device time (bench_port/graphs.py). A port that replays no
graph reads nothing."""
from bench_port import graphs, work

KERNEL = "lbfgs_update_kernel"
HISTORY = 10  # the argmax's L-BFGS history (ops/optimize.py minimize_restarts' memory_size)


def bound_s(R: int, D: int, m: int = HISTORY) -> float:
    """One launch's least time: z, g, p, S, Y, rho, the recursion's
    scratch, f, gamma, gTp, t (3 D + 2 m D + 2 m + 4 floats) and 4 int64
    counters a lane, read and written; f, g, the trial point (1 + 2 D
    floats) and the int64 index read."""
    floats = 3 * D + 2 * m * D + 2 * m + 4
    nbytes = R * (2 * (work.F32 * floats + 8 * 4) + work.F32 * (1 + 2 * D) + 8)
    return work.bound_s(R * (8 * m * D + 12 * D), nbytes, work.FP32_FLOPS)


def _bound_s(builds, launches):
    lanes = graphs.lanes_and_features(builds)
    return None if lanes is None else launches * bound_s(*lanes)


def read(ctx):
    return graphs.kernel_share(ctx, KERNEL, _bound_s)

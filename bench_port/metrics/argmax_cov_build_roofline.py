"""argmax_cov_build_roofline: the share (%) of its roofline at which the
acquisition argmax's covariance build runs inside its CUDA graph replays,
which no `_MaternFn` range holds (`cov_build_roofline` reads the builds
launched outside a graph): the least time of the builds of the eager trip
that each replay repeats (work.cov_build_bound_s at its `_MaternFn` shapes
theta (B, D), the lanes (N, D), the rows (M, D)), summed over the replays,
over the device time of the `matern_fwd_kernel` launches of the replays
(bench_port/graphs.py). A port that replays no graph reads nothing."""
from bench_port import graphs, work

KERNEL = "matern_fwd_kernel"


def _bound_s(builds, launches):
    total = 0.0
    for shapes in builds:
        if len(shapes) < 3 or any(len(s) != 2 for s in shapes[:3]):
            return None
        (B, D), (N, _), (M, _) = shapes[:3]
        total += work.cov_build_bound_s(B, N, M, D)
    return total if builds else None


def read(ctx):
    return graphs.kernel_share(ctx, KERNEL, _bound_s)

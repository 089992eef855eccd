"""cov_build_roofline: the covariance build's share of its roofline (%):
the least time of every call (work.cov_build_bound_s at the call's
recorded shapes theta (B, D), X (N, D), Y (M, D)) summed, over the device
time of the kernels launched inside the `_MaternFn` forward ranges of the
traced iterations. Nothing to read (no call, no shapes, no device time):
no value."""
from bench_port import work

RANGE = "_MaternFn"


def read(ctx):
    calls = (ctx.trace or {}).get("ops", {}).get(RANGE) or []
    bound = dev = 0.0
    for shapes, dev_s in calls:
        if len(shapes) < 3 or len(shapes[0]) != 2 or len(shapes[1]) != 2 or len(shapes[2]) != 2:
            return None
        (B, D), (N, _), (M, _) = shapes[0], shapes[1], shapes[2]
        bound += work.cov_build_bound_s(B, N, M, D)
        dev += dev_s
    return 100.0 * bound / dev if dev > 0 else None

"""launches_per_iter: kernels the device ran an iteration in the traced
iterations (copies and fills not counted), from the profiler's trace."""


def read(ctx):
    t = ctx.trace
    return t["kernels"] / t["n_iters"] if t else None

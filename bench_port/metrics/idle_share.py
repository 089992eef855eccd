"""idle_share: the share (%) of the traced iterations' wall in which the
device ran nothing: 1 - (the union of its kernel and copy intervals) /
(the traced window), from the profiler's trace. The profiler lengthens the
host's side of that window, so this reads high: an upper bound."""


def read(ctx):
    t = ctx.trace
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t else None

"""argmax_update_share: the share (%) of the acquisition argmax's trip
seconds spent in the optimizer's own update (the span `lbfgs.update`:
acceptance, curvature history, the two-loop direction, the state's
rebuild), summed over the window's untraced iterations."""
from bench_port import program


def read(ctx):
    rows = program.records(ctx)
    whole = program.trip_seconds(rows, "arg_max_acquisition") if rows else 0.0
    if not whole:
        return None
    return 100.0 * program.total(rows, "arg_max_acquisition/lbfgs.update:s") / whole

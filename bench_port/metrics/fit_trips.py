"""fit_trips: the surrogate fit's L-BFGS trips a tell (the port's counter
`fit/lbfgs.trips`, one a batched likelihood call), a mean over the window's
untraced iterations."""
from bench_port import program


def read(ctx):
    rows = program.records(ctx)
    return program.total(rows, "fit/lbfgs.trips") / len(rows) if rows else None

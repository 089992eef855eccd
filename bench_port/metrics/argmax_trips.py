"""argmax_trips: the acquisition argmax's L-BFGS trips an ask (the port's
counter `arg_max_acquisition/lbfgs.trips`, one a batched objective call), a
mean over the window's untraced iterations."""
from bench_port import program


def read(ctx):
    rows = program.records(ctx)
    return program.total(rows, "arg_max_acquisition/lbfgs.trips") / len(rows) if rows else None

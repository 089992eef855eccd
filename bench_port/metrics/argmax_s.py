"""argmax_s: the acquisition argmax's time an ask: the `arg_max_acquisition`
phase of the port's PhaseTimer, a mean over the window's untraced iterations."""
from statistics import fmean


def read(ctx):
    rows = ctx.steady
    return fmean(r["argmax_s"] for r in rows) if rows else None

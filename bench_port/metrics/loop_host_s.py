"""loop_host_s: the BO loop's own time an iteration (core/base.py, core/bo.py):
the iteration's wall less its `fit` and `arg_max_acquisition` phases
(the port's PhaseTimer), a mean over the window's untraced iterations."""
from statistics import fmean


def read(ctx):
    rows = ctx.steady
    return fmean(r["wall"] - r["fit_s"] - r["argmax_s"] for r in rows) if rows else None

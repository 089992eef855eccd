"""fit_s: the surrogate fit's time an iteration: the `fit` phase
(BaseBO.update_model) of the port's PhaseTimer, a mean over the window's
untraced iterations."""
from statistics import fmean


def read(ctx):
    rows = ctx.steady
    return fmean(r["fit_s"] for r in rows) if rows else None

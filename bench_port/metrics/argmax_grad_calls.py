"""argmax_grad_calls: Matern backward launches over each ask (the port's
counter `matern_fused.bwd_launches`), one an L-BFGS trip of the argmax; a
mean over the window's untraced asks."""
from statistics import fmean


def read(ctx):
    return fmean(r["argmax_grad_calls"] for r in ctx.steady)

"""fit_grad_calls: Matern backward launches over each tell (the port's
counter `matern_fused.bwd_launches`): one an L-BFGS trip of the MLE ladder,
one a leapfrog of the sampler; a mean over the window's untraced
iterations."""
from statistics import fmean


def read(ctx):
    return fmean(r["fit_grad_calls"] for r in ctx.steady)

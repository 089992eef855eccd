"""iter_p90_s: the 90th percentile of the walls of every untraced iteration
that started in the window, the one still running when it closed included
(host clock). A tail of ~30 iterations: a per-layer reading beside
`iter_s`, whose spread (PERF.md, section 2) no bound holds."""
from bench_port.stats import percentile


def read(ctx):
    walls = [r["wall"] for r in ctx.steady if r["start"] < ctx.window_s]
    return percentile(walls, 90.0) if walls else None

"""argmax_graph_share: the share (%) of the acquisition argmax's L-BFGS
trips that replayed a captured CUDA graph: 100 x the port's counter
`arg_max_acquisition/lbfgs.graph_replays` over
`arg_max_acquisition/lbfgs.trips`, summed over the window's untraced
iterations. An ask's first trip runs eagerly (it warms up the capture), so
the share reads 100 less one trip an ask. A port without the graphed loop
(`ops.optimize._lbfgs_graphed`) reads nothing."""
from bench_port import program


def read(ctx):
    from bayesian_optimization_tpu_torch.ops import optimize

    rows = program.records(ctx)
    if not rows or not hasattr(optimize, "_lbfgs_graphed"):
        return None
    trips = program.total(rows, "arg_max_acquisition/lbfgs.trips")
    if not trips:
        return None
    return 100.0 * program.total(rows, "arg_max_acquisition/lbfgs.graph_replays") / trips

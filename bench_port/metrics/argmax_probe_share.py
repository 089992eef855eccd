"""argmax_probe_share: the share (%) of the acquisition argmax's lane
evaluations that were backtracking probes rather than concluded steps:
(`lbfgs.lane_evals` - `lbfgs.steps`) / `lbfgs.lane_evals` under
`arg_max_acquisition`, summed over the window's untraced iterations."""
from bench_port import program


def read(ctx):
    rows = program.records(ctx)
    evals = program.total(rows, "arg_max_acquisition/lbfgs.lane_evals") if rows else 0
    if not evals:
        return None
    return 100.0 * (evals - program.total(rows, "arg_max_acquisition/lbfgs.steps")) / evals

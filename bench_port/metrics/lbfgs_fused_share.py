"""lbfgs_fused_share: the share (%) of the L-BFGS trips whose update ran as
the port's one-launch kernel: 100 x the `<phase>/lbfgs.fused_updates`
counters over the `<phase>/lbfgs.trips` counters, every phase (the fit's
and the argmax's), summed over the window's untraced iterations. A port
without the kernel (`hopper_kernels.lbfgs_update_fused`) reads nothing."""
from bench_port import program


def read(ctx):
    from bayesian_optimization_tpu_torch.ops import hopper_kernels

    rows = program.records(ctx)
    if not rows or not hasattr(hopper_kernels, "lbfgs_update_fused"):
        return None
    trips = program.total_suffix(rows, "/lbfgs.trips")
    if not trips:
        return None
    return 100.0 * program.total_suffix(rows, "/lbfgs.fused_updates") / trips

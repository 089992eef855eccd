"""host_syncs_per_iter: the port's blocking copies between host and device
an iteration (every `<phase>/host_syncs` counter), a mean over the
window's untraced iterations."""
from bench_port import program


def read(ctx):
    rows = program.records(ctx)
    return program.total_suffix(rows, "/host_syncs") / len(rows) if rows else None

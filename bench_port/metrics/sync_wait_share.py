"""sync_wait_share: the share (%) of the iterations' wall the host spent
in the port's blocking copies between host and device (every
`<phase>/host_sync` span: it waits there for the device's queue), with no
profiler running; summed over the window's untraced iterations."""
from bench_port import program


def read(ctx):
    rows = program.records(ctx)
    wall = sum(r["wall"] for r in rows) if rows else 0.0
    return 100.0 * program.total_suffix(rows, "/host_sync:s") / wall if wall else None

"""fit_rows_share: the rows a surrogate fit lays its data out at, as a share
(%) of the size bucket's rows: 100 x the port's counters `fit/gp.rows` over
`fit/gp.bucket_rows` (models/gp.py::GaussianProcess.fit, one of each a
fit), summed over the window's untraced iterations. A port without the
counters reads nothing."""
from bench_port import program


def read(ctx):
    rows = program.records(ctx)
    if not rows:
        return None
    bucket = program.total(rows, "fit/gp.bucket_rows")
    return 100.0 * program.total(rows, "fit/gp.rows") / bucket if bucket else None

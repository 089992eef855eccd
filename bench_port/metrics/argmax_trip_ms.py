"""argmax_trip_ms: host milliseconds an L-BFGS trip of the acquisition
argmax: the seconds of the trip's spans under `arg_max_acquisition`
(`lbfgs.forward`, `lbfgs.backward`, `lbfgs.update`, `host_sync`) over its
trips, summed over the window's untraced iterations (a trip-weighted
mean)."""
from bench_port import program


def read(ctx):
    rows = program.records(ctx)
    trips = program.total(rows, "arg_max_acquisition/lbfgs.trips") if rows else 0
    return 1e3 * program.trip_seconds(rows, "arg_max_acquisition") / trips if trips else None

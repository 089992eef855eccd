"""The port's own spans and counters, an iteration's worth: the difference
of the optimizer's `_timer.snapshot()` (bayesian_optimization_tpu_torch/
utils/logging.py) across the iteration's tell and ask, kept in its record
under "program". Keys: "<phase>/<name>:s" a span's seconds, ":n" its calls,
"<phase>/<name>" a counter.

The readers of these numbers import this module, which wraps
`traffic.Loop._iterate` once: only a run that reports them (`--trace 1`)
takes the snapshots, outside each iteration's wall. A port whose timer has
no `snapshot` gets no "program" key, and the readers read nothing."""
from bench_port import traffic

TRIP = ("lbfgs.forward", "lbfgs.backward", "lbfgs.update", "host_sync")


def _with_program(inner):
    def _iterate(self, c):
        snap = getattr(c.opt._timer, "snapshot", None)
        if snap is None:
            return inner(self, c)
        before = snap()
        rec = inner(self, c)
        rec["program"] = {k: v - before.get(k, 0) for k, v in snap().items()
                          if v != before.get(k, 0)}
        return rec

    _iterate.takes_program = True
    return _iterate


if not getattr(traffic.Loop._iterate, "takes_program", False):
    traffic.Loop._iterate = _with_program(traffic.Loop._iterate)


def records(ctx):
    """The window's untraced records, or None where one has no "program"."""
    rows = ctx.steady
    if not rows or any("program" not in r for r in rows):
        return None
    return rows


def total(rows, key: str) -> float:
    """A key's sum over the records (0 where a record lacks it)."""
    return sum(r["program"].get(key, 0) for r in rows)


def total_suffix(rows, suffix: str) -> float:
    """The sum, over the records, of every key that ends in `suffix`."""
    return sum(v for r in rows for k, v in r["program"].items() if k.endswith(suffix))


def trip_seconds(rows, phase: str) -> float:
    """The seconds of the L-BFGS trip's four spans under `phase`."""
    return sum(total(rows, f"{phase}/{name}:s") for name in TRIP)

"""hybrid_share: the share (%) of the device's busy time that the hybrid
factorisation holds: the device time of the kernels launched inside the
`linalg.hybrid` ranges (the port's span around the blocked factorisation
above 1024 rows, ops/linalg.py::_whiten_parts: the likelihood's and the
posterior's), over the union of the device's activity in the traced
iterations. A port without the span, or a cell whose factorisations all fit
one `whiten_fused` call, reads nothing: no value."""
RANGE = "linalg.hybrid"


def read(ctx):
    t = ctx.trace
    calls = (t or {}).get("ops", {}).get(RANGE) or []
    dev = sum(dev_s for _, dev_s in calls)
    return 100.0 * dev / t["busy_s"] if dev > 0 and t["busy_s"] > 0 else None

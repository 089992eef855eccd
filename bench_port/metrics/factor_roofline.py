"""factor_roofline: the factorisation's share of its roofline (%): the least
time of every call (work.factor_bound_s at the recorded shapes R (Bt, n, n),
B (Bt, n, mb)) summed, over the device time of the kernels launched inside
the `_Whiten` forward ranges (the likelihood's factorisations; the
posterior's, in chol_inv_whiten, have no range yet) of the traced
iterations. Nothing to read: no value."""
from bench_port import work

RANGE = "_Whiten"


def read(ctx):
    calls = (ctx.trace or {}).get("ops", {}).get(RANGE) or []
    bound = dev = 0.0
    for shapes, dev_s in calls:
        if len(shapes) < 2 or len(shapes[0]) != 3 or len(shapes[1]) != 3:
            return None
        (Bt, n, _), (_, _, mb) = shapes[0], shapes[1]
        bound += work.factor_bound_s(Bt, n, mb)
        dev += dev_s
    return 100.0 * bound / dev if dev > 0 else None

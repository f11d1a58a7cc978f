"""K1's and K2's least time over their device time in the traced chunks,
as a share: each launch's least time from the bytes and operations its
view needs (``counts.k1_bytes_ops``, ``k2_bytes_ops``: the traced steps'
views, binned on the model as the window left it), K1 launched as often a
step as the trace shows (twice under remat)."""
from perfbench.counts import least_s

K1, K2 = "K1 blend forward", "K2 blend backward"


def read(ctx):
    t, work = ctx.get("trace"), ctx.get("work")
    if not t or not work or K1 not in t["groups"] or K2 not in t["groups"]:
        return None
    steps = len(ctx["traced_records"])
    k1_a_step = t["groups"][K1]["launches"] / steps
    k2_a_step = t["groups"][K2]["launches"] / steps
    peaks = ctx["peaks"]
    least = sum(k1_a_step * least_s(*a, peaks) + k2_a_step
                * least_s(*b, peaks) for a, b in zip(work["k1"], work["k2"]))
    spent = t["groups"][K1]["seconds"] + t["groups"][K2]["seconds"]
    return 100.0 * least / spent if spent > 0 else None

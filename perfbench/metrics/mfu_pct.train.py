"""The traced steps' model FLOPs over their time at the card's float32
peak (TF32 is off in the port): the decode heads' matrix products for the
visible anchors only (each step's ``n_visible_anchors``), the phase-2
context MLP on them too, each forward counted once and its backward as
twice it (no recompute from remat), and the blend's operations as K1's
and K2's counts (``counts.head_flops``, ``k1_bytes_ops``,
``k2_bytes_ops``). The compaction bucket's padding rows and the dense
decode's invisible rows count as waste, not as work."""
from perfbench.counts import head_flops


def read(ctx):
    t, work = ctx.get("trace"), ctx.get("work")
    if not t or not work or t["busy_s"] <= 0:
        return None
    heads, context = head_flops(ctx["config"]["gsconfig"],
                                ctx["traffic"]["phase"])
    flops = sum(3 * (heads + context) * r["n_visible_anchors"]
                + a[1] + b[1] for r, a, b in zip(ctx["traced_records"],
                                                 work["k1"], work["k2"]))
    return 100.0 * flops / t["window_s"] / ctx["peaks"]["f32_flops_per_s"]

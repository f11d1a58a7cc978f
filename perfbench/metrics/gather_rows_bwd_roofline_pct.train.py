"""``gather_rows_bwd``'s least time over its device time in the traced
chunks, as a share: a compacted step's backward of the row gather (the
trained anchor leaves' cotangents, 99 floats a row, summed into the
capacity's rows) and, with the statistics, their sorted scatter (22
floats a row onto the [capacity, 22] tables) (``counts.gather_step_bytes``)."""
from perfbench.counts import gather_step_bytes, least_s

GROUP = "gather_rows_bwd"


def read(ctx):
    t, work = ctx.get("trace"), ctx.get("work")
    if not t or not work or not work["compacted"] or GROUP not in t["groups"]:
        return None
    gs = ctx["config"]["gsconfig"]
    F, K = gs["feat_dim"], gs["n_offsets"]
    rows, cap = work["rows"], work["capacity"]
    step = gather_step_bytes(rows, cap, 3 + 3 * K + K + F + 6, False)
    if ctx["traffic"]["track_stats"]:
        step += gather_step_bytes(rows, cap, 2 + 2 * K, True)
    least = len(ctx["traced_records"]) * least_s(step, 0, ctx["peaks"])
    spent = t["groups"][GROUP]["seconds"]
    return 100.0 * least / spent if spent > 0 else None

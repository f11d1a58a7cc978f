"""The hash-grid encoder's least time over its device time in the traced
chunks, as a share: the kernel groups ``hashgrid_encode forward``,
``hashgrid_encode backward`` and ``hashgrid_bwd`` (``kernels.json``), the
least time of each forward and backward call counted on the decoded rows
by ``counts_hashgrid.encode_bytes`` (remat's second forward is a launch of
its own)."""
from perfbench.counts import least_s
from perfbench.counts_hashgrid import encode_bytes

FORWARD, BACKWARD = "hashgrid_encode forward", "hashgrid_encode backward"
GROUPS = (FORWARD, BACKWARD, "hashgrid_bwd")


def read(ctx):
    t, work = ctx.get("trace"), ctx.get("work")
    if not t or not work or not all(g in t["groups"] for g in GROUPS):
        return None
    fwd, bwd = encode_bytes(work["rows"], ctx["config"]["gsconfig"])
    least = least_s(t["groups"][FORWARD]["launches"] * fwd
                    + t["groups"][BACKWARD]["launches"] * bwd, 0,
                    ctx["peaks"])
    spent = sum(t["groups"][g]["seconds"] for g in GROUPS)
    return 100.0 * least / spent if spent > 0 else None

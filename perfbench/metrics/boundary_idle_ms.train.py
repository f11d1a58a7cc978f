"""The device ms between two chunks: from a chunk's last stamp to the
next one's first (the chunk boundary's host work), a chunk's
``boundary_idle_ms``."""
from perfbench.stamps import per_chunk


def read(ctx):
    return per_chunk(ctx, lambda c: c.get("boundary_idle_ms"))

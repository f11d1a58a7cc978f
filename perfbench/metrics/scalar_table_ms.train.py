"""The host ms a chunk of Adam's scalar table for the chunk's steps
(``Adam.scalar_table``): the program's ``loop.scalars`` span."""
from perfbench.stamps import per_chunk


def read(ctx):
    return per_chunk(ctx, lambda c: c.get("host_ms", {}).get("loop.scalars"))

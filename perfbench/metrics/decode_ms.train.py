"""The device ms a step of the neural decode on the compacted bucket,
first pass: the program's ``render.decode`` span with the spans inside it
(device stamps)."""
from perfbench.stamps import per_step, subtree_ms


def read(ctx):
    return per_step(ctx, lambda s: subtree_ms(s, "render.decode", False))

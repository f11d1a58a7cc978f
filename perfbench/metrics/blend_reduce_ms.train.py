"""The device ms a step of the blend backward's emission-order reduction
(its gather and cumsums): the program's ``tile_blend.reduce`` span
(device stamps)."""
from perfbench.stamps import per_step, subtree_ms


def read(ctx):
    return per_step(ctx, lambda s: subtree_ms(s, "tile_blend.reduce", None))

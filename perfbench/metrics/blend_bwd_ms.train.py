"""The device ms a step of the blend's backward but its reduction: the
program's ``tile_blend.backward`` span (the cotangent planes and K2) less
``tile_blend.reduce`` (device stamps)."""
from perfbench.stamps import per_step, subtree_ms


def read(ctx):
    return per_step(ctx, lambda s: subtree_ms(s, "tile_blend.backward", None)
                    - subtree_ms(s, "tile_blend.reduce", None))

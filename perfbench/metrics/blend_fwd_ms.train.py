"""The device ms a step of the blend's forward (K1 and the image
assembly), first pass: the program's ``tile_blend.forward`` span (device
stamps)."""
from perfbench.stamps import per_step, subtree_ms


def read(ctx):
    return per_step(ctx, lambda s: subtree_ms(s, "tile_blend.forward",
                                              False))

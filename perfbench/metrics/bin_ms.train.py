"""The device ms a step of the projection and the binning (K3, the tile
sort, K4), first pass: the program's ``render.bin`` spans (device
stamps)."""
from perfbench.stamps import per_step, subtree_ms


def read(ctx):
    return per_step(ctx, lambda s: subtree_ms(s, "render.bin", False))

"""The device ms a step of remat's recompute: the compaction, decode,
projection, binning and blend forward spans that run again inside
``train.backward`` (device stamps); 0 without remat."""
from perfbench.stamps import per_step, subtree_ms

NAMES = ("render.compact", "render.decode", "render.bin",
         "tile_blend.forward")


def read(ctx):
    return per_step(ctx, lambda s: sum(subtree_ms(s, n, True)
                                       for n in NAMES))

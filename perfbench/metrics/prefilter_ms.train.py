"""The device ms a step of the anchor prefilter and the compaction of the
visible anchors into the decode's bucket, first pass: the program's
``train.prefilter`` and ``render.compact`` spans (device stamps)."""
from perfbench.stamps import per_step, subtree_ms


def read(ctx):
    return per_step(ctx, lambda s: subtree_ms(s, "train.prefilter", False)
                    + subtree_ms(s, "render.compact", False))

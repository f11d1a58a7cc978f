"""The device ms a step of the loss stack's forward: the program's
``train.losses`` span (device stamps)."""
from perfbench.stamps import per_step, subtree_ms


def read(ctx):
    return per_step(ctx, lambda s: subtree_ms(s, "train.losses", None))

"""The device ms a step of the non-finite check and Adam's update: the
program's ``train.update`` span (device stamps)."""
from perfbench.stamps import per_step, subtree_ms


def read(ctx):
    return per_step(ctx, lambda s: subtree_ms(s, "train.update", None))

"""The device ms a step of the densify statistics' accumulation: the
program's ``train.stats`` span (device stamps); 0 in a traffic without
the statistics."""
from perfbench.stamps import per_step, subtree_ms


def read(ctx):
    return per_step(ctx, lambda s: subtree_ms(s, "train.stats", None))

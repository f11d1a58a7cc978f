"""The device ms a step of the compacted decode's row-gather backward
(``gather_rows_bwd``): the program's ``gather_rows.backward`` span
(device stamps)."""
from perfbench.stamps import per_step, subtree_ms


def read(ctx):
    return per_step(ctx, lambda s: subtree_ms(s, "gather_rows.backward",
                                              None))

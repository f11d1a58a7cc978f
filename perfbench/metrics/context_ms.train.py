"""The device ms a step of HAC's context model, first pass: the program's
``decode.context`` (the hash-grid encode and the grid MLP) and
``decode.rate`` (the Gaussian entropy rate on the subsample) spans with
the spans inside them (device stamps); 0 in a step that runs neither."""
from perfbench.stamps import per_step, subtree_ms


def read(ctx):
    return per_step(ctx, lambda s: subtree_ms(s, "decode.context", False)
                    + subtree_ms(s, "decode.rate", False))

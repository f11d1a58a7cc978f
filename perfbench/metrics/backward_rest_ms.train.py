"""The device ms a step of the backward outside every span inside it:
``train.backward``'s self time (the autograd nodes of the decode, the
losses and the projection; device stamps)."""
from perfbench.stamps import SEP, per_step

PATH = SEP.join(("train.step", "train.backward"))


def read(ctx):
    return per_step(ctx, lambda s: s.get(PATH, 0.0))

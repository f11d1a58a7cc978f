"""The device ms a step of the hash-grid encoder's backward: the program's
``hashgrid.backward`` span (``ops/hashgrid.py::_MixEncode.backward``: the
backward kernel, then ``hashgrid_bwd`` on each table's corner rows;
device stamps). None where no window chunk holds the span (a program
without it)."""
from perfbench.stamps import SEP, per_step, stamped_chunks, subtree_ms

NAME = "hashgrid.backward"


def read(ctx):
    if not any(NAME in path.split(SEP) for c in stamped_chunks(ctx)
               for path in c["span_ms"]):
        return None
    return per_step(ctx, lambda s: subtree_ms(s, NAME, None))

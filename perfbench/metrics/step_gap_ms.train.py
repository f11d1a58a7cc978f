"""The device ms between two replayed steps: from a step's last stamp to
the next one's first (the step counter's advance and the next replay's
start), a chunk's ``step_gap_ms`` over its gaps."""
from perfbench.stamps import median, stamped_chunks


def read(ctx):
    return median([c["step_gap_ms"] / (c["stamped_steps"] - 1)
                   for c in stamped_chunks(ctx) if c["stamped_steps"] > 1])

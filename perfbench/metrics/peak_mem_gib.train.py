"""The peak of the card's allocated memory over the run's chunks of the
device loop (``Trainer.chunk_log``: the peak statistic is reset as each
chunk starts; the chunks before the window hold the eager steps and the
captures, the window's the replays), in GiB."""


def read(ctx):
    peaks = [c["peak_mem_bytes"] for c in ctx["all_chunks"]
             if c["peak_mem_bytes"] is not None]
    return max(peaks) / 2 ** 30 if peaks else None

"""The device ms of a replayed training step: the CUDA-event ms of the
window's graph replays (``Trainer.graph_log``) over their count."""


def read(ctx):
    replays = sum(g["replays"] for g in ctx["graphs"])
    if not replays:
        return None
    return sum(g["replay_ms"] for g in ctx["graphs"]) / replays

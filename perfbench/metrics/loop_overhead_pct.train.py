"""The share of the window's wall time that no graph replay covers: the
eager step and the capture that open the window's call, each chunk's
enqueue and its read of the records (``Trainer.graph_log`` against the
window's host seconds)."""


def read(ctx):
    if not ctx["graphs"]:
        return None
    replay_s = sum(g["replay_ms"] for g in ctx["graphs"]) / 1e3
    return 100.0 * (ctx["window_s"] - replay_s) / ctx["window_s"]

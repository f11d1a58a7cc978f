"""The kernel nodes of the window's replayed step graph, its stamp nodes
left out (``StepGraph.record["nodes"]``, counted at the capture); the
graph replayed most where several were."""


def read(ctx):
    graphs = [g for g in ctx.get("graphs", ()) if g.get("nodes")]
    if not graphs:
        return None
    nodes = max(graphs, key=lambda g: g["replays"])["nodes"]
    return nodes["by_type"].get("kernel", 0) - nodes["stamps"]

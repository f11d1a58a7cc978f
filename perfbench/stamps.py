"""What the per-layer readers of the program's own tracing share: each
window chunk's device stamps and host spans (``Trainer.chunk_log``:
``span_ms`` by span path, ``stamped_steps``, ``step_gap_ms``,
``boundary_idle_ms``, ``host_ms``) reduced to one value a step or a
chunk, and the median over the window's chunks. A chunk record without
those fields (a program that does not stamp its steps) gives nothing, and
the readers then return None."""
from __future__ import annotations

import statistics

SEP = "/"                     # joins a span path, the outermost first
BACKWARD = "train.backward"   # a span inside it is remat's recompute


def median(values: list):
    values = [v for v in values if v is not None]
    return statistics.median(values) if values else None


def stamped_chunks(ctx: dict) -> list:
    return [c for c in ctx.get("chunks", ())
            if c.get("span_ms") and c.get("stamped_steps")]


def subtree_ms(span_ms: dict, name: str, recompute: bool | None) -> float:
    """The device ms of the spans named ``name`` and of every span inside
    them: first-pass ones only (``recompute`` False: not inside
    ``train.backward``), the recompute's only (True), or both (None)."""
    total = 0.0
    for path, ms in span_ms.items():
        parts = path.split(SEP)
        if name not in parts:
            continue
        inside = BACKWARD in parts[:parts.index(name)]
        if recompute is None or inside == recompute:
            total += ms
    return total


def per_step(ctx: dict, fn) -> float | None:
    """The median over the window's stamped chunks of ``fn(span_ms)``
    over the chunk's stamped steps."""
    return median([fn(c["span_ms"]) / c["stamped_steps"]
                   for c in stamped_chunks(ctx)])


def per_chunk(ctx: dict, fn) -> float | None:
    """The median over the window's chunks of ``fn(chunk)`` (None where a
    chunk holds nothing to read)."""
    return median([fn(c) for c in ctx.get("chunks", ())])

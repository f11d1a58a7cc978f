"""Per-layer metrics: each is read by ``metrics/<name>.py``, whose
``read(ctx)`` returns the metric's value or None where the run holds
nothing to read (the metric is then left out of the result line).

``ctx`` holds what a traced run gathered: ``window_s`` (the window's host
seconds), ``records`` (each window step's ``StepMetrics`` record),
``chunks`` and ``graphs`` (the window's ``Trainer.chunk_log`` and
``graph_log`` entries), ``trace`` (``tracing.reduce_events`` of the
recorded chunks, with ``first_step``), ``traced_records`` (the records of
those steps), ``work`` (``counts.window_work``), ``config``, ``traffic``
and ``peaks`` (``peaks.json``).
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

METRICS_DIR = Path(__file__).resolve().parent / "metrics"


def reader(name: str):
    path = METRICS_DIR / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_all(metric_specs: list, ctx: dict) -> dict:
    out = {}
    for m in metric_specs:
        value = reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out

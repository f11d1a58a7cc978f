"""Profiling: wall-clock spans and ``torch.profiler`` traces.

The port of ``bloomscene_tpu/utils/profiling.py``: ``Spans`` accumulates
named wall-clock spans, each fenced by ``torch.cuda.synchronize`` on a
CUDA device (the counterpart of ``jax.block_until_ready``), and ``trace``
records a ``torch.profiler`` run of the host and the card into a Chrome
trace.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


class Spans:
    """Accumulating named wall-clock spans."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str, sync=None):
        """Time the block; ``sync`` (a device, or a tensor whose device is
        meant) is synchronized before the clock stops when it is CUDA."""
        t0 = time.perf_counter()
        yield
        if sync is not None:
            dev = sync.device if isinstance(sync, torch.Tensor) \
                else torch.device(sync)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        self.totals[name] += dt
        self.counts[name] += 1

    def summary(self) -> dict:
        return {name: {'total_s': self.totals[name],
                       'count': self.counts[name],
                       'mean_ms': 1000 * self.totals[name]
                       / max(self.counts[name], 1)}
                for name in self.totals}


@contextlib.contextmanager
def trace(log_dir: str):
    """A ``torch.profiler`` run of the block (host, and the card when CUDA
    is available) -> ``log_dir/trace.json``, a Chrome trace. Yields the
    profiler, whose ``key_averages()`` sum the time by operation."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))

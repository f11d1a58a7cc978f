"""The device trace of a window's last chunks, and its reduction: device
time by kernel and by group, the busy and idle time of the card, and the
breakdown the result line carries.

``ChunkTracer`` runs ``torch.profiler`` on a schedule that a
``Trainer.run`` callback advances once a chunk (after the chunk's last
record, so a profiler step holds one chunk: its enqueue, its replays and
its one read of the records). Only the last ``active`` chunks are
recorded; the earlier ones run with the profiler waiting. It records the
device's activity alone (kernels, copies and the CUDA runtime's calls):
recording every host operation as well would slow the chunk boundary's
host work several times over, and the idle share with it.
"""
from __future__ import annotations

import re
import time

TOP = 10                      # entries of each breakdown list
SPAN_PREFIXES = ("train.", "decode.", "tile_blend.")   # the port's spans


class ChunkTracer:
    def __init__(self, trainer, n_chunks: int, active: int):
        from torch.profiler import ProfilerActivity, profile, schedule
        self.trainer = trainer
        self.n_chunks, self.active = n_chunks, active
        self.events = None
        self.first_step = None
        self.done = 0
        self.step_s = 0.0        # host seconds inside the profiler's steps
        self.prof = profile(
            activities=[ProfilerActivity.CUDA],
            schedule=schedule(wait=n_chunks - active - 1, warmup=1,
                              active=active, repeat=1),
            on_trace_ready=self._ready)
        self.prof.start()

    def _ready(self, prof) -> None:
        self.events = prof.events()

    def callback(self, rec: dict) -> None:
        last = self.trainer.chunk_log[-1]
        if rec["iteration"] != last["last"]:
            return
        self.done += 1
        if self.done == self.n_chunks - self.active:
            self.first_step = last["last"] + 1
        t0 = time.perf_counter()
        self.prof.step()
        if self.done == self.n_chunks:
            self.prof.stop()
        self.step_s += time.perf_counter() - t0

    def summary(self, kernel_map: dict) -> dict:
        """-> ``window_s`` (the recorded chunks' profiler steps), ``busy_s``
        (the union of the device's operations inside them), ``groups``
        (device seconds and launches of each group of ``kernel_map``,
        and of ``other``), ``first_step`` and ``breakdown``."""
        if self.events is None:
            raise RuntimeError("the profiler recorded no chunk")
        return reduce_events(self.events, kernel_map) | {
            "first_step": self.first_step}


def classify(name: str, patterns: dict, seen: dict) -> str:
    group = seen.get(name)
    if group is None:
        group = next((g for g, names in patterns.items()
                      if any(p.search(name) for p in names)), "other")
        seen[name] = group
    return group


def union_length(intervals: list) -> tuple[float, list]:
    """Total length of the union of (start, end) intervals, and the gaps
    between the merged runs, in order."""
    total, gaps = 0.0, []
    cur = None
    for s, e in sorted(intervals):
        if cur is None:
            cur = [s, e]
        elif s > cur[1]:
            total += cur[1] - cur[0]
            gaps.append((cur[1], s))
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        total += cur[1] - cur[0]
    return total, gaps


def reduce_events(events, kernel_map: dict) -> dict:
    """The reduction of a profiler's events (times in microseconds)."""
    from torch.autograd import DeviceType
    patterns = {g: [re.compile(rf"\b{re.escape(k)}\b") for k in names]
                for g, names in kernel_map["groups"].items()}
    steps = [e for e in events if e.device_type == DeviceType.CPU
             and e.name.startswith("ProfilerStep")]
    if steps:
        lo = min(e.time_range.start for e in steps)
        hi = max(e.time_range.end for e in steps)
        window_us = sum(e.time_range.end - e.time_range.start for e in steps)
    else:
        # without host operations the trace holds no profiler step: the
        # window runs from the recorded chunks' first event to their last
        if not events:
            raise RuntimeError("the trace holds no event")
        lo = min(e.time_range.start for e in events)
        hi = max(e.time_range.end for e in events)
        window_us = hi - lo
    dev = [e for e in events if e.device_type == DeviceType.CUDA
           and not is_annotation(e)
           and e.time_range.end > lo and e.time_range.start < hi]
    clipped = [(max(e.time_range.start, lo), min(e.time_range.end, hi))
               for e in dev]
    busy_us, gaps = union_length(clipped)
    groups, by_name, seen = {}, {}, {}
    for e in dev:
        us = e.time_range.end - e.time_range.start
        g = classify(e.name, patterns, seen)
        d = groups.setdefault(g, {"seconds": 0.0, "launches": 0})
        d["seconds"] += us / 1e6
        d["launches"] += 1
        key = (g, e.name)
        by_name[key] = by_name.get(key, 0.0) + us / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    device_ops = [[f"{g}: {n[:96]}", s] for (g, n), s in top]
    host = sorted(((e.time_range.start, e.time_range.end, e.name)
                   for e in events if e.device_type == DeviceType.CPU
                   and not e.name.startswith("ProfilerStep")),
                  key=lambda x: x[0])
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    idle = [[host_activity(host, (a + b) / 2), (b - a) / 1e6]
            for a, b in longest]
    return {"window_s": window_us / 1e6, "busy_s": busy_us / 1e6,
            "groups": groups,
            "breakdown": {"device_ops": device_ops, "idle_gaps": idle}}


def is_annotation(e) -> bool:
    """A span's device-side copy (a profiler step, a ``record_function``):
    it covers the kernels inside it, idle gaps included, and is no
    operation of the device's own."""
    return (getattr(e, "is_user_annotation", False)
            or e.name.startswith("ProfilerStep")
            or e.name.startswith(SPAN_PREFIXES))


def host_activity(host: list, t: float) -> str:
    """The innermost host operation that spans time ``t``, or "host"."""
    best = None
    for s, e, name in host:
        if s > t:
            break
        if e >= t and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return f"host: {best[2]}" if best else "host"

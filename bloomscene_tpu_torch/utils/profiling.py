"""Tracing of the port: host spans, device stamps inside the captured
training step, and the operator's Chrome trace.

The port of ``bloomscene_tpu/utils/profiling.py``, grown into the port's
one tracing module:

- ``Spans``: named host spans on CLOCK_MONOTONIC (``time.perf_counter_ns``
  on Linux), each kept in memory with its start, its end and its parent
  (the span open on its thread when it began), and totals by name
  (``summary``). ``sync=`` fences a span on the card (the counterpart of
  ``jax.block_until_ready``). Each span is a ``record_function`` too.
- ``span(name)``: the program's span around a layer. It opens a
  ``record_function`` of that name (``profile_render_torch.py`` and
  ``chip_smoke.py`` read them in a profiler run) and, inside a step of
  the device loop (``StepStamps.step``), writes a device stamp at entry
  and at exit (``ops/cuda/stamp.py``). A stamp is a node of the captured
  step's CUDA graph, so every replay times every span on the device.
- ``step_times``: a chunk's stamp rows -> each span's device self time
  and the gaps between steps; ``graph_kernels``: a captured graph's nodes
  by type and its kernels by span; ``idle_stamps``: the stamps that follow
  another with no work between, which the device loop takes out of its
  graph (``fill_dropped`` restores their columns).
- ``trace``: a ``torch.profiler`` run exported as a Chrome trace with the
  program's host spans on a track of their own.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import defaultdict
from dataclasses import dataclass

import numpy as np
import torch
from torch.profiler import record_function

ENTER, EXIT = 1, -1
SEP = "/"                      # joins a span's path from the outermost


@dataclass
class Span:
    name: str
    start_ns: int
    end_ns: int | None         # None while open
    parent: int | None         # index in ``Spans.records``


class Spans:
    """Named wall-clock spans, kept in memory (``records``, in start
    order) and totalled by name."""

    def __init__(self):
        self.records: list[Span] = []
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    @contextlib.contextmanager
    def span(self, name: str, sync=None):
        """Time the block; ``sync`` (a device, or a tensor whose device is
        meant) is synchronized before the clock stops when it is CUDA."""
        stack = self._stack()
        rec = Span(name, time.perf_counter_ns(), None,
                   stack[-1] if stack else None)
        stack.append(len(self.records))
        self.records.append(rec)
        try:
            with record_function(name):
                yield
                if sync is not None:
                    dev = sync.device if isinstance(sync, torch.Tensor) \
                        else torch.device(sync)
                    if dev.type == "cuda":
                        torch.cuda.synchronize(dev)
        finally:
            rec.end_ns = time.perf_counter_ns()
            stack.pop()
            self.totals[name] += (rec.end_ns - rec.start_ns) / 1e9
            self.counts[name] += 1

    def summary(self) -> dict:
        return {name: {'total_s': self.totals[name],
                       'count': self.counts[name],
                       'mean_ms': 1000 * self.totals[name]
                       / max(self.counts[name], 1)}
                for name in self.totals}

    def self_ms(self, first: int = 0) -> dict:
        """Each name's self time in ms (its spans' time less what their
        children cover) over the closed spans from ``records[first]``
        on."""
        recs = self.records[first:]
        out = defaultdict(float)
        for r in recs:
            if r.end_ns is not None:
                out[r.name] += (r.end_ns - r.start_ns) / 1e6
        for r in recs:
            if (r.end_ns is not None and r.parent is not None
                    and r.parent >= first):
                p = self.records[r.parent]
                out[p.name] -= (r.end_ns - r.start_ns) / 1e6
        return dict(out)


# --- device stamps inside the training step -------------------------------

# The step being stamped. A module-level slot and not a thread's: the
# backward's spans (TileBlend, SortedRowGather) run on autograd's device
# thread while the loop's thread waits in ``torch.autograd.grad``, so the
# calls stay in one order.
_active: StepStamps | None = None


@contextlib.contextmanager
def span(name: str):
    """The program's span ``name``: a ``record_function``, and inside
    ``StepStamps.step`` a device stamp at entry and at exit."""
    with record_function(name):
        stamps = _active
        if stamps is None:
            yield
            return
        stamps.stamp(name, ENTER)
        try:
            yield
        finally:
            stamps.stamp(name, EXIT)


class StepStamps:
    """The device stamps of the device loop's steps. ``stamps`` [rows,
    n_slots] int64 and ``counter`` [1] int64 are the loop's buffers: a
    step's stamps go to the row of its counter, read on the device, each
    at its slot, its place in the step's call order. The slots of the last
    step run under ``step`` are named in ``table``: one (path, ENTER or
    EXIT) a slot, the path the span's name after those of the spans open
    around it (``SEP`` between). A graph captured from such a step replays
    the same stamps, so its table is the capture's."""

    def __init__(self, stamps: torch.Tensor, counter: torch.Tensor):
        self.stamps, self.counter = stamps, counter
        self.table: tuple = ()
        self._calls: list = []
        self._open: list = []

    @contextlib.contextmanager
    def step(self, name: str = "train.step"):
        """Stamp the spans of the block, which is one step: inside the
        outermost span ``name``."""
        global _active
        if _active is not None:
            raise RuntimeError("a step is stamped already")
        self._calls, self._open = [], []
        _active = self
        try:
            with span(name):
                yield
        finally:
            _active = None
            self.table = tuple(self._calls)

    def stamp(self, name: str, kind: int) -> None:
        from ..ops.cuda.stamp import stamp
        slot = len(self._calls)
        if slot >= self.stamps.shape[1]:
            raise RuntimeError(f"more than {self.stamps.shape[1]} stamps a "
                               "step: raise the loop buffers' slots")
        if kind == ENTER:
            self._open.append(name)
        path = SEP.join(self._open)
        if kind == EXIT:
            self._open.pop()
        stamp(self.stamps, self.counter, slot)
        self._calls.append((path, kind))


def owners(table) -> list:
    """The path that owns each interval between consecutive stamps of a
    step: the innermost span open after the interval's first stamp ("" where
    none is)."""
    out = []
    for path, kind in table[:-1]:
        out.append(path if kind == ENTER else path.rpartition(SEP)[0])
    return out


def step_times(rows: np.ndarray, table) -> dict:
    """A chunk's stamped steps -> ``span_ms`` (each path's device self
    time in ms, summed over the steps), ``step_gap_ms`` (from each step's
    last stamp to the next one's first, summed), ``stamped_steps`` and the
    first and last stamps (``first_ns``, ``last_ns``; device clock).
    ``rows`` [steps, >= len(table)] int64, the steps in order."""
    n, S = rows.shape[0], len(table)
    out = {"span_ms": {}, "step_gap_ms": 0.0, "stamped_steps": n,
           "first_ns": None, "last_ns": None}
    if n == 0 or S == 0:
        return out
    t = rows[:, :S].astype(np.int64)
    d = (t[:, 1:] - t[:, :-1]).sum(0) / 1e6 if S > 1 else []
    span_ms = defaultdict(float)
    for path, ms in zip(owners(table), d):
        if path:
            span_ms[path] += float(ms)
    out["span_ms"] = dict(span_ms)
    out["step_gap_ms"] = float((t[1:, 0] - t[:-1, -1]).sum() / 1e6)
    out["first_ns"], out["last_ns"] = int(t[0, 0]), int(t[-1, -1])
    return out


def covered_ns(lo: int, hi: int, intervals) -> int:
    """How much of [lo, hi] the union of (start, end) intervals covers."""
    total, reach = 0, lo
    for s, e in sorted(intervals):
        s, e = max(s, reach), min(e, hi)
        if e > s:
            total += e - s
            reach = e
    return total


# node types that do no work on the device
IDLE_NODES = ("empty", "event_record", "wait_event")


def _last_stamps(census: dict) -> list:
    """Each node's last stamp slot among its ancestors (-1: none), in
    topological order (Kahn's: a node once all its predecessors are
    done)."""
    slots = census["slots"]
    succ, preds = defaultdict(list), [0] * len(slots)
    for a, b in census["edges"]:
        succ[a].append(b)
        preds[b] += 1
    last = [-1] * len(slots)
    order = [v for v, n in enumerate(preds) if n == 0]
    for v in order:
        mark = slots[v] if slots[v] >= 0 else last[v]
        for w in succ[v]:
            last[w] = max(last[w], mark)
            preds[w] -= 1
            if preds[w] == 0:
                order.append(w)
    return last


def idle_stamps(census: dict) -> set:
    """The slots s of a captured step's graph whose stamp follows the
    stamp of slot s - 1 with no work between: no node but a stamp or one of
    ``IDLE_NODES`` has s - 1 as the last stamp among its ancestors. Such a
    stamp reads what the one before it reads, and can leave the graph
    (``fill_dropped`` then gives its column the one before's)."""
    types, slots = census["types"], census["slots"]
    last = _last_stamps(census)
    busy = {last[v] for v, (kind, s) in enumerate(zip(types, slots))
            if s < 0 and kind not in IDLE_NODES}
    node = {s: v for v, s in enumerate(slots) if s >= 0}
    return {s for s, v in node.items()
            if s > 0 and last[v] == s - 1 and s - 1 not in busy}


def fill_dropped(rows: np.ndarray, kept) -> np.ndarray:
    """Stamp rows of a graph whose slots ``kept[s]`` False left it: each
    such column takes the column before it (the slots in order)."""
    rows = rows.copy()
    for s, k in enumerate(kept):
        if not k:
            rows[:, s] = rows[:, s - 1]
    return rows


def graph_kernels(census: dict, table, dropped=()) -> dict:
    """A captured step's graph (``ops.cuda.stamp.graph_census``), less the
    stamps of the slots ``dropped`` -> ``by_type`` (nodes of each type),
    ``stamps`` (stamp nodes), ``stamps_dropped`` and ``kernels_by_span``
    (the other kernel nodes by the path that owns the last stamp among
    their ancestors; "" before the first stamp)."""
    types, slots = census["types"], census["slots"]
    last = _last_stamps(census)
    own = owners(table) + [""]      # after the last stamp no span is open
    by_type: dict = defaultdict(int)
    by_span: dict = defaultdict(int)
    for v, kind in enumerate(types):
        if slots[v] in dropped:
            continue
        by_type[kind] += 1
        if kind == "kernel" and slots[v] < 0:
            s = last[v]
            by_span[own[s] if 0 <= s < len(own) else ""] += 1
    return {"by_type": dict(by_type),
            "stamps": sum(1 for s in slots if s >= 0 and s not in dropped),
            "stamps_dropped": len(dropped),
            "kernels_by_span": dict(by_span)}


# --- the operator's export -----------------------------------------------

def profiler_offset_ns(prof, spans: Spans | None, lo: int = 0) -> int:
    """The profiler's host clock less CLOCK_MONOTONIC, in ns: the median,
    over the program's spans from ``spans.records[lo]`` on that the
    profiler recorded too (their ``record_function``s), of the gap between
    the two starts; 0 where none matches."""
    if spans is None:
        return 0
    theirs = defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        theirs[e.name()].append(e.start_ns())
    ours = defaultdict(list)
    for r in spans.records[lo:]:
        ours[r.name].append(r.start_ns)
    gaps = []
    for name, starts in ours.items():
        got = sorted(theirs.get(name, ()))
        if len(got) == len(starts):
            gaps += [g - s for g, s in zip(got, starts)]
    return int(np.median(gaps)) if gaps else 0


@contextlib.contextmanager
def trace(log_dir: str, spans: Spans | None = None):
    """A ``torch.profiler`` run of the block (host, and the card when CUDA
    is available) -> ``log_dir/trace.json``, a Chrome trace: the
    profiler's rows (on the card the stamp kernels among the device's),
    and ``spans``' spans begun in the block on a track of their own,
    placed on the trace's clock by ``profiler_offset_ns``. Yields the
    profiler, whose ``key_averages()`` sum the time by operation."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    lo = len(spans.records) if spans is not None else 0
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    if spans is None:
        return
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    shift = profiler_offset_ns(prof, spans, lo) - base
    events = doc["traceEvents"]
    pid = 1 + max((e["pid"] for e in events
                   if isinstance(e.get("pid"), int)), default=0)
    events.append({"ph": "M", "name": "process_name", "pid": pid,
                   "tid": 0, "args": {"name": "program spans"}})
    for r in spans.records[lo:]:
        if r.end_ns is None:
            continue
        events.append({"ph": "X", "cat": "program_span", "name": r.name,
                       "pid": pid, "tid": 0,
                       "ts": (r.start_ns + shift) / 1e3,
                       "dur": (r.end_ns - r.start_ns) / 1e3})
    with open(path, "w") as f:
        json.dump(doc, f)

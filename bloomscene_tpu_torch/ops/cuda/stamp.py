"""Device stamps (CUDA ``csrc/stamp.cu``) and their plain version, the
census of a captured graph's nodes, and the removal of stamp nodes from
it.

Replaces no TPU kernel: a stamp writes the device's nanosecond clock into
``stamps[counter[0], slot]``, so a span's boundary inside a CUDA graph of
the training step is timed at every replay (``utils/profiling.py``). The
plain version writes the host's clock (``time.perf_counter_ns``).
"""
from __future__ import annotations

import ctypes
import time

import torch

from .build import check, library, require, stream_ptr

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# cudaGraphNodeType's values, by name
NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty",
              "wait_event", "event_record", "ext_semas_signal",
              "ext_semas_wait", "mem_alloc", "mem_free", "batch_mem_op",
              "conditional")


def _fn(name: str, argtypes: list):
    fn = getattr(library("stamp"), name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def stamp(stamps: torch.Tensor, counter: torch.Tensor, slot: int) -> None:
    """stamps [rows, n_slots] int64, counter [1] int64: ``stamps[counter[0],
    slot]`` = the device's clock in ns (a row outside [0, rows) is not
    written)."""
    rows, n_slots = stamps.shape
    if not 0 <= slot < n_slots:
        raise ValueError(f"slot {slot} outside [0, {n_slots})")
    if stamps.device.type == "cpu":
        stamp_plain(stamps, counter, slot)
        return
    dev = stamps.device
    require(stamps, torch.int64, (rows, n_slots), "stamps", dev)
    require(counter, torch.int64, (1,), "counter", dev)
    check(_fn("bs_stamp", [_P, _P, _I, _I, _I, _P])(
        stamps.data_ptr(), counter.data_ptr(), rows, n_slots, slot,
        stream_ptr(dev)), "stamp")
    stamp.launches += 1


stamp.launches = 0


def stamp_plain(stamps, counter, slot):
    row = int(counter[0])
    if 0 <= row < stamps.shape[0]:
        stamps[row, slot] = time.perf_counter_ns()


def graph_census(raw_graph: int) -> dict:
    """The nodes and edges of a captured graph (``CUDAGraph(keep_graph=
    True).raw_cuda_graph()``, before ``instantiate``): ``types`` (each
    node's name in ``NODE_TYPES``), ``slots`` (a stamp node's slot, -1 for
    any other node) and ``edges`` ((from, to) node indices)."""
    n_nodes, n_edges = _LL(), _LL()
    check(_fn("bs_graph_size", [_P, _P, _P])(
        raw_graph, ctypes.byref(n_nodes), ctypes.byref(n_edges)),
        "graph_size")
    nn, ne = n_nodes.value, n_edges.value
    types, slots = (_I * max(nn, 1))(), (_I * max(nn, 1))()
    src, dst = (_LL * max(ne, 1))(), (_LL * max(ne, 1))()
    check(_fn("bs_graph_census", [_P, _LL, _LL, _P, _P, _P, _P])(
        raw_graph, nn, ne, types, slots, src, dst), "graph_census")
    names = [NODE_TYPES[t] if 0 <= t < len(NODE_TYPES) else f"type_{t}"
             for t in types[:nn]]
    return {"types": names, "slots": list(slots[:nn]),
            "edges": list(zip(src[:ne], dst[:ne]))}


def drop_stamps(raw_graph: int, slots, n_slots: int) -> int:
    """Take the stamp nodes of ``slots`` out of a captured graph (before
    ``instantiate``), each predecessor of one joined to each of its
    successors -> how many were taken out. They were counted as launches
    at the capture and never launch: ``stamp.launches`` drops by as
    many."""
    drop = (_I * max(n_slots, 1))()
    for s in slots:
        drop[s] = 1
    dropped = _LL()
    check(_fn("bs_graph_drop_stamps", [_P, _P, _I, _P])(
        raw_graph, drop, n_slots, ctypes.byref(dropped)), "drop_stamps")
    stamp.launches -= dropped.value
    return dropped.value

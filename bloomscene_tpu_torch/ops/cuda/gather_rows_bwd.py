"""The compacted decode's row-gather backward (CUDA
``csrc/gather_rows_bwd.cu``) beside its plain version.

``gather_rows_bwd(grads, idx, n_rows)`` is ``out_j[idx[i]] += grads_j[i]``
into a zeroed [n_rows, k_j] table for each leaf j: the backward of
``x_j.reshape(n_rows, -1)[idx]`` (``models/anchors.py::SortedRowGather``)
for every trained leaf in one launch. It has no TPU counterpart (XLA's
scatter-add does it in the JAX package). ``idx`` must be nondecreasing,
as ``compact_visible``'s index is: on the card the outputs are zeroed,
a block adds each run of equal indices inside its chunk of ``CHUNK``
entries in entry order from 0, and a second pass adds the fragments of
the runs that cross chunks in chunk order, so the sums are the same bits
from one launch to the next (see the source). The plain version is ``index_add_``: sequential on the
CPU, atomic (in no fixed order) on the card.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from .build import check, library, require, stream_ptr

CHUNK = 256         # entries a block adds (gather_rows_bwd.cu)
GROUPS = 8          # shares of a crossing run's fragments, each from 0
MAX_LEAVES = 8

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
              ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
              ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
              ctypes.c_void_p, ctypes.c_void_p])
_WS_ARGTYPES = [ctypes.c_longlong, ctypes.c_int,
                ctypes.POINTER(ctypes.c_longlong)]


def _launch(grads: Sequence[torch.Tensor], idx: torch.Tensor,
            n_rows: int) -> tuple:
    dev = idx.device
    V = idx.shape[0]
    if not 1 <= len(grads) <= MAX_LEAVES or not 1 <= n_rows < 2 ** 31 \
            or not 1 <= V < 2 ** 31:
        raise ValueError(f"gather_rows_bwd: {len(grads)} leaves (1-"
                         f"{MAX_LEAVES}), n_rows {n_rows} and entries {V} "
                         f"(1 to 2^31 - 1)")
    require(idx, torch.int64, (V,), "idx", dev)
    for j, g in enumerate(grads):
        if g.dim() != 2:
            raise ValueError(f"grads[{j}]: shape {tuple(g.shape)}, expected "
                             f"[{V}, k]")
        require(g, torch.float32, (V, g.shape[1]), f"grads[{j}]", dev)
    outs = [torch.empty((n_rows, g.shape[1]), dtype=torch.float32,
                        device=dev) for g in grads]
    K = sum(g.shape[1] for g in grads)
    lib = library("gather_rows_bwd")
    ws = lib.bs_gather_rows_bwd_workspace
    ws.argtypes, ws.restype = _WS_ARGTYPES, ctypes.c_int
    n_float = ctypes.c_longlong()
    check(ws(V, K, ctypes.byref(n_float)), "gather_rows_bwd workspace")
    part = torch.empty((n_float.value,), dtype=torch.float32, device=dev)
    n = len(grads)
    g_ptrs = (ctypes.c_void_p * n)(*[g.data_ptr() for g in grads])
    o_ptrs = (ctypes.c_void_p * n)(*[o.data_ptr() for o in outs])
    ks = (ctypes.c_int * n)(*[g.shape[1] for g in grads])
    fn = lib.bs_gather_rows_bwd
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    check(fn(idx.data_ptr(), V, n_rows, n, g_ptrs, o_ptrs, ks,
             part.data_ptr(), stream_ptr(dev)), "gather_rows_bwd")
    gather_rows_bwd.launches += 1
    return tuple(outs)


def gather_rows_bwd(grads: Sequence[torch.Tensor], idx: torch.Tensor,
                    n_rows: int) -> tuple:
    """grads: one [V, k_j] float32 cotangent a leaf (at most MAX_LEAVES),
    idx [V] int64 nondecreasing in [0, n_rows) -> one [n_rows, k_j] table
    a leaf of the cotangents summed by row (rows no entry names are 0)."""
    if idx.device.type == "cpu":
        return gather_rows_bwd_plain(grads, idx, n_rows)
    return _launch(grads, idx, n_rows)


gather_rows_bwd.launches = 0


def gather_rows_bwd_plain(grads, idx, n_rows) -> tuple:
    return tuple(torch.zeros((n_rows, g.shape[1]), dtype=g.dtype,
                             device=g.device).index_add_(0, idx, g)
                 for g in grads)

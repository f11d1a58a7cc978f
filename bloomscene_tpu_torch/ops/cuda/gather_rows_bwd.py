"""A fixed-order segmented sum over a sorted index (CUDA
``csrc/gather_rows_bwd.cu``) beside its plain version: the compacted
decode's row-gather backward and the densify statistics' scatter.

``gather_rows_bwd(grads, idx, n_rows)`` is ``out_j[idx[i]] += grads_j[i]``
into a zeroed [n_rows, k_j] table for each leaf j: the backward of
``x_j.reshape(n_rows, -1)[idx]`` (``models/anchors.py::SortedRowGather``)
for every trained leaf in one call. With ``bases`` (one [n_rows, k_j]
table a leaf) it is ``index_add``: ``base_j`` plus the sums, into new
tables (``models/densify.py::accumulate_stats``, the four statistics in
one call). It has no TPU counterpart (XLA's scatter-add does it in the
JAX package). ``idx`` must be nondecreasing, as ``compact_visible``'s
index is. On the card the entries are cut into pieces of ``PIECE``: a run
of one row inside a piece is added in entry order onto its initial value,
a run that crosses pieces is added a piece at a time, the pieces' sums in
``SHARES`` contiguous shares, so the sums are the same bits from one
launch to the next; every output row is written once, with no memset,
the rows by a kernel on a side stream beside the one that reads the
runs that cross pieces (see the source).
The plain version is ``index_add_``: sequential on the CPU, atomic (in no
fixed order) on the card.
"""
from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from .build import check, library, require, stream_ptr

PIECE = 128         # entries a piece (gather_rows_bwd.cu)
SHARES = 32         # shares of a crossing run's pieces, each from 0
MAX_LEAVES = 8
MAX_COLUMNS = 256   # the leaves' widths summed (a thread a column)

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
              ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
              ctypes.POINTER(ctypes.c_void_p),
              ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
              ctypes.c_void_p, ctypes.c_void_p])
_WS_ARGTYPES = [ctypes.c_longlong, ctypes.c_int,
                ctypes.POINTER(ctypes.c_longlong)]


def _launch(grads: Sequence[torch.Tensor], idx: torch.Tensor,
            n_rows: int, bases) -> tuple:
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
    if sum(g.shape[1] for g in grads) > MAX_COLUMNS:
        raise ValueError(f"gather_rows_bwd: {sum(g.shape[1] for g in grads)}"
                         f" columns (at most {MAX_COLUMNS})")
    # the kernel reads the values and the bases in 16-byte pieces
    grads = [g if g.data_ptr() % 16 == 0 else g.clone() for g in grads]
    if bases is not None:
        if len(bases) != len(grads):
            raise ValueError(f"gather_rows_bwd: {len(bases)} bases for "
                             f"{len(grads)} leaves")
        for j, (b, g) in enumerate(zip(bases, grads)):
            require(b, torch.float32, (n_rows, g.shape[1]), f"bases[{j}]",
                    dev)
        bases = [b if b.data_ptr() % 16 == 0 else b.clone() for b in bases]
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
    b_ptrs = (None if bases is None else
              (ctypes.c_void_p * n)(*[b.data_ptr() for b in bases]))
    o_ptrs = (ctypes.c_void_p * n)(*[o.data_ptr() for o in outs])
    ks = (ctypes.c_int * n)(*[g.shape[1] for g in grads])
    fn = lib.bs_gather_rows_bwd
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    check(fn(idx.data_ptr(), V, n_rows, n, g_ptrs, b_ptrs, o_ptrs, ks,
             part.data_ptr(), stream_ptr(dev)), "gather_rows_bwd")
    gather_rows_bwd.launches += 1
    return tuple(outs)


def gather_rows_bwd(grads: Sequence[torch.Tensor], idx: torch.Tensor,
                    n_rows: int, bases: Sequence[torch.Tensor] | None = None
                    ) -> tuple:
    """grads: one [V, k_j] float32 cotangent a leaf (at most MAX_LEAVES),
    idx [V] int64 nondecreasing in [0, n_rows) -> one [n_rows, k_j] table
    a leaf of the cotangents summed by row (rows no entry names are 0), or
    with ``bases`` (one [n_rows, k_j] float32 table a leaf, left as they
    are) each base plus those sums."""
    if idx.device.type == "cpu":
        return gather_rows_bwd_plain(grads, idx, n_rows, bases)
    return _launch(grads, idx, n_rows, bases)


gather_rows_bwd.launches = 0


def gather_rows_bwd_plain(grads, idx, n_rows, bases=None) -> tuple:
    if bases is None:
        bases = [torch.zeros((n_rows, g.shape[1]), dtype=g.dtype,
                             device=g.device) for g in grads]
    return tuple(b.index_add(0, idx, g) for b, g in zip(bases, grads))

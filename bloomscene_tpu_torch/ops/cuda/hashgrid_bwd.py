"""The hash grid's deterministic backward (CUDA ``csrc/hashgrid_bwd.cu``)
beside its plain version.

``grid_scatter(rows, idx, n_cells)`` is ``out[idx[i]] += rows[i]`` into a
zeroed [n_cells, F] table: the backward of the corner gathers
``table.index_select(0, idx)`` (``ops/hashgrid.py``). It has no TPU
counterpart (XLA's scatter-add does it in the JAX package). On the card
the kernel sorts the entries stably by window (``window_bits(F)`` low
bits of the cell dropped, a radix sort of its own that carries the rows)
and adds each window's run in chunks of ``CHUNK`` entries, one warp a
chunk into its own table, ``STEP`` entries a step: runs of one cell on
consecutive lanes by a segmented scan, then the runs in lane order; then
each cell's chunk partials in chunk order. So the sums are the same bits from
one launch to the next (see the source for the order). The plain version
is ``index_add_``: sequential on the CPU, atomic (in no fixed order) on
the card.
"""
from __future__ import annotations

import ctypes

import torch

from .build import check, library, require, stream_ptr

CHUNK = 2048        # sorted entries a warp sums (hashgrid_bwd.cu)
STEP = 32           # entries a warp adds at a time, one a lane
TABLE_FLOATS = 2048  # a warp's table: cells of a window x F
MAX_F = 8

_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [ctypes.c_int] * 2
             + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p])
_WS_ARGTYPES = ([ctypes.c_longlong] + [ctypes.c_int] * 2
                + [ctypes.POINTER(ctypes.c_longlong)] * 2
                + [ctypes.POINTER(ctypes.c_int)])


def window_bits(F: int) -> int:
    """log2 of the cells of a window: the most whose F floats fit a warp's
    table of TABLE_FLOATS."""
    return (TABLE_FLOATS // F).bit_length() - 1


def _launch(rows, idx, n_cells: int, sort_only: bool):
    dev = rows.device
    M, F = rows.shape
    require(rows, torch.float32, (M, F), "rows", dev)
    require(idx, torch.int64, (M,), "idx", dev)
    if not 1 <= F <= MAX_F or n_cells >= 2 ** 31 or M >= 2 ** 31:
        raise ValueError(f"grid_scatter: F {F} (1-{MAX_F}), n_cells "
                         f"{n_cells} and entries {M} (< 2^31)")
    if rows.data_ptr() % 16:
        rows = rows.clone()     # the kernel reads 16-byte rows
    lib = library("hashgrid_bwd")
    ws = lib.bs_hashgrid_bwd_workspace
    ws.argtypes, ws.restype = _WS_ARGTYPES, ctypes.c_int
    n_int, n_float, wb = ctypes.c_longlong(), ctypes.c_longlong(), \
        ctypes.c_int()
    check(ws(M, F, n_cells, ctypes.byref(n_int), ctypes.byref(n_float),
             ctypes.byref(wb)), "grid_scatter workspace")
    if wb.value != window_bits(F):
        raise RuntimeError(f"grid_scatter: the library's window of 2^"
                           f"{wb.value} cells is not window_bits({F})")
    iws = torch.empty((n_int.value,), dtype=torch.int32, device=dev)
    fws = torch.empty((n_float.value,), dtype=torch.float32, device=dev)
    out = torch.empty((n_cells, F), dtype=torch.float32, device=dev)
    fn = lib.bs_hashgrid_bwd
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    check(fn(idx.data_ptr(), rows.data_ptr(), M, F, n_cells, iws.data_ptr(),
             fws.data_ptr(), out.data_ptr(), int(sort_only),
             stream_ptr(dev)), "grid_scatter")
    return out


def grid_scatter(rows: torch.Tensor, idx: torch.Tensor, n_cells: int
                 ) -> torch.Tensor:
    """rows [M, F] float32, idx [M] int64 cells in [0, n_cells) -> the
    table [n_cells, F] float32 of the rows summed by cell."""
    if rows.device.type == "cpu":
        return grid_scatter_plain(rows, idx, n_cells)
    out = _launch(rows, idx, n_cells, sort_only=False)
    grid_scatter.launches += 1
    return out


grid_scatter.launches = 0


def grid_scatter_sort(rows: torch.Tensor, idx: torch.Tensor, n_cells: int
                      ) -> None:
    """The kernel's sort alone, on a CUDA tensor (to time its share); not
    counted as a launch of ``grid_scatter``."""
    _launch(rows, idx, n_cells, sort_only=True)


def grid_scatter_plain(rows, idx, n_cells):
    out = torch.zeros((n_cells, rows.shape[1]), dtype=rows.dtype,
                      device=rows.device)
    return out.index_add_(0, idx, rows)

"""The hash grid's deterministic backward (CUDA ``csrc/hashgrid_bwd.cu``)
beside its plain version.

``grid_scatter(rows, idx, n_cells)`` is ``out[idx[i]] += rows[i]`` into a
zeroed [n_cells, F] table: the backward of the corner gathers
``table.index_select(0, idx)`` (``ops/hashgrid.py``). It has no TPU
counterpart (XLA's scatter-add does it in the JAX package). On the card
the entries are sorted stably by cell (``torch.sort``, glue around the
kernel) and the kernel adds each cell's run in the sorted order, in
chunks of ``CHUNK`` entries and then across chunks in chunk order, so
the sums are the same bits from one launch to the next. The plain
version is ``index_add_``: sequential on the CPU, atomic (in no fixed
order) on the card.
"""
from __future__ import annotations

import ctypes

import torch

from .build import check, library, require, stream_ptr

CHUNK = 64          # sorted entries a pass-1 thread adds (hashgrid_bwd.cu)
MAX_F = 8

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int]
             + [ctypes.c_void_p] * 3)


def grid_scatter(rows: torch.Tensor, idx: torch.Tensor, n_cells: int
                 ) -> torch.Tensor:
    """rows [M, F] float32, idx [M] int64 cells in [0, n_cells) -> the
    table [n_cells, F] float32 of the rows summed by cell."""
    if rows.device.type == "cpu":
        return grid_scatter_plain(rows, idx, n_cells)
    dev = rows.device
    M, F = rows.shape
    require(rows, torch.float32, (M, F), "rows", dev)
    require(idx, torch.int64, (M,), "idx", dev)
    if not 1 <= F <= MAX_F or n_cells >= 2 ** 31:
        raise ValueError(f"grid_scatter: F {F} (1-{MAX_F}), n_cells "
                         f"{n_cells} (< 2^31)")
    keys, order = torch.sort(idx.to(torch.int32), stable=True)
    out = torch.zeros((n_cells, F), dtype=torch.float32, device=dev)
    part = torch.empty((-(-M // CHUNK), 2, F), dtype=torch.float32,
                       device=dev)
    fn = library("hashgrid_bwd").bs_hashgrid_bwd
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    check(fn(keys.data_ptr(), order.data_ptr(), rows.data_ptr(), M, F,
             part.data_ptr(), out.data_ptr(), stream_ptr(dev)),
          "grid_scatter")
    grid_scatter.launches += 1
    return out


grid_scatter.launches = 0


def grid_scatter_plain(rows, idx, n_cells):
    out = torch.zeros((n_cells, rows.shape[1]), dtype=rows.dtype,
                      device=rows.device)
    return out.index_add_(0, idx, rows)

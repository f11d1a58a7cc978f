"""K4: slab expansion (CUDA ``csrc/expand.cu``) and its plain version.

Replaces the TPU kernel ``bloomscene_tpu/ops/pallas/expand.py::_expand_kernel``:
``slab[:, s, p] = asT[:, min(t_start_p[p], width - cap) + s]`` for
s < cap. The plain version is the gather form of expand.py:136-141.
"""
from __future__ import annotations

import ctypes

import torch

from .build import check, library, require, stream_ptr

_ARGTYPES = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2


def slab_index(t_start_p: torch.Tensor, width: int, cap: int) -> torch.Tensor:
    """The [cap * T] column index of the expansion, slot-major."""
    slot = torch.arange(cap, dtype=torch.int64, device=t_start_p.device)
    return (torch.clamp(t_start_p.long(), max=width - cap)[None, :]
            + slot[:, None]).reshape(-1)


def expand_slab(asT: torch.Tensor, t_start_p: torch.Tensor, cap: int
                ) -> torch.Tensor:
    """asT [R, width] (tile-sorted attribute rows + zero tail, width >= cap),
    t_start_p [T] int32 (range starts in position order) -> slab
    [R, cap, T] float32."""
    if asT.device.type == "cpu":
        return expand_slab_plain(asT, t_start_p, cap)
    dev = asT.device
    R, width = asT.shape
    T = t_start_p.shape[0]
    require(asT, torch.float32, (R, width), "asT", dev)
    require(t_start_p, torch.int32, (T,), "t_start_p", dev)
    if width < cap:
        raise ValueError(f"asT width {width} < cap {cap}")
    slab = torch.empty((R, cap, T), dtype=torch.float32, device=dev)
    fn = library("expand").bs_expand_slab
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    check(fn(asT.data_ptr(), t_start_p.data_ptr(), R, width, cap, T,
             slab.data_ptr(), stream_ptr(dev)), "expand_slab")
    expand_slab.launches += 1
    return slab


expand_slab.launches = 0


def expand_slab_plain(asT, t_start_p, cap):
    R, width = asT.shape
    idx = slab_index(t_start_p, width, cap)
    return torch.index_select(asT, 1, idx).reshape(R, cap, -1)

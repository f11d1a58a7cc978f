"""K1: blend forward (CUDA ``csrc/blend.cu``) and its plain version.

Replaces the TPU kernel ``bloomscene_tpu/ops/pallas/blend.py::_fwd_kernel``.
Front-to-back blend of each tile (at slab position p, tile id tid[p]) over
its depth-sorted slab column, with the reference's per-pixel rules
(power > 0 skip, alpha = min(0.99, op e^power), alpha < 1/255 skip, sticky
stop at T (1 - alpha) < 1e-4 without blending that splat). The plain
version runs the same per-slot recurrence over all pixels of all tiles at
once, as the TPU kernel and ``tile_rasterizer._blend_fwd_impl`` do.
"""
from __future__ import annotations

import ctypes

import torch

from ..reference_rasterizer import ACC_SEED, ALPHA_MAX, ALPHA_MIN, T_EPS
from .build import check, library, require, stream_ptr

DATA_W = 10      # slab rows: mx, my, ca, cb, cc, op, depth, r, g, b

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3


def blend_forward(slab: torch.Tensor, counts_p: torch.Tensor,
                  tid: torch.Tensor, tile: int, gx: int):
    """slab [10, cap, T] f32, counts_p [T] int32 (splats per position),
    tid [T] int32 (tile id per position) -> (r, g, b, D, acc, final_T,
    n_contrib), each [tile*tile, T] in position space (float32, last int32).
    """
    if slab.device.type == "cpu":
        return blend_forward_plain(slab, counts_p, tid, tile, gx)
    dev = slab.device
    _, cap, T = slab.shape
    require(slab, torch.float32, (DATA_W, cap, T), "slab", dev)
    require(counts_p, torch.int32, (T,), "counts_p", dev)
    require(tid, torch.int32, (T,), "tid", dev)
    P = tile * tile
    if P > 1024:
        raise ValueError(f"tile {tile}: one thread per pixel needs "
                         "tile*tile <= 1024")
    planes = torch.empty((6, P, T), dtype=torch.float32, device=dev)
    ncon = torch.empty((P, T), dtype=torch.int32, device=dev)
    fn = library("blend").bs_blend_forward
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    check(fn(slab.data_ptr(), counts_p.data_ptr(), tid.data_ptr(), cap, T,
             tile, gx, planes.data_ptr(), ncon.data_ptr(), stream_ptr(dev)),
          "blend_forward")
    blend_forward.launches += 1
    return (*planes.unbind(0), ncon)


blend_forward.launches = 0


def pixel_coords(tid: torch.Tensor, tile: int, gx: int):
    """px, py [tile*tile, T] float32 for the tiles named by ``tid``."""
    sp = torch.arange(tile * tile, device=tid.device)[:, None]
    t = tid.long()[None, :]
    px = ((t % gx) * tile + sp % tile).float()
    py = ((t // gx) * tile + sp // tile).float()
    return px, py


def blend_forward_plain(slab, counts_p, tid, tile, gx):
    _, cap, T = slab.shape
    P = tile * tile
    dev = slab.device
    px, py = pixel_coords(tid, tile, gx)
    Tr = torch.ones((P, T), dtype=torch.float32, device=dev)
    Cr, Cg, Cb, D = (torch.zeros((P, T), dtype=torch.float32, device=dev)
                     for _ in range(4))
    acc = torch.full((P, T), ACC_SEED, dtype=torch.float32, device=dev)
    done = torch.zeros((P, T), dtype=torch.bool, device=dev)
    ncon = torch.zeros((P, T), dtype=torch.int32, device=dev)
    n_slots = int(counts_p.max()) if T else 0
    for s in range(n_slots):
        mx, my, ca, cb, cc, op, de, cr, cg, cbl = slab[:, s, :]
        dx = mx - px
        dy = my - py
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        alpha = torch.clamp(op * torch.exp(power), max=ALPHA_MAX)
        ok = ((s < counts_p) & (power <= 0.0) & (alpha >= ALPHA_MIN)
              & ~done)
        test_T = Tr * (1.0 - alpha)
        term = ok & (test_T < T_EPS)
        blend = ok & ~term
        done = done | term
        w = torch.where(blend, alpha * Tr, 0.0)
        Cr = Cr + w * cr
        Cg = Cg + w * cg
        Cb = Cb + w * cbl
        D = D + w * de
        acc = acc + w
        Tr = torch.where(blend, test_T, Tr)
        ncon = torch.where(blend, s + 1, ncon)
    return Cr, Cg, Cb, D, acc, Tr, ncon

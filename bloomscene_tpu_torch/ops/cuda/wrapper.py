"""Blend forward around K1: position space -> image planes.

The forward half of ``bloomscene_tpu/ops/pallas/wrapper.py`` (``_fwd_impl``,
:56-84): the kernel writes its planes per occupancy-sorted tile position;
this un-permutes them, assembles the [H, W] images and composites the
background and the gated depth.
"""
from __future__ import annotations

import torch

from ..reference_rasterizer import ACC_GATE, ACC_SEED, RenderOutput
from .blend import blend_forward


def blend_tiles(slab: torch.Tensor, counts: torch.Tensor, perm: torch.Tensor,
                pos: torch.Tensor, bg: torch.Tensor, tile: int, gx: int,
                gy: int, W: int, H: int) -> RenderOutput:
    """slab [10, cap, T] in position space, counts [T] per tile id, perm
    (position -> tile id) and pos (tile id -> position) -> RenderOutput."""
    r, g, b, D, acc, Tf, _ = blend_forward(slab, counts[perm].contiguous(),
                                           perm, tile, gx)
    planes = torch.stack([r, g, b, D, acc, Tf], 0)[:, :, pos.long()]
    img = planes.reshape(6, tile, tile, gy, gx).permute(0, 3, 1, 4, 2)
    img = img.reshape(6, gy * tile, gx * tile)[:, :H, :W]
    acc_img = img[4]
    color = torch.movedim(img[0:3], 0, -1) + img[5][..., None] * bg
    depth = torch.where(acc_img > ACC_GATE, img[3] / acc_img, 0.0)
    return RenderOutput(color=color, depth=depth, alpha=acc_img - ACC_SEED,
                        final_T=img[5])

"""Tile rasterizer: bin, then blend, with the gradient of the blend.

The port of ``bloomscene_tpu/ops/tile_rasterizer.py::rasterize_tiles`` on
its kernel path: the blend attributes ride the binning into the slab (K3
pair expansion, K4 slab expansion), K1 blends each tile, and K2 with the
emission-order reduction gives the gradient (``ops/cuda/wrapper.py``).
Binning runs without grad on detached values (the bins and the slab carry
no gradient, tile_rasterizer.py:373-391); the live mean2d, conic, depth,
color, opacity and bg enter ``TileBlend``. Which code runs follows the
tensors' device: on CUDA the kernels, on the CPU their plain versions.

``tile_group`` (the mesh's tile axis) is the counterpart of JAX's
``tile_sharding`` (tile_rasterizer.py:339-421): when the tile count
divides its size S, the occupancy order is dealt over S strips and each
rank blends its strip (``ops/cuda/wrapper.py``); otherwise every rank
blends the whole grid, on the same kernels (tile_rasterizer.py:355-365).
``TileBins.tile_shards`` says which ran.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.profiling import span
from .cuda.wrapper import tile_blend
from .projection import ProjectedSplats
from .reference_rasterizer import RenderOutput
from .tiles import TileBins, bin_splats, tile_grid


def attr_rows(proj: ProjectedSplats, colors: torch.Tensor,
              opac_eff: torch.Tensor) -> torch.Tensor:
    """[10, N] blend attributes in id order: mean2d x/y, conic a/b/c,
    opacity, depth, r, g, b."""
    return torch.stack([
        proj.mean2d[:, 0], proj.mean2d[:, 1], proj.conic[:, 0],
        proj.conic[:, 1], proj.conic[:, 2], opac_eff, proj.depth,
        colors[:, 0], colors[:, 1], colors[:, 2]], 0).contiguous()


def rasterize_tiles(proj: ProjectedSplats,
                    colors: torch.Tensor,
                    opacities: torch.Tensor,
                    bg: torch.Tensor,
                    W: int, H: int,
                    tile: int = 16,
                    pair_capacity: int | None = None,
                    tile_capacity: int = 1024,
                    packed_capacity: int | None = None,
                    tile_group=None) -> tuple[RenderOutput, TileBins]:
    """Bin + blend one view. Overflow is depth-aware (the farthest pairs
    drop first) and reported in the returned ``TileBins``. The output is
    differentiable in proj.mean2d, proj.conic, proj.depth, colors,
    opacities and bg when grad is enabled. With ``tile_group`` every rank
    of that axis calls this on the same inputs and gets the same result,
    the blend cut into strips when the grid divides the axis."""
    n = proj.mean2d.shape[0]
    gx, gy = tile_grid(W, H, tile)
    size = tile_group.size if tile_group is not None else 1
    shards = size if size > 1 and (gx * gy) % size == 0 else 1
    if pair_capacity is None:
        # the JAX package's default: 4 pairs a splat, at most 2x the total
        # tile budget
        limit = 2 * gx * gy * tile_capacity
        want = 1 << max(16, int(np.ceil(np.log2(max(4 * n, 1)))))
        pair_capacity = max(1024, min(want, limit))
    live = (proj.mean2d, proj.conic, proj.depth, colors, opacities, bg)
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in live)
    opac_eff = torch.where(proj.valid, opacities, 0.0)
    with torch.no_grad(), span("render.bin"):
        p_sg = ProjectedSplats(*(t.detach() for t in proj))
        o_sg = opac_eff.detach()
        bins = bin_splats(p_sg, W, H, tile, pair_capacity, tile_capacity,
                          opacities=o_sg, packed_capacity=packed_capacity,
                          grad_index=grad and n > 0,
                          attr_rows=attr_rows(p_sg, colors.detach(), o_sg)
                          if n > 0 else None, tile_shards=shards)
    if n == 0:
        # empty scene: the composite is the background
        dev = bg.device
        out = RenderOutput(
            color=bg.to(torch.float32).expand(H, W, 3).clone(),
            depth=torch.zeros((H, W), dtype=torch.float32, device=dev),
            alpha=torch.zeros((H, W), dtype=torch.float32, device=dev),
            final_T=torch.ones((H, W), dtype=torch.float32, device=dev))
        return out, bins
    out = tile_blend(proj.mean2d, proj.conic, proj.depth, colors, opac_eff,
                     bg, bins, tile, gx, gy, W, H, group=tile_group)
    return out, bins

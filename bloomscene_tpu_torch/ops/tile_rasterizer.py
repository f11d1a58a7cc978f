"""Tile rasterizer forward: bin, then blend.

The forward of ``bloomscene_tpu/ops/tile_rasterizer.py::rasterize_tiles``
on its kernel path: the blend attributes ride the binning into the slab
(K3 pair expansion, K4 slab expansion) and K1 blends each tile. Which code
runs follows the tensors' device: on CUDA the kernels, on the CPU their
plain versions. Forward only; the gradient comes with the training path.
"""
from __future__ import annotations

import numpy as np
import torch

from .cuda.wrapper import blend_tiles
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


@torch.no_grad()
def rasterize_tiles(proj: ProjectedSplats,
                    colors: torch.Tensor,
                    opacities: torch.Tensor,
                    bg: torch.Tensor,
                    W: int, H: int,
                    tile: int = 16,
                    pair_capacity: int | None = None,
                    tile_capacity: int = 1024,
                    packed_capacity: int | None = None
                    ) -> tuple[RenderOutput, TileBins]:
    """Bin + blend one view. Overflow is depth-aware (the farthest pairs
    drop first) and reported in the returned ``TileBins``."""
    n = proj.mean2d.shape[0]
    gx, gy = tile_grid(W, H, tile)
    if pair_capacity is None:
        # the JAX package's default: 4 pairs a splat, at most 2x the total
        # tile budget
        limit = 2 * gx * gy * tile_capacity
        want = 1 << max(16, int(np.ceil(np.log2(max(4 * n, 1)))))
        pair_capacity = max(1024, min(want, limit))
    opac_eff = torch.where(proj.valid, opacities, 0.0)
    bins = bin_splats(proj, W, H, tile, pair_capacity, tile_capacity,
                      opacities=opac_eff, packed_capacity=packed_capacity,
                      attr_rows=attr_rows(proj, colors, opac_eff)
                      if n > 0 else None)
    if n == 0:
        # empty scene: the composite is the background
        out = RenderOutput(
            color=bg.to(torch.float32).expand(H, W, 3).clone(),
            depth=torch.zeros((H, W), dtype=torch.float32, device=bg.device),
            alpha=torch.zeros((H, W), dtype=torch.float32, device=bg.device),
            final_T=torch.ones((H, W), dtype=torch.float32,
                               device=bg.device))
        return out, bins
    out = blend_tiles(bins.slab, bins.counts, bins.perm, bins.pos, bg, tile,
                      gx, gy, W, H)
    return out, bins

"""Full neural render: anchor decode -> projection -> tile rasterizer.

The port of ``bloomscene_tpu/models/render.py`` (gaussian_renderer.render
+ prefilter_voxel, gaussian_renderer/__init__.py:211-349). A train-mode
render is differentiable in the model's leaves that require grad (and in
``mean2d_offset``); an eval-mode or decoded-mode render runs without
grad.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import GSConfig
from ..ops import projection
from ..ops.projection import ProjectedSplats
from ..ops.reference_rasterizer import RenderOutput
from ..ops.tile_rasterizer import rasterize_tiles
from ..ops.tiles import TileBins, compute_tile_rects
from ..scene.cameras import CameraArrays, Intrinsics
from ..utils.profiling import span
from .anchors import get_scaling
from .decode import (DecodedGaussians, DecodeNoise, RateInfo,
                     attribute_means, decode_neural_gaussians)
from .model import Model


class RenderResult(NamedTuple):
    out: RenderOutput
    dec: DecodedGaussians
    rate: RateInfo | None           # train mode only
    proj: ProjectedSplats
    bins: TileBins                  # with the overflow counters
    # anchor indices of the visible-compacted set ([visible_capacity]
    # int64, entries == capacity are padding), or None when decode ran dense
    visible_idx: torch.Tensor | None = None


def _project(xyz, scaling, rotation, intr: Intrinsics, cam: CameraArrays):
    cov6 = projection.build_cov3d(scaling, rotation)
    return projection.project_gaussians(
        xyz, cov6, cam.viewmat, cam.full_proj, intr.width, intr.height,
        intr.focal_x, intr.focal_y, intr.tan_fovx, intr.tan_fovy)


@torch.no_grad()
def prefilter_anchors(model: Model, intr: Intrinsics,
                      cam: CameraArrays) -> torch.Tensor:
    """Anchor visibility: anchors projected as Gaussians with the offset
    scale and the stored rotation, visible iff radius > 0 (prefilter_voxel,
    gaussian_renderer:294-349)."""
    st = model.state
    proj = _project(st.anchor, get_scaling(st)[:, :3], st.rotation, intr,
                    cam)
    return proj.valid & st.alive


def compact_visible(model: Model, visible: torch.Tensor,
                    visible_capacity: int) -> tuple[Model, torch.Tensor]:
    """Gather the visible anchors into a bucket of ``visible_capacity``
    rows, padded with dead rows; visible anchors past the bucket are
    dropped. The indices (int64) are ``jnp.nonzero(visible,
    size=visible_capacity, fill_value=C)``: entry j is where the running
    count of visible rows first reaches j + 1, or C where it never does,
    so nothing waits for the host (``torch.nonzero`` would) and a CUDA
    graph can capture it."""
    st = model.state
    C = st.capacity
    count = torch.cumsum(visible, 0)
    rank = torch.arange(1, visible_capacity + 1, dtype=count.dtype,
                        device=visible.device)
    idx = torch.searchsorted(count, rank, side='left')
    ok = idx < C
    safe = torch.clamp(idx, max=C - 1)
    return model._replace(state=st.gather_rows(safe, ok & st.alive[safe])), idx


@torch.no_grad()
def count_pairs(model: Model, intr: Intrinsics, cam: CameraArrays,
                cfg: GSConfig, *, mode: str = 'eval',
                visible: torch.Tensor | None = None,
                visible_capacity: int | None = None) -> torch.Tensor:
    """Total splat-tile pair count (before the cull) for one view: the
    measuring pass that sizes the eval binning buffers."""
    if (visible_capacity is not None and visible is not None
            and model.state.capacity > visible_capacity):
        model, _ = compact_visible(model, visible, visible_capacity)
        visible = None
    dec, _ = decode_neural_gaussians(model, cam.camera_center, cfg,
                                     mode=mode, visible=visible)
    proj = _project(dec.xyz, dec.scaling, dec.rotation, intr, cam)
    proj = proj._replace(valid=proj.valid & dec.valid)
    opac_eff = torch.where(proj.valid, dec.opacity, 0.0)
    *_, touched = compute_tile_rects(proj, intr.width, intr.height,
                                     cfg.tile_size, opacities=opac_eff)
    return torch.sum(touched)


def render(model: Model, intr: Intrinsics, cam: CameraArrays,
           cfg: GSConfig, *, phase: int = 0, mode: str = 'train',
           bg: torch.Tensor | None = None,
           visible: torch.Tensor | None = None,
           mean2d_offset: torch.Tensor | None = None,
           noise: DecodeNoise | None = None,
           tile_capacity: int | None = None,
           visible_capacity: int | None = None,
           pair_capacity: int | None = None,
           packed_capacity: int | None = None,
           tile_group=None) -> RenderResult:
    """Render one view. ``visible_capacity`` / ``pair_capacity`` /
    ``packed_capacity`` override the cfg values (the eval render sizes them
    from measuring passes over the orbit, pipeline.render_model).

    ``mean2d_offset`` is a flat zero [n_child * 2] tensor added to the
    projected means: its gradient is dL/dmean2d in pixels, the densify
    statistic (render.py:104-108, 160-162). ``noise`` is the decode's
    draws in training phases 1 and 2, over the rows it decodes (the
    visible bucket when the render compacts). ``tile_group`` (the mesh's
    tile axis) blends tile-parallel (render.py:99,170; ``rasterize_tiles``):
    every rank of the axis renders the same view and gets the same
    result."""
    with torch.set_grad_enabled(mode == 'train' and torch.is_grad_enabled()):
        return _render(model, intr, cam, cfg, phase, mode, bg, visible,
                       mean2d_offset, noise, tile_capacity, visible_capacity,
                       pair_capacity, packed_capacity, tile_group)


def _render(model, intr, cam, cfg, phase, mode, bg, visible, mean2d_offset,
            noise, tile_capacity, visible_capacity, pair_capacity,
            packed_capacity, tile_group) -> RenderResult:
    dev = model.state.device
    if bg is None:
        bg = torch.zeros(3, device=dev)
    if visible_capacity is None:
        visible_capacity = cfg.visible_capacity
    visible_idx = attr_means = None
    if (visible_capacity is not None and visible is not None
            and model.state.capacity > visible_capacity):
        with span("render.compact"):
            if mode == 'eval' or (mode == 'train' and phase == 2):
                # quantization centers come from the FULL state, so the
                # render does not depend on the compaction
                attr_means = attribute_means(model.state)
            model, visible_idx = compact_visible(model, visible,
                                                 visible_capacity)
        visible = None
    with span("render.decode"):
        dec, rate = decode_neural_gaussians(
            model, cam.camera_center, cfg, phase=phase, mode=mode,
            visible=visible, noise=noise, attr_means=attr_means)
    # the projection here, the binning in rasterize_tiles: render.bin
    with span("render.bin"):
        proj = _project(dec.xyz, dec.scaling, dec.rotation, intr, cam)
        if mean2d_offset is not None:
            proj = proj._replace(mean2d=proj.mean2d
                                 + mean2d_offset.reshape(-1, 2))
        proj = proj._replace(valid=proj.valid & dec.valid)
    out, bins = rasterize_tiles(
        proj, dec.color, dec.opacity, bg, intr.width, intr.height,
        tile=cfg.tile_size,
        pair_capacity=pair_capacity or cfg.pair_capacity,
        tile_capacity=tile_capacity or cfg.max_splats_per_tile,
        packed_capacity=packed_capacity or cfg.packed_capacity,
        tile_group=tile_group)
    return RenderResult(out=out, dec=dec, rate=rate, proj=proj, bins=bins,
                        visible_idx=visible_idx)

"""The work a training step's kernels and model need, counted from their
inputs: the least time of each kernel group (the larger of its bytes at
the card's memory rate and its operations at its float32 rate) and the
step's model FLOPs.

Each input byte of a kernel group is counted read once and each output
written once, pairs and live slots as the data has them; what one kernel
of a group writes for another (the hash grid's corner rows and their
indices) is not counted, so the count reads the same whatever kernels
implement the group. The blend's counts are PERF.md's kernel table's
(``k1_bound``, ``k2_bound``): K1 reads the slab's live slots, the counts
and the tile ids and writes seven [P, T] planes, 30 operations a (pixel,
slot) step up to each pixel's last contributor; K2 reads the walked
slots and eight [P, T] planes and writes the [10, cap, T] per-entry
gradients, 71 operations a step.
"""
from __future__ import annotations

import torch

BLEND_OPS_PER_STEP = 30
BLEND_BWD_OPS_PER_STEP = 71
F32 = 4


def k1_bytes_ops(counts_p, ncon, tile: int) -> tuple[float, float]:
    P, T = tile * tile, counts_p.numel()
    return (F32 * (10 * int(counts_p.sum()) + 2 * T + 7 * P * T),
            BLEND_OPS_PER_STEP * float(ncon.double().sum()))


def blend_walk(counts_p, ncon):
    """The slots K2 walks a tile: min(count, its pixels' last
    contributor)."""
    return torch.minimum(counts_p, ncon.amax(0))


def k2_bytes_ops(counts_p, ncon, tile: int, cap: int) -> tuple[float, float]:
    P, T = tile * tile, counts_p.numel()
    walk = blend_walk(counts_p, ncon)
    return (F32 * (10 * int(walk.sum()) + 8 * P * T + 2 * T + 10 * cap * T),
            BLEND_BWD_OPS_PER_STEP * float(ncon.double().sum()))


def least_s(nbytes: float, ops: float, peaks: dict) -> float:
    return max(nbytes / peaks["hbm_bytes_per_s"],
               ops / peaks["f32_flops_per_s"])


def gather_step_bytes(rows: int, capacity: int, widths: int,
                      bases: bool) -> float:
    """A segmented row sum: [rows, widths] cotangents and their int64 row
    index read, [capacity, widths] sums written (and, onto bases, read)."""
    return (F32 * widths * rows + 8 * rows
            + F32 * widths * capacity * (2 if bases else 1))


def head_flops(gs: dict, phase: int) -> tuple[float, float]:
    """Forward FLOPs a visible anchor of the decode heads' matrix products
    (opacity, cov, color), and of the phase-2 context MLP (the grid head,
    which gives the entropy model's parameters)."""
    from .scene import head_shapes
    shapes = head_shapes(gs)

    def mlp(dims):
        return sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
    heads = sum(mlp(shapes[k]) for k in ("opacity", "cov", "color"))
    return heads, (mlp(shapes["grid"]) if phase == 2 else 0.0)


@torch.no_grad()
def view_bins(model, cfg, intr, cam, phase: int, gen, device):
    """One view's binning by the reference's plain copies -> (counts_p,
    n_contrib): each position's splats and each pixel's last contributor,
    from the plain blend forward."""
    from .reference.blend import blend_forward_plain
    from .reference.decode import attribute_means, decode_neural_gaussians
    from .reference.decode import draw_noise
    from .reference.render import _project, compact_visible
    from .reference.render import prefilter_anchors
    from .reference.step import decoded_rows
    from .reference.tile_rasterizer import attr_rows
    from .reference.tiles import bin_splats, tile_grid
    visible = prefilter_anchors(model, intr, cam)
    noise = draw_noise(decoded_rows(model.state.capacity, cfg), cfg, phase,
                       gen, device)
    means = None
    if (cfg.visible_capacity is not None
            and model.state.capacity > cfg.visible_capacity):
        if phase == 2:
            means = attribute_means(model.state)
        model, _ = compact_visible(model, visible, cfg.visible_capacity)
        visible = None
    dec, _ = decode_neural_gaussians(model, cam.camera_center, cfg,
                                     phase=phase, mode="train",
                                     visible=visible, noise=noise,
                                     attr_means=means)
    proj = _project(dec.xyz, dec.scaling, dec.rotation, intr, cam)
    proj = proj._replace(valid=proj.valid & dec.valid)
    opac = torch.where(proj.valid, dec.opacity, 0.0)
    W, H, tile = intr.width, intr.height, cfg.tile_size
    n = proj.mean2d.shape[0]
    gx, gy = tile_grid(W, H, tile)
    # the rasterizer's default: 4 pairs a splat, at most 2x the tile budget
    pcap = cfg.pair_capacity or max(1024, min(
        1 << max(16, (4 * n - 1).bit_length()),
        2 * gx * gy * cfg.max_splats_per_tile))
    bins = bin_splats(proj, W, H, tile, pcap, cfg.max_splats_per_tile,
                      opacities=opac, packed_capacity=cfg.packed_capacity,
                      attr_rows=attr_rows(proj, dec.color, opac))
    counts_p = bins.counts[bins.perm.long()].contiguous()
    ncon = blend_forward_plain(bins.slab, counts_p, bins.perm, tile, gx)[6]
    return counts_p, ncon


def window_work(config: dict, traffic: dict, inputs: dict, final: dict,
                weights: dict, views_drawn: list, device) -> dict:
    """K1's and K2's bytes and operations over the traced steps (the views
    they drew, counted on the model as the window left it, by the
    reference's plain binning) and the shapes the other counts need."""
    from .harness import gs_kwargs, views_for
    from .reference.cameras import CameraArrays, Intrinsics
    from .reference.config import GSConfig
    from .reference.step import build_model, decoded_rows
    cfg = GSConfig(**gs_kwargs(config, traffic))
    leaves = dict(weights)
    leaves.update(final)
    model = build_model(leaves, cfg, device)
    c = inputs["cams"]
    intr = Intrinsics(config["camera"]["width"], config["camera"]["height"],
                      c["fovx"], c["fovy"])
    views = views_for(CameraArrays, inputs, device)
    gen = torch.Generator(device=device).manual_seed(0)
    tile, cap = cfg.tile_size, cfg.max_splats_per_tile
    per_view = {}
    for v in sorted(set(views_drawn)):
        counts_p, ncon = view_bins(model, cfg, intr, views[v][0],
                                   traffic["phase"], gen, device)
        per_view[v] = (k1_bytes_ops(counts_p, ncon, tile),
                       k2_bytes_ops(counts_p, ncon, tile, cap))
    return {"k1": [per_view[v][0] for v in views_drawn],
            "k2": [per_view[v][1] for v in views_drawn],
            "rows": decoded_rows(model.state.capacity, cfg),
            "capacity": model.state.capacity,
            "compacted": decoded_rows(model.state.capacity, cfg)
            < model.state.capacity}

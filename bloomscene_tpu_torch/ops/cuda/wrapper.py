"""The tile blend with its gradient: K1 forward, K2 backward, reduction.

The port of ``bloomscene_tpu/ops/pallas/wrapper.py`` (``tile_blend_pallas``
and its custom VJP). Forward (``_fwd_impl``, :56-84): K1 writes its planes
per occupancy-sorted tile position; they are un-permuted, assembled into
[H, W] images, and the background and the gated depth are composited.
Backward (``_bwd``, :97-188): the image cotangents go to position space as
the 5-channel algebra (r, g, b, depth value, ones) plus the background
term, K2 writes per-entry gradients [10, cap, T], and the emission-order
reduction turns them into per-Gaussian gradients without a scatter: each
Gaussian's live entries summed over its contiguous emission range. The
JAX package does that in plain XLA outside the Pallas kernel (a gather,
two cumsums and their difference); here it is a kernel of its own on the
card (``emission_sums``, ``csrc/emission_sums.cu``), a plain segmented sum
on the CPU.

The slab, the bins and the residuals carry no gradient; gradients reach
mean2d, conic, depth, color, opacity and bg only through ``TileBlend``.

Tile-parallel (``group``, the mesh's tile axis, with ``bins.tile_shards``
strips: the counterpart of the shard-mapped K1 and K2, blend.py:243-270 and
:475-500). Binning runs on every rank on the same inputs. Each rank runs
K1 on its strip of T / S positions; the strips' planes are all-gathered
in rank order and assembled on every rank. In the backward every rank
computes the cotangent planes, K2 runs on its strip, the [10, cap, T / S]
strips are all-gathered and every rank runs the reduction. Since a tile's
K1 and K2 read no other tile, the gathered planes and gradients are the
single call's bit for bit, and so are the image and the per-Gaussian
gradients (sums in float are not additive, so strip-local partials are
never summed across ranks).
"""
from __future__ import annotations

import torch

from ..reference_rasterizer import ACC_GATE, ACC_SEED, RenderOutput
from ...utils.profiling import span
from .blend import blend_backward, blend_forward
from .emission_sums import emission_sums


def _assemble(planes: torch.Tensor, pos: torch.Tensor, bg: torch.Tensor,
              tile: int, gx: int, gy: int, W: int, H: int) -> RenderOutput:
    """[6, P, T] position-space planes (r, g, b, D, acc, T) -> images."""
    planes = planes[:, :, pos.long()]
    img = planes.reshape(6, tile, tile, gy, gx).permute(0, 3, 1, 4, 2)
    img = img.reshape(6, gy * tile, gx * tile)[:, :H, :W]
    acc_img = img[4]
    color = torch.movedim(img[0:3], 0, -1) + img[5][..., None] * bg
    depth = torch.where(acc_img > ACC_GATE, img[3] / acc_img, 0.0)
    return RenderOutput(color=color, depth=depth, alpha=acc_img - ACC_SEED,
                        final_T=img[5])


def cotangent_planes(g_color, g_depth, g_alpha, g_final_T, bg, acc, D,
                     perm, tile: int, gx: int, gy: int):
    """Image cotangents -> the six [P, T] planes K2 reads, in position
    space: u_r, u_g, u_b, u_d (depth value), u_one and the background term
    (wrapper.py:106-124)."""
    H, W = g_depth.shape
    planes = torch.stack([g_color[..., 0], g_color[..., 1], g_color[..., 2],
                          g_depth, g_alpha, g_final_T], 0)
    planes = torch.nn.functional.pad(planes, (0, gx * tile - W,
                                              0, gy * tile - H))
    pp = planes.reshape(6, gy, tile, gx, tile).permute(0, 2, 4, 1, 3)
    pp = pp.reshape(6, tile * tile, gy * gx)[:, :, perm.long()]
    g_r, g_g, g_b, g_d, g_a, g_T = pp.unbind(0)
    gate = acc > ACC_GATE
    u_d = torch.where(gate, g_d / acc, 0.0)
    u_one = torch.where(gate, -g_d * D / (acc * acc), 0.0) + g_a
    bg_term = bg[0] * g_r + bg[1] * g_g + bg[2] * g_b + g_T
    return tuple(t.contiguous() for t in (g_r, g_g, g_b, u_d, u_one,
                                          bg_term))


def reduce_entry_grads(grad: torch.Tensor, src_lane: torch.Tensor,
                       starts_by_id: torch.Tensor,
                       ends_by_id: torch.Tensor) -> torch.Tensor:
    """Per-entry gradients [10, cap, T] -> per-Gaussian sums [10, n] in
    emission order (wrapper.py:146-172). Culled, truncated and
    over-capacity pairs carry the lane cap*T and add nothing."""
    return emission_sums(grad, src_lane, starts_by_id, ends_by_id)


def _strip(bins, group) -> tuple[int, int]:
    """(p0, n): this rank's strip of positions, or all of them."""
    T = bins.perm.numel()
    if bins.tile_shards == 1:
        return 0, T
    if group is None or group.size != bins.tile_shards:
        raise ValueError(f"bins cut into {bins.tile_shards} strips need a "
                         f"tile group of that size, got {group}")
    n = T // bins.tile_shards
    return group.index * n, n


def _gather_columns(group, x: torch.Tensor) -> torch.Tensor:
    """Every rank's strip of positions (the last axis), in rank order."""
    return torch.cat(group.all_gather(x), -1)


class TileBlend(torch.autograd.Function):
    """K1 + image assembly forward; K2 + reduction backward."""

    @staticmethod
    def forward(ctx, mean2d, conic, depth, color, opac, bg, bins, geom,
                group):
        with span("tile_blend.forward"):
            return TileBlend._forward(ctx, bg, bins, geom, group)

    @staticmethod
    def _forward(ctx, bg, bins, geom, group):
        tile, gx, gy, W, H = geom
        counts_p = bins.counts[bins.perm.long()].contiguous()
        p0, n = _strip(bins, group)
        r, g, b, D, acc, Tf, ncon = blend_forward(bins.slab, counts_p,
                                                  bins.perm, tile, gx, p0, n)
        if bins.tile_shards > 1:
            # one gather: the six planes and n_contrib's bits as a seventh
            planes = _gather_columns(group, torch.stack(
                [r, g, b, D, acc, Tf, ncon.view(torch.float32)], 0))
            r, g, b, D, acc, Tf = planes[:6]
            ncon = planes[6].view(torch.int32)
        out = _assemble(torch.stack([r, g, b, D, acc, Tf], 0), bins.pos, bg,
                        tile, gx, gy, W, H)
        ctx.geom, ctx.group, ctx.strip = geom, group, (p0, n)
        ctx.shards = bins.tile_shards
        ctx.save_for_backward(bins.slab, counts_p, bins.perm, Tf, acc, D,
                              ncon, bg, bins.src_lane, bins.starts_by_id,
                              bins.ends_by_id)
        return out.color, out.depth, out.alpha, out.final_T

    @staticmethod
    def backward(ctx, g_color, g_depth, g_alpha, g_final_T):
        # the saved tensors first: under remat their unpacking runs the
        # recompute, which is no part of tile_blend.backward
        saved = ctx.saved_tensors
        with span("tile_blend.backward"):
            return TileBlend._backward(ctx, saved, g_color, g_depth, g_alpha,
                                       g_final_T)

    @staticmethod
    def _backward(ctx, saved, g_color, g_depth, g_alpha, g_final_T):
        tile, gx, gy, W, H = ctx.geom
        (slab, counts_p, perm, Tf, acc, D, ncon, bg, src_lane, starts,
         ends) = saved
        if src_lane is None:
            raise ValueError("TileBlend gradients need the grad index: bin "
                             "with bin_splats(..., grad_index=True)")
        with span("tile_blend.cotangents"):
            u = cotangent_planes(g_color, g_depth, g_alpha, g_final_T, bg,
                                 acc, D, perm, tile, gx, gy)
        with span("tile_blend.k2"):
            grad = blend_backward(slab, counts_p, perm, tile, gx, Tf, ncon,
                                  *u, *ctx.strip)
        if ctx.shards > 1:
            with span("tile_blend.gather"):
                grad = _gather_columns(ctx.group, grad)
        with span("tile_blend.reduce"):
            sums = reduce_entry_grads(grad, src_lane, starts, ends)
            d_bg = torch.stack([torch.sum(Tf * u[0]), torch.sum(Tf * u[1]),
                                torch.sum(Tf * u[2])])
        return (sums[0:2].T, sums[2:5].T, sums[6], sums[7:10].T, sums[5],
                d_bg, None, None, None)


def tile_blend(mean2d, conic, depth, color, opac, bg, bins, tile: int,
               gx: int, gy: int, W: int, H: int,
               group=None) -> RenderOutput:
    """Blend the binned splats into one view. ``bins`` must carry the slab
    (``bin_splats(attr_rows=...)``) and, for gradients, the grad index.
    Bins cut into ``bins.tile_shards`` > 1 strips blend tile-parallel over
    ``group`` (the mesh's tile axis, of that size)."""
    return RenderOutput(*TileBlend.apply(mean2d, conic, depth, color, opac,
                                         bg, bins, (tile, gx, gy, W, H),
                                         group))

"""Tile binning: depth pre-sort, pair expansion, tile sort, ranges, slab.

The forward of ``bloomscene_tpu/ops/tiles.py`` (``compute_tile_rects``,
``bin_splats``, ``_finish_bins``) on torch tensors:

1. Per-Gaussian tile rectangle (getRect rounding, intersected with the
   opacity-aware ellipse box when opacities are given).
2. Stable depth pre-sort of the Gaussians with zero-touched ones at the
   tail, so pairs are emitted front to back and the live ranks are a
   gap-free prefix.
3. Pair expansion with the exact-zero cull: kernel K3
   (``ops/cuda/pairs.py``).
4. Tile sort on unique keys ``(tile << kbits) | slot`` (or the two keys
   ``(tile, slot)`` when that does not fit 31 bits), truncated to
   ``packed_capacity``; tile ranges from one (T+1)-probe search.
5. Occupancy order of the tiles, the gradient-reduction index, and the
   blend's slab ``[10, tile_capacity, T]`` through kernel K4
   (``ops/cuda/expand.py``). With ``tile_shards=S`` (the tile-parallel
   render) the occupancy ranks are dealt round-robin over S strips of
   positions, so every strip gets an equal share of heavy tiles.

All outputs equal the JAX package's bit for bit on the same inputs. The
TPU's sort-payload packing of the rectangle fields is not reproduced; the
values it carries are.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .plain import expand_pairs, expand_slab
from .projection import ProjectedSplats


class TileBins(NamedTuple):
    num_pairs: torch.Tensor       # [] int32 total (untruncated) pair count
    pair_overflow: torch.Tensor   # [] int32 pairs dropped by pair_capacity
    tile_overflow: torch.Tensor   # [] int32 entries dropped by tile_capacity
    gauss_sorted: torch.Tensor    # [packed_capacity] int32 tile-then-depth
    tile_sorted: torch.Tensor     # [packed_capacity] int32 tile id per pair
    t_start: torch.Tensor         # [num_tiles] int32 range starts
    counts: torch.Tensor          # [num_tiles] int32 clamped to tile_capacity
    num_packed: torch.Tensor      # [] int32 pairs surviving the cull
    packed_overflow: torch.Tensor  # [] int32 survivors past packed_capacity
    # occupancy order of the tile grid (attr_rows or grad_index)
    perm: torch.Tensor | None = None       # [T] position -> tile id
    pos: torch.Tensor | None = None        # [T] tile id -> position
    # blend slab [10, tile_capacity, T] in position space (attr_rows given)
    slab: torch.Tensor | None = None
    # gradient-reduction index (grad_index=True), as the JAX package's
    src_lane: torch.Tensor | None = None      # [pair_capacity] int32
    starts_by_id: torch.Tensor | None = None  # [n] int32
    ends_by_id: torch.Tensor | None = None    # [n] int32
    # strips of positions the blend was cut into: the tile axis' size in a
    # tile-parallel render whose grid divides it, else 1 (every rank
    # blends the whole grid)
    tile_shards: int = 1


def tile_grid(W: int, H: int, tile: int) -> tuple[int, int]:
    return (-(-W // tile), -(-H // tile))


def compute_tile_rects(proj: ProjectedSplats, W: int, H: int, tile: int,
                       opacities: torch.Tensor | None = None):
    """Per-Gaussian clamped tile rectangle [x0,x1) x [y0,y1) + touched count.

    Without ``opacities``: the reference rect (getRect, auxiliary.h:46-56).
    With them: intersected with the box of the ellipse where
    alpha = opac * exp(-q) can reach 1/255, so the pair set stays a subset
    of the reference's and only never-contributing pairs go.
    """
    gx, gy = tile_grid(W, H, tile)
    r = proj.radius.float()
    x, y = proj.mean2d[:, 0], proj.mean2d[:, 1]
    live = proj.valid

    def cell(v, hi):
        return torch.clamp(v, 0, hi).to(torch.int32)

    x0 = cell(torch.floor((x - r) / tile), gx)
    y0 = cell(torch.floor((y - r) / tile), gy)
    x1 = cell(torch.floor((x + r + tile - 1) / tile), gx)
    y1 = cell(torch.floor((y + r + tile - 1) / tile), gy)
    if opacities is not None:
        ca, cb, cc = proj.conic[:, 0], proj.conic[:, 1], proj.conic[:, 2]
        det = torch.clamp(ca * cc - cb * cb, min=1e-24)
        qmax = torch.log(torch.clamp(255.0 * opacities, min=1e-12)) + 1e-3
        s2 = 2.0 * torch.clamp(qmax, min=0.0) / det
        rx = torch.sqrt(s2 * cc) + 1e-2
        ry = torch.sqrt(s2 * ca) + 1e-2
        x0 = torch.maximum(x0, cell(torch.floor((x - rx) / tile), gx))
        y0 = torch.maximum(y0, cell(torch.floor((y - ry) / tile), gy))
        x1 = torch.minimum(x1, cell(torch.floor((x + rx) / tile) + 1, gx))
        y1 = torch.minimum(y1, cell(torch.floor((y + ry) / tile) + 1, gy))
        live = live & (qmax > 0)
    touched = torch.where(
        live, torch.clamp(x1 - x0, min=0) * torch.clamp(y1 - y0, min=0), 0)
    return x0, y0, x1, y1, touched.to(torch.int32)


def pair_kernel_inputs(proj: ProjectedSplats, W: int, H: int, tile: int,
                       pair_capacity: int,
                       opacities: torch.Tensor | None = None) -> dict:
    """Depth pre-sort -> the keyword arguments of ``expand_pairs`` (K3).

    Stable: equal depths keep id order, which with the unique tile-sort
    key reproduces the reference (tile, depth, emission) order exactly.
    """
    gx, gy = tile_grid(W, H, tile)
    num_tiles = gx * gy
    x0, y0, x1, _, touched = compute_tile_rects(proj, W, H, tile,
                                                opacities=opacities)
    width = torch.clamp(x1 - x0, min=1)
    key = torch.where(touched > 0, proj.depth, torch.inf)
    order = torch.sort(key, stable=True).indices
    touched_s = touched[order]
    offsets = torch.cumsum(touched_s, 0, dtype=torch.int32)
    starts_full = torch.cat([offsets - touched_s, offsets[-1:]])
    atab = None
    if opacities is not None:
        atab = torch.stack([
            proj.mean2d[:, 0], proj.mean2d[:, 1], proj.conic[:, 0],
            proj.conic[:, 1], proj.conic[:, 2],
            torch.log(torch.clamp(255.0 * opacities, min=1e-12))],
            0)[:, order].contiguous()
    kbits = max(1, pair_capacity - 1).bit_length()
    return dict(
        starts_full=starts_full.contiguous(),
        x0=x0[order].contiguous(), y0=y0[order].contiguous(),
        w=width[order].contiguous(), order=order.to(torch.int32),
        atab=atab, pair_capacity=pair_capacity, gx=gx, tile=tile,
        kbits=kbits, num_tiles=num_tiles,
        packed_key=kbits < 31 and (num_tiles + 1) < (1 << (31 - kbits)))


def sorted_attr_table(attr_rows: torch.Tensor, gauss_sorted: torch.Tensor,
                      tile_capacity: int) -> torch.Tensor:
    """[10, N] attribute rows -> [10, len(gauss_sorted) + tile_capacity]
    in tile-sorted pair order, with a zero tail (K4's input)."""
    n = attr_rows.shape[1]
    tab_z = torch.nn.functional.pad(attr_rows, (0, 1))
    idx = torch.cat([gauss_sorted.long(), torch.full(
        (tile_capacity,), n, dtype=torch.int64, device=attr_rows.device)])
    return torch.index_select(tab_z, 1, idx)


def bin_splats(proj: ProjectedSplats, W: int, H: int, tile: int,
               pair_capacity: int, tile_capacity: int,
               opacities: torch.Tensor | None = None,
               packed_capacity: int | None = None,
               grad_index: bool = False,
               attr_rows: torch.Tensor | None = None,
               tile_shards: int = 1) -> TileBins:
    """Per-tile depth-sorted splat lists (see the module docstring).

    ``opacities`` ([N], values) enables the exact-zero pair cull;
    ``attr_rows`` ([10, N] float32: mean2d x/y, conic a/b/c, opacity,
    depth, r, g, b) builds the blend slab; ``grad_index`` adds the JAX
    package's gradient-reduction index. ``tile_shards`` > 1, when it
    divides the tile count, deals the occupancy order over that many
    strips of positions (ops/tiles.py:555-561).
    """
    gx, gy = tile_grid(W, H, tile)
    num_tiles = gx * gy
    n = proj.mean2d.shape[0]
    dev = proj.mean2d.device
    if packed_capacity is None:
        packed_capacity = pair_capacity
    i32 = dict(dtype=torch.int32, device=dev)
    if n == 0:
        zero = torch.zeros((), **i32)
        return TileBins(
            num_pairs=zero, pair_overflow=zero, tile_overflow=zero,
            gauss_sorted=torch.zeros(packed_capacity, **i32),
            tile_sorted=torch.full((packed_capacity,), num_tiles, **i32),
            t_start=torch.zeros(num_tiles, **i32),
            counts=torch.zeros(num_tiles, **i32),
            num_packed=zero, packed_overflow=zero)

    args = pair_kernel_inputs(proj, W, H, tile, pair_capacity, opacities)
    kbits = args["kbits"]
    keyi, gauss_o = expand_pairs(**args)
    starts_full = args["starts_full"]
    total = starts_full[n]

    tids = torch.arange(num_tiles, **i32)
    if args["packed_key"]:
        key_s, idx = torch.sort(keyi)                     # unique keys
        gauss_s = gauss_o[idx][:packed_capacity]
        eslot_s = key_s & ((1 << kbits) - 1)
        tile_full = key_s >> kbits
        key_s = key_s[:packed_capacity]
        probes = (torch.arange(num_tiles + 1, **i32) << kbits)
        bounds = torch.searchsorted(key_s, probes, side='left')
    else:
        # (tile, slot) does not fit one 31-bit key: the same lexicographic
        # order from one int64 key
        k = torch.arange(pair_capacity, dtype=torch.int64, device=dev)
        key_s, idx = torch.sort((keyi.long() << 32) | k)
        gauss_s = gauss_o[idx][:packed_capacity]
        eslot_s = (key_s & 0xFFFFFFFF).to(torch.int32)
        tile_full = (key_s >> 32).to(torch.int32)
        bounds = torch.searchsorted(tile_full[:packed_capacity].contiguous(),
                                    torch.arange(num_tiles + 1, **i32),
                                    side='left')
    tile_s = tile_full[:packed_capacity]
    bounds = bounds.to(torch.int32)
    t_start = bounds[:num_tiles]
    t_end = bounds[1:]
    counts = t_end - t_start
    num_packed = torch.sum(tile_full < num_tiles).to(torch.int32)

    perm = pos = slab = src_lane = starts_by_id = ends_by_id = None
    if grad_index or attr_rows is not None:
        # occupancy order of the tile grid (descending count, stable)
        counts_cl = torch.clamp(counts, max=tile_capacity)
        perm = torch.sort(-counts_cl, stable=True).indices.to(torch.int32)
        if tile_shards > 1 and num_tiles % tile_shards == 0:
            # position q of strip d = q // L holds occupancy rank
            # (q % L) * S + d: every strip an equal share of heavy tiles,
            # each internally occupancy-sorted
            L = num_tiles // tile_shards
            rank_of_pos = (tids % L) * tile_shards + tids // L
            perm = perm[rank_of_pos.long()]
        else:
            tile_shards = 1
        pos = torch.empty_like(perm)
        pos[perm.long()] = tids
    if grad_index:
        # sorted position p of tile t, slot s -> lane s * T + pos[t] of the
        # backward kernel's flat buffer, carried back to emission order
        pfull = torch.arange(pair_capacity, **i32)
        live_p = (pfull < packed_capacity) & (tile_full < num_tiles)
        tcl = torch.clamp(tile_full, max=num_tiles - 1).long()
        slotp = pfull - t_start[tcl]
        okp = live_p & (slotp >= 0) & (slotp < tile_capacity)
        src_of_p = torch.where(okp, slotp * num_tiles + pos[tcl],
                               tile_capacity * num_tiles).to(torch.int32)
        src_lane = torch.empty(pair_capacity, **i32)
        src_lane[eslot_s.long()] = src_of_p
        order = args["order"].long()
        starts_by_id = torch.empty(n, **i32)
        starts_by_id[order] = starts_full[:n]
        ends_by_id = torch.empty(n, **i32)
        ends_by_id[order] = starts_full[1:]
    if attr_rows is not None:
        asT = sorted_attr_table(attr_rows, gauss_s, tile_capacity)
        slab = expand_slab(asT, t_start[perm.long()].contiguous(),
                           tile_capacity)

    zero = torch.zeros((), **i32)
    return TileBins(
        num_pairs=total.to(torch.int32),
        pair_overflow=torch.maximum(total - pair_capacity, zero),
        tile_overflow=torch.sum(
            torch.clamp(counts - tile_capacity, min=0)).to(torch.int32),
        gauss_sorted=gauss_s, tile_sorted=tile_s, t_start=t_start,
        counts=torch.clamp(counts, max=tile_capacity),
        num_packed=num_packed,
        packed_overflow=torch.maximum(num_packed - packed_capacity, zero),
        perm=perm, pos=pos, slab=slab, src_lane=src_lane,
        starts_by_id=starts_by_id, ends_by_id=ends_by_id,
        tile_shards=tile_shards if perm is not None else 1)

"""K3: pair expansion (CUDA ``csrc/pairs.cu``) and its plain version.

Replaces the TPU kernel ``bloomscene_tpu/ops/pallas/pairs.py::_pairs_kernel``.
For every pair slot k it finds the owning depth rank, the tile inside the
rank's rectangle, applies the exact-zero cull, and emits the tile-sort key
(``(tile << kbits) | k`` when ``packed_key``, else the tile id) and the
Gaussian id. The plain version is the JAX package's XLA chain
(``bloomscene_tpu/ops/tiles.py:375-483``): marker scatter + running max
for the rank, the float-reciprocal division, the cull in the same float32
order. Both give bitwise the same keys and ids.
"""
from __future__ import annotations

import ctypes

import torch

from .build import check, library, require, stream_ptr

CULL_MARGIN = 1e-3      # tiles.py:474 (the TPU kernel's 0.02 absorbed bf16)

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
             + [ctypes.c_void_p] * 3)


def expand_pairs(starts_full: torch.Tensor, x0: torch.Tensor,
                 y0: torch.Tensor, w: torch.Tensor, order: torch.Tensor,
                 atab: torch.Tensor | None, pair_capacity: int, gx: int,
                 tile: int, kbits: int, num_tiles: int, packed_key: bool
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Rank table -> (key [pair_capacity] int32, gauss [pair_capacity] int32).

    ``starts_full`` [n+1] int32: exclusive cumsum of the tiles touched per
    depth rank, with the total appended (not clamped). ``x0``, ``y0``,
    ``w`` [n] int32: rect origin and width per rank; ``order`` [n] int32:
    the Gaussian id per rank; ``atab`` [6, n] float32 (mx, my, conic a, b,
    c, ln(255 opacity)) per rank, or None for no cull.
    """
    if starts_full.device.type == "cpu":
        return expand_pairs_plain(starts_full, x0, y0, w, order, atab,
                                  pair_capacity, gx, tile, kbits, num_tiles,
                                  packed_key)
    dev = starts_full.device
    n = x0.shape[0]
    if n == 0:
        raise ValueError("expand_pairs: no ranks (n == 0)")
    require(starts_full, torch.int32, (n + 1,), "starts_full", dev)
    for name, t in (("x0", x0), ("y0", y0), ("w", w), ("order", order)):
        require(t, torch.int32, (n,), name, dev)
    if atab is not None:
        require(atab, torch.float32, (6, n), "atab", dev)
    key = torch.empty(pair_capacity, dtype=torch.int32, device=dev)
    gauss = torch.empty(pair_capacity, dtype=torch.int32, device=dev)
    lib = library("pairs")
    fn = lib.bs_expand_pairs
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    check(fn(starts_full.data_ptr(), x0.data_ptr(), y0.data_ptr(),
             w.data_ptr(), order.data_ptr(),
             0 if atab is None else atab.data_ptr(), n, pair_capacity, gx,
             tile, kbits, num_tiles, int(packed_key), int(atab is not None),
             key.data_ptr(), gauss.data_ptr(), stream_ptr(dev)),
          "expand_pairs")
    expand_pairs.launches += 1
    return key, gauss


expand_pairs.launches = 0


def expand_pairs_plain(starts_full, x0, y0, w, order, atab, pair_capacity,
                       gx, tile, kbits, num_tiles, packed_key):
    """The XLA pair chain of tiles.py:375-483, in torch."""
    n = x0.shape[0]
    dev = x0.device
    P = pair_capacity
    starts = starts_full[:n].long()
    total = starts_full[n].long()
    touched = (starts_full[1:] - starts_full[:n]).long()
    # slot -> owning rank: a marker (rank + 1) at each live rank's start
    # slot and a running max; slots before the first marker take rank 0
    rid = torch.arange(n, device=dev)
    slot = torch.where(touched > 0, starts, P + rid)
    keep = slot < P
    markers = torch.zeros(P, dtype=torch.int64, device=dev)
    markers[slot[keep]] = rid[keep] + 1
    rank = torch.clamp(torch.cummax(markers, 0).values - 1, min=0)

    k = torch.arange(P, dtype=torch.int64, device=dev)
    p_w = w.long()[rank]
    local = k - starts[rank]
    # local // w by the exact float-reciprocal trick (tiles.py:432-439)
    q = torch.floor(local.float() * (1.0 / p_w.float())
                    + 0.0009765625).long()
    tx = x0.long()[rank] + (local - q * p_w)
    ty = y0.long()[rank] + q
    pair_live = k < total
    if atab is not None:
        mx, my, ca, cb, cc, ln_t = atab[:, rank]
        ftile = float(tile)
        lox = tx.float() * ftile - mx
        hix = lox + (ftile - 1.0)
        loy = ty.float() * ftile - my
        hiy = loy + (ftile - 1.0)

        def qq(dx, dy):
            return 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy

        def clip(v, lo, hi):
            return torch.minimum(torch.maximum(v, lo), hi)

        def edge_x(dx):
            return qq(dx, clip(-cb * dx / cc, loy, hiy))

        def edge_y(dy):
            return qq(clip(-cb * dy / ca, lox, hix), dy)

        qmin = torch.minimum(torch.minimum(edge_x(lox), edge_x(hix)),
                             torch.minimum(edge_y(loy), edge_y(hiy)))
        inside = (lox <= 0) & (hix >= 0) & (loy <= 0) & (hiy >= 0)
        qmin = torch.where(inside, 0.0, qmin)
        pair_live = pair_live & (qmin <= ln_t + CULL_MARGIN)
    tile_id = torch.where(pair_live, ty * gx + tx, num_tiles)
    key = (tile_id << kbits) | k if packed_key else tile_id
    return key.to(torch.int32), order[rank].to(torch.int32)

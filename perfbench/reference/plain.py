"""The plain versions of the program's hand-written kernels, which the
reference's copies of its modules call in their place: the pair expansion
(K3) and the slab expansion (K4) as the program's plain torch chains, the
row sums of a gather's backward and of the hash grid's backward as
``index_add``, and a cache of small constant tensors."""
from __future__ import annotations

import numpy as np
import torch

CULL_MARGIN = 1e-3      # the exact-zero cull's margin in the pair expansion

_CONSTANTS: dict = {}


def device_constant(values: np.ndarray, device) -> torch.Tensor:
    """``torch.as_tensor(values, device=device)``, made once and kept."""
    arr = np.ascontiguousarray(values)
    key = (arr.dtype.str, arr.shape, arr.tobytes(), str(torch.device(device)))
    out = _CONSTANTS.get(key)
    if out is None:
        out = _CONSTANTS[key] = torch.from_numpy(arr.copy()).to(device)
    return out


def gather_rows_bwd(grads, idx, n_rows, bases=None) -> tuple:
    """Each [V, k] cotangent summed by row ``idx`` into [n_rows, k] (onto
    ``bases`` where given)."""
    if bases is None:
        bases = [torch.zeros((n_rows, g.shape[1]), dtype=g.dtype,
                             device=g.device) for g in grads]
    return tuple(b.index_add(0, idx, g) for b, g in zip(bases, grads))


def grid_scatter(rows, idx, n_cells):
    """The hash grid's gather transposed: rows summed by table cell."""
    out = torch.zeros((n_cells, rows.shape[1]), dtype=rows.dtype,
                      device=rows.device)
    return out.index_add_(0, idx, rows)


def slab_index(t_start_p: torch.Tensor, width: int, cap: int) -> torch.Tensor:
    """The [cap * T] column index of the expansion, slot-major."""
    slot = torch.arange(cap, dtype=torch.int64, device=t_start_p.device)
    return (torch.clamp(t_start_p.long(), max=width - cap)[None, :]
            + slot[:, None]).reshape(-1)


def expand_slab(asT, t_start_p, cap):
    """asT [R, width] -> slab [R, cap, T]: each position's cap columns."""
    R, width = asT.shape
    idx = slab_index(t_start_p, width, cap)
    return torch.index_select(asT, 1, idx).reshape(R, cap, -1)


def expand_pairs(starts_full, x0, y0, w, order, atab, pair_capacity,
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

"""K1 blend forward (CUDA ``csrc/blend.cu``) and K2 blend backward (CUDA
``csrc/blend_bwd.cu``), each beside its plain version.

K1 replaces the TPU kernel ``bloomscene_tpu/ops/pallas/blend.py::_fwd_kernel``:
front-to-back blend of each tile (at slab position p, tile id tid[p]) over
its depth-sorted slab column, with the reference's per-pixel rules
(power > 0 skip, alpha = min(0.99, op e^power), alpha < 1/255 skip, sticky
stop at T (1 - alpha) < 1e-4 without blending that splat).

K2 replaces ``blend.py::_bwd_kernel``: the back-to-front walk from final T
with the 5-carry suffix-sum recurrence, writing per-entry gradients
[10, cap, T] (see ``csrc/blend_bwd.cu`` for the arithmetic).

Both kernels run two adjacent pixels a thread and take any tile, as the
JAX package's blend does. Up to tile 32 a tile is one block; above it a
tile is split into blocks of at most 1,024 pixels (512 threads, which
``__launch_bounds__`` keeps K2's state in registers for), and K2 adds the
blocks' per-slot sums in a second kernel, in block order (see the
sources' notes for the designs and for tiles whose pixel count is not a
multiple of 64). The plain versions run the same per-slot recurrences
over all pixels of all tiles at once, as the TPU kernels do.

Both take a strip of positions ``[p0, p0 + n)`` (the tile-parallel render,
``ops/cuda/wrapper.py``): the kernels read the whole slab and, for K2, the
whole [P, T] planes in place and write only the strip's columns, which
equal the full call's bit for bit, since no tile's blend or sums read
another tile. The plain versions keep that property on the CPU too: a
strip's pixel sums are taken at the strip's own columns of a [P, T]
buffer (``_pixel_sums``: the CPU's sum over the pixel axis adds a column
in an order that depends on its place in T), and K2 writes exact zeros
past each tile's walk, as the kernel does. Where that order does not
depend on the place (T below 16 or a multiple of 16, as at 64x64 and
512x512 with 16-pixel tiles), the plain K2 of a tile is the same bits at
any position, so a tile-parallel render, whose positions are dealt over
the strips, is the one-process render bit for bit on the CPU too.
"""
from __future__ import annotations

from typing import Iterator, NamedTuple

import torch

from .reference_rasterizer import ACC_SEED, ALPHA_MAX, ALPHA_MIN, T_EPS

DATA_W = 10      # slab rows: mx, my, ca, cb, cc, op, depth, r, g, b
GRAD_W = 10      # gradient rows: d mx, my, ca, cb, cc, op, depth, r, g, b

def check_tile(tile: int) -> int:
    """tile*tile, the pixels of one tile (an int32 count)."""
    if tile < 1 or tile * tile >= 2 ** 31:
        raise ValueError(f"tile {tile}: the blend kernels take tiles of 1 "
                         f"pixel and up whose pixel count fits 31 bits")
    return tile * tile


def strip(T: int, p0: int, n: int | None) -> int:
    """The positions of the strip [p0, p0 + n) of T (n None: to the end),
    checked to lie in [0, T)."""
    n = T - p0 if n is None else n
    if p0 < 0 or n < 0 or p0 + n > T:
        raise ValueError(f"positions [{p0}, {p0 + n}) outside [0, {T})")
    return n


def pixel_coords(tid: torch.Tensor, tile: int, gx: int):
    """px, py [tile*tile, T] float32 for the tiles named by ``tid``."""
    sp = torch.arange(tile * tile, device=tid.device)[:, None]
    t = tid.long()[None, :]
    px = ((t % gx) * tile + sp % tile).float()
    py = ((t // gx) * tile + sp // tile).float()
    return px, py


class ForwardSlot(NamedTuple):
    """One slot s of K1's front-to-back walk, over all pixels [P, T]."""
    s: int
    rows: torch.Tensor      # slab[:, s, :], [10, T]
    power: torch.Tensor
    alpha: torch.Tensor     # min(0.99, op e^power)
    visit: torch.Tensor     # s < the tile's count and the pixel not stopped
    blend: torch.Tensor     # visited, blendable and not the stopping splat
    T: torch.Tensor         # transmittance before the slot
    T_next: torch.Tensor    # and after it


def forward_slots(slab, counts_p, tid, tile, gx) -> Iterator[ForwardSlot]:
    """K1's per-pixel rules, slot by slot, over every pixel of every tile at
    once (the plain version's walk; profile_blend.py counts its work)."""
    T = slab.shape[2]
    px, py = pixel_coords(tid, tile, gx)
    Tr = torch.ones((tile * tile, T), dtype=torch.float32, device=slab.device)
    done = torch.zeros(Tr.shape, dtype=torch.bool, device=slab.device)
    n_slots = int(counts_p.max()) if T else 0
    for s in range(n_slots):
        rows = slab[:, s, :]
        mx, my, ca, cb, cc, op = rows[:6]
        dx = mx - px
        dy = my - py
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        alpha = torch.clamp(op * torch.exp(power), max=ALPHA_MAX)
        visit = (s < counts_p) & ~done
        ok = visit & (power <= 0.0) & (alpha >= ALPHA_MIN)
        test_T = Tr * (1.0 - alpha)
        term = ok & (test_T < T_EPS)
        blend = ok & ~term
        done = done | term
        T_next = torch.where(blend, test_T, Tr)
        yield ForwardSlot(s, rows, power, alpha, visit, blend, Tr, T_next)
        Tr = T_next


def columns(p0: int, n: int, *tensors):
    """Each tensor's positions [p0, p0 + n) along its last axis (views)."""
    return tuple(t[..., p0:p0 + n] for t in tensors)


def blend_forward_plain(slab, counts_p, tid, tile, gx, p0: int = 0,
                        n: int | None = None):
    n = strip(slab.shape[2], p0, n)
    slab, counts_p, tid = columns(p0, n, slab, counts_p, tid)
    P, T = tile * tile, n
    dev = slab.device
    Tr = torch.ones((P, T), dtype=torch.float32, device=dev)
    Cr, Cg, Cb, D = (torch.zeros((P, T), dtype=torch.float32, device=dev)
                     for _ in range(4))
    acc = torch.full((P, T), ACC_SEED, dtype=torch.float32, device=dev)
    ncon = torch.zeros((P, T), dtype=torch.int32, device=dev)
    for st in forward_slots(slab, counts_p, tid, tile, gx):
        de, cr, cg, cbl = st.rows[6:]
        w = torch.where(st.blend, st.alpha * st.T, 0.0)
        Cr = Cr + w * cr
        Cg = Cg + w * cg
        Cb = Cb + w * cbl
        D = D + w * de
        acc = acc + w
        Tr = st.T_next
        ncon = torch.where(st.blend, st.s + 1, ncon)
    return Cr, Cg, Cb, D, acc, Tr, ncon


def blend_walk(counts_p: torch.Tensor, ncon: torch.Tensor) -> torch.Tensor:
    """[T] slots K2 walks per tile: min(count, max n_contrib of its pixels)."""
    return torch.minimum(counts_p, ncon.amax(0))


def _pixel_sums(terms, p0: int, T: int) -> list:
    """Each [P, n] term of the strip [p0, p0 + n) of T positions summed over
    its pixels -> [n] each, every column reduced where the full call
    reduces it: at its own place in a [P, T] buffer."""
    n = terms[0].shape[1]
    if n == T:
        return [x.sum(0) for x in terms]
    out = []
    for x in terms:
        buf = x.new_zeros((x.shape[0], T))
        buf[:, p0:p0 + n] = x
        out.append(buf.sum(0)[p0:p0 + n])
    return out


def blend_backward_plain(slab, counts_p, tid, tile, gx, final_T, ncon, u_r,
                         u_g, u_b, u_d, u_one, bg_term, magnitude=False,
                         p0: int = 0, n: int | None = None):
    """K2's plain version. ``magnitude=True`` gives, for each entry, the
    same row with every pixel term and every factor taken by its absolute
    value: the scale of the float32 rounding of a sum of those terms in
    another order."""
    T_full = slab.shape[2]
    n = strip(T_full, p0, n)
    (slab, counts_p, tid, final_T, ncon, u_r, u_g, u_b, u_d, u_one,
     bg_term) = columns(p0, n, slab, counts_p, tid, final_T, ncon, u_r, u_g,
                        u_b, u_d, u_one, bg_term)
    _, cap, T = slab.shape
    px, py = pixel_coords(tid, tile, gx)
    grad = torch.zeros((GRAD_W, cap, T), dtype=torch.float32,
                       device=slab.device)
    walk = blend_walk(counts_p, ncon)
    n_walk = int(walk.max()) if T else 0
    Tr = final_T
    Sr = Sg = Sb = Sd = S1 = torch.zeros_like(final_T)
    tb = -final_T * bg_term
    for s in reversed(range(n_walk)):
        mx, my, ca, cb, cc, op, de, cr, cg, cbl = slab[:, s, :]
        dx = mx - px
        dy = my - py
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        G = torch.exp(power)
        oG = op * G
        alpha = torch.clamp(oG, max=ALPHA_MAX)
        blended = (power <= 0.0) & (alpha >= ALPHA_MIN) & (s < ncon)
        inv1ma = 1.0 / (1.0 - alpha)
        Tr = torch.where(blended, Tr * inv1ma, Tr)
        w = torch.where(blended, alpha * Tr, 0.0)
        Q = u_r * Sr + u_g * Sg + u_b * Sb + u_d * Sd + u_one * S1
        dL_da = (Tr * (u_r * cr + u_g * cg + u_b * cbl + u_d * de + u_one)
                 + (tb - Q) * inv1ma)
        dL_da = torch.where(blended, dL_da, 0.0)
        Sr = Sr + w * cr
        Sg = Sg + w * cg
        Sb = Sb + w * cbl
        Sd = Sd + w * de
        S1 = S1 + w
        h = torch.where(oG < ALPHA_MAX, G, 0.0) * dL_da
        hdx = h * dx
        hdy = h * dy
        terms = (h, hdx, hdy, hdx * dx, hdx * dy, hdy * dy, w * u_d, w * u_r,
                 w * u_g, w * u_b)
        if magnitude:
            terms = [x.abs() for x in terms]
            op, ca, cb, cc = op.abs(), ca.abs(), cb.abs(), cc.abs()
        m0, m1, m2, m3, m4, m5, sd, sr, sg, sb = _pixel_sums(terms, p0,
                                                             T_full)
        # a tile's rows at or past its walk stay exact zeros, as K2 leaves
        # them
        grad[:, s, :] = torch.where(s < walk, torch.stack([
            -op * (ca * m1 + cb * m2), -op * (cc * m2 + cb * m1),
            -0.5 * op * m3, -op * m4, -0.5 * op * m5, m0, sd, sr, sg, sb], 0),
            0.0)
    return grad.abs() if magnitude else grad


blend_forward = blend_forward_plain


def blend_backward(slab, counts_p, tid, tile, gx, final_T, ncon, u_r, u_g,
                   u_b, u_d, u_one, bg_term, p0: int = 0,
                   n: int | None = None):
    return blend_backward_plain(slab, counts_p, tid, tile, gx, final_T, ncon,
                                u_r, u_g, u_b, u_d, u_one, bg_term, p0=p0,
                                n=n)

"""Ring render: splats depth-sliced over the ranks, pixel strips passed
around the ring (the port of ``bloomscene_tpu/parallel/ring.py``).

The splats are sorted by depth once and cut into one contiguous slice a
rank of the ring's axis (D ranks); the image is cut into D horizontal
strips. Each strip's blend accumulators travel the ring: at every hop the
resident rank composites its slice over the strip visiting it and sends
the strip on, so after D hops every strip has seen every slice while each
slice stayed on its rank; a hop moves O(pixels / D) whatever the splat
count.

Front-to-back blending is the associative but not commutative "over"
operator (C1, T1) + (C2, T2) = (C1 + T1 C2, T1 T2). A strip that starts
at rank b visits slices b .. D-1 and then 0 .. b-1: two runs each in
depth order. So a strip carries two partial composites, head (slices
0 .. b-1) and tail (slices b .. D-1), folds each hop's slice into the one
it belongs to, and its owner composites head over tail after the last
hop. Depth (D += d alpha T) and alpha (acc += alpha T) fold the same way.

The reference blend stops a pixel where T would fall below 1e-4, which
depends on the global prefix of transmittance that a slice cannot see;
this blend has no stop, so it equals the golden model wherever no pixel's
transmittance falls below 1e-4 (ring.py:24-31).

The backward: each hop is a ``torch.autograd.Function`` whose forward
sends to the next rank and receives from the previous one and whose
backward sends the cotangents the other way (``ppermute``'s transpose is
the inverse permutation), so the cotangents travel the ring backwards
while each rank back-blends its own slice, and a splat's gradient is
computed on its own rank. The slicing's backward all-gathers the slices'
gradients, so every rank ends with the whole gradient, as JAX's global
arrays have it.

``_slice_blend`` is plain torch, as it is plain ``jnp`` in JAX (no Pallas
kernel): vectorized over the strip's pixels, a loop over the slice's
splats.
"""
from __future__ import annotations

import torch

from ..ops.projection import ProjectedSplats
from ..ops.reference_rasterizer import ACC_GATE, ACC_SEED, ALPHA_MAX, ALPHA_MIN
from .mesh import AxisGroup


class _Shift(torch.autograd.Function):
    """Send to the next rank, receive from the previous; the backward the
    other way."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis.shift(x, 1)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.shift(g.contiguous(), -1), None


class _Slice(torch.autograd.Function):
    """A replicated [n, ...] tensor -> this rank's chunk of n / D rows; the
    backward gathers every chunk's gradient, so each rank holds the whole
    gradient."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        m = x.shape[0] // axis.size
        return x[axis.index * m:(axis.index + 1) * m].clone()

    @staticmethod
    def backward(ctx, g):
        return torch.cat(ctx.axis.all_gather(g.contiguous()), 0), None


class _Gather(torch.autograd.Function):
    """This rank's strip -> every rank's strips along the leading axis; the
    backward takes this rank's strip of the cotangent (the loss built on the
    gathered image is the same on every rank)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis, ctx.rows = axis, x.shape[0]
        return torch.cat(axis.all_gather(x.contiguous()), 0)

    @staticmethod
    def backward(ctx, g):
        i, h = ctx.axis.index, ctx.rows
        return g[i * h:(i + 1) * h], None


class _Replicated(torch.autograd.Function):
    """The identity on a tensor every rank holds; the backward sums its
    gradient over the ranks, each of which used it on its own strip."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_reduce(g.clone()), None


def _slice_blend(rows, valid, pxg, pyg):
    """Front-to-back blend of one depth slice ([m, 10] rows: mean2d x/y,
    conic a/b/c, depth, r, g, b, opacity; ``valid`` [m]) over one pixel
    strip from a fresh carry (T = 1), no early termination, no
    background: the slice's over-operands C [h, w, 3], T, D and acc
    [h, w] (acc without the 1e-6 seed; ring.py:66-103)."""
    h, w = pxg.shape
    T = torch.ones((h, w), dtype=torch.float32, device=rows.device)
    C = torch.zeros((h, w, 3), dtype=torch.float32, device=rows.device)
    D = torch.zeros((h, w), dtype=torch.float32, device=rows.device)
    acc = torch.zeros((h, w), dtype=torch.float32, device=rows.device)
    for r, val in zip(rows.unbind(0), valid.unbind(0)):
        mx, my, ca, cb, cc, dep, op = r[0], r[1], r[2], r[3], r[4], r[5], r[9]
        dx = mx - pxg
        dy = my - pyg
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        alpha = torch.clamp(op * torch.exp(power), max=ALPHA_MAX)
        blend = val & (power <= 0.0) & (alpha >= ALPHA_MIN)
        wt = torch.where(blend, alpha * T, 0.0)
        C = C + wt[..., None] * r[6:9]
        D = D + wt * dep
        acc = acc + wt
        T = torch.where(blend, T * (1.0 - alpha), T)
    return C, T, D, acc


def _over(a, b):
    """Partial b composited behind partial a."""
    Ca, Ta, Da, aa = a
    Cb, Tb, Db, ab = b
    return Ca + Ta[..., None] * Cb, Ta * Tb, Da + Ta * Db, aa + Ta * ab


def _pack(part) -> torch.Tensor:
    C, T, D, acc = part
    return torch.cat([C, T[..., None], D[..., None], acc[..., None]], -1)


def _unpack(x: torch.Tensor):
    return x[..., 0:3], x[..., 3], x[..., 4], x[..., 5]


def ring_render(proj: ProjectedSplats, colors: torch.Tensor,
                opacities: torch.Tensor, bg: torch.Tensor, W: int, H: int,
                group: AxisGroup) -> tuple[torch.Tensor, torch.Tensor]:
    """Render one view with the splats depth-sliced and the pixel strips
    ringed over ``group`` (an axis of ``parallel.mesh.Mesh``; every rank
    of it calls this on the same inputs). Returns (color [H, W, 3], depth
    [H, W]) on every rank, differentiable in ``proj``'s mean2d, conic and
    depth, ``colors``, ``opacities`` and ``bg`` (ring.py:132-192). ``H``
    and the splat count must divide by the ring's size."""
    D, d = group.size, group.index
    n = proj.mean2d.shape[0]
    if H % D or n % D:
        raise ValueError(
            f"H={H} and n={n} must be divisible by the ring size {D}")
    hs = H // D
    dev = proj.mean2d.device

    # the global depth order, then this rank's contiguous slice
    key = torch.where(proj.valid, proj.depth, torch.inf)
    order = torch.sort(key, stable=True).indices
    rows = torch.cat([proj.mean2d, proj.conic, proj.depth[:, None], colors,
                      opacities[:, None]], 1)[order]
    m = n // D
    rows = _Slice.apply(rows, group)
    valid = proj.valid[order][d * m:(d + 1) * m]

    px = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    state = _pack((torch.zeros((hs, W, 3), device=dev),
                   torch.ones((hs, W), device=dev),
                   torch.zeros((hs, W), device=dev),
                   torch.zeros((hs, W), device=dev)))
    state = torch.cat([state, state], -1)           # head | tail
    for r in range(D):
        b = (d - r) % D                             # the strip visiting
        py = (b * hs + torch.arange(hs, dtype=torch.float32,
                                    device=dev))[:, None]
        part = _slice_blend(rows, valid, px.expand(hs, W), py.expand(hs, W))
        head, tail = _unpack(state[..., :6]), _unpack(state[..., 6:])
        # slice d belongs to the strip's head iff it precedes the strip's
        # first slice b
        if d < b:
            head = _over(head, part)
        else:
            tail = _over(tail, part)
        state = _Shift.apply(torch.cat([_pack(head), _pack(tail)], -1),
                             group)
    # after D hops strip d is home
    C, T, Dp, acc = _over(_unpack(state[..., :6]), _unpack(state[..., 6:]))
    color = C + T[..., None] * _Replicated.apply(bg, group)
    acc = acc + ACC_SEED
    depth = torch.where(acc > ACC_GATE, Dp / acc, 0.0)
    out = _Gather.apply(torch.cat([color, depth[..., None]], -1), group)
    return out[..., :3], out[..., 3]

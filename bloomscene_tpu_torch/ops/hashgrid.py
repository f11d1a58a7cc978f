"""Multi-resolution hash-grid encoder (HAC variant), differentiable.

The conventions of the reference gridencoder (gridencoder.cu:100-360) as
the JAX package implements them:

- explicit per-level resolution list;
- position mapping ``pos = x * (R - 2) + 0.5``;
- corner coords clamped to R-1; corners on the boundary ring (coordinate 0
  or R-1) are excluded and the remaining weights renormalized;
- dense row-major indexing while R^d fits the level's (8-padded) table,
  otherwise the XOR-prime hash, then modulo the table size;
- inputs outside [0, 1] encode to zeros;
- one flat table per encoder, binarized (sign) on every forward.

The hash multiplies and XORs in uint32 with wraparound. torch has no
uint32 arithmetic, so the index is formed in int64 and masked to 32 bits
after every multiply, before the modulo. Autograd carries the gradient
into the tables (through the sign's straight-through rule and the corner
gathers' scatter-add) and into ``x`` (through the corner weights), as JAX
autodiff does. All of an encoder's corner gathers (every level and
corner) are one ``index_select`` of the flat table, whose backward is
``ops/cuda/hashgrid_bwd.py::grid_scatter``: on the card a kernel that
adds each cell's entries in a fixed order, so two identical steps give
the same table gradients; on the CPU ``index_add_``.

On the card ``mix_encode`` is one hand-written kernel instead
(``ops/cuda/hashgrid_encode.py``, ``_MixEncode``): the forward writes all
four encoders' features in one launch, bitwise the eager code; the backward
writes every corner's cotangent row and table index, bitwise the rows the
eager path's autograd hands ``grid_scatter``, and the gradient to ``x``.
On the CPU ``mix_encode`` is the eager code, the kernel's plain version.
``mix_encode_backward_plain`` is the backward kernel's arithmetic in its
order, in torch: the rows are autograd's ops (``where``, ``/``, ``*``); the
gradient to ``x`` is autograd's chain of products, summed in the order
autograd's engine accumulates it (below), and each sum over the F
features of a corner in CUDA's order for a reduction of F contiguous
floats (``_feature_sum``).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..utils.profiling import span
from .cuda.hashgrid_bwd import grid_scatter
from .cuda.hashgrid_encode import hashgrid_encode, hashgrid_encode_bwd
from .quantization import ste_binary

_PRIMES = (1, 2654435761, 805459861, 3674653429, 2097192037, 1434869437,
           2165219737)
_U32 = 0xFFFFFFFF


def _level_table_size(resolution: int, num_dim: int,
                      log2_hashmap_size: int) -> int:
    max_params = 2 ** log2_hashmap_size
    params = min(max_params, resolution ** num_dim)
    return int(np.ceil(params / 8) * 8)        # 8-padded, encodings.py:384


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static configuration of one hash-grid encoder."""
    num_dim: int
    n_features: int
    resolutions: Tuple[int, ...]
    log2_hashmap_size: int
    ste_binary: bool = True

    @property
    def level_sizes(self) -> Tuple[int, ...]:
        return tuple(_level_table_size(r, self.num_dim,
                                       self.log2_hashmap_size)
                     for r in self.resolutions)

    @property
    def offsets(self) -> Tuple[int, ...]:
        offs = [0]
        for s in self.level_sizes:
            offs.append(offs[-1] + s)
        return tuple(offs)

    @property
    def n_params(self) -> int:
        return self.offsets[-1]

    @property
    def output_dim(self) -> int:
        return len(self.resolutions) * self.n_features


def init_grid_params(spec: GridSpec, generator: torch.Generator,
                     device: torch.device, std: float = 1e-4
                     ) -> torch.Tensor:
    """Uniform(-std, std) flat table [n_params * F] (encodings.py:401-403)."""
    u = torch.rand(spec.n_params * spec.n_features, generator=generator,
                   dtype=torch.float32)
    return ((u * 2.0 - 1.0) * std).to(device)


def _corner_index(coords: torch.Tensor, resolution: int, table_size: int,
                  num_dim: int) -> torch.Tensor:
    """coords [N, d] int64 in [0, R-1] -> flat table index [N] int64."""
    idx = torch.zeros(coords.shape[:-1], dtype=torch.int64,
                      device=coords.device)
    if resolution ** num_dim <= table_size:
        stride = 1
        for d in range(num_dim):
            idx = (idx + coords[..., d] * stride) & _U32
            stride *= resolution
    else:
        for d in range(num_dim):
            idx = idx ^ ((coords[..., d] * _PRIMES[d]) & _U32)
    return idx % table_size


class _GridGather(torch.autograd.Function):
    """rows = emb.index_select(0, idx), with ``grid_scatter`` as the
    backward to ``emb``."""

    @staticmethod
    def forward(ctx, emb, idx):
        ctx.save_for_backward(idx)
        ctx.n_cells = emb.shape[0]
        return emb.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None
        (idx,) = ctx.saved_tensors
        return grid_scatter(g.contiguous(), idx, ctx.n_cells), None


def grid_encode(params: torch.Tensor, x: torch.Tensor,
                spec: GridSpec) -> torch.Tensor:
    """Encode x in [0,1]^d -> [N, n_levels * n_features]."""
    params = params.reshape(-1, spec.n_features)
    emb = ste_binary(params) if spec.ste_binary else params
    n = x.shape[0]
    in_bounds = torch.all((x >= 0.0) & (x <= 1.0), dim=-1)     # [N]

    # every level's corner cells and weights, then one gather of them all
    idx_all, wv_all = [], []
    offsets = spec.offsets
    for li, R in enumerate(spec.resolutions):
        table_size = spec.level_sizes[li]
        pos = x * (R - 2) + 0.5                                # [N, d]
        pos0f = torch.floor(pos)
        frac = pos - pos0f
        pos0 = pos0f.to(torch.int64)
        for corner in range(2 ** spec.num_dim):
            w = torch.ones((n,), dtype=torch.float32, device=x.device)
            coords = []
            for d in range(spec.num_dim):
                if (corner >> d) & 1:
                    w = w * frac[:, d]
                    coords.append(torch.clamp(pos0[:, d] + 1, max=R - 1))
                else:
                    w = w * (1.0 - frac[:, d])
                    coords.append(pos0[:, d])
            coords = torch.stack(coords, -1)                   # [N, d]
            on_ring = torch.any((coords == 0) | (coords == R - 1), dim=-1)
            idx_all.append(_corner_index(torch.clamp(coords, 0, R - 1), R,
                                         table_size, spec.num_dim)
                           + offsets[li])
            wv_all.append(torch.where(on_ring, 0.0, w))
    n_corners = 2 ** spec.num_dim
    idx = torch.stack(idx_all).reshape(-1)
    # one unbind: its backward stacks the corners' cotangents in one copy
    vals = _GridGather.apply(emb, idx).view(-1, n, spec.n_features).unbind(0)

    outs = []
    for li in range(len(spec.resolutions)):
        acc = torch.zeros((n, spec.n_features), dtype=torch.float32,
                          device=x.device)
        wn = torch.zeros((n, 1), dtype=torch.float32, device=x.device)
        for k in range(li * n_corners, (li + 1) * n_corners):
            acc = acc + wv_all[k][:, None] * vals[k]
            wn = wn + wv_all[k][:, None]
        outs.append(acc / (wn + 1e-9))

    out = torch.cat(outs, -1)                                  # [N, L*F]
    return torch.where(in_bounds[:, None], out, 0.0)


@dataclasses.dataclass(frozen=True)
class Mix3D2DSpec:
    """HAC's mixed 3D + three 2D-plane encoding (gaussian_model.py:39-105)."""
    n_features: int
    resolutions_3d: Tuple[int, ...]
    log2_hashmap_size_3d: int
    resolutions_2d: Tuple[int, ...]
    log2_hashmap_size_2d: int
    ste_binary: bool = True

    @property
    def spec_xyz(self) -> GridSpec:
        return GridSpec(3, self.n_features, tuple(self.resolutions_3d),
                        self.log2_hashmap_size_3d, self.ste_binary)

    @property
    def spec_2d(self) -> GridSpec:
        return GridSpec(2, self.n_features, tuple(self.resolutions_2d),
                        self.log2_hashmap_size_2d, self.ste_binary)

    @property
    def output_dim(self) -> int:
        return self.spec_xyz.output_dim + 3 * self.spec_2d.output_dim


def init_mix_params(spec: Mix3D2DSpec, generator: torch.Generator,
                    device: torch.device) -> dict:
    return {
        'xyz': init_grid_params(spec.spec_xyz, generator, device),
        'xy': init_grid_params(spec.spec_2d, generator, device),
        'xz': init_grid_params(spec.spec_2d, generator, device),
        'yz': init_grid_params(spec.spec_2d, generator, device),
    }


MIX_ENCODERS = ('xyz', 'xy', 'xz', 'yz')   # the output's order


def mix_parts(spec: Mix3D2DSpec) -> tuple:
    """The four encoders in output order: (name, GridSpec, the columns of x
    it reads); the first reads x itself."""
    return (('xyz', spec.spec_xyz, (0, 1, 2)), ('xy', spec.spec_2d, (0, 1)),
            ('xz', spec.spec_2d, (0, 2)), ('yz', spec.spec_2d, (1, 2)))


def mix_tables(params: dict, spec: Mix3D2DSpec) -> tuple:
    """The four encoders' [n_params, F] tables as the encode reads them
    (binarized when spec.ste_binary), in output order."""
    out = []
    for name in MIX_ENCODERS:
        t = params[name].reshape(-1, spec.n_features)
        out.append(ste_binary(t) if spec.ste_binary else t)
    return tuple(out)


class _MixEncode(torch.autograd.Function):
    """mix_encode on the card over the binarized tables: the forward kernel,
    and as the backward the backward kernel (each corner's cotangent row and
    table index, and the gradient to x), then ``grid_scatter`` on each
    table's rows, under the span ``hashgrid.backward``."""

    @staticmethod
    def forward(ctx, spec, x, *tables):
        ctx.spec = spec
        ctx.save_for_backward(x, *tables)
        return hashgrid_encode(x, tables, spec)

    @staticmethod
    def backward(ctx, g):
        x, *tables = ctx.saved_tensors
        with span("hashgrid.backward"):
            rows, idx, dx = hashgrid_encode_bwd(x, tables, g.contiguous(),
                                                ctx.spec)
            grads = [grid_scatter(r, i, t.shape[0]) if need else None
                     for r, i, t, need in zip(rows, idx, tables,
                                              ctx.needs_input_grad[2:])]
            return (None, dx, *grads)


def mix_encode(params: dict, x: torch.Tensor,
               spec: Mix3D2DSpec) -> torch.Tensor:
    """x [N,3] in [0,1] -> concat(xyz, xy, xz, yz) features: on the card
    the hash-grid kernel (``_MixEncode``; under no_grad, or with no input
    that needs a gradient, autograd keeps nothing of it), on the CPU the
    eager code."""
    if x.device.type == 'cpu':
        return mix_encode_plain(params, x, spec)
    return _MixEncode.apply(spec, x, *mix_tables(params, spec))


def mix_encode_plain(params: dict, x: torch.Tensor,
                     spec: Mix3D2DSpec) -> torch.Tensor:
    """mix_encode in eager torch on any device: the kernel's plain
    version."""
    out_xyz = grid_encode(params['xyz'], x, spec.spec_xyz)
    # slices, not list indices: a list index is copied to the card on
    # every call, which a CUDA graph cannot capture
    out_xy = grid_encode(params['xy'], x[:, 0:2], spec.spec_2d)
    out_xz = grid_encode(params['xz'], x[:, 0::2], spec.spec_2d)
    out_yz = grid_encode(params['yz'], x[:, 1:3], spec.spec_2d)
    return torch.cat([out_xyz, out_xy, out_xz, out_yz], -1)


def _feature_sum(t: torch.Tensor) -> torch.Tensor:
    """[N, F] -> [N]: the sum over the F features (a power of two) in the
    order of torch's CUDA reduction of F contiguous floats, the order of
    ``sum_to`` in the eager backward on the card: F lanes, then shuffles
    down at offsets F/2, F/4, ..., 1 ((t0 + t2) + (t1 + t3) at F = 4)."""
    cols = list(t.unbind(-1))
    off = len(cols) // 2
    while off:
        cols = [cols[i] + cols[i + off] for i in range(off)]
        off //= 2
    return cols[0]


def grid_encode_backward_plain(emb: torch.Tensor, x: torch.Tensor,
                               g: torch.Tensor, spec: GridSpec) -> tuple:
    """The backward kernel's arithmetic for one encoder, in torch and in its
    order: emb [n_params, F] the table as the encode reads it, x [N, d] the
    encoder's input, g [N, L*F] its output's cotangent -> (rows [L*2^d*N,
    F] and idx [L*2^d*N] int64, level-major, corner, row: the cotangents of
    the corner gathers, autograd's ops where(in_bounds, g, 0) / (wn + 1e-9)
    * w; each level's gradient to x [N, d])."""
    n, D, F = x.shape[0], spec.num_dim, spec.n_features
    in_bounds = torch.all((x >= 0.0) & (x <= 1.0), dim=-1)
    g = torch.where(in_bounds[:, None], g, 0.0)
    ones = torch.ones((n,), dtype=torch.float32, device=x.device)
    rows, idx, dx_levels = [], [], []
    for li, R in enumerate(spec.resolutions):
        pos = x * (R - 2) + 0.5
        pos0f = torch.floor(pos)
        frac = pos - pos0f
        pos0 = pos0f.to(torch.int64)
        acc = torch.zeros((n, F), dtype=torch.float32, device=x.device)
        wn = torch.zeros((n,), dtype=torch.float32, device=x.device)
        corners = []
        for corner in range(2 ** D):
            # the weight's factors and the products before each, from 1
            fs, before, coords = [], [ones], []
            for d in range(D):
                if (corner >> d) & 1:
                    fs.append(frac[:, d])
                    coords.append(torch.clamp(pos0[:, d] + 1, max=R - 1))
                else:
                    fs.append(1.0 - frac[:, d])
                    coords.append(pos0[:, d])
                before.append(before[-1] * fs[-1])
            coords = torch.stack(coords, -1)
            on_ring = torch.any((coords == 0) | (coords == R - 1), dim=-1)
            cell = (_corner_index(torch.clamp(coords, 0, R - 1), R,
                                  spec.level_sizes[li], D)
                    + spec.offsets[li])
            wv = torch.where(on_ring, 0.0, before[-1])
            v = emb[cell]
            acc = acc + wv[:, None] * v
            wn = wn + wv
            corners.append((fs, before, on_ring, cell, wv, v))
        gl = g[:, li * F:(li + 1) * F]
        den = (wn + 1e-9)[:, None]
        ga = gl / den
        g_den = _feature_sum(-gl * ((acc / den) / den))
        rows += [ga * c[4][:, None] for c in corners]
        idx += [c[3] for c in corners]
        # autograd's engine takes the later-created corner first
        gfrac = [None] * D
        for corner in reversed(range(2 ** D)):
            fs, before, on_ring, _, _, v = corners[corner]
            gw = torch.where(on_ring, 0.0, _feature_sum(ga * v) + g_den)
            for d in reversed(range(D)):
                gf = gw * before[d]
                gw = gw * fs[d]
                term = gf if (corner >> d) & 1 else -gf
                gfrac[d] = term if gfrac[d] is None else gfrac[d] + term
        dx_levels.append(torch.stack(gfrac, -1) * (R - 2))
    return torch.cat(rows), torch.cat(idx), dx_levels


def mix_encode_backward_plain(tables, x: torch.Tensor, g: torch.Tensor,
                              spec: Mix3D2DSpec) -> tuple:
    """The backward kernel's plain version: tables as ``mix_tables`` gives
    them, x [N, 3], g [N, output_dim] -> (each encoder's rows, each
    encoder's idx, as ``grid_encode_backward_plain``; the gradient to x
    [N, 3]). The gradient to x is summed in the order autograd's engine
    accumulates it in the eager path (the later-created node first): the
    planes yz, xz, xy, each plane's levels from the last into its own sum,
    which then goes into x's; then the 3-D encoder's levels from the
    last, straight into x's."""
    col, parts = 0, []
    for (_, gspec, cols), emb in zip(mix_parts(spec), tables):
        w = gspec.output_dim
        parts.append((grid_encode_backward_plain(
            emb, x[:, list(cols)], g[:, col:col + w], gspec), cols))
        col += w
    dx = torch.zeros_like(x)
    for (_, _, levels), cols in reversed(parts):
        if cols == (0, 1, 2):
            for lv in reversed(levels):
                dx = dx + lv
        else:
            total = levels[-1]
            for lv in reversed(levels[:-1]):
                total = total + lv
            full = torch.zeros_like(x)
            full[:, list(cols)] = total
            dx = dx + full
    return ([r for (r, _, _), _ in parts], [i for (_, i, _), _ in parts],
            dx)


def all_grid_params_flat(params: dict) -> torch.Tensor:
    """The four raw tables concatenated, xyz, xy, xz, yz (the codec's and
    the size estimate's view, get_encoding_params,
    gaussian_model.py:269-281)."""
    return torch.cat([params['xyz'], params['xy'], params['xz'],
                      params['yz']], 0)

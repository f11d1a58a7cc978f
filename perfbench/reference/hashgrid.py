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

In this copy ``mix_encode`` is the eager code on every device, and
``grid_scatter`` is ``index_add_``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .plain import grid_scatter
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


def mix_encode(params: dict, x: torch.Tensor,
               spec: Mix3D2DSpec) -> torch.Tensor:
    """x [N,3] in [0,1] -> concat(xyz, xy, xz, yz) features, eager."""
    return mix_encode_plain(params, x, spec)


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

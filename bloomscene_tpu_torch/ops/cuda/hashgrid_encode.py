"""The hash-grid encoder, forward and backward (CUDA
``csrc/hashgrid_encode.cu``), beside its plain versions.

``hashgrid_encode(x, tables, spec)`` is ``ops/hashgrid.py::mix_encode`` of
``x`` [N, 3] over the four encoders' tables as the encode reads them
(binarized): [N, spec.output_dim], in one launch. ``hashgrid_encode_bwd(x,
tables, g, spec)`` is its backward for the output's
cotangent ``g``: each encoder's corner cotangent rows [L 2^d N, F] and
table indices [L 2^d N] int64 (levels, then corners, then rows: the rows
that ``grid_scatter`` sums into that encoder's table), and the gradient to
``x`` [N, 3], in one launch. No TPU kernel is replaced: XLA fuses the JAX
package's plain jnp encoder (``bloomscene_tpu/ops/hashgrid.py``). The
forward is bitwise its plain version, and the backward's rows and indices
bitwise what autograd hands ``grid_scatter`` in the eager path; the
gradient to ``x`` is autograd's chain of products summed in the order
autograd's engine takes on the card (see the source). The plain versions
are ``ops/hashgrid.py::mix_encode_plain`` (eager torch, any device) and
``mix_encode_backward_plain`` (the backward's arithmetic in its order);
the wrappers take them for CPU tensors only.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from .build import check, library, require, stream_ptr

LEVEL_INTS = 12     # ints a level (hashgrid_encode.cu, make_spec)
MAX_LEVELS = 32
FEATURES = 4        # features a level the kernel takes (HAC's)

_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.POINTER(ctypes.c_void_p),
         ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
         ctypes.c_int]
_FWD_ARGTYPES = _ARGS + [ctypes.c_void_p, ctypes.c_void_p]
_BWD_ARGTYPES = _ARGS + [ctypes.c_void_p] * 5


def level_table(spec) -> tuple[list[int], list[int]]:
    """The kernel's list of levels (LEVEL_INTS ints a level: dim, R, table
    size, offset, dense, encoder, the three columns of x it reads, first
    output column, first corner block, direct) and each encoder's corner
    blocks (its rows are blocks [start, end) of N rows)."""
    from ..hashgrid import mix_parts
    ints, blocks, block = [], [], 0
    out_col = 0
    for e, (_, g, cols) in enumerate(mix_parts(spec)):
        start = block
        for li, R in enumerate(g.resolutions):
            size = g.level_sizes[li]
            ints += [g.num_dim, R, size, g.offsets[li],
                     int(R ** g.num_dim <= size), e,
                     *cols, *[0] * (3 - len(cols)), out_col, block,
                     int(tuple(cols) == (0, 1, 2))]
            out_col += g.n_features
            block += 2 ** g.num_dim
        blocks.append((start, block))
    return ints, blocks


def _args(x, tables, spec):
    from ..hashgrid import mix_parts
    dev = x.device
    N = x.shape[0]
    F = spec.n_features
    require(x, torch.float32, (N, 3), "x", dev)
    ints, blocks = level_table(spec)
    n_levels = len(ints) // LEVEL_INTS
    if F != FEATURES or n_levels > MAX_LEVELS or len(tables) != 4 \
            or N >= 2 ** 31:
        raise ValueError(f"hashgrid_encode: F {F} ({FEATURES}), "
                         f"{n_levels} levels (at most {MAX_LEVELS}), "
                         f"{len(tables)} tables (4) and {N} rows (< 2^31)")
    tabs = []
    for e, (t, (_, g, _)) in enumerate(zip(tables, mix_parts(spec))):
        require(t, torch.float32, (g.n_params, F), f"tables[{e}]", dev)
        tabs.append(t if t.data_ptr() % 16 == 0 else t.clone())
    t_ptrs = (ctypes.c_void_p * 4)(*[t.data_ptr() for t in tabs])
    lv = (ctypes.c_int * len(ints))(*ints)
    return (N, F, n_levels, blocks, tabs,
            [x.data_ptr(), N, t_ptrs, 4, lv, n_levels, F])


def hashgrid_encode(x: torch.Tensor, tables, spec) -> torch.Tensor:
    """x [N, 3] float32, tables: the four encoders' [n_params, F] float32
    tables (xyz, xy, xz, yz; binarized when spec.ste_binary), spec a
    ``Mix3D2DSpec`` -> [N, spec.output_dim] float32."""
    if x.device.type == "cpu":
        return hashgrid_encode_plain(x, tables, spec)
    N, F, n_levels, _, tabs, args = _args(x, tables, spec)
    out = torch.empty((N, n_levels * F), dtype=torch.float32,
                      device=x.device)
    fn = library("hashgrid_encode").bs_hashgrid_encode
    fn.argtypes, fn.restype = _FWD_ARGTYPES, ctypes.c_int
    check(fn(*args, out.data_ptr(), stream_ptr(x.device)), "hashgrid_encode")
    hashgrid_encode.launches += 1
    return out


hashgrid_encode.launches = 0


def hashgrid_encode_bwd(x: torch.Tensor, tables, g: torch.Tensor, spec
                        ) -> tuple:
    """The backward of ``hashgrid_encode`` for g [N, spec.output_dim]
    float32 -> (each encoder's corner rows [L 2^d N, F] float32, each
    encoder's table indices [L 2^d N] int64, the gradient to x [N, 3]
    float32)."""
    if x.device.type == "cpu":
        from ..hashgrid import mix_encode_backward_plain
        return mix_encode_backward_plain(tables, x, g, spec)
    N, F, n_levels, blocks, tabs, args = _args(x, tables, spec)
    dev = x.device
    require(g, torch.float32, (N, n_levels * F), "g", dev)
    if g.data_ptr() % 16:
        g = g.clone()       # the kernel reads 16-byte pieces of a row
    n_blocks = blocks[-1][1]
    rows = torch.empty((n_blocks * N, F), dtype=torch.float32, device=dev)
    idx = torch.empty((n_blocks * N,), dtype=torch.int64, device=dev)
    dx = torch.empty((N, 3), dtype=torch.float32, device=dev)
    fn = library("hashgrid_encode").bs_hashgrid_encode_bwd
    fn.argtypes, fn.restype = _BWD_ARGTYPES, ctypes.c_int
    check(fn(*args, g.data_ptr(), rows.data_ptr(), idx.data_ptr(),
             dx.data_ptr(), stream_ptr(dev)), "hashgrid_encode_bwd")
    hashgrid_encode_bwd.launches += 1
    return ([rows[a * N:b * N] for a, b in blocks],
            [idx[a * N:b * N] for a, b in blocks], dx)


hashgrid_encode_bwd.launches = 0


def hashgrid_encode_plain(x, tables, spec):
    from ..hashgrid import MIX_ENCODERS, mix_encode_plain
    return mix_encode_plain(dict(zip(MIX_ENCODERS, tables)), x,
                            dataclasses.replace(spec, ste_binary=False))


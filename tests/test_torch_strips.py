"""K1 and K2 on a strip of tile positions, the tile-parallel render's
kernel calls: positions [p0, p0 + n) of the full slab against the full
call's columns p0 .. p0 + n - 1, bit for bit (float bits compared, so a
zero's sign counts), on the synthetic edge cases of
tests/test_torch_kernels.py (``blend_case``: 2 x 2 tiles, 40 slots).

The plain versions on the CPU at tiles 4, 12 (a partial last warp on the
card), 16 and 40 (split into blocks on the card); the kernels on the
card (``cuda``-marked, skipped without one), where the strips must also
equal the full call, which stays bitwise its plain version.

This file imports no JAX, so it runs on the card's machine too:
``python -m pytest tests/test_torch_strips.py -q``.
"""
import numpy as np
import pytest
import torch

from bloomscene_tpu_torch.ops.cuda import blend
from test_torch_kernels import BLEND_CASES, CASE_GX, blend_case

torch.set_num_threads(2)
# (p0, n): the two halves, a middle strip, the last position, no position
STRIPS = ((0, 2), (2, 2), (1, 2), (3, 1), (2, 0))
TILES = (4, 12, 16, 40)


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_bitwise(got, want, what):
    assert got.shape == want.shape, what
    assert torch.equal(bits(got), bits(want)), what


def check_strips(forward, backward, slab, counts, tid, tile, dev):
    """Every strip of K1 and K2 (through ``forward`` and ``backward``, the
    kernels' or the plain versions' calls) equals the full call's
    columns."""
    full = forward(slab, counts, tid, tile, CASE_GX)
    rng = np.random.default_rng(2)
    u = [torch.from_numpy(rng.normal(size=full[5].shape).astype(np.float32)
                          ).to(dev) for _ in range(6)]
    args = (slab, counts, tid, tile, CASE_GX, full[5], full[6], *u)
    g_full = backward(*args)
    for p0, n in STRIPS:
        part = forward(slab, counts, tid, tile, CASE_GX, p0, n)
        for i, (a, b) in enumerate(zip(part, full)):
            assert_bitwise(a, b[:, p0:p0 + n], f"K1 plane {i} at {p0}+{n}")
        assert_bitwise(backward(*args, p0=p0, n=n), g_full[..., p0:p0 + n],
                       f"K2 at {p0}+{n}")
    return full, g_full


@pytest.mark.parametrize('tile', TILES)
def test_plain_strips_equal_full_call(tile):
    for case in BLEND_CASES:
        slab, counts, tid = blend_case(case, tile)
        check_strips(blend.blend_forward_plain, blend.blend_backward_plain,
                     slab, counts, tid, tile, 'cpu')


def test_strip_outside_the_slab_raises():
    slab, counts, tid = blend_case('mixed', 4)
    for p0, n in ((-1, 2), (3, 2), (0, 5)):
        with pytest.raises(ValueError):
            blend.blend_forward(slab, counts, tid, 4, CASE_GX, p0, n)


@pytest.mark.cuda
@pytest.mark.parametrize('tile', TILES)
def test_kernel_strips_equal_full_call(tile):
    """On the card: the strips of K1 and K2 equal the full call's columns,
    the full K1 equals its plain version and the full K2 is bitwise equal
    to itself from one launch to the next."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    dev = torch.device('cuda')
    for case in BLEND_CASES:
        slab, counts, tid = (x.to(dev) for x in blend_case(case, tile))
        full, g_full = check_strips(blend.blend_forward, blend.blend_backward,
                                    slab, counts, tid, tile, dev)
        for a, b in zip(full, blend.blend_forward_plain(slab, counts, tid,
                                                        tile, CASE_GX)):
            assert_bitwise(a, b, f"K1 against its plain version ({case})")
        assert_bitwise(blend.blend_backward(slab, counts, tid, tile, CASE_GX,
                                            full[5], full[6],
                                            *(torch.ones_like(full[5]),) * 6),
                       blend.blend_backward(slab, counts, tid, tile, CASE_GX,
                                            full[5], full[6],
                                            *(torch.ones_like(full[5]),) * 6),
                       f"K2 twice ({case})")
        torch.cuda.synchronize()

"""The CUDA kernels (bloomscene_tpu_torch/csrc) against their plain PyTorch
versions, and the no-fallback rule of their build.

This file imports no JAX, so it also runs on a machine with a card and no
JAX: ``python -m pytest tests/test_torch_kernels.py -q`` there runs the
``cuda``-marked test; here it skips.

Tolerances: K3 (pair expansion) and K4 (slab expansion) bitwise; K1 (blend
forward) 1e-5 on color, acc and T and 1e-4 on the depth sum, the
tolerances of tests/test_pallas_blend.py:48-52; K2 (blend backward) atol
2e-6 + rtol 2e-4, those of tests/test_pallas_blend.py:79-80 (the kernel
sums each slot's pixels in a fixed tree, the plain version in torch's
order), and bitwise equal to itself from one launch to the next.
"""
import numpy as np
import pytest
import torch

from bloomscene_tpu_torch.ops import graphics, projection
from bloomscene_tpu_torch.ops.cuda import build

torch.set_num_threads(2)
TILE = 16


def test_cuda_wrapper_without_nvcc_raises(tmp_path, monkeypatch):
    """No fallback: with no kernel library and no nvcc, building raises."""
    monkeypatch.setattr(build, 'BUILD_DIR', tmp_path)
    monkeypatch.setattr(build, '_loaded', {})
    monkeypatch.setenv('PATH', str(tmp_path))
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    with pytest.raises(RuntimeError, match='nvcc not found'):
        build.library('blend')


@pytest.mark.cuda
def test_kernels_match_plain(rng):
    """K3 (packed-key and two-key outputs), K4, K1 and K2 against their
    plain versions on the card, on a random 400-splat scene at 64x64."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from bloomscene_tpu_torch.ops.cuda.blend import (blend_backward,
                                                     blend_backward_plain,
                                                     blend_forward,
                                                     blend_forward_plain)
    from bloomscene_tpu_torch.ops.cuda.expand import (expand_slab,
                                                      expand_slab_plain)
    from bloomscene_tpu_torch.ops.cuda.pairs import (expand_pairs,
                                                     expand_pairs_plain)
    from bloomscene_tpu_torch.ops.tile_rasterizer import attr_rows
    from bloomscene_tpu_torch.ops.tiles import (bin_splats,
                                                pair_kernel_inputs,
                                                sorted_attr_table)
    n, W = 400, 64
    dev = torch.device('cuda')

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    means = np.stack([rng.uniform(-1.2, 1.2, n), rng.uniform(-1.2, 1.2, n),
                      rng.uniform(0.8, 5.0, n)], -1)
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    view = graphics.world_to_view(np.eye(3), np.zeros(3))
    full = graphics.projection_matrix(0.01, 100.0, 1.0, 1.0) @ view
    f = graphics.fov2focal(1.0, W)
    pt = projection.project_gaussians(
        t(means), projection.build_cov3d(t(rng.uniform(0.02, 0.25, (n, 3))),
                                         t(quats)),
        t(view), t(full), W, W, f, f, float(np.tan(0.5)), float(np.tan(0.5)))
    op = torch.where(pt.valid, t(rng.uniform(0.1, 0.95, n)), 0.0)
    for size, pc in ((W, 4096), (1024, (1 << 18) + 8)):  # packed, two-key
        args = pair_kernel_inputs(pt, size, size, TILE, pc, op)
        assert args['packed_key'] == (size == W)
        for a, b in zip(expand_pairs(**args), expand_pairs_plain(**args)):
            assert torch.equal(a, b)
    rows = attr_rows(pt, t(rng.uniform(0, 1, (n, 3))), op)
    bins = bin_splats(pt, W, W, TILE, 4096, 64, opacities=op,
                      attr_rows=rows)
    asT = sorted_attr_table(rows, bins.gauss_sorted, 64)
    tsp = bins.t_start[bins.perm.long()].contiguous()
    assert torch.equal(expand_slab(asT, tsp, 64),
                       expand_slab_plain(asT, tsp, 64))
    counts_p = bins.counts[bins.perm.long()].contiguous()
    got = blend_forward(bins.slab, counts_p, bins.perm, TILE, W // TILE)
    want = blend_forward_plain(bins.slab, counts_p, bins.perm, TILE,
                               W // TILE)
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(got, want)):
        tol = 1e-4 if i == 3 else 1e-5
        assert float((a.double() - b.double()).abs().max()) <= tol
    Tf, ncon = want[5], want[6]
    # cotangents at the scale of a mean over the image's pixels
    u = [t(rng.normal(size=Tf.shape) / (W * W)) for _ in range(6)]
    args = (bins.slab, counts_p, bins.perm, TILE, W // TILE, Tf, ncon, *u)
    got = blend_backward(*args)
    again = blend_backward(*args)
    want = blend_backward_plain(*args)
    torch.cuda.synchronize()
    assert float(want.abs().max()) > 0
    torch.testing.assert_close(got, want, atol=2e-6, rtol=2e-4)
    assert torch.equal(got, again)

"""Port parity: the tile rasterizer forward (bin + blend) against the JAX
package's ``rasterize_tiles`` with backend 'xla' and with backend 'pallas'
(the Pallas kernels in interpret mode, as tests/test_pallas_blend.py runs
them).

Tolerances are those of tests/test_pallas_blend.py:48-52 (color 1e-5 abs
and rel, depth 1e-4, final_T and alpha 1e-5): the blends agree in order of
operations, but ``torch.exp`` and XLA's exp may differ in the last bit.

The CUDA kernels cannot run here; tests/test_torch_kernels.py holds them
against their plain versions where a card is present.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bloomscene_tpu.ops import graphics as jg
from bloomscene_tpu.ops import projection as jp
from bloomscene_tpu.ops.pallas import blend as pallas_blend
from bloomscene_tpu.ops.tile_rasterizer import rasterize_tiles as jax_raster
from bloomscene_tpu_torch.ops.projection import ProjectedSplats
from bloomscene_tpu_torch.ops.tile_rasterizer import rasterize_tiles

torch.set_num_threads(2)
TILE = 16


@pytest.fixture(autouse=True)
def interpret_mode():
    pallas_blend.INTERPRET = True
    yield
    pallas_blend.INTERPRET = False


def scene(rng, n, W=64, H=64, stack_center=False):
    means = np.stack([rng.uniform(-1.2, 1.2, n), rng.uniform(-1.2, 1.2, n),
                      rng.uniform(0.8, 5.0, n)], -1).astype(np.float32)
    if stack_center:
        means[:, :2] = 0.0
    scales = rng.uniform(0.02, 0.25, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    opac = rng.uniform(0.1, 0.95, n).astype(np.float32)
    view = jg.world_to_view(np.eye(3), np.zeros(3))
    full = jg.projection_matrix(0.01, 100.0, 1.0, 1.0) @ view
    pj = jp.project_gaussians(
        jnp.asarray(means), jp.build_cov3d(jnp.asarray(scales),
                                           jnp.asarray(quats)),
        jnp.asarray(view), jnp.asarray(full), W, H, jg.fov2focal(1.0, W),
        jg.fov2focal(1.0, H), float(np.tan(0.5)), float(np.tan(0.5)))
    pt = ProjectedSplats(*(torch.from_numpy(np.array(a)) for a in pj))
    return pj, pt, colors, opac


def assert_close(out_t, out_j):
    np.testing.assert_allclose(out_t.color.numpy(), out_j.color, atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(out_t.depth.numpy(), out_j.depth, atol=1e-4)
    np.testing.assert_allclose(out_t.final_T.numpy(), out_j.final_T,
                               atol=1e-5)
    np.testing.assert_allclose(out_t.alpha.numpy(), out_j.alpha, atol=1e-5)


@pytest.mark.parametrize('cap', [128, 18, 24])
def test_forward_matches_jax_backends(rng, cap):
    """tile_capacity 18 and 24 are the odd-chunk and per-tile truncation
    cases of the JAX blends."""
    pj, pt, colors, opac = scene(rng, 150)
    bg = np.array([0.2, 0.5, 0.8], np.float32)
    out_t, bins = rasterize_tiles(pt, torch.from_numpy(colors),
                                  torch.from_numpy(opac),
                                  torch.from_numpy(bg), 64, 64, tile=TILE,
                                  tile_capacity=cap)
    for backend in ('xla', 'pallas'):
        out_j, jb = jax.jit(functools.partial(
            jax_raster, W=64, H=64, tile=TILE, tile_capacity=cap,
            backend=backend))(pj, jnp.asarray(colors), jnp.asarray(opac),
                              jnp.asarray(bg))
        assert_close(out_t, out_j)
        assert int(bins.tile_overflow) == int(jb.tile_overflow)
    assert (int(bins.tile_overflow) > 0) == (cap < 128)


def test_empty_scene_renders_background():
    empty = ProjectedSplats(torch.zeros((0, 2)), torch.zeros(0),
                            torch.zeros((0, 3)),
                            torch.zeros(0, dtype=torch.int32),
                            torch.zeros(0, dtype=torch.bool))
    bg = torch.tensor([0.25, 0.5, 0.75])
    out, _ = rasterize_tiles(empty, torch.zeros((0, 3)), torch.zeros(0), bg,
                             64, 48, tile=TILE, tile_capacity=32)
    assert out.color.shape == (48, 64, 3)
    assert torch.equal(out.color, bg.expand(48, 64, 3))
    assert bool((out.final_T == 1).all()) and bool((out.depth == 0).all())


@pytest.mark.parametrize('w,h,tile', [(72, 40, 16), (56, 56, 8),
                                      (64, 64, 32), (72, 72, 40),
                                      (128, 96, 64)])
def test_odd_geometry_matches_jax(rng, w, h, tile):
    """Non-square, non-tile-multiple images and tile sizes 8 and 32, and
    40 and 64, which the card's kernels split into several blocks a
    tile."""
    pj, pt, colors, opac = scene(rng, 60, W=w, H=h)
    bg = np.array([0.25, 0.5, 0.75], np.float32)
    out_t, _ = rasterize_tiles(pt, torch.from_numpy(colors),
                               torch.from_numpy(opac), torch.from_numpy(bg),
                               w, h, tile=tile, pair_capacity=4096,
                               tile_capacity=128)
    out_j, _ = jax.jit(functools.partial(
        jax_raster, W=w, H=h, tile=tile, pair_capacity=4096,
        tile_capacity=128, backend='xla'))(
            pj, jnp.asarray(colors), jnp.asarray(opac), jnp.asarray(bg))
    assert_close(out_t, out_j)

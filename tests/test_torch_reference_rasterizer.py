"""The port's golden rasterizer and ``sobel_edge_mask`` against the JAX
package's, and the port's tile path against the port's golden model.

``rasterize_reference`` (dense, one splat at a time over every pixel,
autograd gradients) on the same projected splats as JAX's (projected by
the JAX package, handed to both as numpy arrays): values within the
tolerances of tests/test_reference_rasterizer.py (color 1e-5) and of
tests/test_tile_rasterizer.py:87-90 (depth 1e-4, T and alpha 1e-5); the
gradients of tests/test_tile_rasterizer.py's loss (color, depth, T and
alpha terms) with respect to mean2d, conic, depth, color, opacity and bg
within atol 2e-5 + rtol 2e-3 (tests/test_tile_rasterizer.py:125-126),
tighter than the finite-difference bound of
tests/test_reference_rasterizer.py. The port's tile path (its plain
blend on the CPU) against the port's golden model with ``tile=`` at
tiles 4, 12 and 16, on an image that no tile divides, with the same
tolerances. ``sobel_edge_mask`` bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bloomscene_tpu.ops import graphics as jgraphics
from bloomscene_tpu.ops import projection as jprojection
from bloomscene_tpu.ops.reference_rasterizer import \
    rasterize_reference as jax_reference
from bloomscene_tpu.train.losses import sobel_edge_mask as jax_sobel
from bloomscene_tpu_torch.ops.projection import ProjectedSplats
from bloomscene_tpu_torch.ops.reference_rasterizer import rasterize_reference
from bloomscene_tpu_torch.ops.tile_rasterizer import rasterize_tiles
from bloomscene_tpu_torch.train.losses import sobel_edge_mask

torch.set_num_threads(2)
VALUE_TOL = {'color': 1e-5, 'depth': 1e-4, 'final_T': 1e-5, 'alpha': 1e-5}
GRAD_ATOL, GRAD_RTOL = 2e-5, 2e-3
NAMES = ('mean2d', 'conic', 'depth', 'color', 'opac', 'bg')


def projected_scene(rng, n: int, W: int, H: int) -> dict:
    """A seeded scene of ``n`` Gaussians (tests/test_tile_rasterizer.py's
    ranges) projected by the JAX package -> numpy arrays: mean2d, conic,
    depth, radius, valid, color, opac, bg, and the loss's targets."""
    means = np.stack([rng.uniform(-1.2, 1.2, n), rng.uniform(-1.2, 1.2, n),
                      rng.uniform(0.8, 5.0, n)], -1).astype(np.float32)
    scales = rng.uniform(0.02, 0.25, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    view = jgraphics.world_to_view(np.eye(3), np.zeros(3))
    full = jgraphics.projection_matrix(0.01, 100.0, 1.0, 1.0) @ view
    proj = jprojection.project_gaussians(
        jnp.asarray(means), jprojection.build_cov3d(jnp.asarray(scales),
                                                    jnp.asarray(quats)),
        jnp.asarray(view), jnp.asarray(full), W, H,
        jgraphics.fov2focal(1.0, W), jgraphics.fov2focal(1.0, H),
        np.tan(0.5), np.tan(0.5))
    out = {k: np.array(v) for k, v in proj._asdict().items()}
    out.update(color=rng.uniform(0, 1, (n, 3)).astype(np.float32),
               opac=rng.uniform(0.1, 0.95, n).astype(np.float32),
               bg=np.array([0.25, 0.5, 0.75], np.float32),
               tgt_c=rng.uniform(0, 1, (H, W, 3)).astype(np.float32),
               tgt_d=rng.uniform(1, 4, (H, W)).astype(np.float32))
    assert out['valid'].sum() > 0.8 * n
    return out


def loss_of(out, tgt_c, tgt_d, lib):
    return (lib.mean((out.color - tgt_c) ** 2)
            + 0.7 * lib.mean((out.depth - tgt_d) ** 2)
            + 0.1 * lib.mean(out.final_T) + 0.05 * lib.mean(out.alpha))


def port_run(sc, raster):
    """(output, loss, gradients by NAMES) of ``raster(proj, color, opac,
    bg)`` in the port."""
    leaves = [torch.from_numpy(sc[k].copy()).requires_grad_(True)
              for k in NAMES]
    proj = ProjectedSplats(mean2d=leaves[0], depth=leaves[2],
                           conic=leaves[1],
                           radius=torch.from_numpy(sc['radius']),
                           valid=torch.from_numpy(sc['valid']))
    out = raster(proj, *leaves[3:])
    loss = loss_of(out, torch.from_numpy(sc['tgt_c']),
                   torch.from_numpy(sc['tgt_d']), torch)
    grads = torch.autograd.grad(loss, leaves)
    return out, float(loss.detach()), [g.numpy() for g in grads]


def jax_run(sc, W, H, tile):
    def f(mean2d, conic, depth, color, opac, bg):
        proj = jprojection.ProjectedSplats(
            mean2d=mean2d, depth=depth, conic=conic,
            radius=jnp.asarray(sc['radius']), valid=jnp.asarray(sc['valid']))
        out = jax_reference(proj, color, opac, bg, W, H, tile=tile)
        return loss_of(out, jnp.asarray(sc['tgt_c']),
                       jnp.asarray(sc['tgt_d']), jnp), out
    args = [jnp.asarray(sc[k]) for k in NAMES]
    (loss, out), grads = jax.value_and_grad(
        f, argnums=tuple(range(6)), has_aux=True)(*args)
    return out, float(loss), [np.asarray(g) for g in grads]


def assert_outputs_close(got, want):
    for field, tol in VALUE_TOL.items():
        a = getattr(got, field)
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
        b = np.asarray(getattr(want, field).detach()
                       if isinstance(getattr(want, field), torch.Tensor)
                       else getattr(want, field))
        np.testing.assert_allclose(a, b, atol=tol, rtol=tol,
                                   err_msg=field)


def assert_grads_close(got, want):
    for name, a, b in zip(NAMES, got, want):
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, b, atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=f'gradient of {name}')


@pytest.mark.parametrize('tile', [None, 16])
def test_golden_matches_jax(rng, tile):
    """Values and gradients (depth included) of the port's golden model
    against the JAX package's on the same projected splats, with and
    without the tile visibility rule."""
    W, H = 48, 40
    sc = projected_scene(rng, 60, W, H)
    out, loss, grads = port_run(sc, lambda p, c, o, b: rasterize_reference(
        p, c, o, b, W, H, tile=tile))
    j_out, j_loss, j_grads = jax_run(sc, W, H, tile)
    assert_outputs_close(out, j_out)
    np.testing.assert_allclose(loss, j_loss, rtol=1e-5)
    assert_grads_close(grads, j_grads)
    # the depth path reaches the splats' depths and positions
    assert np.abs(grads[2]).max() > 0 and np.abs(grads[0]).max() > 0


def test_golden_empty_scene_is_background():
    """No valid splat: the background, T 1, depth 0."""
    W, H = 16, 12
    proj = ProjectedSplats(mean2d=torch.zeros((3, 2)),
                           depth=torch.ones(3), conic=torch.ones((3, 3)),
                           radius=torch.zeros(3, dtype=torch.int32),
                           valid=torch.zeros(3, dtype=torch.bool))
    bg = torch.tensor([0.25, 0.5, 0.75])
    out = rasterize_reference(proj, torch.ones((3, 3)), torch.ones(3), bg,
                              W, H, tile=4)
    assert torch.equal(out.color, bg.expand(H, W, 3))
    assert torch.equal(out.final_T, torch.ones((H, W)))
    assert torch.equal(out.depth, torch.zeros((H, W)))


@pytest.mark.parametrize('tile', [4, 12, 16])
def test_plain_tile_path_matches_golden(rng, tile):
    """The port's tile path (binning, the plain K1 and K2) against its
    golden model with the same tile's visibility rule, on a 50 x 42 image
    (no tile divides it), values and gradients."""
    W, H = 50, 42
    sc = projected_scene(rng, 60, W, H)
    gold, g_loss, g_grads = port_run(sc, lambda p, c, o, b:
                                     rasterize_reference(p, c, o, b, W, H,
                                                         tile=tile))
    out, loss, grads = port_run(sc, lambda p, c, o, b: rasterize_tiles(
        p, c, o, b, W, H, tile=tile, tile_capacity=256)[0])
    assert_outputs_close(out, gold)
    np.testing.assert_allclose(loss, g_loss, rtol=1e-5)
    assert_grads_close(grads, g_grads)


@pytest.mark.parametrize('threshold,edge_is_one', [(0.1, True),
                                                   (0.05, False)])
def test_sobel_edge_mask_matches_jax(rng, threshold, edge_is_one):
    image = rng.uniform(0, 1, (24, 40, 3)).astype(np.float32)
    image[8:16] = 0.5                        # a flat band: no edges there
    got = sobel_edge_mask(torch.from_numpy(image), threshold, edge_is_one)
    want = np.asarray(jax_sobel(jnp.asarray(image), threshold, edge_is_one))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < got.sum() < got.numel()

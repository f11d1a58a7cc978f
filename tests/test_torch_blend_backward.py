"""Port parity: the gradient of the tile blend (``TileBlend``: K2's plain
version and the emission-order reduction) against the JAX package's
``rasterize_tiles`` gradients with backend 'pallas' (the Pallas kernels in
interpret mode, as tests/test_pallas_blend.py runs them) and with backend
'xla' (the ``accum_rec`` scan with segment sums).

The three cases are those of tests/test_pallas_blend.py:55-135: a 64x64
view of 60 splats with every output in the loss, per-tile truncation at
``tile_capacity=24``, and the odd capacity 18. Tolerance atol 2e-6,
rtol 2e-4, the JAX tests' own (test_pallas_blend.py:79-80): the suffix-sum
form (tb - Q) / (1 - alpha) and the accum_rec form round differently, and
the per-Gaussian sums are taken in another order (a cumsum difference here,
segment sums or an MXU cumsum there).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bloomscene_tpu.ops import graphics as jg
from bloomscene_tpu.ops import projection as jp
from bloomscene_tpu.ops.pallas import blend as pallas_blend
from bloomscene_tpu.ops.tile_rasterizer import rasterize_tiles as jax_raster
from bloomscene_tpu_torch.ops.cuda import blend as tblend
from bloomscene_tpu_torch.ops.projection import ProjectedSplats
from bloomscene_tpu_torch.ops.tile_rasterizer import rasterize_tiles

torch.set_num_threads(2)
W = H = 64
TILE = 16
NAMES = ('mean2d', 'conic', 'depth', 'colors', 'opac', 'bg')


@pytest.fixture(autouse=True)
def interpret_mode():
    pallas_blend.INTERPRET = True
    yield
    pallas_blend.INTERPRET = False


def make_scene(rng, n):
    """tests/test_pallas_blend.py::make_scene, projected by the JAX
    package."""
    means = np.stack([rng.uniform(-1.2, 1.2, n), rng.uniform(-1.2, 1.2, n),
                      rng.uniform(0.8, 5.0, n)], -1).astype(np.float32)
    scales = rng.uniform(0.02, 0.25, (n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    opac = rng.uniform(0.1, 0.95, n).astype(np.float32)
    view = jg.world_to_view(np.eye(3), np.zeros(3))
    proj_m = jg.projection_matrix(0.01, 100.0, 1.0, 1.0) @ view
    fx = jg.fov2focal(1.0, W)
    t = float(np.tan(0.5))
    p = jp.project_gaussians(
        jnp.asarray(means), jp.build_cov3d(jnp.asarray(scales),
                                           jnp.asarray(quats)),
        jnp.asarray(view), jnp.asarray(proj_m), W, H, fx, fx, t, t)
    return p, colors, opac


def loss_of(out, case, tgt_c, tgt_d, lib):
    """The loss of each case of tests/test_pallas_blend.py."""
    mean = lib.mean
    loss = mean((out.color - tgt_c) ** 2)
    if case == 'all_outputs':
        loss = (loss + 0.5 * mean((out.depth - tgt_d) ** 2)
                + 0.1 * mean(out.final_T) + 0.05 * mean(out.alpha))
    elif case == 'truncation':
        loss = loss + 0.1 * mean(out.depth)
    return loss


@pytest.mark.parametrize('case,n,cap,bg', [
    ('all_outputs', 60, 128, (0.1, 0.2, 0.3)),
    ('truncation', 200, 24, (0.3, 0.1, 0.6)),
    ('odd_cap', 60, 18, (0.1, 0.2, 0.3))])
def test_tile_blend_grads_match_jax(rng, case, n, cap, bg):
    check_grads_against_jax(rng, case, n, cap, bg, TILE, ('pallas', 'xla'))


def test_tile_blend_grads_match_jax_at_tile_48(rng):
    """A tile above 32, which the card's kernels split into several blocks
    a tile (three of 768 pixels at 48): the port's gradients against the
    JAX package's XLA blend (the Pallas kernel is not built for a tile of
    2,304 pixels) on a 64x64 view of 2 x 2 tiles."""
    check_grads_against_jax(rng, 'all_outputs', 60, 128, (0.1, 0.2, 0.3),
                            48, ('xla',))


def check_grads_against_jax(rng, case, n, cap, bg, tile, backends):
    p, colors, opac = make_scene(rng, n)
    bg = np.array(bg, np.float32)
    tgt_c = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    tgt_d = rng.uniform(1, 4, (H, W)).astype(np.float32)
    args = (p.mean2d, p.conic, p.depth, jnp.asarray(colors),
            jnp.asarray(opac), jnp.asarray(bg))

    def jax_loss(backend, mean2d, conic, depth, colors, opac, bg):
        pp = p._replace(mean2d=mean2d, conic=conic, depth=depth)
        out, bins = jax_raster(pp, colors, opac, bg, W, H, tile=tile,
                               tile_capacity=cap, backend=backend)
        return loss_of(out, case, tgt_c, tgt_d, jnp), bins.tile_overflow

    leaves = [torch.from_numpy(np.array(a)).requires_grad_(True)
              for a in args]
    proj = ProjectedSplats(mean2d=leaves[0], depth=leaves[2],
                           conic=leaves[1],
                           radius=torch.from_numpy(np.array(p.radius)),
                           valid=torch.from_numpy(np.array(p.valid)))
    out, bins = rasterize_tiles(proj, leaves[3], leaves[4], leaves[5], W, H,
                                tile=tile, tile_capacity=cap)
    loss_t = loss_of(out, case, torch.from_numpy(tgt_c),
                     torch.from_numpy(tgt_d), torch)
    grads_t = torch.autograd.grad(loss_t, leaves)
    assert (int(bins.tile_overflow) > 0) == (cap < 128)

    for backend in backends:
        (loss_j, overflow), grads_j = jax.jit(jax.value_and_grad(
            lambda *a: jax_loss(backend, *a), argnums=tuple(range(6)),
            has_aux=True))(*args)
        assert int(overflow) == int(bins.tile_overflow)
        np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                                   rtol=1e-5)
        for nm, gt, gj in zip(NAMES, grads_t, grads_j):
            np.testing.assert_allclose(
                gt.numpy(), np.asarray(gj), atol=2e-6, rtol=2e-4,
                err_msg=f"{case} grad {nm} vs {backend}")


def test_walk_rows_past_the_walk_are_zero(rng):
    """K2's plain version writes nothing past a tile's walk
    (min(count, max n_contrib)): those rows are zero, not stale values, and
    the rows below it are not all zero."""
    p, colors, opac = make_scene(rng, 120)
    proj = ProjectedSplats(*(torch.from_numpy(np.array(a)) for a in p))
    leaf = torch.from_numpy(colors).requires_grad_(True)
    _, bins = rasterize_tiles(proj, leaf, torch.from_numpy(opac),
                              torch.zeros(3), W, H, tile=TILE,
                              tile_capacity=64)
    counts_p = bins.counts[bins.perm.long()].contiguous()
    r, g, b, D, acc, Tf, ncon = tblend.blend_forward(bins.slab, counts_p,
                                                     bins.perm, TILE, 4)
    ones = torch.ones_like(Tf)
    grad = tblend.blend_backward(bins.slab, counts_p, bins.perm, TILE, 4, Tf,
                                 ncon, ones, ones, ones, ones, ones, ones)
    walk = tblend.blend_walk(counts_p, ncon)
    past = torch.arange(grad.shape[1])[:, None] >= walk[None, :]
    assert int(walk.max()) > 0 and bool(past.any())
    assert bool((grad[:, past] == 0).all())
    assert bool((grad[:, ~past] != 0).any())


def test_plain_backward_magnitudes_bound_each_row(rng):
    """``magnitude=True`` sums the absolute values of each entry's pixel
    terms: it bounds |grad| (up to float32 rounding, 1e-5 relative), it
    is zero past the walk, it exceeds |grad| where the terms cancel, and a
    change of sign of every cotangent plane leaves it as it is."""
    p, colors, opac = make_scene(rng, 120)
    proj = ProjectedSplats(*(torch.from_numpy(np.array(a)) for a in p))
    _, bins = rasterize_tiles(proj, torch.from_numpy(colors),
                              torch.from_numpy(opac), torch.zeros(3), W, H,
                              tile=TILE, tile_capacity=64)
    counts_p = bins.counts[bins.perm.long()].contiguous()
    *_, Tf, ncon = tblend.blend_forward(bins.slab, counts_p, bins.perm,
                                        TILE, 4)
    u = [torch.from_numpy(rng.normal(size=Tf.shape).astype(np.float32))
         for _ in range(6)]
    base = (bins.slab, counts_p, bins.perm, TILE, 4, Tf, ncon)
    grad = tblend.blend_backward_plain(*base, *u)
    mag = tblend.blend_backward_plain(*base, *u, magnitude=True)
    flipped = tblend.blend_backward_plain(*base, *(-x for x in u),
                                          magnitude=True)
    assert bool((grad.abs() <= mag * (1 + 1e-5)).all())
    assert bool(((mag == 0) == (grad == 0)).all())
    assert bool((mag > 1.01 * grad.abs()).any())
    assert torch.equal(mag, flipped)

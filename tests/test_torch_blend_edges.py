"""Port parity at the edges of the blend kernels' slot batches: the plain
versions of K1 and K2 (``ops/cuda/blend.py``, which the CUDA kernels equal
on the card, tests/test_torch_kernels.py) against the JAX package's Pallas
blends in interpret mode, as tests/test_pallas_blend.py runs them, on the
synthetic slabs of tests/test_torch_kernels.py::blend_case: a walk of 0, a
walk that is not a multiple of a batch, a full column, pixels that all
stop early, and tile 8 beside 16.

Tolerances: forward 1e-5 on color, acc and T and 1e-4 on the depth sum
(tests/test_pallas_blend.py:48-52; ``torch.exp`` and XLA's exp may differ
in the last bit), n_contrib equal; backward atol 2e-6 + rtol 2e-4 with
cotangents at the scale of a mean over the pixels
(tests/test_pallas_blend.py:79-80; the pixel sums are taken in another
order).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bloomscene_tpu.ops.pallas import blend as pallas_blend
from bloomscene_tpu_torch.ops.cuda import blend as tblend
from test_torch_kernels import (BLEND_CASES, CASE_GX, CASE_TILES,
                                blend_case)

torch.set_num_threads(2)


@functools.lru_cache(maxsize=None)
def pallas_blends(tile: int):
    """The JAX blends for ``tile``, jitted once (the cases share shapes)."""
    gy = CASE_TILES // CASE_GX
    fwd = jax.jit(lambda s, c, t: pallas_blend.blend_forward_pallas(
        s, c, tile, CASE_GX, gy, tid=t))
    bwd = jax.jit(lambda s, c, t, *planes: pallas_blend.blend_backward_pallas(
        s, c, tile, CASE_GX, gy, *planes, tid=t))
    return fwd, bwd


@pytest.fixture(autouse=True)
def interpret_mode():
    pallas_blend.INTERPRET = True
    yield
    pallas_blend.INTERPRET = False


@pytest.mark.parametrize('case,tile', [(c, 16) for c in BLEND_CASES]
                         + [('mixed', 8)])
def test_plain_blend_matches_pallas_at_edges(case, tile):
    slab, counts, tid = blend_case(case, tile)
    fwd, bwd = pallas_blends(tile)
    j = [jnp.asarray(x.numpy()) for x in (slab, counts, tid)]
    out_t = tblend.blend_forward_plain(slab, counts, tid, tile, CASE_GX)
    out_j = fwd(*j)
    for i, (a, b) in enumerate(zip(out_t[:6], out_j[:6])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   atol=1e-4 if i == 3 else 1e-5, rtol=0)
    np.testing.assert_array_equal(out_t[6].numpy(), np.asarray(out_j[6]))

    Tf, ncon = out_t[5], out_t[6]
    rng = np.random.default_rng(1)
    u = [rng.normal(size=Tf.shape).astype(np.float32) / Tf.numel()
         for _ in range(6)]
    g_t = tblend.blend_backward_plain(slab, counts, tid, tile, CASE_GX, Tf,
                                      ncon, *(torch.from_numpy(x) for x in u))
    g_j = bwd(*j, jnp.asarray(Tf.numpy()), jnp.asarray(ncon.numpy()),
              *(jnp.asarray(x) for x in u))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=2e-6,
                               rtol=2e-4)
    walk = tblend.blend_walk(counts, ncon)
    assert (int(walk.sum()) == 0) == (case == 'walk0')
    if case != 'walk0':
        assert float(np.abs(np.asarray(g_j)).max()) > 0

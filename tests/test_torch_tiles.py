"""Port parity: tile binning (bloomscene_tpu_torch.ops.tiles) against the
JAX package's ``bin_splats`` on the same projected splats.

Both take the same float32 inputs and do the same integer and float32
steps, so every output -- pair and packed counts, the tile-sorted ids and
tiles, the ranges, counts, occupancy order, gradient index, slab and the
overflow counters -- is asserted bitwise equal. (The JAX function runs under ``jax.jit``,
where XLA may fuse a multiply and an add of the cull into one rounding; the
cull's 1e-3 margin keeps such last-bit differences from moving a pair, and
the test would show it if one did.)
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bloomscene_tpu.ops import graphics as jg
from bloomscene_tpu.ops import projection as jp
from bloomscene_tpu.ops.tiles import bin_splats as jax_bin_splats
from bloomscene_tpu.ops.tiles import compute_tile_rects as jax_rects
from bloomscene_tpu_torch.ops.cuda.pairs import expand_pairs_plain
from bloomscene_tpu_torch.ops.projection import ProjectedSplats
from bloomscene_tpu_torch.ops.tile_rasterizer import attr_rows
from bloomscene_tpu_torch.ops.tiles import (bin_splats, compute_tile_rects,
                                            pair_kernel_inputs)

torch.set_num_threads(2)
W = H = 64
TILE = 16


def scene(rng, n, stack_center=False):
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
    fx = jg.fov2focal(1.0, W)
    t = float(np.tan(0.5))
    pj = jp.project_gaussians(
        jnp.asarray(means), jp.build_cov3d(jnp.asarray(scales),
                                           jnp.asarray(quats)),
        jnp.asarray(view), jnp.asarray(full), W, H, fx, fx, t, t)
    pt = ProjectedSplats(*(torch.from_numpy(np.array(a)) for a in pj))
    op = np.where(np.asarray(pj.valid), opac, 0.0).astype(np.float32)
    return pj, pt, colors, op


def assert_bins_equal(jb, tb):
    for f in tb._fields:
        got = getattr(tb, f)
        if got is None:
            continue
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jb, f)),
                                      err_msg=f)


# (image size, pair_capacity, tile_capacity, packed_capacity, stacked)
CASES = {
    'packed_key': (64, 4096, 256, None, False),
    'pair_overflow': (64, 300, 256, None, False),
    'packed_overflow': (64, 4096, 256, 200, False),
    'tile_overflow': (64, 4096, 16, None, True),
    'two_key': (1024, (1 << 18) + 8, 64, 4096, False),
}


@pytest.mark.parametrize('case', sorted(CASES))
def test_bin_splats_bitwise_vs_jax(rng, case):
    size, pc, cap, packed, stacked = CASES[case]
    pj, pt, colors, op = scene(rng, 150, stack_center=stacked)
    rows = attr_rows(pt, torch.from_numpy(colors), torch.from_numpy(op))
    jb = jax.jit(functools.partial(
        jax_bin_splats, W=size, H=size, tile=TILE, pair_capacity=pc,
        tile_capacity=cap, packed_capacity=packed, grad_index=True,
        need_entries=False))(pj, opacities=jnp.asarray(op),
                             attr_rows=jnp.asarray(rows.numpy()))
    tb = bin_splats(pt, size, size, TILE, pc, cap,
                    opacities=torch.from_numpy(op), packed_capacity=packed,
                    grad_index=True, attr_rows=rows)
    assert_bins_equal(jb, tb)
    kbits = max(1, pc - 1).bit_length()
    nt = (-(-size // TILE)) ** 2
    assert (case == 'two_key') == (not (nt + 1) < (1 << (31 - kbits)))
    if case.endswith('overflow'):
        assert int(getattr(tb, case)) > 0


def test_bin_splats_without_cull_vs_jax(rng):
    """No opacities: the reference rects, no exact-zero cull."""
    pj, pt, _, _ = scene(rng, 100)
    jb = jax.jit(functools.partial(
        jax_bin_splats, W=W, H=H, tile=TILE, pair_capacity=4096,
        tile_capacity=256, grad_index=True, need_entries=False))(pj)
    tb = bin_splats(pt, W, H, TILE, 4096, 256, grad_index=True)
    assert_bins_equal(jb, tb)
    assert int(tb.num_packed) == int(tb.num_pairs)


def test_tile_rects_vs_jax(rng):
    pj, pt, _, op = scene(rng, 200)
    for opac in (None, op):
        got = compute_tile_rects(pt, W, H, TILE, opacities=None if opac is None
                                 else torch.from_numpy(opac))
        want = jax_rects(pj, W, H, TILE, opacities=None if opac is None
                         else jnp.asarray(opac))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_lists_depth_sorted_and_match_rects(rng):
    """Each tile's list is the set of valid splats whose rect covers it,
    nearest first (the properties tests/test_tile_rasterizer.py checks)."""
    pj, pt, _, _ = scene(rng, 60)
    tb = bin_splats(pt, W, H, TILE, 4096, 256)
    x0, y0, x1, y1, _ = (a.numpy() for a in compute_tile_rects(pt, W, H,
                                                                TILE))
    valid, depth = pt.valid.numpy(), pt.depth.numpy()
    gs, ts, cn = (tb.gauss_sorted.numpy(), tb.t_start.numpy(),
                  tb.counts.numpy())
    gx = W // TILE
    for t in range(gx * gx):
        ids = gs[ts[t]:ts[t] + cn[t]]
        assert np.all(np.diff(depth[ids]) >= 0), f"tile {t} not depth sorted"
        tx, ty = t % gx, t // gx
        want = {i for i in range(60) if valid[i] and x0[i] <= tx < x1[i]
                and y0[i] <= ty < y1[i]}
        assert set(ids.tolist()) == want


def test_empty_scene_bins():
    pt = ProjectedSplats(torch.zeros((0, 2)), torch.zeros(0),
                         torch.zeros((0, 3)), torch.zeros(0, dtype=torch.int32),
                         torch.zeros(0, dtype=torch.bool))
    pj = jp.ProjectedSplats(*(jnp.asarray(t.numpy()) for t in pt))
    tb = bin_splats(pt, W, H, TILE, 1024, 32, opacities=torch.zeros(0),
                    packed_capacity=512)
    jb = jax_bin_splats(pj, W, H, TILE, 1024, 32, opacities=jnp.zeros(0),
                        packed_capacity=512)
    assert_bins_equal(jb, tb)
    assert int(tb.num_pairs) == 0 and tb.gauss_sorted.shape == (512,)


def _pairs_per_slot(starts_full, x0, y0, w, order, atab, pair_capacity, gx,
                    tile, kbits, num_tiles, packed_key):
    """The CUDA kernel's per-slot algorithm (csrc/pairs.cu), slot by slot in
    numpy: binary search for the rank, integer division for the tile, the
    cull in float32."""
    f32 = np.float32
    s = starts_full.numpy()
    n = x0.shape[0]
    total = int(s[n])
    a = atab.numpy()
    key = np.zeros(pair_capacity, np.int64)
    gid = np.zeros(pair_capacity, np.int64)
    for k in range(pair_capacity):
        r = max(int(np.searchsorted(s[:n], min(k, total - 1), 'right')) - 1,
                0)
        local = k - int(s[r])
        q, rem = divmod(local, int(w[r]))
        tx, ty = int(x0[r]) + rem, int(y0[r]) + q
        live = k < total
        if live:
            mx, my, ca, cb, cc, ln_t = (f32(v) for v in a[:, r])
            lox = f32(tx) * f32(tile) - mx
            hix = lox + f32(tile - 1)
            loy = f32(ty) * f32(tile) - my
            hiy = loy + f32(tile - 1)

            def qq(dx, dy):
                return (f32(0.5) * (ca * dx * dx + cc * dy * dy)
                        + cb * dx * dy)
            qmin = min(qq(lox, min(max(-cb * lox / cc, loy), hiy)),
                       qq(hix, min(max(-cb * hix / cc, loy), hiy)),
                       qq(min(max(-cb * loy / ca, lox), hix), loy),
                       qq(min(max(-cb * hiy / ca, lox), hix), hiy))
            if lox <= 0 and hix >= 0 and loy <= 0 and hiy >= 0:
                qmin = f32(0.0)
            live = qmin <= ln_t + f32(1e-3)
        t = ty * gx + tx if live else num_tiles
        key[k] = (t << kbits) | k if packed_key else t
        gid[k] = order[r]
    return key, gid


@pytest.mark.parametrize('pair_capacity', [1024, 700])
def test_pair_kernel_algorithm_matches_plain(rng, pair_capacity):
    """The kernel's rank search / integer division equal the plain
    version's marker + running max / float reciprocal, slot for slot,
    including slots past the total and truncation at the capacity."""
    _, pt, _, op = scene(rng, 80)
    args = pair_kernel_inputs(pt, W, H, TILE, pair_capacity,
                              torch.from_numpy(op))
    key, gid = expand_pairs_plain(**args)
    want_key, want_gid = _pairs_per_slot(**args)
    assert int(args['starts_full'][-1]) != pair_capacity
    np.testing.assert_array_equal(key.numpy(), want_key)
    np.testing.assert_array_equal(gid.numpy(), want_gid)

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
        if got is None or f == 'tile_shards':
            # tile_shards: the port's record of the strips the blend took
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


def _warp_count_le(s, n, v):
    """How many of s[:n] are <= v, by the kernel's warp search: 32 probes
    a round (one a lane), the ballot's count narrowing the interval
    32-fold."""
    lo, hi = 0, n
    while lo < hi:
        step = -(-(hi - lo) // 32)
        p = lo + (np.arange(32) + 1) * step - 1
        cnt = int(np.sum((p < hi) & (s[np.minimum(p, n - 1)] <= v)))
        lo, hi = lo + cnt * step, min(hi, lo + (cnt + 1) * step - 1)
    return lo


def _pairs_by_blocks(starts_full, x0, y0, w, order, atab, pair_capacity, gx,
                     tile, kbits, num_tiles, packed_key, block=1024,
                     per_thread=4, window=1024):
    """The CUDA kernel's chunk algorithm (csrc/pairs.cu) in numpy: per
    chunk of ``block`` slots, the ranks owning its first and last slot by
    the warp search (the last live rank for slots past the total); a chunk
    at or past the total writes the dead key and the last live rank's id;
    otherwise the ranks between are staged (at most ``window`` of them,
    the next rank's start as lookahead), each thread of ``per_thread``
    consecutive slots searches the window for its first slot's rank and
    walks forward for the rest, slots past the window search the starts
    beyond it; then the integer division for the tile and the cull in
    float32. Which block takes which chunk does not change the output."""
    f32 = np.float32
    s = starts_full.numpy()
    n = x0.shape[0]
    total = int(s[n])
    a = atab.numpy()
    key = np.zeros(pair_capacity, np.int64)
    gid = np.zeros(pair_capacity, np.int64)

    def rank_of(v):
        return max(_warp_count_le(s, n, v) - 1, 0)

    def emit(k, r):
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

    for k0 in range(0, pair_capacity, block):
        k_end = min(k0 + block, pair_capacity)
        r_last = rank_of(min(k_end - 1, total - 1))
        if k0 >= total:
            for k in range(k0, k_end):
                key[k] = (num_tiles << kbits) | k if packed_key else num_tiles
                gid[k] = order[r_last]
            continue
        r_first = rank_of(k0)
        m = r_last - r_first + 1
        win = s[r_first:r_first + min(m, window)]
        ahead = s[r_first + window] if m > window else np.iinfo(np.int64).max
        for kt in range(k0, k_end, per_thread):
            i = None
            for k in range(kt, min(kt + per_thread, k_end)):
                v = min(k, total - 1)
                if v < ahead:
                    if i is None:
                        i = int(np.searchsorted(win, v, 'right')) - 1
                    while i + 1 < len(win) and win[i + 1] <= v:
                        i += 1
                    r = r_first + i
                else:
                    beyond = s[r_first + window:r_last + 1]
                    r = (r_first + window
                         + int(np.searchsorted(beyond, v, 'right')) - 1)
                emit(k, r)
    return key, gid


@pytest.mark.parametrize('pair_capacity,block,window', [
    pytest.param(1024, 1024, 1024, id='1024'),
    pytest.param(700, 1024, 1024, id='700'),
    pytest.param(700, 4, 4, id='700-block4'),
    pytest.param(700, 16, 2, id='700-window2')])
def test_pair_kernel_algorithm_matches_plain(rng, pair_capacity, block,
                                             window):
    """The kernel's block algorithm (warp search per block, the staged
    window of ranks, the per-thread walk, integer division) equals the
    plain version's marker + running max / float reciprocal, slot for
    slot, including slots past the total, truncation at the capacity,
    ranks wider than a block (a one-rank window) or straddling two, and
    windows too small for their block's ranks."""
    _, pt, _, op = scene(rng, 80)
    args = pair_kernel_inputs(pt, W, H, TILE, pair_capacity,
                              torch.from_numpy(op))
    key, gid = expand_pairs_plain(**args)
    want_key, want_gid = _pairs_by_blocks(**args, block=block,
                                          per_thread=min(4, block),
                                          window=window)
    starts = args['starts_full']
    total = int(starts[-1])
    assert total != pair_capacity
    if block == window < 1024:      # a rank wider than a block
        assert int((starts[1:] - starts[:-1]).max()) > block
    if window < block:              # more ranks a block than the window
        assert int((starts[:-1] < total).sum()) * block > total * window
    np.testing.assert_array_equal(key.numpy(), want_key)
    np.testing.assert_array_equal(gid.numpy(), want_gid)

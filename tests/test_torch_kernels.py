"""The CUDA kernels (bloomscene_tpu_torch/csrc) against their plain PyTorch
versions, and the no-fallback rule of their build.

This file imports no JAX, so it also runs on a machine with a card and no
JAX: ``python -m pytest tests/test_torch_kernels.py -q`` there runs the
``cuda``-marked test; here it skips.

Tolerances: K3 (pair expansion) and K4 (slab expansion) bitwise; K1 (blend
forward) 1e-5 on color, acc and T and 1e-4 on the depth sum, the
tolerances of tests/test_pallas_blend.py:48-52, on a projected scene, and
bitwise on the synthetic edge cases; K2 (blend backward) atol 2e-6 + rtol
2e-4, those of tests/test_pallas_blend.py:79-80 (the kernel sums each
slot's pixels in a fixed tree, the plain version in torch's order), at
the loss's scale on the projected scene, and at a per-pixel scale on the
edge cases with the rtol applied to the summed magnitudes of each entry's
pixel terms (the rounding of a sum in another order); bitwise equal to
itself from one launch to the next.

hashgrid_bwd (the hash grid's backward, no TPU counterpart): bitwise
against ``chunked_segment_sum``, a numpy twin of its algorithm, on the
card; the twin within 1e-6 of each cell's summed magnitudes of a float64
``index_add_`` on the CPU; bitwise equal to itself from one launch to the
next.

hashgrid_encode (the hash-grid encoder, forward and backward, no TPU
counterpart): the forward bitwise its plain version, the backward's rows,
indices and gradient to x bitwise its torch twin on the card, the tables'
gradients through ``_MixEncode`` bitwise the eager path's, its gradient to
x within 1e-6 of the summed magnitudes of its terms of the eager path's
(tests/test_torch_hashgrid.py holds the twin to autograd on the CPU);
``encoder_case`` builds its inputs.

gather_rows_bwd (the compacted decode's row-gather backward and the
densify statistics' scatter, no TPU counterpart): bitwise against
``chip_smoke.sorted_segment_sum``, a numpy twin of its algorithm, on the
card, and bitwise equal to itself from one launch to the next; the twin
within 1e-6 of each row's summed magnitudes (the base's included) of a
float64 ``index_add_`` on the CPU, and bitwise the sequential
``index_add_`` (torch's sum for ``x[idx]``, and ``index_add``'s onto a
base) where every entry of a run but one is zero, as the padding's are in
a training step; at the gather's five widths, and at the statistics'
widths (1, 1, 10 and 10) with and without a base.

``blend_case`` builds the edge cases' slabs; tests/test_torch_blend_edges.py
holds the plain versions against the JAX package on the same cases.
``pairs_case`` and ``slab_case`` build K3's and K4's edge cases: the
edges of K3's blocks of 1024 slots and of its window of ranks, and of
K4's blocks of 32 positions by 32 slots.
"""
import numpy as np
import pytest
import torch

from bloomscene_tpu_torch.ops import graphics, projection
from bloomscene_tpu_torch.ops.cuda import build
from chip_smoke import sorted_segment_sum

torch.set_num_threads(2)
TILE = 16
CASE_TILES, CASE_GX, CASE_CAP = 4, 2, 40   # 2 x 2 tiles, 40 slots each
BLEND_CASES = ('walk0', 'odd_walk', 'full_column', 'early_stop', 'mixed',
               'thin')


def blend_case(case: str, tile: int, seed: int = 0):
    """A synthetic slab [10, 40, 4] over 2 x 2 tiles of ``tile`` pixels, its
    counts and its tile ids (positions permuted), for the edge cases of the
    blend kernels' batching: slots past a tile's count hold stray splats,
    as the next tile's do in a real slab.

    - walk0: every splat far outside its tile (n_contrib 0, so K2 walks
      nothing though the counts are not 0), one tile empty;
    - odd_walk: counts 13, 21, 40 and 3 (not multiples of K2's batch of 16
      slots or K1's of 64);
    - full_column: faint wide splats that every pixel blends in every
      slot, so K2 walks the whole column (walk = cap);
    - early_stop: opaque wide splats (alpha 0.98-0.99) that stop every
      pixel at its third slot (T < 1e-4), well before the count;
    - mixed: random counts and splats in and around each tile;
    - thin: as mixed with needle-like splats (axes 0.3 and 12 pixels):
      nearly singular conics, whose power terms cancel most."""
    rng = np.random.default_rng(seed)
    T, cap = CASE_TILES, CASE_CAP
    counts = {'walk0': [40, 17, 0, 40], 'odd_walk': [13, 21, 40, 3],
              'full_column': [cap] * T, 'early_stop': [cap] * T,
              'mixed': list(rng.integers(0, cap + 1, T)),
              'thin': list(rng.integers(0, cap + 1, T))}[case]
    tid = np.array([2, 0, 3, 1], np.int32)
    slab = np.zeros((10, cap, T), np.float32)
    for p in range(T):
        ox = (tid[p] % CASE_GX) * tile
        oy = (tid[p] // CASE_GX) * tile
        # axes 1 to tile/2 pixels (tile/2 to 1 below tile 2)
        sig = rng.uniform(min(1.0, tile / 2), max(1.0, tile / 2), (cap, 2))
        mx = rng.uniform(ox - 2, ox + tile + 2, cap)
        my = rng.uniform(oy - 2, oy + tile + 2, cap)
        op = rng.uniform(0.05, 0.95, cap)
        if case == 'walk0':
            mx = mx + 50.0 * tile
        elif case == 'thin':
            sig = np.stack([np.full(cap, 0.3), np.full(cap, 12.0)], 1)
        elif case in ('full_column', 'early_stop'):
            sig = np.full((cap, 2), 4.0 * tile)
            mx = np.full(cap, ox + tile / 2)
            my = np.full(cap, oy + tile / 2)
            op = np.full(cap, 0.02 if case == 'full_column' else 0.999)
        th = rng.uniform(0, np.pi, cap)
        c, s = np.cos(th), np.sin(th)
        # conic = inverse of R diag(sig^2) R^T
        ia, ib = 1 / sig[:, 0] ** 2, 1 / sig[:, 1] ** 2
        slab[0, :, p], slab[1, :, p] = mx, my
        slab[2, :, p] = c * c * ia + s * s * ib
        slab[3, :, p] = c * s * (ia - ib)
        slab[4, :, p] = s * s * ia + c * c * ib
        slab[5, :, p] = op
        slab[6, :, p] = rng.uniform(1, 5, cap)
        slab[7:10, :, p] = rng.uniform(0, 1, (3, cap))
    return (torch.from_numpy(slab), torch.tensor(counts, dtype=torch.int32),
            torch.from_numpy(tid))


PAIRS_CASES = ('ragged_capacity', 'overflow', 'exact', 'empty', 'wide_rank',
               'one_slot_runs', 'gaps')


def pairs_case(case: str, packed_key: bool, cull: bool, seed: int = 0
               ) -> dict:
    """K3's keyword arguments for a synthetic rank table on a 64 x 64 grid
    of 16-pixel tiles: random rectangles (1-8 tiles a side), ids a random
    permutation, splats near their rectangles (some slots culled).

    - ragged_capacity: a capacity that is no multiple of 1024, with dead
      blocks past the total;
    - overflow: total > capacity; exact: total == capacity;
    - empty: no rank touches a tile (total 0, every slot dead, rank 0);
    - wide_rank: one rank of 2,560 slots across three blocks;
    - one_slot_runs: 3,000 ranks of one slot each, so a block's window
      holds 1,024 ranks;
    - gaps: one-slot ranks as above, every other touching nothing though
      live ranks follow (no caller makes this): a block's 1,024 slots
      span ~2,048 ranks, so slots past the window search beyond it."""
    rng = np.random.default_rng(seed)
    gx = gy = 64
    n = 3000 if case in ('one_slot_runs', 'gaps') else 600
    rw = rng.integers(1, 9, n)
    rh = rng.integers(1, 9, n)
    if case in ('one_slot_runs', 'gaps'):
        rw[:] = rh[:] = 1
    if case == 'wide_rank':
        rw[5], rh[5] = gx, 40
    x0 = rng.integers(0, gx - rw + 1)
    y0 = rng.integers(0, gy - rh + 1)
    touched = rw * rh
    if case == 'empty':
        touched[:] = 0
    if case == 'gaps':
        touched[1::2] = 0
    starts = np.concatenate([[0], np.cumsum(touched)]).astype(np.int32)
    total = int(starts[-1])
    capacity = {'ragged_capacity': total + 2500, 'overflow': total - 777,
                'exact': total, 'empty': 2000, 'wide_rank': total + 300,
                'one_slot_runs': total + 100, 'gaps': total + 50}[case]
    if case == 'ragged_capacity' and capacity % 1024 == 0:
        capacity += 1
    tile = 16
    # conics of splats with axes 2-40 pixels, centres near the rectangle
    sig = rng.uniform(2.0, 40.0, (n, 2))
    th = rng.uniform(0, np.pi, n)
    c, s_ = np.cos(th), np.sin(th)
    ia, ib = 1 / sig[:, 0] ** 2, 1 / sig[:, 1] ** 2
    atab = np.stack([
        (x0 + rw * rng.uniform(-0.2, 1.2, n)) * tile,
        (y0 + rh * rng.uniform(-0.2, 1.2, n)) * tile,
        c * c * ia + s_ * s_ * ib, c * s_ * (ia - ib), s_ * s_ * ia + c * c * ib,
        np.log(255.0 * rng.uniform(0.02, 1.0, n))]).astype(np.float32)
    kbits = max(1, capacity - 1).bit_length()
    num_tiles = gx * gy
    assert not packed_key or (num_tiles + 1) < (1 << (31 - kbits))

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))
    return dict(starts_full=i32(starts), x0=i32(x0), y0=i32(y0),
                w=i32(rw), order=i32(rng.permutation(n)),
                atab=torch.from_numpy(atab) if cull else None,
                pair_capacity=capacity, gx=gx, tile=tile, kbits=kbits,
                num_tiles=num_tiles, packed_key=packed_key)


# (positions T, cap): T = 15 is an 80 x 48 image at tile 16
SLAB_CASES = {'T15_cap24': (15, 24), 'T15_cap40': (15, 40),
              'T70_cap1024': (70, 1024), 'T1024_cap40': (1024, 40)}


def slab_case(case: str, seed: int = 0):
    """K4's inputs (asT [10, 300 + cap], t_start_p [T], cap), a quarter
    of the starts past width - cap, so the kernel clamps them."""
    T, cap = SLAB_CASES[case]
    rng = np.random.default_rng(seed)
    width = 300 + cap
    asT = rng.normal(size=(10, width)).astype(np.float32)
    starts = rng.integers(0, width - cap + 1, T)
    starts[::4] = rng.integers(width - cap + 1, width + 1, len(starts[::4]))
    return (torch.from_numpy(asT),
            torch.from_numpy(starts.astype(np.int32)), cap)


HASHGRID_CASES = ('random', 'dead_run', 'chunk_edges', 'one_cell', 'short',
                  'levels', 'empty', 'wide')
# the 'levels' encoder: 3D levels of 5,832 (18^3) and 8,192 cells, as the
# grid's small and hashed levels, 8 corners each, anchors in slot order with
# the dead ones (one point, so one cell a level and corner) at the end
LEVEL_CELLS = (5832, 8192, 8192)
LEVEL_ANCHORS, LEVEL_DEAD = 3000, 700


def hashgrid_case(case: str, seed: int = 0):
    """The hash grid backward's inputs: cotangent rows [M, 4] float32 and
    their cells idx [M] int64 in [0, n_cells), in entry order.

    - random: 40,000 entries over 4,096 cells;
    - dead_run: 28,244 entries on one cell (every dead anchor of a
      training step sits in one cell of each level) among 20,000 random
      ones, shuffled;
    - chunk_edges: runs of 1, 63, 64, 65, 127, 128, 129 and 640 entries
      on cells of one window, then shuffled, so the window's steps of 32
      entries mix cells (each cell's entries added over several rounds);
    - one_cell: 5,000 entries on one cell (every step one run, and the
      run spans chunks);
    - short: 5 entries, fewer than one step;
    - levels: a small encoder laid out as the real one, [level, corner,
      anchor] with each level's cells a disjoint range after the ones
      before it (LEVEL_CELLS), live anchors in runs of 1-8 on one cell
      (neighbouring anchors share a cell), and one dead run of LEVEL_DEAD
      entries on one cell per level and corner, contiguous as in a
      training step;
    - empty: no entry (M = 0): every cell 0;
    - wide: 20,000 entries over 300,000 cells, more than 256 windows, so
      the kernel sorts in two radix passes and counts the windows apart."""
    rng = np.random.default_rng(seed)
    n_cells = 4096
    if case == 'random':
        idx = rng.integers(0, n_cells, 40000)
    elif case == 'dead_run':
        idx = np.concatenate([np.full(28244, 17),
                              rng.integers(0, n_cells, 20000)])
    elif case == 'chunk_edges':
        lengths = (1, 63, 64, 65, 127, 128, 129, 640)
        idx = np.repeat(rng.choice(512, len(lengths), replace=False),
                        lengths)
    elif case == 'one_cell':
        idx = np.full(5000, 4095)
    elif case == 'levels':
        parts, offset = [], 0
        for size in LEVEL_CELLS:
            live = LEVEL_ANCHORS - LEVEL_DEAD
            for _ in range(8):
                cells = offset + rng.integers(0, size, live)
                runs = np.repeat(cells, rng.integers(1, 9, live))[:live]
                parts += [runs,
                          np.full(LEVEL_DEAD, offset + rng.integers(size))]
            offset += size
        n_cells = offset
        idx = np.concatenate(parts)
    elif case == 'empty':
        idx = np.zeros(0, np.int64)
    elif case == 'wide':
        n_cells = 300000
        idx = rng.integers(0, n_cells, 20000)
    else:
        idx = rng.integers(0, n_cells, 5)
    if case != 'levels':
        idx = rng.permutation(idx)
    rows = rng.normal(size=(idx.size, 4)).astype(np.float32)
    return torch.from_numpy(rows), torch.from_numpy(idx.astype(np.int64)), \
        n_cells


def chunked_segment_sum(rows: np.ndarray, idx: np.ndarray, n_cells: int
                        ) -> np.ndarray:
    """numpy twin of csrc/hashgrid_bwd.cu, in float32 and in its order:
    entries sorted stably by window (cell >> window_bits(F)); each
    window's run cut into chunks of CHUNK; a chunk summed into its own
    zeroed table STEP entries (lanes) at a time: each run of one cell on
    consecutive lanes by the kernel's segmented Hillis-Steele scan (lane j
    adds lane j - off's value of the step before, offsets 1 to 16, within
    its run), then the runs' sums into the table in lane order; each
    cell's chunk tables added in chunk order from 0."""
    from bloomscene_tpu_torch.ops.cuda.hashgrid_bwd import (CHUNK, STEP,
                                                            window_bits)
    F = rows.shape[1]
    wb = window_bits(F)
    W = 1 << wb
    win = idx >> wb
    order = np.argsort(win, kind='stable')
    keys, vals = idx[order] & (W - 1), rows[order]
    n_win = -(-n_cells // W)
    starts = np.concatenate([[0], np.cumsum(np.bincount(win,
                                                        minlength=n_win))])
    out = np.zeros((n_win * W, F), np.float32)
    for b in range(n_win):
        acc = np.zeros((W, F), np.float32)
        for c0 in range(starts[b], starts[b + 1], CHUNK):
            c1 = min(c0 + CHUNK, starts[b + 1])
            tab = np.zeros((W, F), np.float32)
            for s0 in range(c0, c1, STEP):
                k = keys[s0:min(s0 + STEP, c1)]
                v = vals[s0:min(s0 + STEP, c1)].copy()
                lane = np.arange(k.size)
                head = np.concatenate([[True], k[1:] != k[:-1]])
                start = np.maximum.accumulate(np.where(head, lane, 0))
                off = 1
                while off < STEP:
                    src = lane - off
                    ok = src >= start
                    new = v.copy()
                    new[ok] = v[ok] + v[src[ok]]
                    v = new
                    off *= 2
                for j in np.flatnonzero(np.append(k[1:] != k[:-1], True)):
                    tab[k[j]] = tab[k[j]] + v[j]
            acc = acc + tab
        out[b * W:(b + 1) * W] = acc
    return out[:n_cells]


@pytest.mark.parametrize('case', HASHGRID_CASES)
def test_hashgrid_bwd_algorithm_matches_index_add(case):
    """The hash grid backward's algorithm (its numpy twin) against a
    float64 index_add_: within 1e-6 of each cell's summed magnitudes (the
    rounding of float32 sums in another order), untouched cells exactly
    0; the CPU wrapper is index_add_ itself."""
    from bloomscene_tpu_torch.ops.cuda.hashgrid_bwd import grid_scatter
    rows, idx, n_cells = hashgrid_case(case)
    got = chunked_segment_sum(rows.numpy(), idx.numpy(), n_cells)
    ref = torch.zeros((n_cells, 4), dtype=torch.float64).index_add_(
        0, idx, rows.double()).numpy()
    mag = torch.zeros((n_cells, 4), dtype=torch.float64).index_add_(
        0, idx, rows.double().abs()).numpy()
    assert np.all(np.abs(got - ref) <= 1e-6 * mag)
    assert np.all(got[mag == 0] == 0)
    plain = grid_scatter(rows, idx, n_cells)
    assert torch.equal(plain, torch.zeros((n_cells, 4)).index_add_(
        0, idx, rows))


@pytest.mark.cuda
@pytest.mark.parametrize('case', HASHGRID_CASES)
def test_hashgrid_bwd_kernel(case):
    """hashgrid_bwd bitwise against its numpy twin (same float32 adds in
    the same order), within 2e-6 of the summed magnitudes of its plain
    version (index_add_'s atomic float32 sums round too), and bitwise
    equal to itself across two launches."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from bloomscene_tpu_torch.ops.cuda.hashgrid_bwd import (
        grid_scatter, grid_scatter_plain)
    rows, idx, n_cells = hashgrid_case(case)
    dev = torch.device('cuda')
    got = grid_scatter(rows.to(dev), idx.to(dev), n_cells)
    again = grid_scatter(rows.to(dev), idx.to(dev), n_cells)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    twin = chunked_segment_sum(rows.numpy(), idx.numpy(), n_cells)
    assert np.array_equal(got.cpu().numpy(), twin)
    plain = grid_scatter_plain(rows.to(dev), idx.to(dev), n_cells).cpu()
    mag = grid_scatter_plain(rows.abs(), idx, n_cells)
    assert bool(((got.cpu() - plain).abs() <= 2e-6 * mag).all())


def encoder_case(spec, n: int = 2048, seed: int = 0):
    """The hash-grid encoder's inputs at ``spec`` (a ``Mix3D2DSpec``):
    x [n, 3] float32 uniform in [0, 1] but for ~5% of the rows drawn from
    [-0.5, 1.5]^3 (outside the unit cube for some or all encoders), rows
    with coordinates exactly 0 and 1, and rows within 0.02 of a face, whose
    corners lie on the boundary ring at the coarse levels; the four raw
    tables (flat, uniform in [-2, 2]: binarized to +-1, the straight-through
    gradient masked where |.| > 1); a cotangent g [n, output_dim] ~ N(0, 1).
    Numpy arrays."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (n, 3))
    out = rng.random(n) < 0.05
    x[out] = rng.uniform(-0.5, 1.5, (int(out.sum()), 3))
    edges = [(0, 0, 0), (1, 1, 1), (0, 1, 0.5), (1, 0.25, 0), (0.5, 0.5, 1)]
    x[:min(n, len(edges))] = edges[:n]
    near = slice(len(edges), min(n, len(edges) + 64))
    m = x[near].shape[0]
    x[near] = np.where(rng.random((m, 3)) < 0.5,
                       rng.uniform(0.0, 0.02, (m, 3)),
                       rng.uniform(0.98, 1.0, (m, 3)))
    sizes = {'xyz': spec.spec_xyz.n_params, 'xy': spec.spec_2d.n_params,
             'xz': spec.spec_2d.n_params, 'yz': spec.spec_2d.n_params}
    params = {k: rng.uniform(-2, 2, v * spec.n_features).astype(np.float32)
              for k, v in sizes.items()}
    g = rng.normal(size=(n, spec.output_dim)).astype(np.float32)
    return x.astype(np.float32), params, g


# (rows, narrow): the default spec at 2,048 rows, one row, and 1,000 (not
# a multiple of the kernels' 128-thread blocks); narrow tables (three 3-D
# levels, one dense, at 2^10, one hashed 2-D level at 2^10) at 1,000 and
# 129 rows
ENCODER_CASES = ((2048, False), (1, False), (1000, False), (1000, True),
                 (129, True))


def encoder_spec(narrow: bool):
    from bloomscene_tpu_torch.config import GSConfig
    from bloomscene_tpu_torch.models.model import mix_spec
    if narrow:
        return mix_spec(GSConfig(resolutions_3d=(18, 24, 33),
                                 log2_hashmap_size_3d=10,
                                 resolutions_2d=(130,),
                                 log2_hashmap_size_2d=10))
    return mix_spec(GSConfig())


@pytest.mark.cuda
@pytest.mark.parametrize('n,narrow', ENCODER_CASES)
def test_hashgrid_encode_kernel(n, narrow):
    """hashgrid_encode's forward bitwise its plain version (the eager code
    on the card); its backward's rows, indices and gradient to x bitwise
    the torch twin on the card; both the same bits twice; through
    ``_MixEncode`` the tables' gradients bitwise autograd's through the
    eager code and the gradient to x within 1e-6 of the summed magnitudes
    of its terms; at encoder_case's edges (x 0 and 1, the ring, rows
    outside the unit cube)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from bloomscene_tpu_torch.ops import hashgrid as th
    from bloomscene_tpu_torch.ops.cuda.hashgrid_encode import (
        hashgrid_encode, hashgrid_encode_bwd, hashgrid_encode_plain)
    from chip_smoke import HASHGRID_DX_RTOL, hashgrid_dx_magnitudes
    spec = encoder_spec(narrow)
    dev = torch.device('cuda')
    x, params, g = encoder_case(spec, n)
    x, g = torch.from_numpy(x).to(dev), torch.from_numpy(g).to(dev)
    params = {k: torch.from_numpy(v).to(dev) for k, v in params.items()}
    tables = th.mix_tables(params, spec)
    out = hashgrid_encode(x, tables, spec)
    assert torch.equal(out, hashgrid_encode(x, tables, spec))
    assert torch.equal(out, hashgrid_encode_plain(x, tables, spec))
    rows, idx, dx = hashgrid_encode_bwd(x, tables, g, spec)
    rows2, idx2, dx2 = hashgrid_encode_bwd(x, tables, g, spec)
    t_rows, t_idx, t_dx = th.mix_encode_backward_plain(tables, x, g, spec)
    torch.cuda.synchronize()
    for e in range(4):
        assert torch.equal(rows[e], rows2[e]) and torch.equal(idx[e], idx2[e])
        assert torch.equal(rows[e], t_rows[e]) and torch.equal(idx[e],
                                                               t_idx[e])
    assert torch.equal(dx, dx2) and torch.equal(dx, t_dx)

    def grads(fn):
        xr = x.clone().requires_grad_(True)
        ps = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        return torch.autograd.grad(
            fn(ps, xr, spec), [xr] + [ps[k] for k in th.MIX_ENCODERS], g)

    kernel, eager = grads(th.mix_encode), grads(th.mix_encode_plain)
    for a, b in zip(kernel[1:], eager[1:]):
        assert torch.equal(a, b)
    mag = hashgrid_dx_magnitudes(tables, x, g, spec)
    assert bool(((kernel[0].double() - eager[0].double()).abs()
                 <= HASHGRID_DX_RTOL * mag).all())


# (rows, the column of x outside [0, 1] in some rows, or None): the
# forward's row tiles of 32 (encode_fwd) cut at 1, 31 and 33 rows, and
# phase 33's 139,264
ENCODER_TILE_CASES = ((1, None), (31, None), (33, None), (139264, None),
                      (33, 0), (1000, 2), (139264, 1))


def tiled_encoder_x(n: int, column, seed: int = 3) -> np.ndarray:
    """x [n, 3] float32 as the decode gives it: uniform in [0, 1], rows
    sorted as the anchors are (lexicographically); with ``column``, that
    column of a third of the rows outside [0, 1] (in [-0.5, 0) or (1,
    1.5], and +-1e10 on a few)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, (n, 3))
    x = x[np.lexsort(x.T[::-1])]
    if column is not None:
        out = np.flatnonzero(rng.random(n) < 1 / 3)
        v = rng.uniform(0.0, 0.5, out.size)
        x[out, column] = np.where(rng.random(out.size) < 0.5, -v - 1e-3,
                                  1.0 + v + 1e-3)
        x[out[:4], column] = [1e10, -1e10, 1e10, -1e10][:out[:4].size]
    return x.astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize('n,column', ENCODER_TILE_CASES)
def test_hashgrid_encode_forward_tiles(n, column):
    """hashgrid_encode's forward at the default spec bitwise its plain
    version (the eager code on the card) and the same bits twice, where N
    is not a multiple of the forward's row tile and where x lies outside
    [0, 1] in one column (those rows' levels that read it 0)."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from bloomscene_tpu_torch.ops import hashgrid as th
    from bloomscene_tpu_torch.ops.cuda.hashgrid_encode import (
        hashgrid_encode, hashgrid_encode_plain)
    spec = encoder_spec(False)
    dev = torch.device('cuda')
    _, params, _ = encoder_case(spec, 1)
    x = torch.from_numpy(tiled_encoder_x(n, column)).to(dev)
    tables = th.mix_tables({k: torch.from_numpy(v).to(dev)
                            for k, v in params.items()}, spec)
    before = hashgrid_encode.launches
    out = hashgrid_encode(x, tables, spec)
    again = hashgrid_encode(x, tables, spec)
    plain = hashgrid_encode_plain(x, tables, spec)
    torch.cuda.synchronize()
    assert hashgrid_encode.launches == before + 2
    assert out.shape == (n, spec.output_dim)
    assert torch.equal(int_bits(out), int_bits(again))
    assert torch.equal(int_bits(out), int_bits(plain))
    if column is not None:
        outside = ((x[:, column] < 0) | (x[:, column] > 1)).cpu()
        assert bool(outside.any())
        # the 3-D levels read every column
        assert not bool(out[outside.to(dev), :48].any())


GATHER_CASES = ('pad0', 'pad1', 'pad2', 'pad1000', 'pad10000', 'last_live',
                'chunk_edges', 'aligned', 'short')
GATHER_WIDTHS = (3, 30, 10, 50, 6)   # anchor, offset, mask, feat, scaling
GATHER_ROWS = 4000


def gather_case(case: str, seed: int = 0, widths=GATHER_WIDTHS):
    """The row-gather backward's inputs as ``compact_visible`` makes them:
    one cotangent [V, k] float32 a leaf (GATHER_WIDTHS, the five trained
    per-anchor leaves), idx [V] int64 nondecreasing in [0, C), C, and the
    first padding entry (V where there is none).

    - padN: 1,500 visible rows of C - 1 (sorted, C - 1 not among them),
      then N padding entries on row C - 1 with zero cotangents;
    - last_live: as pad1000 with row C - 1 visible, so its run is one live
      entry and the padding;
    - chunk_edges: runs of 1, 255, 256, 257, 511, 2, 513 and 1 entries
      (nonzero cotangents) on sorted rows, crossing and ending at the
      kernel's pieces of 128 entries;
    - aligned: runs of 256, 256, 1, 255 and 256 entries, so runs end and
      start on piece boundaries, V a multiple of the piece;
    - short: 5 entries, fewer than one piece, rows unnamed before the
      first and after the last;
    - ends: runs of 1 to 300 entries (nonzero) on 60 sorted rows of the
      middle half, so the first and last quarter of the rows are unnamed.

    ``widths``: one leaf a width."""
    rng = np.random.default_rng(seed)
    C = GATHER_ROWS
    if case.startswith('pad') or case == 'last_live':
        n_pad = 1000 if case == 'last_live' else int(case[3:])
        vis = np.sort(rng.choice(C - 1, 1500, replace=False))
        if case == 'last_live':
            vis = np.append(vis, C - 1)
        idx = np.concatenate([vis, np.full(n_pad, C - 1)])
        pad_start = vis.size
    elif case == 'ends':
        rows = np.sort(rng.choice(np.arange(C // 4, 3 * C // 4), 60,
                                  replace=False))
        idx = np.repeat(rows, rng.integers(1, 301, rows.size))
        pad_start = idx.size
    else:
        lengths = {'chunk_edges': (1, 255, 256, 257, 511, 2, 513, 1),
                   'aligned': (256, 256, 1, 255, 256),
                   'short': (1, 1, 1, 1, 1)}[case]
        rows = np.sort(rng.choice(np.arange(7, C - 7), len(lengths),
                                  replace=False))
        idx = np.repeat(rows, lengths)
        pad_start = idx.size
    grads = []
    for k in widths:
        g = rng.normal(size=(idx.size, k)).astype(np.float32)
        g[pad_start:] = 0.0
        grads.append(torch.from_numpy(g))
    return grads, torch.from_numpy(idx.astype(np.int64)), C, pad_start


def split_columns(out: np.ndarray, widths=GATHER_WIDTHS) -> list:
    return np.split(out, np.cumsum(widths)[:-1], axis=1)


def int_bits(t: torch.Tensor) -> torch.Tensor:
    """A float32 tensor's bits, so that -0.0 and 0.0 differ."""
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize('case', GATHER_CASES)
def test_gather_rows_bwd_algorithm(case):
    """The row-gather backward's algorithm (its numpy twin) reads no
    partial it did not write, lies within 1e-6 of each row's summed
    magnitudes of a float64
    ``index_add_`` (unnamed rows exactly 0), and where each run's entries
    but one are zeros (every case but chunk_edges and aligned) equals the
    CPU wrapper, the sequential ``index_add_``, bit for bit."""
    from bloomscene_tpu_torch.ops.cuda.gather_rows_bwd import (
        gather_rows_bwd)
    grads, idx, C, pad_start = gather_case(case)
    twin = sorted_segment_sum(torch.cat(grads, 1).numpy(), idx.numpy(), C)
    assert not np.isnan(twin).any()
    plain = gather_rows_bwd(grads, idx, C)
    for got, want, g in zip(split_columns(twin), plain, grads):
        ref = torch.zeros((C, g.shape[1]), dtype=torch.float64).index_add_(
            0, idx, g.double()).numpy()
        mag = torch.zeros((C, g.shape[1]), dtype=torch.float64).index_add_(
            0, idx, g.double().abs()).numpy()
        assert np.all(np.abs(got - ref) <= 1e-6 * mag)
        assert np.all(got[mag == 0] == 0)
        if case not in ('chunk_edges', 'aligned'):
            assert torch.equal(int_bits(torch.from_numpy(got)),
                               int_bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize('case', GATHER_CASES)
def test_gather_rows_bwd_kernel(case):
    """gather_rows_bwd bitwise against its numpy twin, against the CPU's
    sequential ``index_add_`` where each run's entries but one are zeros,
    and against itself across two launches; within 2e-6 of the summed
    magnitudes of its plain version on the card (atomic float32 adds);
    one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from bloomscene_tpu_torch.ops.cuda.gather_rows_bwd import (
        gather_rows_bwd, gather_rows_bwd_plain)
    grads, idx, C, _ = gather_case(case)
    dev = torch.device('cuda')
    g_dev, i_dev = [g.to(dev) for g in grads], idx.to(dev)
    before = gather_rows_bwd.launches
    got = gather_rows_bwd(g_dev, i_dev, C)
    again = gather_rows_bwd(g_dev, i_dev, C)
    torch.cuda.synchronize()
    assert gather_rows_bwd.launches == before + 2
    twin = split_columns(sorted_segment_sum(torch.cat(grads, 1).numpy(),
                                            idx.numpy(), C))
    cpu = gather_rows_bwd_plain(grads, idx, C)
    card_plain = gather_rows_bwd_plain(g_dev, i_dev, C)
    for j, g in enumerate(grads):
        assert torch.equal(int_bits(got[j]), int_bits(again[j]))
        assert torch.equal(int_bits(got[j].cpu()),
                           int_bits(torch.from_numpy(twin[j])))
        if case not in ('chunk_edges', 'aligned'):
            assert torch.equal(int_bits(got[j].cpu()), int_bits(cpu[j]))
        mag = gather_rows_bwd_plain([g.abs()], idx, C)[0]
        assert bool(((got[j].cpu() - card_plain[j].cpu()).abs()
                     <= 2e-6 * mag).all())


# the statistics' widths (opacity_accum, anchor_demon, offset_grad_accum,
# offset_denom at 10 offsets): runs of single entries and the padding, the
# piece edges, rows unnamed at both ends
STATS_WIDTHS = (1, 1, 10, 10)
STATS_CASES = ('pad1000', 'last_live', 'chunk_edges', 'aligned', 'short',
               'ends')
SINGLE_NONZERO = ('pad1000', 'last_live', 'short')


def stats_case(case: str, with_base: bool):
    """gather_case at STATS_WIDTHS, and (with_base) one seeded base table
    [C, k] a leaf, nonnegative as the statistics are, else None."""
    grads, idx, C, pad_start = gather_case(case, 1, STATS_WIDTHS)
    bases = None
    if with_base:
        rng = np.random.default_rng(2)
        bases = [torch.from_numpy(rng.uniform(0, 9, (C, k)).astype(
            np.float32)) for k in STATS_WIDTHS]
    return grads, idx, C, bases


@pytest.mark.parametrize('with_base', [False, True])
@pytest.mark.parametrize('case', STATS_CASES)
def test_segment_sum_stats_algorithm(case, with_base):
    """The twin at the statistics' widths, from zeros and onto a base:
    within 1e-6 of each row's summed magnitudes (the base's included) of a
    float64 ``index_add``, unnamed rows exactly their base (or 0), and
    where each run's entries but one are zeros bitwise the CPU wrapper,
    the sequential ``index_add``."""
    from bloomscene_tpu_torch.ops.cuda.gather_rows_bwd import (
        gather_rows_bwd)
    grads, idx, C, bases = stats_case(case, with_base)
    base = None if bases is None else torch.cat(bases, 1).numpy()
    twin = sorted_segment_sum(torch.cat(grads, 1).numpy(), idx.numpy(), C,
                              base)
    assert not np.isnan(twin).any()
    plain = gather_rows_bwd(grads, idx, C, bases)
    named = np.zeros(C, bool)
    named[idx.numpy()] = True
    for j, (got, want, g) in enumerate(zip(
            split_columns(twin, STATS_WIDTHS), plain, grads)):
        b = (torch.zeros((C, g.shape[1])) if bases is None
             else bases[j]).double()
        ref = b.index_add(0, idx, g.double()).numpy()
        mag = b.abs().index_add(0, idx, g.double().abs()).numpy()
        assert np.all(np.abs(got - ref) <= 1e-6 * mag)
        assert np.array_equal(got[~named], b.numpy()[~named])
        if case in SINGLE_NONZERO:
            assert torch.equal(int_bits(torch.from_numpy(got)),
                               int_bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize('with_base', [False, True])
@pytest.mark.parametrize('case', STATS_CASES)
def test_segment_sum_stats_kernel(case, with_base):
    """gather_rows_bwd at the statistics' widths, from zeros and onto a
    base: bitwise its twin, itself across two launches, and the CPU's
    sequential ``index_add`` where each run's entries but one are zeros;
    within 2e-6 of the summed magnitudes of the atomic ``index_add`` on the
    card; the bases left as they were."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from bloomscene_tpu_torch.ops.cuda.gather_rows_bwd import (
        gather_rows_bwd, gather_rows_bwd_plain)
    grads, idx, C, bases = stats_case(case, with_base)
    dev = torch.device('cuda')
    g_dev, i_dev = [g.to(dev) for g in grads], idx.to(dev)
    b_dev = None if bases is None else [b.to(dev) for b in bases]
    kept = None if bases is None else [b.clone() for b in b_dev]
    got = gather_rows_bwd(g_dev, i_dev, C, b_dev)
    again = gather_rows_bwd(g_dev, i_dev, C, b_dev)
    torch.cuda.synchronize()
    base = None if bases is None else torch.cat(bases, 1).numpy()
    twin = split_columns(sorted_segment_sum(
        torch.cat(grads, 1).numpy(), idx.numpy(), C, base), STATS_WIDTHS)
    cpu = gather_rows_bwd_plain(grads, idx, C, bases)
    card_plain = gather_rows_bwd_plain(g_dev, i_dev, C, b_dev)
    for j, g in enumerate(grads):
        assert torch.equal(int_bits(got[j]), int_bits(again[j]))
        assert torch.equal(int_bits(got[j].cpu()),
                           int_bits(torch.from_numpy(twin[j])))
        if case in SINGLE_NONZERO:
            assert torch.equal(int_bits(got[j].cpu()), int_bits(cpu[j]))
        b = torch.zeros((C, g.shape[1])) if bases is None else bases[j]
        mag = gather_rows_bwd_plain([g.abs()], idx, C, [b.abs()])[0]
        assert bool(((got[j].cpu() - card_plain[j].cpu()).abs()
                     <= 2e-6 * mag).all())
        if kept is not None:
            assert torch.equal(b_dev[j], kept[j])


def test_cuda_wrapper_without_nvcc_raises(tmp_path, monkeypatch):
    """No fallback: with no kernel library and no nvcc, building raises."""
    monkeypatch.setattr(build, 'BUILD_DIR', tmp_path)
    monkeypatch.setattr(build, '_loaded', {})
    monkeypatch.setenv('PATH', str(tmp_path))
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    with pytest.raises(RuntimeError, match='nvcc not found'):
        build.library('blend')


@pytest.mark.parametrize('kernel,tile,error', [
    ('forward', 0, ValueError), ('forward', 33, RuntimeError),
    ('backward', 64, RuntimeError), ('backward', -1, ValueError),
    ('forward', 5, RuntimeError), ('forward', 12, RuntimeError),
    ('backward', 1, RuntimeError), ('backward', 20, RuntimeError),
    ('forward', 8, RuntimeError), ('backward', 24, RuntimeError)])
def test_blend_wrappers_check_tiles(tmp_path, monkeypatch, kernel, tile,
                                    error):
    """Either blend kernel takes any tile from 1 up (up to 32 a tile is one
    block of two-pixel threads, rounded up to whole warps; above it a tile
    is split into blocks). Tensors off the CPU go to the kernel (here on
    the meta device, which has shapes and no memory): a tile below 1 raises
    before anything is built, any other reaches the build, which raises
    without nvcc (no fallback)."""
    from bloomscene_tpu_torch.ops.cuda.blend import (blend_backward,
                                                     blend_forward)
    monkeypatch.setattr(build, 'BUILD_DIR', tmp_path)
    monkeypatch.setattr(build, '_loaded', {})
    monkeypatch.setenv('PATH', str(tmp_path))
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    dev = torch.device('meta')
    T, P = 4, max(tile, 1) ** 2
    slab = torch.empty((10, 8, T), device=dev)
    ints = torch.empty(T, dtype=torch.int32, device=dev)
    with pytest.raises(error, match='tiles of 1 pixel' if error is ValueError
                       else 'nvcc not found'):
        if kernel == 'forward':
            blend_forward(slab, ints, ints, tile, 2)
        else:
            planes = [torch.empty((P, T), device=dev) for _ in range(7)]
            ncon = torch.empty((P, T), dtype=torch.int32, device=dev)
            blend_backward(slab, ints, ints, tile, 2, planes[0], ncon,
                           *planes[1:])


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


@pytest.mark.cuda
@pytest.mark.parametrize('case,tile', [(c, 16) for c in BLEND_CASES]
                         + [('mixed', 8), ('full_column', 8), ('mixed', 24),
                            ('mixed', 32), ('full_column', 32)]
                         + [(c, t) for t in (1, 4, 5, 12, 20)
                            for c in ('mixed', 'full_column', 'early_stop')]
                         + [(c, t) for t in (33, 40, 48, 64)
                            for c in ('mixed', 'full_column')])
def test_blend_kernels_edge_cases(case, tile):
    """K1 bitwise and K2 within the rounding of its pixel sums, against
    their plain versions, at the edges of the kernels' slot batches and at
    tiles 8 (a one-warp block), 24 (nine warps, K2 just under 48 KB of
    shared memory) and 32 (K2 above 48 KB) beside 16, at tiles whose
    pixel count is no multiple of 64, so the last warp holds inactive
    lanes: 1 (one pixel), 4 and 12 (even), 5 (odd: a thread's two pixels
    straddle two rows) and 20, and at tiles split into several blocks:
    33 (odd, two blocks), 40 (two blocks, the last short), 48 (three full
    blocks) and 64 (four blocks of 1,024 pixels); K2 twice, bitwise, with
    every row at or past a tile's walk zero."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from bloomscene_tpu_torch.ops.cuda.blend import (blend_backward,
                                                     blend_backward_plain,
                                                     blend_forward,
                                                     blend_forward_plain,
                                                     blend_walk)
    dev = torch.device('cuda')
    slab, counts, tid = (x.to(dev) for x in blend_case(case, tile))
    got = blend_forward(slab, counts, tid, tile, CASE_GX)
    want = blend_forward_plain(slab, counts, tid, tile, CASE_GX)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    Tf, ncon = want[5], want[6]
    walk = blend_walk(counts, ncon)
    expect_walk = {'walk0': [0] * 4, 'full_column': [CASE_CAP] * 4,
                   'early_stop': [2] * 4}
    if case in expect_walk:
        assert walk.tolist() == expect_walk[case]
    rng = np.random.default_rng(1)
    u = [torch.from_numpy(rng.normal(size=Tf.shape).astype(np.float32)
                          ).to(dev) for _ in range(6)]
    args = (slab, counts, tid, tile, CASE_GX, Tf, ncon, *u)
    got = blend_backward(*args)
    again = blend_backward(*args)
    want = blend_backward_plain(*args)
    tol = 2e-6 + 2e-4 * blend_backward_plain(*args, magnitude=True)
    torch.cuda.synchronize()
    assert bool(((got - want).abs() <= tol).all())
    assert torch.equal(got, again)
    past = (torch.arange(CASE_CAP, device=dev)[:, None] >= walk[None, :])
    assert bool((got[:, past] == 0).all())
    if int(walk.sum()):
        assert float(want.abs().max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize('cull', [True, False], ids=['cull', 'no_cull'])
@pytest.mark.parametrize('packed_key', [True, False],
                         ids=['packed', 'two_key'])
@pytest.mark.parametrize('case', PAIRS_CASES)
def test_pair_kernel_edge_cases(case, packed_key, cull):
    """K3 bitwise against its plain version at the edges of its blocks
    and windows, in both key forms, with the cull on and off."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from bloomscene_tpu_torch.ops.cuda.pairs import (expand_pairs,
                                                     expand_pairs_plain)
    args = pairs_case(case, packed_key, cull)
    total = int(args['starts_full'][-1])
    cap = args['pair_capacity']
    assert {'overflow': total > cap, 'exact': total == cap,
            'empty': total == 0}.get(case, total < cap)
    want = expand_pairs_plain(**args)
    dev = torch.device('cuda')
    got = expand_pairs(**{k: v.to(dev) if isinstance(v, torch.Tensor) else v
                          for k, v in args.items()})
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(SLAB_CASES))
def test_slab_kernel_edge_cases(case):
    """K4 bitwise against its plain version with T and cap no multiples
    of its block's 32 positions and 32 slots, and clamped starts."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    from bloomscene_tpu_torch.ops.cuda.expand import (expand_slab,
                                                      expand_slab_plain)
    asT, starts, cap = slab_case(case)
    assert int((starts > asT.shape[1] - cap).sum()) > 0
    want = expand_slab_plain(asT, starts, cap)
    got = expand_slab(asT.cuda(), starts.cuda(), cap)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)

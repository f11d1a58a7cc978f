"""The blend backward's emission-order reduction (``emission_sums``, CUDA
``csrc/emission_sums.cu``) and its plain version.

On the CPU: ``chip_smoke.emission_sums_twin``, the torch twin of the
kernel's order of additions, bitwise a loop that follows the kernel's
algorithm (a range of at most WARP_RANGE slots in slot order from 0, a
longer one in 32 lane-strided partials and a butterfly) and within its
rounding bound of a float64 sum (the additions a term goes through, plus
one, times 2^-24, times the range's summed magnitudes); the plain version
(the CPU path: the JAX package's cumsum difference) within that bound
plus the prefix sums' rounding of the float64 sum; on ranges with dead
lanes, empty and reversed ranges, ranges clamped at the pair capacity,
one range of 1,024 slots, lengths at the edge of WARP_RANGE and of a
warp, and counts of Gaussians that are not multiples of 32.

This file imports no JAX, so its ``cuda`` test runs on a machine with a
card and no JAX: the kernel at the main path's shape (grad [10, 1024,
1024], pair capacity 2,097,152, 1,310,720 Gaussians, heavy-tailed ranges)
bitwise its twin on the CPU, within its rounding bound of a float64 sum,
bitwise equal to itself across launches and under a CUDA graph's replay,
one launch a call.
"""
import numpy as np
import pytest
import torch

from bloomscene_tpu_torch.ops.cuda.emission_sums import (
    WARP_RANGE, emission_sums)
from chip_smoke import bit_equal, emission_sums_twin, range_lengths, sum_depth

U = 2.0 ** -24      # float32's unit roundoff

# name: (Gaussians, cap, tiles, share of dead lanes, lengths' kind)
CASES = {
    'dead_lanes': (1000, 8, 12, 0.5, 'short'),
    'empty': (777, 8, 12, 0.1, 'empty'),
    'clamped': (1003, 8, 12, 0.1, 'overflow'),
    'long_1024': (501, 32, 64, 0.1, 'long'),
    'odd_n': (33, 8, 12, 0.1, 'mixed'),
    'warp_edges': (2047, 16, 32, 0.1, 'edges'),
}


def range_case(case: str):
    """K2's gradients [10, cap, T], the lanes of the emission slots and
    each Gaussian's range, as binning lays them out: the Gaussians emit in
    a shuffled order, each its range of slots in turn; the slots past the
    ranges, and a share of those in them, carry the dead lane cap * T."""
    n, cap, T, dead, kind = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case) + 7)
    length = rng.integers(0, 5, n)
    if kind == 'empty':
        length[rng.uniform(size=n) < 0.7] = 0
    if kind in ('long', 'mixed'):
        length[rng.integers(n)] = 1024 if kind == 'long' else 40
    if kind in ('long', 'edges'):
        wide = rng.choice(n, 40, replace=False)
        length[wide] = rng.choice([WARP_RANGE, WARP_RANGE + 1, 31, 32, 33,
                                   64, 65, 200], 40)
    order = rng.permutation(n)
    ends_e = np.cumsum(length[order])
    starts = np.empty(n, np.int64)
    ends = np.empty(n, np.int64)
    starts[order] = ends_e - length[order]
    ends[order] = ends_e
    pc = int(ends_e[-1]) + 50
    if kind == 'overflow':
        pc = int(ends_e[-1]) * 2 // 3     # the last third past capacity
    if kind == 'empty':
        # a few reversed ranges, as past capacity: empty too
        rev = rng.choice(n, 20, replace=False)
        starts[rev] = ends[rev] + 3
    n_lanes = cap * T
    lanes = rng.integers(0, n_lanes, pc)
    lanes[rng.uniform(size=pc) < dead] = n_lanes
    lanes[int(min(ends_e[-1], pc)):] = n_lanes
    mag = rng.uniform(0.5, 1.5, (10, cap, T))
    grad = np.where(rng.uniform(size=mag.shape) < 0.5, -mag, mag)
    return (torch.from_numpy(grad.astype(np.float32)),
            torch.from_numpy(lanes.astype(np.int32)),
            torch.from_numpy(starts.astype(np.int32)),
            torch.from_numpy(ends.astype(np.int32)))


def kernel_loop(grad, src_lane, starts, ends) -> np.ndarray:
    """The kernel's algorithm as a loop, in float32: a range of at most
    WARP_RANGE slots added in slot order from 0; a longer one in 32
    partials (partial l adds slots l, l + 32, ... from 0), combined by
    p[l] + p[l ^ off] for off = 16, 8, 4, 2, 1."""
    g = grad.reshape(10, -1).numpy()
    lanes, pc = src_lane.numpy(), src_lane.shape[0]
    out = np.zeros((10, starts.shape[0]), np.float32)
    for i, (s, e) in enumerate(zip(starts.tolist(), ends.tolist())):
        s, e = min(s, pc), min(e, pc)
        p = np.zeros((32 if e - s > WARP_RANGE else 1, 10), np.float32)
        for k in range(s, e):
            if lanes[k] < g.shape[1]:
                p[(k - s) % p.shape[0]] += g[:, lanes[k]]
        if p.shape[0] == 32:
            for off in (16, 8, 4, 2, 1):
                p = p + p[np.arange(32) ^ off]
        out[:, i] = p[0]
    return out


@pytest.mark.parametrize('case', sorted(CASES))
def test_emission_sums_twin_and_plain(case):
    """The kernel's twin bitwise the loop of its algorithm and within its
    rounding bound of a float64 sum (exactly 0 where a range holds no live
    slot); the plain version, the CPU path, within that bound plus the
    prefix sums' rounding; every case holds what its name says."""
    grad, src_lane, starts, ends = range_case(case)
    n_lanes = grad.shape[1] * grad.shape[2]
    twin = emission_sums_twin(grad, src_lane, starts, ends, WARP_RANGE)
    assert twin.dtype == torch.float32 and twin.shape == (10, starts.shape[0])
    assert bit_equal(twin, torch.from_numpy(
        kernel_loop(grad, src_lane, starts, ends)))
    want = emission_sums_twin(grad.double(), src_lane, starts, ends,
                              WARP_RANGE)
    mag = emission_sums_twin(grad.double().abs(), src_lane, starts, ends,
                             WARP_RANGE)
    length, in_range = range_lengths(src_lane, starts, ends)
    bound = (sum_depth(length, WARP_RANGE) + 1).double() * U * mag
    assert bool(((twin.double() - want).abs() <= bound).all())
    assert bool((twin[:, (mag == 0).all(0)] == 0).all())
    # the plain version's two prefix sums, each over at most pc entries
    plain = emission_sums(grad, src_lane, starts, ends)
    flat = grad.double().abs().reshape(10, -1)
    live = src_lane < n_lanes
    prefix = (2 * src_lane.shape[0] + 2) * U * flat[:, src_lane[live].long()
                                                    ].sum(1)
    assert bool(((plain.double() - want).abs()
                 <= (length + 1).double() * U * mag + prefix[:, None]).all())
    assert bool((plain[:, length == 0] == 0).all())
    if case == 'dead_lanes':
        assert 0.4 < float((~live[in_range]).double().mean()) < 0.6
    if case == 'empty':
        assert int((length == 0).sum()) > starts.shape[0] // 2
        assert bool((twin[:, starts > ends] == 0).all())
    if case == 'clamped':
        assert int((ends > src_lane.shape[0]).sum()) > 100
        assert bool((twin[:, starts >= src_lane.shape[0]] == 0).all())
    if case == 'long_1024':
        assert int(length.max()) == 1024
    if case in ('odd_n', 'warp_edges'):
        assert starts.shape[0] % 32 != 0
    if case == 'warp_edges':
        assert {WARP_RANGE, WARP_RANGE + 1, 32, 33} <= set(length.tolist())


MAIN_N, MAIN_CAP, MAIN_T, MAIN_PC = 1_310_720, 1024, 1024, 2_097_152


def main_path_case():
    """The main path's shape: 1,310,720 Gaussians, 12% of them with a
    range (lengths 1 + geometric, 3% of those 17-400 slots, one 1,024),
    the last in emission order running past the pair capacity; 10% of the
    slots in ranges dead."""
    rng = np.random.default_rng(18)
    n = MAIN_N
    length = np.zeros(n, np.int64)
    some = rng.uniform(size=n) < 0.12
    length[some] = rng.geometric(0.45, int(some.sum()))
    wide = np.flatnonzero(some)[rng.uniform(size=int(some.sum())) < 0.03]
    length[wide] = rng.integers(WARP_RANGE + 1, 400, wide.size)
    length[wide[0]] = 1024
    order = rng.permutation(n)
    ends_e = np.cumsum(length[order])
    assert ends_e[-1] < MAIN_PC
    ends_e += MAIN_PC - int(ends_e[-1]) + 5000    # past capacity at the end
    starts = np.empty(n, np.int64)
    ends = np.empty(n, np.int64)
    starts[order] = ends_e - length[order]
    ends[order] = ends_e
    n_lanes = MAIN_CAP * MAIN_T
    lanes = rng.integers(0, n_lanes, MAIN_PC)
    lanes[rng.uniform(size=MAIN_PC) < 0.1] = n_lanes
    grad = rng.standard_normal((10, MAIN_CAP, MAIN_T), np.float32)
    return (torch.from_numpy(grad),
            torch.from_numpy(lanes.astype(np.int32)),
            torch.from_numpy(starts.astype(np.int32)),
            torch.from_numpy(ends.astype(np.int32)))


@pytest.mark.cuda
def test_emission_sums_kernel():
    """emission_sums at the main path's shape: bitwise its twin on the
    CPU, within its rounding bound of a float64 sum, bitwise equal to
    itself across launches and under a CUDA graph's replay; one launch a
    call."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    args = main_path_case()
    dev = torch.device('cuda')
    d_args = [t.to(dev) for t in args]
    before = emission_sums.launches
    got = emission_sums(*d_args)
    again = emission_sums(*d_args)
    torch.cuda.synchronize()
    assert emission_sums.launches == before + 2
    assert bit_equal(got, again)

    length, _ = range_lengths(*args[1:])
    assert int(length.max()) == 1024
    assert int((length > 32).sum()) > 1000
    assert int((args[3] > MAIN_PC).sum()) > 0   # clamped at the capacity
    got_c = got.cpu()
    assert bit_equal(got_c, emission_sums_twin(*args, WARP_RANGE))
    want = emission_sums_twin(args[0].double(), *args[1:], WARP_RANGE)
    mag = emission_sums_twin(args[0].double().abs(), *args[1:], WARP_RANGE)
    bound = (sum_depth(length, WARP_RANGE) + 1).double() * U * mag
    assert bool(((got_c.double() - want).abs() <= bound).all())

    # captured: the stream's work recorded once, replayed
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        emission_sums(*d_args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = emission_sums(*d_args)
    captured.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert bit_equal(captured, got)

"""The count functions against the kernel table's counts at its shapes,
and the MFU's FLOP count hand-worked on a tiny model."""
import math

import pytest
import torch

from perfbench import counts, harness, readers

PEAKS = harness.load_json(harness.BENCH_DIR / "peaks.json")
GS = harness.load_json(harness.BENCH_DIR / "configs" / "room111k.json")[
    "gsconfig"]


def ms(nbytes, ops=0.0):
    return 1e3 * counts.least_s(nbytes, ops, PEAKS)


def test_gather_rows_bwd_matches_the_table():
    # a compacted step: 131,072 entries x 99 floats into 139,264 rows,
    # bound 0.0323 ms; the statistics, 22 floats onto bases, 0.0111 ms
    assert ms(counts.gather_step_bytes(131072, 139264, 99, False)) == \
        pytest.approx(0.0323, abs=5e-5)
    assert ms(counts.gather_step_bytes(131072, 139264, 22, True)) == \
        pytest.approx(0.0111, abs=5e-5)


def test_blend_counts_by_hand():
    tile, cap = 2, 4
    counts_p = torch.tensor([3, 0, 4], dtype=torch.int32)   # T = 3
    ncon = torch.tensor([[1, 0, 2], [3, 0, 4], [2, 0, 1], [0, 0, 3]],
                        dtype=torch.int32)                  # P = 4
    b1, o1 = counts.k1_bytes_ops(counts_p, ncon, tile)
    assert b1 == 4 * (10 * 7 + 2 * 3 + 7 * 4 * 3)
    assert o1 == 30 * 16
    b2, o2 = counts.k2_bytes_ops(counts_p, ncon, tile, cap)
    walk = 3 + 0 + 4          # min(count, the tile's largest n_contrib)
    assert b2 == 4 * (10 * walk + 8 * 4 * 3 + 2 * 3 + 10 * cap * 3)
    assert o2 == 71 * 16


TINY = {"feat_dim": 2, "n_offsets": 1, "n_features_per_level": 1,
        "resolutions_3d": [4], "resolutions_2d": [4]}


def test_head_flops_by_hand():
    # opacity (6, 2, 1): 2 (6*2 + 2*1) = 28; cov (6, 2, 7): 52;
    # color (6, 2, 3): 36; the grid head (4, 4, 25): 2 (16 + 100) = 232
    assert counts.head_flops(TINY, 0) == (116, 0.0)
    assert counts.head_flops(TINY, 2) == (116, 232)


@pytest.mark.parametrize("phase,context", [(0, 0), (2, 232)])
def test_mfu_by_hand(phase, context):
    ctx = {"trace": {"window_s": 1e-3, "busy_s": 9e-4},
           "work": {"k1": [(0, 100.0), (0, 200.0)],
                    "k2": [(0, 300.0), (0, 400.0)]},
           "traced_records": [{"n_visible_anchors": 10.0},
                              {"n_visible_anchors": 20.0}],
           "config": {"gsconfig": TINY}, "traffic": {"phase": phase},
           "peaks": PEAKS}
    flops = 3 * (116 + context) * 30 + 1000
    got = readers.reader("mfu_pct.train")(ctx)
    assert got == pytest.approx(100 * flops / 1e-3 / 67e12, rel=1e-12)


def test_union_and_gaps():
    from perfbench.tracing import union_length
    total, gaps = union_length([(0, 2), (1, 3), (5, 6), (6, 7)])
    assert total == 5 and gaps == [(3, 5)]


@pytest.mark.parametrize("with_steps", [True, False])
def test_trace_reduction(with_steps):
    """Busy time, the window and the idle gaps of a device-only trace (no
    profiler step: the window spans the events) and of one with steps."""
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    from perfbench.tracing import reduce_events

    def ev(name, dev, a, b):
        return NS(name=name, device_type=dev,
                  time_range=NS(start=a, end=b))
    events = [ev("cudaGraphLaunch", DeviceType.CPU, 0, 10),
              ev("k_blend_fwd", DeviceType.CUDA, 10, 40),
              ev("cudaMemcpyAsync", DeviceType.CPU, 45, 70),
              ev("k_other", DeviceType.CUDA, 60, 100)]
    if with_steps:
        events.append(ev("ProfilerStep#1", DeviceType.CPU, 0, 100))
    out = reduce_events(events, {"groups": {"blend": ["k_blend_fwd"]}})
    assert out["window_s"] == pytest.approx(100e-6)
    assert out["busy_s"] == pytest.approx(70e-6)
    assert out["groups"]["blend"] == {"seconds": pytest.approx(30e-6),
                                      "launches": 1}
    assert out["breakdown"]["idle_gaps"] == [
        ["host: cudaMemcpyAsync", pytest.approx(20e-6)]]


def test_roofline_shares_never_pass_100_on_the_least_time():
    """A share is the least time over the measured time: the measured
    time at the least time reads 100%."""
    ctx = {"trace": {"groups": {"K1 blend forward": {"seconds": 0.0,
                                                      "launches": 2},
                                "K2 blend backward": {"seconds": 0.0,
                                                      "launches": 1}}},
           "work": {"k1": [(1e6, 0.0)], "k2": [(2e6, 0.0)]},
           "traced_records": [{}], "peaks": PEAKS}
    least = 2 * 1e6 / 3.35e12 + 2e6 / 3.35e12
    ctx["trace"]["groups"]["K1 blend forward"]["seconds"] = least / 2
    ctx["trace"]["groups"]["K2 blend backward"]["seconds"] = least / 2
    assert readers.reader("blend_roofline_pct.train")(ctx) == \
        pytest.approx(100.0)
    assert math.isfinite(least)

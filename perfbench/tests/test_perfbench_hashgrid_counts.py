"""The hash-grid encoder's count (``counts_hashgrid``) by hand on a tiny
grid, and the readers of the hash-grid cell's metrics on synthetic
windows: the values worked by hand, None where the run holds nothing to
read (a program without the ``hashgrid.backward`` span, a trace without
the encoder's kernels)."""
import pytest

from perfbench import counts_hashgrid, harness, readers

PEAKS = harness.load_json(harness.BENCH_DIR / "peaks.json")
# 3D: one level at R 4 (4^3 = 64 > 2^4 cells: 16); planes: R 3 (9 cells,
# padded to 16) and R 5 (25 > 16: 16); 2 features a cell
TINY = {"n_features_per_level": 2, "resolutions_3d": [4],
        "log2_hashmap_size_3d": 4, "resolutions_2d": [3, 5],
        "log2_hashmap_size_2d": 4}


def test_counts_by_hand():
    assert counts_hashgrid.table_floats(TINY) == 16 * 2 + 3 * (16 + 16) * 2
    assert counts_hashgrid.feature_width(TINY) == (1 + 3 * 2) * 2
    fwd, bwd = counts_hashgrid.encode_bytes(10, TINY)
    x, tables, feats = 4 * 3 * 10, 4 * 224, 4 * 14 * 10
    assert fwd == x + tables + feats == 1576
    assert bwd == (x + tables + feats) + (x + tables) == 2592


def test_counts_at_the_cell_widths():
    gs = harness.load_json(harness.BENCH_DIR / "configs"
                           / "hac_indoor1557.json")["gsconfig"]
    # 12 3D levels (5,832 cells at R 18, then 8,192) and 4 levels of each
    # plane (16,904 cells at R 130, then 32,768), 4 features a cell
    assert counts_hashgrid.table_floats(gs) == 4 * (
        5832 + 11 * 8192 + 3 * (16904 + 3 * 32768))
    assert counts_hashgrid.feature_width(gs) == 96


def trace(fwd_s, bwd_s, sums_s, fwd_n=4, bwd_n=2):
    return {"groups": {
        "hashgrid_encode forward": {"seconds": fwd_s, "launches": fwd_n},
        "hashgrid_encode backward": {"seconds": bwd_s, "launches": bwd_n},
        "hashgrid_bwd": {"seconds": sums_s, "launches": 7 * bwd_n}}}


def test_roofline_by_hand():
    ctx = {"trace": trace(1e-6, 2e-6, 3e-6), "work": {"rows": 10},
           "config": {"gsconfig": TINY}, "peaks": PEAKS}
    least = (4 * 1576 + 2 * 2592) / PEAKS["hbm_bytes_per_s"]
    got = readers.reader("hashgrid_roofline_pct.train")(ctx)
    assert got == pytest.approx(100 * least / 6e-6)
    # at the least time itself: 100%
    ctx["trace"] = trace(least / 3, least / 3, least / 3)
    assert readers.reader("hashgrid_roofline_pct.train")(ctx) == \
        pytest.approx(100.0)


def test_roofline_without_the_kernels():
    ctx = {"trace": {"groups": {"K1 blend forward": {"seconds": 1.0,
                                                     "launches": 1}}},
           "work": {"rows": 10}, "config": {"gsconfig": TINY},
           "peaks": PEAKS}
    assert readers.reader("hashgrid_roofline_pct.train")(ctx) is None
    assert readers.reader("hashgrid_roofline_pct.train")({}) is None


S, F, B = "train.step", "train.step/train.forward", "train.step/train.backward"
D = F + "/render.decode"
SPAN_MS = {S: 1.0, F: 0.5, D: 10.0, D + "/decode.context": 4.0,
           D + "/decode.rate": 3.0, B: 12.0,
           B + "/render.decode": 9.0, B + "/render.decode/decode.context": 5.0,
           B + "/render.decode/decode.rate": 2.5,
           B + "/hashgrid.backward": 6.0,
           B + "/gather_rows.backward": 1.5}


def chunks(spans):
    return [{"span_ms": {k: v * s * 2 for k, v in spans.items()},
             "stamped_steps": 2} for s in (1.0, 2.0, 3.0)]


def test_context_readers_by_hand():
    ctx = {"chunks": chunks(SPAN_MS)}
    # first pass only; the median chunk is scale 2
    assert readers.reader("context_ms.train")(ctx) == \
        pytest.approx(2 * (4.0 + 3.0))
    assert readers.reader("context_bwd_ms.train")(ctx) == \
        pytest.approx(2 * 6.0)


def test_context_readers_without_the_spans():
    """The parent's records: no ``hashgrid.backward`` span; a phase-0 step
    runs neither the context nor the rate."""
    old = {k: v for k, v in SPAN_MS.items() if "hashgrid" not in k}
    assert readers.reader("context_bwd_ms.train")(
        {"chunks": chunks(old)}) is None
    assert readers.reader("context_bwd_ms.train")({"chunks": []}) is None
    phase0 = {k: v for k, v in old.items() if "decode." not in k}
    assert readers.reader("context_ms.train")(
        {"chunks": chunks(phase0)}) == 0.0
    assert readers.reader("context_ms.train")({"chunks": []}) is None


def test_bucket_fill_by_hand():
    ctx = {"config": {"gsconfig": {"visible_capacity": 1000}},
           "traffic": {},
           "records": [{"n_visible_anchors": 900.0},
                       {"n_visible_anchors": 1100.0}]}
    assert readers.reader("bucket_fill_pct.train")(ctx) == \
        pytest.approx(110.0)
    ctx["traffic"] = {"gsconfig": {"visible_capacity": 2000}}
    assert readers.reader("bucket_fill_pct.train")(ctx) == \
        pytest.approx(55.0)
    ctx["config"]["gsconfig"]["visible_capacity"] = None
    ctx["traffic"] = {}
    assert readers.reader("bucket_fill_pct.train")(ctx) is None


def test_the_cell_s_metrics_are_declared():
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    declared = {m["name"]: m for m in spec["per_layer"]}
    for name in ("context_ms.train", "context_bwd_ms.train",
                 "hashgrid_roofline_pct.train", "bucket_fill_pct.train"):
        m = declared[name]
        assert m["workloads"] == ["hac_indoor1557.train_p2"]
        assert m["moves"] == "train_steps_per_s"
        assert callable(readers.reader(name))

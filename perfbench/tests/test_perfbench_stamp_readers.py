"""The readers of the program's own tracing (device stamps in the replayed
step, host spans at the chunk boundary, the step graph's kernel nodes):
each gives the value worked by hand on a synthetic window, None on the
records of a program that does not stamp its steps, and a value on the
records a tiny device-loop run on the CPU leaves."""
import pytest

from perfbench import harness, readers
from perfbench.tests.tiny import TINY_SEED, tiny_files

SPEC = harness.load_json(harness.ROOT / "BENCHMARK.json")
STAMPED = ["prefilter_ms.train", "decode_ms.train", "bin_ms.train",
           "blend_fwd_ms.train", "losses_ms.train", "recompute_ms.train",
           "blend_bwd_ms.train", "blend_reduce_ms.train",
           "gather_bwd_ms.train", "backward_rest_ms.train",
           "update_ms.train", "stats_ms.train", "step_gap_ms.train",
           "boundary_idle_ms.train", "scalar_table_ms.train",
           "boundary_named_pct.train"]
NEW = STAMPED + ["graph_kernels.train"]

S, F, B = "train.step", "train.step/train.forward", "train.step/train.backward"
SPAN_MS = {S: 1.0, "train.step/train.prefilter": 2.0,
           F: 0.5, F + "/render.compact": 3.0, F + "/render.decode": 10.0,
           F + "/render.decode/decode.context": 4.0, F + "/render.bin": 6.0,
           F + "/tile_blend.forward": 8.0, F + "/train.losses": 5.0,
           B: 12.0, B + "/render.compact": 1.0, B + "/render.decode": 9.0,
           B + "/render.bin": 7.0, B + "/tile_blend.forward": 3.0,
           B + "/tile_blend.backward": 2.0,
           B + "/tile_blend.backward/tile_blend.cotangents": 4.0,
           B + "/tile_blend.backward/tile_blend.k2": 20.0,
           B + "/tile_blend.backward/tile_blend.reduce": 6.0,
           B + "/gather_rows.backward": 1.5,
           "train.step/train.update": 11.0, "train.step/train.stats": 2.5}


def chunk(scale, boundary, unnamed, scalars, steps=2):
    """A chunk of ``steps`` stamped steps whose span ms are ``scale``
    times SPAN_MS a step."""
    return {"span_ms": {k: v * scale * steps for k, v in SPAN_MS.items()},
            "stamped_steps": steps, "step_gap_ms": 0.25 * (steps - 1),
            "boundary_idle_ms": boundary,
            "host_ms": ({"loop.scalars": scalars} if unnamed is None
                        else {"loop.scalars": scalars, "unnamed": unnamed})}


def ctx():
    return {"chunks": [chunk(1.0, None, None, 4.0), chunk(2.0, 10.0, 0.5, 6.0),
                       chunk(3.0, 30.0, 3.0, 5.0)],
            "graphs": [{"replays": 10, "nodes": {"by_type": {"kernel": 900},
                                                 "stamps": 40}},
                       {"replays": 90, "nodes": {"by_type": {"kernel": 700,
                                                             "memset": 3},
                                                 "stamps": 40}}],
            "traffic": {"track_stats": True}}


# a step's value at scale 1; the median chunk is scale 2
HAND = {"prefilter_ms.train": 2.0 + 3.0, "decode_ms.train": 10.0 + 4.0,
        "bin_ms.train": 6.0, "blend_fwd_ms.train": 8.0,
        "losses_ms.train": 5.0, "recompute_ms.train": 1.0 + 9.0 + 7.0 + 3.0,
        "blend_bwd_ms.train": 2.0 + 4.0 + 20.0, "blend_reduce_ms.train": 6.0,
        "gather_bwd_ms.train": 1.5, "backward_rest_ms.train": 12.0,
        "update_ms.train": 11.0, "stats_ms.train": 2.5}


@pytest.mark.parametrize("name", sorted(HAND))
def test_span_readers_by_hand(name):
    assert readers.reader(name)(ctx()) == pytest.approx(2.0 * HAND[name])


def test_loop_readers_by_hand():
    c = ctx()
    assert readers.reader("step_gap_ms.train")(c) == pytest.approx(0.25)
    # boundaries 10 and 30 (the first chunk has none): their median
    assert readers.reader("boundary_idle_ms.train")(c) == pytest.approx(20.0)
    assert readers.reader("scalar_table_ms.train")(c) == pytest.approx(5.0)
    # shares 95% and 90%
    assert readers.reader("boundary_named_pct.train")(c) == \
        pytest.approx(92.5)
    # the graph replayed most, its 40 stamps left out
    assert readers.reader("graph_kernels.train")(c) == 660


@pytest.mark.parametrize("name", NEW)
def test_readers_without_the_fields(name):
    """A parent commit's records: chunks and graphs without the new
    fields, as ``ChunkTimer`` and ``StepGraph`` kept them before."""
    old = {"chunks": [{"first": 1, "last": 50, "phase": 0, "ms": 1100.0,
                       "captures": 0, "eager_steps": 0, "surgery": False,
                       "peak_mem_bytes": 1, "track_stats": True}],
           "graphs": [{"phase": 0, "track_stats": True, "replays": 49,
                       "replay_ms": 1100.0, "launches": {}}],
           "traffic": {"track_stats": True}}
    assert readers.reader(name)(old) is None
    assert readers.reader(name)({"chunks": [], "graphs": [],
                                 "traffic": {"track_stats": True}}) is None


def test_every_new_metric_is_declared():
    declared = {m["name"]: m for m in SPEC["per_layer"]}
    for name in NEW:
        m = declared[name]
        assert m["moves"] == "train_steps_per_s" and "workloads" not in m
        assert callable(readers.reader(name))


def test_readers_on_a_cpu_run():
    """Two chunks of a tiny run of the cell's trainer on the CPU (the
    stamps' plain version) give every stamp reader a value; the graph
    counter has no graph to read there."""
    cell = SPEC["workloads"][0]["name"]
    files = tiny_files(cell)
    config, traffic = files["config"], files["traffic"]
    inputs = harness.make_inputs(config, traffic, TINY_SEED, "cpu")
    trainer = harness.build_trainer(config, traffic, inputs, TINY_SEED,
                                    "cpu")
    from bloomscene_tpu_torch.scene.cameras import CameraArrays
    views = harness.views_for(CameraArrays, inputs, "cpu")
    chunk_n = config["gsconfig"]["device_loop_chunk"]
    trainer.run(views, iterations=traffic["start_step"] + 2 * chunk_n,
                log_every=1, device_loop=True, max_chunk=chunk_n)
    c = {"chunks": trainer.chunk_log, "graphs": [], "traffic": traffic}
    for name in STAMPED:
        value = readers.reader(name)(c)
        assert value is not None and value >= 0, name
    assert readers.reader("recompute_ms.train")(c) > 0
    assert 0 < readers.reader("boundary_named_pct.train")(c) <= 100
    assert readers.reader("graph_kernels.train")(c) is None

"""The benchmark cell ``hac_indoor1557.train_p2`` (HAC's phase-2 context
model at a captured indoor scene's scale) cut as ``perfbench/tests/tiny.py``
cuts a cell: 64x64 views of the inward orbit, ~5.5K anchors, a bucket of
4,096 rows, chunks of 4; every width kept. The port's first three phase-2
steps through ``Trainer.run(device_loop=True)`` (the path a benchmark run
drives) against the plain reference's (``perfbench/reference/step.py::
follow``) from one seed on the CPU, compared under the cell's own limits, and the loss under the phase-0
cell's.
"""
import math

import pytest
import torch

from perfbench import harness
from perfbench.reference.optim import B1
from perfbench.tests.tiny import TINY_SEED, tiny_files

CELL = "hac_indoor1557.train_p2"
LOSS_GAP = 3e-3        # perfbench/limits/room111k.train_p0.json


@pytest.fixture(scope="module")
def both_sides():
    torch.set_num_threads(2)
    files = tiny_files(CELL)
    config, traffic = files["config"], files["traffic"]
    inputs = harness.make_inputs(config, traffic, TINY_SEED, "cpu")
    weights = {k: harness.host(v) for k, v in inputs["weights"].items()}
    trainer = harness.build_trainer(config, traffic, inputs, TINY_SEED,
                                    "cpu")
    from bloomscene_tpu_torch.scene.cameras import CameraArrays
    views = harness.views_for(CameraArrays, inputs, "cpu")
    prog = harness.first_steps(trainer, views, traffic["start_step"],
                               config["gsconfig"]["device_loop_chunk"], B1)
    chunks = list(trainer.chunk_log)
    draws = harness.camera_draws(TINY_SEED, len(views), harness.FIRST_STEPS)
    ref = harness.run_reference(config, traffic, inputs, draws, TINY_SEED,
                                "cpu", tf32=False)
    return files, prog, ref, weights, chunks


def test_the_cell_runs_phase_2_through_the_device_loop(both_sides):
    files, prog, ref, _, chunks = both_sides
    assert files["traffic"]["phase"] == 2
    assert not files["traffic"]["track_stats"]
    assert {(c["phase"], c["track_stats"]) for c in chunks} == {(2, False)}
    assert [c["first"] for c in chunks] == [2001, 2002]
    assert prog["skipped"] == ref["skipped"] == [False] * 3
    assert all(math.isfinite(x) for x in prog["loss"])
    # the bucket holds every visible anchor, with padding past them
    cap = files["config"]["gsconfig"]["visible_capacity"]
    assert 0 < max(prog["visible"]) < cap


def test_the_port_follows_the_reference_within_the_cell_limits(both_sides):
    files, prog, ref, weights, _ = both_sides
    numbers = harness.compare(prog, ref, weights,
                              files["traffic"]["track_stats"])
    assert set(files["limits"]) == {"grad_norm_gap", "change_median_gap"}
    for key, limit in files["limits"].items():
        assert numbers[key] <= limit, (key, numbers[key], limit)
    # the cell leaves the loss out of its limits (a visible anchor that
    # flips at the frustum's edge moves phase 2's rate subsample); with
    # the visible sets equal the loss keeps the phase-0 cell's limit
    assert numbers["visible_equal"]
    assert numbers["loss_gap"] <= LOSS_GAP, numbers["loss_gap"]
    # the phase-2 leaves are compared: the hash tables and the grid MLP
    # have gradients above the exclusion share
    assert not any(n.startswith(("grid.", "heads.grid"))
                   for n in numbers["excluded_leaves"])

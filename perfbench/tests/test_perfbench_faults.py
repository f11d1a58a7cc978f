"""A whole run of each cell at the tiny size on the CPU, past the look
for a card: sound, it comes out correct; with the timed path broken
underneath (a step that leaves the state unchanged; half of each view's
pixels left out of the L1 term, its mean taken over the rest), it comes
out not correct. The precision control runs on the card only (TF32 has
no CPU form): ``test_control_fails_on_the_card``."""
import contextlib
import time

import pytest

from perfbench import calibrate, harness
from perfbench.tests.tiny import TINY_SEED, tiny_files

SPEC = harness.load_json(harness.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in SPEC["workloads"]]


@contextlib.contextmanager
def state_unchanged():
    """Adam's update leaves every leaf and moment as it was."""
    from bloomscene_tpu_torch.train.optim import Adam
    orig = Adam.step

    def step(self, grads, scalars=None):
        if scalars is None:
            self.count += 1
    Adam.step = step
    try:
        yield
    finally:
        Adam.step = orig


FAULTS = {"state_unchanged": state_unchanged,
          "half_batch": calibrate.half_image_l1}


def run(cell: str, fault=None) -> dict:
    files = tiny_files(cell)
    with (FAULTS[fault]() if fault else contextlib.nullcontext()):
        return harness.run_cell(files, TINY_SEED, 0.5, False, "cpu",
                                time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = run(cell)
    assert r["correct"] is True
    assert r["attempted"] > 0 and r["failed"] == 0
    assert list(r["checks"]) == list(tiny_files(cell)["limits"])


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_caught(cell, fault):
    assert run(cell, fault)["correct"] is False


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(cell):
    """At the cell's own size on the card: the program's first steps pass
    every limit, the reference in TF32 fails one."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    files = harness.cell_files(SPEC, cell)
    inputs, weights, prog = calibrate.program_steps(files, TINY_SEED,
                                                    "cuda")
    draws = harness.camera_draws(TINY_SEED, len(inputs["cams"]["viewmat"]),
                                 harness.FIRST_STEPS)
    args = (files["config"], files["traffic"], inputs, draws, TINY_SEED,
            "cuda")
    ref = harness.run_reference(*args, tf32=False)
    low = harness.run_reference(*args, tf32=True)
    track = files["traffic"]["track_stats"]
    limits = files["limits"]
    sound = harness.compare(prog, ref, weights, track)
    control = harness.compare(low, ref, weights, track)
    assert all(sound[k] <= v for k, v in limits.items())
    assert any(control[k] > v for k, v in limits.items())

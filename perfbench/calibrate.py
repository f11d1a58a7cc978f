#!/usr/bin/env python3
"""The readings the correctness limits are set from, on the card, at the
cell's own size: for each seed, the program's first steps (the path a
run's set-up drives) against the plain reference, and, for the seeds
given to ``--control``, the reference in the nearest lower precision
(float32 with TF32 on: the precision control), and with ``--fault half``
the program with half of each view's pixels left out of its L1 term.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3
        [--control 1,2,3] [--fault half] [--out FILE]

One JSON line a reading: ``{"seed", "side", "numbers"}``, ``side`` being
``program``, ``control`` or ``fault:<name>``. The benchmark's own runs do
not run this.
"""
import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import harness  # noqa: E402


@contextlib.contextmanager
def half_image_l1():
    """The program's L1 term over the top half of each view's rows, the
    mean taken over them (a fault: half of the batch left out)."""
    from bloomscene_tpu_torch.train import losses
    orig = losses.l1_loss

    def l1(x, y):
        h = x.shape[0] // 2
        return orig(x[:h], y[:h])
    losses.l1_loss = l1
    try:
        yield
    finally:
        losses.l1_loss = orig


FAULTS = {"half": half_image_l1}


def program_steps(files: dict, seed: int, device, fault=None) -> tuple:
    import torch

    from bloomscene_tpu_torch.scene.cameras import CameraArrays
    from perfbench.reference.optim import B1
    config, traffic = files["config"], files["traffic"]
    inputs = harness.make_inputs(config, traffic, seed, device)
    weights_host = {k: harness.host(v) for k, v in inputs["weights"].items()}
    trainer = harness.build_trainer(config, traffic, inputs, seed, device)
    views = harness.views_for(CameraArrays, inputs, device)
    with (FAULTS[fault]() if fault else contextlib.nullcontext()):
        prog = harness.first_steps(trainer, views, traffic["start_step"],
                                   config["gsconfig"]["device_loop_chunk"],
                                   B1)
    del trainer, views
    gc.collect()
    torch.cuda.empty_cache()
    return inputs, weights_host, prog


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="")
    ap.add_argument("--fault", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    files = harness.cell_files(spec, args.workload)
    traffic = files["traffic"]
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control.split(",") if s}
    out = open(args.out, "a") if args.out else None

    def emit(seed, side, numbers):
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "side": side, "numbers": numbers})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for seed in seeds:
        t0 = time.perf_counter()
        inputs, weights, prog = program_steps(files, seed, "cuda")
        draws = harness.camera_draws(seed, len(inputs["cams"]["viewmat"]),
                                     harness.FIRST_STEPS)
        ref = harness.run_reference(files["config"], traffic, inputs, draws,
                                    seed, "cuda", tf32=False)
        emit(seed, "program", harness.compare(prog, ref, weights,
                                              traffic["track_stats"]))
        if seed in control:
            low = harness.run_reference(files["config"], traffic, inputs,
                                        draws, seed, "cuda", tf32=True)
            emit(seed, "control", harness.compare(low, ref, weights,
                                                  traffic["track_stats"]))
        if args.fault and seed in control:
            del prog
            _, _, bad = program_steps(files, seed, "cuda", args.fault)
            emit(seed, f"fault:{args.fault}",
                 harness.compare(bad, ref, weights, traffic["track_stats"]))
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
        del inputs, ref
        gc.collect()
        torch.cuda.empty_cache()
    found = harness.forbidden_modules()
    if found:
        print(f"modules that must not load: {found}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

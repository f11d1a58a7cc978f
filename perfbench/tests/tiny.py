"""A cell's files cut to a size the CPU runs in seconds: 64x64 views, a
room of 40,000 points at voxel 0.12 (~5.5K anchors), chunks of 4 steps.
The shapes of every layer stay the cell's (feature and head widths, hash
grid levels, tiles of 16 pixels, 1,024 splats a tile)."""
from __future__ import annotations

import copy

from perfbench import harness

TINY_SEED = 2 ** 31 + 12345     # past 32 signed bits, as a run's seed may be


def tiny_files(cell: str, limits: dict | None = None) -> dict:
    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    files = copy.deepcopy(harness.cell_files(spec, cell))
    config = files["config"]
    config["camera"] = {"width": 64, "height": 64}
    config["scene"].update(points=40000)
    g = config["gsconfig"]
    g.update(voxel_size=0.12, device_loop_chunk=4)
    if g["visible_capacity"] is not None:
        g["visible_capacity"] = 4096
    if limits is not None:
        files["limits"] = limits
    return files

"""The work of HAC's hash-grid encoder (``_MixEncode``: the mixed 3D grid
and the three 2D planes, 4 features a level), counted from its inputs and
outputs: each input read once and each output written once. The forward
reads the rows' positions x [rows, 3] and the four binarized tables and
writes the features [rows, levels x 4]; the backward reads x, the tables
and the features' cotangents and writes the gradient to x and the tables'
gradients. The corner rows and indices the backward's first kernel writes
for ``hashgrid_bwd`` are not counted (``counts.py``), so the count reads
the same whatever kernels implement the encoder."""
from __future__ import annotations

from .counts import F32
from .scene import grid_sizes


def table_floats(gs: dict) -> int:
    """Floats of the four tables (``scene.grid_sizes``)."""
    return sum(grid_sizes(gs).values())


def feature_width(gs: dict) -> int:
    """Floats a row of the encoder's output: every level of the 3D grid
    and of the three planes, ``n_features_per_level`` each."""
    return ((len(gs["resolutions_3d"]) + 3 * len(gs["resolutions_2d"]))
            * gs["n_features_per_level"])


def encode_bytes(rows: int, gs: dict) -> tuple[float, float]:
    """(forward, backward) bytes of one call of each on ``rows`` rows."""
    x = F32 * 3 * rows
    tables = F32 * table_floats(gs)
    features = F32 * feature_width(gs) * rows
    forward = x + tables + features
    backward = (x + tables + features) + (x + tables)
    return float(forward), float(backward)

"""Blend constants, the render output container and the golden
rasterizer.

The constants are those of the reference CUDA ``renderCUDA``
(forward.cu:385-471) and of the JAX package's golden rasterizer; every
blend in this package (the CUDA kernels, their plain versions, the golden
model below) uses these.

``rasterize_reference`` is the port of
``bloomscene_tpu/ops/reference_rasterizer.py``: a dense O(N * P) blend in
plain torch, one splat at a time over every pixel, differentiated by
autograd (depth included). It shares no binning code with the tile path,
so the tests and ``chip_smoke.py`` hold the tile path (K3, K4, K1, K2)
against it. For tests and tiny scenes only.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
ACC_SEED = 1e-6
ACC_GATE = 0.5


class RenderOutput(NamedTuple):
    color: torch.Tensor    # [H, W, 3]
    depth: torch.Tensor    # [H, W]
    alpha: torch.Tensor    # [H, W] accumulated alpha (acc, without seed)
    final_T: torch.Tensor  # [H, W]

"""Blend constants and the render output container.

The constants are those of the reference CUDA ``renderCUDA``
(forward.cu:385-471) and of the JAX package's golden rasterizer; every
blend in this package (the CUDA kernel, its plain version) uses these.
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

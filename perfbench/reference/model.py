"""The model bundle: anchor state + MLP heads + hash-grid tables + bounds."""
from __future__ import annotations

from typing import NamedTuple

import torch

from .config import GSConfig
from . import hashgrid
from .anchors import AnchorBounds, AnchorState
from .heads import Heads


class Model(NamedTuple):
    state: AnchorState
    heads: Heads
    grid: dict            # mix-3D2D hash tables, flat float32
    bounds: AnchorBounds


def mix_spec(cfg: GSConfig) -> hashgrid.Mix3D2DSpec:
    return hashgrid.Mix3D2DSpec(
        n_features=cfg.n_features_per_level,
        resolutions_3d=cfg.resolutions_3d,
        log2_hashmap_size_3d=cfg.log2_hashmap_size_3d,
        resolutions_2d=cfg.resolutions_2d,
        log2_hashmap_size_2d=cfg.log2_hashmap_size_2d,
        ste_binary=True)


def calc_interp_feat(model: Model, anchor: torch.Tensor,
                     cfg: GSConfig) -> torch.Tensor:
    """Hash-context features for anchors (gaussian_model.py:413-419)."""
    x = (anchor - model.bounds.x_min) / (model.bounds.x_max
                                         - model.bounds.x_min)
    return hashgrid.mix_encode(model.grid, x, mix_spec(cfg))

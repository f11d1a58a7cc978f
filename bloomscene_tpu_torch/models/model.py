"""The model bundle: anchor state + MLP heads + hash-grid tables + bounds."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import GSConfig
from ..device import resolve_device
from ..ops import hashgrid
from .anchors import AnchorBounds, AnchorState, init_from_points
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


def init_model(seed: int, points: np.ndarray, cfg: GSConfig,
               capacity: int | None = None, device: str = "cuda"
               ) -> tuple[Model, float]:
    """Anchors from a point cloud, heads and hash tables from ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    state, voxel_size = init_from_points(
        points, n_offsets=cfg.n_offsets, feat_dim=cfg.feat_dim,
        device=dev, voxel_size=cfg.voxel_size, capacity=capacity)
    spec = mix_spec(cfg)
    model = Model(
        state=state,
        heads=Heads(cfg.feat_dim, cfg.n_offsets, spec.output_dim, gen, dev,
                    cfg.use_feat_bank, cfg.color_mode, cfg.sh_degree),
        grid=hashgrid.init_mix_params(spec, gen, dev),
        bounds=AnchorBounds.initial(dev))
    return model, voxel_size


def calc_interp_feat(model: Model, anchor: torch.Tensor,
                     cfg: GSConfig) -> torch.Tensor:
    """Hash-context features for anchors (gaussian_model.py:413-419)."""
    x = (anchor - model.bounds.x_min) / (model.bounds.x_max
                                         - model.bounds.x_min)
    return hashgrid.mix_encode(model.grid, x, mix_spec(cfg))

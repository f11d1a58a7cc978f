"""Depth colorization for videos (reference utils/depth.py:7-62).

The port of ``bloomscene_tpu/utils/depthviz.py``: matplotlib's colormap
when matplotlib is importable, a gray ramp otherwise.
"""
from __future__ import annotations

import numpy as np


def colorize(value: np.ndarray, vmin=None, vmax=None, cmap: str = 'magma_r',
             invalid_val: float = -99.0, invalid_mask=None,
             background_color=(128, 128, 128, 255)) -> np.ndarray:
    """Depth map -> RGBA uint8 [H, W, 4]: normalized by ``vmin``/``vmax``
    (default the 2nd and 85th percentiles of the valid values), mapped
    through ``cmap``; invalid pixels take ``background_color``."""
    value = np.asarray(value, np.float32)
    if invalid_mask is None:
        invalid_mask = value == invalid_val
    mask = np.logical_not(invalid_mask)
    vmin = np.percentile(value[mask], 2) if vmin is None and mask.any() \
        else (vmin if vmin is not None else 0.0)
    vmax = np.percentile(value[mask], 85) if vmax is None and mask.any() \
        else (vmax if vmax is not None else 1.0)
    if vmin != vmax:
        norm = (value - vmin) / (vmax - vmin)
    else:
        norm = value * 0.0
    norm = np.clip(norm, 0, 1)
    try:
        import matplotlib
        img = matplotlib.colormaps[cmap](norm, bytes=True)
    except ImportError:
        g = (norm * 255).astype(np.uint8)
        img = np.stack([g, g, g, np.full_like(g, 255)], -1)
    img[invalid_mask] = background_color
    return img

"""Camera assembly from NeRF-style frames (dataset_readers.py:60-99).

Only what the render path needs: turning a camera-to-world frame of a
camera path into a ``Camera``.
"""
from __future__ import annotations

import numpy as np

from .cameras import Camera, camera_from_rt


def _camera_from_nerf_frame(c2w, fovx, fovy, W, H, image=None, depth=None,
                            white_background=False, name="") -> Camera:
    """NeRF c2w (OpenGL axes) -> Camera (loadCamerasFromData)."""
    c2w = np.array(c2w, dtype=np.float64)
    c2w[:3, 1:3] *= -1          # OpenGL -> COLMAP axis flip
    w2c = np.linalg.inv(c2w)
    R = np.transpose(w2c[:3, :3])
    T = w2c[:3, 3]
    if image is not None:
        image = np.asarray(image)
        if image.dtype == np.uint8:
            image = image.astype(np.float32) / 255.0
        if image.shape[-1] == 4:
            bg = np.ones(3) if white_background else np.zeros(3)
            rgb, a = image[..., :3], image[..., 3:4]
            image = (rgb * a + bg * (1 - a)).astype(np.float32)
        image = np.clip(image, 0.0, 1.0).astype(np.float32)
    if depth is not None:
        depth = np.asarray(depth, np.float32)
    return camera_from_rt(R, T, fovx, fovy, W, H, image=image, depth=depth,
                          name=name)

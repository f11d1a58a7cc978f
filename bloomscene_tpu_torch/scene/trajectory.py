"""Render camera paths (reference utils/trajectory.py, utils/camera.py).

``get_camera_paths`` builds the rotate360 orbit as NeRF-style camera-to-
world frames; ``load_camera_path_json`` reads a reference-style camera-path
file such as ``cameras/rotate360.json``.
"""
from __future__ import annotations

import json

import numpy as np


def seed_360(viewangle: float, n_views: int) -> np.ndarray:
    """Yaw-only orbit poses [n_views, 3, 4] (trajectory.py:26-35)."""
    poses = np.zeros((n_views, 3, 4))
    for i in range(n_views):
        th = (viewangle / n_views) * i / 180 * np.pi
        poses[i, :3, :3] = np.array([[np.cos(th), 0, np.sin(th)],
                                     [0, 1, 0],
                                     [-np.sin(th), 0, np.cos(th)]])
    return poses


def get_camera_paths(n_frames: int = 180) -> dict:
    """Render presets as NeRF-style c2w frames
    (get_camerapaths, trajectory.py:102-126; default 180 frames)."""
    presets = {}
    yz_reverse = np.diag([1.0, -1.0, -1.0])
    frames = []
    for pose in seed_360(360, n_frames):
        Rw2i = pose[:3, :3]
        Tw2i = pose[:3, 3:4]
        Ri2w = (yz_reverse @ Rw2i).T
        Ti2w = -Ri2w @ (yz_reverse @ Tw2i)
        c2w = np.eye(4)
        c2w[:3, :3] = Ri2w
        c2w[:3, 3:4] = Ti2w
        frames.append({"transform_matrix": c2w.tolist()})
    presets['rotate360'] = {"frames": frames}
    return presets


def load_camera_path_json(path: str) -> dict:
    """Load {"camera_angle_x": fov, "frames": [{"transform_matrix": 4x4 or
    3x4 NeRF c2w}]} (loader parity with utils/camera.py:23-51). The file's
    own fov is kept under "camera_angle_x"."""
    with open(path) as f:
        contents = json.load(f)
    frames = []
    for fr in contents["frames"]:
        m = np.asarray(fr["transform_matrix"], np.float64)
        if m.shape[0] == 3:           # 3x4 c2w: pad the homogeneous row
            m = np.concatenate([m, [[0.0, 0.0, 0.0, 1.0]]], 0)
        frames.append({"transform_matrix": m.tolist()})
    out = {"frames": frames}
    if "camera_angle_x" in contents:
        out["camera_angle_x"] = float(contents["camera_angle_x"])
    return out

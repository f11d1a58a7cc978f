"""Camera trajectories (reference utils/trajectory.py, utils/camera.py).

The port's copy of ``bloomscene_tpu/scene/trajectory.py``. Poses are
[N, 3, 4] world->camera ("render pose") matrices in the LucidDreamer
convention: the generation poses (``get_pcd_gen_poses``: the shuffled
rotate360 seed, the hemisphere jitter), and the render presets, which
``get_camera_paths`` turns into camera-to-world NeRF-style frames exactly
like get_camerapaths (trajectory.py:102-126); ``load_camera_path_json``
reads a reference-style camera-path file such as ``cameras/rotate360.json``.
"""
from __future__ import annotations

import json
import math

import numpy as np

# shuffled generation order for the 10 rotate360 views (trajectory.py:29)
ROT360_TH_ORDER = (0, 1, 9, 2, 8, 3, 7, 4, 6, 5)


def seed_360(viewangle: float, n_views: int,
             shuffled: bool = False) -> np.ndarray:
    """Yaw-only orbit poses; ``shuffled`` uses the reference's interleaved
    generation order (my_generate_seed_360, trajectory.py:26-35)."""
    poses = np.zeros((n_views, 3, 4))
    order = ROT360_TH_ORDER if shuffled else range(n_views)
    for i, o in zip(range(n_views), order):
        th = (viewangle / n_views) * o / 180 * np.pi
        poses[i, :3, :3] = np.array([[np.cos(th), 0, np.sin(th)],
                                     [0, 1, 0],
                                     [-np.sin(th), 0, np.cos(th)]])
    return poses


def seed_hemisphere(center_depths, degree: float = 5.0) -> np.ndarray:
    """5 jitter poses per center depth, pivoting about the scene point at
    ``d`` in front of the camera (my_generate_seed_hemisphere,
    trajectory.py:71-89)."""
    center_depths = np.atleast_1d(np.asarray(center_depths, np.float64))
    thlist = np.array([degree, 0, 0, 0, -degree])
    philist = np.array([0, -degree, 0, degree, 0])
    poses = np.zeros((len(thlist) * len(center_depths), 3, 4))
    for j, d in enumerate(center_depths):
        for i, (th, phi) in enumerate(zip(thlist, philist)):
            thr = th / 180 * np.pi
            phr = phi / 180 * np.pi
            Ry = np.array([[np.cos(thr), 0, -np.sin(thr)],
                           [0, 1, 0],
                           [np.sin(thr), 0, np.cos(thr)]])
            Rx = np.array([[1, 0, 0],
                           [0, np.cos(phr), -np.sin(phr)],
                           [0, np.sin(phr), np.cos(phr)]])
            idx = j * len(thlist) + i
            poses[idx, :3, :3] = Ry @ Rx
            poses[idx, :3, 3] = (
                np.array([d * np.sin(thr), 0, d - d * np.cos(thr)])
                + np.array([0, d * np.sin(phr), d - d * np.cos(phr)]))
    return poses


def get_pcd_gen_poses(name: str, center_depths=None) -> np.ndarray:
    """Scene-generation poses (get_pcdGenPoses, trajectory.py:92-99)."""
    if name == 'rotate360':
        return seed_360(360, 10, shuffled=True)
    if name == 'hemisphere':
        return seed_hemisphere(center_depths)
    raise ValueError(f"Invalid pcd generation path: {name}")


def get_camera_paths(n_frames: int = 180) -> dict:
    """Render presets as NeRF-style c2w frames
    (get_camerapaths, trajectory.py:102-126; default 180 frames)."""
    presets = {}
    yz_reverse = np.diag([1.0, -1.0, -1.0])
    for name in ('rotate360',):
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
        presets[name] = {"frames": frames}
    return presets


def write_rotate360_json(path: str, n_frames: int = 720,
                         camera_angle_x: float | None = None) -> dict:
    """Generate the 720-frame rotate360 camera-path json — the analog of
    the reference's shipped cameras/rotate360.json asset (720 frames,
    consumed by utils/camera.py:23-51). GENERATED from the orbit formula,
    not copied: same 0.5-degree-per-frame yaw orbit and the same default
    fov (2*atan(256/582.69), the reference CameraParams focal at 512px),
    but the camera orbits at the scene origin like every other preset in
    this repo (the reference file's constant -2.5 translation is specific
    to its own scene layout). Loadable via --campath_render <path> or
    scene.trajectory.load_camera_path_json."""
    if camera_angle_x is None:
        camera_angle_x = 2.0 * math.atan(256.0 / 582.69)
    d = {"camera_angle_x": camera_angle_x,
         "frames": get_camera_paths(n_frames)['rotate360']['frames']}
    with open(path, 'w') as f:
        json.dump(d, f)
    return d


def load_camera_path_json(path: str) -> dict:
    """Load a reference-style camera-path json (e.g. the reference's
    720-frame cameras/rotate360.json; format {"camera_angle_x": fov,
    "frames": [{"transform_matrix": 4x4 NeRF c2w}]}, loader parity with
    utils/camera.py:23-51). Returns the same dict shape get_camera_paths
    produces, with the json's own fov preserved under "camera_angle_x"
    (the reference loader uses the file's fov, NOT the scene's)."""
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

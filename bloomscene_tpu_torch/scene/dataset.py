"""Dataset assembly: traindata dict -> cameras + point cloud + scene.

The port of ``bloomscene_tpu/scene/dataset.py`` (reference
scene/dataset_readers.py and scene/__init__.py), host numpy. ``traindata``
is the progressive generation's output (bloomscene.py:592-599):
{camera_angle_x, W, H, pcd_points [3, N], pcd_colors [N, 3], frames:
[{image [H, W, 3] float or uint8, depth [H, W], transform_matrix 4x4
c2w}]}.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..ops.graphics import focal2fov, fov2focal
from .cameras import Camera, camera_from_rt
from .pose_noise import apply_pose_noise
from .trajectory import get_camera_paths, load_camera_path_json


class SceneData(NamedTuple):
    points: np.ndarray            # [N, 3]
    colors: np.ndarray            # [N, 3]
    train_cameras: list
    eval_cameras: list            # noisy-pose eval set
    preset_cameras: dict          # {path_name: [Camera (pose only)]}
    translate: np.ndarray
    radius: float                 # NeRF++ norm radius (spatial LR scale)


def _camera_from_nerf_frame(c2w, fovx, fovy, W, H, image=None, depth=None,
                            white_background=False, name="") -> Camera:
    """NeRF c2w (OpenGL axes) -> Camera (loadCamerasFromData,
    dataset_readers.py:60-99)."""
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


def nerfpp_norm(cameras: list[Camera]):
    """Scene center and radius from the camera centers (getNerfppNorm,
    dataset_readers.py:35-56) -> (translate, radius)."""
    centers = np.stack([c.camera_center for c in cameras], 1)
    center = centers.mean(axis=1, keepdims=True)
    diagonal = np.max(np.linalg.norm(centers - center, axis=0))
    return -center.flatten(), float(diagonal * 1.1)


def read_scene_data(traindata: dict, white_background: bool = False,
                    with_eval_noise: bool = True,
                    noise_seed: int = 0,
                    preset_json: dict | None = None) -> SceneData:
    """readDataInfo + Scene.__init__ (dataset_readers.py:137-154,
    scene/__init__.py:12-31).

    The render presets narrow the fov by 0.95 (loadCameraPreset,
    dataset_readers.py:105). ``preset_json``: optional {name: path} of
    reference-style camera-path files (cameras/rotate360.json format) added
    as presets; a file's own camera_angle_x wins over the scene's fov, as in
    the reference loader (utils/camera.py:27)."""
    fovx = traindata["camera_angle_x"]
    frames = traindata["frames"]
    cams = []
    for idx, fr in enumerate(frames):
        img = np.asarray(fr["image"])
        H, W = img.shape[:2]
        fovy = focal2fov(fov2focal(fovx, W), H)
        cams.append(_camera_from_nerf_frame(
            fr["transform_matrix"], fovx, fovy, W, H, image=img,
            depth=fr.get("depth"), white_background=white_background,
            name=f"train_{idx:03d}"))

    pfovx = fovx * 0.95
    W0, H0 = cams[0].width, cams[0].height
    pfovy = focal2fov(fov2focal(pfovx, W0), H0)
    presets = {}
    for key, data in get_camera_paths().items():
        presets[key] = [
            _camera_from_nerf_frame(fr["transform_matrix"], pfovx, pfovy,
                                    W0, H0, name=f"{key}_{i:03d}")
            for i, fr in enumerate(data["frames"])]
    for key, path in (preset_json or {}).items():
        data = load_camera_path_json(path)
        jfovx = data.get("camera_angle_x", pfovx)
        jfovy = focal2fov(fov2focal(jfovx, W0), H0)
        presets[key] = [
            _camera_from_nerf_frame(fr["transform_matrix"], jfovx, jfovy,
                                    W0, H0, name=f"{key}_{i:03d}")
            for i, fr in enumerate(data["frames"])]

    eval_cams = (apply_pose_noise(cams, seed=noise_seed)
                 if with_eval_noise else [])
    translate, radius = nerfpp_norm(cams)

    points = np.asarray(traindata["pcd_points"], np.float32)
    if points.shape[0] == 3 and points.shape[1] != 3:
        points = points.T
    colors = np.asarray(traindata["pcd_colors"], np.float32)
    return SceneData(points=points, colors=colors, train_cameras=cams,
                     eval_cameras=eval_cams, preset_cameras=presets,
                     translate=translate, radius=radius)

"""Camera and projective-geometry math (reference conventions).

- world->view matrix from (R, t) as in reference utils/graphics.py:35-54
  (R is camera-to-world rotation; the matrix stores R^T and t);
- perspective projection as in reference utils/graphics.py:57-77;
- matrices in math convention (``y = M @ x``).

The per-camera matrices are built in numpy (float64, then float32); the
per-Gaussian functions take torch tensors.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion(s) (w, x, y, z) -> rotation matrix (..., 3, 3), not
    normalized here (CUDA ``computeCov3D`` convention, forward.cu:127-138).
    """
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z),
                     2 * (x * z + r * y)], -1),
        torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - r * x)], -1),
        torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], -2)


def normalize_quat(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                           min=eps)


def world_to_view(R: np.ndarray, t: np.ndarray,
                  translate: np.ndarray | None = None,
                  scale: float = 1.0) -> np.ndarray:
    """4x4 world->view matrix. Reference utils/graphics.py:43-54."""
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = np.asarray(R).T
    Rt[:3, 3] = np.asarray(t)
    Rt[3, 3] = 1.0
    if translate is not None or scale != 1.0:
        translate = np.zeros(3) if translate is None else translate
        C2W = np.linalg.inv(Rt)
        C2W[:3, 3] = (C2W[:3, 3] + translate) * scale
        Rt = np.linalg.inv(C2W)
    return Rt.astype(np.float32)


def projection_matrix(znear: float, zfar: float,
                      fovx: float, fovy: float) -> np.ndarray:
    """4x4 perspective projection. Reference utils/graphics.py:57-77."""
    t = math.tan(fovy / 2)
    r = math.tan(fovx / 2)
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 1.0 / r
    P[1, 1] = 1.0 / t
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    P[3, 2] = 1.0
    return P


def fov2focal(fov: float, pixels: int) -> float:
    return pixels / (2 * math.tan(fov / 2))


def focal2fov(focal: float, pixels: int) -> float:
    return 2 * math.atan(pixels / (2 * focal))

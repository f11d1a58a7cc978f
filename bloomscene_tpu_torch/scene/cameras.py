"""Camera containers (reference scene/cameras.py:20-78).

A ``Camera`` holds static ints and float32 numpy matrices in math
convention (``y = M @ x``); ``device_arrays`` moves the per-frame matrices
to a torch device for the renderer.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import graphics

ZNEAR = 0.01   # cameras.py:54
ZFAR = 100.0   # cameras.py:53


@dataclasses.dataclass(frozen=True)
class Intrinsics:
    """Hashable static camera parameters."""
    width: int
    height: int
    fovx: float
    fovy: float

    @property
    def tan_fovx(self) -> float:
        return math.tan(self.fovx / 2)

    @property
    def tan_fovy(self) -> float:
        return math.tan(self.fovy / 2)

    @property
    def focal_x(self) -> float:
        return graphics.fov2focal(self.fovx, self.width)

    @property
    def focal_y(self) -> float:
        return graphics.fov2focal(self.fovy, self.height)


@dataclasses.dataclass(frozen=True)
class Camera:
    """One (possibly supervised) viewpoint."""
    width: int
    height: int
    fovx: float
    fovy: float
    viewmat: np.ndarray            # [4,4] world -> view
    image: Optional[np.ndarray] = None    # [H, W, 3] float in [0,1]
    depth: Optional[np.ndarray] = None    # [H, W] supervision depth
    name: str = ""

    @property
    def projmat(self) -> np.ndarray:
        return graphics.projection_matrix(ZNEAR, ZFAR, self.fovx, self.fovy)

    @property
    def full_proj(self) -> np.ndarray:
        return (self.projmat @ self.viewmat).astype(np.float32)

    @property
    def camera_center(self) -> np.ndarray:
        return np.linalg.inv(self.viewmat)[:3, 3].astype(np.float32)

    @property
    def intrinsics(self) -> Intrinsics:
        return Intrinsics(self.width, self.height, self.fovx, self.fovy)

    def device_arrays(self, device: str | torch.device) -> "CameraArrays":
        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=device)
        return CameraArrays(viewmat=t(self.viewmat),
                            full_proj=t(self.full_proj),
                            camera_center=t(self.camera_center))


class CameraArrays(NamedTuple):
    """Per-frame camera tensors on the render device."""
    viewmat: torch.Tensor
    full_proj: torch.Tensor
    camera_center: torch.Tensor


def camera_from_rt(R: np.ndarray, t: np.ndarray, fovx: float, fovy: float,
                   width: int, height: int, image=None, depth=None,
                   trans=None, scale: float = 1.0, name: str = "") -> Camera:
    """Build from the reference's (R, T) convention (cameras.py:59)."""
    viewmat = graphics.world_to_view(R, t, translate=trans, scale=scale)
    return Camera(width=width, height=height, fovx=fovx, fovy=fovy,
                  viewmat=viewmat, image=image, depth=depth, name=name)

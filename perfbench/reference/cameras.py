"""Camera intrinsics and per-frame camera tensors."""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch


def fov2focal(fov: float, pixels: int) -> float:
    return pixels / (2 * math.tan(fov / 2))


@dataclasses.dataclass(frozen=True)
class Intrinsics:
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
        return fov2focal(self.fovx, self.width)

    @property
    def focal_y(self) -> float:
        return fov2focal(self.fovy, self.height)


class CameraArrays(NamedTuple):
    viewmat: torch.Tensor        # [4, 4] world -> view
    full_proj: torch.Tensor      # [4, 4] world -> clip
    camera_center: torch.Tensor  # [3]

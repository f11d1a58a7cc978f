"""Per-Gaussian projection ("preprocess"): depth, 2D mean, conic, radius.

Semantics of the reference CUDA preprocess (forward.cu:74-256):

- cov3D = R diag(s)^2 R^T with the quaternion taken as given;
- EWA: the view point clamped to the 1.3*tan(fov) cone before the
  Jacobian, cov2D = J W Sigma W^T J^T plus the +0.3 px low-pass;
- radius = ceil(3 * sqrt(max eigenvalue));
- near cull at view z <= 0.2 and an off-screen cull of the 3-sigma box;
  rows at or below the near plane take a safe depth (1) before the EWA
  Jacobian's divisions, so a row at the camera's center gives no inf or
  NaN, in the values or in their cotangents (forward.cu divides by the
  depth first and culls the row afterwards).

Everything is computed densely with a ``valid`` mask (invalid Gaussians get
radius 0), in the JAX package's per-component order of operations, so the
same float32 inputs give bitwise the same outputs at every valid row.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ['ProjectedSplats', 'build_cov3d', 'ewa_cov2d',
           'project_gaussians']

NEAR = 0.2      # the near plane: rows at view z <= NEAR are culled


class ProjectedSplats(NamedTuple):
    """Per-Gaussian screen-space quantities (all [N, ...])."""
    mean2d: torch.Tensor   # [N, 2] pixel coords
    depth: torch.Tensor    # [N] view-space z
    conic: torch.Tensor    # [N, 3] inverse 2D covariance (a, b, c)
    radius: torch.Tensor   # [N] int32 3-sigma pixel radius (0 = culled)
    valid: torch.Tensor    # [N] bool


def _rot_components(quats: torch.Tensor):
    r, x, y, z = quats[:, 0], quats[:, 1], quats[:, 2], quats[:, 3]
    return (1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
            2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
            2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y))


def build_cov3d(scales: torch.Tensor, quats: torch.Tensor,
                scale_modifier: float = 1.0) -> torch.Tensor:
    """3D covariance, upper triangle [N, 6]: (xx, xy, xz, yy, yz, zz)."""
    (R00, R01, R02, R10, R11, R12, R20, R21, R22) = _rot_components(quats)
    sm = scale_modifier
    s0 = (sm * scales[:, 0]) ** 2
    s1 = (sm * scales[:, 1]) ** 2
    s2 = (sm * scales[:, 2]) ** 2
    xx = R00 * R00 * s0 + R01 * R01 * s1 + R02 * R02 * s2
    xy = R00 * R10 * s0 + R01 * R11 * s1 + R02 * R12 * s2
    xz = R00 * R20 * s0 + R01 * R21 * s1 + R02 * R22 * s2
    yy = R10 * R10 * s0 + R11 * R11 * s1 + R12 * R12 * s2
    yz = R10 * R20 * s0 + R11 * R21 * s1 + R12 * R22 * s2
    zz = R20 * R20 * s0 + R21 * R21 * s1 + R22 * R22 * s2
    return torch.stack([xx, xy, xz, yy, yz, zz], -1)


def _ewa_cov2d_components(means3d, cov6, viewmat, focal_x, focal_y,
                          tan_fovx, tan_fovy, near):
    """(a, b, c) 2D-covariance components, each [N] (forward.cu:74-113).
    Rows at view z <= ``near`` (culled by ``project_gaussians``) take the
    depth 1: their components are finite and their cotangents exact
    zeros, where 1/z would overflow at the camera's center."""
    V = viewmat
    mx, my, mz = means3d[:, 0], means3d[:, 1], means3d[:, 2]
    tx_v = V[0, 0] * mx + V[0, 1] * my + V[0, 2] * mz + V[0, 3]
    ty_v = V[1, 0] * mx + V[1, 1] * my + V[1, 2] * mz + V[1, 3]
    tz_v = V[2, 0] * mx + V[2, 1] * my + V[2, 2] * mz + V[2, 3]
    tz_v = torch.where(tz_v > near, tz_v, 1.0)

    limx, limy = 1.3 * tan_fovx, 1.3 * tan_fovy
    txc = torch.clamp(tx_v / tz_v, -limx, limx) * tz_v
    tyc = torch.clamp(ty_v / tz_v, -limy, limy) * tz_v

    inv_z = 1.0 / tz_v
    inv_z2 = inv_z * inv_z
    J00 = focal_x * inv_z
    J02 = -(focal_x * txc) * inv_z2
    J11 = focal_y * inv_z
    J12 = -(focal_y * tyc) * inv_z2

    T00 = J00 * V[0, 0] + J02 * V[2, 0]
    T01 = J00 * V[0, 1] + J02 * V[2, 1]
    T02 = J00 * V[0, 2] + J02 * V[2, 2]
    T10 = J11 * V[1, 0] + J12 * V[2, 0]
    T11 = J11 * V[1, 1] + J12 * V[2, 1]
    T12 = J11 * V[1, 2] + J12 * V[2, 2]

    xx, xy, xz = cov6[:, 0], cov6[:, 1], cov6[:, 2]
    yy, yz, zz = cov6[:, 3], cov6[:, 4], cov6[:, 5]
    St00 = xx * T00 + xy * T01 + xz * T02
    St10 = xy * T00 + yy * T01 + yz * T02
    St20 = xz * T00 + yz * T01 + zz * T02
    St01 = xx * T10 + xy * T11 + xz * T12
    St11 = xy * T10 + yy * T11 + yz * T12
    St21 = xz * T10 + yz * T11 + zz * T12
    a = T00 * St00 + T01 * St10 + T02 * St20 + 0.3
    b = T00 * St01 + T01 * St11 + T02 * St21
    c = T10 * St01 + T11 * St11 + T12 * St21 + 0.3
    return a, b, c


def ewa_cov2d(means3d: torch.Tensor, cov6: torch.Tensor,
              viewmat: torch.Tensor, focal_x: float, focal_y: float,
              tan_fovx: float, tan_fovy: float) -> torch.Tensor:
    """3D covariance -> 2D screen covariance [N, 3] = (a, b, c); rows at or
    below ``project_gaussians``' default near plane take the safe depth."""
    a, b, c = _ewa_cov2d_components(means3d, cov6, viewmat, focal_x,
                                    focal_y, tan_fovx, tan_fovy, NEAR)
    return torch.stack([a, b, c], -1)


def project_gaussians(means3d: torch.Tensor,
                      cov6: torch.Tensor,
                      viewmat: torch.Tensor,
                      projmat: torch.Tensor,
                      W: int, H: int,
                      focal_x: float, focal_y: float,
                      tan_fovx: float, tan_fovy: float,
                      near: float = NEAR) -> ProjectedSplats:
    """Full preprocess. ``projmat`` is proj @ viewmat (math convention)."""
    V, F = viewmat, projmat
    mx, my, mz = means3d[:, 0], means3d[:, 1], means3d[:, 2]
    depth = V[2, 0] * mx + V[2, 1] * my + V[2, 2] * mz + V[2, 3]

    hx = F[0, 0] * mx + F[0, 1] * my + F[0, 2] * mz + F[0, 3]
    hy = F[1, 0] * mx + F[1, 1] * my + F[1, 2] * mz + F[1, 3]
    hw = F[3, 0] * mx + F[3, 1] * my + F[3, 2] * mz + F[3, 3]
    p_w = 1.0 / (hw + 1e-7)
    x = ((hx * p_w + 1.0) * W - 1.0) * 0.5      # ndc2Pix (auxiliary.h:41-44)
    y = ((hy * p_w + 1.0) * H - 1.0) * 0.5

    a, b, c = _ewa_cov2d_components(means3d, cov6, viewmat, focal_x,
                                    focal_y, tan_fovx, tan_fovy, near)
    det = a * c - b * b
    det_safe = torch.where(det == 0.0, 1.0, det)
    inv_det = 1.0 / det_safe
    conic = torch.stack([c * inv_det, -b * inv_det, a * inv_det], -1)

    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp(lam, min=0.0)))

    # on-screen test: does the 3-sigma box intersect the image at all?
    on_screen = ((x + radius_f >= 0) & (x - radius_f < W) &
                 (y + radius_f >= 0) & (y - radius_f < H))
    valid = (depth > near) & (det > 0.0) & on_screen & (radius_f > 0)

    radius = torch.where(valid, radius_f, 0.0).to(torch.int32)
    mean2d = torch.stack([x, y], -1)
    return ProjectedSplats(mean2d=mean2d, depth=depth, conic=conic,
                           radius=radius, valid=valid)

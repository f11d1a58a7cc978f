"""Spherical-harmonics view-dependent color, degrees 0-3.

The port of ``bloomscene_tpu/ops/sh.py`` (computeColorFromSH,
depth-diff-gaussian-rasterization forward.cu:20-72). Autograd supplies the
reference's analytic backward (backward.cu:20-142): ``max(result, 0)``
zeroes clamped channels, and differentiating through ``dir / |dir|``
carries the gradient to the means.
"""
from __future__ import annotations

import torch

# basis constants (auxiliary.h:27-46)
SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


def num_sh_coeffs(degree: int) -> int:
    return (degree + 1) ** 2


def sh_basis(degree: int, dirs: torch.Tensor) -> torch.Tensor:
    """Basis values for unit directions [N, 3] -> [N, (degree+1)^2], the
    polynomial of forward.cu:30-60 term by term."""
    if not 0 <= degree <= 3:
        raise ValueError(f"SH degree must be in [0, 3], got {degree}")
    x, y, z = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    cols = [SH_C0 * torch.ones_like(x)]
    if degree >= 1:
        cols += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        cols += [SH_C2[0] * xy, SH_C2[1] * yz,
                 SH_C2[2] * (2.0 * zz - xx - yy),
                 SH_C2[3] * xz, SH_C2[4] * (xx - yy)]
    if degree >= 3:
        cols += [SH_C3[0] * y * (3.0 * xx - yy),
                 SH_C3[1] * xy * z,
                 SH_C3[2] * y * (4.0 * zz - xx - yy),
                 SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                 SH_C3[4] * x * (4.0 * zz - xx - yy),
                 SH_C3[5] * z * (xx - yy),
                 SH_C3[6] * x * (xx - 3.0 * yy)]
    return torch.stack(cols, dim=-1)


def eval_sh(degree: int, sh_coeffs: torch.Tensor, means: torch.Tensor,
            campos: torch.Tensor) -> torch.Tensor:
    """RGB [N, 3] from coefficients [N, M, 3] (M >= (degree+1)^2, extra
    ones ignored) seen from ``campos`` [3]: the basis dotted with the
    coefficients, +0.5, clamped at 0 from below (forward.cu:63-70)."""
    d = means - campos[None, :]
    dirs = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    basis = sh_basis(degree, dirs)                       # [N, M]
    m = num_sh_coeffs(degree)
    result = torch.einsum('nm,nmc->nc', basis, sh_coeffs[:, :m, :]) + 0.5
    # maximum, not clamp: a tie at 0 splits the gradient as jnp.maximum does
    return torch.maximum(result, result.new_zeros(()))

"""Blend constants, the render output container and the golden
rasterizer.

The constants are those of the reference CUDA ``renderCUDA``
(forward.cu:385-471) and of the JAX package's golden rasterizer; every
blend in this package (the CUDA kernels, their plain versions, the golden
model below) uses these.

``rasterize_reference`` is the port of
``bloomscene_tpu/ops/reference_rasterizer.py``: a dense O(N * P) blend in
plain torch, one splat at a time over every pixel, differentiated by
autograd (depth included). It shares no binning code with the tile path,
so the tests and ``chip_smoke.py`` hold the tile path (K3, K4, K1, K2)
against it. For tests and tiny scenes only.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4
ACC_SEED = 1e-6
ACC_GATE = 0.5


class RenderOutput(NamedTuple):
    color: torch.Tensor    # [H, W, 3]
    depth: torch.Tensor    # [H, W]
    alpha: torch.Tensor    # [H, W] accumulated alpha (acc, without seed)
    final_T: torch.Tensor  # [H, W]


def rasterize_reference(proj, colors: torch.Tensor, opacities: torch.Tensor,
                        bg: torch.Tensor, W: int, H: int,
                        tile: int | None = None) -> RenderOutput:
    """Dense rasterization with the reference's blend rules, splats in
    global depth order (stable; invalid splats last and masked): power > 0
    skips, alpha = min(0.99, op e^power) < 1/255 skips, a pixel stops for
    good at the splat that would take T below 1e-4 (not blended).

    With ``tile``, a pixel sees only the splats whose 3-sigma tile
    rectangle covers its tile (the binning's visibility rule, getRect);
    with None, every valid splat is seen everywhere."""
    dev = proj.mean2d.device
    sort_depth = torch.where(proj.valid, proj.depth, float("inf"))
    order = torch.sort(sort_depth, stable=True).indices
    mean2d, conic, depth = (proj.mean2d[order], proj.conic[order],
                            proj.depth[order])
    valid, color, opac = proj.valid[order], colors[order], opacities[order]

    pyg, pxg = torch.meshgrid(torch.arange(H, dtype=torch.float32,
                                           device=dev),
                              torch.arange(W, dtype=torch.float32,
                                           device=dev), indexing="ij")
    seen = valid[:, None, None].expand(-1, H, W)
    if tile is not None:
        rad = proj.radius[order].to(torch.float32)
        m = mean2d.detach()
        gxn, gyn = -(-W // tile), -(-H // tile)
        rx0 = torch.clamp(torch.floor((m[:, 0] - rad) / tile), 0, gxn)
        ry0 = torch.clamp(torch.floor((m[:, 1] - rad) / tile), 0, gyn)
        rx1 = torch.clamp(torch.floor((m[:, 0] + rad + tile - 1) / tile), 0,
                          gxn)
        ry1 = torch.clamp(torch.floor((m[:, 1] + rad + tile - 1) / tile), 0,
                          gyn)
        ptx = torch.floor(pxg / tile)[None]
        pty = torch.floor(pyg / tile)[None]
        seen = seen & ((ptx >= rx0[:, None, None]) & (ptx < rx1[:, None, None])
                       & (pty >= ry0[:, None, None])
                       & (pty < ry1[:, None, None]))

    T = torch.ones((H, W), dtype=torch.float32, device=dev)
    C = torch.zeros((H, W, 3), dtype=torch.float32, device=dev)
    D = torch.zeros((H, W), dtype=torch.float32, device=dev)
    acc = torch.full((H, W), ACC_SEED, dtype=torch.float32, device=dev)
    done = torch.zeros((H, W), dtype=torch.bool, device=dev)
    for i in range(mean2d.shape[0]):
        dx = mean2d[i, 0] - pxg
        dy = mean2d[i, 1] - pyg
        power = (-0.5 * (conic[i, 0] * dx * dx + conic[i, 2] * dy * dy)
                 - conic[i, 1] * dx * dy)
        alpha = torch.clamp(opac[i] * torch.exp(power), max=ALPHA_MAX)
        contrib = seen[i] & (power <= 0.0) & (alpha >= ALPHA_MIN) & ~done
        test_T = T * (1.0 - alpha)
        terminate = contrib & (test_T < T_EPS)
        blend = contrib & ~terminate
        done = done | terminate
        w = torch.where(blend, alpha * T, 0.0)
        C = C + w[..., None] * color[i]
        D = D + w * depth[i]
        acc = acc + w
        T = torch.where(blend, test_T, T)
    return RenderOutput(color=C + T[..., None] * bg,
                        depth=torch.where(acc > ACC_GATE, D / acc, 0.0),
                        alpha=acc - ACC_SEED, final_T=T)

"""Training losses (reference utils/loss.py), as the JAX package's
``train/losses.py`` computes them.

- l1 / l2 (loss.py:83-88)
- SSIM with an 11x11 sigma=1.5 gaussian window, zero-padded (loss.py:91-134)
- CMD central-moment discrepancy, 5 moments, raw or normalized
  (loss.py:26-60)
- bilateral depth smoothness (loss.py:63-80)
- HuberL1 edge-aware depth loss (loss.py:170-202) at any H, W

Images are [H, W, 3] and depths [H, W], channels last, as in the JAX
package. Where JAX takes ``jnp.maximum`` / ``jnp.minimum`` against a
constant, so does this (``torch.maximum`` / ``torch.minimum``): both split
the gradient evenly at a tie (an all-black window's variance is exactly
0), where ``torch.clamp`` would pass all of it. ``jnp.abs`` has the
gradient +1 at 0 (``torch.abs`` has 0); ``_abs`` keeps JAX's, which
matters where a rendered pixel equals its target exactly (black on
black).
"""
from __future__ import annotations


import numpy as np
import torch
import torch.nn.functional as F

from .plain import device_constant


def _abs(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, -x)


def _max(x: torch.Tensor, c: float) -> torch.Tensor:
    return torch.maximum(x, torch.full_like(x, c))


def _min(x: torch.Tensor, c: float) -> torch.Tensor:
    return torch.minimum(x, torch.full_like(x, c))


def l1_loss(x, y):
    return torch.mean(_abs(x - y))


def _gaussian_window(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    g = np.exp(-((np.arange(window_size) - window_size // 2) ** 2)
               / (2 * sigma ** 2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def _depthwise_conv(img: torch.Tensor, window: np.ndarray) -> torch.Tensor:
    """img [H, W, C] -> the same-padded (zeros) depthwise conv, [H, W, C]."""
    k = window.shape[0]
    c = img.shape[-1]
    w = device_constant(window, img.device).expand(c, 1, k, k)
    out = F.conv2d(img.permute(2, 0, 1)[None], w, padding=k // 2, groups=c)
    return out[0].permute(1, 2, 0)


def ssim(img1, img2, window_size: int = 11):
    """Mean SSIM; the windowed variances are clamped at zero, as in the JAX
    package (zero padding makes them negative near borders)."""
    w = _gaussian_window(window_size)
    mu1 = _depthwise_conv(img1, w)
    mu2 = _depthwise_conv(img2, w)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = _max(_depthwise_conv(img1 * img1, w) - mu1_sq, 0.0)
    sigma2_sq = _max(_depthwise_conv(img2 * img2, w) - mu2_sq, 0.0)
    sigma12 = _depthwise_conv(img1 * img2, w) - mu1_mu2
    C1, C2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = (((2 * mu1_mu2 + C1) * (2 * sigma12 + C2))
                / ((mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2)))
    return torch.mean(ssim_map)


def _matchnorm(x1, x2, normalized: bool = False):
    power = _min((_abs(x1 - x2) + 1e-6) ** 2, 1e6)
    if normalized:
        return torch.sqrt(torch.mean(power) + 1e-6)
    summed = _min(torch.sum(power), 1e6)
    return torch.sqrt(summed + 1e-6)


def cmd(x1, x2, n_moments: int = 5, normalized: bool = False):
    """Central moment discrepancy between leading-axis batches.

    ``normalized=False`` is the reference's raw L2 sum of the moment
    differences (loss.py:26-60); ``normalized=True`` takes an RMS instead,
    which keeps the depth term commensurate with L1/SSIM when depth
    gradients flow (the JAX package's ``cmd`` docstring, DPR_AB.json)."""
    x1 = _min(_max(x1, -1e6), 1e6)
    x2 = _min(_max(x2, -1e6), 1e6)
    mx1 = torch.mean(x1, 0)
    mx2 = torch.mean(x2, 0)
    sx1 = x1 - mx1
    sx2 = x2 - mx2
    scms = _matchnorm(mx1, mx2, normalized)
    for k in range(2, n_moments + 1):
        ss1 = torch.mean((_abs(sx1) + 1e-6) ** k, 0)
        ss2 = torch.mean((_abs(sx2) + 1e-6) ** k, 0)
        scms = scms + _matchnorm(ss1, ss2, normalized)
    return scms / x1.shape[0]


def _replicate_pad(x: torch.Tensor, half: int) -> torch.Tensor:
    """[H, W] -> [H + 2 half, W + 2 half], the edge rows and columns
    repeated, as ``F.pad(mode='replicate')``; built from broadcasts, so
    the backward sums the copies as reductions (replicate padding's own
    backward adds them atomically on the card, in no fixed order)."""
    x = torch.cat([x[:1].expand(half, -1), x, x[-1:].expand(half, -1)], 0)
    return torch.cat([x[:, :1].expand(-1, half), x,
                      x[:, -1:].expand(-1, half)], 1)


def bilateral_smoothness(depth, spatial_sigma: float = 2.0,
                         color_sigma: float = 5.0, kernel_size: int = 5):
    """Edge-preserving depth smoothness (bilateral_filter, loss.py:63-80):
    replicate-padded k x k neighborhoods, gaussian spatial kernel,
    exponential range kernel on |depth difference|. ``depth`` [H, W]."""
    k = kernel_size
    half = k // 2
    x = torch.arange(k, dtype=torch.float32, device=depth.device) - half
    spatial = torch.exp(-(x[None, :] ** 2 + x[:, None] ** 2)
                        / (2 * spatial_sigma ** 2))
    spatial = spatial / torch.sum(spatial)
    dpad = _replicate_pad(depth, half)
    H, W = depth.shape
    loss = torch.zeros((), device=depth.device)
    for dy in range(k):
        for dx in range(k):
            nb = dpad[dy:dy + H, dx:dx + W]
            diff = depth - nb
            color_k = torch.exp(-_abs(diff) / (2 * color_sigma ** 2))
            loss = loss + torch.mean(spatial[dy, dx] * color_k * diff * diff)
    return loss


def huber_l1_edge_aware(pred_depth, gt_depth, rgb, thresh: float = 0.2):
    """Edge-aware HuberL1 (loss.py:170-202): huber on depth with the cutoff
    at thresh * max|err|, weighted by exp(-|rgb gradient|), summed over the
    x and y neighbor directions. Depths [H, W], rgb [H, W, 3]."""
    l1 = _abs(pred_depth - gt_depth)
    d = thresh * torch.max(l1)
    d = _max(d, 1e-12)
    huber = ((pred_depth - gt_depth) ** 2 + d * d) / (2 * d)
    loss = torch.where(l1 >= d, l1, huber)
    grad_x = torch.mean(_abs(rgb[:, :-1, :] - rgb[:, 1:, :]), -1)
    grad_y = torch.mean(_abs(rgb[:-1, :, :] - rgb[1:, :, :]), -1)
    loss_x = torch.exp(-grad_x) * loss[:, :-1]
    loss_y = torch.exp(-grad_y) * loss[:-1, :]
    return torch.mean(loss_x) + torch.mean(loss_y)


def minmax_normalize(x, eps: float = 1e-8):
    """The reference's depth pre-normalization (bloomscene.py:298-305)."""
    return (x - torch.min(x)) / (torch.max(x) - torch.min(x) + eps)

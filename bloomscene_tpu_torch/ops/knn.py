"""K-nearest-neighbor mean squared distance (the simple-knn replacement).

For every point, the mean squared distance to its 3 nearest neighbors; used
once at init for the anchors' offset scales (gaussian_model.py:464). Exact
O(N^2) for N <= 2048; above that the JAX package's multi-pass Morton search:
each pass Morton-sorts the points in a differently rotated frame, takes
+-``window`` candidates in sorted order, and the k nearest of the
deduplicated union are kept.
"""
from __future__ import annotations

import numpy as np
import torch


def _morton10(g: torch.Tensor) -> torch.Tensor:
    """10-bit coords [N, 3] -> 30-bit Morton codes [N] (simple_knn.cu:45-70)."""
    def spread(v):
        v = v.to(torch.int64)
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v
    return spread(g[:, 0]) | (spread(g[:, 1]) << 1) | (spread(g[:, 2]) << 2)


def _rotations() -> list[np.ndarray]:
    """The identity plus two rotations that move the octant-boundary planes
    where one Morton curve has long-range discontinuities."""
    def rot(axis, deg):
        a = np.deg2rad(deg)
        c, s = np.cos(a), np.sin(a)
        if axis == 0:
            return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
        if axis == 1:
            return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    return [np.eye(3),
            rot(2, 31.0) @ rot(0, 23.0),
            rot(1, 47.0) @ rot(2, 61.0)]


def knn_mean_sq_dist(points: torch.Tensor, k: int = 3,
                     window: int = 32) -> torch.Tensor:
    """Mean squared distance to the k nearest neighbors, per point. [N]."""
    n = points.shape[0]
    if n <= 2048:
        return _knn_exact(points, k)
    dev = points.device
    offs = torch.from_numpy(np.concatenate(
        [np.arange(-window, 0), np.arange(1, window + 1)])).to(dev)
    rows = torch.arange(n, device=dev)

    cands = []
    for R in _rotations():
        pr = points @ torch.as_tensor(R.T, dtype=torch.float32, device=dev)
        lo = pr.min(0).values
        hi = pr.max(0).values
        unit = (pr - lo) / torch.clamp(hi - lo, min=1e-12)
        grid = torch.clamp(unit * 1023.0, 0, 1023).to(torch.int64)
        order = torch.sort(_morton10(grid), stable=True).indices
        inv = torch.empty_like(order)
        inv[order] = rows
        pos = inv[:, None] + offs[None, :]
        valid = (pos >= 0) & (pos < n)
        cand = order[torch.clamp(pos, 0, n - 1)]              # [N, 2w]
        cands.append(torch.where(valid, cand, n))             # n = sentinel
    cand = torch.cat(cands, 1)                                # [N, P*2w]

    outs = []
    chunk = 131072
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        c = torch.sort(cand[lo:hi], dim=1).values
        dup = torch.cat([torch.zeros((hi - lo, 1), dtype=torch.bool,
                                     device=dev), c[:, 1:] == c[:, :-1]], 1)
        bad = dup | (c >= n)
        diff = points[torch.clamp(c, max=n - 1)] - points[lo:hi, None, :]
        d2 = torch.where(bad, torch.inf, torch.sum(diff * diff, -1))
        outs.append(_mean_of(-torch.topk(-d2, k, dim=1).values))
    return torch.cat(outs)


def _mean_of(d2: torch.Tensor) -> torch.Tensor:
    """The mean over the last axis as XLA computes ``jnp.mean`` under jit:
    the sum times the float32 reciprocal of the count (a divide by the
    count rounds otherwise in the last bit)."""
    n = d2.shape[-1]
    return d2.sum(-1) * (float(np.float32(1.0 / n)) if n else float('nan'))


def _knn_exact(points: torch.Tensor, k: int = 3) -> torch.Tensor:
    n = points.shape[0]
    d2 = torch.sum((points[:, None, :] - points[None, :, :]) ** 2, -1)
    d2 = d2 + torch.where(torch.eye(n, dtype=torch.bool,
                                    device=points.device), torch.inf, 0.0)
    return _mean_of(-torch.topk(-d2, min(k, n - 1), dim=1).values)

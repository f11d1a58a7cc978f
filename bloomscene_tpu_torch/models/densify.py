"""Densification statistics (training_statis, gaussian_model.py:742-759).

The port of ``bloomscene_tpu/models/densify.py``'s ``DensifyStats``,
``init_stats`` and ``accumulate_stats`` (:25-90), dense and compacted. The
anchor surgery (``adjust_anchor``) is not ported yet (ROADMAP queue 1).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class DensifyStats(NamedTuple):
    opacity_accum: torch.Tensor      # [C]
    anchor_demon: torch.Tensor       # [C]
    offset_grad_accum: torch.Tensor  # [C*K]
    offset_denom: torch.Tensor       # [C*K]


def init_stats(capacity: int, n_offsets: int,
               device: str | torch.device = "cuda") -> DensifyStats:
    def z(n):
        return torch.zeros((n,), dtype=torch.float32, device=device)
    return DensifyStats(opacity_accum=z(capacity), anchor_demon=z(capacity),
                        offset_grad_accum=z(capacity * n_offsets),
                        offset_denom=z(capacity * n_offsets))


@torch.no_grad()
def accumulate_stats(stats: DensifyStats, neural_opacity: torch.Tensor,
                     child_valid: torch.Tensor, splat_visible: torch.Tensor,
                     anchor_visible: torch.Tensor, mean2d_grad: torch.Tensor,
                     W: int, H: int,
                     anchor_idx: torch.Tensor | None = None) -> DensifyStats:
    """One view's contribution. ``neural_opacity``, ``child_valid`` and
    ``splat_visible`` are per child [V*K]; ``mean2d_grad`` is the flat
    [V*K*2] gradient of the mean2d offset. Dense (``anchor_idx`` None):
    V == C and ``anchor_visible`` is [C]. Compacted: ``anchor_idx`` [V] maps
    rows to anchor slots (== C for padding) and the contributions add into
    the full-capacity statistics. The pixel-space gradient is scaled by
    (W/2, H/2) before its norm, the reference's NDC units
    (backward.cu:473-475)."""
    C = stats.opacity_accum.shape[0]
    K = stats.offset_grad_accum.shape[0] // C
    scale = torch.tensor([W * 0.5, H * 0.5], dtype=torch.float32,
                         device=mean2d_grad.device)
    g = mean2d_grad.reshape(-1, 2) * scale
    gnorm = torch.linalg.vector_norm(g, dim=-1)
    V = gnorm.shape[0] // K
    opac = torch.clamp(neural_opacity, min=0.0).reshape(V, K)

    if anchor_idx is None:
        av = anchor_visible.to(torch.float32)
        upd = ((child_valid & splat_visible).reshape(V, K)
               & anchor_visible[:, None]).reshape(-1).to(torch.float32)
        return DensifyStats(
            opacity_accum=stats.opacity_accum + av * torch.sum(opac, 1),
            anchor_demon=stats.anchor_demon + av,
            offset_grad_accum=stats.offset_grad_accum + upd * gnorm,
            offset_denom=stats.offset_denom + upd)

    ok = anchor_idx < C
    av = ok.to(torch.float32)
    safe = torch.clamp(anchor_idx, max=C - 1).long()
    upd = ((child_valid & splat_visible).reshape(V, K)
           & ok[:, None]).to(torch.float32)
    flat_idx = (safe[:, None] * K + torch.arange(
        K, device=safe.device)[None, :]).reshape(-1)
    return DensifyStats(
        opacity_accum=stats.opacity_accum.index_add(
            0, safe, av * torch.sum(opac, 1)),
        anchor_demon=stats.anchor_demon.index_add(0, safe, av),
        offset_grad_accum=stats.offset_grad_accum.index_add(
            0, flat_idx, (upd * gnorm.reshape(V, K)).reshape(-1)),
        offset_denom=stats.offset_denom.index_add(0, flat_idx,
                                                  upd.reshape(-1)))

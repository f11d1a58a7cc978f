"""Densification: the statistics (training_statis,
gaussian_model.py:742-759) and the anchor surgery (adjust_anchor,
:898-952).

The port of ``bloomscene_tpu/models/densify.py``. The statistics
accumulate on the device every step, dense or compacted. Every
``update_interval`` steps ``adjust_anchor`` grows anchors from children
with large view-space gradients and prunes anchors of low opacity: the
candidate search, the voxel dedup and the stat bookkeeping run on the host
in numpy, with the same numpy arithmetic as the JAX package (so the grown
anchors are the same to the bit), and the writes to the anchor state and
the optimizer's moments run on the device, in place.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .plain import device_constant, gather_rows_bwd


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
    V == C and ``anchor_visible`` is [C]. Compacted: ``anchor_idx`` [V]
    (nondecreasing, as ``compact_visible`` makes it) maps rows to anchor
    slots (== C for padding) and the contributions add into the
    full-capacity statistics (``gather_rows_bwd`` with bases: one call of
    the kernel on the card, ``index_add`` on the CPU). The pixel-space
    gradient is scaled by (W/2, H/2) before its norm, the reference's NDC
    units (backward.cu:473-475)."""
    C = stats.opacity_accum.shape[0]
    K = stats.offset_grad_accum.shape[0] // C
    scale = device_constant(np.asarray([W * 0.5, H * 0.5], np.float32),
                            mean2d_grad.device)
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
    # one segmented sum over the nondecreasing ``safe`` for all four: on
    # the card one call of gather_rows_bwd, on the CPU index_add (each
    # [C, K] row's K adds in entry order, as a flat index would add them)
    sums = gather_rows_bwd(
        [(av * torch.sum(opac, 1))[:, None], av[:, None],
         upd * gnorm.reshape(V, K), upd], safe, C,
        bases=[stats.opacity_accum[:, None], stats.anchor_demon[:, None],
               stats.offset_grad_accum.view(C, K),
               stats.offset_denom.view(C, K)])
    return DensifyStats(*(t.reshape(-1) for t in sums))



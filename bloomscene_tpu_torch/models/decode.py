"""Anchor -> neural Gaussian decode (gaussian_renderer/__init__.py:26-208).

Phase 0 only: ``mode='train'`` uses the raw attributes and is
differentiable (gradients reach the anchor state through the
straight-through quantizer and mask, and the heads); ``mode='eval'``
quantizes them with STE_multistep at the adaptive step from the hash-grid
context (gaussian_renderer:131-145) and runs without grad. Invalid children
keep opacity 0 and are culled by the rasterizer's validity mask, as in the
JAX package. The phase 1/2 noise, the rate loss, the SH color branch and
the feature bank come later (ROADMAP).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import GSConfig
from ..device import strict_fp32
from ..ops.graphics import normalize_quat
from ..ops.quantization import ste_multistep
from . import heads as heads_lib
from .anchors import (get_anchor_quantized, get_mask, get_mask_anchor,
                      get_scaling)
from .model import Model, calc_interp_feat


class DecodedGaussians(NamedTuple):
    """Per-child-Gaussian tensors, all [C*K, ...] with a validity mask."""
    xyz: torch.Tensor          # [M, 3]
    color: torch.Tensor        # [M, 3]
    opacity: torch.Tensor      # [M]
    scaling: torch.Tensor      # [M, 3]
    rotation: torch.Tensor     # [M, 4] (normalized)
    valid: torch.Tensor        # [M] bool (alive & mask & opacity > 0)
    neural_opacity: torch.Tensor  # [M] pre-mask tanh opacity


class RateInfo(NamedTuple):
    bit_per_param: torch.Tensor
    bit_per_feat_param: torch.Tensor
    bit_per_scaling_param: torch.Tensor
    bit_per_offsets_param: torch.Tensor
    mask_anchor_rate: torch.Tensor


def masked_mean(x, w):
    return torch.sum(x * w) / torch.clamp(torch.sum(w), min=1.0)


def attribute_means(state) -> tuple:
    """(feat, scaling, offset) means over alive anchors: the quantization
    centers of eval mode, taken over the whole anchor set."""
    aw = state.alive.to(torch.float32)
    return (masked_mean(state.feat, aw[:, None]),
            masked_mean(get_scaling(state), aw[:, None]),
            masked_mean(state.offset, aw[:, None, None]))


def phase0_rate(state, visible: torch.Tensor | None = None) -> RateInfo:
    """The rate of phase 0 (decode.py:91-95): zero bits, and the share of
    visible anchors with a child mask on, without gradient (the reference
    takes it over the visible-compacted set,
    gaussian_renderer/__init__.py:44-46)."""
    visible = state.alive if visible is None else visible & state.alive
    rate = masked_mean(get_mask_anchor(state),
                       visible.to(torch.float32)).detach()
    zero = torch.zeros((), device=state.device)
    return RateInfo(zero, zero, zero, zero, rate)


def decode_neural_gaussians(model: Model, cam_center: torch.Tensor,
                            cfg: GSConfig, *, phase: int = 0,
                            mode: str = 'train',
                            visible: torch.Tensor | None = None,
                            attr_means: tuple | None = None
                            ) -> DecodedGaussians:
    """``attr_means`` overrides the eval quantization centers (render()
    passes the full state's when it decodes a compacted visible subset).
    On a CUDA device the heads run in full float32 (TF32 off, see
    ``device.strict_fp32``)."""
    if phase != 0 or mode not in ('train', 'eval'):
        raise NotImplementedError(
            f"decode phase {phase} mode {mode!r}: the port decodes phase 0 "
            "in 'train' and 'eval' mode (phases 1/2: ROADMAP queue 1)")
    with torch.set_grad_enabled(mode == 'train' and torch.is_grad_enabled()):
        return _decode(model, cam_center, cfg, mode, visible, attr_means)


def _decode(model: Model, cam_center: torch.Tensor, cfg: GSConfig,
            mode: str, visible, attr_means) -> DecodedGaussians:
    st = model.state
    strict_fp32(st.device)
    C, K = st.capacity, st.n_offsets
    anchor = get_anchor_quantized(st, model.bounds)
    feat = st.feat
    grid_scaling = get_scaling(st)              # [C, 6]
    grid_offsets = st.offset                    # [C, K, 3]
    binary_mask = get_mask(st)                  # [C, K, 1]
    visible = st.alive if visible is None else visible & st.alive

    if mode == 'eval':
        ctx = calc_interp_feat(model, anchor, cfg)              # [C, ctx]
        out = heads_lib.apply_grid(model.heads, ctx)
        F = cfg.feat_dim
        sizes = [F, F, 6, 6, 3 * K, 3 * K, 1, 1, 1]
        (_, _, _, _, _, _, q_feat_adj, q_scaling_adj,
         q_offsets_adj) = torch.split(out, sizes, dim=-1)
        q_feat = cfg.q_base_feat * (1 + torch.tanh(q_feat_adj))
        q_scaling = cfg.q_base_scaling * (1 + torch.tanh(q_scaling_adj))
        q_offsets = cfg.q_base_offsets * (1 + torch.tanh(q_offsets_adj))
        feat_mean, scal_mean, off_mean = (attr_means if attr_means
                                          is not None
                                          else attribute_means(st))
        feat = ste_multistep(feat, q_feat, feat_mean)
        grid_scaling = ste_multistep(grid_scaling, q_scaling, scal_mean)
        grid_offsets = ste_multistep(grid_offsets, q_offsets[:, :, None],
                                     off_mean)

    # view-conditioned heads (gaussian_renderer:151-203)
    ob_view = anchor - cam_center[None, :]
    ob_dist = torch.linalg.vector_norm(ob_view, dim=1, keepdim=True)
    ob_view = ob_view / torch.clamp(ob_dist, min=1e-12)
    cat_view = torch.cat([feat, ob_view, ob_dist], -1)          # [C, F+4]

    neural_opacity = heads_lib.apply_opacity(model.heads, cat_view)
    neural_opacity = neural_opacity.reshape(-1) * binary_mask.reshape(-1)
    child_valid = ((neural_opacity > 0.0)
                   & torch.repeat_interleave(visible, K))
    opacity = torch.where(child_valid, neural_opacity, 0.0)

    scale_rot = heads_lib.apply_cov(model.heads, cat_view).reshape(-1, 7)
    scaling6 = torch.repeat_interleave(grid_scaling, K, dim=0)  # [C*K, 6]
    anchors_rep = torch.repeat_interleave(anchor, K, dim=0)     # [C*K, 3]
    offsets = grid_offsets.reshape(-1, 3)

    scaling = scaling6[:, 3:] * torch.sigmoid(scale_rot[:, :3])
    rot = normalize_quat(scale_rot[:, 3:7])
    xyz = anchors_rep + offsets * scaling6[:, :3]
    color = heads_lib.apply_color(model.heads, cat_view).reshape(-1, 3)
    return DecodedGaussians(xyz=xyz, color=color, opacity=opacity,
                            scaling=scaling, rotation=rot,
                            valid=child_valid,
                            neural_opacity=neural_opacity)

"""Anchor -> neural Gaussian decode (gaussian_renderer/__init__.py:26-208).

``mode='train'`` is differentiable (gradients reach the anchor state
through the straight-through quantizer and mask, the heads and, in phase
2, the hash tables); ``mode='eval'`` quantizes the attributes with
STE_multistep at the adaptive step from the hash-grid context
(gaussian_renderer:131-145) and runs without grad; ``mode='decoded'``
takes the attributes as they are, with neither the context nor the
quantization, and runs without grad: the render of a scene that the codec
decoded, whose attributes are already the quantized values. Training
phases:

- phase 0 (step <= noise_from_step): the raw attributes;
- phase 1 (up to context_from_step): additive N(0, Q_base) noise on the
  feature, the scaling and the offsets (gaussian_renderer:56-67);
- phase 2: the hash-grid context's entropy parameters, noise at the
  adaptive Q, and the rate on a ~5% subsample of the visible anchors with
  a child mask on (gaussian_renderer:73-127).

The random draws come in as a ``DecodeNoise`` the caller makes (see
``draw_noise``): drawn before a checkpointed forward, they are the same
when the forward is recomputed. Invalid children keep opacity 0 and are
culled by the rasterizer's validity mask, as in the JAX package. With
``color_mode='sh'`` the color comes from per-child SH coefficients, and
with ``use_feat_bank`` the feature is a view-weighted blend of its strided
views (gaussian_renderer:156-167).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import GSConfig
from ..device import strict_fp32
from ..ops.entropy import entropy_gaussian_bits
from ..ops.graphics import normalize_quat
from ..ops.quantization import ste_multistep
from ..ops.sh import eval_sh, num_sh_coeffs
from ..utils.profiling import span
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


class DecodeNoise(NamedTuple):
    """The decode's random draws over its C rows: standard normals for the
    feature [C, F], the scaling [C, 6] and the offsets [C, K, 3] (phases 1
    and 2), and the uniform [C] that picks the rate subsample (phase 2;
    None in phase 1)."""
    feat: torch.Tensor
    scaling: torch.Tensor
    offsets: torch.Tensor
    choose: torch.Tensor | None = None


def draw_noise(rows: int, cfg: GSConfig, phase: int,
               generator: torch.Generator, device) -> DecodeNoise | None:
    """The draws a train-mode decode of ``rows`` anchor rows takes in
    ``phase`` (None in phase 0), from ``generator`` (which lives on
    ``device``)."""
    if phase == 0:
        return None
    kw = dict(generator=generator, device=device, dtype=torch.float32)
    K = cfg.n_offsets
    return DecodeNoise(
        feat=torch.randn((rows, cfg.feat_dim), **kw),
        scaling=torch.randn((rows, 6), **kw),
        offsets=torch.randn((rows, K, 3), **kw),
        choose=torch.rand((rows,), **kw) if phase == 2 else None)


def repeat_rows(x: torch.Tensor, k: int, dim: int = 0) -> torch.Tensor:
    """``torch.repeat_interleave(x, k, dim)``, each entry ``k`` times in
    place, built as a broadcast: its backward sums the ``k`` copies as a
    reduction, where repeat_interleave's backward (index_add_) adds them
    atomically on the card, in no fixed order."""
    dim = dim % x.dim()
    shape = list(x.shape)
    out = x.unsqueeze(dim + 1).expand(*shape[:dim + 1], k, *shape[dim + 1:])
    shape[dim] *= k
    return out.reshape(shape)


def masked_mean(x, w):
    return torch.sum(x * w) / torch.clamp(torch.sum(w), min=1.0)


def attribute_means(state) -> tuple:
    """(feat, scaling, offset) means over alive anchors: the quantization
    centers of eval mode and of the phase-2 rate, taken over the whole
    anchor set."""
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


def _rate(cfg: GSConfig, st, visible, noise: DecodeNoise, mask_rate,
          binary_mask, feat_args, scaling_args, offset_args) -> RateInfo:
    """The phase-2 rate on a ~5% subsample of the visible anchors with a
    child mask on (gaussian_renderer:102-103), computed densely, weighted;
    each ``*_args`` is (values, mean, scale, q, quantization center) for
    ``entropy_gaussian_bits``."""
    K = st.n_offsets
    cw = ((noise.choose <= cfg.rate_subsample)
          & (get_mask_anchor(st) > 0) & visible).to(torch.float32)
    bit_feat = entropy_gaussian_bits(*feat_args)                # [C, F]
    bit_scaling = entropy_gaussian_bits(*scaling_args)          # [C, 6]
    bit_offsets = entropy_gaussian_bits(*offset_args)           # [C, 3K]
    bit_offsets = bit_offsets * repeat_rows(binary_mask[:, :, 0], 3, dim=-1)
    n_chosen = torch.clamp(torch.sum(cw), min=1.0)
    sum_feat = torch.sum(bit_feat * cw[:, None])
    sum_scaling = torch.sum(bit_scaling * cw[:, None])
    sum_offsets = torch.sum(bit_offsets * cw[:, None])
    denom_feat = n_chosen * feat_args[0].shape[1]
    denom_scaling = n_chosen * 6
    denom_offsets = n_chosen * 3 * K
    r = mask_rate
    return RateInfo(
        bit_per_param=((sum_feat + sum_scaling + sum_offsets)
                       / (denom_feat + denom_scaling + denom_offsets) * r),
        bit_per_feat_param=sum_feat / denom_feat * r,
        bit_per_scaling_param=sum_scaling / denom_scaling * r,
        bit_per_offsets_param=sum_offsets / denom_offsets * r,
        mask_anchor_rate=r)


def decode_neural_gaussians(model: Model, cam_center: torch.Tensor,
                            cfg: GSConfig, *, phase: int = 0,
                            mode: str = 'train',
                            visible: torch.Tensor | None = None,
                            noise: DecodeNoise | None = None,
                            attr_means: tuple | None = None
                            ) -> tuple[DecodedGaussians, RateInfo | None]:
    """-> (decoded Gaussians, rate); the rate is None in eval and decoded
    mode.
    ``noise`` holds the train-mode draws of phases 1 and 2 over the
    model's rows. ``attr_means`` overrides the quantization centers (eval,
    and the phase-2 rate): render() passes the full state's when it
    decodes a compacted visible subset. On a CUDA device the heads run in
    full float32 (TF32 off, see ``device.strict_fp32``)."""
    if mode not in ('train', 'eval', 'decoded') or phase not in (0, 1, 2):
        raise ValueError(f"decode phase {phase} mode {mode!r}: phases 0-2 "
                         "in 'train', 'eval' or 'decoded' mode")
    if mode == 'train' and phase > 0 and noise is None:
        raise ValueError(f"a train-mode decode in phase {phase} needs its "
                         "DecodeNoise")
    with torch.set_grad_enabled(mode == 'train' and torch.is_grad_enabled()):
        return _decode(model, cam_center, cfg, phase, mode, visible, noise,
                       attr_means)


def _decode(model: Model, cam_center: torch.Tensor, cfg: GSConfig,
            phase: int, mode: str, visible, noise, attr_means):
    st = model.state
    strict_fp32(st.device)
    C, K = st.capacity, st.n_offsets
    anchor = get_anchor_quantized(st, model.bounds)
    feat = st.feat
    grid_scaling = get_scaling(st)              # [C, 6]
    grid_offsets = st.offset                    # [C, K, 3]
    binary_mask = get_mask(st)                  # [C, K, 1]
    rate = phase0_rate(st, visible) if mode == 'train' else None
    visible = st.alive if visible is None else visible & st.alive
    train = mode == 'train'

    if train and phase == 1:
        feat = feat + noise.feat * cfg.q_base_feat
        grid_scaling = grid_scaling + noise.scaling * cfg.q_base_scaling
        grid_offsets = grid_offsets + noise.offsets * cfg.q_base_offsets

    if mode == 'eval' or (train and phase == 2):
        with span("decode.context"):
            ctx = calc_interp_feat(model, anchor, cfg)          # [C, ctx]
            out = heads_lib.apply_grid(model.heads, ctx)
        F = cfg.feat_dim
        sizes = [F, F, 6, 6, 3 * K, 3 * K, 1, 1, 1]
        (mean_f, scale_f, mean_s, scale_s, mean_o, scale_o, q_feat_adj,
         q_scaling_adj, q_offsets_adj) = torch.split(out, sizes, dim=-1)
        q_feat = cfg.q_base_feat * (1 + torch.tanh(q_feat_adj))
        q_scaling = cfg.q_base_scaling * (1 + torch.tanh(q_scaling_adj))
        q_offsets = cfg.q_base_offsets * (1 + torch.tanh(q_offsets_adj))
        feat_mean, scal_mean, off_mean = (attr_means if attr_means
                                          is not None
                                          else attribute_means(st))

    if train and phase == 2:
        feat = feat + noise.feat * (q_feat + 1e-6)
        grid_scaling = grid_scaling + noise.scaling * (q_scaling + 1e-6)
        grid_offsets = (grid_offsets
                        + noise.offsets * (q_offsets + 1e-6)[:, :, None])
        with span("decode.rate"):
            rate = _rate(cfg, st, visible, noise, rate.mask_anchor_rate,
                         binary_mask, (feat, mean_f, scale_f, q_feat,
                                       feat_mean),
                         (grid_scaling, mean_s, scale_s, q_scaling,
                          scal_mean),
                         (grid_offsets.reshape(C, 3 * K), mean_o, scale_o,
                          q_offsets, off_mean))

    if mode == 'eval':
        feat = ste_multistep(feat, q_feat, feat_mean)
        grid_scaling = ste_multistep(grid_scaling, q_scaling, scal_mean)
        grid_offsets = ste_multistep(grid_offsets, q_offsets[:, :, None],
                                     off_mean)

    # view-conditioned heads (gaussian_renderer:151-203)
    ob_view = anchor - cam_center[None, :]
    ob_dist = torch.linalg.vector_norm(ob_view, dim=1, keepdim=True)
    ob_view = ob_view / torch.clamp(ob_dist, min=1e-12)

    if cfg.use_feat_bank:
        # softmax weights from (ob_view, ob_dist) blend the coarse, medium
        # and fine strided views of feat; the tiled views are cropped back
        # to F, which the JAX package does for F not divisible by 4
        F = feat.shape[1]
        bank_w = heads_lib.apply_feature_bank(
            model.heads, torch.cat([ob_view, ob_dist], -1))     # [C, 3]
        feat = (feat[:, ::4].repeat(1, 4)[:, :F] * bank_w[:, 0:1]
                + feat[:, ::2].repeat(1, 2)[:, :F] * bank_w[:, 1:2]
                + feat * bank_w[:, 2:3])

    cat_view = torch.cat([feat, ob_view, ob_dist], -1)          # [C, F+4]

    neural_opacity = heads_lib.apply_opacity(model.heads, cat_view)
    neural_opacity = neural_opacity.reshape(-1) * binary_mask.reshape(-1)
    child_valid = ((neural_opacity > 0.0)
                   & repeat_rows(visible, K))
    opacity = torch.where(child_valid, neural_opacity, 0.0)

    scale_rot = heads_lib.apply_cov(model.heads, cat_view).reshape(-1, 7)
    scaling6 = repeat_rows(grid_scaling, K)                     # [C*K, 6]
    anchors_rep = repeat_rows(anchor, K)                        # [C*K, 3]
    offsets = grid_offsets.reshape(-1, 3)

    scaling = scaling6[:, 3:] * torch.sigmoid(scale_rot[:, :3])
    rot = normalize_quat(scale_rot[:, 3:7])
    xyz = anchors_rep + offsets * scaling6[:, :3]
    if cfg.color_mode == 'sh':
        # per-child coefficients from the view-independent feature; the
        # SH basis carries the view dependence, and gradients to xyz
        m = num_sh_coeffs(cfg.sh_degree)
        coeffs = heads_lib.apply_color_sh(model.heads, feat).reshape(-1, m, 3)
        color = eval_sh(cfg.sh_degree, coeffs, xyz, cam_center)
    else:
        color = heads_lib.apply_color(model.heads, cat_view).reshape(-1, 3)
    dec = DecodedGaussians(xyz=xyz, color=color, opacity=opacity,
                           scaling=scaling, rotation=rot, valid=child_valid,
                           neural_opacity=neural_opacity)
    return dec, rate

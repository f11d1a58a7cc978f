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

import time
from typing import NamedTuple

import numpy as np
import torch

from ..config import GSConfig
from ..device import device_constant
from ..ops.cuda.gather_rows_bwd import gather_rows_bwd
from .anchors import capacity_bucket, inverse_sigmoid
from .model import Model


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


def _grow_capacity(arr: np.ndarray, new_cap: int) -> np.ndarray:
    out = np.zeros((new_cap,) + arr.shape[1:], arr.dtype)
    out[:arr.shape[0]] = arr
    return out


def _rows_not_in(query: np.ndarray, table: np.ndarray) -> np.ndarray:
    """True where a row of ``query`` (rows already unique) is not among the
    rows of ``table`` (sort-based, one ``np.unique`` over both)."""
    if table.shape[0] == 0:
        return np.ones(query.shape[0], bool)
    both = np.concatenate([table, query], 0)
    _, inv = np.unique(both, axis=0, return_inverse=True)
    in_table = np.zeros(int(inv.max()) + 1, bool)
    in_table[inv[:table.shape[0]]] = True
    return ~in_table[inv[table.shape[0]:]]


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def adjust_anchor(model: Model, stats: DensifyStats, optimizer,
                  cfg: GSConfig, voxel_size: float,
                  rng: np.random.Generator):
    """Grow and prune (adjust_anchor, gaussian_model.py:898-952) ->
    (model, stats, info).

    The host reads the [C] statistics, the alive mask, the anchors and the
    offset, scaling and feature rows of anchors with at least one child
    over the gradient threshold. New anchors go into free slots, written in
    place (``AnchorState.write_rows``); when too few are free the state
    grows to ``capacity_bucket(1.25 (C + n_new))`` with new, zero-padded
    leaf tensors. ``optimizer`` (the trainer's ``Adam``, or None) zeroes
    the moments of every changed slot and pads them on growth
    (``Adam.anchor_surgery``). ``info`` holds n_new, n_pruned, n_alive,
    capacity, capacity_grown and time_s."""
    t_start = time.perf_counter()
    st = model.state
    C, K = st.capacity, st.n_offsets
    dev = st.device

    alive = _host(st.alive).astype(bool).copy()
    anchor = np.asarray(_host(st.anchor), np.float32).reshape(C, 3)
    op_acc = _host(stats.opacity_accum).copy()
    demon = _host(stats.anchor_demon).copy()
    g_acc = _host(stats.offset_grad_accum).reshape(C, K).copy()
    g_den = _host(stats.offset_denom).reshape(C, K).copy()

    with np.errstate(invalid='ignore', divide='ignore'):
        grads = g_acc / g_den
    grads = np.nan_to_num(grads, nan=0.0, posinf=0.0)
    offset_mask = g_den > (cfg.update_interval * cfg.success_threshold * 0.5)
    offset_mask &= alive[:, None]

    # rows with any child over the lowest (level-0) threshold: the only
    # rows whose offsets, scalings and features the grow loop reads
    cand_any = (grads >= cfg.densify_grad_threshold) & offset_mask
    cand_rows = np.where(cand_any.any(1))[0]
    M = cand_rows.size
    if M:
        ridx = torch.from_numpy(cand_rows).to(dev)
        off_rows = np.asarray(_host(st._offset.view(C, -1)[ridx]),
                              np.float32).reshape(M, K, 3)
        scal_rows = np.exp(np.asarray(_host(
            st._scaling_log.view(C, -1)[ridx]), np.float32)[:, :3])
        feat_rows = np.asarray(_host(st._feat.view(C, -1)[ridx]),
                               np.float32)
        cand_xyz = (anchor[cand_rows][:, None, :]
                    + off_rows * scal_rows[:, None, :])     # [M, K, 3]
    r_grads = grads[cand_rows]
    r_mask = offset_mask[cand_rows]

    # ---- grow (anchor_growing, :807-895) ----
    new_rows = {k: [] for k in
                ('anchor', 'feat', 'scaling_log', 'offset', 'mask_logit',
                 'rotation', 'opacity_raw')}
    grown_anchors = []     # dedup against existing and new anchors
    for i in range(cfg.update_depth if M else 0):
        cur_threshold = (cfg.densify_grad_threshold
                         * ((cfg.update_hierachy_factor // 2) ** i))
        cand = (r_grads >= cur_threshold) & r_mask           # [M, K]
        cand &= rng.random(cand.shape) > 0.5 ** (i + 1)
        if not cand.any():
            continue
        size_factor = cfg.update_init_factor // (cfg.update_hierachy_factor
                                                 ** i)
        cur_size = voxel_size * size_factor

        exist = anchor[alive]
        if grown_anchors:
            exist = np.concatenate([exist] + grown_anchors, 0)
        grid_coords = np.round(exist / cur_size).astype(np.int64)

        sel_xyz = cand_xyz[cand]                             # [m, 3]
        # non-finite candidates (exploding offsets * scales) are dropped
        finite = np.isfinite(sel_xyz).all(1) \
            & (np.abs(sel_xyz) < 1e12).all(1)
        if not finite.all():
            cand_idx = np.where(cand.reshape(-1))[0][~finite]
            cand.reshape(-1)[cand_idx] = False
            sel_xyz = sel_xyz[finite]
        if sel_xyz.shape[0] == 0:
            continue
        sel_gc = np.round(sel_xyz / cur_size).astype(np.int64)
        uniq, inverse = np.unique(sel_gc, axis=0, return_inverse=True)

        keep = _rows_not_in(uniq, grid_coords)   # voxels not yet occupied
        if not keep.any():
            continue

        cand_feat = np.repeat(feat_rows, K, axis=0).reshape(M, K, -1)[cand]
        feat_max = np.full((uniq.shape[0], cand_feat.shape[1]), -np.inf,
                           np.float32)
        np.maximum.at(feat_max, inverse, cand_feat)

        new_anchor = (uniq[keep] * cur_size).astype(np.float32)
        m = new_anchor.shape[0]
        new_rows['anchor'].append(new_anchor)
        new_rows['feat'].append(feat_max[keep])
        new_rows['scaling_log'].append(
            np.full((m, 6), np.log(cur_size), np.float32))
        new_rows['offset'].append(np.zeros((m, K, 3), np.float32))
        new_rows['mask_logit'].append(np.ones((m, K, 1), np.float32))
        rot = np.zeros((m, 4), np.float32)
        rot[:, 0] = 1
        new_rows['rotation'].append(rot)
        new_rows['opacity_raw'].append(
            np.full((m, 1), float(inverse_sigmoid(0.1)), np.float32))
        grown_anchors.append(new_anchor)

    n_new = sum(a.shape[0] for a in new_rows['anchor'])

    # ---- stat resets for counted offsets (:907-918) ----
    g_den[offset_mask] = 0
    g_acc[offset_mask] = 0

    # ---- prune (:920-947) ----
    prune = (op_acc < cfg.min_opacity * demon)
    anchors_counted = demon > cfg.update_interval * cfg.success_threshold
    prune = prune & anchors_counted & alive
    op_acc[anchors_counted] = 0
    demon[anchors_counted] = 0
    op_acc[prune] = 0
    demon[prune] = 0
    g_acc[prune] = 0
    g_den[prune] = 0
    alive[prune] = False

    # ---- place new anchors into free slots, growing the capacity ----
    changed_slots = np.where(prune)[0].tolist()
    old_capacity = C
    capacity_grown = False
    if n_new > 0:
        free = np.where(~alive)[0]
        if free.size < n_new:
            new_cap = capacity_bucket(int((C + n_new) * 1.25))
            st = st.grow(new_cap)
            op_acc = _grow_capacity(op_acc, new_cap)
            demon = _grow_capacity(demon, new_cap)
            g_acc = _grow_capacity(g_acc, new_cap)
            g_den = _grow_capacity(g_den, new_cap)
            alive = _grow_capacity(alive, new_cap)
            free = np.where(~alive)[0]
            capacity_grown = True
            C = new_cap
        slots = free[:n_new]
        st.write_rows(torch.from_numpy(slots).to(dev), {
            f: torch.from_numpy(np.concatenate(v, 0)).to(dev)
            for f, v in new_rows.items()})
        alive[slots] = True
        op_acc[slots] = 0
        demon[slots] = 0
        g_acc[slots] = 0
        g_den[slots] = 0
        changed_slots.extend(slots.tolist())

    # the reference clamps the cov log-scales at 0.05 in the optimizer's
    # prune surgery, which runs after growing, so grown anchors are clamped
    # too (gaussian_model.py:775-787, prune_anchor at :949-950)
    with torch.no_grad():
        st._scaling_log.view(C, 6)[:, 3:].clamp_(max=0.05)
    st = st._replace(alive=torch.from_numpy(alive).to(dev))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a).reshape(-1)).to(dev)
    new_stats = DensifyStats(opacity_accum=t(op_acc), anchor_demon=t(demon),
                             offset_grad_accum=t(g_acc),
                             offset_denom=t(g_den))
    model = model._replace(state=st)
    if optimizer is not None:
        optimizer.anchor_surgery(model, old_capacity,
                                 np.asarray(changed_slots, np.int64))
    info = dict(n_new=n_new, n_pruned=int(prune.sum()),
                n_alive=int(alive.sum()), capacity=C,
                capacity_grown=capacity_grown,
                time_s=round(time.perf_counter() - t_start, 4))
    return model, new_stats, info

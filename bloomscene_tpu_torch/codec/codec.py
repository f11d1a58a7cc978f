"""Scene compression codec: rate estimate and the encode/decode round trip.

The port of ``bloomscene_tpu/codec/codec.py`` (the HAC-style structured
context compression of the reference, scene/gaussian_model.py:1016-1377):
per 1000-anchor chunk, the hash-grid context MLP predicts gaussian entropy
parameters and adaptive quantization steps for the feature, the scaling
and the offsets; the quantized values are rANS-coded against those
gaussians (``codec/rans.py``); the hash tables and the child masks are
Bernoulli-coded; the anchors are stored as 16-bit codes with their AABB.
The directory layout is the JAX package's: ``anchor_codes.npy``,
``feat_<i>.b``, ``scaling_<i>.b``, ``offsets_<i>.b``, ``hash.b``,
``masks.b`` and ``meta.json`` with the same keys.

Where it runs, by design: the per-anchor arrays are read off the model
into host memory, and the context parameters and the ``ste_multistep``
quantization run on the host CPU in plain torch, in ``MEGACHUNK``-sized
batches on both sides, as the JAX package runs them on its host CPU
backend. A bitstream therefore does not depend on the card: a scene
trained on the card encodes to the same bytes as its copy on the CPU.
The context floats condition every rANS stream, and the port's MLP sums
its products in another order than XLA's, so they differ from the JAX
package's in the last bits; ``meta.json`` carries a SHA-256 of them, and
a decode whose recomputed context differs (another package, another
machine's float rounding, a changed MLP) raises instead of decoding into
a garbled scene. ``decode_scene(..., device=...)`` returns the decoded
model on the card unless the caller asks for the CPU.
"""
from __future__ import annotations

import copy
import hashlib
import json
import os
import time

import numpy as np
import torch

from ..config import GSConfig
from ..device import resolve_device
from ..models import heads as heads_lib
from ..models.anchors import (AnchorBounds, AnchorState, get_anchor_quantized,
                              get_mask, get_mask_anchor, get_scaling)
from ..models.model import Model, calc_interp_feat
from ..ops.entropy import binary_entropy_bits, entropy_gaussian_bits
from ..ops.hashgrid import all_grid_params_flat
from ..ops.quantization import ANCHOR_ROUND_DIGITS, Q_ANCHOR, ste_multistep
from . import rans

BIT2MB = 8 * 1024 * 1024
CHUNK = 1000
# anchors per context-MLP batch; both coder sides MUST use the same size,
# since the MLP's float sums may depend on the batch shape and the entropy
# model conditions the rANS streams on these floats
MEGACHUNK = 64 * CHUNK
GRID_KEYS = ('xyz', 'xy', 'xz', 'yz')


def _anchors_from_codes(codes: np.ndarray, bmin: np.ndarray,
                        bmax: np.ndarray) -> np.ndarray:
    """Deterministic float32 anchor reconstruction from 16-bit codes, used
    identically on the encode and decode sides so the context MLP sees
    bit-identical inputs. The arithmetic mirrors quantize_anchor's float32
    operations, so re-quantization is exact under its nudged floor."""
    bmin32 = bmin.astype(np.float32)
    bmax32 = bmax.astype(np.float32)
    interval = np.float32((bmax32 - bmin32) * np.float32(Q_ANCHOR)
                          + np.float32(1e-6))
    return (codes.astype(np.float32) * interval + bmin32).astype(np.float32)


def _host_model(model: Model) -> Model:
    """What the context reads (heads, hash tables, bounds), on the CPU and
    without grad; no per-anchor state."""
    cpu = torch.device('cpu')
    return Model(
        state=None,
        heads=copy.deepcopy(model.heads).to(cpu).requires_grad_(False),
        grid={k: v.detach().to(cpu) for k, v in model.grid.items()},
        bounds=AnchorBounds(*(b.detach().to(cpu) for b in model.bounds)))


def _context_params(model: Model, anchors: torch.Tensor, cfg: GSConfig):
    """grid MLP -> entropy parameters and adaptive Q for ``anchors``."""
    ctx = calc_interp_feat(model, anchors, cfg)
    out = heads_lib.apply_grid(model.heads, ctx)
    F, K = cfg.feat_dim, cfg.n_offsets
    (mean_f, scale_f, mean_s, scale_s, mean_o, scale_o, qf_adj, qs_adj,
     qo_adj) = torch.split(out, [F, F, 6, 6, 3 * K, 3 * K, 1, 1, 1], dim=-1)
    q_f = cfg.q_base_feat * (1 + torch.tanh(qf_adj))
    q_s = cfg.q_base_scaling * (1 + torch.tanh(qs_adj))
    q_o = cfg.q_base_offsets * (1 + torch.tanh(qo_adj))
    return (mean_f, scale_f, mean_s, scale_s, mean_o, scale_o, q_f, q_s, q_o)


@torch.no_grad()
def _context_params_np(model: Model, anchors: np.ndarray, cfg: GSConfig):
    """Context parameters for ALL anchors as numpy float32 arrays, on the
    host CPU in MEGACHUNK-sized batches (identical on encode and
    decode)."""
    host = _host_model(model)
    cols = None
    for lo in range(0, anchors.shape[0], MEGACHUNK):
        part = _context_params(
            host, torch.from_numpy(np.ascontiguousarray(
                anchors[lo:lo + MEGACHUNK], np.float32)), cfg)
        part = [p.numpy() for p in part]
        if cols is None:
            cols = [[p] for p in part]
        else:
            for c, p in zip(cols, part):
                c.append(p)
    return [np.concatenate(c, 0) if len(c) > 1 else c[0] for c in cols]


@torch.no_grad()
def _quantize_np(x: np.ndarray, q: np.ndarray, mean: float) -> np.ndarray:
    """ste_multistep's forward in float32 on the host CPU."""
    return ste_multistep(torch.from_numpy(np.asarray(x, np.float32)),
                         torch.from_numpy(np.asarray(q, np.float32)),
                         np.float32(mean)).numpy()


def _context_digest(params) -> str:
    """SHA-256 over the (clipped) context-parameter floats that condition
    the rANS streams. Encode stores it in meta.json; decode recomputes and
    compares, so a context that differs between the two sides fails
    loudly instead of derailing the entropy decoder."""
    h = hashlib.sha256()
    for a in params:
        h.update(np.ascontiguousarray(a, np.float32).tobytes())
    return h.hexdigest()


@torch.no_grad()
def _alive_arrays(model: Model):
    """The per-anchor arrays to code, compacted on the host: alive anchors
    whose child mask is not empty (get_mask_anchor)."""
    st = AnchorState(**{f: v.detach().cpu()
                        for f, v in model.state.flat_leaves().items()})
    bounds = AnchorBounds(*(b.detach().cpu() for b in model.bounds))
    keep = st.alive & (get_mask_anchor(st) > 0)
    idx = np.where(keep.numpy())[0]
    t = torch.from_numpy(idx)
    return idx, {
        'anchor': get_anchor_quantized(st, bounds)[t].numpy(),
        'feat': st.feat[t].numpy(),
        'offsets': st.offset[t].numpy(),
        'scaling': get_scaling(st)[t].numpy(),
        'mask': get_mask(st)[t].numpy(),
    }


@torch.no_grad()
def estimate_final_bits(model: Model, cfg: GSConfig) -> dict:
    """estimate_final_bits (gaussian_model.py:1016-1071): the entropy
    model's bits per stream, in MB, on the host CPU."""
    idx, arr = _alive_arrays(model)
    n = idx.size
    if n == 0:
        return {'total_MB': 0.0, 'n_anchors': 0,
                'error': 'no alive anchors with non-empty masks'}
    (mean_f, scale_f, mean_s, scale_s, mean_o, scale_o, q_f, q_s, q_o) = [
        torch.from_numpy(a) for a in
        _context_params_np(model, arr['anchor'], cfg)]

    feat = _quantize_np(arr['feat'], q_f.numpy(), float(arr['feat'].mean()))
    scaling = _quantize_np(arr['scaling'], q_s.numpy(),
                           float(arr['scaling'].mean()))
    offsets = _quantize_np(arr['offsets'], q_o.numpy()[:, :, None],
                           float(arr['offsets'].mean())).reshape(n, -1)

    def t(x):
        return torch.from_numpy(np.asarray(x, np.float32))

    bit_feat = torch.sum(entropy_gaussian_bits(
        t(feat), mean_f, scale_f, q_f, float(feat.mean())))
    bit_scaling = torch.sum(entropy_gaussian_bits(
        t(scaling), mean_s, scale_s, q_s, float(scaling.mean())))
    mask3 = np.repeat(arr['mask'][:, :, 0], 3, axis=-1)
    bit_offsets = torch.sum(entropy_gaussian_bits(
        t(offsets), mean_o, scale_o, q_o, float(offsets.mean())) * t(mask3))

    hash_flat = all_grid_params_flat(model.grid).detach().cpu().numpy()
    hash_bin = np.where(hash_flat >= 0, 1.0, -1.0)
    _, bit_hash = binary_entropy_bits(t((hash_bin + 1) / 2))
    _, bit_masks = binary_entropy_bits(t(arr['mask']))
    bit_anchor = n * 3 * ANCHOR_ROUND_DIGITS
    bit_mlp = heads_lib.mlp_param_bits(model.heads)

    sizes = {
        'anchor_MB': float(bit_anchor) / BIT2MB,
        'feat_MB': float(bit_feat) / BIT2MB,
        'scaling_MB': float(bit_scaling) / BIT2MB,
        'offsets_MB': float(bit_offsets) / BIT2MB,
        'hash_MB': float(bit_hash) / BIT2MB,
        'masks_MB': float(bit_masks) / BIT2MB,
        'MLPs_MB': float(bit_mlp) / BIT2MB,
    }
    sizes['total_MB'] = sum(sizes.values())
    sizes['n_anchors'] = n
    return sizes


def _write(path: str, name: str, data: bytes) -> int:
    with open(os.path.join(path, name), 'wb') as f:
        f.write(data)
    return len(data) * 8


def encode_scene(model: Model, cfg: GSConfig, path: str) -> dict:
    """conduct_encoding (gaussian_model.py:1073-1230): write the scene's
    bitstreams into ``path`` -> sizes in MB by stream, the wall seconds and
    their split (context_s, quantize_s, rans_s)."""
    t1 = time.time()
    os.makedirs(path, exist_ok=True)
    idx, arr = _alive_arrays(model)
    n = idx.size
    if n == 0:
        raise ValueError("encode_scene: no alive anchors with non-empty "
                         "masks -- the scene is empty (diverged training?)")
    steps = -(-n // CHUNK)

    # anchors: their 16-bit codes and the bounds; arr['anchor'] is already
    # the quantized reconstruction q*interval+min, so round() recovers q
    bounds_min = model.bounds.x_min.detach().cpu().numpy()
    bounds_max = model.bounds.x_max.detach().cpu().numpy()
    interval = ((bounds_max.astype(np.float64)
                 - bounds_min.astype(np.float64)) * Q_ANCHOR + 1e-6)
    codes = np.clip(np.round((arr['anchor'].astype(np.float64)
                              - bounds_min) / interval),
                    0, 2 ** ANCHOR_ROUND_DIGITS - 1).astype(np.uint16)
    np.save(os.path.join(path, 'anchor_codes.npy'), codes)
    # the context sees the code-reconstructed anchors on BOTH sides
    arr['anchor'] = _anchors_from_codes(codes, bounds_min, bounds_max)

    meta = {'n': int(n), 'chunk': CHUNK, 'backend': 'cpu'}
    feat_mean = float(arr['feat'].mean())
    scaling_mean = float(arr['scaling'].mean())
    offsets_mean = float(arr['offsets'].mean())
    bit_feat = bit_scaling = bit_offsets = 0

    t_ctx = time.time()
    (mean_f, scale_f, mean_s, scale_s, mean_o, scale_o,
     q_f, q_s, q_o) = _context_params_np(model, arr['anchor'], cfg)
    scale_f = np.clip(scale_f, 1e-9, None)
    scale_s = np.clip(scale_s, 1e-9, None)
    scale_o = np.clip(scale_o, 1e-9, None)
    meta['context_sha256'] = _context_digest(
        (mean_f, scale_f, mean_s, scale_s, mean_o, scale_o, q_f, q_s, q_o))
    context_s = time.time() - t_ctx

    t_q = time.time()
    feat_q = _quantize_np(arr['feat'], q_f, feat_mean)
    scaling_q = _quantize_np(arr['scaling'], q_s, scaling_mean)
    offsets_q = _quantize_np(arr['offsets'], q_o[:, :, None],
                             offsets_mean).reshape(n, -1)
    quantize_s = time.time() - t_q

    t_rans = time.time()
    for s in range(steps):
        lo, hi = s * CHUNK, min((s + 1) * CHUNK, n)
        m = hi - lo
        qf = np.broadcast_to(q_f[lo:hi], (m, cfg.feat_dim)).ravel()
        qs = np.broadcast_to(q_s[lo:hi], (m, 6)).ravel()
        qo = np.broadcast_to(q_o[lo:hi], (m, 3 * cfg.n_offsets)).ravel()
        bit_feat += _write(path, f'feat_{s}.b', rans.encode_gaussian(
            feat_q[lo:hi].ravel(), mean_f[lo:hi].ravel(),
            scale_f[lo:hi].ravel(), qf))
        bit_scaling += _write(path, f'scaling_{s}.b', rans.encode_gaussian(
            scaling_q[lo:hi].ravel(), mean_s[lo:hi].ravel(),
            scale_s[lo:hi].ravel(), qs))
        mask3 = (np.repeat(arr['mask'][lo:hi, :, 0], 3, axis=-1)
                 > 0.5).reshape(-1)
        bit_offsets += _write(path, f'offsets_{s}.b', rans.encode_gaussian(
            offsets_q[lo:hi].ravel()[mask3], mean_o[lo:hi].ravel()[mask3],
            scale_o[lo:hi].ravel()[mask3], qo[mask3]))
    rans_s = time.time() - t_rans

    # hash tables and child masks: Bernoulli
    hash_flat = all_grid_params_flat(model.grid).detach().cpu().numpy()
    hash_bin = np.where(hash_flat >= 0, 1.0, -1.0).astype(np.float32)
    prob_hash = float((hash_bin > 0).mean())
    bit_hash = _write(path, 'hash.b', rans.encode_binary(hash_bin, prob_hash))
    masks = arr['mask'].reshape(-1)
    prob_masks = float((masks > 0.5).mean())
    bit_masks = _write(path, 'masks.b',
                       rans.encode_binary(masks * 2 - 1, prob_masks))

    meta.update(prob_hash=prob_hash, prob_masks=prob_masks,
                feat_mean=feat_mean, scaling_mean=scaling_mean,
                offsets_mean=offsets_mean,
                bounds_min=bounds_min.tolist(), bounds_max=bounds_max.tolist())
    with open(os.path.join(path, 'meta.json'), 'w') as f:
        json.dump(meta, f)

    sizes = {
        'anchor_MB': codes.size * ANCHOR_ROUND_DIGITS / BIT2MB,
        'feat_MB': bit_feat / BIT2MB,
        'scaling_MB': bit_scaling / BIT2MB,
        'offsets_MB': bit_offsets / BIT2MB,
        'hash_MB': bit_hash / BIT2MB,
        'masks_MB': bit_masks / BIT2MB,
        'MLPs_MB': heads_lib.mlp_param_bits(model.heads) / BIT2MB,
        'encode_time_s': time.time() - t1,
        'context_s': round(context_s, 3),
        'quantize_s': round(quantize_s, 3),
        'rans_s': round(rans_s, 3),
        'n_anchors': int(n),
    }
    sizes['total_MB'] = sum(v for k, v in sizes.items()
                            if k.endswith('_MB'))
    return sizes


def decode_scene(model_shell: Model, cfg: GSConfig, path: str,
                 timings: dict | None = None,
                 device: str = "cuda") -> Model:
    """conduct_decoding (gaussian_model.py:1233-1377) -> the decoded model
    on ``device``.

    ``model_shell`` provides the MLP heads (shared when already on
    ``device``, else copied there); the hash tables and the per-anchor
    state come from the bitstream. The state stores the decoded values
    re-expressed so that the standard activations give them back (the log
    of the decoded scaling, +-10 mask logits); render it with
    ``mode='decoded'``. ``timings``, when a dict, receives the wall split
    (hash_s, masks_s, context_s, rans_s, state_s). Raises RuntimeError
    when the recomputed context differs from the encode side's."""
    dev = resolve_device(device)
    with open(os.path.join(path, 'meta.json')) as f:
        meta = json.load(f)
    n = meta['n']
    K, F = cfg.n_offsets, cfg.feat_dim

    # hash tables first (the context depends on them)
    t_hash = time.time()
    with open(os.path.join(path, 'hash.b'), 'rb') as f:
        hash_bin = rans.decode_binary(
            f.read(), meta['prob_hash'],
            sum(model_shell.grid[k].numel() for k in GRID_KEYS))
    grid = _unflatten_grid(model_shell.grid, hash_bin, dev)
    if timings is not None:
        timings['hash_s'] = round(time.time() - t_hash, 3)
    bmin = np.array(meta['bounds_min'], np.float32)
    bmax = np.array(meta['bounds_max'], np.float32)
    bounds = AnchorBounds(x_min=torch.from_numpy(bmin).to(dev),
                          x_max=torch.from_numpy(bmax).to(dev))
    heads = model_shell.heads
    if next(heads.parameters()).device != dev:
        heads = copy.deepcopy(heads).to(dev)
    model = Model(state=None, heads=heads, grid=grid, bounds=bounds)

    # anchors from their 16-bit codes (the encode side's reconstruction)
    anchors = _anchors_from_codes(
        np.load(os.path.join(path, 'anchor_codes.npy')), bmin, bmax)

    t_masks = time.time()
    with open(os.path.join(path, 'masks.b'), 'rb') as f:
        masks = rans.decode_binary(f.read(), meta['prob_masks'], n * K,
                                   as_pm1=False).reshape(n, K, 1)
    if timings is not None:
        timings['masks_s'] = round(time.time() - t_masks, 3)

    # context parameters batched exactly like the encode side
    t_ctx = time.time()
    (mean_f, scale_f, mean_s, scale_s, mean_o, scale_o,
     q_f, q_s, q_o) = _context_params_np(model, anchors, cfg)
    scale_f = np.clip(scale_f, 1e-9, None)
    scale_s = np.clip(scale_s, 1e-9, None)
    scale_o = np.clip(scale_o, 1e-9, None)
    if 'context_sha256' in meta:
        got = _context_digest((mean_f, scale_f, mean_s, scale_s, mean_o,
                               scale_o, q_f, q_s, q_o))
        if got != meta['context_sha256']:
            raise RuntimeError(
                "decode_scene: context-model mismatch -- the entropy "
                f"parameters recomputed here (sha256 {got[:16]}...) differ "
                f"from the encode side's ({meta['context_sha256'][:16]}...). "
                "Decoding would produce a silently garbled scene. Causes: "
                "a bitstream encoded by another package or on another "
                "machine (the context MLP's floats depend on the order of "
                "its sums), or changed MLP heads.")
    if timings is not None:
        timings['context_s'] = round(time.time() - t_ctx, 3)

    t_rans = time.time()
    feat = np.zeros((n, F), np.float32)
    scaling = np.zeros((n, 6), np.float32)
    offsets = np.zeros((n, K, 3), np.float32)
    for s in range(-(-n // CHUNK)):
        lo, hi = s * CHUNK, min((s + 1) * CHUNK, n)
        m = hi - lo
        qf = np.broadcast_to(q_f[lo:hi], (m, F)).ravel()
        qs = np.broadcast_to(q_s[lo:hi], (m, 6)).ravel()
        qo = np.broadcast_to(q_o[lo:hi], (m, 3 * K)).ravel()
        with open(os.path.join(path, f'feat_{s}.b'), 'rb') as f:
            feat[lo:hi] = rans.decode_gaussian(
                f.read(), mean_f[lo:hi].ravel(), scale_f[lo:hi].ravel(),
                qf).reshape(m, F)
        with open(os.path.join(path, f'scaling_{s}.b'), 'rb') as f:
            scaling[lo:hi] = rans.decode_gaussian(
                f.read(), mean_s[lo:hi].ravel(), scale_s[lo:hi].ravel(),
                qs).reshape(m, 6)
        mask3 = np.repeat(masks[lo:hi, :, 0], 3, axis=-1).reshape(-1) > 0.5
        off_flat = np.zeros(m * 3 * K)
        if mask3.any():
            with open(os.path.join(path, f'offsets_{s}.b'), 'rb') as f:
                off_flat[mask3] = rans.decode_gaussian(
                    f.read(), mean_o[lo:hi].ravel()[mask3],
                    scale_o[lo:hi].ravel()[mask3], qo[mask3])
        offsets[lo:hi] = off_flat.reshape(m, K, 3)
    if timings is not None:
        timings['rans_s'] = round(time.time() - t_rans, 3)

    t_state = time.time()

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    state = AnchorState(
        anchor=t(anchors), offset=t(offsets),
        mask_logit=t(np.where(masks > 0.5, 10.0, -10.0)),
        feat=t(feat),
        scaling_log=t(np.log(np.clip(scaling, 1e-9, None))),
        rotation=t(np.tile([1, 0, 0, 0], (n, 1))),
        opacity_raw=t(np.zeros((n, 1))),
        alive=torch.ones((n,), dtype=torch.bool, device=dev))
    if timings is not None:
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)
        timings['state_s'] = round(time.time() - t_state, 3)
    return model._replace(state=state)


def _unflatten_grid(grid_template: dict, flat_bin: np.ndarray,
                    device) -> dict:
    """The decoded flat {-1, +1} tables split into the template's four
    tables, float32 on ``device``."""
    out, pos = {}, 0
    for key in GRID_KEYS:
        size = grid_template[key].numel()
        out[key] = torch.from_numpy(np.ascontiguousarray(
            flat_bin[pos:pos + size], np.float32)).to(device)
        pos += size
    if pos != flat_bin.shape[0]:
        raise ValueError(f"hash.b holds {flat_bin.shape[0]} entries, the "
                         f"shell's tables {pos}")
    return out

"""Rendering a finished scene along a camera list (eval renders, orbit).

The port of ``BloomScene._render_model`` (bloomscene.py:248-336): two
measuring passes size the per-frame buffers snugly, then every frame
renders with them. ``mode='eval'`` renders a trained scene (the hash-grid
context quantizes its attributes), ``mode='decoded'`` the scene that
``codec.decode_scene`` returns, as ``BloomScene.render_video(...,
use_decoded=True)`` does (bloomscene.py:338-341). The BloomScene class,
``--load_dir`` and the video writer come later.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..config import GSConfig
from ..device import resolve_device
from ..models.model import Model
from ..models.render import count_pairs, prefilter_anchors, render

# Eval-render visible-compaction bucket granule; module-level so tests can
# shrink it to exercise compaction at toy scale.
EVAL_VCAP_GRANULE = 8192


def render_model(model: Model, cameras: list, cfg: GSConfig,
                 mode: str = 'eval', device: str = "cuda",
                 frame_stats: list | None = None):
    """Render ``cameras`` (sharing one set of intrinsics) -> (frames [H, W, 3]
    clipped to [0, 1], depths [H, W], fps), frames and depths as float32
    numpy arrays.

    1. The orbit's largest visible-anchor count, in buckets of
       ``EVAL_VCAP_GRANULE``, sizes the per-frame compaction (decode and
       projection then scale with the visible set, not the capacity).
    2. The orbit's largest pair count sizes the binning buffers:
       ``pcap = max(16384, ceil(1.02 * max_pairs / 16384) * 16384)``.
    3. Each frame renders with those sizes. fps leaves out the first frame
       (the warm-up) when more than one frame renders.

    ``frame_stats``, when a list, receives one dict per frame: visible
    anchors, pairs, packed pairs, overflow counters and milliseconds.
    """
    dev = resolve_device(device)
    if model.state.device != dev:
        raise ValueError(f"model lives on {model.state.device}, "
                         f"render requested on {dev}")
    intr = cameras[0].intrinsics
    if any(c.intrinsics != intr for c in cameras):
        raise ValueError("render_model: cameras must share intrinsics")
    cams = [c.device_arrays(dev) for c in cameras]

    C = model.state.capacity
    mv = max(int(prefilter_anchors(model, intr, cam).sum()) for cam in cams)
    g = EVAL_VCAP_GRANULE
    vcap = min(-(-max(mv, g // 32) // g) * g, C)
    eval_vcap = vcap if vcap < C else None

    def visible_of(cam):
        return (prefilter_anchors(model, intr, cam)
                if eval_vcap is not None else None)

    mp = max(int(count_pairs(model, intr, cam, cfg, mode=mode,
                             visible=visible_of(cam),
                             visible_capacity=eval_vcap)) for cam in cams)
    pcap = max(16384, -(-int(mp * 1.02) // 16384) * 16384)

    frames_rgb, frames_depth, times = [], [], []
    for cam in cams:
        t0 = time.perf_counter()
        vis = visible_of(cam)
        res = render(model, intr, cam, cfg, phase=0, mode=mode,
                     visible=vis, visible_capacity=eval_vcap,
                     pair_capacity=pcap, packed_capacity=pcap)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.append(time.perf_counter() - t0)
        frames_rgb.append(np.clip(res.out.color.cpu().numpy(), 0, 1))
        frames_depth.append(res.out.depth.cpu().numpy())
        if frame_stats is not None:
            b = res.bins
            frame_stats.append({
                'visible_anchors': (int(vis.sum()) if vis is not None
                                    else model.state.num_alive()),
                'visible_capacity': eval_vcap,
                'pair_capacity': pcap, 'num_pairs': int(b.num_pairs),
                'num_packed': int(b.num_packed),
                'tile_overflow': int(b.tile_overflow),
                'pair_overflow': int(b.pair_overflow),
                'packed_overflow': int(b.packed_overflow),
                'ms': times[-1] * 1e3})
    timed = times[1:] if len(times) > 1 else times
    fps = len(timed) / max(sum(timed), 1e-9)
    return frames_rgb, frames_depth, float(fps)

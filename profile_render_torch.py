#!/usr/bin/env python3
"""Where a frame's time, or a training step's, goes on the PyTorch port, on
one card.

    python3 profile_render_torch.py [--frames 8] [--decoded]
    python3 profile_render_torch.py --train 10 [--phase 2]
        [--visible_capacity N]

Builds the scene of ``chip_smoke.py`` (~111K anchors, GSConfig defaults,
512x512, the rotate360 orbit).

Render (the default): sizes the buffers as ``render_model`` does, then for
each frame:

1. stage times on the host clock with ``torch.cuda.synchronize()`` after
   each stage: prefilter, compaction, decode, projection, binning (K3, the
   tile sort, K4) and blend (K1 and the image assembly);
2. under ``torch.profiler``: the device time by kernel name, the number of
   kernel launches per frame and the device's busy share of the window.

``--decoded``: the scene goes through the codec first (``encode_scene``
into ``outputs/profile_render_torch``, ``decode_scene`` onto the card)
and the frames render in ``mode='decoded'``, the serving path of a
compressed scene (no hash-grid context, no quantization in the decode).

``--train N``: the training phase of ``chip_smoke.py`` (the perturbed
model, ``GSConfig(voxel_size=0.03, use_dpr=True, start_stat=0)``, the 8
orbit frames as targets); two warm-up steps, N steps of ``Trainer.run``
timed on the host clock, then N more under ``torch.profiler``: per step,
for each ``record_function`` span of the step (``train.*``), of the
decode (``decode.context``: the hash grid and the grid head;
``decode.rate``: the entropy rate) and of the tile blend's backward
(``tile_blend.*``: cotangent planes, K2, the emission-order reduction)
its host time and the device time of the kernels inside its device-side
interval, the device time by kernel name, and the device's busy share.
The backward runs on autograd's device thread, outside the
``train.backward`` span's device-side interval; the line gives its device
time as the window's total less the other step spans. ``--phase 1`` or
``--phase 2`` moves the schedule's boundaries before step 1, so every
step runs in that phase (no densification step is due).
``--visible_capacity N`` trains with ``GSConfig.visible_capacity=N``: the
decode compacted to a bucket of N anchor rows (the full-scale run's
131072; the scene's capacity is 139,264).

Prints one JSON object per measurement, the card's name and power limit
first. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from chip_smoke import kernel_table, span_table


def profile_train(steps: int, repo: str, phase: int = 0,
                  visible_capacity: int | None = None) -> int:
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile
    from bloomscene_tpu_torch.config import GSConfig
    from bloomscene_tpu_torch.pipeline.bloomscene import render_model
    from bloomscene_tpu_torch.train.loop import Trainer

    card = cs.card_name_and_power()
    print(json.dumps({"card": card}), flush=True)
    cfg = GSConfig(voxel_size=0.03)
    model, voxel = cs.trained_scale_model(cs.room_points(cs.N_POINTS, cs.SEED),
                                          cfg, cs.SEED, "cuda")
    cams = cs.orbit_cameras(cs.N_FRAMES, 512, 512, repo)
    frames, depths, _ = render_model(model, cams, cfg, mode="eval")
    # every step in ``phase``: the phase boundaries moved before step 1
    bounds = {0: {}, 1: dict(noise_from_step=0),
              2: dict(noise_from_step=0, context_from_step=0)}[phase]
    cfg_t = GSConfig(voxel_size=0.03, use_dpr=True, start_stat=0,
                     visible_capacity=visible_capacity, **bounds)
    views = [(c.device_arrays("cuda"), torch.as_tensor(f, device="cuda"),
              torch.as_tensor(d, device="cuda"))
             for c, f, d in zip(cams, frames, depths)]
    trainer = Trainer(cs.perturbed(model, cs.SEED), cfg_t,
                      cams[0].intrinsics, voxel, seed=cs.SEED)
    trainer.run(views, iterations=2, log_every=1)        # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.run(views, iterations=2 + steps, log_every=1)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.run(views, iterations=2 + 2 * steps, log_every=1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = span_table(prof, steps)
    kernels = kernel_table(prof)
    device_ms = sum(k["device_us"] for k in kernels) / 1e3 / steps
    others = sum(spans.get(f"train.{k}", {}).get("device_busy_ms", 0.0)
                 for k in ("prefilter", "forward", "update", "stats"))
    print(json.dumps({
        "steps": steps, "phase": phase,
        "visible_capacity": visible_capacity,
        "step_ms_unprofiled": plain_ms,
        "wall_ms_per_step": wall_ms / steps,
        "device_ms_per_step": device_ms,
        "backward_device_ms_per_step": device_ms - others,
        "device_busy_share": device_ms * steps / wall_ms,
        "kernel_launches_per_step": sum(k["calls"] for k in kernels) / steps,
        "spans": spans, "top_kernels": kernels[:25],
        "history": trainer.history[-2 * steps:], "card": card}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--train", type=int, default=0, metavar="STEPS",
                    help="profile STEPS training steps instead of frames")
    ap.add_argument("--phase", type=int, default=0, choices=(0, 1, 2),
                    help="the training phase of the profiled steps")
    ap.add_argument("--visible_capacity", type=int, default=None,
                    help="with --train: compact the decode to N rows")
    ap.add_argument("--decoded", action="store_true",
                    help="profile the decoded scene's frames")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_render_torch: needs a CUDA card", file=sys.stderr)
        return 1
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    if args.train:
        return profile_train(args.train, repo, args.phase,
                             args.visible_capacity)
    import chip_smoke as cs
    from bloomscene_tpu_torch.config import GSConfig
    from bloomscene_tpu_torch.models.decode import (attribute_means,
                                                    decode_neural_gaussians)
    from bloomscene_tpu_torch.models.render import (_project, compact_visible,
                                                    count_pairs,
                                                    prefilter_anchors, render)
    from bloomscene_tpu_torch.ops.cuda.wrapper import tile_blend
    from bloomscene_tpu_torch.ops.tile_rasterizer import attr_rows
    from bloomscene_tpu_torch.ops.tiles import bin_splats, tile_grid
    from bloomscene_tpu_torch.pipeline.bloomscene import EVAL_VCAP_GRANULE

    card = cs.card_name_and_power()
    print(json.dumps({"card": card}), flush=True)
    cfg = GSConfig(voxel_size=0.03)
    model, _ = cs.trained_scale_model(cs.room_points(cs.N_POINTS, cs.SEED),
                                      cfg, cs.SEED, "cuda")
    mode = "eval"
    if args.decoded:
        from bloomscene_tpu_torch.codec.codec import (decode_scene,
                                                      encode_scene)
        path = os.path.join(repo, "outputs", "profile_render_torch")
        sizes = encode_scene(model, cfg, path)
        model, mode = decode_scene(model, cfg, path, device="cuda"), "decoded"
        print(json.dumps({"codec_total_MB": sizes["total_MB"],
                          "n_anchors": sizes["n_anchors"]}), flush=True)
    cams = cs.orbit_cameras(args.frames, 512, 512, repo)
    intr = cams[0].intrinsics
    arrs = [c.device_arrays("cuda") for c in cams]
    W, H, tile = intr.width, intr.height, cfg.tile_size
    cap = cfg.max_splats_per_tile
    gx, gy = tile_grid(W, H, tile)

    # buffer sizes as render_model measures them
    C = model.state.capacity
    mv = max(int(prefilter_anchors(model, intr, a).sum()) for a in arrs)
    g = EVAL_VCAP_GRANULE
    vcap = min(-(-max(mv, g // 32) // g) * g, C)
    mp = max(int(count_pairs(model, intr, a, cfg, mode=mode,
                             visible=prefilter_anchors(model, intr, a),
                             visible_capacity=vcap)) for a in arrs)
    pcap = max(16384, -(-int(mp * 1.02) // 16384) * 16384)
    print(json.dumps({"mode": mode, "anchors": model.state.num_alive(),
                      "capacity": C, "visible_capacity": vcap,
                      "pair_capacity": pcap}), flush=True)

    def frame(a):
        return render(model, intr, a, cfg, mode=mode,
                      visible=prefilter_anchors(model, intr, a),
                      visible_capacity=vcap, pair_capacity=pcap,
                      packed_capacity=pcap)

    frame(arrs[0])                                   # warm-up
    torch.cuda.synchronize()

    # 1. stage times, host clock, synchronized per stage
    stages: dict[str, list[float]] = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return out

    with torch.no_grad():
        for a in arrs:
            t_frame = time.perf_counter()
            vis = timed("prefilter", lambda: prefilter_anchors(model, intr,
                                                               a))
            sub, means = timed("compact", lambda: (
                compact_visible(model, vis, vcap)[0],
                attribute_means(model.state)))
            dec, _ = timed("decode", lambda: decode_neural_gaussians(
                sub, a.camera_center, cfg, mode=mode, attr_means=means))
            proj = timed("project", lambda: _project(
                dec.xyz, dec.scaling, dec.rotation, intr, a))
            proj = proj._replace(valid=proj.valid & dec.valid)
            opac = torch.where(proj.valid, dec.opacity, 0.0)
            bins = timed("bin", lambda: bin_splats(
                proj, W, H, tile, pcap, cap, opacities=opac,
                packed_capacity=pcap,
                attr_rows=attr_rows(proj, dec.color, opac)))
            timed("blend", lambda: tile_blend(
                proj.mean2d, proj.conic, proj.depth, dec.color, opac,
                torch.zeros(3, device="cuda"), bins, tile, gx, gy, W, H))
            stages.setdefault("frame", []).append(
                (time.perf_counter() - t_frame) * 1e3)
    print(json.dumps({"mode": mode,
                      "stage_ms_mean": {k: sum(v) / len(v)
                                        for k, v in stages.items()},
                      "stage_ms": stages, "card": card}), flush=True)

    # 2. profiler: device time by kernel, launches, busy share
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for a in arrs:
            frame(a)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = kernel_table(prof)
    n_launch = sum(k["calls"] for k in kernels)
    device_ms = sum(k["device_us"] for k in kernels) / 1e3
    print(json.dumps({
        "mode": mode, "frames": len(arrs),
        "wall_ms_per_frame": wall_ms / len(arrs),
        "device_ms_per_frame": device_ms / len(arrs),
        "device_busy_share": device_ms / wall_ms,
        "kernel_launches_per_frame": n_launch / len(arrs),
        "top_kernels": kernels[:25], "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch port's render path on one CUDA card and hold its
kernels against their plain versions.

    python3 chip_smoke.py

Phases, each printing one JSON object on its own line; any failure exits
nonzero:

1. build: compile the CUDA kernels from ``bloomscene_tpu_torch/csrc`` (one
   nvcc per source, in parallel) and load them; the card's name and power
   limit from nvidia-smi.
2. scene: a seeded room-sized point cloud (~2M points on the walls, floor
   and ceiling of a cylinder around the orbit) -> ``init_model`` at
   ``GSConfig(voxel_size=0.03)``, ~110K anchors; features, offsets and head
   weights are given seeded values at a trained scale (no checkpoint ships
   with the repo).
3. render: ``render_model(mode='eval')`` over 8 frames of
   ``cameras/rotate360.json`` at 512x512, with every launch counter set to
   0 just before and read just after; each kernel must have launched once
   per frame.
4. kernels: on one frame's real inputs, K3 (pair expansion) and K4 (slab
   expansion) must equal their plain versions bit for bit, K1 (blend
   forward) within 1e-5 (color, acc, T) and 1e-4 (depth sum), the
   tolerances of tests/test_pallas_blend.py; times by CUDA events.
5. reference: a 128x128 view rasterized on the card and by the plain
   PyTorch path on the CPU from the same projected splats must agree
   within the same tolerances.

The last line is ``{"ok": true, "device": {...}}``. Without CUDA the script
exits 1 before printing anything on stdout.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

N_POINTS = 2_000_000
ROOM_RADIUS = 2.4
ROOM_HALF_HEIGHT = 1.2
N_FRAMES = 8
SEED = 0
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
BLEND_OPS_PER_STEP = 30        # float operations per (pixel, splat) step


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def card_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def room_points(n: int, seed: int) -> np.ndarray:
    """Points on the wall, floor and ceiling of a cylinder room around the
    origin (where the orbit's cameras sit), uniform by area, 5 mm noise."""
    rng = np.random.default_rng(seed)
    r, h = ROOM_RADIUS, ROOM_HALF_HEIGHT
    a_wall, a_disk = 2 * np.pi * r * 2 * h, np.pi * r * r
    n_wall = int(n * a_wall / (a_wall + 2 * a_disk))
    n_floor = (n - n_wall) // 2
    th = rng.uniform(0, 2 * np.pi, n_wall)
    parts = [np.stack([r * np.cos(th), rng.uniform(-h, h, n_wall),
                       r * np.sin(th)], 1)]
    for m, y in ((n_floor, -h), (n - n_wall - n_floor, h)):
        rr = r * np.sqrt(rng.uniform(0, 1, m))
        t = rng.uniform(0, 2 * np.pi, m)
        parts.append(np.stack([rr * np.cos(t), np.full(m, y),
                               rr * np.sin(t)], 1))
    pts = np.concatenate(parts)
    return (pts + rng.normal(0, 0.005, pts.shape)).astype(np.float32)


def trained_scale_model(points: np.ndarray, cfg, seed: int, device: str):
    """init_model, then seeded stand-ins for trained values: anchor features
    ~N(0, 0.5), child offsets ~N(0, 0.7) offset-scales, opacity-head bias
    +0.5 (most children visible), color-head output weights x4 (colors
    spread over [0, 1]), and the anchor bounds of the scene."""
    from bloomscene_tpu_torch.models.anchors import update_anchor_bounds
    from bloomscene_tpu_torch.models.model import init_model
    model, voxel = init_model(seed, points, cfg, device=device)
    st = model.state
    gen = torch.Generator().manual_seed(seed + 1)
    C, K, F = st.capacity, st.n_offsets, st.feat_dim
    feat = (torch.randn((C, F), generator=gen) * 0.5).to(device)
    offset = (torch.randn((C, K, 3), generator=gen) * 0.7).to(device)
    st = st._replace(feat=feat.reshape(-1), offset=offset.reshape(-1))
    with torch.no_grad():
        model.heads.opacity[-1].bias += 0.5
        model.heads.color[-1].weight *= 4.0
    model = model._replace(state=st, bounds=update_anchor_bounds(st))
    return model, voxel


def orbit_cameras(n_frames: int, W: int, H: int, repo: str):
    """n_frames evenly spaced frames of cameras/rotate360.json, with the
    file's own horizontal fov."""
    from bloomscene_tpu_torch.ops.graphics import fov2focal, focal2fov
    from bloomscene_tpu_torch.scene.dataset import _camera_from_nerf_frame
    from bloomscene_tpu_torch.scene.trajectory import load_camera_path_json
    data = load_camera_path_json(os.path.join(repo, "cameras",
                                              "rotate360.json"))
    fovx = data["camera_angle_x"]
    fovy = focal2fov(fov2focal(fovx, W), H)
    frames = data["frames"]
    pick = np.linspace(0, len(frames), n_frames, endpoint=False).astype(int)
    return [_camera_from_nerf_frame(frames[i]["transform_matrix"], fovx,
                                    fovy, W, H, name=f"rotate360_{i:03d}")
            for i in pick]


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the card: one warm-up, then CUDA
    events around ``reps`` calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def kernel_checks(model, cam, cfg, vcap, pcap, launches):
    """K3, K4 and K1 against their plain versions on one frame's inputs."""
    from bloomscene_tpu_torch.models.render import prefilter_anchors, render
    from bloomscene_tpu_torch.ops.cuda.blend import (blend_forward,
                                                     blend_forward_plain)
    from bloomscene_tpu_torch.ops.cuda.expand import (expand_slab,
                                                      expand_slab_plain,
                                                      slab_index)
    from bloomscene_tpu_torch.ops.cuda.pairs import (expand_pairs,
                                                     expand_pairs_plain)
    from bloomscene_tpu_torch.ops.tile_rasterizer import attr_rows
    from bloomscene_tpu_torch.ops.tiles import (pair_kernel_inputs,
                                                sorted_attr_table, tile_grid)
    intr = cam.intrinsics
    W, H, tile, cap = intr.width, intr.height, cfg.tile_size, \
        cfg.max_splats_per_tile
    gx, _ = tile_grid(W, H, tile)
    arrs = cam.device_arrays(model.state.device)
    vis = prefilter_anchors(model, intr, arrs) if vcap else None
    res = render(model, intr, arrs, cfg, mode="eval", visible=vis,
                 visible_capacity=vcap, pair_capacity=pcap,
                 packed_capacity=pcap)
    proj, bins = res.proj, res.bins
    opac = torch.where(proj.valid, res.dec.opacity, 0.0)
    rows = []

    # K3: pair expansion
    args = pair_kernel_inputs(proj, W, H, tile, pcap, opac)
    n = args["x0"].shape[0]
    key_k, gid_k = expand_pairs(**args)
    key_p, gid_p = expand_pairs_plain(**args)
    k3_equal = torch.equal(key_k, key_p) and torch.equal(gid_k, gid_p)
    t_bytes, by = bound(4 * ((n + 1) + 4 * n + 6 * n) + 8 * pcap, 60 * pcap)
    rows.append(dict(
        name="pair_expansion", route="cuda",
        source="bloomscene_tpu_torch/csrc/pairs.cu",
        replaces="bloomscene_tpu/ops/pallas/pairs.py:109",
        launches=launches["pair_expansion"],
        max_abs_err=float(max(max_abs(key_k, key_p), max_abs(gid_k, gid_p))),
        bitwise=k3_equal,
        ms=time_ms(lambda: expand_pairs(**args), 50),
        plain_ms=time_ms(lambda: expand_pairs_plain(**args), 10),
        bound_ms=t_bytes, bound_by=by, library_ms=None,
        shapes={"n": n, "pair_capacity": pcap,
                "packed_key": args["packed_key"]}))

    # K4: slab expansion
    asT = sorted_attr_table(attr_rows(proj, res.dec.color, opac),
                            bins.gauss_sorted, cap)
    t_start_p = bins.t_start[bins.perm.long()].contiguous()
    slab_k = expand_slab(asT, t_start_p, cap)
    slab_p = expand_slab_plain(asT, t_start_p, cap)
    idx = slab_index(t_start_p, asT.shape[1], cap)
    k4_equal = torch.equal(slab_k, slab_p) and torch.equal(slab_k, bins.slab)
    cols = int(torch.unique(idx).numel())
    t_bytes, by = bound(4 * (asT.shape[0] * cols + t_start_p.numel()
                             + slab_k.numel()), 0)
    rows.append(dict(
        name="slab_expansion", route="cuda",
        source="bloomscene_tpu_torch/csrc/expand.cu",
        replaces="bloomscene_tpu/ops/pallas/expand.py:51",
        launches=launches["slab_expansion"],
        max_abs_err=max_abs(slab_k, slab_p), bitwise=k4_equal,
        ms=time_ms(lambda: expand_slab(asT, t_start_p, cap), 50),
        plain_ms=time_ms(lambda: expand_slab_plain(asT, t_start_p, cap), 20),
        bound_ms=t_bytes, bound_by=by,
        library_ms=time_ms(lambda: asT[:, idx], 20),
        shapes={"asT": list(asT.shape), "slab": list(slab_k.shape)}))

    # K1: blend forward
    counts_p = bins.counts[bins.perm.long()].contiguous()
    out_k = blend_forward(bins.slab, counts_p, bins.perm, tile, gx)
    out_p = blend_forward_plain(bins.slab, counts_p, bins.perm, tile, gx)
    names = ("r", "g", "b", "D", "acc", "T")
    errs = {nm: max_abs(a, b) for nm, a, b in zip(names, out_k, out_p)}
    errs["n_contrib"] = max_abs(out_k[6], out_p[6])
    k1_ok = (all(errs[nm] <= 1e-5 for nm in ("r", "g", "b", "acc", "T"))
             and errs["D"] <= 1e-4)
    k1_bitwise = all(torch.equal(a, b) for a, b in zip(out_k, out_p))
    P, T = tile * tile, counts_p.numel()
    steps = float(out_p[6].double().sum())     # >= ncon steps per pixel
    t_bytes, by = bound(4 * (10 * int(counts_p.sum()) + 2 * T + 7 * P * T),
                        BLEND_OPS_PER_STEP * steps)
    rows.append(dict(
        name="blend_forward", route="cuda",
        source="bloomscene_tpu_torch/csrc/blend.cu",
        replaces="bloomscene_tpu/ops/pallas/blend.py:140",
        launches=launches["blend_forward"],
        max_abs_err=max(errs[nm] for nm in names), bitwise=k1_bitwise,
        errors=errs,
        ms=time_ms(lambda: blend_forward(bins.slab, counts_p, bins.perm,
                                         tile, gx), 50),
        plain_ms=time_ms(lambda: blend_forward_plain(
            bins.slab, counts_p, bins.perm, tile, gx), 2),
        bound_ms=t_bytes, bound_by=by, library_ms=None,
        shapes={"slab": list(bins.slab.shape),
                "max_count": int(counts_p.max()),
                "sum_counts": int(counts_p.sum())}))
    ok = {"pair_expansion": k3_equal, "slab_expansion": k4_equal,
          "blend_forward": k1_ok}
    return rows, ok


def reference_check(model, cfg, size: int):
    """One view at ``size`` x ``size``: rasterized on the card and by the
    plain path on the CPU from the same projected splats."""
    from bloomscene_tpu_torch.models.render import render
    from bloomscene_tpu_torch.ops.projection import ProjectedSplats
    from bloomscene_tpu_torch.ops.tile_rasterizer import rasterize_tiles
    cam = orbit_cameras(1, size, size, os.path.dirname(
        os.path.abspath(__file__)))[0]
    intr = cam.intrinsics
    pcap = 1 << 20
    res = render(model, intr, cam.device_arrays(model.state.device), cfg,
                 mode="eval", pair_capacity=pcap)
    cpu = ProjectedSplats(*(t.cpu() for t in res.proj))
    out_c, bins_c = rasterize_tiles(
        cpu, res.dec.color.cpu(), res.dec.opacity.cpu(), torch.zeros(3),
        size, size, tile=cfg.tile_size, pair_capacity=pcap,
        tile_capacity=cfg.max_splats_per_tile)
    errs = {f: max_abs(getattr(res.out, f).cpu(), getattr(out_c, f))
            for f in res.out._fields}
    ok = (errs["color"] <= 1e-5 and errs["alpha"] <= 1e-5
          and errs["final_T"] <= 1e-5 and errs["depth"] <= 1e-4
          and int(res.bins.num_pairs) > 0)
    return dict(size=size, num_pairs=int(res.bins.num_pairs),
                num_pairs_cpu=int(bins_c.num_pairs), max_abs_err=errs), ok


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA card", file=sys.stderr)
        return 1
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    from bloomscene_tpu_torch.config import GSConfig
    from bloomscene_tpu_torch.ops.cuda import build
    from bloomscene_tpu_torch.ops.cuda.blend import blend_forward
    from bloomscene_tpu_torch.ops.cuda.expand import expand_slab
    from bloomscene_tpu_torch.ops.cuda.pairs import expand_pairs
    from bloomscene_tpu_torch.pipeline.bloomscene import render_model
    failed = []

    # 1. build
    card = card_name_and_power()
    t0 = time.perf_counter()
    build.build_all()
    for name in build.KERNELS:
        build.library(name)
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "Used" in ln or "spill" in ln]
             for name, log in build.build_logs.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "card": card, "ptxas": ptxas})

    # 2. scene
    cfg = GSConfig(voxel_size=0.03)
    t0 = time.perf_counter()
    points = room_points(N_POINTS, SEED)
    model, voxel = trained_scale_model(points, cfg, SEED, "cuda")
    torch.cuda.synchronize()
    n_anchors = model.state.num_alive()
    emit({"phase": "scene", "points": int(points.shape[0]),
          "voxel_size": voxel, "anchors": n_anchors,
          "capacity": model.state.capacity,
          "seconds": time.perf_counter() - t0})

    # 3. main path
    cams = orbit_cameras(N_FRAMES, 512, 512, repo)
    counters = {"pair_expansion": expand_pairs,
                "slab_expansion": expand_slab,
                "blend_forward": blend_forward}
    for fn in counters.values():
        fn.launches = 0
    stats: list = []
    frames, depths, fps = render_model(model, cams, cfg, mode="eval",
                                       device="cuda", frame_stats=stats)
    launches = {name: fn.launches for name, fn in counters.items()}
    for i, s in enumerate(stats):
        emit({"phase": "frame", "frame": i, **s})
    finite = all(np.isfinite(f).all() and np.isfinite(d).all()
                 for f, d in zip(frames, depths))
    shapes = all(f.shape == (512, 512, 3) and d.shape == (512, 512)
                 for f, d in zip(frames, depths))
    pairs_ok = all(s["num_pairs"] > 0 for s in stats)
    counts_ok = all(v == len(frames) for v in launches.values())
    emit({"phase": "render", "frames": len(frames), "fps": fps,
          "card": card, "launches": launches, "finite": finite,
          "shapes_ok": shapes, "pairs_ok": pairs_ok,
          "launches_ok": counts_ok,
          "mean_color": float(np.mean([f.mean() for f in frames]))})
    if not (finite and shapes and pairs_ok and counts_ok):
        failed.append("render")

    # 4. kernels against their plain versions
    rows, ok = kernel_checks(model, cams[0], cfg,
                             stats[0]["visible_capacity"],
                             stats[0]["pair_capacity"], launches)
    for row in rows:
        emit({"phase": "kernel", "card": card, **row})
    failed += [name for name, good in ok.items() if not good]

    # 5. small reference
    ref, ref_ok = reference_check(model, cfg, 128)
    emit({"phase": "reference", **ref, "ok": ref_ok})
    if not ref_ok:
        failed.append("reference")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(card, flush=True)
    emit({"kernels": [{k: row[k] for k in keys} for row in rows]})
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

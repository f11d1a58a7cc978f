#!/usr/bin/env python3
"""What holds the kernels back, on one card: the blend kernels K1 (forward)
and K2 (backward) and the binning kernels K3 (pair expansion) and K4 (slab
expansion).

    python3 profile_blend.py

Builds the scene of ``chip_smoke.py``, renders its first orbit frame (the
render shape) and trains the perturbed model two steps (the training
shape, as ``chip_smoke.py`` phase 8), then prints one JSON object per
line:

1. ``build``: each kernel's ptxas report (registers, shared memory,
   spills) and the opcode histogram of its SASS (``cuobjdump -sass`` of
   the built library), for the whole kernel and for each loop (a backward
   branch and the instructions it closes); for K1 and K2 also the block
   shape and the theoretical occupancy from those.
2. ``work`` per kernel and shape, counted from the inputs with torch on the
   card: K1's pixel iterations (slots a pixel visits before it stops), its
   warp iterations (slots any of a warp's 32 or 64 pixels visits), blended
   steps and the steps above the kernels' exp-free skip threshold; K2's
   walked (pixel, slot) steps, the blended ones, the warp slots where no
   pixel of a 32- or 64-pixel warp blends, and the steps above the
   threshold; K3's ranks, live ranks (those owning a slot below the
   total and the capacity), total pairs, slots past the total, the
   binary-search depth over the starts and the ranks a chunk of 1024
   slots touches; K4's slab size, the distinct asT columns it reads and
   the positions whose start is clamped at width - cap.
3. ``time``: CUDA events over 100 launches, with the SM clock and the
   power draw sampled by nvidia-smi during the loop; K3 also with the
   cull off (no atab), which isolates the cost of its float arithmetic,
   and an empty launch (``torch.cuda._sleep(0)``), the floor of a timed
   launch.

    python3 profile_blend.py --against DIR

also builds K1 and K2 from another checkout's sources
(``DIR/bloomscene_tpu_torch/csrc/blend.cu`` and ``blend_bwd.cu``, for
example the parent commit unpacked with ``git archive``) and prints 4.
``ab``: on the same render and training inputs, the other build and this
one timed in turns (other, this, this, other, twice), each turn the mean
of 50 launches behind a device-side wait (``chip_smoke.time_ms``), and
whether the two builds' outputs are bitwise equal.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time

import torch

WARP = 32
REGS_PER_SM = 65536
SMEM_PER_SM = 233472            # 228 KB; a block may use 227 KB of it
THREADS_PER_SM = 2048
BLOCKS_PER_SM = 32
REPS = 100                      # launches timed per kernel and shape
CHUNK_SLOTS = 1024              # pair slots a chunk of K3 takes


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def occupancy(regs: int, threads: int, smem: int) -> dict:
    """Resident blocks and warps per SM from the per-SM limits (registers
    allocated per warp in units of 256)."""
    warps = -(-threads // WARP)
    regs_warp = -(-regs * WARP // 256) * 256
    by = {"registers": REGS_PER_SM // (regs_warp * warps),
          "threads": THREADS_PER_SM // threads,
          "shared_memory": SMEM_PER_SM // (smem + 1024) if smem else
          BLOCKS_PER_SM,
          "blocks": BLOCKS_PER_SM}
    blocks = min(by.values())
    return {"blocks_per_sm": blocks, "warps_per_sm": blocks * warps,
            "occupancy": blocks * warps / (THREADS_PER_SM // WARP),
            "limited_by": min(by, key=by.get)}


def sass_histograms(lib_path: str) -> dict:
    """Per kernel function: the opcode histogram of its SASS and of each
    loop (a backward BRA and the instructions from its target to it)."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    tool = shutil.which("cuobjdump") or os.path.join(home, "bin",
                                                     "cuobjdump")
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=120).stdout
    funcs: dict[str, list] = {}
    cur = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][\w.]*)"
                     r"(.*?);", line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(3).split(".")[0],
                        m.group(4)))
    out = {}
    for name, ins in funcs.items():
        hist: dict[str, int] = {}
        for _, op, _ in ins:
            hist[op] = hist.get(op, 0) + 1
        loops = []
        for addr, op, args in ins:
            t = re.search(r"0x([0-9a-f]+)", args)
            if op == "BRA" and t and int(t.group(1), 16) < addr:
                lo = int(t.group(1), 16)
                body: dict[str, int] = {}
                for a, o, _ in ins:
                    if lo <= a <= addr:
                        body[o] = body.get(o, 0) + 1
                loops.append({"from": lo, "to": addr,
                              "instructions": sum(body.values()),
                              "opcodes": dict(sorted(body.items(),
                                                     key=lambda kv: -kv[1]))})
        out[name] = {"instructions": len(ins),
                     "opcodes": dict(sorted(hist.items(),
                                            key=lambda kv: -kv[1])),
                     "loops": loops}
    return out


@torch.no_grad()
def blend_work(slab, counts_p, tid, tile: int, gx: int, ncon=None) -> dict:
    """K1's (and, given K1's n_contrib, K2's) work on these inputs, counted
    on the plain version's walk (``ops/cuda/blend.py::forward_slots``)."""
    from bloomscene_tpu_torch.ops.cuda.blend import blend_walk, forward_slots
    from bloomscene_tpu_torch.ops.reference_rasterizer import ALPHA_MIN
    P, T = tile * tile, counts_p.numel()
    zero = torch.zeros((), dtype=torch.int64, device=slab.device)
    c = {k: zero.clone() for k in (
        "k1_pixel_iterations", "k1_warp_iterations",
        "k1_warp64_iterations", "k1_block_slots", "k1_blended",
        "k1_pixel_exp", "k1_warp64_exp", "k2_blended",
        "k2_warp32_slots_none_blended", "k2_warp64_slots_none_blended",
        "k2_pixel_exp", "k2_warp64_exp")}
    walk = None if ncon is None else blend_walk(counts_p, ncon)
    n = int(counts_p.max()) if T else 0
    for st in forward_slots(slab, counts_p, tid, tile, gx):
        s, power, alpha, visit, blend = (st.s, st.power, st.alpha, st.visit,
                                         st.blend)
        # the kernels' exp-free skip (skip_below in both sources)
        exp = power >= torch.log(ALPHA_MIN / st.rows[5]) - 1e-3
        c["k1_pixel_iterations"] += visit.sum()
        c["k1_warp_iterations"] += visit.view(P // WARP, WARP, T).any(1).sum()
        c["k1_warp64_iterations"] += visit.view(P // 64, 64, T).any(1).sum()
        c["k1_block_slots"] += visit.any(0).sum()
        c["k1_blended"] += blend.sum()
        c["k1_pixel_exp"] += (visit & exp).sum()
        c["k1_warp64_exp"] += (visit & exp).view(P // 64, 64, T).any(1).sum()
        if walk is not None:
            inwalk = s < walk
            b2 = (power <= 0.0) & (alpha >= ALPHA_MIN) & (s < ncon) & inwalk
            c["k2_blended"] += b2.sum()
            e2 = exp & inwalk
            c["k2_pixel_exp"] += e2.sum()
            c["k2_warp64_exp"] += e2.view(P // 64, 64, T).any(1).sum()
            for w, key in ((WARP, "k2_warp32_slots_none_blended"),
                           (2 * WARP, "k2_warp64_slots_none_blended")):
                none = ~b2.view(P // w, w, T).any(1) & inwalk[None, :]
                c[key] += none.sum()
    out = {k: int(v) for k, v in c.items()}
    out["k1_pixel_steps_to_n_contrib"] = (None if ncon is None
                                          else int(ncon.sum()))
    out["k1_simt_efficiency"] = (out["k1_pixel_iterations"]
                                 / max(1, WARP * out["k1_warp_iterations"]))
    if walk is not None:
        out["k2_walk_sum"] = int(walk.sum())
        out["k2_walk_max"] = int(walk.max())
        out["k2_pixel_slots"] = int(walk.sum()) * P
        out["k2_warp32_slots"] = int(walk.sum()) * (P // WARP)
        out["k2_warp64_slots"] = int(walk.sum()) * (P // (2 * WARP))
    out["counts_sum"] = int(counts_p.sum())
    out["counts_max"] = n
    out["tiles"] = T
    return out


@torch.no_grad()
def pairs_work(args: dict) -> dict:
    """K3's work on these inputs (its keyword arguments)."""
    starts = args["starts_full"]
    n = args["x0"].shape[0]
    pcap = args["pair_capacity"]
    total = int(starts[n])
    live_slots = min(total, pcap)
    live_ranks = int((starts[:n] < live_slots).sum())
    touched = starts[1:] - starts[:n]
    # the rank that owns each chunk's first and last slot (slots past the
    # total belong to the last live rank)
    first = torch.arange(0, pcap, CHUNK_SLOTS, device=starts.device)
    last = torch.clamp(first + CHUNK_SLOTS, max=pcap) - 1
    rank = [torch.clamp(torch.searchsorted(
        starts[:n], torch.clamp(k, max=max(total - 1, 0)).int(),
        right=True) - 1, min=0) for k in (first, last)]
    span = rank[1] - rank[0] + 1
    return {"n": n, "pair_capacity": pcap, "total_pairs": total,
            "live_slots": live_slots,
            "slots_past_total": max(pcap - total, 0),
            "live_ranks": live_ranks,
            "max_touched": int(touched.max()) if n else 0,
            "slots_per_live_rank": live_slots / max(1, live_ranks),
            "search_depth": (n + 1).bit_length(),
            "packed_key": args["packed_key"],
            "cull": args["atab"] is not None,
            "chunks": len(first),
            "live_chunks": int((first < total).sum()),
            "ranks_per_live_chunk_max": int(span[first < total].max())
            if total else 0,
            "ranks_per_live_chunk_mean": float(span[first < total].double()
                                               .mean()) if total else 0.0}


@torch.no_grad()
def slab_work(asT, t_start_p, cap: int) -> dict:
    """K4's work on these inputs."""
    from bloomscene_tpu_torch.ops.cuda.expand import slab_index
    R, width = asT.shape
    T = t_start_p.numel()
    cols = int(torch.unique(slab_index(t_start_p, width, cap)).numel())
    return {"rows": R, "width": width, "positions": T, "cap": cap,
            "slab_bytes": 4 * R * cap * T,
            "distinct_columns": cols,
            "distinct_read_bytes": 4 * R * cols,
            "clamped_positions": int((t_start_p > width - cap).sum())}


def timed_with_clocks(fn) -> dict:
    """CUDA-event ms per call over REPS calls queued behind
    ``chip_smoke.hold_device``, with nvidia-smi sampling the SM clock and
    power draw every 20 ms meanwhile."""
    import chip_smoke as cs
    fn()
    torch.cuda.synchronize()
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "20"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        time.sleep(0.1)
        cs.hold_device(fn, REPS)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            fn()
        end.record()
        torch.cuda.synchronize()
    finally:
        smi.terminate()
        text, _ = smi.communicate(timeout=30)
    samples = [[float(x) for x in ln.split(",")] for ln in text.splitlines()
               if ln.count(",") == 1 and "N/A" not in ln]
    return {"ms": start.elapsed_time(end) / REPS, "reps": REPS,
            "sm_clock_mhz": [s[0] for s in samples],
            "power_w": [s[1] for s in samples]}


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_blend: needs a CUDA card", file=sys.stderr)
        return 1
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    import chip_smoke as cs
    from bloomscene_tpu_torch.config import GSConfig
    from bloomscene_tpu_torch.models.render import prefilter_anchors, render
    from bloomscene_tpu_torch.ops.cuda import build
    from bloomscene_tpu_torch.ops.cuda.blend import (blend_backward,
                                                     blend_forward)
    from bloomscene_tpu_torch.ops.cuda.expand import expand_slab
    from bloomscene_tpu_torch.ops.cuda.pairs import expand_pairs
    from bloomscene_tpu_torch.ops.tiles import tile_grid
    from bloomscene_tpu_torch.pipeline.bloomscene import render_model
    from bloomscene_tpu_torch.train.loop import Trainer

    card = cs.card_name_and_power()
    emit({"card": card})
    build.build_all()
    cfg = GSConfig(voxel_size=0.03)
    model, voxel = cs.trained_scale_model(cs.room_points(cs.N_POINTS,
                                                         cs.SEED),
                                          cfg, cs.SEED, "cuda")
    cams = cs.orbit_cameras(cs.N_FRAMES, 512, 512, repo)
    stats: list = []
    frames, depths, _ = render_model(model, cams, cfg, mode="eval",
                                     frame_stats=stats)
    cfg_t = GSConfig(voxel_size=0.03, use_dpr=True, start_stat=0)
    views = [(c.device_arrays("cuda"), torch.as_tensor(f, device="cuda"),
              torch.as_tensor(d, device="cuda"))
             for c, f, d in zip(cams, frames, depths)]
    # the render shape before training changes the model in place
    intr = cams[0].intrinsics
    arrs = views[0][0]
    res_r = render(model, intr, arrs, cfg, mode="eval",
                   visible=prefilter_anchors(model, intr, arrs),
                   visible_capacity=stats[0]["visible_capacity"],
                   pair_capacity=stats[0]["pair_capacity"],
                   packed_capacity=stats[0]["pair_capacity"])
    trainer = Trainer(cs.perturbed(model, cs.SEED), cfg_t, intr, voxel,
                      seed=cs.SEED)
    trainer.run(views, iterations=2, log_every=1)
    torch.cuda.synchronize()

    tile = cfg.tile_size
    gx, _ = tile_grid(512, 512, tile)
    res_t, counts_t, _, Tf, ncon, u = cs.train_blend_inputs(trainer, cfg_t,
                                                            views)
    bins_r = res_r.bins
    counts_r = bins_r.counts[bins_r.perm.long()].contiguous()
    cap = cfg.max_splats_per_tile
    binning = {"render": cs.binning_inputs(res_r, intr, cfg,
                                           stats[0]["pair_capacity"]),
               "train": cs.binning_inputs(res_t, intr, cfg_t,
                                          res_t.bins.src_lane.numel())}

    # 1. build
    for name in ("blend", "blend_bwd"):
        shape = cs.launch_shape(name, tile)
        emit({"phase": "build", "kernel": name, **shape,
              **occupancy(shape["registers"] or 255, shape["block"][0],
                          shape["static_smem_bytes"]
                          + shape["dynamic_smem_bytes"]),
              "blocks": len(counts_t),
              "sass": sass_histograms(str(build.library_path(name)))})
    for name in ("pairs", "expand"):
        emit({"phase": "build", "kernel": name,
              **cs.ptxas_report(build.build_log(name)),
              "sass": sass_histograms(str(build.library_path(name)))})

    # 2. work
    emit({"phase": "work", "kernel": "blend_forward", "shape": "render",
          **blend_work(bins_r.slab, counts_r, bins_r.perm, tile, gx)})
    emit({"phase": "work", "kernel": "blend_forward+blend_backward",
          "shape": "train",
          **blend_work(res_t.bins.slab, counts_t, res_t.bins.perm, tile, gx,
                       ncon)})
    for shape, (args, asT, t_start_p) in binning.items():
        emit({"phase": "work", "kernel": "pair_expansion", "shape": shape,
              **pairs_work(args)})
        emit({"phase": "work", "kernel": "slab_expansion", "shape": shape,
              **slab_work(asT, t_start_p, cap)})

    # 3. time
    bt = res_t.bins
    emit({"phase": "time", "kernel": "blend_forward", "shape": "render",
          "card": card, **timed_with_clocks(lambda: blend_forward(
              bins_r.slab, counts_r, bins_r.perm, tile, gx))})
    emit({"phase": "time", "kernel": "blend_forward", "shape": "train",
          "card": card, **timed_with_clocks(lambda: blend_forward(
              bt.slab, counts_t, bt.perm, tile, gx))})
    scale = float(512 * 512 * 3)
    k2_args = (bt.slab, counts_t, bt.perm, tile, gx, Tf, ncon,
               *(x * scale for x in u))
    emit({"phase": "time", "kernel": "blend_backward", "shape": "train",
          "card": card, **timed_with_clocks(lambda: blend_backward(*k2_args))})
    for shape, (args, asT, t_start_p) in binning.items():
        emit({"phase": "time", "kernel": "pair_expansion", "shape": shape,
              "card": card,
              **timed_with_clocks(lambda: expand_pairs(**args))})
        emit({"phase": "time", "kernel": "pair_expansion", "shape": shape,
              "cull": False, "card": card, **timed_with_clocks(
                  lambda: expand_pairs(**{**args, "atab": None}))})
        emit({"phase": "time", "kernel": "slab_expansion", "shape": shape,
              "card": card, **timed_with_clocks(
                  lambda: expand_slab(asT, t_start_p, cap))})
    emit({"phase": "time", "kernel": "empty launch", "card": card,
          **timed_with_clocks(lambda: torch.cuda._sleep(0))})

    # 4. the other checkout's K1 and K2 against this one's
    if "--against" in sys.argv:
        other = against_libraries(sys.argv[sys.argv.index("--against") + 1])
        calls = {
            ("blend_forward", "render"): lambda: blend_forward(
                bins_r.slab, counts_r, bins_r.perm, tile, gx),
            ("blend_forward", "train"): lambda: blend_forward(
                bt.slab, counts_t, bt.perm, tile, gx),
            ("blend_backward", "train"): lambda: blend_backward(*k2_args)}
        for (kernel, shape), fn in calls.items():
            lib = "blend" if kernel == "blend_forward" else "blend_bwd"
            ms = {"other": [], "this": []}
            outs = {}
            for arm in ("other", "this", "this", "other") * 2:
                with swapped(lib, other[lib] if arm == "other" else None):
                    outs[arm] = fn()
                    ms[arm].append(cs.time_ms(fn, 50))
            same = all(torch.equal(a, b) for a, b in zip(
                outs["other"] if kernel == "blend_forward"
                else [outs["other"]],
                outs["this"] if kernel == "blend_forward"
                else [outs["this"]]))
            emit({"phase": "ab", "kernel": kernel, "shape": shape,
                  "tile": tile, "card": card, "other_ms": ms["other"],
                  "this_ms": ms["this"], "bitwise_equal": same})
    return 0


def against_libraries(src_dir: str) -> dict:
    """K1's and K2's libraries built from ``src_dir``'s sources (the same
    flags as this checkout's), loaded under other names."""
    import ctypes
    from bloomscene_tpu_torch.ops.cuda import build
    libs = {}
    for name in ("blend", "blend_bwd"):
        src = os.path.join(src_dir, "bloomscene_tpu_torch", "csrc",
                           f"{name}.cu")
        out = build.BUILD_DIR / f"libbs_{name}_against.so"
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                        src], check=True, capture_output=True)
        libs[name] = ctypes.CDLL(str(out))
    return libs


class swapped:
    """Within the block, the wrappers' library ``name`` is ``lib`` (this
    checkout's own when None)."""

    def __init__(self, name: str, lib):
        from bloomscene_tpu_torch.ops.cuda import build
        self.build, self.name, self.lib = build, name, lib

    def __enter__(self):
        self.own = self.build.library(self.name)
        if self.lib is not None:
            self.build._loaded[self.name] = self.lib

    def __exit__(self, *exc):
        self.build._loaded[self.name] = self.own


if __name__ == "__main__":
    sys.exit(main())

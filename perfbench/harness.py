"""One run of one cell: set-up, warm-up, the measured window, the check of
what the window's path produced, and the result line.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration, found by its ``file``, and a traffic mix, found as
``perfbench/traffic/<traffic>.json``; its correctness limits are
``perfbench/limits/<cell>.json`` and each per-layer metric is read by
``perfbench/metrics/<metric>.py``. Nothing here names a cell. Every
traffic is training (a regime of the schedule held through the window),
and every cell reports ``train_steps_per_s`` and ``setup_s``: a traffic of
another kind (an orbit, the codec) needs a runner of its own here.

A training run:

1. set-up: the room's anchors, the weights, the targets (``scene.py``) and
   the trainer at the traffic's start step, all on the card;
2. the first steps through ``Trainer.run(device_loop=True)``: step 1 alone
   (Adam's first moment then holds the gradient), steps 2-3 (an eager
   step, a capture, a replay), then chunks up to the start step + two
   chunks, whose last chunk's ms (CUDA events) fix the window's steps;
3. the window: one ``Trainer.run`` over that many steps (whole chunks),
   timed by the host's clock from before the call to a synchronize after
   it; with ``--trace 1`` the profiler records its last chunks;
4. after the window: the peak memory, the per-layer readers, then the
   program's state is freed and the plain reference (``reference/``)
   takes the same first steps from the same inputs; the comparison
   decides ``correct``.
"""
from __future__ import annotations

import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "bloomscene_tpu")
FIRST_STEPS = 3            # the steps the reference follows
TRACED_CHUNKS = 2          # chunks the profiler records, at the window's end
EXCLUDE_SHARE = 1e-3       # leaves whose reference gradient is below this
                           # share of the median leaf's are not compared


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that this process must not hold,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def find_cell(spec: dict, name: str) -> tuple[dict, dict]:
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    config = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    return cell, config


def cell_files(spec: dict, name: str) -> dict:
    """The files a cell is made of, found by its names."""
    cell, entry = find_cell(spec, name)
    return {"cell": cell, "config": load_json(ROOT / entry["file"]),
            "traffic": load_json(BENCH_DIR / "traffic"
                                 / f"{cell['traffic']}.json"),
            "limits": load_json(BENCH_DIR / "limits" / f"{name}.json"),
            "metrics": [m for m in spec["per_layer"]
                        if name in m.get("workloads", [name])]}


def gs_kwargs(config: dict, traffic: dict) -> dict:
    kw = {**config["gsconfig"], **traffic.get("gsconfig", {})}
    return {k: tuple(v) if isinstance(v, list) else v for k, v in kw.items()}


def card_power() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout else None


# --- the inputs -------------------------------------------------------------

def make_inputs(config: dict, traffic: dict, seed: int, device) -> dict:
    """The scene, the weights and the views from the seed (``scene.py``),
    with the cameras as float32 arrays. The capacity is the program's for
    the anchor count (``capacity_bucket`` of 1.25 times it, as
    ``init_from_points`` sizes it)."""
    import torch

    from bloomscene_tpu_torch.models.anchors import capacity_bucket

    from . import scene
    cam = config["camera"]
    W, H = cam["width"], cam["height"]
    cams = scene.load_cameras(str(ROOT / traffic["cameras"]), W, H)
    anchors = scene.room_anchors(config["scene"],
                                 config["gsconfig"]["voxel_size"], device)
    capacity = capacity_bucket(int(anchors.shape[0] * 1.25))
    weights = scene.make_weights(config, anchors, capacity, seed, device)
    images, depths = scene.make_targets(cams, config["scene"], W, H, device)
    return {"cams": cams, "weights": weights, "images": images,
            "depths": depths, "n_anchors": int(anchors.shape[0]),
            "bg": torch.zeros(3, device=device)}


def views_for(camera_arrays, inputs: dict, device) -> list:
    """(CameraArrays, image, depth) a view, ``camera_arrays`` the class
    the side that takes them defines."""
    import torch
    c = inputs["cams"]
    return [(camera_arrays(torch.as_tensor(c["viewmat"][i], device=device),
                           torch.as_tensor(c["full_proj"][i], device=device),
                           torch.as_tensor(c["center"][i], device=device)),
             inputs["images"][i], inputs["depths"][i])
            for i in range(len(c["viewmat"]))]


def camera_draws(seed: int, n_views: int, n: int) -> list:
    """The trainer's camera stream: numpy's generator on the first child
    of the seed's SeedSequence, one ``integers(n_views)`` a step."""
    import numpy as np
    rng = np.random.default_rng(np.random.SeedSequence(seed).spawn(1)[0])
    return [int(rng.integers(n_views)) for _ in range(n)]


# --- the program ------------------------------------------------------------

def build_trainer(config: dict, traffic: dict, inputs: dict, seed: int,
                  device):
    """The port's trainer on the inputs' weights at the traffic's start
    step (its step and its optimizer's count)."""
    import torch

    from bloomscene_tpu_torch.config import GSConfig
    from bloomscene_tpu_torch.models.anchors import AnchorBounds, AnchorState
    from bloomscene_tpu_torch.models.heads import Heads
    from bloomscene_tpu_torch.models.model import Model, mix_spec
    from bloomscene_tpu_torch.scene.cameras import Intrinsics
    from bloomscene_tpu_torch.train.loop import Trainer
    cfg = GSConfig(**gs_kwargs(config, traffic))
    w = inputs["weights"]
    state = AnchorState(**{f: w[f"state.{f}"].clone()
                           for f in AnchorState._fields})
    heads = Heads(cfg.feat_dim, cfg.n_offsets, mix_spec(cfg).output_dim,
                  torch.Generator(), torch.device(device), cfg.use_feat_bank,
                  cfg.color_mode, cfg.sh_degree)
    heads.load_state_dict({k[len("heads."):]: v for k, v in w.items()
                           if k.startswith("heads.")})
    grid = {k[len("grid."):]: v.clone() for k, v in w.items()
            if k.startswith("grid.")}
    model = Model(state=state, heads=heads, grid=grid,
                  bounds=AnchorBounds.initial(torch.device(device)))
    c = inputs["cams"]
    intr = Intrinsics(config["camera"]["width"], config["camera"]["height"],
                      c["fovx"], c["fovy"])
    trainer = Trainer(model, cfg, intr, cfg.voxel_size,
                      spatial_lr_scale=config["spatial_lr_scale"], seed=seed,
                      device=device)
    trainer.step = traffic["start_step"]
    trainer.optimizer.count = traffic["start_step"]
    return trainer


def host(t):
    return t.detach().to("cpu", copy=True)


def first_steps(trainer, views: list, start: int, chunk: int,
                b1: float) -> dict:
    """Steps start + 1 .. start + FIRST_STEPS through the window's call:
    each step's loss and visible anchors, the first gradient of each
    trained leaf (Adam's first moment after one step over 1 - b1), each
    leaf after the last of them and the statistics after the first and
    after the last."""
    run = dict(log_every=1, device_loop=True, max_chunk=chunk)
    trainer.run(views, iterations=start + 1, **run)
    names = [n for n, _, _ in trainer.optimizer.params]
    grad = {n: host(m) / (1 - b1) for n, m in zip(names,
                                                   trainer.optimizer.m)}
    stats1 = {k: host(v) for k, v in trainer.stats._asdict().items()}
    trainer.run(views, iterations=start + FIRST_STEPS, **run)
    recs = trainer.history[-FIRST_STEPS:]
    return {"loss": [r["loss"] for r in recs],
            "visible": [int(r["n_visible_anchors"]) for r in recs],
            "skipped": [bool(r["skipped"]) for r in recs],
            "grad": grad,
            "params": {n: host(t) for n, _, t in trainer.optimizer.params},
            "stats1": stats1,
            "stats": {k: host(v) for k, v in trainer.stats._asdict().items()}}


OVERFLOWS = ("tile_overflow", "pair_overflow", "packed_overflow")


def replay_deltas(graph_log: list, before: list) -> list:
    """The window's replays of each graph: its ``graph_log`` record less
    what it held before the window (a graph captured in the window counts
    from nothing)."""
    out = []
    for i, g in enumerate(graph_log):
        n0, ms0 = before[i] if i < len(before) else (0, 0.0)
        if g["replays"] > n0:
            out.append(dict(g, replays=g["replays"] - n0,
                            replay_ms=g["replay_ms"] - ms0))
    return out


def failed_steps(records: list) -> int:
    """Steps whose loss is not finite, whose update was skipped, or that
    overflowed a tile, pair or packed buffer."""
    return sum(1 for r in records
               if not math.isfinite(r["loss"]) or r["skipped"] > 0
               or any(r[k] > 0 for k in OVERFLOWS))


# --- the comparison ---------------------------------------------------------

def norm(t) -> float:
    return float(t.double().norm())


def leaf_gaps(prog: dict, ref: dict, keep: list) -> dict:
    """Each leaf's gap between the two sides' norms, over the larger of
    the reference's norm of that leaf and of the median leaf."""
    norms = {n: norm(ref[n]) for n in keep}
    med = statistics.median(norms.values())
    return {n: abs(norm(prog[n]) - norms[n]) / max(norms[n], med, 1e-30)
            for n in keep}


def worst(gaps: dict) -> tuple[float, str]:
    name = max(gaps, key=gaps.get)
    return gaps[name], name


def compare(prog: dict, ref: dict, weights: dict, track_stats: bool
            ) -> dict:
    """The numbers ``correct`` is decided by (see PERF.md): the worst
    step's loss gap, the worst leaf's gap of first-gradient norms, the
    worst and the median leaf's gap of parameter-change norms after the
    first steps, and with the statistics
    the worst statistic's gap of norms after the first step
    (``stats1_norm_gap``) and after the last (``stats_norm_gap``)."""
    ref_g = {n: norm(g) for n, g in ref["grad"].items()}
    med = statistics.median(ref_g.values())
    keep = [n for n, g in ref_g.items() if g >= EXCLUDE_SHARE * med]
    out = {"loss_gap": max(abs(p - r) / max(abs(r), 1e-30)
                           for p, r in zip(prog["loss"], ref["loss"]))}
    out["grad_norm_gap"], out["grad_norm_gap_leaf"] = worst(leaf_gaps(
        {n: prog["grad"][n].cpu() for n in keep},
        {n: ref["grad"][n].cpu() for n in keep}, keep))
    change = leaf_gaps(
        {n: prog["params"][n].cpu() - weights[n] for n in keep},
        {n: ref["params"][n].cpu() - weights[n] for n in keep}, keep)
    out["change_norm_gap"], out["change_norm_gap_leaf"] = worst(change)
    out["change_median_gap"] = statistics.median(change.values())
    if track_stats:
        for key in ("stats1", "stats"):
            out[f"{key}_norm_gap"] = max(
                abs(norm(prog[key][k]) - norm(v)) / max(norm(v), 1e-30)
                for k, v in ref[key].items())
    out["excluded_leaves"] = sorted(set(ref_g) - set(keep))
    out["visible_equal"] = prog["visible"] == ref["visible"]
    out["skipped"] = {"program": prog["skipped"],
                      "reference": ref["skipped"]}
    return out


def run_reference(config: dict, traffic: dict, inputs: dict, draws: list,
                  seed: int, device, tf32: bool) -> dict:
    """The plain reference's first steps on the inputs: float32 with TF32
    off, or with TF32 on (the precision control)."""
    import torch

    from .reference.cameras import CameraArrays, Intrinsics
    from .reference.config import GSConfig
    from .reference.step import follow
    cfg = GSConfig(**gs_kwargs(config, traffic))
    c = inputs["cams"]
    intr = Intrinsics(config["camera"]["width"], config["camera"]["height"],
                      c["fovx"], c["fovy"])
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        return follow(inputs["weights"], cfg, intr, inputs["bg"],
                      views_for(CameraArrays, inputs, device), draws, seed,
                      traffic["phase"], traffic["track_stats"],
                      traffic["start_step"], config["spatial_lr_scale"],
                      device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def checks(numbers: dict, limits: dict) -> dict:
    """Each compared number beside its limit."""
    return {k: {"value": numbers[k], "limit": limits[k]} for k in limits
            if k in numbers}


# --- a run ------------------------------------------------------------------

def run_cell(files: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float, log=None) -> dict:
    """One run of the cell described by ``files`` (``cell_files``) on
    ``device`` -> the result line's object. ``log`` (a callable taking a
    str) receives progress notes."""
    import torch

    from . import counts, readers, tracing
    from .reference.optim import B1
    log = log or (lambda s: None)
    config, traffic = files["config"], files["traffic"]
    start, chunk = traffic["start_step"], config["gsconfig"][
        "device_loop_chunk"]
    cuda = torch.device(device).type == "cuda"

    inputs = make_inputs(config, traffic, seed, device)
    weights_host = {k: host(v) for k, v in inputs["weights"].items()}
    trainer = build_trainer(config, traffic, inputs, seed, device)
    from bloomscene_tpu_torch.scene.cameras import CameraArrays
    views = views_for(CameraArrays, inputs, device)
    log(f"set-up: {inputs['n_anchors']} anchors, "
        f"{time.perf_counter() - t_start:.1f} s")

    prog = first_steps(trainer, views, start, chunk, B1)
    warm_end = start + 2 * chunk
    trainer.run(views, iterations=warm_end, log_every=1, device_loop=True,
                max_chunk=chunk)
    last = trainer.chunk_log[-1]
    step_ms = last["ms"] / (last["last"] - last["first"] + 1)
    n_chunks = max(TRACED_CHUNKS + 2 if trace else 1,
                   round(seconds * 1e3 / step_ms / chunk))
    n_steps = n_chunks * chunk
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    log(f"warm-up: {step_ms:.2f} ms a step; window {n_steps} steps")

    before = [(g["replays"], g["replay_ms"]) for g in trainer.graph_log]
    n_chunk_log, n_hist = len(trainer.chunk_log), len(trainer.history)
    tracer = tracing.ChunkTracer(trainer, n_chunks, TRACED_CHUNKS) \
        if trace else None
    t0 = time.perf_counter()
    trainer.run(views, iterations=warm_end + n_steps, log_every=1,
                device_loop=True, max_chunk=chunk,
                callback=tracer.callback if tracer else None)
    if cuda:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    records = trainer.history[n_hist:]
    chunks = trainer.chunk_log[n_chunk_log:]
    graphs = replay_deltas(trainer.graph_log, before)
    regime = {(c["phase"], c["track_stats"]) for c in chunks}
    if regime != {(traffic["phase"], traffic["track_stats"])}:
        raise RuntimeError(f"the window ran {sorted(regime)}, the traffic "
                           f"states phase {traffic['phase']}, statistics "
                           f"{traffic['track_stats']}")
    peak = 0
    if cuda:
        peak = max([torch.cuda.max_memory_allocated()]
                   + [c["peak_mem_bytes"] for c in trainer.chunk_log
                      if c["peak_mem_bytes"] is not None])
    result = {"correct": False, "attempted": len(records),
              "failed": failed_steps(records),
              "window": {"captures": sum(c["captures"] for c in chunks),
                         "eager_steps": sum(c["eager_steps"]
                                            for c in chunks),
                         "overflow_steps": {k: sum(1 for r in records
                                                   if r[k] > 0) for k in
                                            OVERFLOWS},
                         "mean_visible_anchors": statistics.fmean(
                             r["n_visible_anchors"] for r in records),
                         "mean_pairs": statistics.fmean(
                             r["num_pairs"] for r in records),
                         "replay_ms": (sum(g["replay_ms"] for g in graphs)
                                       / max(1, sum(g["replays"]
                                                    for g in graphs)))}}
    # the profiler's own work at its step ends (collecting and parsing the
    # trace) runs inside the window's call: the readers take it out
    ctx = {"window_s": window_s - (tracer.step_s if tracer else 0.0),
           "records": records, "chunks": chunks,
           "all_chunks": list(trainer.chunk_log),
           "graphs": graphs, "config": config, "traffic": traffic,
           "peaks": load_json(BENCH_DIR / "peaks.json")}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": (torch.cuda.get_device_name() if cuda
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": int(peak),
                   "power": card_power() if cuda else None}
    log(f"window: {window_s:.2f} s")
    if tracer is not None:
        summary = tracer.summary(load_json(BENCH_DIR / "kernels.json"))
        log("trace reduced")
        ctx["trace"] = summary
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
        result["breakdown"] = summary["breakdown"]
        final = {n: host(t) for n, _, t in trainer.optimizer.params}
    draws = camera_draws(seed, len(views), warm_end - start + n_steps)
    del trainer, views, tracer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    if trace:
        traced = [r for r in records if r["iteration"] >= ctx["trace"]
                  ["first_step"]]
        ctx["work"] = counts.window_work(
            config, traffic, inputs, final, weights_host,
            [draws[r["iteration"] - start - 1] for r in traced], device)
        ctx["traced_records"] = traced
        log("work counted")
        del final
        result["metrics"] = readers.read_all(files["metrics"], ctx)
    else:
        result["metrics"] = {
            "train_steps_per_s": {"value": n_steps / window_s,
                                  "unit": "steps/s"},
            "setup_s": {"value": setup_s, "unit": "s"}}
    log("reference")

    ref = run_reference(config, traffic, inputs, draws[:FIRST_STEPS], seed,
                        device, tf32=False)
    numbers = compare(prog, ref, weights_host, traffic["track_stats"])
    result["correct"] = all(numbers[k] <= v
                            for k, v in files["limits"].items())
    result["device"] = device_info
    result["comparison"] = numbers
    result["checks"] = checks(numbers, files["limits"])
    log("compared")
    return result


def main(argv: list, t_start: float) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_json(ROOT / "BENCHMARK.json")
    files = cell_files(spec, args.workload)
    cache = BENCH_DIR / ".cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"

    try:
        import bloomscene_tpu_torch  # noqa: F401
    except ImportError as err:
        print(f"the program under test is missing: {err}", file=sys.stderr)
        return 5
    import torch
    need = files["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        found = (torch.cuda.device_count() if torch.cuda.is_available()
                 else 0)
        print(f"this cell needs {need} CUDA device(s); found {found}",
              file=sys.stderr)
        return 3
    torch.cuda.set_device(0)
    torch.set_num_threads(1)     # one host thread: the load of one process
    seed = args.seed % (2 ** 63)

    def log(s):
        print(f"[{time.perf_counter() - t_start:7.1f} s] {s}",
              file=sys.stderr, flush=True)

    result = run_cell(files, seed, args.seconds, bool(args.trace), "cuda",
                      t_start, log)
    found = forbidden_modules()
    if found:
        print(f"modules that must not load: {found}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']:.6g} limit {c['limit']:.6g}",
              file=sys.stderr)
    checks_last = result.pop("checks")
    result["checks"] = checks_last
    print(json.dumps(result), flush=True)
    return 0

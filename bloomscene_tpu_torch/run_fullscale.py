"""The whole pipeline at the reference's scale, on the card, with a record.

    python -m bloomscene_tpu_torch.run_fullscale [--iterations 2990]
        [--out FILE] [--save_dir DIR] [--resolution 512] [--voxel_size V]
        [--visible_capacity 131072] [--render_frames 60] [--device cuda]
        [--seed 1]

The port's counterpart of the repository's top-level ``run_fullscale.py``
(the JAX package's full-scale run), with its arguments, its ``GSConfig``
(the device loop in chunks of 50, the DPR losses at 0.7 / 0.1 / 1.0) and
its ``BloomScene`` calls in its order: stub priors on
``examples/01_childroom.png`` (read and resized by ``utils/image.py``),
``generate(diff_steps=1)``, ``training(resume=True, checkpoint_every=500)``
(a cut run started again with the same ``--save_dir`` resumes from its
``train_ckpt.npz``; a second ``generate`` reads ``traindata.npz``),
``compress``, a re-encode of the decoded scene compared byte for byte
with every ``.b`` stream, ``save_outputs``, the decoded orbit over
``--render_frames`` frames of rotate360, and ``render_eval``.

The record (JSON at ``--out``) has every key of the JAX script's record,
so the two compare field by field, and the port's own:

- ``step_ms_by_phase``: for training phases 0, 1 and 2 the chunks' ms over
  their steps (CUDA events around each chunk, its eager first step,
  capture and surgery included) and the ms a replayed step (CUDA events
  around the replays, ``Trainer.graph_log``);
- ``graphs``: the captures and their seconds;
- ``chunks``: each chunk of the device loop (``Trainer.chunk_log``) with
  its peak allocated memory, and ``memory_growth``: whether that peak grew
  from chunk to chunk within a phase;
- ``launches``: each kernel's launches over the run, a captured launch
  counted once a replay;
- ``stages``: ``BloomScene.spans`` (each stage's wall seconds);
- ``quality``: the means of the last five logged steps' PSNR and loss,
  the overflow counters over every logged step, and the training views'
  frames that dropped a splat.

``device`` is nvidia-smi's name and power limit of the card. ``--device
cuda`` (the default) raises where CUDA is absent: the CPU runs only when
asked for (``--device cpu``), as the tests do. ``run(args, cfg)`` takes a
``GSConfig`` of the caller's (a cut schedule for a short run); ``main``
builds the script's own.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from .codec.codec import encode_scene
from .config import CameraConfig, GSConfig
from .device import resolve_device
from .ops.cuda import launch_counts, loop_launches, reset_launch_counts
from .pipeline.bloomscene import BloomScene, render_model
from .pipeline.run import _read_rgb
from .priors import StubDepthPrior, StubInpaintPrior
from .utils.metrics import psnr

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT = "a child room with toys"
LOG_KEYS = ('iteration', 'loss', 'psnr', 'bit_per_param',
            'n_visible_anchors', 'densify_n_alive', 'tile_overflow',
            'pair_overflow')
OVERFLOW_KEYS = ('tile_overflow', 'pair_overflow', 'packed_overflow')
# a chunk's peak allocated memory may exceed the first of its kind in its
# phase by this share before it counts as growth
MEMORY_GROWTH_SHARE = 0.02


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--iterations', type=int, default=2990)
    ap.add_argument('--out', type=str,
                    default=os.path.join('outputs', 'run_fullscale.json'))
    ap.add_argument('--save_dir', type=str,
                    default=os.path.join('outputs', 'fullscale_run'))
    ap.add_argument('--resolution', type=int, default=512)
    ap.add_argument('--voxel_size', type=float, default=0.002)
    ap.add_argument('--visible_capacity', type=int, default=131072)
    ap.add_argument('--render_frames', type=int, default=60)
    ap.add_argument('--device', type=str, default='cuda',
                    help="'cuda' (the card; raises without one) or 'cpu'")
    ap.add_argument('--seed', type=int, default=1)
    return ap


def config(args: argparse.Namespace) -> GSConfig:
    """The JAX script's ``GSConfig``."""
    return GSConfig(voxel_size=args.voxel_size,
                    visible_capacity=args.visible_capacity,
                    device_loop=True, device_loop_chunk=50,
                    use_dpr=True, lambda_dep_value=0.7,
                    lambda_dep_domin=0.1, lambda_dep_smooth=1.0)


def card_name_and_power(dev: torch.device) -> str:
    """nvidia-smi's name and power limit of the card, or the device."""
    if dev.type != 'cuda':
        return str(dev)
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
        return out[dev.index or 0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(dev)


def step_ms_by_phase(chunk_log: list, graph_log: list) -> dict:
    """For training phases 0-2: the steps and chunks, the chunks' ms over
    their steps (``wall_ms``; the eager step, the capture and the surgery
    included), the replays and the ms a replayed step (``replay_ms``)."""
    out = {}
    for p in (0, 1, 2):
        mine = [c for c in chunk_log if c['phase'] == p]
        steps = sum(c['last'] - c['first'] + 1 for c in mine)
        graphs = [g for g in graph_log if g['phase'] == p]
        replays = sum(g['replays'] for g in graphs)
        out[p] = {'steps': steps, 'chunks': len(mine),
                  'wall_ms': (sum(c['ms'] for c in mine) / steps
                              if steps else None),
                  'replays': replays,
                  'replay_ms': (sum(g['replay_ms'] for g in graphs) / replays
                                if replays else None)}
    return out


def memory_growth(chunk_log: list) -> dict:
    """Peak allocated memory by phase, over chunks of one kind (whether
    the chunk ran an eager step, and with it a capture where it had more
    steps; whether a surgery ended it) at one capacity: each kind's first, largest and last peak, and ``grows``
    where a later chunk's peak passed the first's by more than
    MEMORY_GROWTH_SHARE. Chunks without a peak (the CPU) are left out."""
    kinds: dict = {}
    for c in chunk_log:
        if c['peak_mem_bytes'] is None:
            continue
        key = (c['phase'], c['eager_steps'] > 0, c['surgery'],
               c['capacity'])
        kinds.setdefault(key, []).append(c['peak_mem_bytes'])
    out = {}
    for (p, eager, surg, capacity), peaks in sorted(kinds.items()):
        name = (f"phase{p}_{'eager' if eager else 'replay'}"
                f"{'_surgery' if surg else ''}_{capacity}")
        out[name] = {'chunks': len(peaks), 'first_bytes': peaks[0],
                     'max_bytes': max(peaks), 'last_bytes': peaks[-1],
                     'grows': max(peaks) > peaks[0] * (
                         1 + MEMORY_GROWTH_SHARE)}
    return out


def _rounded(r: dict) -> dict:
    return {k: (round(float(v), 5) if isinstance(v, (int, float)) else v)
            for k, v in r.items() if k in LOG_KEYS}


def _reencode(bs: BloomScene) -> dict:
    """Encode the decoded scene again and compare every ``.b`` stream with
    the first encoding's, byte for byte."""
    path1 = os.path.join(bs.save_dir, 'bitstreams')
    path2 = os.path.join(bs.save_dir, 'bitstreams_reenc')
    t0 = time.time()
    encode_scene(bs.decoded_model, bs.cfg, path2)
    mismatch = []
    for fn in sorted(os.listdir(path1)):
        if not fn.endswith('.b'):
            continue
        with open(os.path.join(path1, fn), 'rb') as f1, \
                open(os.path.join(path2, fn), 'rb') as f2:
            if f1.read() != f2.read():
                mismatch.append(fn)
    out = {'reencode_bit_exact': not mismatch,
           'reencode_check_s': round(time.time() - t0, 1)}
    if mismatch:
        out['reencode_mismatch_files'] = mismatch[:10]
    return out


def run(args: argparse.Namespace, cfg: GSConfig, log_every: int = 100):
    """The full-scale run -> (the record, the ``BloomScene``); the record
    is also written to ``args.out``. A training record is kept every
    ``log_every`` steps (the JAX script's 100; a short run's check may ask
    for every step) and at the last."""
    dev = resolve_device(args.device)
    res = args.resolution
    cam = CameraConfig(H=res, W=res, focal=(582.69 * res / 512,) * 2)
    rgb = _read_rgb(os.path.join(_REPO_ROOT, 'examples', '01_childroom.png'),
                    res)
    os.makedirs(args.save_dir, exist_ok=True)
    bs = BloomScene(args.save_dir, cfg=cfg, cam=cam,
                    inpaint_prior=StubInpaintPrior(),
                    depth_prior=StubDepthPrior(), seed=args.seed, device=dev)
    rec = {"artifact": "full-scale end-to-end run of the PyTorch port",
           "device": card_name_and_power(dev),
           "resolution": res, "iterations": args.iterations,
           "voxel_size": cfg.voxel_size,
           "visible_capacity": cfg.visible_capacity,
           "priors": "stub (no SD/ZoeDepth weights)",
           "dpr": cfg.use_dpr, "device_loop": cfg.device_loop,
           "device_loop_chunk": cfg.device_loop_chunk, "seed": args.seed,
           "torch": torch.__version__, "cuda": torch.version.cuda}
    reset_launch_counts()

    t0 = time.time()
    bs.generate(rgb, PROMPT, diff_steps=1, verbose=False)
    rec["generate_s"] = round(time.time() - t0, 1)
    rec["n_train_views"] = len(bs.scene.train_cameras)
    rec["pcd_points"] = int(bs.traindata['pcd_points'].shape[1])

    peak = {"n": 0}
    logs = []

    def cb(r):
        peak["n"] = max(peak["n"], int(r.get('densify_n_alive', 0) or 0))
        logs.append(_rounded(r))
        densify = {k: r[k] for k in r if k.startswith('densify_')}
        print({**logs[-1], **densify}, flush=True)

    t0 = time.time()
    bs.training(iterations=args.iterations, log_every=log_every, callback=cb,
                resume=True, checkpoint_every=500)
    t_train = time.time() - t0
    tr = bs.trainer
    first = tr.chunk_log[0]['first'] if tr.chunk_log else args.iterations
    rec["resumed_from_step"] = first - 1
    rec["train_s"] = round(t_train, 1)
    rec["ms_per_step_incl_compile"] = round(
        t_train / max(args.iterations - first + 1, 1) * 1e3, 2)
    hist = tr.history
    rec["final_loss"] = round(float(hist[-1]['loss']), 5)
    rec["final_psnr"] = round(float(hist[-1]['psnr']), 3)
    rec["final_bit_per_param"] = round(
        float(hist[-1].get('bit_per_param', 0.0) or 0.0), 5)
    st = bs.model.state
    rec["peak_anchors"] = max(peak["n"], st.num_alive())
    rec["final_anchors"] = st.num_alive()
    rec["anchor_capacity_bucket"] = st.capacity

    t0 = time.time()
    sizes = bs.compress()
    rec["encode_decode_s"] = round(time.time() - t0, 1)
    rec["codec_sizes_MB"] = {k: round(float(v), 4)
                             for k, v in sizes.items()
                             if isinstance(v, (int, float)) and '_MB' in k}
    rec["codec_total_MB"] = round(float(sizes.get('total_MB', 0.0)), 3)
    rec["codec_split"] = {
        "encode_context_s": sizes.get('context_s'),
        "encode_quantize_s": sizes.get('quantize_s'),
        "encode_rans_s": sizes.get('rans_s'),
        "decode_split": sizes.get('decode_split'),
    }
    encode_s, decode_s = sizes['encode_time_s'], sizes['decode_time_s']
    rec["codec_postfix"] = {
        "note": ("compress's stages from this run: the estimate is the "
                 "compress span less encode and decode"),
        "estimate_s": round(rec["encode_decode_s"] - encode_s - decode_s, 1),
        "encode_s": round(encode_s, 1), "decode_s": round(decode_s, 1),
        "total_s": rec["encode_decode_s"],
        "decode_split": sizes.get('decode_split'),
        "encode_split": {k: sizes.get(k) for k in
                         ('context_s', 'quantize_s', 'rans_s')},
        "total_MB": rec["codec_total_MB"]}
    rec.update(_reencode(bs))

    bs.save_outputs()
    pk = 'rotate360'
    n_frames = len(bs.scene.preset_cameras[pk])
    stride = max(1, n_frames // args.render_frames)
    bs.scene = bs.scene._replace(preset_cameras={
        pk: bs.scene.preset_cameras[pk][::stride]})
    vid = bs.render_video(pk, use_decoded=True)
    rec["video"] = {k: v for k, v in vid.items()
                    if isinstance(v, (int, float, str))}
    ev = bs.render_eval(PROMPT)
    rec["eval_fps"] = round(float(ev.get('eval_fps', 0.0)), 2)
    rec["proxy_iqa"] = {k: round(float(v), 4) for k, v in ev.items()
                        if k.startswith('proxy_')}
    rec["log_tail"] = logs[-5:]

    # the trained scene on its own training views (consistency_ab.py's
    # phase A for the JAX runs)
    frame_stats: list = []
    with torch.no_grad():
        frames, _, _ = render_model(bs.model, bs.scene.train_cameras, cfg,
                                    mode='eval', device=dev,
                                    frame_stats=frame_stats)
    ps = [psnr(f, c.image) for f, c in zip(frames, bs.scene.train_cameras)]
    rec["trainview_psnr_50view_mean"] = {
        "mean_psnr": round(float(np.mean(ps)), 3),
        "median_psnr": round(float(np.median(ps)), 3),
        "min_psnr": round(float(np.min(ps)), 3),
        "max_psnr": round(float(np.max(ps)), 3),
        "n_views": len(ps), "per_view": [round(float(p), 3) for p in ps],
        "note": "eval-mode renders of the trained scene at its training "
                "views, PSNR against their images"}

    # the port's own
    rec["quality"] = {
        "psnr_last5_mean": float(np.mean([r['psnr'] for r in logs[-5:]])),
        "loss_last5_mean": float(np.mean([r['loss'] for r in logs[-5:]])),
        "overflow_max": {k: max((float(r[k]) for r in hist), default=0.0)
                         for k in OVERFLOW_KEYS},
        "logged_steps_with_overflow": sum(
            any(r[k] > 0 for k in OVERFLOW_KEYS) for r in hist),
        "trainview_frames_with_overflow": sum(
            any(f[k] > 0 for k in OVERFLOW_KEYS) for f in frame_stats)}
    rec["step_ms_by_phase"] = step_ms_by_phase(tr.chunk_log, tr.graph_log)
    rec["graphs"] = {
        "captures": len(tr.graph_log),
        "capture_s": [round(g['capture_s'], 4) for g in tr.graph_log],
        "capture_s_total": sum(g['capture_s'] for g in tr.graph_log),
        "log": [{k: g[k] for k in ('phase', 'track_stats', 'step',
                                   'capture_s', 'replays', 'replay_ms')}
                for g in tr.graph_log]}
    rec["eager_steps"] = sum(c['eager_steps'] for c in tr.chunk_log)
    rec["chunks"] = tr.chunk_log
    rec["memory_growth"] = memory_growth(tr.chunk_log)
    rec["launches"] = loop_launches(launch_counts(), tr.graph_log)
    rec["stages"] = bs.spans.summary()
    rec["densify"] = [{k: r[k] for k in r if k.startswith('densify_')
                       or k == 'iteration'}
                      for r in hist if 'densify_n_alive' in r]
    rec["logs"] = logs

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(rec, f, indent=2)
    print(json.dumps({k: v for k, v in rec.items()
                      if k not in ('log_tail', 'chunks', 'logs', 'graphs')}),
          flush=True)
    return rec, bs


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    rec, _ = run(args, config(args))
    return rec


if __name__ == '__main__':
    main()

"""CLI entry: python -m bloomscene_tpu_torch.pipeline.run --image ... --text ...

The port of ``bloomscene_tpu/pipeline/run.py``, with its flags and
defaults: the reference run.py's groups (run.py:26-57: input, camera
paths, inpainting, save dir, DPR regularizers, SCC compression), the prior
backends (stub by default; the real diffusion and depth models need local
weights) and the shrink-run options, plus ``--device`` (default "cuda";
"cpu" runs the plain PyTorch path) and ``--log_every`` (the training
record's interval, 100 as the JAX CLI's fixed one). The input PNG is read and resized
without PIL (``utils/image.py``). ``--load_dir`` takes the model's widths
from the saved run's ``settings.json`` (the JAX CLI takes the defaults,
so a run trained at other widths does not load there).
``--device_loop`` trains in chunks of up to ``--device_loop_chunk`` steps,
each replaying a CUDA graph of the step on the card (``Trainer.run``); it
raises where a capture fails and never falls back to the host loop.
``main`` returns the ``BloomScene``.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os

import numpy as np

from ..config import CameraConfig, GSConfig
from ..priors import (DiffusersInpaintPrior, StubDepthPrior,
                      StubInpaintPrior, ZoeDepthPrior)
from ..utils.image import read_png, resize
from .bloomscene import BloomScene

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description='BloomScene (PyTorch port)')
    # input
    p.add_argument('--image', '-img', type=str,
                   default=os.path.join(_REPO_ROOT, 'examples',
                                        '01_childroom.png'))
    p.add_argument('--text', '-t', type=str,
                   default=os.path.join(_REPO_ROOT, 'examples',
                                        '01_childroom.txt'))
    p.add_argument('--neg_text', '-nt', type=str, default='')
    # camera
    p.add_argument('--campath_gen', '-cg', type=str, default='rotate360',
                   choices=['rotate360'])
    p.add_argument('--campath_render', '-cr', type=str, default='rotate360',
                   help="render preset: 'rotate360' or a path to a "
                        "reference-style camera-path json (e.g. the "
                        "reference's cameras/rotate360.json)")
    # inpainting
    p.add_argument('--seed', type=int, default=1)
    p.add_argument('--diff_steps', type=int, default=50)
    # save
    p.add_argument('--save_dir', '-s', type=str, default='')
    # DPR
    p.add_argument('--dep_value', action='store_true')
    p.add_argument('--dep_domin', action='store_true')
    p.add_argument('--dep_smooth', action='store_true')
    p.add_argument('--dep_value_lbd', type=float, default=0.7)
    p.add_argument('--dep_domin_lbd', type=float, default=0.1)
    p.add_argument('--dep_smooth_lbd', type=float, default=1.0)
    # SCC
    p.add_argument('--n_features', type=int, default=4)
    p.add_argument('--log2', type=int, default=13)
    p.add_argument('--log2_2D', type=int, default=15)
    p.add_argument('--lambdae', type=float, default=0.002)
    # build extras
    p.add_argument('--device', type=str, default='cuda',
                   help="torch device: 'cuda' (the card, default) or 'cpu' "
                        "(the plain PyTorch path)")
    p.add_argument('--device_loop', action='store_true',
                   help='train in chunks of up to --device_loop_chunk '
                        'steps, each a CUDA graph of the step replayed back '
                        'to back on the card (the same steps on the CPU)')
    p.add_argument('--device_loop_chunk', type=int, default=50)
    p.add_argument('--iterations', type=int, default=None,
                   help='override training iterations (default: config)')
    p.add_argument('--log_every', type=int, default=100,
                   help='print and keep (train_log.json) a training '
                        'record every N steps and at the last; each one '
                        'reads the step\'s metrics back from the device')
    p.add_argument('--priors', type=str, default='stub',
                   choices=['stub', 'real'],
                   help='stub = deterministic CI priors; real = '
                        'diffusers SD-inpaint + ZoeDepth (needs weights)')
    p.add_argument('--resolution', type=int, default=512,
                   help='render/generation resolution')
    p.add_argument('--render_frames', type=int, default=180,
                   help='number of orbit frames to render for the video')
    p.add_argument('--voxel_size', type=float, default=None,
                   help='anchor voxel size (default: config 0.001; larger '
                        '= fewer anchors)')
    # static rasterizer/decode capacities (large-scene knobs; overflow is
    # depth-aware and warned about per step — see train/loop.py)
    p.add_argument('--visible_capacity', type=int, default=None,
                   help='bound the per-step decoded anchor set to this '
                        'many visible anchors (required for 500K+ anchor '
                        'scenes; default: dense decode)')
    p.add_argument('--max_splats_per_tile', type=int, default=None,
                   help='static per-tile splat list capacity (default: '
                        f'config {1024})')
    p.add_argument('--pair_capacity', type=int, default=None,
                   help='static (splat, tile) pair buffer size (default: '
                        '2x the total tile budget)')
    p.add_argument('--packed_capacity', type=int, default=None,
                   help='post-cull sorted pair list size (default: '
                        'pair_capacity)')
    p.add_argument('--color_mode', type=str, default='mlp',
                   choices=('mlp', 'sh'),
                   help='color decode: view-conditioned MLP RGB (mlp) or '
                        'per-child SH coefficients + eval_sh (sh)')
    p.add_argument('--sh_degree', type=int, default=1,
                   help='SH degree 0-3 (color_mode=sh only)')
    p.add_argument('--load_dir', type=str, default='',
                   help='cold-start: skip generation/training and re-render '
                        'a previously saved run from its checkpoint.npz + '
                        'bitstreams/gsplat.ply (render_sets equivalent, '
                        'reference bloomscene.py:411-421)')
    return p


def _read_rgb(path: str, resolution: int) -> np.ndarray:
    """A PNG as float32 RGB in [0, 1] at resolution x resolution (PIL's
    ``convert('RGB').resize``: gray repeated, alpha dropped; bicubic)."""
    img = read_png(path)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, -1)
    img = resize(np.ascontiguousarray(img[..., :3]), (resolution, resolution))
    return np.asarray(img, np.float32) / 255.0


def _first_line(text: str) -> str:
    """``text``, or the first line of the file it names (a .txt)."""
    if text.endswith('.txt') and os.path.exists(text):
        with open(text) as f:
            return f.readline().strip()
    return text


def _config(args: argparse.Namespace) -> GSConfig:
    """The ``GSConfig`` that the flags ask for."""
    use_dpr = args.dep_value or args.dep_domin or args.dep_smooth
    cap_over = {k: getattr(args, k) for k in
                ('voxel_size', 'visible_capacity', 'max_splats_per_tile',
                 'pair_capacity', 'packed_capacity')
                if getattr(args, k) is not None}
    return GSConfig(
        **cap_over,
        use_dpr=use_dpr,
        lambda_dep_value=args.dep_value_lbd if args.dep_value else 0.0,
        lambda_dep_domin=args.dep_domin_lbd if args.dep_domin else 0.0,
        lambda_dep_smooth=args.dep_smooth_lbd if args.dep_smooth else 0.0,
        lambda_entropy=args.lambdae,
        n_features_per_level=args.n_features,
        log2_hashmap_size_3d=args.log2,
        log2_hashmap_size_2d=args.log2_2D,
        device_loop=args.device_loop,
        device_loop_chunk=args.device_loop_chunk,
        color_mode=args.color_mode,
        sh_degree=args.sh_degree)


def main(argv=None):
    args = build_parser().parse_args(argv)
    np.random.seed(args.seed)

    preset_json = None
    if args.campath_render.endswith('.json'):
        if not os.path.exists(args.campath_render):
            raise SystemExit(f"--campath_render json not found: "
                             f"{args.campath_render}")
        name = os.path.splitext(os.path.basename(args.campath_render))[0]
        preset_json = {name: args.campath_render}
        args.campath_render = name
    elif args.campath_render != 'rotate360':
        # fail NOW, not after hours of generation+training (preset lookup
        # happens post-training)
        raise SystemExit(
            f"unknown --campath_render {args.campath_render!r}: expected "
            "'rotate360' or a path to a camera-path .json")

    if args.load_dir:
        txt = _first_line(args.text)
        # the model's widths are those the run was trained with
        cfg = None
        settings = os.path.join(args.load_dir, 'settings.json')
        if os.path.exists(settings):
            with open(settings) as f:
                saved = {**vars(build_parser().parse_args([])), **json.load(f)}
            cfg = _config(argparse.Namespace(**saved))
        bs = BloomScene.load(args.load_dir, cfg=cfg, preset_json=preset_json,
                             device=args.device)
        if bs.scene is not None:
            pk = args.campath_render
            n_frames = len(bs.scene.preset_cameras[pk])
            if args.render_frames < n_frames:
                stride = max(1, n_frames // args.render_frames)
                bs.scene = bs.scene._replace(preset_cameras={
                    pk: bs.scene.preset_cameras[pk][::stride]})
        print('video:', bs.render_video(
            args.campath_render, use_decoded=bs.decoded_model is not None))
        print('eval:', bs.render_eval(txt))
        return bs

    if args.save_dir == '':
        img_name = os.path.splitext(os.path.basename(args.image))[0]
        now = datetime.datetime.now().strftime('%Y-%m-%d_%H-%M-%S')
        args.save_dir = (f'./outputs/{img_name}_{args.campath_gen}_'
                         f'{args.seed}_{now}')
    os.makedirs(args.save_dir, exist_ok=True)
    with open(os.path.join(args.save_dir, 'settings.json'), 'w') as f:
        json.dump(vars(args), f, indent=4, sort_keys=True)

    rgb = _read_rgb(args.image, args.resolution)
    txt = _first_line(args.text)
    neg = _first_line(args.neg_text)

    cfg = _config(args)
    cam = CameraConfig(H=args.resolution, W=args.resolution,
                       focal=(582.69 * args.resolution / 512,) * 2)

    if args.priors == 'real':
        inpaint = DiffusersInpaintPrior(device=args.device)
        depth = ZoeDepthPrior(device=args.device)
    else:
        inpaint, depth = StubInpaintPrior(), StubDepthPrior()

    bs = BloomScene(args.save_dir, cfg=cfg, cam=cam, inpaint_prior=inpaint,
                    depth_prior=depth, seed=args.seed,
                    preset_json=preset_json, device=args.device)
    print('start..', datetime.datetime.now().strftime('%Y-%m-%d %H:%M:%S'))
    bs.create(rgb, txt, neg, args.campath_gen, args.diff_steps,
              iterations=args.iterations, log_every=args.log_every)
    print('end..', datetime.datetime.now().strftime('%Y-%m-%d %H:%M:%S'))
    if args.render_frames < 180:
        pk = args.campath_render
        stride = max(1, 180 // args.render_frames)
        bs.scene = bs.scene._replace(preset_cameras={
            pk: bs.scene.preset_cameras[pk][::stride]})
    print('video:', bs.render_video(args.campath_render))
    print('eval:', bs.render_eval(txt))
    return bs


if __name__ == '__main__':
    main()

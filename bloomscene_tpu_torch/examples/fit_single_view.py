"""Smallest end-to-end training demo: fit the anchor model to one view.

The port of ``bloomscene_tpu/examples/fit_single_view.py``: the same scene
(a sphere-shell point cloud and a two-color disk target), the same
``GSConfig`` (densification on, noise and context from 10**9) and the same
check, that the eval render's mean L1 error drops.

    python -m bloomscene_tpu_torch.examples.fit_single_view \\
        --steps 300 --out outputs/fit_single_view [--color_mode sh] \\
        [--device_loop]

runs on the CUDA card; ``--device cpu`` runs the plain PyTorch path.
``--device_loop`` trains in chunks of CUDA graph replays
(``Trainer.run(device_loop=True)``), to the host loop's result bit for
bit.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def build_scene(n_points: int = 1500, seed: int = 0, res: int = 128):
    from ..scene.cameras import camera_from_rt

    rng = np.random.default_rng(seed)
    th = rng.uniform(0, np.pi, n_points)
    ph = rng.uniform(0, 2 * np.pi, n_points)
    pts = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                    np.cos(th)], -1).astype(np.float32) * 0.7
    pts[:, 2] += 2.5

    cam = camera_from_rt(np.eye(3), np.zeros(3), 1.0, 1.0, res, res)
    yy, xx = np.mgrid[0:res, 0:res]
    r2 = (xx - res // 2) ** 2 + (yy - res // 2) ** 2
    img = np.zeros((res, res, 3), np.float32)
    img[r2 < (res // 3) ** 2] = [0.85, 0.45, 0.2]
    img[r2 < (res // 6) ** 2] = [0.2, 0.5, 0.85]
    depth = np.where(r2 < (res // 3) ** 2, 2.5, 0.0).astype(np.float32)
    return pts, cam, img, depth


def fit(steps: int = 300, res: int = 128, seed: int = 0,
        device: str = "cuda", out: str | None = None,
        log_every: int = 25, n_points: int = 1500,
        color_mode: str = 'mlp', sh_degree: int = 1,
        device_loop: bool = False) -> dict:
    """Train ``steps`` steps on a shell of ``n_points`` points; returns the
    loss curve's ends, the L1 errors of the eval render before and after,
    the device loop's capture records (``Trainer.graph_log``; empty for
    the host loop and on the CPU), and the trained ``trainer`` with its
    ``views``. Writes before/after images (``.npy``) and the loss curve to
    ``out`` when given."""
    from ..config import GSConfig
    from ..device import resolve_device
    from ..models.model import init_model
    from ..models.render import render
    from ..train.loop import Trainer

    dev = resolve_device(device)
    pts, cam, img, depth = build_scene(n_points, seed=seed, res=res)
    cfg = GSConfig(iterations=steps, voxel_size=0.08,
                   max_splats_per_tile=2048,
                   start_stat=10, update_from=50, update_interval=100,
                   update_until=max(60, steps - 20),
                   noise_from_step=10 ** 9, context_from_step=10 ** 9,
                   color_mode=color_mode, sh_degree=sh_degree)
    model, voxel_size = init_model(seed, pts, cfg, device=str(dev))
    arrs = cam.device_arrays(dev)
    views = [(arrs, torch.as_tensor(img, device=dev),
              torch.as_tensor(depth, device=dev))]

    def snapshot(m):
        res_r = render(m, cam.intrinsics, arrs, cfg, phase=0, mode='eval',
                       bg=torch.zeros(3, device=dev))
        return np.clip(res_r.out.color.cpu().numpy(), 0, 1)

    before = snapshot(model)
    t0 = time.perf_counter()
    trainer = Trainer(model, cfg, cam.intrinsics, voxel_size, seed=seed,
                      device=str(dev))
    model = trainer.run(views, log_every=log_every, device_loop=device_loop,
                        callback=lambda rec: print(
                            f"step {rec['iteration']:4d} "
                            f"loss {rec['loss']:.4f} "
                            f"psnr {rec['psnr']:.2f}", flush=True))
    train_s = time.perf_counter() - t0
    after = snapshot(model)
    hist = trainer.history
    result = {'steps': steps, 'train_s': train_s,
              'loss_first': hist[0]['loss'],
              'loss_last': hist[-1]['loss'],
              'l1_before': float(np.mean(np.abs(before - img))),
              'l1_after': float(np.mean(np.abs(after - img))),
              'graphs': trainer.graph_log,
              'trainer': trainer, 'views': views}
    if out:
        os.makedirs(out, exist_ok=True)
        np.save(os.path.join(out, 'before.npy'), before)
        np.save(os.path.join(out, 'after.npy'), after)
        with open(os.path.join(out, 'loss_curve.json'), 'w') as f:
            json.dump(hist, f, indent=1)
    return result


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--steps', type=int, default=300)
    ap.add_argument('--res', type=int, default=128)
    ap.add_argument('--out', type=str, default='outputs/fit_single_view')
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--device', type=str, default='cuda')
    ap.add_argument('--color_mode', type=str, default='mlp',
                    choices=('mlp', 'sh'))
    ap.add_argument('--sh_degree', type=int, default=1)
    ap.add_argument('--device_loop', action='store_true',
                    help='train in chunks of CUDA graph replays of the step')
    args = ap.parse_args()
    result = fit(args.steps, args.res, args.seed, args.device, args.out,
                 color_mode=args.color_mode, sh_degree=args.sh_degree,
                 device_loop=args.device_loop)
    del result['trainer'], result['views']
    print(json.dumps({**result, 'out': args.out}))
    if not result['l1_after'] < result['l1_before']:
        raise SystemExit("training did not improve the render")


if __name__ == '__main__':
    main()

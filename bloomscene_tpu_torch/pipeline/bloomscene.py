"""BloomScene orchestrator: image + prompt -> trained, compressed 3D scene.

The port of ``bloomscene_tpu/pipeline/bloomscene.py`` (the reference's
BloomScene class, bloomscene.py:34-425) on one device, "cuda" unless the
caller asks for another:

- ``create`` runs progressive generation (``pcdgen.generate_pcd``, host
  numpy and scipy, cached in ``traindata.npz``), the scene assembly and
  the optimization (``Trainer``), then the codec round trip and
  ``save_outputs`` (gsplat.ply, checkpoint.npz, train_log.json);
- ``render_video`` renders a preset orbit (RGB and colorized depth),
  ``render_eval`` the noisy-pose eval views with their metrics;
- ``load`` rebuilds a saved run in a fresh process from its files, which
  either package may have written.

Each stage's wall time, the card synchronized at its end, accumulates in
``spans`` (``utils.profiling.Spans``) under the stage's name.

``render_model`` renders a camera list (``BloomScene._render_model``,
bloomscene.py:248-336): two measuring passes size the per-frame buffers
snugly, then every frame renders with them. ``mode='eval'`` renders a
trained scene (the hash-grid context quantizes its attributes),
``mode='decoded'`` the scene that ``codec.decode_scene`` returns.

``training`` passes ``GSConfig.device_loop`` and ``device_loop_chunk``
to ``Trainer.run``: with ``device_loop=True`` the steps run in chunks,
each replaying a CUDA graph of the step on the card (JAX's
``make_train_scan``).
"""
from __future__ import annotations

import functools
import json
import os
import time
import warnings
from typing import Optional

import numpy as np
import torch

from ..codec.codec import decode_scene, encode_scene, estimate_final_bits
from ..config import CameraConfig, GSConfig
from ..device import resolve_device
from ..models.model import Model, init_model
from ..models.render import count_pairs, prefilter_anchors, render
from ..priors import (DepthPrior, InpaintPrior, StubDepthPrior,
                      StubInpaintPrior)
from ..scene.dataset import SceneData, read_scene_data
from ..train.loop import Trainer
from ..utils import io as io_utils
from ..utils.depthviz import colorize
from ..utils.image import write_png
from ..utils.metrics import evaluate_renders
from ..utils.profiling import Spans
from . import pcdgen

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


def _save_traindata(path: str, td: dict) -> None:
    """``traindata`` -> a compressed npz that JAX's ``_load_traindata``
    reads, and the port's."""
    frames = td['frames']
    np.savez_compressed(
        path,
        camera_angle_x=td['camera_angle_x'], W=td['W'], H=td['H'],
        pcd_points=td['pcd_points'], pcd_colors=td['pcd_colors'],
        images=np.stack([f['image'] for f in frames]),
        depths=np.stack([f['depth'] for f in frames]),
        transforms=np.stack([np.array(f['transform_matrix'])
                             for f in frames]))


def _load_traindata(path: str) -> dict:
    """Either package's ``traindata.npz`` (fixtures may store float16)."""
    with np.load(path) as z:
        imgs = z['images'].astype(np.float32)
        deps = z['depths'].astype(np.float32)
        frames = [{'image': imgs[i], 'depth': deps[i],
                   'transform_matrix': z['transforms'][i].tolist()}
                  for i in range(imgs.shape[0])]
        return {'camera_angle_x': float(z['camera_angle_x']),
                'W': int(z['W']), 'H': int(z['H']),
                'pcd_points': z['pcd_points'].astype(np.float32),
                'pcd_colors': z['pcd_colors'].astype(np.float32),
                'frames': frames}


def _print_record(rec: dict) -> None:
    print({k: (round(v, 4) if isinstance(v, float) else v)
           for k, v in rec.items()
           if k in ('iteration', 'loss', 'loss_rgb', 'psnr',
                    'bit_per_param', 'n_visible_anchors', 'tile_overflow',
                    'pair_overflow', 'densify_n_alive')}, flush=True)


def _stage(method):
    """Time each call of a ``BloomScene`` stage in its ``spans``."""
    @functools.wraps(method)
    def timed(self, *args, **kw):
        with self.spans.span(method.__name__, sync=self.device):
            return method(self, *args, **kw)
    return timed


class BloomScene:
    """End-to-end scene generation, optimization and compression."""

    def __init__(self, save_dir: str, cfg: Optional[GSConfig] = None,
                 cam: Optional[CameraConfig] = None,
                 inpaint_prior: Optional[InpaintPrior] = None,
                 depth_prior: Optional[DepthPrior] = None,
                 seed: int = 1,
                 preset_json: Optional[dict] = None,
                 device: str = "cuda"):
        self.device = resolve_device(device)
        self.save_dir = save_dir
        self.cfg = cfg or GSConfig()
        self.cam = cam or CameraConfig()
        self.inpaint = inpaint_prior or StubInpaintPrior()
        self.depth = depth_prior or StubDepthPrior()
        self.seed = seed
        # optional reference-style camera-path jsons: {name: path}
        self.preset_json = preset_json
        self.traindata: Optional[dict] = None
        self.scene: Optional[SceneData] = None
        self.model: Optional[Model] = None
        self.decoded_model: Optional[Model] = None
        self.trainer: Optional[Trainer] = None
        self.logs: list[dict] = []
        self.spans = Spans()
        os.makedirs(save_dir, exist_ok=True)

    # ---- cold start: rebuild a renderable scene from disk ----
    @classmethod
    def load(cls, save_dir: str, cfg: Optional[GSConfig] = None,
             cam: Optional[CameraConfig] = None, seed: int = 1,
             preset_json: Optional[dict] = None,
             device: str = "cuda") -> "BloomScene":
        """A saved run, in a fresh process (bloomscene.py:411-421): the
        heads, hash tables and bounds from ``checkpoint.npz``, the anchors
        decoded from ``bitstreams/`` (``decoded_model``, rendered with
        ``use_decoded=True``) and read from ``gsplat.ply`` (``model``, the
        eval renders), the cameras from ``traindata.npz``. A bitstream that
        the context digest refuses (one the other package encoded) is
        skipped with a warning, and ``gsplat.ply`` serves."""
        self = cls(save_dir, cfg=cfg, cam=cam, seed=seed,
                   preset_json=preset_json, device=device)
        ck_path = os.path.join(save_dir, 'checkpoint.npz')
        if not os.path.exists(ck_path):
            raise FileNotFoundError(f"no checkpoint.npz in {save_dir}")
        # a shell with the heads' and tables' shapes; weights from disk
        shell, _ = init_model(seed, np.zeros((8, 3), np.float32), self.cfg,
                              device=self.device)
        shell = io_utils.load_checkpoint(ck_path, shell)

        bit_dir = os.path.join(save_dir, 'bitstreams')
        if os.path.exists(os.path.join(bit_dir, 'meta.json')):
            try:
                self.decoded_model = decode_scene(shell, self.cfg, bit_dir,
                                                  device=self.device)
                self.model = self.decoded_model
            except RuntimeError as e:
                warnings.warn(f"load: skipping bitstream decode: {e}")
        ply = os.path.join(save_dir, 'gsplat.ply')
        if os.path.exists(ply):
            state = io_utils.load_anchor_ply(ply, self.cfg.n_offsets,
                                             self.cfg.feat_dim,
                                             device=self.device)
            self.model = shell._replace(state=state)
        if self.model is None:
            raise FileNotFoundError(
                f"neither bitstreams/ nor gsplat.ply found in {save_dir}")

        cache = os.path.join(save_dir, 'traindata.npz')
        if os.path.exists(cache):
            self.traindata = _load_traindata(cache)
            self.scene = read_scene_data(self.traindata,
                                         self.cfg.white_background,
                                         preset_json=self.preset_json)
        return self

    # ---- stage 1: progressive generation ----
    @_stage
    def generate(self, rgb_cond: np.ndarray, prompt: str,
                 negative_prompt: str = "", pcdgenpath: str = 'rotate360',
                 diff_steps: int = 50, verbose: bool = True) -> dict:
        """``traindata`` from ``save_dir/traindata.npz`` when it is there,
        else from ``generate_pcd`` (which also writes point_cloud.ply), then
        the scene."""
        cache = os.path.join(self.save_dir, 'traindata.npz')
        if os.path.exists(cache):
            self.traindata = _load_traindata(cache)
        else:
            self.traindata = pcdgen.generate_pcd(
                rgb_cond, prompt, negative_prompt, pcdgenpath, self.seed,
                diff_steps, self.cam, self.inpaint, self.depth,
                save_ply_path=os.path.join(self.save_dir,
                                           'point_cloud.ply'),
                progress=(print if verbose else None))
            _save_traindata(cache, self.traindata)
        self.scene = read_scene_data(self.traindata,
                                     self.cfg.white_background,
                                     preset_json=self.preset_json)
        return self.traindata

    # ---- stage 2: optimization ----
    @_stage
    def training(self, iterations: Optional[int] = None,
                 log_every: int = 100, callback=None,
                 resume: bool = False,
                 checkpoint_every: int = 0) -> Model:
        """Train a model initialized from the scene's points.
        ``resume=True`` restores ``save_dir/train_ckpt.npz`` when it is
        there and continues from its step; ``checkpoint_every=N`` writes
        it on each logged step that is a multiple of N."""
        if self.scene is None:
            raise RuntimeError("training: generate() (or load a scene) "
                               "first")
        dev = self.device
        model, voxel_size = init_model(self.seed, self.scene.points,
                                       self.cfg, device=dev)
        cam0 = self.scene.train_cameras[0]
        views = self.train_views()
        self.trainer = Trainer(model, self.cfg, cam0.intrinsics, voxel_size,
                               spatial_lr_scale=self.scene.radius,
                               seed=self.seed, device=dev)
        ckpt = os.path.join(self.save_dir, 'train_ckpt.npz')
        if resume and os.path.exists(
                os.path.splitext(ckpt)[0] + '.meta.json'):
            self.trainer.restore(ckpt)
            print(f"training: resumed from step {self.trainer.step}",
                  flush=True)
        if callback is None:
            callback = _print_record
        if checkpoint_every:
            inner_cb = callback

            def callback(rec):
                inner_cb(rec)
                it = int(rec.get('iteration', 0))
                if it and it % checkpoint_every == 0:
                    self.trainer.save(ckpt)

        self.model = self.trainer.run(views, iterations=iterations,
                                      log_every=log_every,
                                      callback=callback,
                                      device_loop=self.cfg.device_loop,
                                      max_chunk=self.cfg.device_loop_chunk)
        self.logs = self.trainer.history
        return self.model

    def train_views(self) -> list:
        """The scene's supervised views as ``Trainer.run`` takes them:
        (CameraArrays, gt_image, gt_depth) on the device, a zero depth
        where a view has none."""
        cams, dev = self.scene.train_cameras, self.device
        if any(c.intrinsics != cams[0].intrinsics for c in cams):
            raise ValueError("train cameras must share intrinsics")
        return [(c.device_arrays(dev),
                 torch.as_tensor(c.image, device=dev),
                 torch.as_tensor(c.depth if c.depth is not None
                                 else np.zeros((c.height, c.width),
                                               np.float32), device=dev))
                for c in cams]

    # ---- stage 3: compression round trip ----
    @_stage
    def compress(self) -> dict:
        """Encode the model into ``bitstreams/``, decode it back
        (``decoded_model``), and write the sizes, the estimate and the
        wall times to ``codec_sizes.json``."""
        if self.model is None:
            raise RuntimeError("compress: no model (train or load first)")
        path = os.path.join(self.save_dir, 'bitstreams')
        est = estimate_final_bits(self.model, self.cfg)
        sizes = encode_scene(self.model, self.cfg, path)
        t0 = time.time()
        dec_t: dict = {}
        self.decoded_model = decode_scene(self.model, self.cfg, path,
                                          timings=dec_t, device=self.device)
        sizes['decode_time_s'] = time.time() - t0
        sizes['decode_split'] = dec_t
        sizes['estimated'] = est
        with open(os.path.join(self.save_dir, 'codec_sizes.json'),
                  'w') as f:
            json.dump(sizes, f, indent=2)
        return sizes

    # ---- rendering ----
    def _render(self, model: Model, cameras, mode: str = 'eval'):
        with torch.no_grad():
            return render_model(model, cameras, self.cfg, mode=mode,
                                device=self.device)

    @_stage
    def render_video(self, preset: str = 'rotate360',
                     use_decoded: bool = False) -> dict:
        """The preset orbit -> ``{preset}.mp4`` and ``{preset}_depth.mp4``
        (or their PNG frame directories, ``utils.io.write_video``)."""
        model = self.decoded_model if use_decoded else self.model
        mode = 'decoded' if use_decoded else 'eval'
        cams = self.scene.preset_cameras[preset]
        rgb, dep, fps = self._render(model, cams, mode=mode)
        io_utils.write_video(
            os.path.join(self.save_dir, f'{preset}.mp4'), rgb)
        dmin = min(d.min() for d in dep)
        dmax = max(d.max() for d in dep)
        dep_rgb = [colorize(d, vmin=dmin, vmax=dmax)[..., :3] / 255.0
                   for d in dep]
        io_utils.write_video(
            os.path.join(self.save_dir, f'{preset}_depth.mp4'), dep_rgb)
        return {'eval_fps': fps, 'n_frames': len(rgb)}

    @_stage
    def render_eval(self, prompt: str = "") -> dict:
        """The noisy-pose eval views (the train views when there are none)
        -> ``eval_renders/NNN.png`` and ``metrics.json`` (render_sets and
        the metrics, bloomscene.py:385-421, run.py:109-111)."""
        cams = self.scene.eval_cameras or self.scene.train_cameras
        rgb, _, fps = self._render(self.model, cams)
        out_dir = os.path.join(self.save_dir, 'eval_renders')
        os.makedirs(out_dir, exist_ok=True)
        for i, im in enumerate(rgb):
            write_png(os.path.join(out_dir, f'{i:03d}.png'),
                      (im * 255).astype(np.uint8))
        metrics = evaluate_renders(rgb, prompt)
        metrics['eval_fps'] = fps
        with open(os.path.join(self.save_dir, 'metrics.json'), 'w') as f:
            json.dump(metrics, f, indent=2)
        return metrics

    # ---- persistence ----
    @_stage
    def save_outputs(self) -> None:
        """``gsplat.ply``, ``checkpoint.npz`` and ``train_log.json``."""
        if self.model is None:
            raise RuntimeError("save_outputs: no model")
        io_utils.save_anchor_ply(
            os.path.join(self.save_dir, 'gsplat.ply'), self.model.state)
        io_utils.save_checkpoint(
            os.path.join(self.save_dir, 'checkpoint.npz'), self.model)
        with open(os.path.join(self.save_dir, 'train_log.json'), 'w') as f:
            json.dump(self.logs, f)

    # ---- the full reference flow ----
    def create(self, rgb_cond: np.ndarray, prompt: str,
               negative_prompt: str = "", pcdgenpath: str = 'rotate360',
               diff_steps: int = 50, iterations: Optional[int] = None,
               log_every: int = 100):
        """bloomscene.create (bloomscene.py:152-159): generate, train
        (a record every ``log_every`` steps), compress, save."""
        self.generate(rgb_cond, prompt, negative_prompt, pcdgenpath,
                      diff_steps)
        self.training(iterations=iterations, log_every=log_every)
        self.compress()
        self.save_outputs()
        return self

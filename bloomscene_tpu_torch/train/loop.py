"""One training step of the anchor model, and the host-side training loop.

The port of ``bloomscene_tpu/train/loop.py`` (the reference hot loop,
bloomscene.py:222-361): per step, the anchor prefilter, the neural render
through the tile rasterizer's custom backward (K1 forward, K2 backward),
the loss stack (L1 + DSSIM + scaling regularizer + the entropy rate + the
optional depth-prior regularizers), the gradients, the non-finite update
skip, the 13-group Adam and the densification statistics. The decode
follows the phase schedule (0: raw attributes, 1: quantization noise, 2:
the hash-grid context, adaptive noise and the rate), and every
``update_interval`` steps ``Trainer.run`` runs the anchor surgery
(``models/densify.py::adjust_anchor``) at the JAX trainer's cadence.

``Trainer.save``/``restore`` write and read the port's own trainer
checkpoint, which resumes a run bit for bit, past densification steps too.

Not ported yet (ROADMAP queue 1): ``make_train_scan`` (a device loop) and
``make_dp_train_step`` (data parallelism).
"""
from __future__ import annotations

import json
import os
import warnings
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from ..config import GSConfig
from ..device import resolve_device
from ..models import densify
from ..models.anchors import AnchorBounds, AnchorState, update_anchor_bounds
from ..models.decode import DecodeNoise, draw_noise
from ..models.densify import DensifyStats
from ..models.model import Model
from ..models.render import prefilter_anchors, render
from ..scene.cameras import CameraArrays, Intrinsics
from . import losses
from .optim import Adam, make_trainable


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    loss_rgb: torch.Tensor
    loss_dep_value: torch.Tensor
    loss_dep_domin: torch.Tensor
    loss_dep_smooth: torch.Tensor
    bit_per_param: torch.Tensor
    psnr: torch.Tensor
    n_visible_anchors: torch.Tensor
    tile_overflow: torch.Tensor
    pair_overflow: torch.Tensor
    packed_overflow: torch.Tensor
    num_pairs: torch.Tensor        # splat-tile pairs before the cull
    skipped: torch.Tensor          # 1 where the update was skipped


def phase_of_step(step: int, cfg: GSConfig) -> int:
    """Training phase (decode noise/context schedule)."""
    if step <= cfg.noise_from_step:
        return 0
    if step <= cfg.context_from_step:
        return 1
    return 2


def compute_losses(res, gt_image, gt_depth, cfg: GSConfig):
    """The reference loss stack (bloomscene.py:283-325)."""
    image = res.out.color
    l1 = losses.l1_loss(image, gt_image)
    loss_rgb = ((1.0 - cfg.lambda_dssim) * l1
                + cfg.lambda_dssim * (1.0 - losses.ssim(image, gt_image)))
    loss = loss_rgb
    # scaling regularizer: prod of decoded child scales (bloomscene.py:289)
    scaling_reg = torch.mean(torch.where(
        res.dec.valid, torch.prod(res.dec.scaling, dim=1), 0.0))
    loss = loss + cfg.lambda_scaling_reg * scaling_reg
    loss = loss + cfg.lambda_entropy * res.rate.bit_per_param

    zero = torch.zeros((), device=image.device)
    dep_value = dep_domin = dep_smooth = zero
    if cfg.use_dpr:
        gt_d = losses.minmax_normalize(gt_depth)
        rd = losses.minmax_normalize(res.out.depth)
        dep_value = cfg.lambda_dep_value * losses.huber_l1_edge_aware(
            rd, gt_d, gt_image)
        dep_domin = cfg.lambda_dep_domin * losses.cmd(
            rd[None], gt_d[None, None], normalized=cfg.cmd_normalized)
        dep_smooth = cfg.lambda_dep_smooth * losses.bilateral_smoothness(rd)
        loss = loss + dep_value + dep_domin + dep_smooth

    mse = torch.mean((image - gt_image) ** 2)
    psnr = -10.0 * torch.log10(torch.clamp(mse, min=1e-12))
    return loss, dict(loss_rgb=loss_rgb, loss_dep_value=dep_value,
                      loss_dep_domin=dep_domin, loss_dep_smooth=dep_smooth,
                      psnr=psnr)


def make_train_step(cfg: GSConfig, intr: Intrinsics, optimizer: Adam,
                    bg: torch.Tensor,
                    generator: torch.Generator | None = None):
    """step(model, stats, cam, gt_image, gt_depth, *, phase, track_stats,
    noise=None) -> (model, stats, StepMetrics); the model's leaves and the
    optimizer's moments are updated in place. In phases 1 and 2 the
    decode's draws come from ``noise`` when given, else from
    ``generator``."""

    def train_step(model: Model, stats: DensifyStats, cam: CameraArrays,
                   gt_image, gt_depth, *, phase: int, track_stats: bool,
                   noise: DecodeNoise | None = None):
        if noise is None and phase > 0:
            noise = draw_noise(decoded_rows(model, cfg), cfg, phase,
                               generator, model.state.device)
        return _step_core(cfg, intr, optimizer, bg, model, stats, cam,
                          gt_image, gt_depth, phase, track_stats, noise)

    return train_step


def decoded_rows(model: Model, cfg: GSConfig) -> int:
    """The anchor rows a training render decodes: the capacity, or the
    visible bucket when ``cfg.visible_capacity`` compacts the decode."""
    n = model.state.capacity
    if cfg.visible_capacity is not None and n > cfg.visible_capacity:
        n = cfg.visible_capacity
    return n


def step_gradients(cfg: GSConfig, intr: Intrinsics, bg, model: Model,
                   params: list, cam: CameraArrays, gt_image, gt_depth,
                   phase: int, noise: DecodeNoise | None = None):
    """The forward and backward of one step -> (visible, loss, aux, res,
    grads, g_m2d): the gradient of the loss for each tensor of ``params``
    (zeros where the loss does not reach it) and for the mean2d offset.
    With ``cfg.remat`` the decode and render are recomputed in the backward
    (``noise`` is drawn before, so the recomputation sees the same
    draws)."""
    with record_function("train.prefilter"):
        visible = prefilter_anchors(model, intr, cam)
    n_child = decoded_rows(model, cfg) * model.state.n_offsets
    m2d_offset = torch.zeros((n_child * 2,), device=visible.device,
                             requires_grad=True)

    def render_fn(m2d):
        return render(model, intr, cam, cfg, phase=phase, mode='train',
                      bg=bg, visible=visible, mean2d_offset=m2d, noise=noise)

    with torch.enable_grad():
        with record_function("train.forward"):
            if cfg.remat:
                # recompute decode + render in the backward: the forward
                # runs twice per step (K1, K3 and K4 launch twice, K2 once)
                res = checkpoint(render_fn, m2d_offset, use_reentrant=False)
            else:
                res = render_fn(m2d_offset)
            loss, aux = compute_losses(res, gt_image, gt_depth, cfg)
        with record_function("train.backward"):
            grads = torch.autograd.grad(loss, params + [m2d_offset],
                                        allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(params + [m2d_offset], grads)]
    g_m2d = grads.pop()
    return visible, loss, aux, res, grads, g_m2d


def _step_core(cfg: GSConfig, intr: Intrinsics, optimizer: Adam, bg,
               model: Model, stats: DensifyStats, cam: CameraArrays,
               gt_image, gt_depth, phase: int, track_stats: bool,
               noise: DecodeNoise | None = None):
    """One SGD step (``_step_core``, loop.py:100-168). Its parts run under
    ``record_function`` spans (``train.prefilter``, ``train.forward``,
    ``train.backward``, ``train.update``, ``train.stats``) that a
    ``torch.profiler`` run reads (``profile_render_torch.py --train``)."""
    params = [t for _, _, t in optimizer.params]
    visible, loss, aux, res, grads, g_m2d = step_gradients(
        cfg, intr, bg, model, params, cam, gt_image, gt_depth, phase, noise)

    # a non-finite loss or gradient would poison every parameter through
    # Adam in one step: zero the gradients and still step (loop.py:136-147)
    with torch.no_grad(), record_function("train.update"):
        gsum = sum(torch.sum(torch.abs(g)) for g in grads)
        ok = torch.isfinite(loss) & torch.isfinite(gsum)
        grads = [torch.where(ok, g, 0.0) for g in grads]
        optimizer.step(grads)

    if track_stats:
        with record_function("train.stats"):
            stats = densify.accumulate_stats(
                stats, res.dec.neural_opacity.detach(), res.dec.valid,
                res.proj.valid, visible, g_m2d, intr.width, intr.height,
                anchor_idx=res.visible_idx)

    metrics = StepMetrics(
        loss=loss.detach(), loss_rgb=aux['loss_rgb'].detach(),
        loss_dep_value=aux['loss_dep_value'].detach(),
        loss_dep_domin=aux['loss_dep_domin'].detach(),
        loss_dep_smooth=aux['loss_dep_smooth'].detach(),
        bit_per_param=res.rate.bit_per_param.detach(),
        psnr=aux['psnr'].detach(),
        n_visible_anchors=torch.sum(visible),
        tile_overflow=res.bins.tile_overflow,
        pair_overflow=res.bins.pair_overflow,
        packed_overflow=res.bins.packed_overflow,
        num_pairs=res.bins.num_pairs,
        skipped=(~ok).to(torch.int32))
    return model, stats, metrics


class Trainer:
    """Host-side orchestration of the optimization (loop.py:333-508), on one
    device. The model's leaves are trained in place, until a densification
    step grows the capacity and replaces them."""

    def __init__(self, model: Model, cfg: GSConfig, intr: Intrinsics,
                 voxel_size: float, spatial_lr_scale: float = 1.0,
                 bg: np.ndarray | None = None, seed: int = 0,
                 device: str = "cuda"):
        dev = resolve_device(device)
        if model.state.device != dev:
            raise ValueError(f"model lives on {model.state.device}, "
                             f"training requested on {dev}")
        self.cfg = cfg
        self.intr = intr
        self.voxel_size = voxel_size
        model = model._replace(bounds=update_anchor_bounds(model.state))
        self.model = make_trainable(model)
        self.optimizer = Adam(cfg, spatial_lr_scale, self.model)
        self.stats = densify.init_stats(model.state.capacity, cfg.n_offsets,
                                        dev)
        self.bg = torch.as_tensor(
            bg if bg is not None else
            (np.ones(3) if cfg.white_background else np.zeros(3)),
            dtype=torch.float32, device=dev)
        # the decode's noise in phases 1 and 2, drawn on the device
        self.noise_gen = torch.Generator(device=dev).manual_seed(seed)
        self.step_fn = make_train_step(cfg, intr, self.optimizer, self.bg,
                                       self.noise_gen)
        # camera draws: numpy, not the JAX package's key splits, so the
        # draw sequence differs from JAX's for more than one camera; a
        # stream spawned from the seed, apart from the surgery's below
        self.rng = np.random.default_rng(
            np.random.SeedSequence(seed).spawn(1)[0])
        # the surgery's draws: a numpy Generator of its own, as the JAX
        # trainer's np_rng
        self.densify_rng = np.random.default_rng(seed)
        self.history: list[dict] = []
        self.step = 0

    # --- the trainer checkpoint ---
    def save(self, path: str) -> None:
        """Write everything a resumed run needs to ``path`` (an ``.npz``)
        and the step to ``{stem}.meta.json``: the model's leaves (state,
        heads, hash tables, bounds), ``Adam``'s moments and count, the
        densify statistics, and the three generators (``noise_gen``'s
        device state, the camera stream ``rng`` and the surgery's
        ``densify_rng``). A run restored from it continues as the straight
        run would, bit for bit, past densification steps too (the JAX
        trainer saves no numpy generator, loop.py:379-386).

        The file is the port's own format; the JAX package cannot load it
        (its trainer checkpoint holds optax's state and a JAX key)."""
        m = self.model
        arrays = {f'state.{f}': t.detach().cpu().numpy()
                  for f, t in m.state.flat_leaves().items()}
        arrays.update({f'heads.{n}': p.detach().cpu().numpy()
                       for n, p in m.heads.named_parameters()})
        arrays.update({f'grid.{k}': t.detach().cpu().numpy()
                       for k, t in m.grid.items()})
        arrays['bounds.x_min'] = m.bounds.x_min.detach().cpu().numpy()
        arrays['bounds.x_max'] = m.bounds.x_max.detach().cpu().numpy()
        arrays.update({f'adam.{k}': v for k, v in
                       self.optimizer.state_arrays().items()})
        arrays.update({f'stats.{f}': t.detach().cpu().numpy()
                       for f, t in self.stats._asdict().items()})
        arrays['noise_gen'] = self.noise_gen.get_state().numpy()
        for name in ('rng', 'densify_rng'):
            arrays[name] = np.frombuffer(json.dumps(
                getattr(self, name).bit_generator.state).encode(), np.uint8)
        os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
        np.savez(path, **arrays)
        with open(os.path.splitext(path)[0] + '.meta.json', 'w') as f:
            json.dump({'step': self.step}, f)

    @torch.no_grad()
    def restore(self, path: str) -> None:
        """Read a ``save`` file into this trainer, built with the same
        config, intrinsics and seed: the model at the saved capacity (which
        densification may have grown past this trainer's), its saved
        bounds, its trained leaves requiring grad and taken by ``Adam``
        with the saved moments, the statistics, the generators and the
        step."""
        with np.load(path if path.endswith('.npz') else path + '.npz',
                     allow_pickle=False) as f:
            data = {k: f[k] for k in f.files}
        dev = self.model.state.device

        def t(key):
            return torch.from_numpy(data[key]).to(dev)

        state = AnchorState(**{f: t(f'state.{f}')
                               for f in AnchorState._fields})
        heads = self.model.heads
        for n, p in heads.named_parameters():
            p.copy_(t(f'heads.{n}'))
        model = Model(state=state, heads=heads,
                      grid={k: t(f'grid.{k}') for k in self.model.grid},
                      bounds=AnchorBounds(x_min=t('bounds.x_min'),
                                          x_max=t('bounds.x_max')))
        self.model = make_trainable(model)
        self.optimizer.load_state_arrays(self.model, {
            k[len('adam.'):]: v for k, v in data.items()
            if k.startswith('adam.')})
        self.stats = DensifyStats(**{f: t(f'stats.{f}')
                                     for f in DensifyStats._fields})
        self.noise_gen.set_state(torch.from_numpy(data['noise_gen']))
        for name in ('rng', 'densify_rng'):
            getattr(self, name).bit_generator.state = json.loads(
                data[name].tobytes().decode())
        meta_p = os.path.splitext(path)[0] + '.meta.json'
        with open(meta_p) as f:
            self.step = int(json.load(f)['step'])

    def _densify_due(self, it: int) -> bool:
        cfg = self.cfg
        track = cfg.start_stat < it < cfg.update_until
        in_pause = cfg.densify_pause_from <= it < cfg.densify_pause_until
        return (track and not in_pause and it > cfg.update_from
                and it % cfg.update_interval == 0)

    def run(self, cameras, iterations: int | None = None,
            log_every: int = 100, callback=None) -> Model:
        """cameras: list of (CameraArrays, gt_image [H, W, 3], gt_depth
        [H, W]) on the trainer's device. Resumes from ``self.step + 1``.
        A record (every ``log_every`` steps and the last) carries the
        step's metrics, and ``densify_*`` keys when ``adjust_anchor`` ran
        on that step."""
        cfg = self.cfg
        iterations = iterations or cfg.iterations
        for it in range(self.step + 1, iterations + 1):
            self.step = it
            cam, gt_image, gt_depth = cameras[int(
                self.rng.integers(len(cameras)))]
            if it == cfg.context_from_step:
                self.model = self.model._replace(
                    bounds=update_anchor_bounds(self.model.state))
            track = cfg.start_stat < it < cfg.update_until
            self.model, self.stats, metrics = self.step_fn(
                self.model, self.stats, cam, gt_image, gt_depth,
                phase=phase_of_step(it, cfg), track_stats=track)
            info = None
            if self._densify_due(it):
                self.model, self.stats, info = densify.adjust_anchor(
                    self.model, self.stats, self.optimizer, cfg,
                    self.voxel_size, self.densify_rng)
            if it % log_every == 0 or it == iterations:
                self._emit_record(it, metrics._asdict(), info, callback)
        return self.model

    def _emit_record(self, it, metric_items, info, callback):
        cfg = self.cfg
        rec = {k: float(v) for k, v in metric_items.items()}
        rec['iteration'] = it
        if (cfg.visible_capacity is not None
                and rec['n_visible_anchors'] > cfg.visible_capacity):
            warnings.warn(
                f"step {it}: {int(rec['n_visible_anchors'])} visible anchors "
                f"exceed visible_capacity={cfg.visible_capacity}; "
                "overflowing anchors are skipped this step — raise "
                "GSConfig.visible_capacity for full coverage",
                RuntimeWarning, stacklevel=2)
        if rec['pair_overflow'] > 0 or rec['tile_overflow'] > 0:
            warnings.warn(
                f"rasterizer capacity overflow at step {it}: "
                f"pair_overflow={int(rec['pair_overflow'])} "
                f"tile_overflow={int(rec['tile_overflow'])} — farthest "
                "splats are being dropped; consider raising "
                "GSConfig.pair_capacity/max_splats_per_tile",
                RuntimeWarning, stacklevel=2)
        if rec['packed_overflow'] > 0:
            warnings.warn(
                f"step {it}: packed pair buffer overflow "
                f"({int(rec['packed_overflow'])} surviving pairs dropped, "
                "highest tile ids first) — raise the packed_capacity "
                "passed to rasterize_tiles (defaults to pair_capacity, "
                "which never overflows this buffer)",
                RuntimeWarning, stacklevel=2)
        if info:
            rec.update({f'densify_{k}': v for k, v in info.items()
                        if not isinstance(v, bool)})
        self.history.append(rec)
        if callback:
            callback(rec)

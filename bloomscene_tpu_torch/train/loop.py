"""One training step of the anchor model, and the training loops.

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

Three loops run that schedule:

- the host loop (``Trainer.run``): one step a call;
- the device loop (``Trainer.run(device_loop=True)``, JAX's
  ``make_train_scan``): chunks of up to ``max_chunk`` steps. On the card
  ``capture_train_step`` records one step as a CUDA graph, which each
  chunk replays back to back with no host round trip between its steps;
  the step reads its camera, its Adam scalars and its metrics row from
  static tensors at a step counter it advances itself (``loop_step``). On
  the CPU the same chunks run the same ``loop_step`` without a graph. It
  trains on the host loop's camera sequence and draws, and ends on the
  host loop's state bit for bit;
- the batched trainer (``Trainer(dp_batch=B)``, JAX's
  ``make_dp_train_step`` with ``mesh=None``): B views a step, the mean of
  their losses; with ``mesh=`` (``parallel/mesh.py``) the same step data
  parallel over the mesh's ranks, each rendering its B / data views.

``Trainer.save``/``restore`` write and read the port's own trainer
checkpoint, which resumes a run bit for bit, past densification steps too.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import time
import warnings
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..config import GSConfig
from ..device import resolve_device
from ..models import densify
from ..models.anchors import AnchorBounds, AnchorState, update_anchor_bounds
from ..models.decode import DecodeNoise, draw_noise
from ..models.densify import DensifyStats
from ..models.model import Model
from ..models.render import prefilter_anchors, render
from ..ops.cuda import launch_counts
from ..scene.cameras import CameraArrays, Intrinsics
from ..utils.profiling import (Spans, StepStamps, covered_ns, fill_dropped,
                               graph_kernels, idle_stamps, span, step_times)
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
    # scaling regularizer: prod of decoded child scales (bloomscene.py:289),
    # written out: torch.prod's backward on the card reads a count of zeros
    # on the host (.item()), which a CUDA graph cannot capture. The
    # gradient of each factor is the product of the other two, as JAX's
    # reduce_prod rule gives it
    s = res.dec.scaling
    scaling_reg = torch.mean(torch.where(
        res.dec.valid, s[:, 0] * s[:, 1] * s[:, 2], 0.0))
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


def view_loss(cfg: GSConfig, intr: Intrinsics, bg, model: Model,
              visible, m2d_offset, cam: CameraArrays, gt_image, gt_depth,
              phase: int, noise: DecodeNoise | None = None, tile_group=None):
    """One view's render and loss stack, with grad -> (loss, aux, res).
    With ``cfg.remat`` the decode and render are recomputed in the
    backward; ``noise`` is drawn before, so the recomputation sees the same
    draws, and the render draws nothing itself, so the CUDA RNG state is
    neither saved nor restored (which a CUDA graph could not capture).
    ``tile_group`` blends tile-parallel (``render``)."""
    def render_fn(m2d):
        return render(model, intr, cam, cfg, phase=phase, mode='train',
                      bg=bg, visible=visible, mean2d_offset=m2d, noise=noise,
                      tile_group=tile_group)

    with torch.enable_grad(), span("train.forward"):
        if cfg.remat:
            # the forward runs twice per step (K1, K3 and K4 launch twice,
            # K2 once): its spans run again inside train.backward
            res = checkpoint(render_fn, m2d_offset, use_reentrant=False,
                             preserve_rng_state=False)
        else:
            res = render_fn(m2d_offset)
        with span("train.losses"):
            loss, aux = compute_losses(res, gt_image, gt_depth, cfg)
    return loss, aux, res


def _gradients(loss, tensors: list) -> list:
    """d loss / d each of ``tensors`` (zeros where the loss does not reach
    it)."""
    with torch.enable_grad(), span("train.backward"):
        grads = torch.autograd.grad(loss, tensors, allow_unused=True)
    return [torch.zeros_like(t) if g is None else g
            for t, g in zip(tensors, grads)]


def step_gradients(cfg: GSConfig, intr: Intrinsics, bg, model: Model,
                   params: list, cam: CameraArrays, gt_image, gt_depth,
                   phase: int, noise: DecodeNoise | None = None,
                   tile_group=None):
    """The forward and backward of one step -> (visible, loss, aux, res,
    grads, g_m2d): the gradient of the loss for each tensor of ``params``
    (zeros where the loss does not reach it) and for the mean2d offset."""
    with span("train.prefilter"):
        visible = prefilter_anchors(model, intr, cam)
    n_child = decoded_rows(model, cfg) * model.state.n_offsets
    m2d_offset = torch.zeros((n_child * 2,), device=visible.device,
                             requires_grad=True)
    loss, aux, res = view_loss(cfg, intr, bg, model, visible, m2d_offset,
                               cam, gt_image, gt_depth, phase, noise,
                               tile_group)
    grads = _gradients(loss, params + [m2d_offset])
    g_m2d = grads.pop()
    return visible, loss, aux, res, grads, g_m2d


@torch.no_grad()
def _update(optimizer: Adam, loss, grads: list, scalars=None):
    """The non-finite skip and one Adam step -> ``ok``: a non-finite loss
    or gradient would poison every parameter through Adam in one step, so
    the gradients are zeroed and Adam still steps (loop.py:136-147)."""
    with span("train.update"):
        gsum = sum(torch.sum(torch.abs(g)) for g in grads)
        ok = torch.isfinite(loss) & torch.isfinite(gsum)
        grads = [torch.where(ok, g, 0.0) for g in grads]
        optimizer.step(grads, scalars)
    return ok


def _step_core(cfg: GSConfig, intr: Intrinsics, optimizer: Adam, bg,
               model: Model, stats: DensifyStats, cam: CameraArrays,
               gt_image, gt_depth, phase: int, track_stats: bool,
               noise: DecodeNoise | None = None, scalars=None,
               tile_group=None):
    """One SGD step (``_step_core``, loop.py:100-168). Its parts run under
    the program's spans (``utils.profiling.span``: ``train.prefilter``,
    ``train.forward`` with ``train.losses``, ``train.backward``,
    ``train.update``, ``train.stats``), which a ``torch.profiler`` run
    reads (``profile_render_torch.py --train``) and which the device loop
    stamps on the device.
    ``scalars`` is Adam's row for the step in the device loop
    (``Adam.step``); ``tile_group`` blends tile-parallel."""
    params = [t for _, _, t in optimizer.params]
    visible, loss, aux, res, grads, g_m2d = step_gradients(
        cfg, intr, bg, model, params, cam, gt_image, gt_depth, phase, noise,
        tile_group)
    ok = _update(optimizer, loss, grads, scalars)

    if track_stats:
        with span("train.stats"):
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


# --- the batched trainer ------------------------------------------------

def make_dp_train_step(cfg: GSConfig, intr: Intrinsics, optimizer: Adam,
                       bg: torch.Tensor,
                       generator: torch.Generator | None = None, mesh=None):
    """A step over a batch of B views with the mean of their losses (JAX's
    ``make_dp_train_step``, loop.py:171-289): each view prefiltered,
    rendered (remat per view, as ``step_gradients``) and differentiated on
    its own, the gradient of the mean loss the views' gradients summed in
    view order over B, the non-finite skip and one Adam step, then the
    densify statistics of each view in order with its own mean2d gradient
    (JAX's gradient of the mean times B: B views count as B single-view
    steps of the reference's training_statis, gaussian_model.py:742-759).

    step(model, stats, cams, gt_images, gt_depths, idx, *, phase,
    track_stats, noise=None) -> (model, stats, StepMetrics): ``cams`` a
    ``CameraArrays`` of stacked [N, ...] tensors, ``gt_images`` [N, H, W,
    3], ``gt_depths`` [N, H, W], ``idx`` the B views of the step (ints). In
    phases 1 and 2 each view's draws come from ``noise`` (one
    ``DecodeNoise`` a view) when given, else from ``generator``, in view
    order. The metrics are means over the views, the overflow counters
    their maximum.

    With ``mesh`` (a ``parallel.mesh.Mesh``; the sharded branch,
    loop.py:273-283) every rank of the mesh calls the step on the same
    arguments: data rank d renders views [d B/D, (d + 1) B/D) (B divisible
    by the data size D), tile-parallel over the tile axis; the draws are
    taken for the whole batch in view order on every rank, so the
    generator moves as in the one-process step. Each view's gradient,
    scalars and densify inputs are all-gathered over the data axis, and
    every rank sums and accumulates them in view order: every rank takes
    the one-process step's update, statistics and metrics bit for bit.
    (An ``all_reduce`` of per-rank sums would round in the backend's order:
    the step would differ from the one-process one in the last bits, which
    Adam and the surgery's thresholds carry further; on a CPU run 3 of
    9.5K anchors came out otherwise at the first surgery.)"""

    def dp_step(model: Model, stats: DensifyStats, cams: CameraArrays,
                gt_images, gt_depths, idx, *, phase: int, track_stats: bool,
                noise: list | None = None):
        views = [(CameraArrays(*(x[int(i)] for x in cams)),
                  gt_images[int(i)], gt_depths[int(i)]) for i in idx]
        if noise is None:
            noise = [draw_noise(decoded_rows(model, cfg), cfg, phase,
                                generator, model.state.device)
                     for _ in views]
        return _dp_step_core(cfg, intr, optimizer, bg, model, stats, views,
                             phase, track_stats, noise, mesh)

    return dp_step


def _dp_step_core(cfg: GSConfig, intr: Intrinsics, optimizer: Adam, bg,
                  model: Model, stats: DensifyStats, views: list,
                  phase: int, track_stats: bool, noise: list, mesh=None):
    B = len(views)
    data = tile = None
    if mesh is not None:
        from ..parallel.mesh import shard_batch
        data, tile = mesh.axis('data'), mesh.axis('tile')
        views, noise = shard_batch(views, mesh), shard_batch(noise, mesh)
    params = [t for _, _, t in optimizer.params]
    n_child = decoded_rows(model, cfg) * model.state.n_offsets
    # one row a view: its flat parameter gradient, its StepMetrics scalars
    # and, with the statistics, its densify inputs
    rows = []
    for (cam, gt_i, gt_d), nz in zip(views, noise):
        with span("train.prefilter"):
            vis = prefilter_anchors(model, intr, cam)
        m2d = torch.zeros((n_child * 2,), device=vis.device,
                          requires_grad=True)
        loss_b, aux, res = view_loss(cfg, intr, bg, model, vis, m2d, cam,
                                     gt_i, gt_d, phase, nz, tile)
        grads = _gradients(loss_b, params + [m2d])
        row = [torch.cat([g.reshape(-1) for g in grads[:-1]]),
               *view_record(loss_b, aux, res, vis)]
        if track_stats:
            row += [*stats_args(None, res, vis, grads[-1])[1:],
                    res.visible_idx]
        rows.append(row)
    if data is not None:
        rows = gather_rows(data, rows)
    with torch.no_grad():
        total = rows[0][0]
        for r in rows[1:]:
            total = total + r[0]
        total = total / B
        g_params = [f.view_as(p) for f, p in zip(
            total.split([p.numel() for p in params]), params)]
        loss = torch.mean(torch.stack([r[1] for r in rows]))
    ok = _update(optimizer, loss, g_params)
    n_rec = len(StepMetrics._fields)
    if track_stats:
        with span("train.stats"):
            for r in rows:
                stats = densify.accumulate_stats(
                    stats, *r[n_rec:n_rec + 5], intr.width, intr.height,
                    anchor_idx=r[n_rec + 5])
    return model, stats, batch_metrics(loss, [r[1:n_rec] for r in rows], ok)


def stats_args(stats: DensifyStats, res, visible, g_m2d) -> tuple:
    """``accumulate_stats``'s per-view arguments of one view's render."""
    return (stats, res.dec.neural_opacity.detach(), res.dec.valid,
            res.proj.valid, visible, g_m2d)


def view_record(loss, aux: dict, res, visible) -> list:
    """One view's scalars, in ``StepMetrics`` order (without ``skipped``)."""
    return [loss.detach(), aux['loss_rgb'], aux['loss_dep_value'],
            aux['loss_dep_domin'], aux['loss_dep_smooth'],
            res.rate.bit_per_param, aux['psnr'], torch.sum(visible),
            res.bins.tile_overflow, res.bins.pair_overflow,
            res.bins.packed_overflow, res.bins.num_pairs]


def batch_metrics(loss, records: list, ok) -> StepMetrics:
    """A batch's ``StepMetrics`` from its views' ``view_record``s in view
    order: ``loss`` the batch's, the overflow counters' maxima and the
    other values' means (loop.py:257-269)."""
    cols = list(zip(*records))

    def mean(xs):
        return torch.mean(torch.stack([x.detach().to(torch.float32)
                                       for x in xs]))
    values = {f: (torch.amax(torch.stack(c)) if f.endswith('_overflow')
                  else mean(c))
              for f, c in zip(StepMetrics._fields[1:], cols[1:])}
    return StepMetrics(loss=loss.detach(), **values,
                       skipped=(~ok).to(torch.int32))


def gather_rows(axis, rows: list) -> list:
    """This rank's rows (lists of tensors, or None, of the same shapes and
    dtypes on every rank) -> every rank's rows in rank order, from one
    ``all_gather`` of their bytes."""
    if axis.group is None:
        return rows
    parts = [t.detach().reshape(-1).view(torch.uint8) for row in rows
             for t in row if t is not None]
    # each tensor starts on an 8-byte boundary, so its bytes view back
    sizes = [(p.numel() + 7) // 8 * 8 for p in parts]
    buf = torch.zeros(sum(sizes), dtype=torch.uint8, device=parts[0].device)
    for p, off in zip(parts, np.cumsum([0] + sizes[:-1])):
        buf[off:off + p.numel()] = p
    out = []
    for got in axis.all_gather(buf):
        off = 0
        for row in rows:
            new = []
            for t in row:
                if t is None:
                    new.append(None)
                    continue
                nbytes = t.numel() * t.element_size()
                new.append(got[off:off + nbytes].view(t.dtype)
                           .view(t.shape))
                off += (nbytes + 7) // 8 * 8
            out.append(new)
    return out


# --- the device loop ---------------------------------------------------------

STAMP_SLOTS = 128             # stamps a step can hold (a phase-2 step: ~60)


class LoopBuffers(NamedTuple):
    """The static tensors of the device loop, which a captured step reads
    and writes at the step counter."""
    cams: CameraArrays        # the run's cameras, stacked [N, ...]
    gt_images: torch.Tensor   # [N, H, W, 3]
    gt_depths: torch.Tensor   # [N, H, W]
    cam_idx: torch.Tensor     # [max_chunk] int64: the chunk's camera draws
    counter: torch.Tensor     # [1] int64: the chunk's step
    scalars: torch.Tensor     # [max_chunk, S] float32: Adam.scalar_table
    metrics: torch.Tensor     # [max_chunk, 13] float64: StepMetrics rows
    stamps: torch.Tensor      # [max_chunk, STAMP_SLOTS] int64: the steps'
                              # device stamps (utils.profiling.StepStamps)


def stack_views(cameras) -> tuple[CameraArrays, torch.Tensor, torch.Tensor]:
    """``Trainer.run``'s (CameraArrays, gt_image, gt_depth) list -> the
    cameras, the images and the depths, each stacked on a leading axis (all
    views share the image shape)."""
    cams = CameraArrays(*(torch.stack(xs) for xs in
                          zip(*[c for c, _, _ in cameras])))
    return (cams, torch.stack([g for _, g, _ in cameras]),
            torch.stack([d for _, _, d in cameras]))


def loop_buffers(cameras, max_chunk: int, optimizer: Adam) -> LoopBuffers:
    cams, gt_images, gt_depths = stack_views(cameras)
    dev = gt_images.device
    return LoopBuffers(
        cams=cams, gt_images=gt_images, gt_depths=gt_depths,
        cam_idx=torch.zeros((max_chunk,), dtype=torch.int64, device=dev),
        counter=torch.zeros((1,), dtype=torch.int64, device=dev),
        scalars=torch.zeros((max_chunk, len(optimizer.lr) + 4),
                            dtype=torch.float32, device=dev),
        metrics=torch.zeros((max_chunk, len(StepMetrics._fields)),
                            dtype=torch.float64, device=dev),
        stamps=torch.zeros((max_chunk, STAMP_SLOTS), dtype=torch.int64,
                           device=dev))


def loop_step(cfg: GSConfig, intr: Intrinsics, optimizer: Adam, bg,
              generator: torch.Generator, model: Model,
              stats: DensifyStats, buf: LoopBuffers, stamps: StepStamps,
              phase: int, track_stats: bool) -> None:
    """One step of the device loop (the body of JAX's ``make_train_scan``,
    loop.py:315-324): the step at ``buf.counter`` takes its camera from
    ``buf.cam_idx``, its decode noise from ``generator`` and Adam's scalars
    from ``buf.scalars``; it updates the leaves, the moments and (with
    ``track_stats``) the statistics in place, writes its ``StepMetrics``
    into its row of ``buf.metrics`` and advances the counter. Its spans
    (all inside ``train.step``) write their stamps into its row of
    ``buf.stamps`` (``stamps``, over ``buf.stamps`` and ``buf.counter``).
    Nothing in it waits for the host, so a CUDA graph can capture it."""
    i = buf.counter
    with stamps.step():
        ci = buf.cam_idx.index_select(0, i)
        cam = CameraArrays(*(x.index_select(0, ci)[0] for x in buf.cams))
        noise = (draw_noise(decoded_rows(model, cfg), cfg, phase, generator,
                            model.state.device) if phase > 0 else None)
        _, new_stats, metrics = _step_core(
            cfg, intr, optimizer, bg, model, stats, cam,
            buf.gt_images.index_select(0, ci)[0],
            buf.gt_depths.index_select(0, ci)[0], phase, track_stats, noise,
            scalars=buf.scalars.index_select(0, i)[0])
        with torch.no_grad():
            if track_stats:
                for old, new in zip(stats, new_stats):
                    old.copy_(new)
            row = torch.stack([m.to(torch.float64) for m in metrics])
            buf.metrics.index_copy_(0, i, row[None])
    with torch.no_grad():
        buf.counter.add_(1)


class StepGraph:
    """One captured step: the graph, its stamps' slots (``slots``, the
    capture's ``StepStamps.table``) and which of them it kept (``kept``:
    the stamps that followed another with no work between left it), and
    what a report of the device loop
    reads (its phase and track_stats, the eager step it was captured after,
    the host seconds the capture took, each kernel's launches recorded in
    it, its nodes (``utils.profiling.graph_kernels``: by type, the stamps,
    and the kernels by span), how many times it was replayed, and the
    device ms of those replays, from CUDA events around each run of
    replays)."""

    def __init__(self, graph, phase: int, track_stats: bool, step: int,
                 capture_s: float, launches: dict, slots: tuple,
                 kept: tuple, nodes: dict):
        self.graph = graph
        self.slots, self.kept = slots, kept
        self.record = dict(phase=phase, track_stats=track_stats, step=step,
                           capture_s=capture_s, launches=launches,
                           nodes=nodes, replays=0, replay_ms=0.0)
        self._events = []

    def replay(self, n: int) -> None:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(n):
            self.graph.replay()
        end.record()
        self._events.append((start, end))
        self.record['replays'] += n

    def settle(self) -> None:
        """Add the ms of the replays recorded so far to ``replay_ms``
        (waiting for the last of them, which the caller usually has)."""
        for start, end in self._events:
            end.synchronize()
            self.record['replay_ms'] += start.elapsed_time(end)
        self._events.clear()


def capture_train_step(step_fn, generator: torch.Generator, phase: int,
                       track_stats: bool, step: int,
                       stamps: StepStamps) -> StepGraph:
    """Record ``step_fn`` (a ``loop_step`` with its arguments bound, its
    stamps ``stamps``) as a CUDA graph on the current stream, with a memory
    pool of its own: the port's ``make_train_scan``. ``generator`` (the
    decode noise's) is registered with the graph, so each replay draws at
    the generator's offset of the moment and advances it, as an eager step
    does. Before the graph is instantiated its nodes are counted and the
    stamps with no work since the one before them are taken out (each ~2
    us of the replay's chain). A failed capture raises."""
    from ..ops.cuda.stamp import drop_stamps, graph_census
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    graph.register_generator_state(generator)
    before = launch_counts()
    t0 = time.perf_counter()
    graph.capture_begin()
    try:
        step_fn()
    except BaseException:
        # end the capture so the stream leaves capture mode, then raise
        with contextlib.suppress(RuntimeError):
            graph.capture_end()
        raise
    graph.capture_end()
    capture_s = time.perf_counter() - t0
    census = graph_census(graph.raw_cuda_graph())
    idle = idle_stamps(census)
    drop_stamps(graph.raw_cuda_graph(), idle, len(stamps.table))
    nodes = graph_kernels(census, stamps.table, idle)
    graph.instantiate()
    launches = {k: v - before[k] for k, v in launch_counts().items()}
    kept = tuple(s not in idle for s in range(len(stamps.table)))
    return StepGraph(graph, phase, track_stats, step, capture_s, launches,
                     stamps.table, kept, nodes)


class ChunkStamps(NamedTuple):
    """A chunk's stamp rows on their way to the host: their slots'
    ``table`` (the replayed graph's, or the eager step's where none
    replayed) and which of them the graph kept (``kept``; None: every
    one), the steps that ran eagerly, the first stamped row (``first``:
    the replays on the card, every step on the CPU, where each runs
    eagerly), and ``rows`` (``copied``: a host tensor, pinned on the card,
    that a copy behind the chunk's end event fills)."""
    table: tuple
    kept: tuple | None
    eager: int
    first: int
    rows: torch.Tensor | None = None

    def copied(self, stamps: torch.Tensor) -> ChunkStamps:
        """With the rows ``stamps`` (the chunk's, on its device) copied."""
        if stamps.device.type != "cuda":
            return self._replace(rows=stamps.clone())
        rows = torch.empty(stamps.shape, dtype=stamps.dtype, pin_memory=True)
        rows.copy_(stamps, non_blocking=True)
        return self._replace(rows=rows)

    def read(self) -> np.ndarray:
        """The copied rows (once the chunk's end event has passed), each
        column the graph left taking the one before it."""
        rows = self.rows.numpy()
        if self.kept is None:
            return rows
        return np.concatenate([rows[:self.first],
                               fill_dropped(rows[self.first:], self.kept)])


class ChunkTimer:
    """What a report of the device loop reads about one chunk (``record``):
    its first and last step, phase, track_stats and capacity, the graphs
    captured in it, its eager steps, whether a surgery ended it, its ms
    with that surgery (CUDA events on the current stream on the card; the
    host's clock on the CPU), on the card the peak memory allocated in it
    (``torch.cuda``'s peak statistic, reset when the chunk starts), and
    what its device stamps and host spans give (``stamped``, ``placed``):

    - ``span_ms``: each span's device self time, in ms summed over the
      ``stamped_steps`` (the chunk's replays on the card, every step on
      the CPU), by the span's path (``utils.profiling.StepStamps``:
      ``train.step/train.backward/render.decode`` is remat's recompute of
      the decode);
    - ``step_gap_ms``: from each stamped step's last stamp to the next
      one's first, summed;
    - ``boundary_idle_ms``: from the run's previous chunk's last stamp to
      this chunk's first (None in a run's first chunk);
    - ``host_ms``: each host span's self ms in the chunk (``loop.*``), and
      ``unnamed``: the ms of the boundary that no host span covers;
    - ``stamps_ns``: the chunk's first and last stamps (the device's
      clock), and ``clock_offset_ns``: CLOCK_MONOTONIC less that clock,
      one a run, which places the stamps beside the trainer's ``spans``."""

    def __init__(self, device: torch.device, graphs_before: int, **record):
        self.record = dict(record, captures=0, eager_steps=0, surgery=False,
                           ms=None, peak_mem_bytes=None,
                           span_ms={}, stamped_steps=0, step_gap_ms=None,
                           boundary_idle_ms=None, host_ms={},
                           clock_offset_ns=None, stamps_ns=None)
        self._graphs_before = graphs_before
        self._cuda = device.type == "cuda"
        self._waited = not self._cuda
        if self._cuda:
            torch.cuda.reset_peak_memory_stats(device)
            self._events = [torch.cuda.Event(enable_timing=True)
                            for _ in range(2)]
            self._events[0].record()
        self._device = device
        self._t0 = time.perf_counter()

    def stop(self, graphs_after: int, eager_steps: int,
             surgery: bool) -> None:
        self.record.update(captures=graphs_after - self._graphs_before,
                           eager_steps=eager_steps, surgery=surgery)
        if self._cuda:
            self._events[1].record()
            self.record['peak_mem_bytes'] = torch.cuda.max_memory_allocated(
                self._device)
        else:
            self.record['ms'] = 1e3 * (time.perf_counter() - self._t0)

    def wait(self) -> None:
        """Wait for the chunk's device work (on the card; on the CPU it
        has run)."""
        if not self._waited:
            self._events[1].synchronize()
            self._waited = True

    def settle(self) -> None:
        self.wait()
        if self._cuda:
            self.record['ms'] = self._events[0].elapsed_time(self._events[1])

    def stamped(self, rows: np.ndarray, table: tuple, stamped_from: int,
                prev_last_ns: int | None) -> None:
        """The chunk's stamp rows (one a step, in order; the stamped steps
        from ``stamped_from`` on), their slots' ``table`` and the run's
        previous chunk's last stamp."""
        t = step_times(rows[stamped_from:], table)
        first, last = int(rows[0, 0]), int(rows[-1, len(table) - 1])
        self.record.update(
            span_ms=t["span_ms"], stamped_steps=t["stamped_steps"],
            step_gap_ms=t["step_gap_ms"], stamps_ns=[first, last],
            boundary_idle_ms=(None if prev_last_ns is None
                              else (first - prev_last_ns) / 1e6))

    def placed(self, offset_ns: int, named_ms: float | None) -> None:
        """The run's clock offset, and how much of the boundary host spans
        cover (None without a boundary)."""
        self.record['clock_offset_ns'] = offset_ns
        if named_ms is not None:
            self.record['host_ms']['unnamed'] = max(
                0.0, self.record['boundary_idle_ms'] - named_ms)


class Trainer:
    """Host-side orchestration of the optimization (loop.py:333-508), on one
    device. The model's leaves are trained in place, until a densification
    step grows the capacity and replaces them.

    ``dp_batch=B`` makes every step a batch of B views with the mean loss
    (``make_dp_train_step``), on this one device; ``run`` then takes that
    path whatever ``device_loop`` says, as the JAX trainer does.

    ``mesh`` (a ``parallel.mesh.Mesh`` over ranks that each build this
    trainer with the same arguments; loop.py:336-370) makes the batched
    step data parallel: ``dp_batch`` defaults to the data axis' size and
    must divide by it, and the model's leaves are broadcast from rank 0.
    The ranks keep the same state bit for bit. ``save`` writes from rank 0
    only and returns once the file is there; every rank ``restore``s."""

    def __init__(self, model: Model, cfg: GSConfig, intr: Intrinsics,
                 voxel_size: float, spatial_lr_scale: float = 1.0,
                 bg: np.ndarray | None = None, seed: int = 0,
                 device: str = "cuda", dp_batch: int | None = None,
                 mesh=None):
        dev = resolve_device(device)
        if model.state.device != dev:
            raise ValueError(f"model lives on {model.state.device}, "
                             f"training requested on {dev}")
        if mesh is not None:
            data = mesh.shape['data']
            dp_batch = dp_batch or data
            if dp_batch % data:
                raise ValueError(
                    f"dp_batch={dp_batch} must be divisible by the mesh "
                    f"'data' axis size {data}")
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
        self.dp_batch = dp_batch
        self.mesh = mesh
        if mesh is not None:
            from ..parallel.mesh import broadcast_tree
            broadcast_tree(self._leaves(), mesh)
        self.dp_step_fn = (make_dp_train_step(cfg, intr, self.optimizer,
                                              self.bg, self.noise_gen, mesh)
                           if dp_batch else None)
        self.history: list[dict] = []
        self.step = 0
        # the device loop's CUDA graphs by (phase, track_stats), valid for
        # the storages in _graph_key; the side stream they run on; and one
        # record per capture (StepGraph.record), in capture order
        self._graphs: dict = {}
        self._graph_key = None
        self._stream = None
        self._replayed: list = []      # graphs replayed since the last wait
        self.graph_log: list[dict] = []
        # one record per device-loop chunk (ChunkTimer.record), in order,
        # and the chunks whose ms are not read yet
        self.chunk_log: list[dict] = []
        self._timed_chunks: list = []
        # the device loop's host spans (loop.*), kept in memory
        self.spans = Spans()

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
        (its trainer checkpoint holds optax's state and a JAX key). Under a
        mesh rank 0 writes, and every rank returns once it has."""
        if self.mesh is None or self.mesh.rank == 0:
            self._write(path)
        if self.mesh is not None:
            self.mesh.world.all_reduce(torch.zeros(1, device=self.bg.device))

    def _write(self, path: str) -> None:
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
            log_every: int = 100, callback=None, device_loop: bool = False,
            max_chunk: int = 50) -> Model:
        """cameras: list of (CameraArrays, gt_image [H, W, 3], gt_depth
        [H, W]) on the trainer's device. Resumes from ``self.step + 1``.
        A record (every ``log_every`` steps and the last) carries the
        step's metrics, and ``densify_*`` keys when ``adjust_anchor`` ran
        on that step.

        ``device_loop=True`` runs chunks of up to ``max_chunk`` steps (the
        JAX trainer's ``make_train_scan``): on the card a CUDA graph of the
        step replayed back to back, one host read of the metrics a chunk.
        A chunk ends at every phase change, stat-tracking flip, bounds
        refresh and densification step, so the host's work runs where the
        host loop runs it, and the run ends on the host loop's state bit
        for bit. A record inside a chunk is emitted after the chunk, with
        the trainer at the chunk's last step (a checkpoint written from the
        callback holds that step). A capture or replay that fails raises;
        nothing falls back to the host loop. All views must share one
        image shape. Each chunk appends its record to ``chunk_log``
        (``ChunkTimer``; on the card it resets ``torch.cuda``'s peak memory
        statistic when it starts), each capture its own to ``graph_log``."""
        cfg = self.cfg
        iterations = iterations or cfg.iterations
        if self.dp_batch:
            return self._run_dp(cameras, iterations, log_every, callback)
        if device_loop:
            return self._run_device_loop(cameras, iterations, log_every,
                                         callback, max_chunk)
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

    def _run_dp(self, cameras, iterations, log_every, callback) -> Model:
        """The batched host loop (loop.py:510-563): the whole cadence
        (phase, bounds refresh, stat tracking, densify pause and
        ``adjust_anchor``), ``dp_batch`` views a step drawn from the camera
        stream."""
        cfg = self.cfg
        cams, gt_images, gt_depths = stack_views(cameras)
        for it in range(self.step + 1, iterations + 1):
            self.step = it
            idx = self.rng.integers(len(cameras), size=self.dp_batch)
            if it == cfg.context_from_step:
                self.model = self.model._replace(
                    bounds=update_anchor_bounds(self.model.state))
            track = cfg.start_stat < it < cfg.update_until
            self.model, self.stats, metrics = self.dp_step_fn(
                self.model, self.stats, cams, gt_images, gt_depths, idx,
                phase=phase_of_step(it, cfg), track_stats=track)
            info = None
            if self._densify_due(it):
                self.model, self.stats, info = densify.adjust_anchor(
                    self.model, self.stats, self.optimizer, cfg,
                    self.voxel_size, self.densify_rng)
            if it % log_every == 0 or it == iterations:
                self._emit_record(it, metrics._asdict(), info, callback)
        return self.model

    def _chunk_end(self, it: int, iterations: int, max_chunk: int) -> int:
        """Largest end step e >= it such that steps [it, e] share phase and
        track_stats, no bounds-update start falls strictly inside, and any
        densification step lands exactly at e (loop.py:565-588)."""
        cfg = self.cfg
        e = min(iterations, it + max_chunk - 1)
        # phase changes AFTER noise_from_step / context_from_step
        for b in (cfg.noise_from_step, cfg.context_from_step):
            if it <= b:
                e = min(e, b)
        # the bounds refresh must run right before step context_from_step
        if it < cfg.context_from_step:
            e = min(e, cfg.context_from_step - 1)
        # track_stats flips after start_stat and at update_until
        if it <= cfg.start_stat:
            e = min(e, cfg.start_stat)
        elif it < cfg.update_until:
            e = min(e, cfg.update_until - 1)
        # densification (host surgery) may trigger at any multiple of
        # update_interval: make that a chunk end
        nxt = -(-it // cfg.update_interval) * cfg.update_interval
        if nxt <= e:
            e = nxt
        return e

    def _run_device_loop(self, cameras, iterations, log_every, callback,
                         max_chunk) -> Model:
        """The chunked loop (loop.py:590-636). A chunk with a logged step
        ends in one read of its metrics rows (``loop.wait``); only such a
        chunk waits for the device. Each chunk's stamps are copied to the
        host behind its steps and read at the next such wait (the run's
        last chunk logs). The host's work between chunks runs under the
        ``loop.*`` spans of ``self.spans``."""
        cfg = self.cfg
        spans = self.spans
        buf = loop_buffers(cameras, max_chunk, self.optimizer)
        stamps = StepStamps(buf.stamps, buf.counter)
        run = []            # (timer, the wait's return or None) a chunk
        pending = []        # (timer, its ChunkStamps) not yet read
        prev_last = None    # the last stamp of the last chunk read
        first_span = len(spans.records)
        it = self.step + 1
        while it <= iterations:
            chunk_span = len(spans.records)
            phase = phase_of_step(it, cfg)
            if it == cfg.context_from_step:
                with spans.span("loop.bounds"):
                    self.model = self.model._replace(
                        bounds=update_anchor_bounds(self.model.state))
            track = cfg.start_stat < it < cfg.update_until
            e = self._chunk_end(it, iterations, max_chunk)
            timer = ChunkTimer(self.bg.device, first=it, last=e, phase=phase,
                               track_stats=track,
                               capacity=self.model.state.capacity,
                               graphs_before=len(self.graph_log))
            chunk = self._run_chunk(buf, stamps, phase, track, e - it + 1,
                                    len(cameras))
            self.step = e
            info = None
            if self._densify_due(e):
                with spans.span("loop.surgery"):
                    self.model, self.stats, info = densify.adjust_anchor(
                        self.model, self.stats, self.optimizer, cfg,
                        self.voxel_size, self.densify_rng)
            timer.stop(len(self.graph_log), chunk.eager,
                       surgery=info is not None)
            self.chunk_log.append(timer.record)
            self._timed_chunks.append(timer)
            # after the end event, so that a wait for it does not wait for
            # the copy too
            pending.append((timer, chunk.copied(buf.stamps[:e - it + 1])))
            log_its = [s for s in range(it, e + 1)
                       if s % log_every == 0 or s == iterations]
            waited = None
            if log_its:
                with spans.span("loop.wait"):
                    timer.wait()
                    waited = time.perf_counter_ns()
                    rows = buf.metrics.cpu().numpy()
                with spans.span("loop.settle"):
                    self._settle()
                    for t, c in pending:
                        t.stamped(c.read(), c.table, c.first, prev_last)
                        prev_last = t.record['stamps_ns'][1]
                    pending.clear()
                with spans.span("loop.records"):
                    for s in log_its:
                        self._emit_record(
                            s, dict(zip(StepMetrics._fields, rows[s - it])),
                            info if s == e else None, callback)
            timer.record['host_ms'] = spans.self_ms(chunk_span)
            run.append((timer, waited))
            it = e + 1
        self._place(run, first_span)
        return self.model

    def _place(self, run: list, first_span: int) -> None:
        """Put the run's device stamps on CLOCK_MONOTONIC by one offset,
        the least over its chunks that waited of the moment ``loop.wait``'s
        wait for the chunk's end event returns less the chunk's last stamp
        (0 on the CPU), and give each chunk how much of its boundary the
        run's host spans cover."""
        if not run:
            return
        # the plain stamps read the host's clock
        offset = (min(w - t.record['stamps_ns'][1] for t, w in run
                      if w is not None)
                  if self.bg.device.type == "cuda" else 0)
        host = [(r.start_ns, r.end_ns) for r in
                self.spans.records[first_span:] if r.end_ns is not None]
        prev = None
        for timer, _ in run:
            first, last = timer.record['stamps_ns']
            named = None
            if prev is not None:
                named = covered_ns(prev + offset, first + offset, host) / 1e6
            timer.placed(offset, named)
            prev = last

    def _run_chunk(self, buf: LoopBuffers, stamps: StepStamps, phase: int,
                   track: bool, n: int, n_cams: int) -> ChunkStamps:
        """n steps of one phase and track_stats: the camera draws (one
        ``integers`` call a step, as the host loop's) and Adam's scalars
        copied into ``buf`` once, the counter reset, then the steps. On
        the card the first step under a new graph runs eagerly on the side
        stream, the graph is captured there, and it is replayed for the
        rest; on the CPU every step runs eagerly. -> the chunk's stamps
        (their rows not yet copied)."""
        spans = self.spans
        with spans.span("loop.draws"):
            draws = [int(self.rng.integers(n_cams)) for _ in range(n)]
        with spans.span("loop.scalars"):
            scalars = self.optimizer.scalar_table(n)
        with spans.span("loop.stage"):
            buf.cam_idx[:n].copy_(torch.tensor(draws, dtype=torch.int64))
            buf.scalars[:n].copy_(torch.from_numpy(scalars))
            buf.counter.zero_()
        step_fn = functools.partial(
            loop_step, self.cfg, self.intr, self.optimizer, self.bg,
            self.noise_gen, self.model, self.stats, buf, stamps, phase, track)
        dev = self.bg.device
        if dev.type != "cuda":
            with spans.span("loop.eager"):
                for _ in range(n):
                    step_fn()
            out = ChunkStamps(stamps.table, None, n, 0)
        else:
            out = self._replay_chunk(step_fn, buf, stamps, phase, track, n)
        self.optimizer.count += n
        return out

    def _replay_chunk(self, step_fn, buf, stamps, phase, track,
                      n) -> ChunkStamps:
        """The chunk's steps on the card -> the chunk's stamps."""
        dev = self.bg.device
        spans = self.spans
        with spans.span("loop.enqueue"):
            key = self._storage_key(buf)
            if key != self._graph_key:
                # the host replaced a tensor that a graph reads (the bounds
                # refresh, adjust_anchor, restore, a new run's views): drop
                # every graph, so that their memory pools go with them (the
                # copies into ``buf`` above waited for their replays)
                self._settle()
                self._graphs.clear()
                self._graph_key = key
            if self._stream is None:
                self._stream = torch.cuda.Stream(device=dev)
            main = torch.cuda.current_stream(dev)
            self._stream.wait_stream(main)
            with torch.cuda.stream(self._stream):
                graph = self._graphs.get((phase, track))
                done = 0
                if graph is None:
                    # the first step under a new graph runs eagerly: it
                    # warms up what a capture needs (kernels, constants,
                    # workspaces)
                    with spans.span("loop.eager"):
                        step_fn()
                    done = 1
                    if n > 1:
                        with spans.span("loop.capture"):
                            graph = capture_train_step(
                                step_fn, self.noise_gen, phase, track,
                                self.step + 1, stamps)
                        self._graphs[phase, track] = graph
                        self.graph_log.append(graph.record)
                if n > done:
                    graph.replay(n - done)
                    self._replayed.append(graph)
            main.wait_stream(self._stream)
        if n > done:
            return ChunkStamps(graph.slots, graph.kept, done, done)
        return ChunkStamps(stamps.table, None, done, done)

    def _settle(self) -> None:
        """Read the ms of the replays and chunks run since the last call
        into their records, and let go of the graphs replayed."""
        for graph in self._replayed:
            graph.settle()
        self._replayed.clear()
        for timer in self._timed_chunks:
            timer.settle()
        self._timed_chunks.clear()

    def _leaves(self) -> list:
        """The model's tensors: the state's leaves, the heads' parameters,
        the hash tables and the bounds."""
        m = self.model
        return [*m.state.flat_leaves().values(), *m.heads.parameters(),
                *m.grid.values(), *m.bounds]

    def _storage_key(self, buf: LoopBuffers) -> tuple:
        """The address and shape of every tensor a captured step reads or
        writes in place: the model's leaves, Adam's moments, the
        statistics and the loop's buffers."""
        tensors = [*self._leaves(), *self.optimizer.m, *self.optimizer.v,
                   *self.stats, *buf.cams, buf.gt_images, buf.gt_depths,
                   buf.cam_idx, buf.counter, buf.scalars, buf.metrics,
                   buf.stamps]
        return tuple((t.data_ptr(), tuple(t.shape)) for t in tensors)

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

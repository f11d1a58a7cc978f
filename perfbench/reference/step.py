"""The training step, plain: the loss stack, the gradients, the non-finite
skip, the 13-group Adam and the densify statistics, over the plain copies
of the decode, projection, binning and blend beside this file.

``follow`` builds a model from the benchmark's weights and takes the first
steps of a run from them, on the cameras the run's draws pick, with the
decode noise drawn from a generator seeded as the run's trainer seeds its
own. It computes everything again from the inputs: the anchor bounds, the
visible set, the compaction, the bins, the blend and its gradient."""
from __future__ import annotations

import torch

from . import losses
from .anchors import AnchorState, update_anchor_bounds
from .config import GSConfig
from .decode import draw_noise
from .densify import accumulate_stats, init_stats
from .heads import Heads
from .model import Model, mix_spec
from .optim import Adam, make_trainable
from .render import prefilter_anchors, render


def compute_losses(res, gt_image, gt_depth, cfg: GSConfig):
    """L1 + DSSIM, the scaling regularizer, the entropy rate and the
    depth-prior regularizers."""
    image = res.out.color
    l1 = losses.l1_loss(image, gt_image)
    loss = ((1.0 - cfg.lambda_dssim) * l1
            + cfg.lambda_dssim * (1.0 - losses.ssim(image, gt_image)))
    s = res.dec.scaling
    scaling_reg = torch.mean(torch.where(
        res.dec.valid, s[:, 0] * s[:, 1] * s[:, 2], 0.0))
    loss = loss + cfg.lambda_scaling_reg * scaling_reg
    loss = loss + cfg.lambda_entropy * res.rate.bit_per_param
    if cfg.use_dpr:
        gt_d = losses.minmax_normalize(gt_depth)
        rd = losses.minmax_normalize(res.out.depth)
        loss = loss + cfg.lambda_dep_value * losses.huber_l1_edge_aware(
            rd, gt_d, gt_image)
        loss = loss + cfg.lambda_dep_domin * losses.cmd(
            rd[None], gt_d[None, None], normalized=cfg.cmd_normalized)
        loss = loss + cfg.lambda_dep_smooth * losses.bilateral_smoothness(rd)
    return loss


def decoded_rows(capacity: int, cfg: GSConfig) -> int:
    if cfg.visible_capacity is not None and capacity > cfg.visible_capacity:
        return cfg.visible_capacity
    return capacity


def build_model(weights: dict, cfg: GSConfig, device) -> Model:
    """``weights``: the flat anchor leaves under ``state.<field>``, the
    heads' parameters under ``heads.<name>``, the hash tables under
    ``grid.<name>``."""
    state = AnchorState(**{f: weights[f'state.{f}'].to(device).clone()
                           for f in AnchorState._fields})
    heads = Heads(cfg.feat_dim, cfg.n_offsets, mix_spec(cfg).output_dim,
                  torch.Generator(), device, cfg.use_feat_bank,
                  cfg.color_mode, cfg.sh_degree)
    heads.load_state_dict({k[len('heads.'):]: v.to(device)
                           for k, v in weights.items()
                           if k.startswith('heads.')})
    grid = {k[len('grid.'):]: v.to(device).clone()
            for k, v in weights.items() if k.startswith('grid.')}
    return Model(state=state, heads=heads, grid=grid,
                 bounds=update_anchor_bounds(state))


def follow(weights: dict, cfg: GSConfig, intr, bg: torch.Tensor,
           views: list, draws: list, noise_seed: int, phase: int,
           track_stats: bool, start: int, spatial_lr_scale: float,
           device) -> dict:
    """Steps ``start + 1`` to ``start + len(draws)`` from ``weights``, view
    ``draws[i]`` of ``views`` (CameraArrays, image, depth) at step i ->
    ``loss`` (one float a step), ``grad`` (the first step's gradient of
    each trained leaf, by name, as Adam receives it), ``params`` (each
    trained leaf after the last step), ``stats1`` and ``stats`` (the
    statistics after the first step and after the last, with them), ``visible`` (the visible anchors of each step) and
    ``skipped`` (whether each step's update was skipped)."""
    model = make_trainable(build_model(weights, cfg, device))
    opt = Adam(cfg, spatial_lr_scale, model)
    opt.count = start
    names = [n for n, _, _ in opt.params]
    params = [t for _, _, t in opt.params]
    stats = init_stats(model.state.capacity, cfg.n_offsets, device)
    gen = torch.Generator(device=device).manual_seed(noise_seed)
    rows = decoded_rows(model.state.capacity, cfg)
    out = {'loss': [], 'visible': [], 'grad': None, 'skipped': []}
    for ci in draws:
        cam, gt_image, gt_depth = views[ci]
        noise = draw_noise(rows, cfg, phase, gen, device)
        visible = prefilter_anchors(model, intr, cam)
        m2d = torch.zeros((rows * cfg.n_offsets * 2,), device=device,
                          requires_grad=True)
        with torch.enable_grad():
            res = render(model, intr, cam, cfg, phase=phase, mode='train',
                         bg=bg, visible=visible, mean2d_offset=m2d,
                         noise=noise)
            loss = compute_losses(res, gt_image, gt_depth, cfg)
            grads = torch.autograd.grad(loss, params + [m2d],
                                        allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(params + [m2d], grads)]
        g_m2d = grads.pop()
        with torch.no_grad():
            gsum = sum(torch.sum(torch.abs(g)) for g in grads)
            ok = torch.isfinite(loss) & torch.isfinite(gsum)
            grads = [torch.where(ok, g, 0.0) for g in grads]
            first = out['grad'] is None
            if first:
                out['grad'] = {n: g.detach().clone()
                               for n, g in zip(names, grads)}
            opt.step(grads)
        if track_stats:
            stats = accumulate_stats(
                stats, res.dec.neural_opacity.detach(), res.dec.valid,
                res.proj.valid, visible, g_m2d, intr.width, intr.height,
                anchor_idx=res.visible_idx)
            if first:
                out['stats1'] = {k: v.clone() for k, v in
                                 stats._asdict().items()}
        out["loss"].append(float(loss.detach()))
        out["skipped"].append(not bool(ok))
        out['visible'].append(int(visible.sum()))
        del res, grads, g_m2d
    out['params'] = {n: t.detach().clone() for n, t in zip(names, params)}
    out['stats'] = stats._asdict() if track_stats else None
    return out


"""Optimizer: 13 parameter groups, each an Adam (eps 1e-15) with its own
log-lerp learning-rate schedule.

The port of ``bloomscene_tpu/train/optim.py`` (the reference's single
Adam with per-group scheduled learning rates, gaussian_model.py:482-615,
as an ``optax.multi_transform``). The update is written out rather than
taken from ``torch.optim.Adam``, so that it follows optax step for step:

- every group counts every update, zero gradients included (a leaf the
  loss does not reach, such as the hash grid in phase 0, still advances
  its bias correction);
- the schedule is read at the count before the increment, so the first
  update uses ``lr(0)``; the bias corrections use the count after it;
- ``m = (1 - b1) g + b1 m``, ``v = (1 - b2) g^2 + b2 v``,
  ``p += -lr * m_hat / (sqrt(v_hat) + eps)``.

The device loop (``train/loop.py``) replays a CUDA graph of the step,
which would bake one step's Python floats into every replay. For it,
``scalar_table`` computes a chunk's learning rates and bias corrections
on the host, in float32 exactly as ``step`` does, and ``step(grads,
scalars=row)`` reads them from a device row of that table and leaves the
count to the caller.

``rotation``, ``opacity_raw``, ``alive`` and the anchor bounds are the
``FROZEN`` group: never updated, as the reference's requires_grad_(False)
parameters (:477-478). Parameters and moments are updated in place.
Densification's ``anchor_surgery`` zeroes the moments of changed anchor
slots and pads them when the capacity grows (densify.py:315-352).
"""
from __future__ import annotations

import numpy as np
import torch

from .config import GSConfig
from .model import Model
from .schedules import expon_lr

FROZEN = 'frozen'
B1, B2, EPS = 0.9, 0.999, 1e-15
STATE_GROUPS = {'anchor': 'anchor', 'offset': 'offset', 'mask_logit': 'mask',
                'feat': 'anchor_feat', 'scaling_log': 'scaling',
                'rotation': FROZEN, 'opacity_raw': FROZEN, 'alive': FROZEN}
# the groups whose leaves hold one row per anchor slot
PER_ANCHOR_GROUPS = ('anchor', 'offset', 'mask', 'anchor_feat', 'scaling',
                     FROZEN)
HEAD_GROUPS = {'opacity': 'mlp_opacity', 'cov': 'mlp_cov',
               'color': 'mlp_color', 'grid': 'mlp_grid',
               'deform': 'mlp_deform', 'feature_bank': 'mlp_featurebank'}


def schedules(cfg: GSConfig, spatial_lr_scale: float = 1.0) -> dict:
    """Group name -> lr(count) for the 12 trained groups."""
    s = spatial_lr_scale

    def sched(prefix, scale=1.0):
        return expon_lr(getattr(cfg, f'{prefix}_lr_init') * scale,
                        getattr(cfg, f'{prefix}_lr_final') * scale,
                        lr_delay_mult=getattr(cfg, f'{prefix}_lr_delay_mult'),
                        max_steps=getattr(cfg, f'{prefix}_lr_max_steps'))

    def const(lr):
        return lambda count: torch.tensor(lr, dtype=torch.float32)

    return {
        'anchor': sched('position', s), 'offset': sched('offset', s),
        'mask': sched('mask', s), 'anchor_feat': const(cfg.feature_lr),
        'scaling': const(cfg.scaling_lr),
        'mlp_opacity': sched('mlp_opacity'), 'mlp_cov': sched('mlp_cov'),
        'mlp_color': sched('mlp_color'), 'mlp_grid': sched('mlp_grid'),
        'mlp_deform': sched('mlp_deform'),
        'encoding_xyz': sched('encoding_xyz'),
        'mlp_featurebank': sched('mlp_featurebank')}


def _unbias(x: torch.Tensor, bc, inv_bc) -> torch.Tensor:
    """``x / bc`` as the update divides by a Python float ``bc`` (when
    ``inv_bc`` is None), or the same bits from the device scalars ``bc``
    and ``inv_bc`` (its float32 reciprocal): torch divides a CUDA tensor
    by a host float as a product with the float's float32 reciprocal, and
    a CPU tensor by true division."""
    if inv_bc is None:
        return x / bc
    return x * inv_bc if x.is_cuda else x / bc


def make_trainable(model: Model) -> Model:
    """The same model with every trained leaf requiring grad: the anchor
    state's trained leaves become new leaf tensors on the same storage, the
    heads' and hash tables' parameters are switched on. Frozen leaves stay
    as they are."""
    st = model.state
    leaves = {f: (t if STATE_GROUPS[f] == FROZEN
                  else t.detach().requires_grad_(True))
              for f, t in st.flat_leaves().items()}
    model.heads.requires_grad_(True)
    grid = {k: v.detach().requires_grad_(True) for k, v in model.grid.items()}
    return model._replace(state=st._replace(**leaves), grid=grid)


def param_groups(model: Model) -> list[tuple[str, str, torch.Tensor]]:
    """(leaf name, group, tensor) for every trained leaf, in a fixed order:
    the anchor state, the heads, the hash tables."""
    out = [(f'state.{f}', STATE_GROUPS[f], t)
           for f, t in model.state.flat_leaves().items()
           if STATE_GROUPS[f] != FROZEN]
    for name, module in model.heads.named_children():
        out += [(f'heads.{name}.{p}', HEAD_GROUPS[name], t)
                for p, t in module.named_parameters()]
    out += [(f'grid.{k}', 'encoding_xyz', t) for k, t in model.grid.items()]
    return out


class Adam:
    """Per-group Adam over ``param_groups(model)`` (see the module
    docstring). ``step(grads)`` takes one gradient per trained leaf, in
    ``self.params`` order, and updates the leaves in place."""

    def __init__(self, cfg: GSConfig, spatial_lr_scale: float, model: Model):
        self.lr = schedules(cfg, spatial_lr_scale)
        self.params = param_groups(model)
        self.m = [torch.zeros_like(t) for _, _, t in self.params]
        self.v = [torch.zeros_like(t) for _, _, t in self.params]
        self.count = 0

    def _scalars(self, count: int) -> tuple[dict, float, float]:
        """The learning rate of each group and the bias corrections of the
        update that takes the count from ``count`` to ``count + 1``:
        float32 values (as optax computes them) held in Python floats."""
        lrs = {g: float(fn(count)) for g, fn in self.lr.items()}
        f32 = torch.float32
        bc1 = float(1 - torch.tensor(B1, dtype=f32) ** (count + 1))
        bc2 = float(1 - torch.tensor(B2, dtype=f32) ** (count + 1))
        return lrs, bc1, bc2

    def scalar_table(self, n: int) -> np.ndarray:
        """[n, len(self.lr) + 4] float32: for each of the next ``n``
        updates (from ``self.count`` on), the groups' learning rates in
        ``self.lr`` order, then bc1, bc2, and their float32 reciprocals.
        A row on the device is what ``step(grads, scalars=row)`` reads."""
        rows = []
        for count in range(self.count, self.count + n):
            lrs, bc1, bc2 = self._scalars(count)
            inv = np.float32(1.0) / np.float32([bc1, bc2])
            rows.append([*lrs.values(), bc1, bc2, *inv])
        return np.asarray(rows, np.float32).reshape(n, len(self.lr) + 4)

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor],
             scalars: torch.Tensor | None = None) -> None:
        """One update. ``scalars``, a row of ``scalar_table`` on the
        parameters' device, gives the learning rates and bias corrections
        in place of the ones from ``self.count``, which is then left as it
        is: the caller counts the updates."""
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} gradients for "
                             f"{len(self.params)} parameters")
        if scalars is None:
            # Python floats: no host-to-device copy stalls the stream
            lrs, bc1, bc2 = self._scalars(self.count)
            inv1 = inv2 = None
            self.count += 1
        else:
            lrs = dict(zip(self.lr, scalars.unbind(0)))
            bc1, bc2, inv1, inv2 = scalars[len(self.lr):].unbind(0)
        for (_, group, p), g, m, v in zip(self.params, grads, self.m,
                                          self.v):
            m.copy_((1 - B1) * g + B1 * m)
            v.copy_((1 - B2) * (g * g) + B2 * v)
            u = (_unbias(m, bc1, inv1)
                 / (torch.sqrt(_unbias(v, bc2, inv2)) + EPS))
            p.add_(-lrs[group] * u)

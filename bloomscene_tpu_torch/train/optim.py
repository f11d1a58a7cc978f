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

``rotation``, ``opacity_raw``, ``alive`` and the anchor bounds are the
``FROZEN`` group: never updated, as the reference's requires_grad_(False)
parameters (:477-478). Parameters and moments are updated in place.
Densification's ``anchor_surgery`` zeroes the moments of changed anchor
slots and pads them when the capacity grows (densify.py:315-352).
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import GSConfig
from ..models.model import Model
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

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor]) -> None:
        if len(grads) != len(self.params):
            raise ValueError(f"{len(grads)} gradients for "
                             f"{len(self.params)} parameters")
        # the scalars are float32 values (as optax computes them) held in
        # Python floats, so no host-to-device copy stalls the stream
        lrs = {g: float(fn(self.count)) for g, fn in self.lr.items()}
        self.count += 1
        f32 = torch.float32
        bc1 = float(1 - torch.tensor(B1, dtype=f32) ** self.count)
        bc2 = float(1 - torch.tensor(B2, dtype=f32) ** self.count)
        for (_, group, p), g, m, v in zip(self.params, grads, self.m,
                                          self.v):
            m.copy_((1 - B1) * g + B1 * m)
            v.copy_((1 - B2) * (g * g) + B2 * v)
            u = (m / bc1) / (torch.sqrt(v / bc2) + EPS)
            p.add_(-lrs[group] * u)

    def state_arrays(self) -> dict:
        """The moments and count as numpy arrays: ``m.<leaf name>``,
        ``v.<leaf name>`` (the port's shapes) and ``count``."""
        out = {'count': np.asarray(self.count, np.int64)}
        for (name, _, _), m, v in zip(self.params, self.m, self.v):
            out[f'm.{name}'] = m.detach().cpu().numpy()
            out[f'v.{name}'] = v.detach().cpu().numpy()
        return out

    @torch.no_grad()
    def load_state_arrays(self, model: Model, arrays) -> None:
        """Take the trained leaves of ``model`` (of any capacity) as the
        parameters, as ``anchor_surgery`` does, and the moments and count
        from ``arrays`` (``state_arrays``'s keys, at that capacity)."""
        params = param_groups(model)
        if [n for n, _, _ in params] != [n for n, _, _ in self.params]:
            raise ValueError("the model's trained leaves changed names")
        self.m, self.v = [], []
        for name, _, p in params:
            for moments, key in ((self.m, f'm.{name}'), (self.v, f'v.{name}')):
                a = np.asarray(arrays[key])
                if tuple(a.shape) != tuple(p.shape):
                    raise ValueError(f"{key}: shape {a.shape}, the leaf's "
                                     f"{tuple(p.shape)}")
                moments.append(torch.from_numpy(a.copy()).to(p.device))
        self.count = int(arrays['count'])
        self.params = params

    @torch.no_grad()
    def anchor_surgery(self, model: Model, old_capacity: int,
                       changed: np.ndarray) -> None:
        """After densification: take the leaves of ``model`` (new tensors
        where the capacity grew), zero-pad the moments of the per-anchor
        groups from ``old_capacity`` rows to the new capacity, and zero
        the rows of the ``changed`` slots. The other groups' moments and
        the count are kept."""
        params = param_groups(model)
        if [n for n, _, _ in params] != [n for n, _, _ in self.params]:
            raise ValueError("the model's trained leaves changed names")
        new_capacity = model.state.capacity
        idx = torch.from_numpy(changed).to(model.state.device)
        for i, (_, group, p) in enumerate(params):
            if group not in PER_ANCHOR_GROUPS:
                continue
            for moments in (self.m, self.v):
                rows = moments[i].view(old_capacity, -1)
                if new_capacity > old_capacity:
                    rows = torch.cat([rows, rows.new_zeros(
                        (new_capacity - old_capacity, rows.shape[1]))])
                rows.index_fill_(0, idx, 0.0)
                moments[i] = rows.reshape(p.shape)
        self.params = params

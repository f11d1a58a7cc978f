"""Carry a JAX-package model across: numpy leaves -> the port's ``Model``.

``params`` is the JAX ``Model`` with every leaf already a numpy array (for
example ``jax.tree.map(np.asarray, model)``); it is read by attribute only
(``state._asdict()``, ``heads``, ``grid``, ``bounds``), so no JAX type is
needed here. Both models then compute the same functions.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import GSConfig
from .device import resolve_device
from .models.anchors import AnchorBounds, AnchorState
from .models.heads import Heads
from .models.model import Model, mix_spec


def model_from_jax_params(params, cfg: GSConfig,
                          device: str = "cuda") -> Model:
    dev = resolve_device(device)

    def t(a):
        a = np.asarray(a)
        return torch.from_numpy(np.array(a)).to(dev)

    st = {k: t(v) for k, v in params.state._asdict().items()}
    state = AnchorState(**st)
    heads = Heads(cfg.feat_dim, cfg.n_offsets, mix_spec(cfg).output_dim,
                  torch.Generator().manual_seed(0), dev,
                  cfg.use_feat_bank, cfg.color_mode)
    with torch.no_grad():
        for name in ('opacity', 'cov', 'color', 'grid', 'deform'):
            linears = [m for m in getattr(heads, name)
                       if isinstance(m, torch.nn.Linear)]
            layers = params.heads[name]
            if len(layers) != len(linears):
                raise ValueError(f"head {name}: {len(layers)} layers, "
                                 f"expected {len(linears)}")
            for lin, layer in zip(linears, layers):
                # JAX stores w as [in, out] (x @ w); nn.Linear as [out, in]
                lin.weight.copy_(t(np.asarray(layer['w']).T))
                lin.bias.copy_(t(layer['b']))
    grid = {k: t(params.grid[k]) for k in ('xyz', 'xy', 'xz', 'yz')}
    bounds = AnchorBounds(x_min=t(params.bounds.x_min),
                          x_max=t(params.bounds.x_max))
    return Model(state=state, heads=heads, grid=grid, bounds=bounds)

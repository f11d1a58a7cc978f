"""Carry a model between the packages as numpy leaves.

``model_from_jax_params``: ``params`` is the JAX ``Model`` with every leaf
already a numpy array (for example ``jax.tree.map(np.asarray, model)``); it
is read by attribute only (``state._asdict()``, ``heads``, ``grid``,
``bounds``), so no JAX type is needed here. Both models then compute the
same functions. ``model_to_numpy`` goes the other way, for comparing a
trained port model with the JAX one leaf by leaf.
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


def model_to_numpy(model: Model) -> dict:
    """The reverse direction: the port's ``Model`` as numpy leaves in the
    JAX package's layout, ``{'state': {field: flat array}, 'heads': {name:
    [{'w': [in, out], 'b': [out]}, ...]}, 'grid': {...}, 'bounds':
    {'x_min', 'x_max'}}``, so the two models compare leaf by leaf."""
    def a(x):
        return x.detach().cpu().numpy().copy()

    heads = {name: [{'w': a(lin.weight).T.copy(), 'b': a(lin.bias)}
                    for lin in getattr(model.heads, name)
                    if isinstance(lin, torch.nn.Linear)]
             for name in ('opacity', 'cov', 'color', 'grid', 'deform')}
    return {'state': {f: a(v) for f, v in
                      model.state.flat_leaves().items()},
            'heads': heads,
            'grid': {k: a(v) for k, v in model.grid.items()},
            'bounds': {'x_min': a(model.bounds.x_min),
                       'x_max': a(model.bounds.x_max)}}

"""Carry a model, and its optimizer's moments, between the packages as
numpy leaves.

``model_from_jax_params``: ``params`` is the JAX ``Model`` with every leaf
already a numpy array (for example ``jax.tree.map(np.asarray, model)``); it
is read by attribute only (``state._asdict()``, ``heads``, ``grid``,
``bounds``), so no JAX type is needed here. Both models then compute the
same functions. ``model_to_numpy`` goes the other way, for comparing a
trained port model with the JAX one leaf by leaf.

``optax_moments`` reads the JAX trainer's optax state the same way, and
``adam_moments`` the port's ``Adam``, into one layout: ``{'count': int,
'mu': {key: array}, 'nu': {key: array}}`` keyed by ``leaf_key``, with the
JAX package's leaf shapes (flat anchor leaves, [in, out] weights).
``load_adam_moments`` writes such a dict into an ``Adam``.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from .config import GSConfig
from .device import resolve_device
from .models.anchors import AnchorBounds, AnchorState
from .models.heads import Heads
from .models.model import Model, mix_spec


def _linears(heads: Heads, name: str) -> list:
    return [m for m in getattr(heads, name)
            if isinstance(m, torch.nn.Linear)]


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
                  cfg.use_feat_bank, cfg.color_mode, cfg.sh_degree)
    names = [n for n, _ in heads.named_children()]
    if sorted(names) != sorted(params.heads):
        raise ValueError(f"heads {sorted(params.heads)}, expected "
                         f"{sorted(names)} for this GSConfig")
    with torch.no_grad():
        for name in names:
            linears = _linears(heads, name)
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
                    for lin in _linears(model.heads, name)]
             for name, _ in model.heads.named_children()}
    return {'state': {f: a(v) for f, v in
                      model.state.flat_leaves().items()},
            'heads': heads,
            'grid': {k: a(v) for k, v in model.grid.items()},
            'bounds': {'x_min': a(model.bounds.x_min),
                       'x_max': a(model.bounds.x_max)}}


def model_to(model: Model, device) -> Model:
    """A copy of ``model`` on ``device``, every leaf detached (no grad)."""
    dev = torch.device(device)
    st = AnchorState(**{f: v.detach().to(dev).clone()
                        for f, v in model.state.flat_leaves().items()})
    heads = copy.deepcopy(model.heads).to(dev).requires_grad_(False)
    return Model(state=st, heads=heads,
                 grid={k: v.detach().to(dev).clone()
                       for k, v in model.grid.items()},
                 bounds=AnchorBounds(*(b.detach().to(dev).clone()
                                       for b in model.bounds)))


def leaf_key(name: str) -> tuple[tuple, bool]:
    """An ``Adam.params`` leaf name ('state.anchor', 'heads.color.2.weight',
    'grid.xyz') -> its key in the JAX package's tree (('state', 'anchor'),
    ('heads', 'color', 1, 'w'), ('grid', 'xyz')) and whether the port
    stores it transposed ([out, in] weights)."""
    parts = name.split('.')
    if parts[0] == 'heads':
        return ('heads', parts[1], int(parts[2]) // 2,
                'w' if parts[3] == 'weight' else 'b'), parts[3] == 'weight'
    return tuple(parts), False


def _jax_leaf(tree, key: tuple):
    """The leaf at ``key`` of a JAX ``Model``-shaped tree, read by
    attribute and item only."""
    if key[0] == 'state':
        return getattr(tree.state, '_' + key[1])
    if key[0] == 'heads':
        return tree.heads[key[1]][key[2]][key[3]]
    return tree.grid[key[1]]


def optax_moments(opt_state, opt) -> dict:
    """The Adam moments and count of the JAX trainer's optax
    ``multi_transform`` state (numpy leaves) for each leaf of the port's
    ``opt``, each read from its own group's inner state."""
    out = {'count': None, 'mu': {}, 'nu': {}}
    for name, group, _ in opt.params:
        adam = opt_state.inner_states[group].inner_state[0]
        key = leaf_key(name)[0]
        out['mu'][key] = np.array(_jax_leaf(adam.mu, key))
        out['nu'][key] = np.array(_jax_leaf(adam.nu, key))
        out['count'] = int(np.asarray(adam.count))
    return out


def adam_moments(opt) -> dict:
    """The port's ``Adam`` moments and count in ``optax_moments``'s
    layout."""
    out = {'count': opt.count, 'mu': {}, 'nu': {}}
    for (name, _, p), m, v in zip(opt.params, opt.m, opt.v):
        key, transposed = leaf_key(name)
        for tree, x in (('mu', m), ('nu', v)):
            a = x.detach().cpu().numpy()
            out[tree][key] = a.T.copy() if transposed else a.reshape(-1)
    return out


@torch.no_grad()
def load_adam_moments(opt, moments: dict) -> None:
    """Write ``moments`` (``optax_moments``'s layout) into ``opt``'s
    moments and count, in place."""
    for (name, _, p), m, v in zip(opt.params, opt.m, opt.v):
        key, transposed = leaf_key(name)
        for x, tree in ((m, 'mu'), (v, 'nu')):
            a = np.asarray(moments[tree][key])
            a = a.T if transposed else a
            x.copy_(torch.from_numpy(np.ascontiguousarray(a)).reshape(
                p.shape))
    opt.count = int(moments['count'])

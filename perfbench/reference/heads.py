"""The anchor model's MLP heads (scene/gaussian_model.py:224-265).

opacity (F+4 -> F -> K, tanh), cov (F+4 -> F -> 7K), color (F+4 -> F -> 3K,
sigmoid; with ``color_mode='sh'`` F -> F -> 3MK raw SH coefficients, M =
(sh_degree+1)^2, from the view-independent feature), grid/context (ctx ->
2F -> 2*(F+6+3K)+3), deform (ctx -> 2F -> 2K, bias[0::2] += 10; trained but
unused when rendering), and with ``use_feat_bank`` the feature bank (4 -> F
-> 3, softmax). Weights take torch's default Linear init,
U(-1/sqrt(fan_in), 1/sqrt(fan_in)).
"""
from __future__ import annotations

import math

import torch
from torch import nn


class MLP(nn.Sequential):
    """Linear layers with ReLU between them."""

    def __init__(self, dims, generator: torch.Generator,
                 device: torch.device):
        layers = []
        for i in range(len(dims) - 1):
            lin = nn.utils.skip_init(nn.Linear, dims[i], dims[i + 1],
                                     device=device)
            bound = 1.0 / math.sqrt(dims[i])
            with torch.no_grad():
                for p in (lin.weight, lin.bias):
                    u = torch.rand(p.shape, generator=generator)
                    p.copy_((u * 2.0 - 1.0) * bound)
            layers.append(lin)
            if i < len(dims) - 2:
                layers.append(nn.ReLU())
        super().__init__(*layers)


class Heads(nn.Module):
    def __init__(self, feat_dim: int, n_offsets: int, ctx_dim: int,
                 generator: torch.Generator, device: torch.device,
                 use_feat_bank: bool = False, color_mode: str = 'mlp',
                 sh_degree: int = 1):
        super().__init__()
        if color_mode not in ('mlp', 'sh'):
            raise ValueError(f"color_mode must be 'mlp' or 'sh', "
                             f"got {color_mode!r}")
        F, K = feat_dim, n_offsets
        self.opacity = MLP((F + 4, F, K), generator, device)
        self.cov = MLP((F + 4, F, 7 * K), generator, device)
        color_dims = ((F, F, 3 * (sh_degree + 1) ** 2 * K)
                      if color_mode == 'sh' else (F + 4, F, 3 * K))
        self.color = MLP(color_dims, generator, device)
        self.grid = MLP((ctx_dim, 2 * F, (F + 6 + 3 * K) * 2 + 3),
                        generator, device)
        self.deform = MLP((ctx_dim, 2 * F, 2 * K), generator, device)
        if use_feat_bank:
            self.feature_bank = MLP((4, F, 3), generator, device)
        with torch.no_grad():
            self.deform[-1].bias[0::2] += 10.0   # gaussian_model.py:265
        # no graph is built until the trainer turns grad on (train/optim.py)
        self.requires_grad_(False)


def apply_opacity(heads: Heads, x):
    return torch.tanh(heads.opacity(x))


def apply_cov(heads: Heads, x):
    return heads.cov(x)


def apply_color(heads: Heads, x):
    return torch.sigmoid(heads.color(x))


def apply_color_sh(heads: Heads, feat):
    """Raw per-child SH coefficients [C, 3MK]; ``eval_sh`` adds the +0.5
    and the clamp."""
    return heads.color(feat)


def apply_grid(heads: Heads, x):
    return heads.grid(x)


def apply_feature_bank(heads: Heads, x):
    return torch.softmax(heads.feature_bank(x), dim=1)

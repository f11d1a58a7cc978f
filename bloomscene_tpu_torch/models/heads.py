"""The anchor model's MLP heads (scene/gaussian_model.py:224-265).

opacity (F+4 -> F -> K, tanh), cov (F+4 -> F -> 7K), color (F+4 -> F -> 3K,
sigmoid), grid/context (ctx -> 2F -> 2*(F+6+3K)+3), deform (ctx -> 2F -> 2K,
bias[0::2] += 10; trained but unused when rendering). Weights take torch's
default Linear init, U(-1/sqrt(fan_in), 1/sqrt(fan_in)).
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
                 use_feat_bank: bool = False, color_mode: str = 'mlp'):
        super().__init__()
        if use_feat_bank or color_mode != 'mlp':
            raise NotImplementedError(
                "the port renders color_mode='mlp' without a feature bank")
        F, K = feat_dim, n_offsets
        self.opacity = MLP((F + 4, F, K), generator, device)
        self.cov = MLP((F + 4, F, 7 * K), generator, device)
        self.color = MLP((F + 4, F, 3 * K), generator, device)
        self.grid = MLP((ctx_dim, 2 * F, (F + 6 + 3 * K) * 2 + 3),
                        generator, device)
        self.deform = MLP((ctx_dim, 2 * F, 2 * K), generator, device)
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


def apply_grid(heads: Heads, x):
    return heads.grid(x)

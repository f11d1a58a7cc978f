"""Straight-through quantizers (reference utils/encodings.py:177-227,
utils/entropy_models.py:35-50).

Each is a ``torch.autograd.Function`` with the forward values of the JAX
package's ``ops/quantization.py`` and its straight-through backward rules
(``jax.custom_vjp`` there):

- ``ste_binary``: sign; the gradient passes only where |x| <= 1;
- ``ste_multistep``: rounding to q*Z; identity gradient to x, none to q
  or the mean;
- ``quantize_anchor``: 16-bit grid; the gradient goes to the anchors only;
- ``low_bound``: clamp from below; the gradient passes where x >= bound or
  where it would push x up (g < 0).
"""
from __future__ import annotations

import torch

ANCHOR_ROUND_DIGITS = 16                      # encodings.py:12
Q_ANCHOR = 1.0 / (2 ** ANCHOR_ROUND_DIGITS - 1)
STE_CLAMP_RANGE = 15_000                      # encodings.py:202-203


class _SteBinary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * (torch.abs(x) <= 1.0).to(g.dtype)


def ste_binary(x: torch.Tensor) -> torch.Tensor:
    """sign(x) in {-1, +1} (0 maps to +1); gradient masked to |x| <= 1."""
    return _SteBinary.apply(x)


class _SteMultistep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, q, x_mean, tau):
        x = torch.minimum(torch.maximum(x, x_mean - STE_CLAMP_RANGE * q),
                          x_mean + STE_CLAMP_RANGE * q)
        q_q = torch.round(x / q) * q
        return q_q + torch.tanh((x - q_q) / tau) * q

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


def ste_multistep(x: torch.Tensor, q, x_mean, tau: float = 1.0
                  ) -> torch.Tensor:
    """Round x to the grid q*Z with a tanh soft fractional part, after
    clamping to mean +- 15000*q (STE_multistep.forward, encodings.py:196-209).
    ``torch.round`` rounds half to even, as ``jnp.round`` does. The gradient
    is the identity to x, the clamp included."""
    q = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    x_mean = torch.as_tensor(x_mean, dtype=x.dtype, device=x.device)
    return _SteMultistep.apply(x, q, x_mean, tau)


class _QuantizeAnchor(torch.autograd.Function):
    @staticmethod
    def forward(ctx, anchors, min_v, max_v):
        interval = (max_v - min_v) * Q_ANCHOR + 1e-6
        q = torch.floor((anchors - min_v) / interval + 0.02)
        q = torch.clamp(q, 0, 2 ** ANCHOR_ROUND_DIGITS - 1)
        ctx.mark_non_differentiable(q)
        return q * interval + min_v, q

    @staticmethod
    def backward(ctx, g_anchor, g_q):
        return g_anchor, None, None


def quantize_anchor(anchors: torch.Tensor, min_v: torch.Tensor,
                    max_v: torch.Tensor):
    """16-bit uniform quantization inside [min_v, max_v] -> (anchors_q, q).

    The floor carries the JAX package's 0.02-cell nudge, which makes the
    quantization idempotent (Quantize_anchor, encodings.py:215-227). The
    gradient of anchors_q goes straight through to ``anchors``."""
    return _QuantizeAnchor.apply(anchors, min_v, max_v)


class _LowBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp(x, min=bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where((x >= ctx.bound) | (g < 0.0), g, 0.0), None


def low_bound(x: torch.Tensor, bound: float = 1e-6) -> torch.Tensor:
    """max(x, bound); below the bound only gradients that push x up (g < 0)
    pass (Low_bound, entropy_models.py:35-50)."""
    return _LowBound.apply(x, bound)

"""Quantizer forwards (reference utils/encodings.py:177-227).

Forward values only: the straight-through gradient rules come with the
training path.
"""
from __future__ import annotations

import torch

ANCHOR_ROUND_DIGITS = 16                      # encodings.py:12
Q_ANCHOR = 1.0 / (2 ** ANCHOR_ROUND_DIGITS - 1)
STE_CLAMP_RANGE = 15_000                      # encodings.py:202-203


def ste_binary(x: torch.Tensor) -> torch.Tensor:
    """sign(x) in {-1, +1} (0 maps to +1)."""
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


def ste_multistep(x: torch.Tensor, q, x_mean, tau: float = 1.0
                  ) -> torch.Tensor:
    """Round x to the grid q*Z with a tanh soft fractional part, after
    clamping to mean +- 15000*q (STE_multistep.forward, encodings.py:196-209).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    x = torch.minimum(torch.maximum(x, x_mean - STE_CLAMP_RANGE * q),
                      x_mean + STE_CLAMP_RANGE * q)
    q_q = torch.round(x / q) * q
    return q_q + torch.tanh((x - q_q) / tau) * q


def quantize_anchor(anchors: torch.Tensor, min_v: torch.Tensor,
                    max_v: torch.Tensor):
    """16-bit uniform quantization inside [min_v, max_v] -> (anchors_q, q).

    The floor carries the JAX package's 0.02-cell nudge, which makes the
    quantization idempotent (Quantize_anchor, encodings.py:215-227)."""
    interval = (max_v - min_v) * Q_ANCHOR + 1e-6
    q = torch.floor((anchors - min_v) / interval + 0.02)
    q = torch.clamp(q, 0, 2 ** ANCHOR_ROUND_DIGITS - 1)
    return q * interval + min_v, q

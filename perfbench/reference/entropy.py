"""Entropy models of the rate loss (utils/entropy_models.py:10-31,
Entropy_gaussian; utils/encodings.py:17-33, get_binary_vxl_size).

The port of ``bloomscene_tpu/ops/entropy.py``. The Gaussian CDF takes
JAX's arrangement of ``ndtr`` (``1 + erf`` near 0, ``2 - erfc`` and
``erfc`` in the tails), not ``torch.special.ndtr`` (``1 + erf`` for every
x >= -1): ``upper - lower`` cancels in the upper tail, and there the two
arrangements differ by up to ~1e-3 of the bits, against ~1e-5 for the
erf/erfc rounding left between torch and XLA.
"""
from __future__ import annotations

import math

import torch

from .quantization import STE_CLAMP_RANGE, low_bound

_HALF_SQRT2 = 0.5 * math.sqrt(2.0)


def ndtr(x: torch.Tensor) -> torch.Tensor:
    """The standard normal CDF, arranged as ``jax.scipy.special.ndtr``."""
    w = x * _HALF_SQRT2
    z = torch.abs(w)
    y = torch.where(z < _HALF_SQRT2, 1.0 + torch.erf(w),
                    torch.where(w > 0.0, 2.0 - torch.erfc(z),
                                torch.erfc(z)))
    return 0.5 * y


def gaussian_cdf(x, mean, scale):
    return ndtr((x - mean) / scale)


def entropy_gaussian_bits(x, mean, scale, q, x_mean):
    """Per-element bits -log2(Phi(x + q/2) - Phi(x - q/2)) under N(mean,
    scale): x clamped to x_mean +- 15000 q, scale floored at 1e-9, the
    likelihood low-bounded at 1e-6 with the grad-safe rule. The clamp is
    ``minimum(maximum(...))`` as ``jnp.clip`` is, so ties split the
    gradient the same way."""
    x = torch.minimum(torch.maximum(x, x_mean - STE_CLAMP_RANGE * q),
                      x_mean + STE_CLAMP_RANGE * q)
    scale = torch.clamp(scale, min=1e-9)
    lower = gaussian_cdf(x - 0.5 * q, mean, scale)
    upper = gaussian_cdf(x + 0.5 * q, mean, scale)
    d = upper - lower
    # |d| with JAX's derivative, +1 at 0 (both CDFs round to 1 far out in
    # a tail; the low bound then passes the gradient that raises d)
    return -torch.log2(low_bound(torch.where(d >= 0, d, -d)))


def binary_entropy_bits(binary_pm1: torch.Tensor):
    """(p_one, total bits) to code a {-1, +1} (or {0, 1}) tensor with its
    empirical Bernoulli probability, plus 32 bits for the probability."""
    x01 = (binary_pm1 > 0).to(torch.float32)
    n = x01.numel()
    pos = torch.sum(x01)
    p = torch.clamp(pos / n, 1e-6, 1.0 - 1e-6)
    bits = pos * (-torch.log2(p)) + (n - pos) * (-torch.log2(1.0 - p))
    return p, bits + 32.0

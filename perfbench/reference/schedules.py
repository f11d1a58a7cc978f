"""LR schedules (reference utils/general.py:33-66 get_expon_lr_func)."""
from __future__ import annotations

import math

import torch

_F32 = torch.float32


def expon_lr(lr_init: float, lr_final: float, *, lr_delay_steps: int = 0,
             lr_delay_mult: float = 1.0, max_steps: int = 1_000_000,
             step_sub: int = 0):
    """Log-lerp decay with an optional sine delay ramp: fn(step) -> lr as a
    float32 scalar tensor, computed in float32 in the JAX package's order of
    operations."""
    def f32(x):
        return torch.tensor(x, dtype=_F32)

    def helper(step) -> torch.Tensor:
        step = torch.as_tensor(step, dtype=_F32)
        if lr_init == 0.0 and lr_final == 0.0:
            return torch.zeros_like(step)
        if lr_delay_steps > 0:
            delay = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
                0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0, 1))
        else:
            delay = 1.0
        t = torch.clamp((step - step_sub) / (max_steps - step_sub), 0, 1)
        log_lerp = torch.exp(torch.log(f32(lr_init)) * (1 - t)
                             + torch.log(f32(lr_final)) * t)
        out = delay * log_lerp
        return torch.where(step < 0, 0.0, out)
    return helper

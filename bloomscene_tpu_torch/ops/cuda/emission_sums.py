"""The blend backward's emission-order reduction (CUDA
``csrc/emission_sums.cu``) beside its plain version: K2's per-entry
gradients [10, cap, T] summed over each Gaussian's contiguous range of
emission slots into per-Gaussian gradients [10, n].

``emission_sums(grad, src_lane, starts_by_id, ends_by_id)``: for each
Gaussian i, the sum over the slots k of [min(s_i, pc), min(e_i, pc))
whose lane ``src_lane[k]`` is live (below cap * T; culled, truncated and
over-capacity pairs carry cap * T) of ``grad[:, src_lane[k]]``, 0 where the
range is empty. On the card a range of at most WARP_RANGE slots is summed
in slot order from 0, a longer one by its warp in a fixed order (see the
source): the same bits from one launch to the next, within a few
roundings of the exact sum. The kernel has no TPU counterpart.

The plain version is the JAX package's arithmetic for the same sums
(``bloomscene_tpu/ops/pallas/wrapper.py:146-172``): the entries gathered
into emission order with the dead lanes masked, an inclusive and an
exclusive cumsum, and their difference at each range, which carries the
prefix sums' rounding (eps * |prefix|). The CPU path keeps it so that a
CPU step's gradients stay those the JAX package's tests were set against:
a three-step run's Adam updates turn a change of rounding in the sums into
whole learning-rate steps at entries near the noise floor.
"""
from __future__ import annotations

import ctypes

import torch

from .build import check, library, require, stream_ptr

CHANNELS = 10       # K2's gradient rows (emission_sums.cu)
WARP_RANGE = 16     # a longer range is summed by its warp (emission_sums.cu)

_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]


def _launch(grad, src_lane, starts_by_id, ends_by_id) -> torch.Tensor:
    dev = grad.device
    n, pc = starts_by_id.shape[0], src_lane.shape[0]
    if grad.dim() != 3 or grad.shape[0] != CHANNELS:
        raise ValueError(f"emission_sums: grad of shape {tuple(grad.shape)},"
                         f" expected [{CHANNELS}, cap, T]")
    n_lanes = grad.shape[1] * grad.shape[2]
    if not 1 <= n_lanes < 2 ** 31 or not 1 <= n < 2 ** 31 \
            or pc >= 2 ** 31:
        raise ValueError(f"emission_sums: lanes {n_lanes} and Gaussians {n} "
                         f"(1 to 2^31 - 1), slots {pc} (below 2^31)")
    require(grad, torch.float32, tuple(grad.shape), "grad", dev)
    require(src_lane, torch.int32, (pc,), "src_lane", dev)
    require(starts_by_id, torch.int32, (n,), "starts_by_id", dev)
    require(ends_by_id, torch.int32, (n,), "ends_by_id", dev)
    out = torch.empty((CHANNELS, n), dtype=torch.float32, device=dev)
    fn = library("emission_sums").bs_emission_sums
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    check(fn(grad.data_ptr(), n_lanes, src_lane.data_ptr(), pc,
             starts_by_id.data_ptr(), ends_by_id.data_ptr(), n,
             out.data_ptr(), stream_ptr(dev)), "emission_sums")
    emission_sums.launches += 1
    return out


def emission_sums(grad: torch.Tensor, src_lane: torch.Tensor,
                  starts_by_id: torch.Tensor,
                  ends_by_id: torch.Tensor) -> torch.Tensor:
    """grad [10, cap, T] float32, src_lane [pc] int32 in [0, cap * T],
    starts_by_id and ends_by_id [n] int32 -> [10, n] float32, each
    Gaussian's live entries summed over its emission range."""
    if grad.device.type == "cpu":
        return emission_sums_plain(grad, src_lane, starts_by_id, ends_by_id)
    return _launch(grad, src_lane, starts_by_id, ends_by_id)


emission_sums.launches = 0


def emission_sums_plain(grad, src_lane, starts_by_id,
                        ends_by_id) -> torch.Tensor:
    n_lanes = grad.shape[1] * grad.shape[2]
    flat = grad.reshape(grad.shape[0], n_lanes)
    dead = src_lane >= n_lanes
    pg = torch.index_select(flat, 1, torch.clamp(src_lane,
                                                 max=n_lanes - 1).long())
    pg = torch.where(dead[None, :], 0.0, pg)
    inc = torch.cumsum(pg, 1)
    exc = inc - pg
    pc = src_lane.shape[0]
    s = torch.clamp(starts_by_id, max=pc).long()
    e = torch.clamp(ends_by_id, max=pc).long()
    return torch.where((e > s)[None, :],
                       inc[:, torch.clamp(e - 1, min=0)]
                       - exc[:, torch.clamp(s, max=pc - 1)], 0.0)

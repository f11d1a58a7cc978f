"""Anchor model state + initialization (gaussian_model.py:171-186, 440-479).

Per-anchor state, stored as flat 1D leaves like the JAX package's
``AnchorState`` (so the two convert leaf by leaf), with 2D/3D views:

- anchor [C, 3], offset [C, K, 3], mask_logit [C, K, 1], feat [C, F],
  scaling_log [C, 6], rotation [C, 4], opacity_raw [C, 1];
- alive [C] bool capacity mask.

The float leaves are plain tensors without grad; ``train/optim.py`` turns
the trained ones (all but rotation and opacity_raw) into leaves that
require grad and updates them in place.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.cuda.gather_rows_bwd import gather_rows_bwd
from ..ops.knn import knn_mean_sq_dist
from ..ops.quantization import quantize_anchor
from ..utils.profiling import span


def inverse_sigmoid(x):
    return np.log(x / (1.0 - x))


def capacity_bucket(n: int, granularity: int = 8192) -> int:
    """Anchor capacity: the next multiple of ``granularity`` (min 256)."""
    return max(256, -(-n // granularity) * granularity)


class AnchorState:
    """Anchor state whose leaves are flat 1D tensors; views by property."""
    _fields = ('anchor', 'offset', 'mask_logit', 'feat', 'scaling_log',
               'rotation', 'opacity_raw', 'alive')
    _widths = {'anchor': 3, 'scaling_log': 6, 'rotation': 4,
               'opacity_raw': 1}

    def __init__(self, anchor, offset, mask_logit, feat, scaling_log,
                 rotation, opacity_raw, alive):
        def flat(x):
            # a flat leaf is kept as the same tensor: ``_replace`` must not
            # swap a trained leaf for a view of it
            return x if x.dim() == 1 else x.reshape(-1)
        self._anchor = flat(anchor)
        self._offset = flat(offset)
        self._mask_logit = flat(mask_logit)
        self._feat = flat(feat)
        self._scaling_log = flat(scaling_log)
        self._rotation = flat(rotation)
        self._opacity_raw = flat(opacity_raw)
        self._alive = alive

    def flat_leaves(self) -> dict:
        """field -> the flat 1D leaf tensor (not a view copy)."""
        return {f: getattr(self, '_' + f) for f in self._fields}

    def _replace(self, **kw) -> "AnchorState":
        vals = self.flat_leaves()
        vals.update(kw)
        return AnchorState(**vals)

    @property
    def capacity(self) -> int:
        return self._alive.shape[0]

    @property
    def n_offsets(self) -> int:
        return self._offset.numel() // (self.capacity * 3)

    @property
    def feat_dim(self) -> int:
        return self._feat.numel() // self.capacity

    @property
    def device(self) -> torch.device:
        return self._alive.device

    def _view(self, name):
        x = getattr(self, '_' + name)
        if name == 'offset':
            return x.reshape(-1, self.n_offsets, 3)
        if name == 'mask_logit':
            return x.reshape(-1, self.n_offsets, 1)
        if name == 'feat':
            return x.reshape(-1, self.feat_dim)
        return x.reshape(-1, self._widths[name])

    @property
    def anchor(self):
        return self._view('anchor')

    @property
    def offset(self):
        return self._view('offset')

    @property
    def mask_logit(self):
        return self._view('mask_logit')

    @property
    def feat(self):
        return self._view('feat')

    @property
    def scaling_log(self):
        return self._view('scaling_log')

    @property
    def rotation(self):
        return self._view('rotation')

    @property
    def opacity_raw(self):
        return self._view('opacity_raw')

    @property
    def alive(self):
        return self._alive

    def num_alive(self) -> int:
        return int(self._alive.sum())

    @torch.no_grad()
    def write_rows(self, slots: torch.Tensor, rows: dict) -> None:
        """Write ``rows[field]`` (one row per slot) into those ``slots`` of
        the flat float leaves, in place (the trainer's leaves stay the
        tensors its optimizer holds)."""
        C = self.capacity
        for f, v in rows.items():
            leaf = getattr(self, '_' + f).view(C, -1)
            leaf.index_copy_(0, slots, v.reshape(slots.shape[0], -1).to(
                leaf.dtype))

    def grow(self, new_capacity: int) -> "AnchorState":
        """The state zero-padded to ``new_capacity`` anchors (new rows dead):
        new leaf tensors, which require grad where the old ones did."""
        pad = new_capacity - self.capacity
        vals = {}
        for f, v in self.flat_leaves().items():
            k = v.numel() // self.capacity
            grown = torch.cat([v.detach(), v.new_zeros(pad * k)])
            vals[f] = grown.requires_grad_(v.requires_grad)
        return AnchorState(**vals)

    def gather_rows(self, idx: torch.Tensor, alive: torch.Tensor
                    ) -> "AnchorState":
        """Row-gather every per-anchor field by ``idx``; ``alive`` becomes
        the gathered state's alive mask. The leaves that require grad go
        through ``SortedRowGather`` (so ``idx`` must be nondecreasing), the
        frozen ones through plain indexing."""
        C = self.capacity
        leaves = {f: getattr(self, '_' + f) for f in self._fields
                  if f != 'alive'}
        trained = [f for f, x in leaves.items() if x.requires_grad]
        vals = {f: x.reshape(C, -1)[idx] for f, x in leaves.items()
                if f not in trained}
        if trained:
            rows = SortedRowGather.apply(idx, C, *(leaves[f]
                                                   for f in trained))
            vals.update(zip(trained, rows))
        return AnchorState(alive=alive, **vals)


class SortedRowGather(torch.autograd.Function):
    """``x.reshape(C, -1)[idx]`` of each leaf x, with the backward
    ``gather_rows_bwd``: every leaf's rows summed by ``idx`` in one call
    of the kernel on CUDA tensors, ``index_add_`` on CPU tensors.

    The precondition: ``idx`` is nondecreasing and in [0, C). Its only
    caller is ``compact_visible`` (through ``AnchorState.gather_rows``),
    whose index is the sorted visible rows, then C - 1 repeated for the
    bucket's padding."""

    @staticmethod
    def forward(ctx, idx, C, *leaves):
        ctx.save_for_backward(idx)
        ctx.C, ctx.shapes = C, [x.shape for x in leaves]
        return tuple(x.reshape(C, -1)[idx] for x in leaves)

    @staticmethod
    def backward(ctx, *grads):
        idx, = ctx.saved_tensors
        with span("gather_rows.backward"):
            sums = gather_rows_bwd([g.contiguous() for g in grads], idx,
                                   ctx.C)
            return (None, None, *(s.reshape(shape)
                                  for s, shape in zip(sums, ctx.shapes)))


class AnchorBounds(NamedTuple):
    """Anchor AABB for quantization / hash normalization."""
    x_min: torch.Tensor   # [1, 3]
    x_max: torch.Tensor   # [1, 3]

    @staticmethod
    def initial(device) -> "AnchorBounds":
        return AnchorBounds(x_min=torch.zeros((1, 3), device=device),
                            x_max=torch.ones((1, 3), device=device))


@torch.no_grad()
def update_anchor_bounds(state: AnchorState) -> AnchorBounds:
    """AABB over alive anchors with the 1.2/0.8 margin rule
    (gaussian_model.py:401-411); constants of the model, without grad."""
    big = 1e9
    alive = state.alive[:, None]
    x_min = torch.where(alive, state.anchor, big).amin(0, keepdim=True)
    x_max = torch.where(alive, state.anchor, -big).amax(0, keepdim=True)
    x_min = torch.where(x_min < 0, x_min * 1.2, x_min * 0.8)
    x_max = torch.where(x_max > 0, x_max * 1.2, x_max * 0.8)
    return AnchorBounds(x_min=x_min, x_max=x_max)


def voxelize_points(points: np.ndarray, voxel_size: float,
                    seed: int = 0) -> np.ndarray:
    """Shuffle + round-to-voxel + unique (gaussian_model.py:435-438)."""
    rng = np.random.default_rng(seed)
    pts = np.array(points)
    rng.shuffle(pts)
    return np.unique(np.round(pts / voxel_size), axis=0) * voxel_size


def init_from_points(points: np.ndarray, *, n_offsets: int, feat_dim: int,
                     device: torch.device, voxel_size: float = 0.001,
                     capacity: int | None = None,
                     seed: int = 0) -> tuple[AnchorState, float]:
    """create_from_pcd (gaussian_model.py:440-479): voxelized anchors,
    offset scales from 3-NN distances, zero offsets and features, masks on,
    identity rotations, opacity 0.1, padded to ``capacity`` with dead
    anchors. ``voxel_size`` <= 0 takes the median 3-NN distance."""
    if voxel_size <= 0:
        d2 = knn_mean_sq_dist(torch.as_tensor(points, dtype=torch.float32,
                                              device=device))
        voxel_size = float(torch.quantile(d2.cpu(), 0.5))
    pts = voxelize_points(points, voxel_size, seed).astype(np.float32)
    n = pts.shape[0]
    if capacity is None:
        capacity = capacity_bucket(int(n * 1.25))

    d2 = knn_mean_sq_dist(torch.as_tensor(pts, device=device))
    scales = torch.log(torch.sqrt(torch.clamp(d2, min=1e-7)))[:, None]

    def pad(x, fill=0.0):
        out = torch.full((capacity,) + tuple(x.shape[1:]), fill,
                         dtype=x.dtype, device=device)
        out[:n] = x
        return out

    f32 = dict(dtype=torch.float32, device=device)
    state = AnchorState(
        anchor=pad(torch.as_tensor(pts, device=device)),
        offset=torch.zeros((capacity, n_offsets, 3), **f32),
        mask_logit=pad(torch.ones((n, n_offsets, 1), **f32)),
        feat=torch.zeros((capacity, feat_dim), **f32),
        scaling_log=pad(scales.expand(n, 6).contiguous()),
        rotation=pad(torch.tensor([1.0, 0, 0, 0], **f32).expand(n, 4)),
        opacity_raw=pad(torch.full((n, 1), float(inverse_sigmoid(0.1)),
                                   **f32)),
        alive=torch.arange(capacity, device=device) < n,
    )
    return state, voxel_size


# --- activated getters (gaussian_model.py:342-399) ---

def get_scaling(state: AnchorState) -> torch.Tensor:
    return torch.exp(torch.clamp(state.scaling_log, -20.0, 10.0))


def get_mask(state: AnchorState) -> torch.Tensor:
    """Binary child mask in {0, 1} (sigmoid > 0.01) with the sigmoid's
    straight-through gradient: ``sig + (hard - sig).detach()``, which also
    rounds as the JAX package's does."""
    sig = torch.sigmoid(state.mask_logit)
    hard = (sig > 0.01).to(torch.float32)
    return sig + (hard - sig).detach()


def get_mask_anchor(state: AnchorState) -> torch.Tensor:
    """[C] float: 1 where any child mask of the anchor is on (:355-364);
    no gradient."""
    m = get_mask(state).detach()
    return (torch.sum(m[:, :, 0], dim=1) > 0).to(torch.float32)


def get_anchor_quantized(state: AnchorState,
                         bounds: AnchorBounds) -> torch.Tensor:
    """16-bit quantized anchors, straight-through gradient (:394-399)."""
    q, _ = quantize_anchor(state.anchor, bounds.x_min, bounds.x_max)
    return q

"""Sharded training and render steps over a mesh.

The port of ``bloomscene_tpu/parallel/sharded.py``: two strategies over
the ('data', 'tile') mesh of ``parallel/mesh.py``.

1. Data parallel (``make_dp_train_step``, implemented in ``train/loop.py``
   and re-exported here; ``Trainer(mesh=..., dp_batch=...)`` drives it): a
   batch of views over the data axis, the model and optimizer replicated,
   the gradients of the mean loss summed over the axis.
2. Tile parallel (``make_tile_parallel_render``,
   ``make_tile_parallel_train_step``): one view, the blend's tile
   positions cut into one strip a rank of the tile axis (K1 and K2 on the
   strip, the strips all-gathered; ``ops/cuda/wrapper.py``). Every rank
   of the axis calls the returned function on the same arguments and gets
   the same result, the single-process result bit for bit.

Every rank holds its own tensors; these functions run eagerly on each
rank (there is no jit to hand shardings to).
"""
from __future__ import annotations

from ..config import GSConfig
from ..models.model import Model
from ..models.render import render
from ..scene.cameras import CameraArrays, Intrinsics
from ..train.loop import _step_core
from ..train.loop import make_dp_train_step  # noqa: F401  (re-export)
from .mesh import Mesh


def make_tile_parallel_render(cfg: GSConfig, intr: Intrinsics, mesh: Mesh, *,
                              phase: int = 0, mode: str = 'train'):
    """render1(model, cam, noise=None) -> RenderOutput, with the blend's
    tile positions cut over the mesh's tile axis (sharded.py:46-60).
    ``noise`` is the decode's draws of a train-mode render in phases 1 and
    2 (JAX's ``key``)."""
    tile = mesh.axis('tile')

    def render1(model: Model, cam: CameraArrays, noise=None):
        return render(model, intr, cam, cfg, phase=phase, mode=mode,
                      noise=noise, tile_group=tile).out

    return render1


def make_tile_parallel_train_step(cfg: GSConfig, intr: Intrinsics,
                                  optimizer, bg, mesh: Mesh, *,
                                  phase: int = 0):
    """step(model, cam, gt_image, gt_depth, noise=None) -> (model, loss):
    one training step on one view with the blend's forward and backward
    cut over the mesh's tile axis (sharded.py:63-91). It is the port's
    single-view step (``make_train_step``'s, without the densify
    statistics): the leaves and ``optimizer``'s moments are updated in
    place."""
    tile = mesh.axis('tile')

    def step(model: Model, cam: CameraArrays, gt_image, gt_depth,
             noise=None):
        model, _, metrics = _step_core(cfg, intr, optimizer, bg, model, None,
                                       cam, gt_image, gt_depth, phase, False,
                                       noise, tile_group=tile)
        return model, metrics.loss

    return step

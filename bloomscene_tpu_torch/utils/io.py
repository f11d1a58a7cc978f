"""Scene files: PLY point clouds and anchor snapshots, the model checkpoint,
videos.

The port of ``bloomscene_tpu/utils/io.py``. The files cross between the
packages:

- the PLYs are byte for byte the JAX package's for the same state;
- ``checkpoint.npz`` holds the same ``leaf_{i}`` keys in the same order as
  JAX's ``save_checkpoint`` of ``{'heads', 'grid', 'bounds'}`` (its tree
  flattened: dict keys sorted, ``AnchorBounds`` as (x_min, x_max), each
  head a list of ``{'b', 'w'}`` layers), with the JAX shapes: weights
  ``[in, out]`` (``convert.leaf_key`` says which leaves the port stores
  transposed). Each package loads the other's file with its own
  ``load_checkpoint``.

``write_video`` writes an mp4 through imageio when imageio is importable
and can write one, otherwise a directory of PNG frames
(``utils/image.write_png``).
"""
from __future__ import annotations

import copy
import json
import os
from typing import Optional

import numpy as np
import torch

from ..models.anchors import AnchorBounds, AnchorState
from ..models.heads import Heads
from .image import write_png


# ---------------- PLY ----------------

def _ply_header(n: int, props: list[str]) -> bytes:
    return ("ply\nformat binary_little_endian 1.0\n"
            f"element vertex {n}\n" + "\n".join(props)
            + "\nend_header\n").encode()


def _read_ply(path: str, dtype_of) -> tuple[np.ndarray, list[str]]:
    """(vertex records, property names) of a binary little-endian PLY;
    ``dtype_of(names)`` gives the record dtype."""
    with open(path, 'rb') as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: PLY header without end_header")
            header += line
        lines = header.decode().splitlines()
        n = next(int(ln.split()[-1]) for ln in lines
                 if ln.startswith("element vertex"))
        names = [ln.split()[-1] for ln in lines if ln.startswith("property")]
        rec = np.frombuffer(f.read(), dtype=dtype_of(names), count=n)
    return rec, names


def save_ply_pointcloud(path: str, points: np.ndarray,
                        colors: Optional[np.ndarray] = None) -> None:
    """Binary little-endian PLY with xyz (+ rgb as uchar)."""
    points = np.asarray(points, np.float32)
    n = points.shape[0]
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    props = ["property float x", "property float y", "property float z"]
    if colors is not None:
        props += ["property uchar red", "property uchar green",
                  "property uchar blue"]
    with open(path, 'wb') as f:
        f.write(_ply_header(n, props))
        if colors is None:
            f.write(points.astype('<f4').tobytes())
        else:
            c8 = (np.clip(colors, 0, 1) * 255).astype(np.uint8)
            rec = np.zeros(n, dtype=[('x', '<f4'), ('y', '<f4'),
                                     ('z', '<f4'), ('r', 'u1'),
                                     ('g', 'u1'), ('b', 'u1')])
            rec['x'], rec['y'], rec['z'] = points.T
            rec['r'], rec['g'], rec['b'] = c8.T
            f.write(rec.tobytes())


def load_ply_pointcloud(path: str):
    """The PLYs written above -> (points [N, 3], rgb [N, 3] in [0, 1] or
    None)."""
    def dtype_of(names):
        fmt = [('x', '<f4'), ('y', '<f4'), ('z', '<f4')]
        if "red" in names:
            fmt += [('r', 'u1'), ('g', 'u1'), ('b', 'u1')]
        return np.dtype(fmt)
    rec, names = _read_ply(path, dtype_of)
    pts = np.stack([rec['x'], rec['y'], rec['z']], -1)
    rgb = (np.stack([rec['r'], rec['g'], rec['b']], -1) / 255.0
           if "red" in names else None)
    return pts, rgb


def save_anchor_ply(path: str, state: AnchorState) -> None:
    """The alive anchors as PLY vertex properties (gaussian_model.py:
    632-650): x y z, f_offset_*, f_mask_*, f_anchor_feat_*, scale_*, rot_*,
    opacity."""
    def host(x):
        return x.detach().cpu().numpy()
    alive = host(state.alive).astype(bool)
    anchor = host(state.anchor)[alive]
    n = anchor.shape[0]
    offset = host(state.offset)[alive].reshape(n, -1)
    mask = host(state.mask_logit)[alive].reshape(n, -1)
    feat = host(state.feat)[alive]
    scaling = host(state.scaling_log)[alive]
    rot = host(state.rotation)[alive]
    opac = host(state.opacity_raw)[alive]
    cols = {'x': anchor[:, 0], 'y': anchor[:, 1], 'z': anchor[:, 2]}
    for prefix, a in (('f_offset', offset), ('f_mask', mask),
                      ('f_anchor_feat', feat), ('scale', scaling),
                      ('rot', rot)):
        for i in range(a.shape[1]):
            cols[f'{prefix}_{i}'] = a[:, i]
    cols['opacity'] = opac[:, 0]
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    names = list(cols)
    rec = np.zeros(n, dtype=[(c, '<f4') for c in names])
    for c in names:
        rec[c] = cols[c].astype(np.float32)
    with open(path, 'wb') as f:
        f.write(_ply_header(n, [f"property float {c}" for c in names]))
        f.write(rec.tobytes())


def load_anchor_ply(path: str, n_offsets: int, feat_dim: int,
                    capacity: Optional[int] = None,
                    device: str | torch.device = "cuda") -> AnchorState:
    """Inverse of ``save_anchor_ply`` -> an ``AnchorState`` on ``device``,
    padded to ``capacity`` (default ``max(64, 2**ceil(log2(1.5 n)))``, as
    the JAX package pads) with dead anchors."""
    rec, _ = _read_ply(path, lambda names: np.dtype(
        [(c, '<f4') for c in names]))
    n = rec.shape[0]

    def grab(prefix, d):
        return np.stack([rec[f'{prefix}_{i}'] for i in range(d)], -1)

    cap = capacity or max(64, int(2 ** np.ceil(np.log2(n * 1.5))))

    def pad(a):
        out = np.zeros((cap,) + a.shape[1:], np.float32)
        out[:n] = a
        return torch.from_numpy(out).to(device)

    return AnchorState(
        anchor=pad(np.stack([rec['x'], rec['y'], rec['z']], -1)),
        offset=pad(grab('f_offset', 3 * n_offsets).reshape(n, n_offsets, 3)),
        mask_logit=pad(grab('f_mask', n_offsets).reshape(n, n_offsets, 1)),
        feat=pad(grab('f_anchor_feat', feat_dim)),
        scaling_log=pad(grab('scale', 6)), rotation=pad(grab('rot', 4)),
        opacity_raw=pad(rec['opacity'][:, None]),
        alive=torch.arange(cap, device=device) < n)


# ---------------- the model checkpoint ----------------

def _head_layers(heads: Heads) -> dict:
    """head name -> its Linear layers, in order."""
    return {name: [m for m in module if isinstance(m, torch.nn.Linear)]
            for name, module in heads.named_children()}


def checkpoint_leaves(heads: Heads, grid: dict, bounds: AnchorBounds
                      ) -> list[tuple[str, torch.Tensor, bool]]:
    """(name, tensor, stored transposed) for each leaf of JAX's
    ``{'heads', 'grid', 'bounds'}`` tree in its flatten order: bounds
    (x_min, x_max), the hash tables by sorted key, the heads by sorted
    name, each layer's bias before its weight."""
    out = [('bounds.x_min', bounds.x_min, False),
           ('bounds.x_max', bounds.x_max, False)]
    out += [(f'grid.{k}', grid[k], False) for k in sorted(grid)]
    layers = _head_layers(heads)
    for name in sorted(layers):
        for i, lin in enumerate(layers[name]):
            out += [(f'heads.{name}.{i}.b', lin.bias, False),
                    (f'heads.{name}.{i}.w', lin.weight, True)]
    return out


def save_checkpoint(path: str, model, meta: Optional[dict] = None) -> None:
    """The heads, hash tables and bounds of ``model`` as JAX's
    ``save_checkpoint`` writes them (``leaf_{i}`` keys, JAX shapes)."""
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    leaves = checkpoint_leaves(model.heads, model.grid, model.bounds)
    arrays = {}
    for i, (_, t, transposed) in enumerate(leaves):
        a = t.detach().cpu().numpy()
        arrays[f"leaf_{i}"] = a.T.copy() if transposed else a
    arrays["__treedef__"] = np.frombuffer(json.dumps(
        {'meta': meta or {}, 'leaves': [n for n, _, _ in leaves]}).encode(),
        dtype=np.uint8)
    np.savez(path, **arrays)


@torch.no_grad()
def load_checkpoint(path: str, like):
    """``like`` (a ``Model``) with its heads, hash tables and bounds read
    from a checkpoint that either package wrote; the heads are a new
    module on ``like``'s device, the anchor state is ``like``'s."""
    with np.load(path if path.endswith('.npz') else path + '.npz',
                 allow_pickle=False) as f:
        data = {k: f[k] for k in f.files}
    dev = like.state.device
    heads = copy.deepcopy(like.heads)
    grid = {k: v.detach().clone() for k, v in like.grid.items()}
    bounds = AnchorBounds(*(b.detach().clone() for b in like.bounds))
    leaves = checkpoint_leaves(heads, grid, bounds)
    n_file = sum(1 for k in data if k.startswith('leaf_'))
    if n_file != len(leaves):
        raise ValueError(f"{path}: {n_file} leaves, expected {len(leaves)} "
                         "for this GSConfig")
    for i, (name, t, transposed) in enumerate(leaves):
        a = data[f"leaf_{i}"]
        a = a.T if transposed else a
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"{path}: leaf_{i} ({name}) has shape "
                             f"{a.shape}, expected {tuple(t.shape)}")
        t.copy_(torch.from_numpy(np.ascontiguousarray(a)).to(dev))
    return like._replace(heads=heads, grid=grid, bounds=bounds)


# ---------------- video ----------------

def write_video(path: str, frames, fps: int = 30) -> bool:
    """Frames [H, W, 3] in [0, 1] -> an mp4 through imageio when it is
    importable and can write one; otherwise PNG frames ``0000.png``, ...
    in the directory named like ``path`` without its extension."""
    frames8 = [np.asarray(np.clip(f, 0, 1) * 255, np.uint8) for f in frames]
    try:
        import imageio.v2 as imageio
        os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
        imageio.mimwrite(path, frames8, fps=fps,
                         quality=8, macro_block_size=1)
        return True
    except Exception:   # no imageio, or no mp4 writer behind it
        d = os.path.splitext(path)[0]
        os.makedirs(d, exist_ok=True)
        for i, fr in enumerate(frames8):
            write_png(os.path.join(d, f"{i:04d}.png"), fr)
        return True

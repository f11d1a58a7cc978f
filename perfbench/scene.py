"""The scene a training cell runs: the room's anchors, the model's weights
at a trained scale, the orbit's cameras and the target images and depths.

Everything is made on the card from seeds, in a few large calls: the
room (its geometry, its texture) and the model's heads from the
configuration's fixed ``scene_seed``, so every run holds the same anchors
and does the same work; the anchors' features, offsets and scales from the
run's ``--seed``, which also drives the trainer's camera draws and decode
noise. The weights are returned as one dict of tensors, keyed
as the trained leaves are named (``state.<field>``, ``heads.<name>``,
``grid.<name>``), which both the program and the reference are built from.
"""
from __future__ import annotations

import json
import math

import numpy as np
import torch

ZNEAR, ZFAR = 0.01, 100.0


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def room_anchors(scene: dict, voxel: float, device) -> torch.Tensor:
    """Points on the wall, floor and ceiling of a cylinder room around the
    orbit's cameras (uniform by area, Gaussian noise of ``noise`` units),
    voxelized: the sorted distinct voxel centers [n, 3] float32."""
    gen = _generator(scene["scene_seed"], device)
    n = scene["points"]
    r, h = scene["radius"], scene["half_height"]
    a_wall, a_disk = 2 * math.pi * r * 2 * h, math.pi * r * r
    n_wall = int(n * a_wall / (a_wall + 2 * a_disk))
    n_floor = (n - n_wall) // 2
    n_ceil = n - n_wall - n_floor
    u = torch.rand((n, 2), generator=gen, device=device, dtype=torch.float64)
    th = 2 * math.pi * u[:, 0]
    wall = torch.stack([r * torch.cos(th[:n_wall]),
                        (2 * u[:n_wall, 1] - 1) * h,
                        r * torch.sin(th[:n_wall])], 1)
    rr = r * torch.sqrt(u[n_wall:, 1])
    y = torch.cat([torch.full((n_floor,), -h, dtype=torch.float64,
                              device=device),
                   torch.full((n_ceil,), h, dtype=torch.float64,
                              device=device)])
    disks = torch.stack([rr * torch.cos(th[n_wall:]), y,
                         rr * torch.sin(th[n_wall:])], 1)
    pts = torch.cat([wall, disks])
    pts = pts + scene["noise"] * torch.randn(pts.shape, generator=gen,
                                             device=device,
                                             dtype=torch.float64)
    pts = pts.to(torch.float32)
    vox = torch.unique(torch.round(pts / voxel).to(torch.int64), dim=0)
    return vox.to(torch.float32) * voxel


def grid_sizes(gs: dict) -> dict:
    """Floats of each hash table (the 8-padded levels, 4 features each):
    the 3D encoder and the three planes."""
    F = gs["n_features_per_level"]

    def size(res, dim, log2):
        return sum(int(math.ceil(min(2 ** log2, r ** dim) / 8) * 8)
                   for r in res) * F
    xyz = size(gs["resolutions_3d"], 3, gs["log2_hashmap_size_3d"])
    plane = size(gs["resolutions_2d"], 2, gs["log2_hashmap_size_2d"])
    return {"xyz": xyz, "xy": plane, "xz": plane, "yz": plane}


def head_shapes(gs: dict) -> dict:
    """The decode heads' layer widths (the ``Heads`` module's): opacity,
    cov and color from the feature and the view, grid and deform from the
    hash-grid context."""
    F, K = gs["feat_dim"], gs["n_offsets"]
    ctx = (len(gs["resolutions_3d"]) + 3 * len(gs["resolutions_2d"])) \
        * gs["n_features_per_level"]
    return {"opacity": (F + 4, F, K), "cov": (F + 4, F, 7 * K),
            "color": (F + 4, F, 3 * K),
            "grid": (ctx, 2 * F, (F + 6 + 3 * K) * 2 + 3),
            "deform": (ctx, 2 * F, 2 * K)}


def make_weights(config: dict, anchors: torch.Tensor, capacity: int,
                 seed: int, device) -> dict:
    """The model's leaves at a trained scale: the anchors' from ``seed``,
    the heads and hash tables from the scene's seed (one trained model's
    heads: heads drawn anew for each seed change how many children are
    valid, and so each run's work). Features
    ~N(0, feat_std), child offsets ~N(0, offset_std), log scales
    log(voxel) + scale_shift + N(0, scale_std), masks on, identity
    rotations, opacity 0.1 (the frozen leaves as the program initializes
    them); the heads' layers
    uniform in +-1/sqrt(fan_in) with the opacity head's output bias
    +opacity_bias and the color head's output weights x color_gain (most
    children visible, colors spread over [0, 1]), the deform head's
    output bias +10 on its even rows; hash tables uniform in +-1e-4.
    The capacity's empty slots are the program's (``init_from_points``):
    zeros, their anchor at the origin and their log scales 0.
    """
    gs, w, scene = config["gsconfig"], config["weights"], config["scene"]
    C, n = capacity, anchors.shape[0]
    if n > C:
        raise ValueError(f"{n} anchors exceed the capacity {C}")
    F, K = gs["feat_dim"], gs["n_offsets"]
    normal = torch.randn((C * (F + 3 * K + 6),),
                         generator=_generator(seed, device), device=device)
    feat, offset, scaling = normal.split([C * F, C * 3 * K, C * 6])
    heads = head_shapes(gs)
    layer_sizes = [(a, b) for dims in heads.values()
                   for a, b in zip(dims[:-1], dims[1:])]
    tables = grid_sizes(gs)
    n_uniform = sum(b * a + b for a, b in layer_sizes) + sum(tables.values())
    uniform = torch.rand((n_uniform,), device=device,
                         generator=_generator(scene["scene_seed"] + 1, device))
    f32 = dict(dtype=torch.float32, device=device)
    alive = torch.arange(C, device=device) < n
    live = alive[:, None].to(torch.float32)
    out = {
        "state.anchor": torch.cat([anchors, anchors.new_zeros(C - n, 3)]),
        "state.offset": offset.view(C, 3 * K) * w["offset_std"] * live,
        "state.mask_logit": live.expand(C, K).contiguous(),
        "state.feat": feat.view(C, F) * w["feat_std"] * live,
        "state.scaling_log": torch.where(
            live > 0, math.log(gs["voxel_size"]) + w["scale_shift"]
            + scaling.view(C, 6) * w["scale_std"], 0.0),
        "state.rotation": torch.tensor([1.0, 0, 0, 0], **f32)
        .expand(C, 4) * live,
        "state.opacity_raw": live * float(np.log(0.1 / 0.9)),
        "state.alive": alive,
    }
    at = 0
    for name, dims in heads.items():
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            bound = 1.0 / math.sqrt(a)
            wt = uniform[at:at + a * b].view(b, a) * 2 - 1
            bias = uniform[at + a * b:at + a * b + b] * 2 - 1
            at += a * b + b
            out[f"heads.{name}.{2 * i}.weight"] = wt * bound
            out[f"heads.{name}.{2 * i}.bias"] = bias * bound
    last = {k: 2 * (len(d) - 2) for k, d in heads.items()}
    out[f"heads.opacity.{last['opacity']}.bias"] += w["opacity_bias"]
    out[f"heads.color.{last['color']}.weight"] *= w["color_gain"]
    out[f"heads.deform.{last['deform']}.bias"][0::2] += 10.0
    for name, size in tables.items():
        out[f"grid.{name}"] = (uniform[at:at + size] * 2 - 1) * 1e-4
        at += size
    return {k: (v.reshape(-1) if k.startswith("state.") else v).contiguous()
            for k, v in out.items()}


def load_cameras(path: str, width: int, height: int) -> dict:
    """The orbit's cameras (NeRF camera-to-world, OpenGL axes) -> float32
    arrays: ``viewmat`` [N, 4, 4] world -> view (COLMAP axes),
    ``full_proj`` [N, 4, 4] world -> clip, ``center`` [N, 3], and the
    fields of view."""
    with open(path) as f:
        data = json.load(f)
    fovx = data["camera_angle_x"]
    focal = width / (2 * math.tan(fovx / 2))
    fovy = 2 * math.atan(height / (2 * focal))
    c2w = np.asarray(data["transform_matrix"], np.float64)
    c2w[:, :3, 1:3] *= -1
    view = np.linalg.inv(c2w)
    P = np.zeros((4, 4))
    P[0, 0] = 1 / math.tan(fovx / 2)
    P[1, 1] = 1 / math.tan(fovy / 2)
    P[2, 2] = ZFAR / (ZFAR - ZNEAR)
    P[2, 3] = -(ZFAR * ZNEAR) / (ZFAR - ZNEAR)
    P[3, 2] = 1.0
    view = view.astype(np.float32)
    full = (P.astype(np.float32) @ view).astype(np.float32)
    center = np.linalg.inv(view.astype(np.float64))[:, :3, 3]
    return {"viewmat": view, "full_proj": full,
            "center": center.astype(np.float32), "fovx": fovx, "fovy": fovy,
            "focal": focal}


def make_targets(cams: dict, scene: dict, width: int, height: int,
                 device) -> tuple[torch.Tensor, torch.Tensor]:
    """Each view's target: the room's walls, floor and ceiling as the
    camera sees them, cast ray by ray (the nearest hit of the cylinder and
    the two disks), textured by a sum of seeded sinusoids of the hit point
    -> images [N, H, W, 3] in [0, 1] and view-space depths [N, H, W]. The
    texture is the room's, from the scene's seed."""
    gen = _generator(scene["scene_seed"] + 2, device)
    waves = torch.randn((3, 6, 4), generator=gen, device=device)
    view = torch.as_tensor(cams["viewmat"], device=device)
    center = torch.as_tensor(cams["center"], device=device)
    focal = cams["focal"]
    v, u = torch.meshgrid(torch.arange(height, device=device,
                                       dtype=torch.float32),
                          torch.arange(width, device=device,
                                       dtype=torch.float32), indexing="ij")
    d_view = torch.stack([(u + 0.5 - width / 2) / focal,
                          (v + 0.5 - height / 2) / focal,
                          torch.ones_like(u)], -1)              # [H, W, 3]
    rot = view[:, :3, :3]                                       # [N, 3, 3]
    d = torch.einsum("nji,hwj->nhwi", rot, d_view)              # world
    o = center[:, None, None, :]
    r, h = scene["radius"], scene["half_height"]
    a = d[..., 0] ** 2 + d[..., 2] ** 2
    b = 2 * (o[..., 0] * d[..., 0] + o[..., 2] * d[..., 2])
    c = o[..., 0] ** 2 + o[..., 2] ** 2 - r * r
    t_wall = (-b + torch.sqrt(torch.clamp(b * b - 4 * a * c, min=0))) \
        / torch.clamp(2 * a, min=1e-12)
    dy = d[..., 1]
    t_disk = torch.where(dy > 0, (h - o[..., 1]) / dy.clamp(min=1e-12),
                         (-h - o[..., 1]) / (-dy).clamp(min=1e-12))
    t = torch.minimum(t_wall, t_disk)                           # view z
    p = o + t[..., None] * d
    feats = torch.einsum("nhwk,cjk->nhwcj", p, 3.0 * waves[..., :3])
    color = 0.5 + 0.12 * torch.sin(feats + waves[..., 3]).sum(-1)
    return color.clamp(0.0, 1.0).contiguous(), t.contiguous()

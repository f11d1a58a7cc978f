"""Noisy-pose evaluation cameras (reference utils/pose_noise_util.py).

The port's copy of ``bloomscene_tpu/scene/pose_noise.py`` (host numpy).

Interpolated gaussian noise applied in Euler-angle space to train poses,
producing the "noisy-pose robustness" eval set (apply_noise_bloomscene,
pose_noise_util.py:89-145).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..ops.graphics import world_to_view
from .cameras import Camera


def sample_noise(n, r_max, t_max, rng):
    nr = np.clip(rng.normal(0, r_max / 2.0, (n, 3)), -r_max, r_max)
    nt = np.clip(rng.normal(0, t_max / 2.0, (n, 3)), -t_max, t_max)
    return nr, nt


def interpolate_noise(n, steps):
    last = np.linspace(n[-1], n[-1], num=steps)
    segs = [np.linspace(n[i], n[i + 1], num=steps)
            for i in range(n.shape[0] - 1)]
    segs.append(last)
    return np.concatenate(segs, axis=0)


def rotmat_to_euler(R):
    sy = np.sqrt(R[0, 0] ** 2 + R[1, 0] ** 2)
    if sy >= 1e-6:
        return np.array([np.arctan2(R[2, 1], R[2, 2]),
                         np.arctan2(-R[2, 0], sy),
                         np.arctan2(R[1, 0], R[0, 0])])
    return np.array([np.arctan2(-R[1, 2], R[1, 1]),
                     np.arctan2(-R[2, 0], sy), 0.0])


def euler_to_rotmat(t):
    Rx = np.array([[1, 0, 0],
                   [0, np.cos(t[0]), -np.sin(t[0])],
                   [0, np.sin(t[0]), np.cos(t[0])]])
    Ry = np.array([[np.cos(t[1]), 0, np.sin(t[1])],
                   [0, 1, 0],
                   [-np.sin(t[1]), 0, np.cos(t[1])]])
    Rz = np.array([[np.cos(t[2]), -np.sin(t[2]), 0],
                   [np.sin(t[2]), np.cos(t[2]), 0],
                   [0, 0, 1]])
    return Rz @ Ry @ Rx


def apply_pose_noise(cameras: list[Camera], chunk_size: int = 10,
                     r_max: float = 2.0, t_max: float = 0.05,
                     seed: int = 0) -> list[Camera]:
    """Returns noisy copies of ``cameras`` for evaluation.

    ``(R, t)`` here are read from the stored world->view matrix in the same
    decomposition the reference uses (R = W2V[:3,:3]^T, t = W2V[:3,3]).
    """
    rng = np.random.default_rng(seed)
    n = len(cameras) // chunk_size + (len(cameras) % chunk_size != 0)
    nr, nt = sample_noise(n, r_max, t_max, rng)
    nr = interpolate_noise(nr, chunk_size)
    nt = interpolate_noise(nt, chunk_size)

    noisy = []
    for idx, cam in enumerate(cameras):
        R = cam.viewmat[:3, :3].T
        t = cam.viewmat[:3, 3].copy()
        e = np.degrees(rotmat_to_euler(R))
        e = e + nr[idx // chunk_size]
        t = t + nt[idx // chunk_size]
        Rn = euler_to_rotmat(np.radians(e))
        noisy.append(dataclasses.replace(
            cam, viewmat=world_to_view(Rn, t), name=cam.name + "_noisy"))
    return noisy

"""Progressive crossmodal scene generation (generate_pcd equivalent).

The port of ``bloomscene_tpu/pipeline/pcdgen.py``, bit for bit the same
host numpy and scipy (Delaunay-linear ``griddata`` has no exact torch
twin, and the stage runs once per scene); images are resized with
``utils/image.resize``, PIL's bicubic, rather than PIL itself.

A numpy re-implementation of the reference pipeline
(bloomscene.py:428-656): iteratively warp the world point cloud into each
rotate360 pose, diffusion-inpaint the holes, monocular-depth-lift the new
pixels (with scale alignment + border depth compensation), and accumulate;
then reproject into 5 hemisphere-jitter poses per view to build the
supervision frames (depth supervision = depth-prior prediction of the
reprojection, bloomscene.py:650-654).

This stage is host-side by design: it is dominated by the diffusion /
depth priors (pluggable, see ``priors``), runs once per scene, and feeds
the training loop on the card through the traindata dict.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
from scipy.interpolate import griddata
from scipy.ndimage import maximum_filter, minimum_filter

from ..config import CameraConfig
from ..priors import DepthPrior, InpaintPrior
from ..scene.trajectory import get_pcd_gen_poses
from ..utils.image import resize
from ..utils.io import save_ply_pointcloud

YZ_REVERSE = np.diag([1.0, -1.0, -1.0])


def resize_or_crop_input(rgb: np.ndarray, cam: CameraConfig,
                         inpaint: InpaintPrior, prompt: str,
                         negative_prompt: str, seed: int):
    """Square-pad + outpaint, or center-crop (bloomscene.py:431-453).

    NOTE (documented deviation): in the reference, this path hands
    ``mask2`` (1 = padding) to ``.rgb()`` which inverts it
    (bloomscene.py:91), so SD would inpaint the *known* photo region — an
    apparent bug in the rarely-hit non-square input path. Here the padding
    region is outpainted, which is the evident intent.
    """
    h_in, w_in = rgb.shape[:2]
    if w_in / h_in > 1.1 or h_in / w_in > 1.1:
        res = max(w_in, h_in)
        image_in = np.zeros((res, res, 3), np.float32)
        mask_in = np.ones((res, res), np.float32)
        y0 = int(res / 2 - h_in / 2)
        x0 = int(res / 2 - w_in / 2)
        image_in[y0:y0 + h_in, x0:x0 + w_in] = rgb
        mask_in[y0:y0 + h_in, x0:x0 + w_in] = 0
        image2 = _resize(image_in, (cam.H, cam.W))
        mask2 = _resize(mask_in[..., None], (cam.H, cam.W))[..., 0]
        return inpaint(image2, mask2, prompt, negative_prompt, seed)
    if w_in > h_in:
        x0 = int(w_in / 2 - h_in / 2)
        crop = rgb[:, x0:x0 + h_in]
    else:
        y0 = int(h_in / 2 - w_in / 2)
        crop = rgb[y0:y0 + w_in]
    return _resize(crop, (cam.H, cam.W))


def _resize(img: np.ndarray, shape):
    """Float [0, 1] image -> ``shape``, each channel through uint8 (the
    JAX package's per-channel PIL resize)."""
    arr = np.clip(img, 0, 1)
    if arr.ndim == 2:
        arr = arr[..., None]
    chans = [resize((arr[..., c] * 255).astype(np.uint8), shape) / 255.0
             for c in range(arr.shape[-1])]
    out = np.stack(chans, -1).astype(np.float32)
    return out if img.ndim == 3 else out[..., 0]


def _backproject(K_inv, x, y, depth):
    """Pixel grid + depth -> camera-space points [3, H*W]."""
    return K_inv @ np.stack((x * depth, y * depth, depth), 0).reshape(3, -1)


def _adam_scale_align(p_target, p_new, iters: int = 100, lr: float = 1e-3):
    """Scalar world-scale alignment.

    The reference runs 100 Adam steps on a scalar sc minimizing
    mean((P_target - sc*P_new)^2) (bloomscene.py:520-535) — a quadratic
    whose closed form is <Pt,Pn>/<Pn,Pn>; the short Adam run only crawls
    toward it. We replicate the Adam trajectory exactly (same lr/steps) for
    behavioral parity.
    """
    sc = 1.0
    m = v = 0.0
    b1, b2, eps = 0.9, 0.999, 1e-8
    pn2 = float(np.mean(np.sum(p_new * p_new, 0)))
    ptpn = float(np.mean(np.sum(p_target * p_new, 0)))
    for t in range(1, iters + 1):
        g = 2.0 / 3.0 * (sc * pn2 - ptpn)  # d/dsc mean over 3N elements
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / (1 - b1 ** t)
        vh = v / (1 - b2 ** t)
        sc -= lr * mh / (np.sqrt(vh) + eps)
    return float(sc)


def generate_pcd(rgb_cond: np.ndarray, prompt: str, negative_prompt: str,
                 pcdgenpath: str, seed: int, diff_steps: int,
                 cam: CameraConfig, inpaint: InpaintPrior,
                 depth_prior: DepthPrior, save_ply_path: Optional[str] = None,
                 progress=None) -> dict:
    """Returns the traindata dict (bloomscene.py:592-599, 651-655)."""
    H, W, K = cam.H, cam.W, cam.K
    K_inv = np.linalg.inv(K)

    image_curr = resize_or_crop_input(rgb_cond, cam, inpaint, prompt,
                                      negative_prompt, seed)
    render_poses = get_pcd_gen_poses(pcdgenpath)
    depth_curr = depth_prior(image_curr)
    h_in, w_in = rgb_cond.shape[:2]
    cy, cx = h_in // 2, w_in // 2
    center_depth_list = [float(np.mean(
        depth_curr[max(cy - 10, 0):cy + 10, max(cx - 10, 0):cx + 10]))]

    x, y = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32), indexing='xy')
    edgeN = 2
    edgemask = np.pad(np.ones((H - 2 * edgeN, W - 2 * edgeN)),
                      ((edgeN, edgeN), (edgeN, edgeN)))
    grid = np.stack((x, y), -1).reshape(-1, 2)

    # view 0 backprojection (bloomscene.py:469-473)
    R0, T0 = render_poses[0, :3, :3], render_poses[0, :3, 3:4]
    pts_cam = _backproject(K_inv, x, y, depth_curr)
    pts_world = (np.linalg.inv(R0) @ pts_cam
                 - np.linalg.inv(R0) @ T0).astype(np.float32)
    colors = image_curr.reshape(-1, 3).astype(np.float32)

    for i in range(1, len(render_poses)):
        if progress:
            progress(f"pcdgen view {i}/{len(render_poses) - 1}")
        R, T = render_poses[i, :3, :3], render_poses[i, :3, 3:4]
        pts_cam2 = R @ pts_world + T
        pix = K @ pts_cam2
        valid_idx = np.where(
            (pix[2] > 0)
            & (pix[0] / pix[2] >= 0) & (pix[0] / pix[2] <= W - 1)
            & (pix[1] / pix[2] >= 0) & (pix[1] / pix[2] <= H - 1))[0]
        pix2 = pix[:2, valid_idx] / pix[2:, valid_idx]
        rc = np.round(pix2).astype(np.int32)

        image2 = griddata(pix2.T, colors[valid_idx], grid, method='linear',
                          fill_value=0).reshape(H, W, 3)
        image2 = (edgemask[..., None] * image2
                  + (1 - edgemask[..., None])
                  * np.pad(image2[1:-1, 1:-1],
                           ((1, 1), (1, 1), (0, 0)), mode='edge'))
        round_mask = np.zeros((H, W), np.float32)
        round_mask[rc[1], rc[0]] = 1
        round_mask = maximum_filter(round_mask, size=9)
        image2 = (round_mask[..., None] * image2
                  + (1 - round_mask[..., None]) * (-1))
        mask2 = minimum_filter((image2.sum(-1) != -3) * 1, size=11)
        image2 = mask2[..., None] * image2

        # hole-border pixels of the warp (bloomscene.py:501-504)
        mask_hf = (np.abs(mask2[:H - 1, :W - 1] - mask2[1:, :W - 1])
                   + np.abs(mask2[:H - 1, :W - 1] - mask2[:H - 1, 1:]))
        mask_hf = np.pad(mask_hf, ((0, 1), (0, 1)), 'edge')
        mask_hf = np.where(mask_hf < 0.3, 0, 1)
        border_valid = np.where(mask_hf[rc[1], rc[0]] == 1)[0]

        image_curr = inpaint(np.clip(image2, 0, 1), 1.0 - mask2, prompt,
                             negative_prompt, seed, num_steps=diff_steps)
        depth_curr = depth_prior(image_curr)
        center_depth_list.append(float(np.mean(
            depth_curr[max(cy - 10, 0):cy + 10, max(cx - 10, 0):cx + 10])))

        # scale alignment on warped-visible pixels (bloomscene.py:519-535)
        cam_pts = _backproject(K_inv, x, y, depth_curr).reshape(3, H, W)
        cam_sel = cam_pts[:, rc[1], rc[0]]
        world_sel = (np.linalg.inv(R) @ cam_sel - np.linalg.inv(R) @ T)
        sc = _adam_scale_align(pts_world[:, valid_idx], world_sel)

        # border depth compensation (bloomscene.py:537-569)
        cam_border = cam_pts[:, rc[1, border_valid], rc[0, border_valid]]
        world_border = (np.linalg.inv(R) @ cam_border
                        - np.linalg.inv(R) @ T) * sc
        cam_origin = -np.linalg.inv(R) @ T
        v_cam = world_border - cam_origin
        v_pcd = pts_world[:, valid_idx[border_valid]] - cam_origin
        coeff = (np.sum(v_pcd * v_cam, 0)
                 / np.maximum(np.sum(v_cam * v_cam, 0), 1e-12))
        compensated_world = cam_origin + v_cam * coeff[None, :]
        comp_cam = R @ compensated_world + T
        homog_cam = R @ world_border + T
        comp_depth = comp_cam[-1] - homog_cam[-1]
        pix_corr = np.concatenate(
            [pix2[:, border_valid],
             np.array([[0, 0, W - 1, W - 1], [0, H - 1, 0, H - 1]])], 1).T
        comp_depth = np.concatenate([comp_depth, np.zeros(4)])

        hole = np.where(1 - mask2.reshape(-1))[0]
        hole_xy = np.stack(np.where(1 - mask2), 1)[:, [1, 0]]
        nd_lin = griddata(pix_corr, comp_depth, hole_xy, method='linear')
        nd_near = griddata(pix_corr, comp_depth, hole_xy, method='nearest')
        new_depth = np.where(np.isnan(nd_lin), nd_near, nd_lin)

        # lift hole pixels with compensated depth (bloomscene.py:571-583)
        pts_cam_new = _backproject(K_inv, x, y, depth_curr)[:, hole]
        xh = x.reshape(-1)[hole]
        yh = y.reshape(-1)[hole]
        comp_cam_new = K_inv @ np.stack(
            (xh * new_depth, yh * new_depth, new_depth), 0)
        warped = pts_cam_new + comp_cam_new
        new_world = (np.linalg.inv(R) @ warped
                     - np.linalg.inv(R) @ T).astype(np.float32) * sc
        new_colors = image_curr.reshape(-1, 3)[hole].astype(np.float32)

        pts_world = np.concatenate([pts_world, new_world], -1)
        colors = np.concatenate([colors, new_colors], 0)

    if save_ply_path:
        save_ply_pointcloud(save_ply_path, pts_world.T, colors)

    traindata = {
        'camera_angle_x': cam.fov[0],
        'W': W, 'H': H,
        'pcd_points': pts_world,
        'pcd_colors': colors,
        'frames': [],
    }

    # supervision frames: hemisphere jitter reprojections
    # (bloomscene.py:601-655)
    internal_poses = get_pcd_gen_poses('hemisphere', center_depth_list)
    per = len(internal_poses) // len(render_poses)
    for i in range(len(render_poses)):
        for j in range(per):
            idx = per * i + j
            if progress:
                progress(f"supervision frame {idx + 1}/{len(internal_poses)}")
            Rw2i = render_poses[i, :3, :3]
            Tw2i = render_poses[i, :3, 3:4]
            Ri2j = internal_poses[idx, :3, :3]
            Ti2j = internal_poses[idx, :3, 3:4]
            Rw2j = Ri2j @ Rw2i
            Tw2j = Ri2j @ Tw2i + Ti2j
            Rj2w = (YZ_REVERSE @ Rw2j).T
            Tj2w = -Rj2w @ (YZ_REVERSE @ Tw2j)
            c2w = np.eye(4)
            c2w[:3, :3] = Rj2w
            c2w[:3, 3:4] = Tj2w

            pts_camj = Rw2j @ pts_world + Tw2j
            pixj = K @ pts_camj
            vj = np.where(
                (pixj[2] > 0)
                & (pixj[0] / pixj[2] >= 0) & (pixj[0] / pixj[2] <= W - 1)
                & (pixj[1] / pixj[2] >= 0)
                & (pixj[1] / pixj[2] <= H - 1))[0]
            if vj.size == 0:
                continue
            depthsj = pixj[2:, vj]
            pixj2 = pixj[:2, vj] / depthsj
            rcj = np.round(pixj2).astype(np.int32)

            imagej = griddata(pixj2.T, colors[vj], grid, method='linear',
                              fill_value=0).reshape(H, W, 3)
            imagej = (edgemask[..., None] * imagej
                      + (1 - edgemask[..., None])
                      * np.pad(imagej[1:-1, 1:-1],
                               ((1, 1), (1, 1), (0, 0)), mode='edge'))
            maskj = np.zeros((H, W), np.float32)
            maskj[rcj[1], rcj[0]] = 1
            maskj = maximum_filter(maskj, size=9)
            imagej = maskj[..., None] * imagej + (1 - maskj[..., None]) * -1
            maskj = minimum_filter((imagej.sum(-1) != -3) * 1, size=11)
            imagej = np.clip(maskj[..., None] * imagej, 0, 1)

            depth_pred = depth_prior(imagej)
            traindata['frames'].append({
                'image': imagej.astype(np.float32),
                'depth': np.asarray(depth_pred, np.float32),
                'transform_matrix': c2w.tolist(),
            })
    return traindata

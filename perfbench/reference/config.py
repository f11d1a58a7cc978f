"""Configuration for the PyTorch port of BloomScene.

An own copy of the JAX package's ``GSConfig`` / ``CameraConfig``: the same
fields, defaults and documentation, so a configuration means the same thing
to both packages. Hyperparameters mirror the reference's ``GSParams`` /
``CameraParams``; anything the reference hardcodes deep in its code (the
feat_dim=50 override, the hash-grid resolution lists) is an explicit field.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class GSConfig:
    """Training / model hyperparameters (reference arguments.py:4-98)."""

    # --- model shape ---
    feat_dim: int = 50          # anchor feature width. NOTE: the reference sets
                                # GSParams.feat_dim=32 but force-overrides to 50
                                # (gaussian_model.py:149); we use 50 directly.
    n_offsets: int = 10         # K offsets (child Gaussians) per anchor
    voxel_size: float = 0.001   # 0 => adaptive from median KNN distance
    update_depth: int = 3       # densification hierarchy levels
    update_init_factor: int = 16
    update_hierachy_factor: int = 4
    use_feat_bank: bool = False
    white_background: bool = False
    # color decode: 'mlp' = view-conditioned MLP RGB (the reference
    # pipeline's path, gaussian_renderer/__init__.py:180,257-258);
    # 'sh' = the color head emits per-child SH coefficients from the
    # view-independent anchor feature and ops.sh.eval_sh turns them into
    # view-dependent RGB (the rasterizer-contract SH path the reference
    # ships but never uses, forward.cu:20-72,243)
    color_mode: str = 'mlp'
    sh_degree: int = 1          # 0..3; only read when color_mode == 'sh'

    # --- schedule ---
    iterations: int = 2990
    position_lr_init: float = 0.0016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 2990

    offset_lr_init: float = 0.01
    offset_lr_final: float = 0.0001
    offset_lr_delay_mult: float = 0.01
    offset_lr_max_steps: int = 2990

    mask_lr_init: float = 0.01
    mask_lr_final: float = 0.0001
    mask_lr_delay_mult: float = 0.01
    mask_lr_max_steps: int = 2990

    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001

    mlp_opacity_lr_init: float = 0.002
    mlp_opacity_lr_final: float = 0.00002
    mlp_opacity_lr_delay_mult: float = 0.01
    mlp_opacity_lr_max_steps: int = 2990

    mlp_cov_lr_init: float = 0.004
    mlp_cov_lr_final: float = 0.004
    mlp_cov_lr_delay_mult: float = 0.01
    mlp_cov_lr_max_steps: int = 2990

    mlp_color_lr_init: float = 0.008
    mlp_color_lr_final: float = 0.00005
    mlp_color_lr_delay_mult: float = 0.01
    mlp_color_lr_max_steps: int = 2990

    mlp_featurebank_lr_init: float = 0.01
    mlp_featurebank_lr_final: float = 0.00001
    mlp_featurebank_lr_delay_mult: float = 0.01
    mlp_featurebank_lr_max_steps: int = 2990

    encoding_xyz_lr_init: float = 0.005
    encoding_xyz_lr_final: float = 0.00001
    encoding_xyz_lr_delay_mult: float = 0.33
    encoding_xyz_lr_max_steps: int = 2990

    mlp_grid_lr_init: float = 0.005
    mlp_grid_lr_final: float = 0.00001
    mlp_grid_lr_delay_mult: float = 0.01
    mlp_grid_lr_max_steps: int = 2990

    mlp_deform_lr_init: float = 0.005
    mlp_deform_lr_final: float = 0.0005
    mlp_deform_lr_delay_mult: float = 0.01
    mlp_deform_lr_max_steps: int = 2990

    # --- densification (Scaffold-GS, reference arguments.py:79-94) ---
    start_stat: int = 200
    update_from: int = 500
    update_interval: int = 100
    update_until: int = 2000
    # densification pause window [pause_from, pause_until) — the reference
    # hardcodes `1000, 1500` at bloomscene.py:346; configurable here.
    densify_pause_from: int = 1000
    densify_pause_until: int = 1500
    percent_dense: float = 0.01
    densify_grad_threshold: float = 0.0002
    min_opacity: float = 0.005
    success_threshold: float = 0.8

    # --- losses ---
    lambda_dssim: float = 0.2
    lambda_scaling_reg: float = 0.01    # bloomscene.py:289-290
    # depth-prior regularizers (DPR); reference CLI flags run.py:41-47
    use_dpr: bool = False
    lambda_dep_value: float = 0.1
    lambda_dep_domin: float = 0.01
    lambda_dep_smooth: float = 0.1
    # normalize the CMD (dep_domin) moment norms to RMS scale. The
    # reference's raw-L2 CMD is ~500x a mean-based loss at 512^2, which
    # is harmless there (its rasterizer has no depth backward,
    # backward.cu:539-554) but swamps the RGB gradients here where depth
    # gradients DO flow (train/losses.py cmd() docstring, DPR_AB.json).
    cmd_normalized: bool = True
    # structured context compression (SCC) rate loss
    lambda_entropy: float = 0.001       # lambdae in run.py:51

    # --- SCC / HAC compression head (reference gaussian_model.py:128-151) ---
    use_scc: bool = True
    anchor_round_digits: int = 16       # encodings.py:12
    q_feat: float = 1.0                 # Q base before 0.25 scale (see codec)
    n_features_per_level: int = 4
    log2_hashmap_size_3d: int = 13
    resolutions_3d: Tuple[int, ...] = (18, 24, 33, 44, 59, 80, 108, 148, 201,
                                       275, 376, 514)
    log2_hashmap_size_2d: int = 15
    resolutions_2d: Tuple[int, ...] = (130, 258, 514, 1026)
    # phase boundaries for quantization-noise schedule
    # (gaussian_renderer/__init__.py:56-100)
    noise_from_step: int = 1000
    context_from_step: int = 2000

    # --- rasterizer (16x16 tiles, as the reference's CUDA blocks) ---
    tile_size: int = 16
    max_splats_per_tile: int = 1024     # static per-tile capacity (XLA shapes)
    # static (splat, tile) pair-buffer size; None = rasterizer default
    # (2x the total tile budget, ops/tile_rasterizer.py). Large scenes at
    # big early-training splat sizes may need more; overflow drops the
    # FARTHEST pairs and is reported per step (train/loop.py warnings).
    pair_capacity: int | None = None
    # post-cull sorted pair list size; None = pair_capacity. The exact-
    # zero cull typically drops 20-40% of pairs, so a snug packed buffer
    # shrinks every pair-proportional stage by that factor.
    packed_capacity: int | None = None
    # when set, decode/rasterize only a bounded bucket of VISIBLE anchors
    # (gathered before decode, as the reference's visible_mask compaction,
    # gaussian_renderer/__init__.py:33-44). Bounds per-step child-array
    # memory/compute by visible_capacity*K instead of capacity*K — required
    # for 500K+ anchor scenes; leave None for small scenes (dense decode).
    visible_capacity: int | None = None
    # rematerialize the decode+render in the backward pass (trades ~30%
    # recompute for the per-child activation memory — required to fit
    # full-scale scenes in 16G HBM)
    remat: bool = True
    # run training in device-loop chunks (Trainer.run(device_loop=True)):
    # up to device_loop_chunk steps a chunk, each a replay of a CUDA graph
    # of the step, the camera read on the card from the chunk's draws —
    # hides the per-step host launch latency. Same step/RNG/event sequence
    # and the same state bit for bit as the host loop (see train/loop.py).
    device_loop: bool = False
    device_loop_chunk: int = 50

    # --- quantization step bases (gaussian_renderer/__init__.py:52-54) ---
    q_base_feat: float = 0.25
    q_base_scaling: float = 2.5e-4
    q_base_offsets: float = 0.05
    rate_subsample: float = 0.05        # gaussian_renderer/__init__.py:100

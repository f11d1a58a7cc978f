#!/usr/bin/env python3
"""Drive the PyTorch port's render, training and pipeline paths on one CUDA
card and hold its kernels against their plain versions.

    python3 chip_smoke.py

Phases, each printing one JSON object on its own line; any failure exits
nonzero:

1. build: compile the CUDA kernels from ``bloomscene_tpu_torch/csrc`` (one
   nvcc per source, in parallel) and load them; the card's name and power
   limit from nvidia-smi. A spill that ptxas reports for any kernel fails
   the run: each keeps its per-thread state in registers.
2. scene: a seeded room-sized point cloud (~2M points on the walls, floor
   and ceiling of a cylinder around the orbit) -> ``init_model`` at
   ``GSConfig(voxel_size=0.03)``, ~110K anchors; features, offsets and head
   weights are given seeded values at a trained scale (no checkpoint ships
   with the repo).
3. render: ``render_model(mode='eval')`` over 8 frames of
   ``cameras/rotate360.json`` at 512x512, with every launch counter set to
   0 just before and read just after; K1, K3 and K4 must have launched once
   per frame, hashgrid_encode twice (the measuring pass decodes each
   camera too), no backward kernel.
4. kernels: on one frame's real inputs, K3 (pair expansion) and K4 (slab
   expansion) must equal their plain versions bit for bit, K1 (blend
   forward) within 1e-5 (color, acc, T) and 1e-4 (depth sum), the
   tolerances of tests/test_pallas_blend.py; times by CUDA events around
   calls queued behind a device-side wait, so they are the device's time
   and not the wrappers' host overhead.
5. reference: a 128x128 view rasterized on the card and by the plain
   PyTorch path on the CPU from the same projected splats must agree
   within the same tolerances.
6. grad_reference: at 128x128, the gradients of a fixed loss with respect
   to mean2d, conic, depth, color, opacity and bg through ``TileBlend`` (K1
   forward, K2 backward) on the card against the plain path on the CPU,
   atol 2e-6 + rtol 2e-4 (tests/test_pallas_blend.py:79-80).
7. train: the same model, perturbed (feature noise, a re-drawn color
   head), trained by ``Trainer.run`` for 30 host-loop steps toward the 8
   orbit frames of phase 3 and their depths, at
   ``GSConfig(voxel_size=0.03, use_dpr=True, start_stat=0)`` (phase 0,
   remat on, no densification step due). Every counter is set to 0 just
   before and read just after: K2 and emission_sums must launch once per
   step, K1, K3 and K4 once per forward (twice per step under remat). One
   line per step, one summary line; losses must be finite, no update
   skipped, and the mean loss of the last 5 steps below that of the first
   5.
8. kernels at the training shapes, on one training step's real inputs
   (pair capacity 2,097,152, where K3 writes the two-key form): K3, K4 and
   K1 against their plain versions as in phase 4; K2 (blend backward)
   within atol 2e-6 + rtol 2e-4 at the loss's scale, and again with the
   cotangent planes scaled by H * W * 3 (K2 is linear in them) and the
   rtol applied to the magnitudes of each entry's pixel terms; most
   entries of every gradient row resolved, planted faults caught, and
   bitwise equal to itself from one launch to the next. Then the
   emission-order reduction (``emission_sums``) on that step's K2 output:
   bitwise its twin on the CPU and equal to itself, within its rounding
   bound of a float64 sum; the plain version's gaps (the cumsum
   difference) to that float64 sum beside the kernel's.
9. phase2_grad_reference: at 128x128, one phase-2 training step (the
   hash-grid context, the adaptive noise, the rate) on copies of the
   untrained model, DETERMINISM_RUNS times on the card and once by the
   plain path on the CPU with the same ``DecodeNoise``: the gradient of
   every trained leaf (anchor leaves, six heads, four hash tables) within
   P2_GRAD_TOL of the leaf's largest on the CPU (the sums run in other
   orders), and bitwise equal between the steps on the card. Where a leaf
   passes the tolerance, ``grad_gate`` finds the anchor rows that carry
   the excess and compares the two sides' forward decisions (the visible
   set, the child opacity mask, the projection's validity, K3's pair
   cull): at most MAX_BOUNDARY_ROWS rows whose differing decisions all
   have their inputs within BOUNDARY_ULPS of their thresholds on both
   sides, and that hold every row with an excess, may be left out; the
   step is run again on both sides with those rows dead and every leaf
   must then pass P2_GRAD_TOL. Each row left out is reported with its
   margin.
10. schedule: a fresh ``Trainer`` on the perturbed untrained model at
   ``GSConfig(**SCHEDULE)``: 40 steps through phase 0 (1-10), phase 1
   (11-20), the bounds refresh (20) and phase 2 (21-40), with
   ``adjust_anchor`` at steps 20 and 30. One line per step (its phase and
   ms), one ``densify`` line per surgery (n_new, n_pruned, n_alive,
   capacity, capacity_grown, time_s), one summary (mean and median step
   ms per phase, the phase-2 rate); losses finite, the phase-2 rate
   finite and positive, exactly two surgeries, n_alive moved by n_new -
   n_pruned, K2 once a step and K1, K3, K4 twice (remat). The trainer
   writes its checkpoint after step RESUME_SAVE_AT (phase 2, past the
   first densification); then ``resume``: a fresh Trainer built from the
   same initial model restores it and runs to step 40, and every model
   leaf, Adam's moments and count, the densify statistics and the three
   generators' states must equal the straight run's bit for bit (the
   save's and restore's seconds, the file's MB).
11. kernels on a phase-2 step's inputs after the densification steps, as
   in phase 8.
12. hashgrid_bwd: the hash grid's deterministic backward on the four
   encoders' cotangent rows of one phase-2 step of the schedule's trainer
   (captured from the step's backward), against a float64 ``index_add_``
   within 1e-6 of each cell's summed magnitudes, against its plain version
   (``index_add_``, atomic), and bitwise equal to itself; times summed over
   the step's four calls: the kernel with its sort's and its sum's shares,
   ``index_add_`` atomic and in PyTorch's deterministic mode, and the
   share of the bound.
13. codec: ``estimate_final_bits``, ``encode_scene`` of the schedule's
   model and ``decode_scene`` with that model as the shell (as
   ``BloomScene.compress`` does): sizes by stream, the estimate, the wall
   times with their context/rANS split; the decoded masks equal the
   encoded ones, the hash tables binarize identically, the features lie
   within two quantization steps, and re-encoding the decoded scene
   reproduces every ``.b`` stream byte for byte.
14. decoded orbit: ``render_model(mode='decoded')`` of the decoded scene
   over the 8 frames with every counter set to 0 just before and read
   just after (K1, K3 and K4 once a frame, nothing else), beside an eval
   render of the encoded scene over the same frames: decoded and eval fps.
15. kernels at the decoded frame's shapes (K3, K4, K1, as in phase 4).
16. golden: at 64x64, a seeded 400-Gaussian scene projected on the card;
   the tile path (K3, K4, K1 forward, K2 backward through ``TileBlend``)
   against ``rasterize_reference(tile=16)``, the dense golden blend that
   shares no binning code with it, on the same projected splats: values
   within tests/test_tile_rasterizer.py's tolerances (color, T and alpha
   1e-5, depth 1e-4) and the gradients of that test's loss with respect to
   mean2d, conic, depth, color, opacity and bg within atol 2e-5 + rtol
   2e-3.
17. growth: a trainer on the perturbed scene cut to a capacity with no
   free slot, 20 steps with ``adjust_anchor`` at step 20, so the capacity
   grows (``capacity_grown`` must be true); the optimizer's rebuilt list
   must hold the model's live leaves, and one more step must change them;
   then, at the grown shape, a phase-2 step's gradients card against CPU
   (as phase 9) and K1-K4 on a phase-2 step's inputs (as phase 8).
18. tiles: one orbit frame rendered at tiles 8, 12, 16, 40 and 64 (12
   and 40: a block with a partial last warp; 40 and 64: a tile split into
   2 and 4 blocks, binned with TILE_CAPACITY slots a tile); the frame
   finite, K1 bitwise and K2 within its magnitude tolerance of their plain
   versions and bitwise across two launches; their times, block shapes and
   splits at each tile, and the overflow counters.
19. phase2_ab: the schedule's trainer goes on for 4 runs of 5 phase-2
   steps, with the hash grid's backward on the kernel, on ``index_add_``,
   on ``index_add_``, on the kernel: the step medians of both.
20. pipeline: ``bloomscene_tpu_torch.pipeline.run.main`` as a user runs it
   (PIPELINE_ARGS: stub priors on examples/01_childroom.png at 128x128,
   voxel 0.03 at the model's default widths, 32,768 slots a tile, 60 steps
   with the DPR losses and a record each step, 8 orbit frames) into
   outputs/chip_smoke/pipeline, its printing sent to main.log there, with
   every counter set to 0 just before and read just after: every output
   file (settings, traindata, the PLYs, the checkpoint, the bitstreams,
   the codec sizes, the training log, the metrics, the eval PNGs, both
   videos or their PNG frame directories), K1, K3 and K4 launched for
   every rendered frame and training forward, K2 once a step, every loss
   finite and the last below the first, and no splat dropped: no step's
   tile, pair or packed overflow, and none in the orbit's or the eval
   views' frames (rendered again after the run, with their statistics).
   The points, anchors and capacity, each stage's wall seconds from the
   BloomScene's own spans (generate, training and its steps/s, compress
   with encode and decode, the orbit with its fps, the eval views with
   theirs), the MB, the proxy metrics and the overflow counters. Then
   K3, K4, K1 and K2 on the trained model's inputs at step 60, as phase 8.
21. cold_start: ``main(['--load_dir', <the pipeline's directory>])``, a
   fresh ``BloomScene.load`` that decodes the bitstreams: the decoded
   anchors, features, scalings, offsets and masks equal the pipeline's
   in-memory decoded model bit for bit, and no decoded frame overflows;
   the decoded orbit's fps. Then K3, K4 and K1 on its first decoded
   frame's inputs, as phase 15.
22. device_loop: a fresh Trainer on the perturbed model at SCHEDULE, run by
   the device loop (``Trainer.run(device_loop=True)``, chunks of
   LOOP_CHUNK: a CUDA graph of the step, captured after the first step of
   each (phase, track_stats) and replayed; chunk ends at every phase
   change and surgery), with every counter set to 0 just before and read
   just after: every model leaf, Adam's moments and count, the
   statistics, the three generators' states and every record equal the
   host loop's of phase 10 at step 40 (a snapshot written after phase 10)
   bit for bit. A wrapper counts its calls, so a captured launch counts
   once at the capture: each kernel's launches are the captures' launches
   times their replays plus the eager steps'; each capture must hold K2
   once, K1, K3 and K4 twice (remat) and hashgrid_bwd 4 times in phase 2,
   and the run must launch them as often as the host loop. Step ms by
   phase (chunk seconds over steps, mean and median, and the device ms a
   replayed step) beside the host loop's of phase 10, the captures and
   their seconds, the replays, the peak memory.
23. device_loop_growth: the growth phase's scene (no free slot) for
   GROWTH_LOOP_STEPS steps with the host loop and with the device loop:
   the surgery at step 20 grows the capacity, a graph is captured at the
   grown shape, and the two runs are bitwise equal, records included.
24. dp: ``Trainer(dp_batch=DP_BATCH)`` at full width over the 8 orbit
   views, DP_STEPS phase-0 steps: the loss falls, K2 once a view; then one
   batched step over DP_BATCH copies of one view against one single-view
   step (tests/test_parallel.py's property: loss rtol 1e-5, leaves atol
   1e-5 and rtol 1e-4, anchor_demon's maximum DP_BATCH); ms a step and a
   view.
25. fit_single_view: ``examples.fit_single_view.fit(steps=FIT_STEPS)``
   with the host loop and with the device loop: the last loss bit for
   bit, the render improved by both, their wall seconds.
26. strip_kernels: on one 512x512 orbit frame's bins and on one phase-0
   training step's, at STRIP_TILES (16, 12: a partial last warp, 40: split
   into blocks), K1 and K2 on the positions' halves [0, T/2) and
   [T/2, T) equal the full call's columns bit for bit; the full call holds
   against its plain version as in phases 4 and 8 (K1 bitwise, K2 within
   its magnitude tolerance); the times of the full call and of each
   strip, beside phases 4's and 8's times of the same full calls.
27-30 run in RANKS processes sharing the card over gloo (NCCL takes one
rank a device), spawned by ``parallel.launch.spawn`` and joined under
RANK_TIMEOUT: a rank that fails or hangs raises out of the script. The
ranks load the scene that phase 2 built (saved once, with the perturbed
start, under outputs/chip_smoke/parallel); the one-process results come
first, from this process. Every launch counter is set to 0 just before
each path and read just after, in each rank.
27. tile_parallel: a (1, RANKS) mesh on phase 2's scene at 512x512:
   ``make_tile_parallel_render`` of the first orbit frame (eval and train
   mode) and one phase-0 ``make_tile_parallel_train_step`` from the
   perturbed start: color, depth, loss and every updated leaf bitwise the
   one-process ``render`` and ``make_train_step``; each rank launches K1
   once a frame and K1 twice (remat) and K2 once a step, on its 512 of the
   1,024 positions; the ms a frame and a step of each rank beside the
   one-process ms.
28. dp_mesh: ``Trainer(mesh=(RANKS, 1), dp_batch=MESH_BATCH)`` at full
   width over the 8 orbit views at MESH_SCHEDULE (DP_STEPS phase-0 steps,
   then phase-2 steps across one ``adjust_anchor``): the loss within
   tests/test_parallel.py:185-189's tolerances of the one-process
   ``Trainer(dp_batch=MESH_BATCH)``'s and the psnr within 5e-3, the same
   surgery and the same anchors alive, the ranks' leaves, Adam states,
   statistics, generators and records bitwise equal to each other, K2
   once a view and hashgrid_bwd 4 times a phase-2 view on each rank; the
   ms a step and a view.
29. nccl_world1: one process, NCCL at world size 1,
   ``Trainer(mesh=(1, 1), dp_batch=MESH_BATCH)`` for NCCL_STEPS steps:
   the state and records bitwise those of ``Trainer(dp_batch=MESH_BATCH)``
   from the same start in the same process.
30. ring: ``ring_render`` over the RANKS ranks of a seeded
   RING_SPLATS-splat scene at RING_SIZE x RING_SIZE: the image and the
   gradients of tests/test_ring.py's loss against ``rasterize_reference``
   on the card within that test's tolerances (the scene's minimum final
   T above 2e-4, its precondition), every rank the same; the wall ms of
   the ring's forward and of forward and backward.
31. fullscale_short: ``run_fullscale.run`` (the path of ``python -m
   bloomscene_tpu_torch.run_fullscale``) at FULLSCALE_ARGS (128x128, 60
   steps, 8 orbit frames) with FULLSCALE_CUT (phase 10's step numbers cut
   to cross phases 0-2 and two surgeries in the device loop; 32,768 slots
   a tile), a training record every step, into
   outputs/chip_smoke/fullscale_short, with every counter set to 0 just
   before and read just after: every step finite and no splat dropped (the
   steps, the decoded orbit's and the training views' frames), the re-encode
   byte-exact, every output file there, no chunk's peak memory above the
   first of its kind in its phase by more than 2%, each capture holding
   the step's kernels, K2 once a step, K1, K3 and K4 twice a step and once
   a rendered frame, hashgrid_bwd four times a phase-2 step. Then K3, K4,
   K1 and K2 on its last step's inputs, as phase 20.
32. compacted_step: the compacted decode at run_fullscale's
   ``--visible_capacity`` (COMPACT_CAPACITY of phase 2's 139,264 rows,
   the bucket padded with row C - 1) on the perturbed start of phase 7:
   ``Trainer.run`` at COMPACT_LOOP (phase 0, the bounds refresh, phase 2)
   with the host loop and with the device loop, every counter set to 0
   just before each and read just after: bitwise equal, records included,
   gather_rows_bwd twice a step (the row gather's backward and the densify
   statistics; twice in each captured step) and every kernel launched as
   often in both; both loops again with the statistics through the atomic
   ``index_add`` (gather_rows_bwd's plain version, the path before the
   kernel): every leaf, moment and statistic the same bits as the
   kernel's run of that loop. Then one phase-0 and one phase-2 step
   (``step_gradients``) compacted and dense from the same start with the
   same draws per anchor, at COMPACT_SAME_FN: every alive row's gradient on
   every trained per-anchor leaf equal to the bit but for a zero's sign
   (the gather's backward adds from +0). The cotangents the row gather's
   backward takes in a phase-0, 1 and 2 step at the default config: the
   padding entries' exactly zero and all finite. gather_rows_bwd on phase
   0's: the same bits from two launches, bitwise its plain version on the
   CPU on every row whose run is one entry, and on the pad row bitwise
   where the padding's cotangents are zero (else within the rounding of
   two float32 sums of its run). gather_rows_bwd where runs that cross
   pieces carry values (``crossing_runs``): the main path's index with a
   seeded nonzero cotangent on every entry, and with row C - 1 live;
   bitwise its numpy twin, the same bits twice, within (longest run) x
   2^-24 of the summed magnitudes of a float64 ``index_add_``, and with
   row C - 1 live bitwise the CPU's plain version where the padding's
   cotangents are zero; the same two cases on the statistics' index,
   widths and bases (within (longest run + 1) x 2^-24 there). The
   statistics' scatter of a compacted step (``stats_scatter``): the same
   bits twice and bitwise the atomic ``index_add``, its ms against that
   and against the flat ``index_add`` of the path before it. The
   compacted and the dense step's device ms and ``train.stats`` device
   ms; the backward's ms against torch's backward of ``x[idx]``
   (``index_put_`` with accumulate) and against ``index_add_`` (atomic),
   its share of the compacted step, and for reference torch's own fill of
   its outputs and copy of the padding's cotangents on this card.
33. hashgrid_encode: the hash-grid kernel (``csrc/hashgrid_encode.cu``)
   on phase 2's scene's 139,264 rows (every anchor slot's x, as the
   phase-2 decode takes them) at the default spec, with a seeded
   cotangent: the forward bitwise its plain version (the eager
   ``mix_encode_plain`` on the card); the backward's rows and indices
   bitwise its torch twin (``mix_encode_backward_plain`` on the card) and
   the rows the eager path's autograd hands ``grid_scatter``; the table
   gradients through ``_MixEncode`` bitwise the eager path's; the gradient
   to x bitwise the twin, and bitwise the eager path's or within
   HASHGRID_DX_RTOL of the summed magnitudes of its terms (which of the
   two is reported); each the same bits twice. Times behind a device-side
   wait: the forward and the backward kernel, hashgrid_bwd's four calls,
   the whole ``_MixEncode`` forward and backward, the eager forward and
   the eager forward and backward, with each kernel's bound.

The line before the last holds every kernel's row (``kernels``: K1, K3 and
K4 at the render's shapes with their training, post-schedule, decoded,
grown, pipeline and cold-start shapes under ``train_shape``,
``schedule_shape``, ``decoded_shape``, ``growth_shape``, ``pipeline_shape``
and ``cold_start_shape`` (and fit_single_view's and phase 31's under
``fit_single_view_shape`` and ``fullscale_short_shape``), K2 at the
training shape with its schedule, growth, pipeline, fit_single_view and
fullscale_short shapes, hashgrid_bwd at a phase-2 step's,
gather_rows_bwd at phase 32's compacted phase-0 step's (the statistics'
scatter of that step under ``stats_shape``), hashgrid_encode
and hashgrid_encode_bwd at phase 33's; K1's
and K2's strips of phase 26 at tile 16 under ``strip_shape``,
``train_strip_shape`` and ``render_strip_shape``; launches of the
render, train, schedule, decoded orbit and growth paths, the pipeline,
the cold start, the device loop and its growth run (graph replays
counted), the batched trainer, fit_single_view, phases 27, 28 and 29
(summed over the ranks), phase 31 (graph replays counted) and phase
32's two loops; the ptxas report of each: registers, static shared
memory, spill bytes; for K1 and K2 also the block shape and dynamic
shared memory), the one before it
the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``. Without CUDA the script exits 1 before
printing anything on stdout.
"""
from __future__ import annotations

import ast
import contextlib
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

N_POINTS = 2_000_000
ROOM_RADIUS = 2.4
ROOM_HALF_HEIGHT = 1.2
N_FRAMES = 8
SEED = 0
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
SLEEP_CYCLES_PER_S = 2.0e9     # torch.cuda._sleep's unit at the H100's
                               # 1.98 GHz boost clock (longer when slower)
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
BLEND_OPS_PER_STEP = 30        # float operations per (pixel, splat) step
# K2, per walked (pixel, slot) step, counted from csrc/blend_bwd.cu: offsets
# and power 11, exp 1, alpha and the gates 4, 1/(1 - alpha) 2, T and w 2,
# Q 9, dL/dalpha 12, the suffix carries 9, h 2, the moments and channel
# products 9, the block sums 10 (one add per value per channel)
BLEND_BWD_OPS_PER_STEP = 71
GRAD_ATOL, GRAD_RTOL = 2e-6, 2e-4   # tests/test_pallas_blend.py:79-80
K2_ROWS = ("d mx", "d my", "d ca", "d cb", "d cc", "d op", "d depth", "d r",
           "d g", "d b")
K2_RESOLVED_SHARE = 0.5
TRAIN_STEPS = 30
# the schedule phase: GSConfig()'s widths, its step numbers cut so that 40
# steps cross phase 1 (11-20), the bounds refresh (20), phase 2 (21-40)
# and densification at steps 20 and 30
SCHEDULE = dict(voxel_size=0.03, use_dpr=True, start_stat=0, iterations=40,
                noise_from_step=10, context_from_step=20, update_from=10,
                update_interval=10, update_until=40)
P2_PAIR_CAPACITY = 1 << 21     # no pair overflow at 128x128
P2_GRAD_TOL = 1e-3             # of each leaf's largest gradient
# rows the gradient gate may leave out, each at a decision boundary: its
# differing decisions' inputs within BOUNDARY_ULPS of their thresholds
BOUNDARY_ULPS = 8
MAX_BOUNDARY_ROWS = 2
DETERMINISM_RUNS = 3           # identical phase-2 steps on the card
HASHGRID_RTOL = 1e-6           # of each cell's summed magnitudes
# tests/test_tile_rasterizer.py:87-90 (values) and :125-126 (gradients)
GOLDEN_TOL = {"color": (1e-5, 1e-5), "depth": (1e-4, 1e-4),
              "final_T": (1e-5, 0.0), "alpha": (1e-5, 0.0)}
GOLDEN_GRAD_ATOL, GOLDEN_GRAD_RTOL = 2e-5, 2e-3
# the growth phase: densification at step 20 (the schedule's first, with
# 19 steps of statistics) of a scene with no free slot
GROWTH = dict(voxel_size=0.03, use_dpr=True, start_stat=0, iterations=20,
              update_from=10, update_interval=10, update_until=30)
AB_STEPS = 5                   # phase-2 steps a run of phase 19
# phases 22-23: the device loop's chunk (chunk ends fall at every phase
# change and surgery of SCHEDULE and GROWTH), and the growth run's steps:
# the surgery at step 20 grows the capacity, then 4 steps at the grown
# shape
LOOP_CHUNK = 10
GROWTH_LOOP_STEPS = 24
# phase 24: the batched trainer's views a step and steps
DP_BATCH = 4
DP_STEPS = 10
# phase 25: fit_single_view's steps, host loop and device loop
FIT_STEPS = 100
FORWARD_KERNELS = ("pair_expansion", "slab_expansion", "blend_forward")
RESUME_SAVE_AT = 25            # the schedule's trainer checkpoint (phase 2)
# phase 20: the CLI as a user runs it, at the model's full default widths,
# at 128x128: at 256x256 generation (host numpy and scipy) took the whole
# script past 300 s on the H100's machine (PERF.md). A 128x128 frame has
# 64 tiles, which the early steps' large splats crowd: with the default
# 1,024 slots a tile, splats were dropped in every step but the first
# (PERF.md); 32,768 keep every splat of this run, and the check fails if
# one is dropped. A record each step gives every step's loss and overflow
# counters (one readback a step)
PIPELINE_ARGS = ("--priors", "stub", "--resolution", "128",
                 "--voxel_size", "0.03", "--max_splats_per_tile", "32768",
                 "--iterations", "60", "--log_every", "1",
                 "--render_frames", "8", "--dep_value", "--dep_domin",
                 "--dep_smooth", "--device", "cuda")
PIPELINE_FILES = ("settings.json", "traindata.npz", "point_cloud.ply",
                  "gsplat.ply", "checkpoint.npz", "bitstreams/meta.json",
                  "codec_sizes.json", "train_log.json", "metrics.json")
# phase 18: the tiles of one frame (12 and 40: a partial last warp; 40 and
# 64: split into blocks), and the slots a tile above 32 is binned with
# (the default 1,024 x its area over tile 16's)
TILES = (8, 12, 16, 40, 64)
TILE_CAPACITY = {40: 6400, 64: 16384}
# phase 26: K1 and K2 on strips of positions, at these tiles (12: a partial
# last warp; 40: a tile split into blocks)
STRIP_TILES = (16, 12, 40)
# phases 27, 28 and 30: gloo ranks sharing the card (NCCL takes one rank a
# device), spawned together and joined under one deadline (seconds)
RANKS = 2
RANK_TIMEOUT = 600.0
PARALLEL_REPS = 3              # timed frames and steps
# phase 28: the batched trainer on a (RANKS, 1) mesh, phase 10's step
# numbers cut down (no phase 1): DP_STEPS phase-0 steps, the bounds
# refresh at step DP_STEPS, then phase-2 steps with adjust_anchor at
# DP_STEPS + 2; tests/test_parallel.py:185-189's tolerances against
# the one-process trainer
MESH_BATCH = 4
MESH_SCHEDULE = dict(voxel_size=0.03, use_dpr=True, start_stat=0,
                     iterations=DP_STEPS + 4, noise_from_step=DP_STEPS,
                     context_from_step=DP_STEPS, update_from=5,
                     update_interval=DP_STEPS + 2, update_until=40)
MESH_LOSS_TOL = dict(rtol=5e-4, atol=1e-5)
MESH_PSNR_RTOL = 5e-3
NCCL_STEPS = 3                 # phase 29
# phase 31: run_fullscale.run at 128x128 for 60 steps (phase 20's size and
# slots a tile), GSConfig's step numbers cut as phase 10's so that the
# device loop crosses phase 1 (21-40), the bounds refresh (40) and phase 2
# (41-60) with adjust_anchor at steps 20 and 40; 8 orbit frames, a
# training record every step (every step's overflow counters)
FULLSCALE_ARGS = ("--resolution", "128", "--iterations", "60",
                  "--voxel_size", "0.03", "--render_frames", "8",
                  "--device", "cuda")
FULLSCALE_CUT = dict(noise_from_step=20, context_from_step=40, start_stat=0,
                     update_from=10, update_interval=20, update_until=50,
                     max_splats_per_tile=32768)
FULLSCALE_FILES = ("traindata.npz", "point_cloud.ply", "gsplat.ply",
                   "checkpoint.npz", "bitstreams/meta.json",
                   "bitstreams_reenc/meta.json", "codec_sizes.json",
                   "train_log.json", "metrics.json", "record.json")
# phase 30: the ring's scene and tests/test_ring.py's tolerances
RING_SPLATS, RING_SIZE = 4096, 128
RING_TOL = {"color": (1e-5, 1e-5), "depth": (1e-4, 1e-4)}
# phase 32: run_fullscale's --visible_capacity on phase 2's scene (139,264
# rows); the steps held to the dense decode leave out the one loss term
# that averages over the decoded rows (the scaling regularizer's mean over
# capacity x K children dense, visible_capacity x K compacted, as in the
# JAX package), so that both compute one function; the device-loop run:
# phase 0 (1-3, the bounds refresh before 3) and phase 2 (4-6)
COMPACT_CAPACITY = 131072
COMPACT_SAME_FN = dict(voxel_size=0.03, use_dpr=True, lambda_scaling_reg=0.0)
COMPACT_LOOP = dict(voxel_size=0.03, use_dpr=True, start_stat=0,
                    iterations=6, noise_from_step=3, context_from_step=3,
                    update_from=10 ** 9, visible_capacity=COMPACT_CAPACITY)
COMPACT_REPS = 5               # timed steps and backward calls
COMPACT_TRAINED = ("anchor", "offset", "mask_logit", "feat", "scaling_log")
RING_GRAD_ATOL, RING_GRAD_RTOL = 3e-5, 2e-4   # atol of each largest
# phase 33: the hash-grid encoder's kernel on phase 2's scene (139,264
# rows); the gradient to x within HASHGRID_DX_RTOL of the summed magnitudes
# of its terms where it is not bitwise the eager path's
HASHGRID_DX_RTOL = 1e-6
HASHGRID_REPS = 20             # timed kernel calls
STAMP_REPS = 500               # timed stamps, back to back (fewer than
                               # the launch queue holds)
STAMP_GRAPH = (64, 50)         # stamps a graph, and its timed replays
HASHGRID_PLAIN_REPS = 3        # timed eager calls (~13K launches each)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def card_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def room_points(n: int, seed: int) -> np.ndarray:
    """Points on the wall, floor and ceiling of a cylinder room around the
    origin (where the orbit's cameras sit), uniform by area, 5 mm noise."""
    rng = np.random.default_rng(seed)
    r, h = ROOM_RADIUS, ROOM_HALF_HEIGHT
    a_wall, a_disk = 2 * np.pi * r * 2 * h, np.pi * r * r
    n_wall = int(n * a_wall / (a_wall + 2 * a_disk))
    n_floor = (n - n_wall) // 2
    th = rng.uniform(0, 2 * np.pi, n_wall)
    parts = [np.stack([r * np.cos(th), rng.uniform(-h, h, n_wall),
                       r * np.sin(th)], 1)]
    for m, y in ((n_floor, -h), (n - n_wall - n_floor, h)):
        rr = r * np.sqrt(rng.uniform(0, 1, m))
        t = rng.uniform(0, 2 * np.pi, m)
        parts.append(np.stack([rr * np.cos(t), np.full(m, y),
                               rr * np.sin(t)], 1))
    pts = np.concatenate(parts)
    return (pts + rng.normal(0, 0.005, pts.shape)).astype(np.float32)


def trained_scale_model(points: np.ndarray, cfg, seed: int, device: str):
    """init_model, then seeded stand-ins for trained values: anchor features
    ~N(0, 0.5), child offsets ~N(0, 0.7) offset-scales, opacity-head bias
    +0.5 (most children visible), color-head output weights x4 (colors
    spread over [0, 1]), and the anchor bounds of the scene."""
    from bloomscene_tpu_torch.models.anchors import update_anchor_bounds
    from bloomscene_tpu_torch.models.model import init_model
    model, voxel = init_model(seed, points, cfg, device=device)
    st = model.state
    gen = torch.Generator().manual_seed(seed + 1)
    C, K, F = st.capacity, st.n_offsets, st.feat_dim
    feat = (torch.randn((C, F), generator=gen) * 0.5).to(device)
    offset = (torch.randn((C, K, 3), generator=gen) * 0.7).to(device)
    st = st._replace(feat=feat.reshape(-1), offset=offset.reshape(-1))
    with torch.no_grad():
        model.heads.opacity[-1].bias += 0.5
        model.heads.color[-1].weight *= 4.0
    model = model._replace(state=st, bounds=update_anchor_bounds(st))
    return model, voxel


def orbit_cameras(n_frames: int, W: int, H: int, repo: str):
    """n_frames evenly spaced frames of cameras/rotate360.json, with the
    file's own horizontal fov."""
    from bloomscene_tpu_torch.ops.graphics import fov2focal, focal2fov
    from bloomscene_tpu_torch.scene.dataset import _camera_from_nerf_frame
    from bloomscene_tpu_torch.scene.trajectory import load_camera_path_json
    data = load_camera_path_json(os.path.join(repo, "cameras",
                                              "rotate360.json"))
    fovx = data["camera_angle_x"]
    fovy = focal2fov(fov2focal(fovx, W), H)
    frames = data["frames"]
    pick = np.linspace(0, len(frames), n_frames, endpoint=False).astype(int)
    return [_camera_from_nerf_frame(frames[i]["transform_matrix"], fovx,
                                    fovy, W, H, name=f"rotate360_{i:03d}")
            for i in pick]


def hold_device(fn, reps: int) -> None:
    """Queue a device-side wait longer than the host takes to enqueue
    ``reps`` calls of ``fn`` (timed once, capped at 1 s), so that CUDA
    events recorded after it time the calls' device work back to back and
    not a wrapper's host overhead (argument checks, allocation, the ctypes
    launch), which exceeds the device time of the binning kernels."""
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wait_s = min(1.0, 1.5 * reps * (time.perf_counter() - t0) + 1e-3)
    torch.cuda._sleep(int(wait_s * SLEEP_CYCLES_PER_S))


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the card: one warm-up, then CUDA
    events around ``reps`` calls queued behind ``hold_device``."""
    fn()
    torch.cuda.synchronize()
    hold_device(fn, reps)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# the program's spans (utils.profiling.span and Spans: record_functions)
SPAN_PREFIXES = ("train.", "tile_blend.", "decode.", "render.",
                 "gather_rows.", "loop.")


def kernel_table(prof) -> list[dict]:
    """Device time and calls by kernel name, largest first."""
    from torch.autograd import DeviceType
    kernels = []
    for e in prof.key_averages():
        # device-side events only (the CPU op that launched a kernel carries
        # the same time again), and no span: a span's device-side event
        # covers the kernels inside it, idle gaps included
        if (e.device_type != DeviceType.CUDA
                or e.key.startswith(SPAN_PREFIXES)):
            continue
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0:
            kernels.append({"name": e.key[:90], "device_us": dev_us,
                            "calls": e.count})
    kernels.sort(key=lambda k: -k["device_us"])
    return kernels


def span_table(prof, steps: int) -> dict:
    """Per step, for each span: host ms (its interval on the host) and
    device busy ms (the kernels that ran inside its device-side interval;
    the stream runs one kernel at a time)."""
    import bisect
    from torch.autograd import DeviceType
    events = prof.events()
    kern = sorted((e.time_range.start, e.time_range.end) for e in events
                  if e.device_type == DeviceType.CUDA
                  and not e.name.startswith(SPAN_PREFIXES))
    starts = [k[0] for k in kern]
    spans: dict[str, dict] = {}
    for e in events:
        if not e.name.startswith(SPAN_PREFIXES):
            continue
        d = spans.setdefault(e.name, {"host_ms": 0.0, "device_busy_ms": 0.0})
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CPU:
            d["host_ms"] += (b - a) / 1e3 / steps
            continue
        busy = 0
        for k in range(bisect.bisect_left(starts, a), len(kern)):
            s0, s1 = kern[k]
            if s0 >= b:
                break
            busy += min(s1, b) - s0
        d["device_busy_ms"] += busy / 1e3 / steps
    return spans


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_report(log: str) -> dict:
    """Registers, static shared memory and spill bytes from the
    ``nvcc -Xptxas -v`` output of one library (None where not printed):
    the first kernel's registers and shared memory, the spills of all,
    and for a library of several kernels each one's registers and spills
    (``kernels``: name, registers, spill bytes, in ptxas's order)."""
    regs = re.search(r"Used (\d+) registers", log)
    smem = re.search(r"(\d+) bytes smem", log)
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        log)
    out = {"registers": int(regs.group(1)) if regs else None,
           "static_smem_bytes": int(smem.group(1)) if smem else 0,
           "spill_bytes": (sum(int(a) + int(b) for a, b in spills)
                           if spills else None)}
    # one "Function properties for <mangled>" block per kernel
    blocks = re.findall(
        r"Function properties for (\S+)\s+\d+ bytes stack frame, (\d+) "
        r"bytes spill stores, (\d+) bytes spill loads\s+ptxas info\s+: "
        r"Used (\d+) registers", log)
    if len(blocks) > 1:
        out["kernels"] = [[short_name(m), int(r), int(a) + int(b)]
                          for m, a, b, r in blocks]
    return out


def short_name(mangled: str) -> str:
    """A kernel's name from its mangled symbol _ZN<namespace><name>...: the
    name, with its template arguments as mangled (``ILi4EE`` for <4>)."""
    ns = re.match(r"_ZN(\d+)", mangled)
    if not ns:
        return mangled
    rest = mangled[ns.end() + int(ns.group(1)):]
    n = re.match(r"\d+", rest)
    if not n:
        return mangled
    start = len(n.group(0))
    name = rest[start:start + int(n.group(0))]
    tmpl = re.match(r"I.*?E(?=Ev)", rest[start + int(n.group(0)):])
    return name + (tmpl.group(0) if tmpl else "")


def launch_shape(name: str, tile: int) -> dict:
    """The blocks a blend kernel (library ``name``: "blend" or
    "blend_bwd") launches for ``tile``, as its library computes them (a
    tile above 32 is split into ``splits`` blocks), with the ptxas report
    of this run's build."""
    from bloomscene_tpu_torch.ops.cuda import blend, build
    threads, smem, splits = blend.launch_shape(name, tile)
    return {"block": [threads, 1, 1], "dynamic_smem_bytes": smem,
            "splits": splits, **ptxas_report(build.build_log(name))}


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def kernel_checks(model, cam, cfg, vcap, pcap, mode: str = "eval"):
    """K3, K4 and K1 against their plain versions on one orbit frame's
    inputs (the ``mode`` render's shapes)."""
    from bloomscene_tpu_torch.models.render import prefilter_anchors, render
    arrs = cam.device_arrays(model.state.device)
    vis = prefilter_anchors(model, cam.intrinsics, arrs) if vcap else None
    res = render(model, cam.intrinsics, arrs, cfg, mode=mode, visible=vis,
                 visible_capacity=vcap, pair_capacity=pcap,
                 packed_capacity=pcap)
    return forward_kernel_rows(res, cam.intrinsics, cfg, pcap)


def k1_bound(counts_p, ncon, tile: int) -> tuple[float, str]:
    """K1's bound: the slab's live slots, counts and ids read, seven
    [P, T] planes written; BLEND_OPS_PER_STEP a (pixel, slot) step, at
    least n_contrib steps a pixel."""
    P, T = tile * tile, counts_p.numel()
    return bound(4 * (10 * int(counts_p.sum()) + 2 * T + 7 * P * T),
                 BLEND_OPS_PER_STEP * float(ncon.double().sum()))


def k2_bound(counts_p, ncon, tile: int, cap: int) -> tuple[float, str]:
    """K2's bound: the walked slots and eight [P, T] planes read, the
    [10, cap, T] gradient written; BLEND_BWD_OPS_PER_STEP a walked
    (pixel, slot) step."""
    from bloomscene_tpu_torch.ops.cuda.blend import blend_walk
    P, T = tile * tile, counts_p.numel()
    walk = blend_walk(counts_p, ncon)
    return bound(4 * (10 * int(walk.sum()) + 8 * P * T + 2 * T
                      + 10 * cap * T),
                 BLEND_BWD_OPS_PER_STEP * float(ncon.double().sum()))


def k3_bound(args) -> tuple[float, str]:
    """K3's least time on these inputs: it writes 8 bytes a slot and reads
    the rows of the ranks that own a live slot (starts, x0, y0, w, order
    and, with the cull, six atab floats) once, plus one search path over
    the starts; it computes ~60 float operations a live slot."""
    n = args["x0"].shape[0]
    pcap = args["pair_capacity"]
    live_slots = min(int(args["starts_full"][n]), pcap)
    live_ranks = int((args["starts_full"][:n] < live_slots).sum())
    words = 5 + (6 if args["atab"] is not None else 0)
    return bound(8 * pcap + 4 * words * live_ranks
                 + 4 * (n + 1).bit_length(), 60 * live_slots)


def k4_bound(asT, t_start_p, cap) -> tuple[float, str]:
    """K4's least time: each distinct column of asT the slab takes read
    once, the starts read once, the slab written once."""
    from bloomscene_tpu_torch.ops.cuda.expand import slab_index
    cols = int(torch.unique(slab_index(t_start_p, asT.shape[1], cap)).numel())
    return bound(4 * (asT.shape[0] * cols + t_start_p.numel()
                      + asT.shape[0] * cap * t_start_p.numel()), 0)


@torch.no_grad()
def binning_inputs(res, intr, cfg, pcap):
    """The inputs K3 and K4 take in one render: K3's keyword arguments
    (from the projected splats and their opacities) and K4's (asT,
    t_start_p) in position order."""
    from bloomscene_tpu_torch.ops.projection import ProjectedSplats
    from bloomscene_tpu_torch.ops.tile_rasterizer import attr_rows
    from bloomscene_tpu_torch.ops.tiles import (pair_kernel_inputs,
                                                sorted_attr_table)
    proj = ProjectedSplats(*(t.detach() for t in res.proj))
    opac = torch.where(proj.valid, res.dec.opacity.detach(), 0.0)
    args = pair_kernel_inputs(proj, intr.width, intr.height, cfg.tile_size,
                              pcap, opac)
    bins = res.bins
    asT = sorted_attr_table(attr_rows(proj, res.dec.color.detach(), opac),
                            bins.gauss_sorted, cfg.max_splats_per_tile)
    return args, asT, bins.t_start[bins.perm.long()].contiguous()


@torch.no_grad()
def forward_kernel_rows(res, intr, cfg, pcap):
    """K3, K4 and K1 against their plain versions on one render's projected
    splats, colors, opacities and bins."""
    from bloomscene_tpu_torch.ops.cuda import build
    from bloomscene_tpu_torch.ops.cuda.blend import (blend_forward,
                                                     blend_forward_plain)
    from bloomscene_tpu_torch.ops.cuda.expand import (expand_slab,
                                                      expand_slab_plain,
                                                      slab_index)
    from bloomscene_tpu_torch.ops.cuda.pairs import (expand_pairs,
                                                     expand_pairs_plain)
    from bloomscene_tpu_torch.ops.tiles import tile_grid
    W, H, tile, cap = intr.width, intr.height, cfg.tile_size, \
        cfg.max_splats_per_tile
    gx, _ = tile_grid(W, H, tile)
    bins = res.bins
    args, asT, t_start_p = binning_inputs(res, intr, cfg, pcap)
    rows = []

    # K3: pair expansion
    n = args["x0"].shape[0]
    key_k, gid_k = expand_pairs(**args)
    key_p, gid_p = expand_pairs_plain(**args)
    k3_equal = torch.equal(key_k, key_p) and torch.equal(gid_k, gid_p)
    t_bytes, by = k3_bound(args)
    rows.append(dict(
        name="pair_expansion", route="cuda",
        source="bloomscene_tpu_torch/csrc/pairs.cu",
        replaces="bloomscene_tpu/ops/pallas/pairs.py:109",
        max_abs_err=float(max(max_abs(key_k, key_p), max_abs(gid_k, gid_p))),
        bitwise=k3_equal,
        ms=time_ms(lambda: expand_pairs(**args), 50),
        plain_ms=time_ms(lambda: expand_pairs_plain(**args), 10),
        bound_ms=t_bytes, bound_by=by, library_ms=None,
        **ptxas_report(build.build_log("pairs")),
        shapes={"n": n, "pair_capacity": pcap,
                "total_pairs": int(args["starts_full"][n]),
                "packed_key": args["packed_key"]}))

    # K4: slab expansion
    slab_k = expand_slab(asT, t_start_p, cap)
    slab_p = expand_slab_plain(asT, t_start_p, cap)
    idx = slab_index(t_start_p, asT.shape[1], cap)
    k4_equal = torch.equal(slab_k, slab_p) and torch.equal(slab_k, bins.slab)
    t_bytes, by = k4_bound(asT, t_start_p, cap)
    rows.append(dict(
        name="slab_expansion", route="cuda",
        source="bloomscene_tpu_torch/csrc/expand.cu",
        replaces="bloomscene_tpu/ops/pallas/expand.py:51",
        max_abs_err=max_abs(slab_k, slab_p), bitwise=k4_equal,
        ms=time_ms(lambda: expand_slab(asT, t_start_p, cap), 50),
        plain_ms=time_ms(lambda: expand_slab_plain(asT, t_start_p, cap), 20),
        bound_ms=t_bytes, bound_by=by,
        library_ms=time_ms(lambda: asT[:, idx], 20),
        **ptxas_report(build.build_log("expand")),
        shapes={"asT": list(asT.shape), "slab": list(slab_k.shape)}))

    # K1: blend forward
    counts_p = bins.counts[bins.perm.long()].contiguous()
    out_k = blend_forward(bins.slab, counts_p, bins.perm, tile, gx)
    out_p = blend_forward_plain(bins.slab, counts_p, bins.perm, tile, gx)
    names = ("r", "g", "b", "D", "acc", "T")
    errs = {nm: max_abs(a, b) for nm, a, b in zip(names, out_k, out_p)}
    errs["n_contrib"] = max_abs(out_k[6], out_p[6])
    k1_ok = (all(errs[nm] <= 1e-5 for nm in ("r", "g", "b", "acc", "T"))
             and errs["D"] <= 1e-4)
    k1_bitwise = all(torch.equal(a, b) for a, b in zip(out_k, out_p))
    t_bytes, by = k1_bound(counts_p, out_p[6], tile)
    rows.append(dict(
        name="blend_forward", route="cuda",
        source="bloomscene_tpu_torch/csrc/blend.cu",
        replaces="bloomscene_tpu/ops/pallas/blend.py:140",
        max_abs_err=max(errs[nm] for nm in names), bitwise=k1_bitwise,
        errors=errs,
        ms=time_ms(lambda: blend_forward(bins.slab, counts_p, bins.perm,
                                         tile, gx), 50),
        plain_ms=time_ms(lambda: blend_forward_plain(
            bins.slab, counts_p, bins.perm, tile, gx), 2),
        bound_ms=t_bytes, bound_by=by, library_ms=None,
        **launch_shape("blend", tile),
        shapes={"slab": list(bins.slab.shape),
                "max_count": int(counts_p.max()),
                "sum_counts": int(counts_p.sum())}))
    ok = {"pair_expansion": k3_equal, "slab_expansion": k4_equal,
          "blend_forward": k1_ok}
    return rows, ok


def reference_check(model, cfg, size: int):
    """One view at ``size`` x ``size``: rasterized on the card and by the
    plain path on the CPU from the same projected splats."""
    from bloomscene_tpu_torch.models.render import render
    from bloomscene_tpu_torch.ops.projection import ProjectedSplats
    from bloomscene_tpu_torch.ops.tile_rasterizer import rasterize_tiles
    cam = orbit_cameras(1, size, size, os.path.dirname(
        os.path.abspath(__file__)))[0]
    intr = cam.intrinsics
    pcap = 1 << 20
    res = render(model, intr, cam.device_arrays(model.state.device), cfg,
                 mode="eval", pair_capacity=pcap)
    cpu = ProjectedSplats(*(t.cpu() for t in res.proj))
    out_c, bins_c = rasterize_tiles(
        cpu, res.dec.color.cpu(), res.dec.opacity.cpu(), torch.zeros(3),
        size, size, tile=cfg.tile_size, pair_capacity=pcap,
        tile_capacity=cfg.max_splats_per_tile)
    errs = {f: max_abs(getattr(res.out, f).cpu(), getattr(out_c, f))
            for f in res.out._fields}
    ok = (errs["color"] <= 1e-5 and errs["alpha"] <= 1e-5
          and errs["final_T"] <= 1e-5 and errs["depth"] <= 1e-4
          and int(res.bins.num_pairs) > 0)
    return dict(size=size, num_pairs=int(res.bins.num_pairs),
                num_pairs_cpu=int(bins_c.num_pairs), max_abs_err=errs), ok


def grad_reference_check(model, cfg, size: int):
    """At ``size`` x ``size``: the gradients of a fixed loss through the
    tile blend on the card and by the plain path on the CPU, from the same
    projected splats."""
    from bloomscene_tpu_torch.models.render import render
    from bloomscene_tpu_torch.ops.projection import ProjectedSplats
    from bloomscene_tpu_torch.ops.tile_rasterizer import rasterize_tiles
    cam = orbit_cameras(1, size, size, os.path.dirname(
        os.path.abspath(__file__)))[0]
    pcap = 1 << 20
    res = render(model, cam.intrinsics,
                 cam.device_arrays(model.state.device), cfg, mode="eval",
                 pair_capacity=pcap)
    rng = np.random.default_rng(SEED + 3)
    tgt_c = rng.uniform(0, 1, (size, size, 3)).astype(np.float32)
    tgt_d = rng.uniform(1, 4, (size, size)).astype(np.float32)
    names = ("mean2d", "conic", "depth", "color", "opac", "bg")
    live = (res.proj.mean2d, res.proj.conic, res.proj.depth, res.dec.color,
            res.dec.opacity, torch.tensor([0.1, 0.2, 0.3]))

    def grads(dev):
        leaves = [x.detach().to(dev).clone().requires_grad_(True)
                  for x in live]
        proj = ProjectedSplats(mean2d=leaves[0], depth=leaves[2],
                               conic=leaves[1],
                               radius=res.proj.radius.to(dev),
                               valid=res.proj.valid.to(dev))
        out, bins = rasterize_tiles(
            proj, leaves[3], leaves[4], leaves[5], size, size,
            tile=cfg.tile_size, pair_capacity=pcap,
            tile_capacity=cfg.max_splats_per_tile)
        loss = (torch.mean((out.color - torch.from_numpy(tgt_c).to(dev)) ** 2)
                + 0.5 * torch.mean((out.depth
                                    - torch.from_numpy(tgt_d).to(dev)) ** 2)
                + 0.1 * torch.mean(out.final_T) + 0.05 * torch.mean(out.alpha))
        return loss, torch.autograd.grad(loss, leaves), int(bins.num_pairs)

    loss_g, g_gpu, pairs = grads(model.state.device)
    loss_c, g_cpu, pairs_c = grads(torch.device("cpu"))
    errs, ok = {}, pairs > 0 and pairs == pairs_c
    for nm, a, b in zip(names, g_gpu, g_cpu):
        a = a.cpu()
        errs[nm] = max_abs(a, b)
        ok = ok and bool(torch.allclose(a, b, atol=GRAD_ATOL, rtol=GRAD_RTOL))
        ok = ok and bool(torch.isfinite(a).all()) and float(b.abs().max()) > 0
    return dict(size=size, num_pairs=pairs, num_pairs_cpu=pairs_c,
                loss=float(loss_g.detach()), loss_cpu=float(loss_c.detach()),
                max_abs_err=errs,
                atol=GRAD_ATOL, rtol=GRAD_RTOL), ok


def perturbed(model, seed: int):
    """The model with feature noise ~N(0, 0.1) and a re-drawn color head
    (output weights x4, as ``trained_scale_model``): a seeded start that
    training has to pull back toward the model's own renders. The color
    head is replaced in the shared ``Heads`` module."""
    from bloomscene_tpu_torch.models.heads import MLP
    st = model.state
    gen = torch.Generator().manual_seed(seed + 2)
    feat = st.feat + (torch.randn(st.feat.shape, generator=gen)
                      * 0.1).to(st.device)
    lins = [m for m in model.heads.color if isinstance(m, torch.nn.Linear)]
    dims = [lins[0].in_features] + [m.out_features for m in lins]
    color = MLP(dims, gen, st.device)
    with torch.no_grad():
        color[-1].weight *= 4.0
    model.heads.color = color
    return model._replace(state=st._replace(feat=feat))


def timed_run(trainer, views, iterations: int, counters: dict,
              after_step=None):
    """``trainer.run`` up to step ``iterations`` with every launch counter
    set to 0 just before and read just after -> (records, step ms, launch
    counts, wall seconds, peak device bytes, caught warnings). A step's
    ms lie between CUDA events recorded at the ends of consecutive steps
    (the host loop reads every step's metrics, so each step ends
    synchronized); None on the CPU. ``after_step(record)``, when given,
    runs after each step (its time falls in the next step's ms)."""
    import warnings
    timed = trainer.bg.device.type == "cuda"
    marks, records = [], []

    def mark():
        if timed:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)

    def on_step(rec):
        mark()
        records.append(rec)
        if after_step is not None:
            after_step(rec)

    if timed:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        mark()
        trainer.run(views, iterations=iterations, log_every=1,
                    callback=on_step)
        if timed:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    ms = [marks[i].elapsed_time(marks[i + 1]) if timed else None
          for i in range(len(records))]
    peak = torch.cuda.max_memory_allocated() if timed else None
    return records, ms, launches, wall, peak, caught


def train_phase(model, cams, frames, depths, voxel: float, counters: dict,
                device: str = "cuda"):
    """Trainer.run for TRAIN_STEPS steps toward ``frames``/``depths``; one
    record per step with its milliseconds (``timed_run``)."""
    from bloomscene_tpu_torch.config import GSConfig
    from bloomscene_tpu_torch.train.loop import Trainer
    cfg = GSConfig(voxel_size=0.03, use_dpr=True, start_stat=0)
    dev = torch.device(device)
    views = [(c.device_arrays(dev), torch.as_tensor(f, device=dev),
              torch.as_tensor(d, device=dev))
             for c, f, d in zip(cams, frames, depths)]
    trainer = Trainer(perturbed(model, SEED), cfg, cams[0].intrinsics, voxel,
                      seed=SEED, device=device)
    records, ms, launches, wall, peak, caught = timed_run(
        trainer, views, TRAIN_STEPS, counters)
    steps = []
    for rec, t in zip(records, ms):
        steps.append({k: rec[k] for k in (
            "iteration", "loss", "psnr", "n_visible_anchors", "num_pairs",
            "tile_overflow", "pair_overflow", "packed_overflow", "skipped")})
        steps[-1]["ms"] = t
    losses = [r["loss"] for r in records]
    per_forward = 2 if cfg.remat else 1
    checks = {
        "steps": len(records) == TRAIN_STEPS,
        "finite": all(np.isfinite(losses)),
        "no_skipped_update": all(r["skipped"] == 0 for r in records),
        "loss_falls": float(np.mean(losses[-5:])) < float(np.mean(losses[:5])),
        "blend_backward_once_per_step":
            launches["blend_backward"] == TRAIN_STEPS,
        "emission_sums_once_per_step":
            launches["emission_sums"] == TRAIN_STEPS,
        "forward_kernels_once_per_forward": all(
            launches[k] == per_forward * TRAIN_STEPS
            for k in ("pair_expansion", "slab_expansion", "blend_forward")),
    }
    summary = {
        "steps": len(records), "wall_s": wall,
        "steps_per_s": len(records) / wall, "launches": launches,
        "loss_first5": float(np.mean(losses[:5])),
        "loss_last5": float(np.mean(losses[-5:])),
        "peak_mem_bytes": peak,
        "warnings": len(caught),
        "first_warning": str(caught[0].message) if caught else None,
        "checks": checks}
    return trainer, cfg, views, steps, summary, all(checks.values())


def train_blend_inputs(trainer, cfg, views, phase: int = 0):
    """One training step's render of the first view in ``phase`` (its
    noise drawn from a seed) and the cotangents of its loss: (res,
    counts_p, gx, K1's final_T and n_contrib, the six cotangent planes K2
    reads)."""
    from bloomscene_tpu_torch.models.decode import draw_noise
    from bloomscene_tpu_torch.models.render import prefilter_anchors, render
    from bloomscene_tpu_torch.ops.cuda.blend import blend_forward
    from bloomscene_tpu_torch.ops.cuda.wrapper import cotangent_planes
    from bloomscene_tpu_torch.ops.tiles import tile_grid
    from bloomscene_tpu_torch.train.loop import compute_losses, decoded_rows
    cam, gt_image, gt_depth = views[0]
    intr, model, tile = trainer.intr, trainer.model, cfg.tile_size
    gx, gy = tile_grid(intr.width, intr.height, tile)
    dev = model.state.device
    noise = draw_noise(decoded_rows(model, cfg), cfg, phase,
                       torch.Generator(device=dev).manual_seed(SEED + 5), dev)
    with torch.enable_grad():
        res = render(model, intr, cam, cfg, phase=phase, mode="train",
                     bg=trainer.bg, noise=noise,
                     visible=prefilter_anchors(model, intr, cam))
        loss, _ = compute_losses(res, gt_image, gt_depth, cfg)
        outs = (res.out.color, res.out.depth, res.out.alpha, res.out.final_T)
        cot = torch.autograd.grad(loss, outs, allow_unused=True)
    cot = [torch.zeros_like(o) if g is None else g for o, g in zip(outs, cot)]
    bins = res.bins
    counts_p = bins.counts[bins.perm.long()].contiguous()
    _, _, _, D, acc, Tf, ncon = blend_forward(bins.slab, counts_p, bins.perm,
                                              tile, gx)
    u = cotangent_planes(*cot, trainer.bg, acc, D, bins.perm, tile, gx, gy)
    return res, counts_p, gx, Tf, ncon, u


def train_kernel_checks(trainer, cfg, views, phase: int = 0):
    """On the inputs of one training step in ``phase`` (the trained model,
    the first view): K3, K4 and K1 at the training shapes, and K2 against
    its plain version, twice.

    1. At the loss's own scale, within atol 2e-6 + rtol 2e-4
       (tests/test_pallas_blend.py:79-80). The loss is a mean over the
       H x W pixels, so its cotangent planes are ~1e-6 and most gradient
       entries sit below that atol: this check alone would pass a zeroed
       row.
    2. K2 is linear in its six cotangent planes: scaled by H * W * 3 to a
       per-pixel scale, each entry within atol 2e-6 + rtol 2e-4 of the sum
       of the magnitudes of its 256 pixel terms (``magnitude=True``): the
       kernel differs from the plain version only in the order of those
       sums, so a value that cancels is held to the rounding of its terms,
       not of itself. In each of the ten rows at least K2_RESOLVED_SHARE of
       the nonzero entries must have a tolerance below a tenth of their
       value, and planted faults (each row zeroed in turn, the depth row
       shifted by one slot) must fail this check. A row that the plain
       version gives as zero everywhere (the depth row where the loss has
       no depth term) must be zero everywhere in the kernel's result too;
       no fault can be planted there by zeroing or shifting it."""
    from bloomscene_tpu_torch.ops.cuda.blend import (blend_backward,
                                                     blend_backward_plain,
                                                     blend_walk)
    from bloomscene_tpu_torch.ops.cuda.wrapper import reduce_entry_grads
    intr = trainer.intr
    tile, cap = cfg.tile_size, cfg.max_splats_per_tile
    res, counts_p, gx, Tf, ncon, u = train_blend_inputs(trainer, cfg, views,
                                                        phase)
    bins = res.bins
    fwd_rows, fwd_ok = forward_kernel_rows(res, intr, cfg,
                                           int(bins.src_lane.numel()))
    base = (bins.slab, counts_p, bins.perm, tile, gx, Tf, ncon)
    natural = bool(torch.allclose(blend_backward(*base, *u),
                                  blend_backward_plain(*base, *u),
                                  atol=GRAD_ATOL, rtol=GRAD_RTOL))
    scale = float(intr.width * intr.height * 3)
    args = (*base, *(x * scale for x in u))
    got = blend_backward(*args)
    again = blend_backward(*args)
    want = blend_backward_plain(*args)
    tol = GRAD_ATOL + GRAD_RTOL * blend_backward_plain(*args, magnitude=True)

    def close(x):
        return bool(((x - want).abs() <= tol).all())

    per_row, caught, zero_rows = {}, {}, {}
    bad = got.clone()
    for c, nm in enumerate(K2_ROWS):
        mag = want[c].abs()
        nz = mag > 0
        if not nz.any():
            zero_rows[nm] = not bool(got[c].any())
            continue
        per_row[nm] = dict(
            nonzero=int(nz.sum()),
            median_nonzero=float(mag[nz].median()),
            max=float(mag.max()), max_abs_err=max_abs(got[c], want[c]),
            resolved_share=float((10 * tol[c][nz] < mag[nz]).double()
                                 .mean()))
        bad[c] = 0.0
        caught[f"{nm} zeroed"] = not close(bad)
        bad[c] = got[c]
    if "d depth" in per_row:
        bad[6] = torch.roll(got[6], 1, dims=0)
        caught["d depth shifted one slot"] = not close(bad)
    resolved = bool(per_row) and all(
        v["resolved_share"] >= K2_RESOLVED_SHARE for v in per_row.values())
    within = close(got)
    deterministic = torch.equal(got, again)
    k2_ok = (natural and within and deterministic and resolved
             and all(caught.values()) and all(zero_rows.values()))

    t_bytes, by = k2_bound(counts_p, ncon, tile, cap)
    walk = blend_walk(counts_p, ncon)
    row = dict(
        name="blend_backward", route="cuda",
        source="bloomscene_tpu_torch/csrc/blend_bwd.cu",
        replaces="bloomscene_tpu/ops/pallas/blend.py:309",
        max_abs_err=max_abs(got, want), within_tolerance_natural=natural,
        within_tolerance=within,
        # the largest |got - want| / tolerance: 1 at the edge
        max_tolerance_used=float(((got - want).abs() / tol).max()),
        cotangent_scale=scale, atol=GRAD_ATOL, rtol=GRAD_RTOL,
        rows=per_row, rows_resolved=resolved, planted_faults_caught=caught,
        # rows the plain version gives as zero: True where the kernel's are
        zero_rows=zero_rows,
        deterministic=deterministic,
        ms=time_ms(lambda: blend_backward(*args), 20),
        plain_ms=time_ms(lambda: blend_backward_plain(*args), 1),
        reduce_ms=time_ms(lambda: reduce_entry_grads(
            got, bins.src_lane, bins.starts_by_id, bins.ends_by_id), 20),
        bound_ms=t_bytes, bound_by=by, library_ms=None,
        **launch_shape("blend_bwd", tile),
        shapes={"grad": list(got.shape), "max_walk": int(walk.max()),
                "sum_walk": int(walk.sum()),
                "sum_n_contrib": int(ncon.sum())})
    return row, k2_ok, fwd_rows, fwd_ok


def emission_sums_twin(grad, src_lane, starts_by_id, ends_by_id,
                       warp_range: int):
    """A torch twin of ``csrc/emission_sums.cu``'s order of additions: a
    range of at most ``warp_range`` slots added in slot order from 0
    (``index_add_``'s sequential order on the CPU); a longer one by 32
    lanes, lane l adding slots l, l + 32, ... from 0, the lanes' partials
    then combined by the butterfly p[l] + p[l ^ off], off = 16, 8, 4, 2, 1.
    On CPU tensors the kernel's bits."""
    C, n = grad.shape[0], starts_by_id.shape[0]
    n_lanes = grad.shape[1] * grad.shape[2]
    flat = grad.reshape(C, n_lanes)
    length, _ = range_lengths(src_lane, starts_by_id, ends_by_id)
    s = torch.clamp(starts_by_id, max=src_lane.shape[0]).long()
    owner = torch.repeat_interleave(torch.arange(n), length)
    pos = torch.arange(owner.numel()) - (torch.cumsum(length, 0)
                                         - length)[owner]
    lane = src_lane[s[owner] + pos].long()
    wide = length[owner] > warp_range
    live = lane < n_lanes
    # one bucket a short range, 32 a long one (its lanes)
    wide_ids = torch.nonzero(length > warp_range).flatten()
    rank = torch.full((n,), -1, dtype=torch.long)
    rank[wide_ids] = torch.arange(wide_ids.numel())
    bucket = torch.where(wide, n + rank[owner] * 32 + pos % 32, owner)
    part = torch.zeros((C, n + 32 * wide_ids.numel()), dtype=grad.dtype)
    part.index_add_(1, bucket[live], flat[:, lane[live]])
    out = part[:, :n].clone()
    p = part[:, n:].reshape(C, -1, 32)
    lanes = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        p = p + p[:, :, lanes ^ off]
    out[:, wide_ids] = p[:, :, 0]
    return out


def range_lengths(src_lane, starts_by_id, ends_by_id):
    """Each Gaussian's range length, clamped at the pair capacity, and
    which slots lie in some range."""
    pc = src_lane.shape[0]
    s = torch.clamp(starts_by_id, max=pc).long()
    length = torch.clamp(torch.clamp(ends_by_id, max=pc).long() - s, min=0)
    in_range = torch.zeros(pc + 1, dtype=torch.int32, device=s.device)
    in_range.index_add_(0, s, torch.ones_like(s, dtype=torch.int32))
    in_range.index_add_(0, s + length,
                        -torch.ones_like(s, dtype=torch.int32))
    return length, torch.cumsum(in_range[:pc], 0) > 0


def sum_depth(length, warp_range: int):
    """The most additions any one term of a sum goes through in
    ``emission_sums``: serial up to ``warp_range`` slots, else a lane's
    share of 32 and the five levels of the butterfly."""
    return torch.where(length <= warp_range, length,
                       (length + 31) // 32 + 5)


def emission_sums_check(trainer, cfg, views):
    """The emission-order reduction on one training step's K2 output (the
    first view, the loss's own cotangents): the kernel bitwise its twin
    (``emission_sums_twin`` on the CPU) and equal to itself from one
    launch to the next, within its rounding bound of a float64 sum (the
    additions a term goes through, plus one, times 2^-24, times the summed
    magnitudes); the gaps to that float64 sum of the kernel and of the
    plain version (the JAX package's cumsum difference, the path before the
    kernel); times of the kernel and of the plain version on the card."""
    from bloomscene_tpu_torch.ops.cuda import build
    from bloomscene_tpu_torch.ops.cuda.blend import blend_backward
    from bloomscene_tpu_torch.ops.cuda.emission_sums import (
        WARP_RANGE, emission_sums, emission_sums_plain)
    tile = cfg.tile_size
    res, counts_p, gx, Tf, ncon, u = train_blend_inputs(trainer, cfg, views)
    bins = res.bins
    grad = blend_backward(bins.slab, counts_p, bins.perm, tile, gx, Tf, ncon,
                          *u)
    idx = (bins.src_lane, bins.starts_by_id, bins.ends_by_id)
    got = emission_sums(grad, *idx)
    again = emission_sums(grad, *idx)
    plain = emission_sums_plain(grad, *idx)
    cpu = [t.cpu() for t in (grad, *idx)]
    twin = emission_sums_twin(*cpu, WARP_RANGE)
    want = emission_sums_twin(cpu[0].double(), *cpu[1:], WARP_RANGE)
    mag = emission_sums_twin(cpu[0].double().abs(), *cpu[1:], WARP_RANGE)
    length, in_range = range_lengths(*cpu[1:])
    tol = (sum_depth(length, WARP_RANGE) + 1).double() * 2.0 ** -24 * mag

    def gaps(x):
        d = x.cpu().double() - want
        return {"max_abs": float(d.abs().max()),
                "norm": float(d.norm() / want.norm())}

    n_lanes = grad.shape[1] * grad.shape[2]
    live = int(((cpu[1] < n_lanes) & in_range).sum())
    n, pc = bins.starts_by_id.numel(), bins.src_lane.numel()
    # sums written, ranges read, src_lane over the ranges, a live pair's
    # ten gathers of grad; ten adds a live pair
    t_bytes, by = bound(4 * (10 * n + 2 * n + int(in_range.sum()))
                        + 40 * live, 10 * live)
    deterministic = bit_equal(got, again)
    bitwise_twin = bit_equal(got.cpu(), twin)
    within = bool(((got.cpu().double() - want).abs() <= tol).all())
    row = dict(
        name="emission_sums", route="cuda",
        source="bloomscene_tpu_torch/csrc/emission_sums.cu",
        replaces="none (XLA's gather, cumsum and difference at "
                 "bloomscene_tpu/ops/pallas/wrapper.py:146-172)",
        max_abs_err=gaps(got)["max_abs"], kernel_gaps=gaps(got),
        plain_gaps=gaps(plain), within_bound=within,
        bitwise_twin=bitwise_twin, deterministic=deterministic,
        ms=time_ms(lambda: emission_sums(grad, *idx), 20),
        # the plain version is the cumsum difference the port ran before
        plain_ms=time_ms(lambda: emission_sums_plain(grad, *idx), 20),
        bound_ms=t_bytes, bound_by=by, library_ms=None,
        **ptxas_report(build.build_log("emission_sums")),
        shapes={"grad": list(grad.shape), "pair_capacity": pc,
                "gaussians": n, "live_pairs": live,
                "slots_in_ranges": int(in_range.sum()),
                "nonempty_ranges": int((length > 0).sum()),
                "longest_range": int(length.max()),
                "ranges_over_warp_range": int((length > WARP_RANGE).sum())})
    return row, deterministic and bitwise_twin and within


def leaf_errors(names, card: list, cpu: list) -> dict:
    """Each leaf's largest gradient difference, card against CPU, beside
    its largest CPU gradient and their ratio."""
    out = {}
    for name, a, b in zip(names, card, cpu):
        scale = float(b.abs().max())
        err = max_abs(a, b)
        out[name] = {"max_abs_err": err, "max_abs": scale,
                     "err_over_max": err / scale if scale > 0 else err,
                     "finite": bool(torch.isfinite(a).all())}
    return out


def excess_rows(names, card: list, cpu: list, leaves: dict,
                capacity: int) -> list:
    """The anchor rows that carry a failing per-anchor leaf's excess: the
    rows where the difference passes P2_GRAD_TOL of the leaf's largest."""
    rows = set()
    for name, a, b in zip(names, card, cpu):
        if (leaves[name]["err_over_max"] <= P2_GRAD_TOL
                or not name.startswith("state.") or a.shape[0] != capacity):
            continue
        lim = P2_GRAD_TOL * leaves[name]["max_abs"]
        diff = (a.cpu() - b).abs().reshape(a.shape[0], -1).amax(1)
        rows.update(int(r) for r in torch.nonzero(diff > lim).flatten())
    return sorted(rows)


def ulps(value, threshold, scale=None) -> float:
    """How far ``value`` lies from ``threshold``, in float32 ulps at
    ``scale`` (by default the larger of the two magnitudes)."""
    s = max(abs(float(value)), abs(float(threshold))) if scale is None \
        else abs(float(scale))
    return abs(float(value) - float(threshold)) / float(
        np.spacing(np.float32(max(s, np.finfo(np.float32).tiny))))


def cull_input(dec: dict, child: int, tile_id: int):
    """K3's exact-zero cull of one (child, tile) pair as the plain pair
    chain computes it (``ops/cuda/pairs.py::expand_pairs_plain``) ->
    (the smallest exponent over the tile, its threshold, the magnitude of
    the terms they are made of): the pair stays where the first is at most
    the second."""
    from bloomscene_tpu_torch.ops.cuda.pairs import CULL_MARGIN
    t = float(dec["tile"])
    gx = -(-dec["width"] // dec["tile"])
    f32 = torch.float32
    mx, my = dec["mean2d"][child].to(f32)
    ca, cb, cc = dec["conic"][child].to(f32)
    ln_t = torch.log(torch.clamp(255.0 * dec["opac_eff"][child].to(f32),
                                 min=1e-12))
    lox = torch.tensor(float(tile_id % gx) * t, dtype=f32) - mx
    hix = lox + (t - 1.0)
    loy = torch.tensor(float(tile_id // gx) * t, dtype=f32) - my
    hiy = loy + (t - 1.0)

    def qq(dx, dy):
        return 0.5 * (ca * dx * dx + cc * dy * dy) + cb * dx * dy

    def clip(v, lo, hi):
        return torch.minimum(torch.maximum(v, lo), hi)

    qmin = min(float(qq(lox, clip(-cb * lox / cc, loy, hiy))),
               float(qq(hix, clip(-cb * hix / cc, loy, hiy))),
               float(qq(clip(-cb * loy / ca, lox, hix), loy)),
               float(qq(clip(-cb * hiy / ca, lox, hix), hiy)))
    if lox <= 0 and hix >= 0 and loy <= 0 and hiy >= 0:
        qmin = 0.0
    return qmin, float(ln_t + CULL_MARGIN), max(abs(qmin), abs(float(ln_t)),
                                                CULL_MARGIN)


def decision_flips(card: dict, cpu: dict) -> dict:
    """The anchor rows on which the card and the CPU took another forward
    decision, each with the decisions that differ and its margin: the
    largest, over those decisions and the two sides, of the decision's
    input's distance to its threshold in float32 ulps (inf where the gate
    cannot show it). A decision counts where it changes what the blend
    sees, and is charged to the first that explains it: the visible set
    (its margin shown for the near plane only), then a child's opacity
    mask (``opacity > 0``, in ulps of the opacity head's last product's
    magnitude) or another cause of its decode validity (no margin), then
    its projection's validity (no margin), then, for a child valid on both
    sides, K3's pair cull (each (child, tile) kept on one side only,
    recomputed from each side's inputs)."""
    C = card["visible"].shape[0]
    K = card["opacity"].shape[0] // C
    flips: dict = {}

    def flip(row, what, margin):
        f = flips.setdefault(int(row), {"decisions": [], "margin_ulps": 0.0})
        f["decisions"].append(what)
        f["margin_ulps"] = max(f["margin_ulps"], margin)

    near = card["near"]
    vis_flip = card["visible"] != cpu["visible"]
    for r in torch.nonzero(vis_flip).flatten().tolist():
        d = (float(card["anchor_depth"][r]), float(cpu["anchor_depth"][r]))
        at_near = (d[0] > near) != (d[1] > near)
        flip(r, {"decision": "visible", "depth": list(d)},
             max(ulps(x, near) for x in d) if at_near else float("inf"))
    child_vis_flip = vis_flip.repeat_interleave(K)
    dec_flip = (card["dec_valid"] != cpu["dec_valid"]) & ~child_vis_flip
    op_flip = (card["opacity"] > 0) != (cpu["opacity"] > 0)
    for c in torch.nonzero(dec_flip).flatten().tolist():
        if not op_flip[c]:
            flip(c // K, {"decision": "decode_valid", "child": c},
                 float("inf"))
            continue
        x = (float(card["opacity"][c]), float(cpu["opacity"][c]))
        sc = (float(card["opacity_scale"][c]), float(cpu["opacity_scale"][c]))
        flip(c // K, {"decision": "opacity_mask", "child": c,
                      "opacity": list(x), "scale": list(sc)},
             max(ulps(v, 0.0, m) for v, m in zip(x, sc)))
    valid_a, valid_b = card["child_valid"], cpu["child_valid"]
    proj_flip = (valid_a != valid_b) & ~dec_flip & ~child_vis_flip
    for c in torch.nonzero(proj_flip).flatten().tolist():
        flip(c // K, {"decision": "projection", "child": c}, float("inf"))
    both = valid_a & valid_b
    kept_a = {tuple(p) for p in card["pairs"].tolist() if both[p[0]]}
    kept_b = {tuple(p) for p in cpu["pairs"].tolist() if both[p[0]]}
    for child, tile_id in sorted(kept_a ^ kept_b):
        inputs = [cull_input(dec, child, tile_id) for dec in (card, cpu)]
        flip(child // K, {"decision": "pair_cull", "child": child,
                          "tile": tile_id,
                          "kept_on": "card" if (child, tile_id) in kept_a
                          else "cpu", "qmin_and_threshold": inputs},
             max(ulps(q, t, m) for q, t, m in inputs))
    return flips


def grad_gate(names, card: list, cpu: list, dec_card: dict, dec_cpu: dict,
              rerun) -> tuple[dict, bool]:
    """The card-vs-CPU gradient gate: every leaf within P2_GRAD_TOL of its
    largest CPU gradient. Where a leaf passes it, the rows that carry the
    excess are found and the two sides' forward decisions compared; rows
    that sit at a decision boundary (every decision that differs there has
    its input within BOUNDARY_ULPS of its threshold, on both sides) may be
    left out, at most MAX_BOUNDARY_ROWS of them and only if they hold every
    row with an excess. ``rerun(rows)`` then gives both sides' gradients
    with those rows dead, and every leaf must pass the tolerance there.
    -> (the report, ok); the report names each row left out with its
    margin and decisions."""
    leaves = leaf_errors(names, card, cpu)
    finite = all(v["finite"] for v in leaves.values())
    report = {"leaves": leaves, "excused_rows": []}
    if all(v["err_over_max"] <= P2_GRAD_TOL for v in leaves.values()):
        return report, finite
    capacity = dec_card["visible"].shape[0]
    rows = excess_rows(names, card, cpu, leaves, capacity)
    flips = decision_flips(dec_card, dec_cpu)
    boundary = sorted(r for r, f in flips.items()
                      if f["margin_ulps"] <= BOUNDARY_ULPS)
    report.update(
        excess_rows=rows[:20], n_excess_rows=len(rows),
        flipped_rows={str(r): flips[r] for r in sorted(flips)[:20]},
        n_flipped_rows=len(flips), boundary_rows=boundary)
    if (not boundary or len(boundary) > MAX_BOUNDARY_ROWS
            or not set(rows) <= set(boundary)):
        return report, False
    card2, cpu2 = rerun(boundary)
    report["excused_rows"] = [{"row": r, **flips[r]} for r in boundary]
    report["leaves_without_excused_rows"] = again = leaf_errors(
        names, card2, cpu2)
    return report, finite and all(
        v["finite"] and v["err_over_max"] <= P2_GRAD_TOL
        for v in again.values())


def opacity_scale_hook(heads, out: list):
    """Hook the opacity head's last product: ``out`` receives the
    magnitude its rounding scales with, |h| |W|^T + |b| a child, once a
    forward."""
    lin = heads.opacity[-1]

    def hook(module, inputs, _):
        with torch.no_grad():
            out.append((inputs[0].detach().abs() @ lin.weight.detach().abs().T
                        + lin.bias.detach().abs()).reshape(-1))
    return lin.register_forward_hook(hook)


def step_decisions(model, cam, res, visible, scale) -> dict:
    """One step's forward decisions and their inputs, on the CPU."""
    from bloomscene_tpu_torch.models.anchors import get_scaling
    from bloomscene_tpu_torch.models.render import _project
    st = model.state
    intr = cam.intrinsics
    with torch.no_grad():
        anchors = _project(st.anchor, get_scaling(st)[:, :3], st.rotation,
                           intr, cam.device_arrays(st.device))
    b = res.bins
    n = int(b.num_packed)
    return {
        "visible": visible.cpu(), "anchor_depth": anchors.depth.cpu(),
        "near": 0.2,
        "opacity": res.dec.neural_opacity.detach().cpu(),
        "opacity_scale": scale.cpu(),
        "dec_valid": res.dec.valid.cpu(),
        "child_valid": res.proj.valid.cpu(),
        "mean2d": res.proj.mean2d.detach().cpu(),
        "conic": res.proj.conic.detach().cpu(),
        "opac_eff": torch.where(res.proj.valid, res.dec.opacity,
                                0.0).detach().cpu(),
        "pairs": torch.stack([b.gauss_sorted[:n], b.tile_sorted[:n]],
                             1).long().cpu(),
        "width": intr.width, "tile": 16}


def phase2_grad_reference(model, size: int, repo: str):
    """One phase-2 step at ``size`` x ``size`` on copies of ``model``: the
    gradient of every trained leaf (the anchor leaves, the six heads, the
    four hash tables) on the card against the plain path on the CPU, from
    the same view, seeded targets and ``DecodeNoise``, held by
    ``grad_gate``; and bitwise equal between DETERMINISM_RUNS identical
    steps on the card."""
    from bloomscene_tpu_torch.config import GSConfig
    from bloomscene_tpu_torch.convert import model_to
    from bloomscene_tpu_torch.models.decode import DecodeNoise, draw_noise
    from bloomscene_tpu_torch.train.loop import step_gradients
    from bloomscene_tpu_torch.train.optim import make_trainable, param_groups
    cfg = GSConfig(voxel_size=0.03, use_dpr=True, remat=False,
                   pair_capacity=P2_PAIR_CAPACITY)
    cam = orbit_cameras(1, size, size, repo)[0]
    rng = np.random.default_rng(SEED + 4)
    tgt_c = rng.uniform(0, 1, (size, size, 3)).astype(np.float32)
    tgt_d = rng.uniform(1, 4, (size, size)).astype(np.float32)
    noise = draw_noise(model.state.capacity, cfg, 2,
                       torch.Generator().manual_seed(SEED + 4), "cpu")

    def side(dev, dead=()):
        m = make_trainable(model_to(model, dev))
        if dead:
            m.state.alive[list(dead)] = False
        scale: list = []
        hook = opacity_scale_hook(m.heads, scale)
        t0 = time.perf_counter()
        try:
            visible, loss, _, res, grads, _ = step_gradients(
                cfg, cam.intrinsics, torch.zeros(3, device=dev), m,
                [p for _, _, p in param_groups(m)], cam.device_arrays(dev),
                torch.from_numpy(tgt_c).to(dev),
                torch.from_numpy(tgt_d).to(dev), phase=2,
                noise=DecodeNoise(*(x.to(dev) for x in noise)))
        finally:
            hook.remove()
        return dict(loss=float(loss.detach()),
                    bit_per_param=float(res.rate.bit_per_param.detach()),
                    num_pairs=int(res.bins.num_pairs),
                    seconds=time.perf_counter() - t0,
                    grads=[g.detach().cpu() for g in grads],
                    names=[n for n, _, _ in param_groups(m)],
                    decisions=step_decisions(m, cam, res, visible,
                                             scale[0]))

    card_dev = model.state.device
    out = {"card": side(card_dev)}
    repeats = [f"card_{i}" for i in range(2, DETERMINISM_RUNS + 1)]
    for r in repeats:
        out[r] = side(card_dev)
    out["cpu"] = side(torch.device("cpu"))
    names = out["card"]["names"]

    def rerun(rows):
        a, b = side(card_dev, rows), side(torch.device("cpu"), rows)
        return a["grads"], b["grads"]

    gate, ok = grad_gate(names, out["card"]["grads"], out["cpu"]["grads"],
                         out["card"]["decisions"], out["cpu"]["decisions"],
                         rerun)
    leaves = gate.pop("leaves")
    ok = ok and out["card"]["num_pairs"] == out["cpu"]["num_pairs"] > 0
    for name in ("grid.xyz", "heads.grid.0.weight", "state.anchor"):
        ok = ok and leaves[name]["max_abs"] > 0     # the context is reached
    # identical steps on the card: every leaf's gradient bitwise equal
    deterministic = all(torch.equal(a, b) for r in repeats for a, b in zip(
        out["card"]["grads"], out[r]["grads"]))
    ok = ok and deterministic
    summary = {k: {f: v[f] for f in ("loss", "bit_per_param", "num_pairs",
                                     "seconds")} for k, v in out.items()}
    worst = max(leaves, key=lambda n: leaves[n]["err_over_max"])
    return dict(size=size, tolerance=P2_GRAD_TOL, **summary,
                worst_leaf=worst, card_deterministic=deterministic,
                leaves=leaves, gate=gate), ok


def schedule_phase(model, cams, frames, depths, voxel: float, counters: dict,
                   device: str = "cuda", save_path: str | None = None):
    """A fresh Trainer on the perturbed model, run through SCHEDULE's
    phases 0-2 and two densification steps; one record per step (with its
    phase and ms), one per ``adjust_anchor``, and a summary with the mean
    and median step ms of each phase. With ``save_path`` the trainer
    writes its checkpoint there after step RESUME_SAVE_AT (the summary's
    ``checkpoint``: seconds and MB; the save's time falls in the next
    step's ms)."""
    from bloomscene_tpu_torch.config import GSConfig
    from bloomscene_tpu_torch.train.loop import Trainer, phase_of_step
    cfg = GSConfig(**SCHEDULE)
    dev = torch.device(device)
    views = [(c.device_arrays(dev), torch.as_tensor(f, device=dev),
              torch.as_tensor(d, device=dev))
             for c, f, d in zip(cams, frames, depths)]
    trainer = Trainer(perturbed(model, SEED), cfg, cams[0].intrinsics, voxel,
                      seed=SEED, device=device)
    alive0 = trainer.model.state.num_alive()
    capacity0 = trainer.model.state.capacity
    saved = {}

    def save(rec):
        if save_path is not None and rec["iteration"] == RESUME_SAVE_AT:
            t0 = time.perf_counter()
            trainer.save(save_path)
            saved.update(step=RESUME_SAVE_AT,
                         save_s=time.perf_counter() - t0,
                         mb=os.path.getsize(save_path) / 1e6)

    records, ms, launches, wall, peak, caught = timed_run(
        trainer, views, cfg.iterations, counters, after_step=save)
    steps, dens = [], []
    alive, capacity, alive_chain = alive0, capacity0, True
    for rec, t in zip(records, ms):
        it = rec["iteration"]
        steps.append({"iteration": it, "train_phase": phase_of_step(it, cfg),
                      "ms": t, **{k: rec[k] for k in (
                          "loss", "psnr", "bit_per_param",
                          "n_visible_anchors", "num_pairs", "skipped",
                          "tile_overflow", "pair_overflow")}})
        if "densify_n_alive" in rec:
            d = {k[len("densify_"):]: v for k, v in rec.items()
                 if k.startswith("densify_")}
            d["capacity_grown"] = d["capacity"] != capacity
            alive_chain &= d["n_alive"] == alive + d["n_new"] - d["n_pruned"]
            alive, capacity = d["n_alive"], d["capacity"]
            dens.append({"iteration": it, **d})
    by_phase = {}
    for p in (0, 1, 2):
        t = [s["ms"] for s in steps if s["train_phase"] == p]
        by_phase[p] = {"steps": len(t), "first_ms": t[0] if t else None,
                       "mean_ms": float(np.mean(t)) if t and t[0] else None,
                       "median_ms": float(np.median(t)) if t and t[0]
                       else None}
    bpp = [s["bit_per_param"] for s in steps if s["train_phase"] == 2]
    per_forward = 2 if cfg.remat else 1
    n = cfg.iterations
    checks = {
        "steps": len(records) == n,
        "finite": all(np.isfinite(s["loss"]) for s in steps),
        "phase2_rate": bool(bpp) and all(np.isfinite(b) and b > 0
                                         for b in bpp),
        "densified_twice": [d["iteration"] for d in dens] == [20, 30],
        "n_alive_moved_by_new_less_pruned": alive_chain,
        "alive_at_end": trainer.model.state.num_alive() == alive,
        "blend_backward_once_per_step": launches["blend_backward"] == n,
        "forward_kernels_once_per_forward": all(
            launches[k] == per_forward * n
            for k in ("pair_expansion", "slab_expansion", "blend_forward")),
        # one backward a phase-2 step for each of the four encoders
        "hashgrid_bwd_four_per_phase2_step": launches["hashgrid_bwd"]
        == 4 * by_phase[2]["steps"],
        "hashgrid_encode_per_phase2_forward": launches["hashgrid_encode"]
        == per_forward * by_phase[2]["steps"],
        "hashgrid_encode_bwd_once_per_phase2_step":
            launches["hashgrid_encode_bwd"] == by_phase[2]["steps"],
    }
    summary = {
        "steps": len(records), "wall_s": wall, "launches": launches,
        "anchors_start": alive0, "capacity_start": capacity0,
        "anchors_end": trainer.model.state.num_alive(),
        "capacity_end": trainer.model.state.capacity,
        "step_ms_by_phase": by_phase,
        "bit_per_param_phase2": {"first": bpp[0] if bpp else None,
                                 "last": bpp[-1] if bpp else None,
                                 "mean": float(np.mean(bpp)) if bpp
                                 else None},
        "skipped_updates": int(sum(s["skipped"] for s in steps)),
        "peak_mem_bytes": peak, "warnings": len(caught),
        "first_warning": str(caught[0].message) if caught else None,
        "checkpoint": saved or None, "checks": checks}
    return trainer, cfg, views, steps, dens, summary, all(checks.values())


def trainer_differences(a, b) -> list[str]:
    """The names of what differs, to the bit, between two trainers: the
    step, every model leaf, Adam's moments and count, the densify
    statistics, and the three generators' states."""
    diff = [] if a.step == b.step else ["step"]

    def check(name, x, y):
        if x.shape != y.shape or not torch.equal(x, y):
            diff.append(name)
    for f, x in a.model.state.flat_leaves().items():
        check(f"state.{f}", x.detach(), b.model.state.flat_leaves()[f].detach())
    for (n, x), (_, y) in zip(a.model.heads.named_parameters(),
                              b.model.heads.named_parameters()):
        check(f"heads.{n}", x.detach(), y.detach())
    for k in a.model.grid:
        check(f"grid.{k}", a.model.grid[k].detach(), b.model.grid[k].detach())
    for n, x, y in zip(("x_min", "x_max"), a.model.bounds, b.model.bounds):
        check(f"bounds.{n}", x, y)
    oa, ob = a.optimizer.state_arrays(), b.optimizer.state_arrays()
    diff += [f"adam.{k}" for k in oa
             if k not in ob or oa[k].shape != ob[k].shape
             or not np.array_equal(oa[k], ob[k])]
    for f, x, y in zip(a.stats._fields, a.stats, b.stats):
        check(f"stats.{f}", x, y)
    if not torch.equal(a.noise_gen.get_state(), b.noise_gen.get_state()):
        diff.append("noise_gen")
    for g in ("rng", "densify_rng"):
        if (getattr(a, g).bit_generator.state
                != getattr(b, g).bit_generator.state):
            diff.append(g)
    return diff


def resume_check(model, trainer_s, cfg, intr, voxel: float, views,
                 save_path: str, device: str = "cuda"):
    """A fresh Trainer, built as the schedule's from the same initial
    ``model``, restores the schedule's checkpoint (written after step
    RESUME_SAVE_AT, past the densification at step 20 and in phase 2) and
    runs on to the schedule's last step: everything must equal the
    straight run's, bit for bit."""
    from bloomscene_tpu_torch.train.loop import Trainer
    trainer = Trainer(perturbed(model, SEED), cfg, intr, voxel, seed=SEED,
                      device=device)
    t0 = time.perf_counter()
    trainer.restore(save_path)
    restore_s = time.perf_counter() - t0
    step0 = trainer.step
    t0 = time.perf_counter()
    trainer.run(views, iterations=cfg.iterations, log_every=cfg.iterations)
    run_s = time.perf_counter() - t0
    diff = trainer_differences(trainer_s, trainer)
    checks = {"restored_step": step0 == RESUME_SAVE_AT,
              "bitwise_equal_to_straight_run": not diff}
    return dict(restore_s=restore_s, resumed_steps=cfg.iterations - step0,
                run_s=run_s, differences=diff, checks=checks), \
        all(checks.values())


OVERFLOW_KEYS = ("tile_overflow", "pair_overflow", "packed_overflow")


def overflow_summary(records) -> dict:
    """The largest and the summed count of each overflow counter over
    ``records`` (training records or frame statistics), and how many of
    them dropped anything."""
    out = {k: {"max": int(max((r[k] for r in records), default=0)),
               "sum": int(sum(r[k] for r in records))}
           for k in OVERFLOW_KEYS}
    out["records"] = len(records)
    out["records_with_overflow"] = sum(
        any(r[k] > 0 for k in OVERFLOW_KEYS) for r in records)
    return out


def frame_overflow(model, cameras, cfg, mode: str) -> dict:
    """``render_model``'s frame statistics for ``cameras`` (rendered again,
    after the counters were read), summed by ``overflow_summary``, with
    the first frame's buffer sizes."""
    from bloomscene_tpu_torch.pipeline.bloomscene import render_model
    stats: list = []
    render_model(model, cameras, cfg, mode=mode, device="cuda",
                 frame_stats=stats)
    return {**overflow_summary(stats),
            "visible_capacity": stats[0]["visible_capacity"],
            "pair_capacity": stats[0]["pair_capacity"]}


def run_main(argv, log_path: str, counters: dict):
    """``pipeline.run.main(argv)``, unmodified, with its printing sent to
    ``log_path`` and every launch counter set to 0 just before and read
    just after -> (the BloomScene, its stages' spans, launches, wall
    seconds, the orbit's result as the CLI printed it)."""
    from bloomscene_tpu_torch.pipeline import run
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with open(log_path, "w") as log, contextlib.redirect_stdout(log):
        bs = run.main(list(argv))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    with open(log_path) as f:
        video = [ast.literal_eval(ln[len("video: "):]) for ln in f
                 if ln.startswith("video: ")]
    return bs, bs.spans.summary(), launches, wall, video[-1]


def pipeline_phase(repo: str, workdir: str, counters: dict, card: str):
    """``python -m bloomscene_tpu_torch.pipeline.run`` as a user runs it
    (PIPELINE_ARGS on examples/01_childroom.png into a fresh ``workdir``):
    every output file must be there, K1, K3 and K4 must launch for every
    rendered frame and training forward, K2 once a step, every loss
    finite and the last below the first, and no step and no rendered
    frame may drop a splat."""
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    argv = (*PIPELINE_ARGS,
            "--image", os.path.join(repo, "examples", "01_childroom.png"),
            "--text", os.path.join(repo, "examples", "01_childroom.txt"),
            "--save_dir", workdir)
    bs, st, launches, wall, video = run_main(
        argv, os.path.join(workdir, "main.log"), counters)
    cfg = bs.cfg
    steps = bs.trainer.step
    iterations = int(PIPELINE_ARGS[PIPELINE_ARGS.index("--iterations") + 1])
    losses = [r["loss"] for r in bs.logs]
    orbit = bs.scene.preset_cameras["rotate360"]
    evals = bs.scene.eval_cameras or bs.scene.train_cameras
    forwards = steps * (2 if cfg.remat else 1)
    with open(os.path.join(workdir, "codec_sizes.json")) as f:
        sizes = json.load(f)
    with open(os.path.join(workdir, "metrics.json")) as f:
        metrics = json.load(f)
    overflow = {"training": overflow_summary(bs.logs),
                "orbit": frame_overflow(bs.model, orbit, cfg, "eval"),
                "eval_views": frame_overflow(bs.model, evals, cfg, "eval")}

    def video_written(name):
        return (os.path.exists(os.path.join(workdir, name + ".mp4"))
                or os.path.exists(os.path.join(workdir, name, "0000.png")))
    missing = [f for f in PIPELINE_FILES
               if not os.path.exists(os.path.join(workdir, f))]
    missing += [f"eval_renders/{i:03d}.png" for i in range(len(evals))
                if not os.path.exists(os.path.join(
                    workdir, "eval_renders", f"{i:03d}.png"))]
    missing += [v for v in ("rotate360", "rotate360_depth")
                if not video_written(v)]
    checks = {
        "files": not missing,
        "steps": steps == len(losses) == iterations,
        "finite": bool(losses) and all(np.isfinite(losses)),
        "loss_falls": bool(losses) and losses[-1] < losses[0],
        "blend_backward_once_per_step": launches["blend_backward"] == steps,
        "forward_kernels_every_frame_and_forward": all(
            launches[k] >= len(orbit) + len(evals) + forwards
            for k in ("pair_expansion", "slab_expansion", "blend_forward")),
        "decoded": bs.decoded_model is not None,
        "metrics_finite": all(np.isfinite(metrics[k]) for k in (
            "proxy_sharpness", "proxy_colorfulness", "proxy_contrast")),
        "no_splat_dropped": all(o["records_with_overflow"] == 0
                                for o in overflow.values()),
    }
    t_train = st["training"]["total_s"]
    out = {
        "card": card, "argv": list(PIPELINE_ARGS), "wall_s": wall,
        "points": int(bs.traindata["pcd_points"].shape[1]),
        "supervision_frames": len(bs.traindata["frames"]),
        "anchors": bs.model.state.num_alive(),
        "capacity": bs.model.state.capacity,
        "max_splats_per_tile": cfg.max_splats_per_tile,
        "generate_s": st["generate"]["total_s"],
        "training_s": t_train, "steps": steps,
        "steps_per_s": steps / t_train,
        "compress_s": st["compress"]["total_s"],
        "encode_s": sizes["encode_time_s"], "decode_s": sizes["decode_time_s"],
        "save_outputs_s": st["save_outputs"]["total_s"],
        "render_video_s": st["render_video"]["total_s"],
        "video_frames": video["n_frames"], "video_fps": video["eval_fps"],
        "render_eval_s": st["render_eval"]["total_s"],
        "eval_frames": len(evals), "eval_fps": metrics["eval_fps"],
        "total_MB": sizes["total_MB"],
        "proxy": {k: metrics[k] for k in (
            "proxy_sharpness", "proxy_colorfulness", "proxy_contrast")},
        "loss_first": losses[0] if losses else None,
        "loss_last": losses[-1] if losses else None,
        "loss_first5": float(np.mean(losses[:5])) if losses else None,
        "loss_last5": float(np.mean(losses[-5:])) if losses else None,
        "overflow": overflow,
        "launches": launches, "missing": missing, "checks": checks}
    return bs, out, all(checks.values())


def cold_start_phase(workdir: str, first, counters: dict, card: str):
    """``--load_dir`` on the pipeline's output in a fresh ``BloomScene``:
    the decoded state must equal the first run's in-memory decoded model
    bit for bit, K1, K3 and K4 launch for every rendered frame, and no
    decoded frame drops a splat."""
    bs, st, launches, wall, video = run_main(
        ("--load_dir", workdir, "--device", "cuda", "--render_frames", "8"),
        os.path.join(workdir, "cold_start.log"), counters)
    a, b = bs.decoded_model, first.decoded_model
    differ = [f for f in ("anchor", "feat", "scaling_log", "offset",
                          "mask_logit")
              if a is None or not torch.equal(getattr(a.state, f),
                                              getattr(b.state, f))]
    orbit = bs.scene.preset_cameras["rotate360"]
    n_eval = len(bs.scene.eval_cameras or bs.scene.train_cameras)
    # render_eval writes into the loaded run's directory
    with open(os.path.join(workdir, "metrics.json")) as f:
        metrics = json.load(f)
    overflow = frame_overflow(bs.decoded_model, orbit, bs.cfg, "decoded")
    checks = {
        "decoded_bitwise_equal": not differ,
        "forward_kernels_every_frame": all(
            launches[k] >= len(orbit) + n_eval
            for k in ("pair_expansion", "slab_expansion", "blend_forward")),
        "no_backward": launches["blend_backward"] == 0,
        "no_splat_dropped": overflow["records_with_overflow"] == 0,
    }
    return bs, {"card": card, "wall_s": wall,
                "decoded_fps": video["eval_fps"],
                "video_frames": video["n_frames"],
                "render_video_s": st["render_video"]["total_s"],
                "eval_fps": metrics["eval_fps"],
                "eval_frames": n_eval, "differences": differ,
                "overflow": overflow, "launches": launches,
                "checks": checks}, all(checks.values())


def capture_grid_scatter(trainer, cfg, views):
    """The cotangent rows, cells and table sizes that the hash grid's
    backward takes in one phase-2 step of ``trainer`` (the first view;
    its gradients are computed and dropped), one entry per encoder."""
    from bloomscene_tpu_torch.models.decode import draw_noise
    from bloomscene_tpu_torch.ops import hashgrid
    from bloomscene_tpu_torch.train.loop import decoded_rows, step_gradients
    cam, gt_image, gt_depth = views[0]
    model, dev = trainer.model, trainer.bg.device
    noise = draw_noise(decoded_rows(model, cfg), cfg, 2,
                       torch.Generator(device=dev).manual_seed(SEED + 7), dev)
    calls, original = [], hashgrid.grid_scatter

    def record(rows, idx, n_cells):
        calls.append((rows.clone(), idx.clone(), n_cells))
        return original(rows, idx, n_cells)

    hashgrid.grid_scatter = record
    try:
        step_gradients(cfg, trainer.intr, trainer.bg, model,
                       [p for _, _, p in trainer.optimizer.params], cam,
                       gt_image, gt_depth, phase=2, noise=noise)
    finally:
        hashgrid.grid_scatter = original
    return calls


def hashgrid_row(calls):
    """hashgrid_bwd on one phase-2 step's four calls: against a float64
    index_add_ (within HASHGRID_RTOL of each cell's summed magnitudes),
    against its plain version (index_add_, atomic float32: twice that),
    bitwise equal to itself; the kernel's time with its sort's share (the
    sort alone) and its sum's (the rest), the plain version's, and
    index_add_'s in its atomic form and in PyTorch's deterministic mode
    (torch.use_deterministic_algorithms, the library call with the
    kernel's contract), and the bound, each summed over the calls."""
    from bloomscene_tpu_torch.ops.cuda import build
    from bloomscene_tpu_torch.ops.cuda.hashgrid_bwd import (
        grid_scatter, grid_scatter_plain, grid_scatter_sort)
    ok, err, used = True, 0.0, 0.0
    ms = plain_ms = lib_ms = det_ms = bound_s = sort_ms = 0.0
    det_same = True
    shapes = []
    for rows, idx, n_cells in calls:
        got = grid_scatter(rows, idx, n_cells)
        again = grid_scatter(rows, idx, n_cells)
        ref = grid_scatter_plain(rows.double(), idx, n_cells)
        mag = grid_scatter_plain(rows.double().abs(), idx, n_cells)
        plain = grid_scatter_plain(rows, idx, n_cells)
        tol = HASHGRID_RTOL * mag
        ok = (ok and torch.equal(got, again)
              and bool(((got.double() - ref).abs() <= tol).all())
              and bool(((got.double() - plain.double()).abs()
                        <= 2 * tol).all())
              and bool(torch.isfinite(got).all()))
        err = max(err, max_abs(got, ref))
        used = max(used, float(((got.double() - ref).abs()
                                / tol.clamp(min=1e-300)).max()))
        out = torch.zeros_like(plain)
        ms += time_ms(lambda: grid_scatter(rows, idx, n_cells), 10)
        sort_ms += time_ms(lambda: grid_scatter_sort(rows, idx, n_cells), 10)
        plain_ms += time_ms(lambda: grid_scatter_plain(rows, idx, n_cells),
                            10)
        lib_ms += time_ms(lambda: out.index_add_(0, idx, rows), 10)
        was = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)
        try:
            det_ms += time_ms(lambda: out.index_add_(0, idx, rows), 10)
            det_same = det_same and torch.equal(
                grid_scatter_plain(rows, idx, n_cells),
                grid_scatter_plain(rows, idx, n_cells))
        finally:
            torch.use_deterministic_algorithms(was)
        M, F = rows.shape
        # rows and cells read once, the table written once; F adds an entry
        bound_s += bound(4 * M * F + 8 * M + 4 * n_cells * F, M * F)[0]
        shapes.append({"entries": M, "features": F, "cells": n_cells,
                       "largest_run": int(torch.unique(
                           idx, return_counts=True)[1].max())})
    return dict(
        name="hashgrid_bwd", route="cuda",
        source="bloomscene_tpu_torch/csrc/hashgrid_bwd.cu",
        # no TPU kernel: the transpose of this gather, XLA's scatter-add
        replaces="bloomscene_tpu/ops/hashgrid.py:147", max_abs_err=err,
        max_tolerance_used=used, rtol_of_magnitudes=HASHGRID_RTOL,
        deterministic=ok, ms=ms, sort_ms=sort_ms, sum_ms=ms - sort_ms,
        plain_ms=plain_ms, bound_ms=bound_s, bound_by="bytes",
        bound_share=bound_s / ms, library_ms=lib_ms,
        library_ms_deterministic=det_ms,
        library_deterministic_bitwise=det_same, calls=len(calls),
        **ptxas_report(build.build_log("hashgrid_bwd")),
        shapes={"calls": shapes}), ok


def codec_phase(model, cfg, workdir: str, device: str = "cuda"):
    """estimate, encode and decode (the model as the shell) of ``model``,
    then the decoded scene's checks and a re-encode of it."""
    import shutil
    from bloomscene_tpu_torch.codec.codec import (decode_scene, encode_scene,
                                                  estimate_final_bits)
    from bloomscene_tpu_torch.convert import model_to
    from bloomscene_tpu_torch.models.anchors import get_mask, get_mask_anchor
    from bloomscene_tpu_torch.ops.hashgrid import all_grid_params_flat
    shutil.rmtree(workdir, ignore_errors=True)
    path, path2 = (os.path.join(workdir, d) for d in ("bitstreams",
                                                      "bitstreams2"))
    model = model_to(model, model.state.device)
    t0 = time.perf_counter()
    est = estimate_final_bits(model, cfg)
    est_s = time.perf_counter() - t0
    sizes = encode_scene(model, cfg, path)
    t0 = time.perf_counter()
    dec_t: dict = {}
    decoded = decode_scene(model, cfg, path, timings=dec_t, device=device)
    decode_s = time.perf_counter() - t0
    st = model_to(model, "cpu").state
    keep = st.alive & (get_mask_anchor(st) > 0)
    dst = model_to(decoded, "cpu").state
    masks_equal = torch.equal(get_mask(dst), get_mask(st)[keep])
    ob = all_grid_params_flat(model.grid).cpu()
    db = all_grid_params_flat(decoded.grid).cpu()
    hash_equal = torch.equal(torch.where(ob >= 0, 1.0, -1.0), db)
    feat_err = max_abs(dst.feat, st.feat[keep])
    sizes2 = encode_scene(decoded, cfg, path2)
    def read(d, f):
        with open(os.path.join(d, f), "rb") as fh:
            return fh.read()

    streams = sorted(f for f in os.listdir(path) if f.endswith(".b"))
    same = [f for f in streams if read(path, f) == read(path2, f)]
    reencode_equal = (len(same) == len(streams)
                      and sorted(os.listdir(path)) == sorted(
                          os.listdir(path2)))
    checks = {"n_anchors": sizes["n_anchors"] == decoded.state.num_alive()
              == est["n_anchors"] > 0,
              "decoded_on_device": decoded.state.device.type
              == torch.device(device).type,
              "masks_equal": masks_equal,
              "hash_binarized_equal": hash_equal,
              "feat_within_two_steps": feat_err < 2 * cfg.q_base_feat,
              "reencode_byte_identical": reencode_equal}
    mb = {k: v for k, v in sizes.items() if k.endswith("_MB")}
    out = dict(sizes_MB=mb, estimate_MB={k: v for k, v in est.items()
                                         if k.endswith("_MB")},
               n_anchors=sizes["n_anchors"], estimate_s=est_s,
               encode_s=sizes["encode_time_s"],
               encode_split={k: sizes[k] for k in ("context_s",
                                                   "quantize_s", "rans_s")},
               decode_s=decode_s, decode_split=dec_t,
               reencode_s=sizes2["encode_time_s"], streams=len(streams),
               streams_identical=len(same), feat_max_abs_err=feat_err,
               checks=checks)
    return decoded, out, all(checks.values())


def golden_check(size: int = 64, n: int = 400, device: str = "cuda"):
    """At ``size`` x ``size``, a seeded scene of ``n`` Gaussians projected
    on the card: the tile path (K3, K4, K1, and K2 in the backward)
    against rasterize_reference(tile=16) on the same projected splats,
    values and the gradients of tests/test_tile_rasterizer.py's loss."""
    from bloomscene_tpu_torch.ops import graphics, projection
    from bloomscene_tpu_torch.ops.projection import ProjectedSplats
    from bloomscene_tpu_torch.ops.reference_rasterizer import (
        rasterize_reference)
    from bloomscene_tpu_torch.ops.tile_rasterizer import rasterize_tiles
    dev = torch.device(device)
    rng = np.random.default_rng(SEED + 6)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    means = np.stack([rng.uniform(-1.2, 1.2, n), rng.uniform(-1.2, 1.2, n),
                      rng.uniform(0.8, 5.0, n)], -1)
    scales = rng.uniform(0.02, 0.25, (n, 3))
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    colors = rng.uniform(0, 1, (n, 3))
    opac = rng.uniform(0.1, 0.95, n)
    view = graphics.world_to_view(np.eye(3), np.zeros(3))
    full = graphics.projection_matrix(0.01, 100.0, 1.0, 1.0) @ view
    f = graphics.fov2focal(1.0, size)
    proj = projection.project_gaussians(
        t(means), projection.build_cov3d(t(scales), t(quats)), t(view),
        t(full), size, size, f, f, float(np.tan(0.5)), float(np.tan(0.5)))
    tgt_c = t(rng.uniform(0, 1, (size, size, 3)))
    tgt_d = t(rng.uniform(1, 4, (size, size)))
    live = (proj.mean2d, proj.conic, proj.depth, t(colors), t(opac),
            t([0.25, 0.5, 0.75]))
    names = ("mean2d", "conic", "depth", "color", "opac", "bg")

    def run(raster):
        leaves = [x.detach().clone().requires_grad_(True) for x in live]
        p = ProjectedSplats(mean2d=leaves[0], depth=leaves[2],
                            conic=leaves[1], radius=proj.radius,
                            valid=proj.valid)
        out = raster(p, leaves[3], leaves[4], leaves[5])
        loss = (torch.mean((out.color - tgt_c) ** 2)
                + 0.7 * torch.mean((out.depth - tgt_d) ** 2)
                + 0.1 * torch.mean(out.final_T) + 0.05 * torch.mean(out.alpha))
        return out, loss, torch.autograd.grad(loss, leaves)

    gold, loss_g, g_gold = run(lambda p, c, o, b: rasterize_reference(
        p, c, o, b, size, size, tile=16))
    tile, loss_t, g_tile = run(lambda p, c, o, b: rasterize_tiles(
        p, c, o, b, size, size, tile=16, tile_capacity=256)[0])
    values, grads, ok = {}, {}, int(proj.valid.sum()) > 0
    for field, (atol, rtol) in GOLDEN_TOL.items():
        a, b = getattr(tile, field).detach(), getattr(gold, field).detach()
        values[field] = max_abs(a, b)
        ok = ok and bool(((a - b).abs() <= atol + rtol * b.abs()).all())
    for nm, a, b in zip(names, g_tile, g_gold):
        grads[nm] = {"max_abs_err": max_abs(a, b),
                     "max_abs": float(b.abs().max())}
        ok = ok and bool(torch.allclose(a, b, atol=GOLDEN_GRAD_ATOL,
                                        rtol=GOLDEN_GRAD_RTOL))
        ok = ok and bool(torch.isfinite(a).all())
    ok = ok and float(g_gold[2].abs().max()) > 0        # depth reached
    return dict(size=size, gaussians=n, valid=int(proj.valid.sum()),
                loss=float(loss_t.detach()),
                loss_golden=float(loss_g.detach()),
                max_abs_err=values, grads=grads, tolerances=GOLDEN_TOL,
                grad_atol=GOLDEN_GRAD_ATOL, grad_rtol=GOLDEN_GRAD_RTOL), ok


def no_free_slot(model, cams, frames, depths, device: str = "cuda"):
    """A copy of ``model`` cut to its alive anchors (no free slot), with
    its bounds, and the views of ``frames``/``depths`` on ``device``."""
    from bloomscene_tpu_torch.convert import model_to
    from bloomscene_tpu_torch.models.anchors import update_anchor_bounds
    dev = torch.device(device)
    model = model_to(model, dev)
    n = model.state.num_alive()
    keep = torch.arange(n, device=dev)
    st = model.state.gather_rows(keep, model.state.alive[keep])
    model = model._replace(state=st, bounds=update_anchor_bounds(st))
    views = [(c.device_arrays(dev), torch.as_tensor(f, device=dev),
              torch.as_tensor(d, device=dev))
             for c, f, d in zip(cams, frames, depths)]
    return model, views


def growth_phase(model, cams, frames, depths, voxel: float, counters: dict,
                 device: str = "cuda"):
    """A Trainer on the perturbed ``model`` cut to its alive anchors (no
    free slot), run to GROWTH's densification step, which must grow the
    capacity; the optimizer's list must hold the model's live leaves and
    one more step must change them."""
    from bloomscene_tpu_torch.config import GSConfig
    from bloomscene_tpu_torch.train.loop import Trainer
    from bloomscene_tpu_torch.train.optim import param_groups
    cfg = GSConfig(**GROWTH)
    model, views = no_free_slot(model, cams, frames, depths, device)
    n = model.state.num_alive()
    trainer = Trainer(perturbed(model, SEED), cfg, cams[0].intrinsics, voxel,
                      seed=SEED, device=device)
    capacity0 = trainer.model.state.capacity
    records, ms, launches, wall, peak, caught = timed_run(
        trainer, views, cfg.iterations, counters)
    dens = {k[len("densify_"):]: v for k, v in records[-1].items()
            if k.startswith("densify_")}
    dens["capacity_grown"] = dens.get("capacity", capacity0) != capacity0
    held = [p for _, _, p in trainer.optimizer.params]
    live = [p for _, _, p in param_groups(trainer.model)]
    holds_live = (len(held) == len(live)
                  and all(a is b for a, b in zip(held, live)))
    moments_fit = all(m.shape == p.shape for m, p in
                      zip(trainer.optimizer.m, held))
    before = [p.detach().clone() for p in held]
    trainer.run(views, iterations=cfg.iterations + 1, log_every=1)
    names = [nm for nm, _, _ in trainer.optimizer.params]
    changed = {nm: not torch.equal(a, p.detach())
               for nm, a, p in zip(names, before, held)}
    state_changed = all(changed[nm] for nm in (
        "state.feat", "state.offset", "state.scaling_log",
        "state.mask_logit"))
    checks = {
        "capacity_grown": dens["capacity_grown"],
        "capacity_end": trainer.model.state.capacity > capacity0,
        "optimizer_holds_live_leaves": holds_live,
        "moments_fit_leaves": moments_fit,
        "step_changes_live_leaves": state_changed,
        "finite": all(np.isfinite(r["loss"]) for r in records),
        "blend_backward_once_per_step":
            launches["blend_backward"] == cfg.iterations,
        "forward_kernels_once_per_forward": all(
            launches[k] == (2 if cfg.remat else 1) * cfg.iterations
            for k in ("pair_expansion", "slab_expansion", "blend_forward")),
    }
    summary = {"anchors_start": n, "capacity_start": capacity0,
               "capacity_end": trainer.model.state.capacity,
               "densify": dens, "steps": len(records), "wall_s": wall,
               "step_ms_median": float(np.median(ms[1:])) if ms[0] else None,
               "launches": launches, "leaves_changed": sum(changed.values()),
               "leaves": len(changed), "warnings": len(caught),
               "checks": checks}
    return trainer, cfg, views, summary, all(checks.values())


def tile_checks(model, cam, cfg, tiles=TILES):
    """One orbit frame rendered at each tile: the whole frame (binning
    included) finite; K1 bitwise and K2 within its magnitude tolerance
    against their plain versions (K2 on seeded cotangent planes at a
    per-pixel scale) and bitwise across two launches; both kernels' times,
    block shapes and splits, and the overflow counters. A tile above 32 is
    binned with TILE_CAPACITY[tile] slots a tile (the default 1,024 scaled
    by the tile's area over tile 16's), since a larger tile gathers more
    splats; slots past it drop the farthest pairs and are counted."""
    import dataclasses
    from bloomscene_tpu_torch.models.render import prefilter_anchors, render
    from bloomscene_tpu_torch.ops.cuda.blend import (blend_backward,
                                                     blend_backward_plain,
                                                     blend_forward,
                                                     blend_forward_plain)
    from bloomscene_tpu_torch.ops.tiles import tile_grid
    intr = cam.intrinsics
    arrs = cam.device_arrays(model.state.device)
    vis = prefilter_anchors(model, intr, arrs)
    out = {}
    ok = True
    for tile in tiles:
        c = dataclasses.replace(cfg, tile_size=tile, max_splats_per_tile=(
            TILE_CAPACITY.get(tile, cfg.max_splats_per_tile)))
        res = render(model, intr, arrs, c, mode="eval", visible=vis,
                     pair_capacity=1 << 21, packed_capacity=1 << 21)
        bins = res.bins
        gx, _ = tile_grid(intr.width, intr.height, tile)
        counts_p = bins.counts[bins.perm.long()].contiguous()
        args = (bins.slab, counts_p, bins.perm, tile, gx)
        fk = blend_forward(*args)
        fp = blend_forward_plain(*args)
        k1_bitwise = all(torch.equal(a, b) for a, b in zip(fk, fp))
        rng = np.random.default_rng(SEED + 8)
        u = [torch.from_numpy(rng.normal(size=fp[5].shape).astype(
            np.float32)).to(fp[5].device) for _ in range(6)]
        bargs = (*args, fp[5], fp[6], *u)
        got = blend_backward(*bargs)
        want = blend_backward_plain(*bargs)
        tol = GRAD_ATOL + GRAD_RTOL * blend_backward_plain(*bargs,
                                                           magnitude=True)
        k2_ok = (bool(((got - want).abs() <= tol).all())
                 and torch.equal(got, blend_backward(*bargs)))
        frame_ok = bool(torch.isfinite(res.out.color).all()
                        and torch.isfinite(res.out.depth).all())
        ok = (ok and k1_bitwise and k2_ok and frame_ok
              and int(bins.num_pairs) > 0)
        k1, k2 = launch_shape("blend", tile), launch_shape("blend_bwd", tile)
        k1_b, k1_by = k1_bound(counts_p, fp[6], tile)
        k2_b, k2_by = k2_bound(counts_p, fp[6], tile, bins.slab.shape[1])
        k1_ms = time_ms(lambda: blend_forward(*args), 50)
        k2_ms = time_ms(lambda: blend_backward(*bargs), 20)
        out[tile] = {
            "positions": counts_p.numel(), "num_pairs": int(bins.num_pairs),
            "max_splats_per_tile": c.max_splats_per_tile,
            "largest_tile_count": int(counts_p.max()),
            "tile_overflow": int(bins.tile_overflow),
            "pair_overflow": int(bins.pair_overflow),
            "frame_finite": frame_ok,
            "k1_bitwise": k1_bitwise, "k2_within_tolerance": k2_ok,
            "k2_max_abs_err": max_abs(got, want),
            "k1_ms": k1_ms, "k2_ms": k2_ms,
            "k1_plain_ms": time_ms(lambda: blend_forward_plain(*args), 1),
            "k2_plain_ms": time_ms(lambda: blend_backward_plain(*bargs), 1),
            "k1_bound_ms": k1_b, "k1_bound_by": k1_by,
            "k2_bound_ms": k2_b, "k2_bound_by": k2_by,
            "k1_bound_share": k1_b / k1_ms, "k2_bound_share": k2_b / k2_ms,
            "k1_block": k1["block"], "k1_splits": k1["splits"],
            "k2_block": k2["block"], "k2_splits": k2["splits"],
            "k2_dynamic_smem_bytes": k2["dynamic_smem_bytes"],
            "color_mean": float(res.out.color.mean())}
    return out, ok


def phase2_ab(trainer, views, counters: dict):
    """AB_STEPS phase-2 steps of ``trainer`` four times: the hash grid's
    backward on hashgrid_bwd, on index_add_ (its plain version), on
    index_add_, on hashgrid_bwd -> the step ms of each arm."""
    from bloomscene_tpu_torch.ops import hashgrid
    from bloomscene_tpu_torch.ops.cuda.hashgrid_bwd import grid_scatter_plain
    original = hashgrid.grid_scatter
    arms = {"hashgrid_bwd": [], "index_add_": []}
    for arm in ("hashgrid_bwd", "index_add_", "index_add_", "hashgrid_bwd"):
        hashgrid.grid_scatter = (original if arm == "hashgrid_bwd"
                                 else grid_scatter_plain)
        try:
            _, ms, launches, _, _, _ = timed_run(
                trainer, views, trainer.step + AB_STEPS, counters)
        finally:
            hashgrid.grid_scatter = original
        arms[arm] += ms
        if arm == "hashgrid_bwd" and launches["hashgrid_bwd"] != 4 * AB_STEPS:
            return {"error": f"hashgrid_bwd launched "
                    f"{launches['hashgrid_bwd']} times"}, False
    out = {arm: {"steps": len(v), "median_ms": float(np.median(v)),
                 "mean_ms": float(np.mean(v)), "ms": v}
           for arm, v in arms.items()}
    return out, True


def same_launches(loop: dict, host: dict) -> bool:
    """A device-loop run launched each kernel as often as the host loop,
    the loop's stamps aside (the host loop stamps nothing)."""
    return all(loop[k] == host[k] for k in host if k != "stamp")


def record_differences(a: list, b: list) -> list[str]:
    """``iteration:key`` of every record entry that differs between two
    runs' records (the surgery's wall time aside)."""
    if [r["iteration"] for r in a] != [r["iteration"] for r in b]:
        return ["iterations"]
    return [f"{ra['iteration']}:{k}" for ra, rb in zip(a, b)
            for k in sorted(set(ra) | set(rb))
            if k != "densify_time_s" and ra.get(k) != rb.get(k)]


def device_loop_run(trainer, views, iterations: int, counters: dict):
    """``trainer.run(device_loop=True, max_chunk=LOOP_CHUNK)`` to step
    ``iterations``, a record each step, with every launch counter set to 0
    just before and read just after -> (records, chunks, launches with the
    graphs' replays, wall seconds, peak device bytes, caught warnings). A
    chunk's records come together after its one read of the metrics, so a
    chunk's seconds run from the previous chunk's records to its own (its
    surgery included, as a host-loop step's ms include it)."""
    import warnings

    from bloomscene_tpu_torch.ops.cuda import loop_launches
    records, stamps = [], []
    timed = trainer.bg.device.type == "cuda"

    def on_step(rec):
        records.append(rec)
        stamps.append(time.perf_counter())

    if timed:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    first = trainer.step + 1
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        trainer.run(views, iterations=iterations, log_every=1,
                    callback=on_step, device_loop=True, max_chunk=LOOP_CHUNK)
        if timed:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in counters.items()}
    chunks, it, last = [], first, t0
    while it <= iterations:
        e = trainer._chunk_end(it, iterations, LOOP_CHUNK)
        t = stamps[it - first]
        chunks.append({"first": it, "last": e, "seconds": t - last})
        it, last = e + 1, t
    # the loop resets the peak statistic at each chunk: the run's peak is
    # the largest of the chunks' and of what followed the last reset
    peak = (max([torch.cuda.max_memory_allocated()]
                + [c["peak_mem_bytes"] for c in trainer.chunk_log
                   if c["peak_mem_bytes"] is not None])
            if timed else None)
    return (records, chunks, loop_launches(counts, trainer.graph_log), wall,
            peak, caught)


def loop_step_ms(chunks: list, graph_log: list, cfg) -> dict:
    """For each training phase of a device-loop run: the mean and median
    over its chunks of chunk seconds over steps, and the phase's chunk
    seconds over its steps (``wall_ms``, the wall time a step as the host
    loop's mean counts it; all three with the eager first step and the
    capture of a new graph included), and the device ms a replayed step
    (the replays' CUDA-event ms over their count), in ms."""
    from bloomscene_tpu_torch.train.loop import phase_of_step
    out = {}
    for p in (0, 1, 2):
        mine = [c for c in chunks if phase_of_step(c["first"], cfg) == p]
        t = [1e3 * c["seconds"] / (c["last"] - c["first"] + 1)
             for c in mine]
        steps = sum(c["last"] - c["first"] + 1 for c in mine)
        graphs = [g for g in graph_log if g["phase"] == p]
        replays = sum(g["replays"] for g in graphs)
        out[p] = {"chunks": len(t), "steps": steps,
                  "wall_ms": (1e3 * sum(c["seconds"] for c in mine) / steps
                              if steps else None),
                  "mean_ms": float(np.mean(t)) if t else None,
                  "median_ms": float(np.median(t)) if t else None,
                  "replays": replays,
                  "replay_ms": (sum(g["replay_ms"] for g in graphs) / replays
                                if replays else None)}
    return out


def graph_checks(graph_log: list, per_forward: int) -> bool:
    """Every captured step holds K2 and emission_sums once, K1, K3 and K4
    once a forward, and in phase 2 (none before) hashgrid_encode once a
    forward, hashgrid_encode_bwd once and hashgrid_bwd four times."""
    return bool(graph_log) and all(
        g["replays"] > 0 and g["launches"]["blend_backward"] == 1
        and g["launches"]["emission_sums"] == 1
        and all(g["launches"][k] == per_forward for k in FORWARD_KERNELS)
        and g["launches"]["hashgrid_bwd"] == (4 if g["phase"] == 2 else 0)
        and g["launches"]["hashgrid_encode"]
        == (per_forward if g["phase"] == 2 else 0)
        and g["launches"]["hashgrid_encode_bwd"]
        == (1 if g["phase"] == 2 else 0)
        for g in graph_log)


def device_loop_phase(model, cams, frames, depths, voxel: float,
                      counters: dict, reference, host_records: list,
                      host_summary: dict, device: str = "cuda"):
    """A fresh Trainer on the perturbed model at SCHEDULE, run by the
    device loop in chunks of LOOP_CHUNK: every model leaf, Adam's moments
    and count, the statistics, the three generators' states and every
    record must equal the schedule phase's host loop at step 40
    (``reference``, its snapshot), bit for bit; each capture must hold the
    step's kernels, and the kernels must run as often as in the host loop.
    Step ms by phase beside the host loop's of this call, the captures,
    replays and peak memory."""
    from bloomscene_tpu_torch.config import GSConfig
    from bloomscene_tpu_torch.train.loop import Trainer, phase_of_step
    cfg = GSConfig(**SCHEDULE)
    dev = torch.device(device)
    views = [(c.device_arrays(dev), torch.as_tensor(f, device=dev),
              torch.as_tensor(d, device=dev))
             for c, f, d in zip(cams, frames, depths)]
    trainer = Trainer(perturbed(model, SEED), cfg, cams[0].intrinsics, voxel,
                      seed=SEED, device=device)
    records, chunks, launches, wall, peak, caught = device_loop_run(
        trainer, views, cfg.iterations, counters)
    diff = trainer_differences(reference, trainer)
    rec_diff = record_differences(host_records, records)
    graphs = trainer.graph_log
    n = cfg.iterations
    per_forward = 2 if cfg.remat else 1
    p2 = sum(phase_of_step(i, cfg) == 2 for i in range(1, n + 1))
    checks = {
        "steps": len(records) == n,
        "bitwise_equal_to_host_loop": not diff,
        "records_equal_to_host_loop": not rec_diff,
        "graphs_hold_the_step_kernels": graph_checks(graphs, per_forward),
        "blend_backward_once_per_step": launches["blend_backward"] == n,
        "forward_kernels_once_per_forward": all(
            launches[k] == per_forward * n for k in FORWARD_KERNELS),
        "hashgrid_bwd_four_per_phase2_step":
            launches["hashgrid_bwd"] == 4 * p2,
        "hashgrid_encode_bwd_once_per_phase2_step":
            launches["hashgrid_encode_bwd"] == p2,
    }
    host = host_summary["step_ms_by_phase"]
    summary = {
        "steps": len(records), "max_chunk": LOOP_CHUNK, "wall_s": wall,
        "step_ms_by_phase": {p: {"device_loop": v, "host_loop": host[p]}
                             for p, v in loop_step_ms(chunks, graphs,
                                                      cfg).items()},
        "chunks": chunks, "captures": len(graphs),
        "capture_s": [g["capture_s"] for g in graphs],
        "replays": sum(g["replays"] for g in graphs),
        "eager_steps": n - sum(g["replays"] for g in graphs),
        "graphs": graphs, "launches": launches,
        "peak_mem_bytes": peak,
        "host_loop_peak_mem_bytes": host_summary["peak_mem_bytes"],
        "differences": diff, "record_differences": rec_diff[:20],
        "warnings": len(caught), "checks": checks}
    return summary, all(checks.values())


def device_loop_growth_phase(model, cams, frames, depths, voxel: float,
                             counters: dict, device: str = "cuda"):
    """The growth phase's scene (no free slot) for GROWTH_LOOP_STEPS steps,
    twice: the host loop and the device loop. The surgery at step 20 must
    grow the capacity, a graph must be captured at the grown shape, and
    the two runs must be bitwise equal at the end, records included."""
    from bloomscene_tpu_torch.config import GSConfig
    from bloomscene_tpu_torch.convert import model_to
    from bloomscene_tpu_torch.train.loop import Trainer
    cfg = GSConfig(**dict(GROWTH, iterations=GROWTH_LOOP_STEPS))
    base, views = no_free_slot(model, cams, frames, depths, device)
    capacity0 = base.state.capacity
    runs = {}
    for loop in (False, True):
        trainer = Trainer(perturbed(model_to(base, base.state.device), SEED),
                          cfg, cams[0].intrinsics, voxel, seed=SEED,
                          device=device)
        if loop:
            records, chunks, launches, wall, peak, _ = device_loop_run(
                trainer, views, cfg.iterations, counters)
        else:
            records, _, launches, wall, peak, _ = timed_run(
                trainer, views, cfg.iterations, counters)
        runs[loop] = (trainer, records, launches, wall)
    (host, host_rec, host_launches, host_wall), \
        (dl, dl_rec, dl_launches, dl_wall) = runs[False], runs[True]
    dens = [r for r in dl_rec if "densify_capacity" in r]
    diff = trainer_differences(host, dl)
    rec_diff = record_differences(host_rec, dl_rec)
    n = cfg.iterations
    checks = {
        "densified_at_20": [r["iteration"] for r in dens] == [20],
        "capacity_grown": dl.model.state.capacity > capacity0,
        "graph_at_grown_shape": any(g["step"] > 20 for g in dl.graph_log),
        "bitwise_equal_to_host_loop": not diff,
        "records_equal_to_host_loop": not rec_diff,
        "graphs_hold_the_step_kernels": graph_checks(dl.graph_log, 2),
        "launches_as_host_loop": same_launches(dl_launches, host_launches),
        "blend_backward_once_per_step": dl_launches["blend_backward"] == n,
    }
    summary = {"anchors_start": base.state.num_alive(),
               "capacity_start": capacity0,
               "capacity_end": dl.model.state.capacity, "steps": n,
               "host_loop_wall_s": host_wall, "device_loop_wall_s": dl_wall,
               "chunks": chunks, "graphs": dl.graph_log,
               "launches": dl_launches, "host_launches": host_launches,
               "differences": diff, "record_differences": rec_diff[:20],
               "checks": checks}
    return summary, all(checks.values())


def dp_phase(model, cams, frames, depths, voxel: float, counters: dict,
             device: str = "cuda"):
    """``Trainer(dp_batch=DP_BATCH)`` on the perturbed model at full width
    (the train phase's config, the 8 orbit views), DP_STEPS phase-0 steps:
    the loss falls and K2 runs once a view. Then tests/test_parallel.py's
    identical-views property on the card: one batched step over DP_BATCH
    copies of one view equals one single-view step (loss rtol 1e-5, leaves
    atol 1e-5 and rtol 1e-4) and the busiest anchor counts DP_BATCH
    views."""
    from bloomscene_tpu_torch.config import GSConfig
    from bloomscene_tpu_torch.convert import model_to
    from bloomscene_tpu_torch.models import densify
    from bloomscene_tpu_torch.train.loop import (Trainer, make_dp_train_step,
                                                 make_train_step, stack_views)
    from bloomscene_tpu_torch.train.optim import Adam, make_trainable
    cfg = GSConfig(voxel_size=0.03, use_dpr=True, start_stat=0)
    dev = torch.device(device)
    views = [(c.device_arrays(dev), torch.as_tensor(f, device=dev),
              torch.as_tensor(d, device=dev))
             for c, f, d in zip(cams, frames, depths)]
    start = perturbed(model_to(model, dev), SEED)
    trainer = Trainer(model_to(start, dev), cfg, cams[0].intrinsics, voxel,
                      seed=SEED, device=device, dp_batch=DP_BATCH)
    records, ms, launches, wall, peak, caught = timed_run(
        trainer, views, DP_STEPS, counters)
    losses = [r["loss"] for r in records]
    step_ms = float(np.median(ms[1:])) if ms[0] is not None else None

    intr, bg = cams[0].intrinsics, torch.zeros(3, device=dev)
    single = make_trainable(model_to(start, dev))
    batched = make_trainable(model_to(start, dev))
    adam_1, adam_b = Adam(cfg, 1.0, single), Adam(cfg, 1.0, batched)
    _, _, met_1 = make_train_step(cfg, intr, adam_1, bg)(
        single, densify.init_stats(single.state.capacity, cfg.n_offsets,
                                   dev), *views[0], phase=0,
        track_stats=True)
    _, stats_b, met_b = make_dp_train_step(cfg, intr, adam_b, bg)(
        batched, densify.init_stats(batched.state.capacity, cfg.n_offsets,
                                    dev), *stack_views(views[:1]),
        [0] * DP_BATCH, phase=0, track_stats=True)
    loss_1, loss_b = float(met_1.loss), float(met_b.loss)
    leaf_err = {name: max_abs(b.detach(), a.detach())
                for (name, _, a), (_, _, b) in zip(adam_1.params,
                                                   adam_b.params)}
    leaves_close = all(torch.allclose(b.detach(), a.detach(), atol=1e-5,
                                      rtol=1e-4)
                       for (_, _, a), (_, _, b) in zip(adam_1.params,
                                                       adam_b.params))
    checks = {
        "steps": len(records) == DP_STEPS,
        "finite": all(np.isfinite(losses)),
        "no_skipped_update": all(r["skipped"] == 0 for r in records),
        "loss_falls": float(np.mean(losses[-5:])) < float(np.mean(losses[:5])),
        "blend_backward_once_per_view":
            launches["blend_backward"] == DP_BATCH * DP_STEPS,
        "forward_kernels_once_per_forward": all(
            launches[k] == 2 * DP_BATCH * DP_STEPS for k in FORWARD_KERNELS),
        "identical_views_loss": abs(loss_b - loss_1) <= 1e-5 * abs(loss_1),
        "identical_views_leaves": leaves_close,
        "identical_views_demon": float(stats_b.anchor_demon.max())
        == float(DP_BATCH),
    }
    summary = {
        "batch": DP_BATCH, "steps": len(records), "wall_s": wall,
        "step_ms": ms, "step_ms_median": step_ms,
        "view_ms_median": step_ms and step_ms / DP_BATCH,
        "loss_first5": float(np.mean(losses[:5])),
        "loss_last5": float(np.mean(losses[-5:])),
        "launches": launches, "peak_mem_bytes": peak,
        "warnings": len(caught),
        "identical_views": {"loss_single": loss_1, "loss_batched": loss_b,
                            "worst_leaf": max(leaf_err, key=leaf_err.get),
                            "worst_leaf_max_abs_err": max(leaf_err.values()),
                            "anchor_demon_max":
                                float(stats_b.anchor_demon.max())},
        "checks": checks}
    return summary, all(checks.values())


def fit_phase(workdir: str, counters: dict):
    """``examples.fit_single_view.fit(steps=FIT_STEPS)`` on the card with
    the host loop and with the device loop (its printing sent to a log in
    ``workdir``), every launch counter set to 0 just before each and read
    just after: the same last loss bit for bit, the render improved by
    both, the wall seconds of both and the device ms a replayed step.
    Then K3, K4, K1 and K2 against their plain versions on the inputs of
    one training step of the host loop's trained trainer, at this path's
    own shapes (128 x 128, 2,048 slots a tile, the shell at voxel 0.08)."""
    from bloomscene_tpu_torch.examples import fit_single_view
    from bloomscene_tpu_torch.ops.cuda import loop_launches
    from bloomscene_tpu_torch.train.loop import phase_of_step
    out, trained = {}, None
    for loop in (False, True):
        name = "device_loop" if loop else "host_loop"
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with open(os.path.join(workdir, f"fit_{name}.log"), "w") as log, \
                contextlib.redirect_stdout(log):
            r = fit_single_view.fit(steps=FIT_STEPS, device="cuda",
                                    device_loop=loop)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: fn.launches for k, fn in counters.items()}
        trainer, views = r.pop("trainer"), r.pop("views")
        if not loop:
            trained = (trainer, views)
        replays = sum(g["replays"] for g in r["graphs"])
        out[name] = {"wall_s": wall, "train_s": r["train_s"],
                     **{k: r[k] for k in ("loss_first", "loss_last",
                                          "l1_before", "l1_after")},
                     "captures": len(r["graphs"]), "replays": replays,
                     "replay_ms": (sum(g["replay_ms"] for g in r["graphs"])
                                   / replays if replays else None),
                     "launches": loop_launches(counts, r["graphs"])}
    h, d = out["host_loop"], out["device_loop"]
    checks = {
        "loss_last_bitwise_equal": d["loss_last"] == h["loss_last"],
        "render_improves": all(v["l1_after"] < v["l1_before"]
                               for v in out.values()),
        "captured": d["captures"] > 0,
        "launches_as_host_loop": same_launches(d["launches"],
                                               h["launches"]),
    }
    trainer, views = trained
    k2_row, k2_ok, fwd_rows, fwd_ok = train_kernel_checks(
        trainer, trainer.cfg, views,
        phase=phase_of_step(trainer.step, trainer.cfg))
    checks.update({f"{name} (fit step)": good
                   for name, good in fwd_ok.items()})
    checks["blend_backward (fit step)"] = k2_ok
    return {**out, "steps": FIT_STEPS, "checks": checks}, \
        all(checks.values()), fwd_rows, k2_row



# --- phases 26-30: the parallel layer ------------------------------------

def bits(t: torch.Tensor) -> torch.Tensor:
    """A float32 tensor's bits (a zero's sign counts), else the tensor."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def bit_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(bits(a), bits(b))


def digest(tensors) -> str:
    """sha256 of the tensors' bytes, in order: two ranks' states compare by
    it bit for bit without moving them."""
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def strip_check(slab, counts_p, perm, tile: int, gx: int, u=None,
                plain_times: bool = False):
    """K1 and K2 on the positions' two halves [0, T/2) and [T/2, T) against
    the full call's columns, bit for bit; the full call against its plain
    version (K1 bitwise, K2 within the magnitude tolerance: with ``u``, a
    training step's cotangent planes, scaled to a per-pixel scale as in
    phase 8; else seeded per-pixel planes as in phase 18); the times of
    the full call and of each strip; with ``plain_times`` the strip's
    plain versions' too and the strip's kernel-line entries."""
    from bloomscene_tpu_torch.ops.cuda.blend import (blend_backward,
                                                     blend_backward_plain,
                                                     blend_forward,
                                                     blend_forward_plain)
    T = counts_p.numel()
    strips = ((0, T // 2), (T // 2, T - T // 2))
    args = (slab, counts_p, perm, tile, gx)
    full = blend_forward(*args)
    plain = blend_forward_plain(*args)
    k1_plain = all(bit_equal(a, b) for a, b in zip(full, plain))
    k1_strips = all(bit_equal(a, b[:, p0:p0 + n])
                    for p0, n in strips
                    for a, b in zip(blend_forward(*args, p0, n), full))
    if u is None:
        rng = np.random.default_rng(SEED + 8)
        u = [torch.from_numpy(rng.normal(size=full[5].shape).astype(
            np.float32)).to(slab.device) for _ in range(6)]
    bargs = (*args, full[5], full[6], *u)
    got = blend_backward(*bargs)
    want = blend_backward_plain(*bargs)
    tol = GRAD_ATOL + GRAD_RTOL * blend_backward_plain(*bargs,
                                                       magnitude=True)
    k2_plain = bool(((got - want).abs() <= tol).all())
    k2_strips = all(bit_equal(blend_backward(*bargs, p0=p0, n=n),
                              got[..., p0:p0 + n]) for p0, n in strips)
    cap = slab.shape[1]
    out = {"positions": T, "strips": [list(x) for x in strips],
           "k1_bitwise_plain": k1_plain, "k1_strips_bitwise": k1_strips,
           "k2_within_tolerance": k2_plain, "k2_strips_bitwise": k2_strips,
           "k1_max_abs_err": max(max_abs(a, b) for a, b in zip(full, plain)),
           "k2_max_abs_err": max_abs(got, want),
           "k1_ms": time_ms(lambda: blend_forward(*args), 50),
           "k1_strip_ms": [time_ms(lambda: blend_forward(*args, p0, n), 50)
                           for p0, n in strips],
           "k2_ms": time_ms(lambda: blend_backward(*bargs), 20),
           "k2_strip_ms": [time_ms(lambda: blend_backward(*bargs, p0=p0,
                                                           n=n), 20)
                           for p0, n in strips]}
    ok = k1_plain and k1_strips and k2_plain and k2_strips
    if not plain_times:
        return out, ok
    p0, n = strips[0]
    ncon = full[6][:, p0:p0 + n]
    k1_b, k1_by = k1_bound(counts_p[p0:p0 + n], ncon, tile)
    k2_b, k2_by = k2_bound(counts_p[p0:p0 + n], ncon, tile, cap)
    shape = {"positions": n, "of": T, "p0": p0, "slab": list(slab.shape)}
    k1_entry = dict(
        max_abs_err=out["k1_max_abs_err"], ms=out["k1_strip_ms"][0],
        plain_ms=time_ms(lambda: blend_forward_plain(*args, p0, n), 1),
        bound_ms=k1_b, bound_by=k1_by, library_ms=None, shapes=shape)
    k2_entry = dict(
        max_abs_err=out["k2_max_abs_err"], ms=out["k2_strip_ms"][0],
        plain_ms=time_ms(lambda: blend_backward_plain(*bargs, p0=p0, n=n), 1),
        bound_ms=k2_b, bound_by=k2_by, library_ms=None, shapes=shape)
    return out, ok, k1_entry, k2_entry


def strip_phase(model, cam, cfg, trainer, cfg_t, views):
    """Phase 26: ``strip_check`` on one 512x512 orbit frame's bins (the
    untrained scene, eval mode, as phase 18 renders it) and on one phase-0
    training step's (phase 7's trainer, as phase 8), at STRIP_TILES; a tile
    above 32 binned with TILE_CAPACITY slots. At tile 16 the inputs are
    those of phases 4 and 8, whose full-call times this phase's repeat in
    the same run."""
    import dataclasses
    from bloomscene_tpu_torch.models.render import prefilter_anchors, render
    from bloomscene_tpu_torch.ops.tiles import tile_grid
    intr = cam.intrinsics
    arrs = cam.device_arrays(model.state.device)
    vis = prefilter_anchors(model, intr, arrs)
    out, ok, entries = {}, True, {}
    for tile in STRIP_TILES:
        cap = TILE_CAPACITY.get(tile, cfg.max_splats_per_tile)
        gx, _ = tile_grid(intr.width, intr.height, tile)
        c = dataclasses.replace(cfg, tile_size=tile, max_splats_per_tile=cap)
        res = render(model, intr, arrs, c, mode="eval", visible=vis,
                     pair_capacity=1 << 21, packed_capacity=1 << 21)
        b = res.bins
        counts_p = b.counts[b.perm.long()].contiguous()
        got = strip_check(b.slab, counts_p, b.perm, tile, gx,
                          plain_times=tile == 16)
        if tile == 16:
            got, good, entries["k1_render"], entries["k2_render"] = got
        else:
            got, good = got
        out[f"render_frame_tile{tile}"] = got
        ok = ok and good
        c_t = dataclasses.replace(cfg_t, tile_size=tile,
                                  max_splats_per_tile=TILE_CAPACITY.get(
                                      tile, cfg_t.max_splats_per_tile))
        res_t, counts_t, gx, _, _, u = train_blend_inputs(trainer, c_t, views)
        bt = res_t.bins
        scale = float(intr.width * intr.height * 3)
        got = strip_check(bt.slab, counts_t, bt.perm, tile, gx,
                          [x * scale for x in u], plain_times=tile == 16)
        if tile == 16:
            got, good, entries["k1_train"], entries["k2_train"] = got
        else:
            got, good = got
        out[f"train_step_tile{tile}"] = got
        ok = ok and good
    return out, ok, entries


def start_model(fresh):
    """The perturbed start every training phase of 27-29 takes."""
    from bloomscene_tpu_torch.convert import model_to
    return perturbed(model_to(fresh, fresh.state.device), SEED)


def device_views(cams, frames, depths, dev):
    return [(c.device_arrays(dev), torch.as_tensor(f, device=dev),
             torch.as_tensor(d, device=dev))
            for c, f, d in zip(cams, frames, depths)]


def ring_scene(n: int, size: int, device):
    """Phase 30's scene: tests/test_ring.py's draws (opacity 0.05-0.35,
    scales 0.01-0.08) at ``n`` Gaussians, projected at size x size, with
    the loss's targets."""
    from bloomscene_tpu_torch.ops import graphics, projection
    dev = torch.device(device)
    rng = np.random.default_rng(SEED + 9)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    means = np.stack([rng.uniform(-1.2, 1.2, n), rng.uniform(-1.2, 1.2, n),
                      rng.uniform(0.8, 6.0, n)], -1)
    scales = rng.uniform(0.01, 0.08, (n, 3))
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    view = graphics.world_to_view(np.eye(3), np.zeros(3))
    full = graphics.projection_matrix(0.01, 100.0, 1.0, 1.0) @ view
    f = graphics.fov2focal(1.0, size)
    proj = projection.project_gaussians(
        t(means), projection.build_cov3d(t(scales), t(quats)), t(view),
        t(full), size, size, f, f, float(np.tan(0.5)), float(np.tan(0.5)))
    return dict(proj=proj, colors=t(rng.uniform(0, 1, (n, 3))),
                opac=t(rng.uniform(0.05, 0.35, n)), bg=t([0.1, 0.2, 0.3]),
                tgt_c=t(rng.uniform(0, 1, (size, size, 3))),
                tgt_d=t(rng.uniform(0, 5, (size, size))))


def ring_loss_grads(scene, raster):
    """test_ring.py's loss through ``raster(proj, colors, opac, bg)`` ->
    (color, depth, final_T or None, loss, gradients for mean2d, conic,
    colors and opacities)."""
    from bloomscene_tpu_torch.ops.projection import ProjectedSplats
    p = scene["proj"]
    leaves = [x.detach().clone().requires_grad_(True)
              for x in (p.mean2d, p.conic, scene["colors"], scene["opac"])]
    proj = ProjectedSplats(mean2d=leaves[0], depth=p.depth, conic=leaves[1],
                           radius=p.radius, valid=p.valid)
    color, depth, final_T = raster(proj, leaves[2], leaves[3], scene["bg"])
    loss = (torch.mean((color - scene["tgt_c"]) ** 2)
            + 0.3 * torch.mean((depth - scene["tgt_d"]) ** 2))
    grads = torch.autograd.grad(loss, leaves)
    return (color.detach(), depth.detach(), final_T, loss.detach(),
            [g.detach() for g in grads])


def trainer_digest(tr) -> dict:
    """Digests of a trainer's state: leaves, Adam's moments, the
    statistics and the generators."""
    return {"leaves": digest(tr._leaves()),
            "adam": digest([*tr.optimizer.m, *tr.optimizer.v]),
            "count": tr.optimizer.count,
            "stats": digest(tr.stats),
            "noise_gen": digest([tr.noise_gen.get_state()]),
            "rng": json.dumps(tr.rng.bit_generator.state),
            "densify_rng": json.dumps(tr.densify_rng.bit_generator.state)}


def counted(fn, counters: dict):
    """fn() with every launch counter set to 0 just before and read just
    after -> (result, launches)."""
    for c in counters.values():
        c.launches = 0
    result = fn()
    return result, {k: c.launches for k, c in counters.items()}


def synced_ms(fn, reps: int) -> float:
    """Median wall ms of ``reps`` calls, each ending synchronized."""
    dev = torch.cuda.is_available()
    ts = []
    for _ in range(reps):
        if dev:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if dev:
            torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def tile_parallel_run(job: dict, mesh):
    """Phase 27's work on one rank (``mesh`` a (1, S) mesh) or, with mesh
    None, in one process: ``make_tile_parallel_render`` (or ``render``) of
    the first orbit frame in eval and train mode, and one phase-0
    ``make_tile_parallel_train_step`` (or ``make_train_step``) on the first
    view from the perturbed start; each counted, then timed."""
    from bloomscene_tpu_torch.config import GSConfig
    from bloomscene_tpu_torch.convert import model_to
    from bloomscene_tpu_torch.models.render import render
    from bloomscene_tpu_torch.ops.cuda import wrappers
    from bloomscene_tpu_torch.parallel.sharded import (
        make_tile_parallel_render, make_tile_parallel_train_step)
    from bloomscene_tpu_torch.train.loop import make_train_step
    from bloomscene_tpu_torch.train.optim import Adam, make_trainable
    dev = torch.device(job["device"])
    counters = wrappers()
    cfg, cfg_t = GSConfig(**job["cfg"]), GSConfig(**job["cfg_t"])
    cam = job["cams"][0]
    intr, arrs = cam.intrinsics, cam.device_arrays(dev)
    model = model_to(job["model"], dev)
    out = {}
    for mode in ("eval", "train"):
        if mesh is None:
            def fn(mode=mode):
                with torch.no_grad():
                    return render(model, intr, arrs, cfg, mode=mode).out
        else:
            r1 = make_tile_parallel_render(cfg, intr, mesh, mode=mode)

            def fn(r1=r1):
                with torch.no_grad():
                    return r1(model, arrs)
        o, launches = counted(fn, counters)
        out[mode] = {"color": o.color.cpu(), "depth": o.depth.cpu(),
                     "launches": launches,
                     "ms": synced_ms(fn, PARALLEL_REPS)}
    bg = torch.zeros(3, device=dev)
    trained = make_trainable(model_to(job["start"], dev))
    adam = Adam(cfg_t, 1.0, trained)
    if mesh is None:
        single = make_train_step(cfg_t, intr, adam, bg)

        def step():
            return single(trained, None, *job_view(job, dev), phase=0,
                          track_stats=False)[2].loss
    else:
        sharded = make_tile_parallel_train_step(cfg_t, intr, adam, bg, mesh)

        def step():
            return sharded(trained, *job_view(job, dev))[1]
    loss, launches = counted(step, counters)
    out["step"] = {"loss": float(loss), "loss_bits": digest([loss]),
                   "leaves": digest([t for _, _, t in adam.params]),
                   "launches": launches,
                   "ms": synced_ms(step, PARALLEL_REPS)}
    return out


def job_view(job: dict, dev):
    """The first orbit view on ``dev``: camera arrays, frame, depth."""
    return (job["cams"][0].device_arrays(dev),
            torch.as_tensor(job["frames"][0], device=dev),
            torch.as_tensor(job["depths"][0], device=dev))


def dp_mesh_run(job: dict, mesh, iterations: int):
    """Phase 28's (and 29's) trainer: ``Trainer(dp_batch=MESH_BATCH)`` on
    ``mesh`` (None: one process) at MESH_SCHEDULE over the orbit views,
    from the perturbed start, for ``iterations`` steps (``timed_run``)."""
    from bloomscene_tpu_torch.config import GSConfig
    from bloomscene_tpu_torch.convert import model_to
    from bloomscene_tpu_torch.ops.cuda import wrappers
    from bloomscene_tpu_torch.train.loop import Trainer
    dev = torch.device(job["device"])
    cfg = GSConfig(**MESH_SCHEDULE)
    views = device_views(job["cams"], job["frames"], job["depths"], dev)
    tr = Trainer(model_to(job["start"], dev), cfg, job["cams"][0].intrinsics,
                 job["voxel"], seed=SEED, device=job["device"],
                 dp_batch=MESH_BATCH, mesh=mesh)
    records, ms, launches, wall, peak, caught = timed_run(
        tr, views, iterations, wrappers())
    return {"history": [{k: v for k, v in r.items() if k != "densify_time_s"}
                        for r in records],
            "ms": ms, "launches": launches, "wall_s": wall,
            "peak_mem_bytes": peak, "warnings": len(caught),
            "alive": digest([tr.model.state.alive]),
            "n_alive": int(tr.model.state.alive.sum()),
            "capacity": tr.model.state.capacity,
            "state": trainer_digest(tr)}


def timed_once(fn):
    """(fn(), wall ms of that call, synchronized before and after)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def ring_run(job: dict, group):
    """Phase 30 on one rank of the ring: ``ring_render`` of the ring scene,
    forward and backward, and the wall ms of that call and of one forward
    alone (each synchronized; a forward is ~70K launches, so one run
    suffices)."""
    from bloomscene_tpu_torch.parallel.ring import ring_render
    scene = ring_scene(RING_SPLATS, RING_SIZE, job["device"])

    def ring(p, c, o, b):
        return (*ring_render(p, c, o, b, RING_SIZE, RING_SIZE, group), None)
    (color, depth, _, loss, grads), fb_ms = timed_once(
        lambda: ring_loss_grads(scene, ring))
    _, fwd_ms = timed_once(lambda: ring(scene["proj"], scene["colors"],
                                        scene["opac"], scene["bg"]))
    return {"color": color.cpu(), "depth": depth.cpu(), "loss": float(loss),
            "grads": [g.cpu() for g in grads], "forward_ms": fwd_ms,
            "forward_backward_ms": fb_ms}


def parallel_rank(rank: int, world: int, store: str, workdir: str):
    """One of the RANKS gloo ranks sharing the card (phases 27, 28 and 30;
    spawned by ``parallel.launch.spawn``): the (1, RANKS) mesh's
    tile-parallel render and step, the (RANKS, 1) mesh's trainer, the
    ring, each with the launch counters set to 0 just before and read
    just after; the results into ``workdir``/rank<r>.pt."""
    from bloomscene_tpu_torch.parallel.mesh import init_distributed, make_mesh
    init_distributed("gloo", f"file://{store}", world, rank, device="cuda")
    job = torch.load(os.path.join(workdir, "job.pt"), weights_only=False)
    out = {"tile_parallel": tile_parallel_run(job, make_mesh(1, world))}
    out["dp_mesh"] = dp_mesh_run(job, make_mesh(world, 1),
                                 MESH_SCHEDULE["iterations"])
    out["ring"] = ring_run(job, make_mesh(1, world).axis("tile"))
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))


def nccl_rank(rank: int, world: int, store: str, workdir: str):
    """Phase 29 in a process of its own: NCCL at world size 1 (joined
    directly: ``init_distributed`` is a no-op at world size 1, as JAX's),
    ``Trainer(mesh=(1, 1), dp_batch=MESH_BATCH)`` for NCCL_STEPS steps,
    then ``Trainer(dp_batch=MESH_BATCH)`` from the same start."""
    import torch.distributed as dist
    from bloomscene_tpu_torch.parallel.mesh import make_mesh
    dist.init_process_group("nccl", init_method=f"file://{store}",
                            world_size=world, rank=rank)
    job = torch.load(os.path.join(workdir, "job.pt"), weights_only=False)
    mesh = make_mesh(1, 1)
    out = {"backend": dist.get_backend(mesh.axis("data").group),
           "mesh": dp_mesh_run(job, mesh, NCCL_STEPS),
           "single": dp_mesh_run(job, None, NCCL_STEPS)}
    dist.destroy_process_group()
    torch.save(out, os.path.join(workdir, "nccl.pt"))


def parallel_job(workdir: str, fresh, cams, frames, depths, voxel: float,
                 device: str = "cuda") -> dict:
    """What the ranks load: the scene (its CPU copy, built once), the
    perturbed start, the orbit's cameras, frames and depths, the configs."""
    from bloomscene_tpu_torch.convert import model_to
    job = {"model": model_to(fresh, "cpu"),
           "start": model_to(start_model(fresh), "cpu"),
           "cams": list(cams), "frames": np.asarray(frames),
           "depths": np.asarray(depths), "voxel": voxel,
           "cfg": dict(voxel_size=0.03),
           "cfg_t": dict(voxel_size=0.03, use_dpr=True, start_stat=0),
           "device": device}
    os.makedirs(workdir, exist_ok=True)
    torch.save(job, os.path.join(workdir, "job.pt"))
    return job


def parallel_phases(workdir: str, job: dict):
    """Phases 27, 28 and 30: the one-process results first (the card to
    itself), then RANKS gloo ranks on the card in one spawn, joined under
    RANK_TIMEOUT (a rank that fails or hangs raises out of the script).
    Then phase 29: one NCCL rank."""
    from bloomscene_tpu_torch.ops.reference_rasterizer import (
        rasterize_reference)
    from bloomscene_tpu_torch.parallel.launch import spawn
    single = {"tile_parallel": tile_parallel_run(job, None),
              "dp_mesh": dp_mesh_run(job, None, MESH_SCHEDULE["iterations"])}
    scene = ring_scene(RING_SPLATS, RING_SIZE, job["device"])

    def reference(p, c, o, b):
        out = rasterize_reference(p, c, o, b, RING_SIZE, RING_SIZE)
        return out.color, out.depth, out.final_T
    single["ring"], single["ring_backward_ms"] = timed_once(
        lambda: ring_loss_grads(scene, reference))
    _, single["ring_ms"] = timed_once(
        lambda: reference(scene["proj"], scene["colors"], scene["opac"],
                          scene["bg"]))
    for f in os.listdir(workdir):
        if f.startswith("rank") or f.startswith("store") or f == "nccl.pt":
            os.remove(os.path.join(workdir, f))
    t0 = time.perf_counter()
    spawn(parallel_rank, RANKS, (os.path.join(workdir, "store"), workdir),
          timeout=RANK_TIMEOUT)
    ranks_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                        weights_only=False) for r in range(RANKS)]
    t0 = time.perf_counter()
    spawn(nccl_rank, 1, (os.path.join(workdir, "store_nccl"), workdir),
          timeout=RANK_TIMEOUT)
    nccl_s = time.perf_counter() - t0
    nccl = torch.load(os.path.join(workdir, "nccl.pt"), weights_only=False)
    return (tile_parallel_summary(single, ranks),
            dp_mesh_summary(single, ranks, ranks_s),
            nccl_summary(nccl, nccl_s), ring_summary(single, ranks))


def median_ms(ms: list):
    """The median step ms after the first (None on the CPU)."""
    return float(np.median(ms[1:])) if ms[0] is not None else None


def tile_parallel_summary(single: dict, ranks: list):
    s = single["tile_parallel"]
    per = [r["tile_parallel"] for r in ranks]
    checks = {}
    for mode in ("eval", "train"):
        checks[f"{mode}_bitwise"] = all(
            bit_equal(p[mode]["color"], s[mode]["color"])
            and bit_equal(p[mode]["depth"], s[mode]["depth"]) for p in per)
        # each rank's K1 once a frame (on its strip), nothing backward
        checks[f"{mode}_launches"] = all(
            p[mode]["launches"]["blend_forward"] == 1
            and p[mode]["launches"]["blend_backward"] == 0 for p in per)
        checks[f"{mode}_finite"] = bool(
            torch.isfinite(s[mode]["color"]).all())
    checks["step_loss_bitwise"] = all(
        p["step"]["loss_bits"] == s["step"]["loss_bits"] for p in per)
    checks["step_leaves_bitwise"] = all(
        p["step"]["leaves"] == s["step"]["leaves"] for p in per)
    # remat: the forward twice, K2 once
    checks["step_launches"] = all(
        p["step"]["launches"]["blend_forward"] == 2
        and p["step"]["launches"]["blend_backward"] == 1 for p in per)
    launches = {k: sum(p[m]["launches"][k] for p in per
                       for m in ("eval", "train", "step"))
                for k in s["step"]["launches"]}
    summary = {
        "ranks": len(per), "backend": "gloo", "mesh": [1, len(per)],
        "positions_per_rank": 1024 // len(per),
        "frame_ms": {m: [p[m]["ms"] for p in per] for m in ("eval", "train")},
        "frame_ms_single": {m: s[m]["ms"] for m in ("eval", "train")},
        "step_ms": [p["step"]["ms"] for p in per],
        "step_ms_single": s["step"]["ms"],
        "loss": s["step"]["loss"], "launches": launches,
        "rank_launches": [{m: p[m]["launches"] for m in ("eval", "train",
                                                         "step")}
                          for p in per],
        "checks": checks}
    return summary, all(checks.values())


def dp_mesh_summary(single: dict, ranks: list, ranks_s: float):
    s = single["dp_mesh"]
    per = [r["dp_mesh"] for r in ranks]
    h0, hs = per[0]["history"], s["history"]
    n = MESH_SCHEDULE["iterations"]
    views = MESH_BATCH // len(per)
    p2 = [i for i in range(1, n + 1) if i > MESH_SCHEDULE["context_from_step"]]
    dens = [r["iteration"] for r in h0 if "densify_n_alive" in r]
    checks = {
        "steps": len(h0) == len(hs) == n,
        "loss_within": all(np.isclose(a["loss"], b["loss"], **MESH_LOSS_TOL)
                           for a, b in zip(h0, hs)),
        "psnr_within": all(np.isclose(a["psnr"], b["psnr"],
                                      rtol=MESH_PSNR_RTOL, atol=0)
                           for a, b in zip(h0, hs)),
        "finite": all(np.isfinite(r["loss"]) for r in h0),
        "no_skipped_update": all(r["skipped"] == 0 for r in h0),
        "one_surgery": dens == [r["iteration"] for r in hs
                                if "densify_n_alive" in r]
        and len(dens) == 1,
        "same_anchors_alive": all(p["alive"] == s["alive"] for p in per),
        "ranks_bitwise_equal": all(p["state"] == per[0]["state"]
                                   and p["history"] == h0 for p in per),
        "blend_backward_once_a_view": all(
            p["launches"]["blend_backward"] == views * n for p in per),
        "hashgrid_bwd_4_a_phase2_view": all(
            p["launches"]["hashgrid_bwd"] == 4 * views * len(p2)
            for p in per),
    }
    step_ms = [median_ms(p["ms"]) for p in per]
    single_ms = median_ms(s["ms"])
    launches = {k: sum(p["launches"][k] for p in per)
                for k in per[0]["launches"]}
    summary = {
        "ranks": len(per), "backend": "gloo", "mesh": [len(per), 1],
        "batch": MESH_BATCH, "views_per_rank": views, "steps": n,
        "phase2_steps": len(p2), "densify_at": dens,
        "loss_first": h0[0]["loss"], "loss_last": h0[-1]["loss"],
        "loss_single_last": hs[-1]["loss"],
        "max_loss_rel_diff": max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                                 for a, b in zip(h0, hs)),
        "n_alive": per[0]["n_alive"], "capacity": per[0]["capacity"],
        # both steps sum the views' gradients in view order
        "bitwise_one_process": all(p["state"] == s["state"]
                                   and p["history"] == hs for p in per),
        "step_ms": [p["ms"] for p in per],
        "step_ms_median": step_ms,
        "view_ms_median": [m and m / views for m in step_ms],
        "step_ms_single": s["ms"],
        "step_ms_single_median": single_ms,
        "view_ms_single_median": single_ms and single_ms / MESH_BATCH,
        "wall_s": [p["wall_s"] for p in per], "wall_s_single": s["wall_s"],
        "spawn_s": ranks_s, "peak_mem_bytes": [p["peak_mem_bytes"]
                                              for p in per],
        "launches": launches, "rank_launches": [p["launches"] for p in per],
        "checks": checks}
    return summary, all(checks.values())


def nccl_summary(nccl: dict, seconds: float):
    m, s = nccl["mesh"], nccl["single"]
    checks = {
        "backend_nccl": nccl["backend"] == "nccl",
        "states_bitwise": m["state"] == s["state"],
        "records_bitwise": m["history"] == s["history"],
        "steps": len(m["history"]) == NCCL_STEPS,
        "blend_backward_once_a_view":
            m["launches"]["blend_backward"] == MESH_BATCH * NCCL_STEPS}
    return {"backend": nccl["backend"], "mesh": [1, 1], "batch": MESH_BATCH,
            "steps": NCCL_STEPS, "loss": [r["loss"] for r in m["history"]],
            "step_ms": m["ms"], "step_ms_single": s["ms"],
            "spawn_s": seconds, "launches": m["launches"],
            "checks": checks}, all(checks.values())


def ring_summary(single: dict, ranks: list):
    color, depth, final_T, loss, grads = single["ring"]
    per = [r["ring"] for r in ranks]
    first = per[0]
    (c_atol, c_rtol), (d_atol, d_rtol) = RING_TOL["color"], RING_TOL["depth"]
    errs = {nm: max_abs(a, b.cpu()) for nm, a, b in zip(
        ("mean2d", "conic", "colors", "opac"), first["grads"], grads)}
    checks = {
        "precondition_min_final_T": float(final_T.detach().min()) > 2e-4,
        "color_within": bool(torch.allclose(first["color"], color.cpu(),
                                            atol=c_atol, rtol=c_rtol)),
        "depth_within": bool(torch.allclose(first["depth"], depth.cpu(),
                                            atol=d_atol, rtol=d_rtol)),
        "grads_within": all(bool(torch.allclose(
            a, b.cpu(), atol=RING_GRAD_ATOL * float(b.abs().max()),
            rtol=RING_GRAD_RTOL)) for a, b in zip(first["grads"], grads)),
        "grads_finite": all(bool(torch.isfinite(a).all())
                            for a in first["grads"]),
        "ranks_equal": all(bit_equal(p["color"], first["color"])
                           and all(bit_equal(a, b) for a, b in
                                   zip(p["grads"], first["grads"]))
                           for p in per)}
    return {"ranks": len(per), "backend": "gloo", "splats": RING_SPLATS,
            "size": RING_SIZE, "min_final_T": float(final_T.detach().min()),
            "color_max_abs_err": max_abs(first["color"], color.cpu()),
            "depth_max_abs_err": max_abs(first["depth"], depth.cpu()),
            "loss": first["loss"], "loss_reference": float(loss),
            "grad_max_abs_err": errs,
            "forward_ms": [p["forward_ms"] for p in per],
            "forward_backward_ms": [p["forward_backward_ms"] for p in per],
            "reference_ms": single["ring_ms"],
            "reference_forward_backward_ms": single["ring_backward_ms"],
            "checks": checks}, all(checks.values())


def fullscale_short_phase(workdir: str, counters: dict, card: str):
    """``run_fullscale.run`` as ``python -m
    bloomscene_tpu_torch.run_fullscale`` runs it, at FULLSCALE_ARGS with FULLSCALE_CUT's step numbers, into a
    fresh ``workdir``, its printing sent to main.log there, with every
    counter set to 0 just before and read just after (each graph's
    launches counted once a replay): every step in the device loop through
    phases 0-2 and both surgeries, every loss finite, no splat dropped by
    any step or by the orbit's or the training views' frames, the re-encode
    byte-exact, every output file there, no chunk's peak memory grown past
    the first of its kind, every capture holding the step's kernels, and
    the kernels launched as the steps and frames ask (the record's own
    count the same)."""
    from bloomscene_tpu_torch import run_fullscale
    from bloomscene_tpu_torch.ops.cuda import loop_launches
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    args = run_fullscale.build_parser().parse_args([
        *FULLSCALE_ARGS, "--save_dir", workdir,
        "--out", os.path.join(workdir, "record.json")])
    cfg = dataclasses.replace(run_fullscale.config(args), **FULLSCALE_CUT)
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with open(os.path.join(workdir, "main.log"), "w") as log, \
            contextlib.redirect_stdout(log):
        rec, bs = run_fullscale.run(args, cfg, log_every=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tr = bs.trainer
    launches = loop_launches({n: fn.launches for n, fn in counters.items()},
                             tr.graph_log)
    steps = args.iterations
    losses = [r["loss"] for r in bs.logs]
    orbit = bs.scene.preset_cameras["rotate360"]
    evals = bs.scene.eval_cameras or bs.scene.train_cameras
    overflow = {"training": overflow_summary(bs.logs),
                "orbit": frame_overflow(bs.decoded_model, orbit, cfg,
                                        "decoded")}
    frames = (rec["video"]["n_frames"] + len(evals)
              + rec["trainview_psnr_50view_mean"]["n_views"])
    p2 = sum(c["last"] - c["first"] + 1 for c in tr.chunk_log
             if c["phase"] == 2)

    def there(f):
        return os.path.exists(os.path.join(workdir, f))
    missing = [f for f in FULLSCALE_FILES if not there(f)]
    missing += [v for v in ("rotate360", "rotate360_depth")
                if not (there(v + ".mp4") or there(v + "/0000.png"))]
    missing += [f"eval_renders/{i:03d}.png" for i in range(len(evals))
                if not there(f"eval_renders/{i:03d}.png")]
    checks = {
        "steps": tr.step == steps == len(losses),
        "device_loop_phases": sorted({c["phase"] for c in tr.chunk_log})
        == [0, 1, 2],
        "surgeries": [c["last"] for c in tr.chunk_log if c["surgery"]]
        == [20, 40],
        "finite": all(np.isfinite(losses)),
        "reencode_bit_exact": rec["reencode_bit_exact"] is True,
        "no_splat_dropped": all(o["records_with_overflow"] == 0
                                for o in overflow.values())
        and rec["quality"]["trainview_frames_with_overflow"] == 0,
        "files": not missing,
        "memory_flat": not any(v["grows"]
                               for v in rec["memory_growth"].values()),
        "graphs_hold_the_step_kernels": graph_checks(tr.graph_log, 2),
        "blend_backward_once_per_step": launches["blend_backward"] == steps,
        "forward_kernels_per_forward_and_frame": all(
            launches[k] == 2 * steps + frames for k in FORWARD_KERNELS),
        "hashgrid_bwd_four_per_phase2_step":
            launches["hashgrid_bwd"] == 4 * p2,
        "hashgrid_encode_bwd_once_per_phase2_step":
            launches["hashgrid_encode_bwd"] == p2,
        "record_launches": rec["launches"] == launches,
    }
    out = {
        "card": card, "argv": list(FULLSCALE_ARGS),
        "cut": FULLSCALE_CUT, "wall_s": wall,
        "pcd_points": rec["pcd_points"],
        "n_train_views": rec["n_train_views"],
        "anchors": rec["final_anchors"],
        "capacity": rec["anchor_capacity_bucket"],
        "stages": {k: v["total_s"] for k, v in rec["stages"].items()},
        "step_ms_by_phase": rec["step_ms_by_phase"],
        "chunks": len(tr.chunk_log), "captures": len(tr.graph_log),
        "capture_s": rec["graphs"]["capture_s"],
        "eager_steps": rec["eager_steps"],
        "peak_mem_bytes": [c["peak_mem_bytes"] for c in tr.chunk_log],
        "memory_growth": rec["memory_growth"],
        "codec_total_MB": rec["codec_total_MB"],
        "reencode_check_s": rec["reencode_check_s"],
        "quality": rec["quality"], "video": rec["video"],
        "eval_fps": rec["eval_fps"],
        "trainview_psnr": rec["trainview_psnr_50view_mean"]["mean_psnr"],
        "loss_first": losses[0], "loss_last": losses[-1],
        "overflow": overflow, "launches": launches, "missing": missing,
        "checks": checks}
    return bs, out, all(checks.values())


def sorted_segment_sum(g: np.ndarray, idx: np.ndarray, C: int,
                       base: np.ndarray | None = None) -> np.ndarray:
    """numpy twin of csrc/gather_rows_bwd.cu, in float32 and in its order,
    over the leaves' columns side by side (g [V, K]; base [C, K], or None
    for zeros): the entries cut into pieces of PIECE; a row's run inside
    one piece added in entry order onto its base row; a run that crosses
    pieces added a piece at a time from 0 (each piece's fragment: slot 0
    the run that came from the piece before, slot 1 the run that goes on),
    the fragments in SHARES contiguous shares each from 0, the shares
    added in order from 0, then that total added onto the base row. Rows
    no entry names are their base rows. A fragment never written stays
    NaN."""
    from bloomscene_tpu_torch.ops.cuda.gather_rows_bwd import PIECE, SHARES
    V, K = g.shape
    g = g.astype(np.float32)
    init = (np.zeros((C, K), np.float32) if base is None
            else np.array(base, np.float32))
    out = init.copy()

    def in_order(rows, a, b, acc):
        # acc[q] + g[a[q]] + ... + g[b[q] - 1], one entry at a time
        for j in range(int((b - a).max(initial=0))):
            live = a + j < b
            acc[live] = acc[live] + g[a[live] + j]
        return acc

    n_pieces = -(-V // PIECE)
    part = np.full((n_pieces, 2, K), np.nan, np.float32)
    lo = np.arange(n_pieces) * PIECE
    hi = np.minimum(lo + PIECE, V)
    first, last = idx[lo], idx[hi - 1]
    from_prev = (lo > 0) & (idx[np.maximum(lo - 1, 0)] == first)
    to_next = (hi < V) & (idx[np.minimum(hi, V - 1)] == last)
    head_end = np.where(first == last, hi,
                        np.searchsorted(idx, first + 1, side='left'))
    head_end = np.minimum(head_end, hi)
    tail_start = np.maximum(np.searchsorted(idx, last, side='left'), lo)
    tail = to_next & ~(from_prev & (first == last))
    for slot, live, a, b in ((0, from_prev, lo, head_end),
                             (1, tail, tail_start, hi)):
        q = np.flatnonzero(live)
        part[q, slot] = in_order(q, a[q], b[q],
                                 np.zeros((q.size, K), np.float32))

    start = np.searchsorted(idx, np.arange(C + 1), side='left')
    a, b = start[:-1], start[1:]
    named = b > a
    inside = named & (a // PIECE == (b - 1) // PIECE)
    r = np.flatnonzero(inside)
    out[r] = in_order(r, a[r], b[r], init[r].copy())
    for row in np.flatnonzero(named & ~inside):
        p = a[row] // PIECE
        m = int((b[row] - 1) // PIECE - p + 1)
        frags = [part[p, 1]] + [part[p + t, 0] for t in range(1, m)]
        per = -(-m // SHARES)
        total = np.zeros(K, np.float32)
        for share in range(SHARES):
            acc = np.zeros(K, np.float32)
            for t in range(share * per, min(m, share * per + per)):
                acc = acc + frags[t]
            total = total + acc
        out[row] = init[row] + total
    return out


def crossing_runs(cot, idx, C: int, n_live: int, longest: int,
                  pads_zero: bool, bases=None) -> dict:
    """gather_rows_bwd on the card where runs that cross pieces carry
    values, which the main path's do not (the padding's are zeros, so its
    run sums to the +0 (or base) it started from):

    - nonzero_every_entry: the main path's index, widths and C with a
      seeded nonzero value on every entry, so the pad row is the sum of
      run_sums' shares;
    - row_c_minus_1_live: the main path's values on its index with the
      last live entry moved onto row C - 1, so that row's run is one live
      entry and the padding, and its value comes through run_sums.

    With ``bases`` (the statistics' tables) each case adds onto them.
    Each bitwise its numpy twin (``sorted_segment_sum``) and the same bits
    from two launches; within (terms) x 2^-24 of each row's summed
    magnitudes (the base's included) of a float64 ``index_add``, terms
    the longest run, plus one with a base (a float32 sum of that many
    terms in any order rounds within it);
    row_c_minus_1_live bitwise its plain version on the CPU where the
    padding's values are zeros."""
    from bloomscene_tpu_torch.ops.cuda.gather_rows_bwd import (
        gather_rows_bwd, gather_rows_bwd_plain)
    rng = np.random.default_rng(SEED + 13)
    V, widths = idx.shape[0], [g.shape[1] for g in cot]
    seeded = [torch.from_numpy(rng.normal(size=(V, k)).astype(np.float32))
              .to(idx.device) for k in widths]
    cases = {"nonzero_every_entry": (seeded, idx)}
    if n_live:
        moved = idx.clone()
        moved[n_live - 1] = C - 1
        cases["row_c_minus_1_live"] = (cot, moved)
    b_cpu = None if bases is None else [b.cpu() for b in bases]
    terms = longest + (0 if bases is None else 1)
    out = {}
    for case, (g, i) in cases.items():
        got = gather_rows_bwd(g, i, C, bases)
        again = gather_rows_bwd(g, i, C, bases)
        g_cpu, i_cpu = [x.cpu() for x in g], i.cpu()
        twin = np.split(sorted_segment_sum(
            torch.cat(g_cpu, 1).numpy(), i_cpu.numpy(), C,
            None if b_cpu is None else torch.cat(b_cpu, 1).numpy()),
            np.cumsum(widths)[:-1], axis=1)
        b64 = [torch.zeros((C, k), dtype=torch.float64) for k in widths] \
            if b_cpu is None else [b.double() for b in b_cpu]
        ref = gather_rows_bwd_plain([x.double() for x in g_cpu], i_cpu, C,
                                    b64)
        mag = gather_rows_bwd_plain([x.double().abs() for x in g_cpu],
                                    i_cpu, C, [b.abs() for b in b64])
        r = {"same_bits_two_launches": all(
                 bit_equal(a, b) for a, b in zip(got, again)),
             "bitwise_twin": all(bit_equal(a.cpu(), torch.from_numpy(t))
                                 for a, t in zip(got, twin)),
             "within_rounding": all(
                 bool(((a.cpu().double() - f).abs()
                       <= terms * 2.0 ** -24 * m).all())
                 for a, f, m in zip(got, ref, mag)),
             "max_abs_err_float64": max(
                 float((a.cpu().double() - f).abs().max())
                 for a, f in zip(got, ref))}
        if case == "row_c_minus_1_live" and pads_zero:
            plain = gather_rows_bwd_plain(g_cpu, i_cpu, C, b_cpu)
            r["bitwise_plain"] = all(bit_equal(a.cpu(), b)
                                     for a, b in zip(got, plain))
        out[case] = r
    return out


def compacted_grads(start, cfg, intr, view, phase: int, dense_noise):
    """One step's forward and backward (``step_gradients``, as
    ``Trainer``'s step takes them) from a trainable copy of ``start`` at
    ``cfg`` -> (each trained per-anchor leaf's gradient [C, k] by field,
    and for a compacted decode the cotangents and index the row gather's
    backward took with the count of live entries, else None). The decode's
    draws are ``dense_noise`` (over the C rows) at the rows it decodes, so
    each anchor takes the same draw whether its row is compacted or not."""
    from bloomscene_tpu_torch.convert import model_to
    from bloomscene_tpu_torch.models import anchors
    from bloomscene_tpu_torch.models.decode import DecodeNoise
    from bloomscene_tpu_torch.models.render import (compact_visible,
                                                    prefilter_anchors)
    from bloomscene_tpu_torch.train.loop import step_gradients
    from bloomscene_tpu_torch.train.optim import Adam, make_trainable
    cam, gt_image, gt_depth = view
    dev = gt_image.device
    model = make_trainable(model_to(start, dev))
    C = model.state.capacity
    adam = Adam(cfg, 1.0, model)
    noise, n_live = dense_noise, None
    if cfg.visible_capacity is not None:
        visible = prefilter_anchors(model, intr, cam)
        n_live = min(int(visible.sum()), cfg.visible_capacity)
        _, idx = compact_visible(model, visible, cfg.visible_capacity)
        safe = torch.clamp(idx, max=C - 1)
        if dense_noise is not None:
            noise = DecodeNoise(*(None if x is None else x[safe]
                                  for x in dense_noise))
    taken, original = [], anchors.gather_rows_bwd

    def record(grads, idx_, n_rows):
        taken.append(([g.clone() for g in grads], idx_.clone(), n_live))
        return original(grads, idx_, n_rows)

    anchors.gather_rows_bwd = record
    try:
        *_, grads, _ = step_gradients(
            cfg, intr, torch.zeros(3, device=dev), model,
            [p for _, _, p in adam.params], cam, gt_image, gt_depth, phase,
            noise)
    finally:
        anchors.gather_rows_bwd = original
    by_name = {n: g for (n, _, _), g in zip(adam.params, grads)}
    return ({f: by_name[f"state.{f}"].reshape(C, -1)
             for f in COMPACT_TRAINED}, taken[0] if taken else None)


def step_device_ms(start, cfg, intr, view) -> tuple:
    """Device ms of one phase-0 training step (``make_train_step``: the
    forward, backward, Adam update and statistics) on a trainable copy of
    ``start``: the kernels' device time under ``torch.profiler`` over
    COMPACT_REPS steps after one warm-up (an eager step waits for the
    host, so CUDA events around it would time the host too), summed by
    ``kernel_table`` as profile_render_torch.py's ``device_ms_per_step``
    -> (that ms, the ``train.stats`` span's device busy ms a step, the
    statistics' scatter's arguments in the warm-up step: (values, index,
    rows, bases) as ``accumulate_stats`` hands them to ``gather_rows_bwd``,
    or None for a dense step)."""
    from torch.profiler import ProfilerActivity, profile
    from bloomscene_tpu_torch.convert import model_to
    from bloomscene_tpu_torch.models import densify
    from bloomscene_tpu_torch.train.loop import make_train_step
    from bloomscene_tpu_torch.train.optim import Adam, make_trainable
    cam, gt_image, gt_depth = view
    dev = gt_image.device
    model = make_trainable(model_to(start, dev))
    adam = Adam(cfg, 1.0, model)
    step = make_train_step(cfg, intr, adam, torch.zeros(3, device=dev))
    stats = densify.init_stats(model.state.capacity, model.state.n_offsets,
                               dev)
    def run():
        step(model, stats, cam, gt_image, gt_depth, phase=0,
             track_stats=True)
    taken, original = [], densify.gather_rows_bwd

    def record(grads, idx, n_rows, bases=None):
        taken.append(([g.clone() for g in grads], idx.clone(), n_rows,
                      [b.clone() for b in bases]))
        return original(grads, idx, n_rows, bases)

    densify.gather_rows_bwd = record
    try:
        run()
    finally:
        densify.gather_rows_bwd = original
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(COMPACT_REPS):
            run()
        torch.cuda.synchronize()
    us = sum(k["device_us"] for k in kernel_table(prof))
    stats_ms = span_table(prof, COMPACT_REPS).get(
        "train.stats", {}).get("device_busy_ms")
    return us / 1e3 / COMPACT_REPS, stats_ms, (taken[0] if taken else None)


def stats_scatter(args) -> tuple:
    """The statistics' scatter of a compacted step (``step_device_ms``'s
    capture) through gather_rows_bwd against the atomic ``index_add``
    path, its plain version (the same bits where each run's entries but
    one are zeros: every real row once, the padding's values 0), twice,
    timed, with the bound and the path before this kernel (each
    statistic's ``index_add`` over ``safe`` K + k, as the JAX package's
    ``.at[flat_idx].add``) as its library time -> (the kernels line's
    ``stats_shape`` entry, checks)."""
    from bloomscene_tpu_torch.ops.cuda.gather_rows_bwd import (
        gather_rows_bwd, gather_rows_bwd_plain)
    vals, idx, C, bases = args
    got = gather_rows_bwd(vals, idx, C, bases)
    again = gather_rows_bwd(vals, idx, C, bases)
    plain = gather_rows_bwd_plain(vals, idx, C, bases)
    pads = idx == C - 1
    checks = {
        "stats_same_bits_two_launches": all(
            bit_equal(a, b) for a, b in zip(got, again)),
        "stats_bitwise_atomic_index_add": all(
            bit_equal(a, b) for a, b in zip(got, plain))}
    widths = [v.shape[1] for v in vals]
    V, K = idx.shape[0], sum(widths)
    flat = [idx[:, None] * k + torch.arange(k, device=idx.device)[None]
            for k in widths]

    def flat_index_add():
        return [b.reshape(-1).index_add(0, f.reshape(-1), v.reshape(-1))
                for b, f, v in zip(bases, flat, vals)]
    ms = time_ms(lambda: gather_rows_bwd(vals, idx, C, bases), COMPACT_REPS)
    plain_ms = time_ms(lambda: gather_rows_bwd_plain(vals, idx, C, bases),
                       COMPACT_REPS)
    lib_ms = time_ms(flat_index_add, COMPACT_REPS)
    # the index and values read once, every base row read and every
    # output row written once
    bound_ms, bound_by = bound(8 * V + 4 * V * K + 8 * C * K, V * K)
    entry = {"max_abs_err": max(max_abs(a, b) for a, b in zip(got, plain)),
             "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
             "bound_by": bound_by, "bound_share": bound_ms / ms,
             "library_ms": lib_ms,
             "library": "index_add_ of each statistic over a flat index "
                        "(atomic; the path before this kernel)",
             "shapes": {"entries": V, "rows": C, "columns": K,
                        "leaves": widths,
                        "pad_row_entries": int(pads.sum()),
                        # at most one: row C - 1's own entry, if it is live
                        "pad_row_nonzero_entries": int(torch.stack(
                            [v[pads].ne(0).any(1) for v in vals]).any(0)
                            .sum())}}
    return entry, checks


def compacted_step_phase(fresh, cams, frames, depths, voxel: float,
                         counters: dict, device: str = "cuda"):
    """Phase 32: the compacted decode at run_fullscale's visible_capacity
    (COMPACT_CAPACITY of phase 2's 139,264 rows) -> (summary, ok, the
    kernels line's row for gather_rows_bwd)."""
    from bloomscene_tpu_torch.config import GSConfig
    from bloomscene_tpu_torch.convert import model_to
    from bloomscene_tpu_torch.models import densify
    from bloomscene_tpu_torch.models.decode import draw_noise
    from bloomscene_tpu_torch.ops.cuda import build
    from bloomscene_tpu_torch.ops.cuda.gather_rows_bwd import (
        gather_rows_bwd, gather_rows_bwd_plain)
    from bloomscene_tpu_torch.train.loop import Trainer
    dev = torch.device(device)
    intr = cams[0].intrinsics
    views = device_views(cams, frames, depths, dev)
    start = perturbed(model_to(fresh, dev), SEED)
    C = start.state.capacity

    # the path: Trainer.run, host loop then device loop, every counter set
    # to 0 just before each and read just after
    cfg_l = GSConfig(**COMPACT_LOOP)
    n = cfg_l.iterations
    host = Trainer(perturbed(model_to(fresh, dev), SEED), cfg_l, intr,
                   voxel, seed=SEED, device=device)
    host_rec, _, host_launches, host_wall, _, _ = timed_run(
        host, views, n, counters)
    loop = Trainer(perturbed(model_to(fresh, dev), SEED), cfg_l, intr,
                   voxel, seed=SEED, device=device)
    loop_rec, chunks, loop_launches_, loop_wall, _, _ = device_loop_run(
        loop, views, n, counters)
    launches = {k: host_launches[k] + loop_launches_[k]
                for k in host_launches}
    diff = trainer_differences(host, loop)
    rec_diff = record_differences(host_rec, loop_rec)
    # both loops again with the statistics through the atomic index_add
    # (gather_rows_bwd's plain version), the path before the kernel: every
    # leaf, moment and statistic the same bits
    atomic = {}
    original = densify.gather_rows_bwd
    densify.gather_rows_bwd = gather_rows_bwd_plain
    try:
        for name in ("host_loop", "device_loop"):
            tr = Trainer(perturbed(model_to(fresh, dev), SEED), cfg_l, intr,
                         voxel, seed=SEED, device=device)
            if name == "host_loop":
                timed_run(tr, views, n, counters)
            else:
                device_loop_run(tr, views, n, counters)
            atomic[name] = trainer_differences(
                host if name == "host_loop" else loop, tr)
    finally:
        densify.gather_rows_bwd = original

    # a compacted step's gradients against the dense step's, phases 0, 2
    same = {}
    for phase in (0, 2):
        cfg_d = GSConfig(**COMPACT_SAME_FN)
        noise = draw_noise(C, cfg_d, phase, torch.Generator(
            device=dev).manual_seed(SEED + 11), dev)
        dense, _ = compacted_grads(start, cfg_d, intr, views[0], phase,
                                   noise)
        comp, (_, _, n_live) = compacted_grads(
            start, GSConfig(**COMPACT_SAME_FN,
                            visible_capacity=COMPACT_CAPACITY),
            intr, views[0], phase, noise)
        alive = start.state.alive
        # the row gather's backward adds a row's cotangents from +0, so a
        # -0 cotangent arrives as +0 (as with torch's own x[idx]): every
        # other bit must match
        c = {f: comp[f][alive] for f in COMPACT_TRAINED}
        d = {f: dense[f][alive] for f in COMPACT_TRAINED}
        zeros = {f: (c[f] == 0) & (d[f] == 0) for f in COMPACT_TRAINED}
        same[phase] = {
            "live_entries": n_live, "alive_rows": int(alive.sum()),
            "bit_differences": {
                f: int(((bits(c[f]) != bits(d[f])) & ~zeros[f]).sum())
                for f in COMPACT_TRAINED},
            "zero_sign_differences": {
                f: int(((bits(c[f]) != bits(d[f])) & zeros[f]).sum())
                for f in COMPACT_TRAINED}}

    # the padding's cotangents at the default config, phases 0-2
    cfg_c = GSConfig(voxel_size=0.03, use_dpr=True,
                     visible_capacity=COMPACT_CAPACITY)
    pads, taken = {}, {}
    for phase in (0, 1, 2):
        noise = draw_noise(C, cfg_c, phase, torch.Generator(
            device=dev).manual_seed(SEED + 12), dev)
        _, taken[phase] = compacted_grads(start, cfg_c, intr, views[0],
                                          phase, noise)
        cot, _, n_live = taken[phase]
        pads[phase] = {f: {"pad_entries": int(g.shape[0] - n_live),
                           "nonzero": int((g[n_live:] != 0).sum()),
                           "finite": bool(torch.isfinite(g).all())}
                       for f, g in zip(COMPACT_TRAINED, cot)}
    pads_zero = all(v["nonzero"] == 0 and v["finite"]
                    for p in pads.values() for v in p.values())

    # the kernel against its plain version on phase 0's cotangents
    cot, idx, n_live = taken[0]
    got = gather_rows_bwd(cot, idx, C)
    again = gather_rows_bwd(cot, idx, C)
    card_plain = gather_rows_bwd_plain(cot, idx, C)
    cpu_plain = gather_rows_bwd_plain([g.cpu() for g in cot], idx.cpu(), C)
    runs = torch.bincount(idx, minlength=C)
    single = runs <= 1
    longest = int(runs.max())
    kernel = {"same_bits_two_launches": all(
        bit_equal(a, b) for a, b in zip(got, again))}
    kernel["bitwise_plain_single_entry_rows"] = all(
        bit_equal(a[single].cpu(), b[single.cpu()])
        for a, b in zip(got, cpu_plain))
    # where the padding's cotangents are zeros, the pad row's sum is its
    # live entry's (or 0) in any order; else it is held within the
    # rounding of two float32 sums of its run
    kernel["pad_row"] = ("bitwise" if pads_zero else
                         f"within {longest} x 2^-24 of its summed "
                         f"magnitudes")
    if pads_zero:
        kernel["bitwise_plain"] = all(bit_equal(a.cpu(), b)
                                      for a, b in zip(got, cpu_plain))
    else:
        mags = gather_rows_bwd_plain([g.abs() for g in cot], idx, C)
        kernel["bitwise_plain"] = all(
            bool(((a - b).abs() <= longest * 2.0 ** -24 * m).all())
            for a, b, m in zip(got, card_plain, mags))
    kernel["bitwise_card_plain"] = all(bit_equal(a, b)
                                       for a, b in zip(got, card_plain))
    err = max(max_abs(a.cpu(), b) for a, b in zip(got, cpu_plain))
    widths = [g.shape[1] for g in cot]
    V, K = idx.shape[0], sum(widths)
    crossing = crossing_runs(cot, idx, C, n_live, longest, pads_zero)
    ms = time_ms(lambda: gather_rows_bwd(cot, idx, C), COMPACT_REPS)
    plain_ms = time_ms(lambda: gather_rows_bwd_plain(cot, idx, C),
                       COMPACT_REPS)
    # torch's backward of x[idx]: index_put_ with accumulate, each leaf
    lib_ms = time_ms(lambda: [torch.zeros((C, g.shape[1]), device=dev)
                              .index_put_((idx,), g, accumulate=True)
                              for g in cot], COMPACT_REPS)
    # what this card's memory gives torch's own kernels for the kernel's
    # two streams: writing the outputs (fill) and moving the padding's
    # cotangents (a copy reads and writes them)
    pad_cot = [g[n_live:] for g in cot]
    fills = [torch.empty_like(a) for a in got]
    memory_ms = {"fill_outputs": time_ms(lambda: [o.zero_() for o in fills],
                                         COMPACT_REPS),
                 "copy_padding": time_ms(lambda: [p.clone() for p in pad_cot],
                                         COMPACT_REPS),
                 "output_bytes": 4 * C * sum(g.shape[1] for g in cot),
                 "padding_bytes": 4 * sum(p.numel() for p in pad_cot)}
    # the index and cotangents read once, every row written once
    bound_ms, bound_by = bound(8 * V + 4 * V * K + 4 * C * K, V * K)
    compact_ms, compact_stats_ms, scatter = step_device_ms(
        start, cfg_c, intr, views[0])
    dense_ms, dense_stats_ms, _ = step_device_ms(
        start, GSConfig(voxel_size=0.03, use_dpr=True), intr, views[0])
    stats_entry, stats_checks = stats_scatter(scatter)
    s_vals, s_idx, _, s_bases = scatter
    crossing_stats = crossing_runs(s_vals, s_idx, C, n_live, longest,
                                   pads_zero, s_bases)
    row = dict(
        name="gather_rows_bwd", route="cuda",
        source="bloomscene_tpu_torch/csrc/gather_rows_bwd.cu",
        # no TPU kernel: the transpose of this gather, XLA's scatter-add
        replaces="bloomscene_tpu/models/anchors.py:166", max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        bound_share=bound_ms / ms, library_ms=lib_ms,
        library="torch's backward of x[idx] (index_put_, accumulate)",
        **ptxas_report(build.build_log("gather_rows_bwd")),
        shapes={"entries": V, "live_entries": n_live, "rows": C,
                "columns": K, "leaves": widths, "longest_run": longest},
        stats_shape=stats_entry)

    loop_ok = {
        "compacts": C > COMPACT_CAPACITY,
        "bitwise_equal_to_host_loop": not diff,
        "records_equal_to_host_loop": not rec_diff,
        "losses_finite": all(np.isfinite(r["loss"]) for r in loop_rec),
        # the row gather's backward and the statistics (every step is in
        # the statistics' window: start_stat 0)
        "graphs_hold_the_step_kernels": graph_checks(loop.graph_log, 2)
        and all(g["launches"]["gather_rows_bwd"] == 2
                for g in loop.graph_log),
        "launches_as_host_loop": same_launches(loop_launches_,
                                               host_launches),
        "gather_rows_bwd_twice_per_step":
            host_launches["gather_rows_bwd"] == 2 * n,
        "stats_bitwise_atomic_host_loop": not atomic["host_loop"],
        "stats_bitwise_atomic_device_loop": not atomic["device_loop"],
        "phases_0_and_2": sorted({c["phase"] for c in loop.chunk_log})
        == [0, 2]}
    checks = {
        **loop_ok,
        "gradients_bitwise_dense_at_alive_rows": all(
            not any(v["bit_differences"].values()) for v in same.values()),
        "padding_cotangents_zero": pads_zero,
        **{f"kernel_{k}": v for k, v in kernel.items()
           if k not in ("bitwise_card_plain", "pad_row")},
        **{f"crossing_{case}_{k}": v for case, r in crossing.items()
           for k, v in r.items() if k != "max_abs_err_float64"},
        **{f"crossing_stats_{case}_{k}": v
           for case, r in crossing_stats.items()
           for k, v in r.items() if k != "max_abs_err_float64"},
        **stats_checks}
    summary = {
        "capacity": C, "visible_capacity": COMPACT_CAPACITY, "steps": n,
        "host_loop_wall_s": host_wall, "device_loop_wall_s": loop_wall,
        "chunks": chunks, "graphs": loop.graph_log, "launches": launches,
        "differences": diff, "record_differences": rec_diff[:20],
        "dense_vs_compacted": same, "padding": pads, "kernel": kernel,
        "crossing_runs": crossing, "crossing_runs_stats": crossing_stats,
        "atomic_stats_differences": atomic,
        "step_device_ms": {"compacted": compact_ms, "dense": dense_ms},
        "stats_device_ms": {"compacted": compact_stats_ms,
                            "dense": dense_stats_ms},
        "stats_scatter_ms": {"gather_rows_bwd": stats_entry["ms"],
                             "index_add_": stats_entry["plain_ms"],
                             "flat_index_add_": stats_entry["library_ms"]},
        "backward_ms": {"gather_rows_bwd": ms, "index_put_accumulate": lib_ms,
                        "index_add_": plain_ms},
        "memory_reference_ms": memory_ms,
        "backward_share_of_compacted_step": ms / compact_ms,
        "checks": checks}
    return summary, all(checks.values()), row


def hashgrid_dx_magnitudes(tables, x, g, spec) -> torch.Tensor:
    """[N, 3] float64: for each entry of the hash grid's gradient to x the
    summed magnitudes of the terms whose float32 sums make it: for each
    encoder, level and corner off the ring, (R - 2) times the product of
    the weight's other factors times each feature's terms of the corner's
    ga v and of g acc / den^2 (acc expanded into its corners' w v)."""
    from bloomscene_tpu_torch.ops.hashgrid import _corner_index, mix_parts
    mag = torch.zeros(x.shape, dtype=torch.float64, device=x.device)
    col = 0
    for (_, gs, cols), emb in zip(mix_parts(spec), tables):
        xe = x[:, list(cols)]
        inb = torch.all((xe >= 0.0) & (xe <= 1.0), dim=-1)
        D, F = gs.num_dim, gs.n_features
        for li, R in enumerate(gs.resolutions):
            gl = torch.where(inb[:, None], g[:, col:col + F], 0.0)
            gl = gl.double().abs()
            col += F
            pos = xe * (R - 2) + 0.5
            pos0f = torch.floor(pos)
            frac = (pos - pos0f).double()
            pos0 = pos0f.to(torch.int64)
            corners, acc, wn = [], 0.0, 0.0
            for corner in range(2 ** D):
                fs, coords = [], []
                for d in range(D):
                    up = (corner >> d) & 1
                    fs.append(frac[:, d] if up else 1.0 - frac[:, d])
                    coords.append(torch.clamp(pos0[:, d] + up, max=R - 1)
                                  if up else pos0[:, d])
                coords = torch.stack(coords, -1)
                off = ~torch.any((coords == 0) | (coords == R - 1), dim=-1)
                cell = (_corner_index(torch.clamp(coords, 0, R - 1), R,
                                      gs.level_sizes[li], D)
                        + gs.offsets[li])
                v = emb[cell].double().abs()
                w = torch.stack(fs, -1).prod(-1) * off
                acc = acc + w[:, None] * v
                wn = wn + w
                corners.append((fs, off, v))
            den = wn + 1e-9
            q_term = (gl * acc).sum(-1) / den ** 2
            for fs, off, v in corners:
                term = ((gl * v).sum(-1) / den + q_term) * off * (R - 2)
                for d in range(D):
                    rest = torch.ones_like(term)
                    for e in range(D):
                        if e != d:
                            rest = rest * fs[e]
                    mag[:, cols[d]] += term * rest
    return mag


def hashgrid_encode_phase(model, cfg):
    """Phase 33: the hash-grid kernel on ``model``'s rows (the decode's x of
    every anchor slot, dead ones included) at the default spec -> (the
    forward's and the backward's kernel rows, ok)."""
    from bloomscene_tpu_torch.models.anchors import get_anchor_quantized
    from bloomscene_tpu_torch.models.model import mix_spec
    from bloomscene_tpu_torch.ops import hashgrid
    from bloomscene_tpu_torch.ops.cuda import build
    from bloomscene_tpu_torch.ops.cuda.hashgrid_bwd import grid_scatter
    from bloomscene_tpu_torch.ops.cuda.hashgrid_encode import (
        hashgrid_encode, hashgrid_encode_bwd, hashgrid_encode_plain)
    spec = mix_spec(cfg)
    b = model.bounds
    with torch.no_grad():
        x = ((get_anchor_quantized(model.state, b) - b.x_min)
             / (b.x_max - b.x_min)).contiguous()
        params = {k: v.detach().clone() for k, v in model.grid.items()}
        tables = hashgrid.mix_tables(params, spec)
    N, dev = x.shape[0], x.device
    gen = np.random.default_rng(SEED + 33)
    g = torch.from_numpy(gen.normal(size=(N, spec.output_dim)).astype(
        np.float32)).to(dev)
    checks = {}

    # the forward, bitwise the eager plain version, twice
    with torch.no_grad():
        out = hashgrid_encode(x, tables, spec)
        again = hashgrid_encode(x, tables, spec)
        plain = hashgrid_encode_plain(x, tables, spec)
    checks["forward_bitwise_plain"] = torch.equal(out, plain)
    checks["forward_same_bits_twice"] = torch.equal(out, again)
    checks["forward_finite"] = bool(torch.isfinite(out).all())

    # the backward: rows, indices and dx against the twin, twice
    rows, idx, dx = hashgrid_encode_bwd(x, tables, g, spec)
    rows2, idx2, dx2 = hashgrid_encode_bwd(x, tables, g, spec)
    t_rows, t_idx, t_dx = hashgrid.mix_encode_backward_plain(tables, x, g,
                                                             spec)
    checks["backward_same_bits_twice"] = (
        all(torch.equal(a, c) for a, c in zip(rows, rows2))
        and all(torch.equal(a, c) for a, c in zip(idx, idx2))
        and torch.equal(dx, dx2))
    checks["rows_idx_bitwise_twin"] = (
        all(torch.equal(a, c) for a, c in zip(rows, t_rows))
        and all(torch.equal(a, c) for a, c in zip(idx, t_idx)))
    checks["dx_bitwise_twin"] = torch.equal(dx, t_dx)

    # the eager path's autograd on the card: the rows it hands grid_scatter,
    # the table gradients and dx; then the kernel path's (mix_encode on the
    # card is _MixEncode) from the same leaves
    def leaves():
        return (x.clone().requires_grad_(True),
                {k: v.clone().requires_grad_(True) for k, v in
                 params.items()})

    def grads(fn):
        xr, ps = leaves()
        out_ = fn(ps, xr, spec)
        return torch.autograd.grad(
            out_, [xr] + [ps[k] for k in hashgrid.MIX_ENCODERS], g)

    calls, original = [], hashgrid.grid_scatter

    def record(r, i, n):
        calls.append((r.clone(), i.clone()))
        return original(r, i, n)

    hashgrid.grid_scatter = record
    try:
        eager = grads(hashgrid.mix_encode_plain)
    finally:
        hashgrid.grid_scatter = original
    # autograd reaches the encoders' gathers last to first
    eager_rows = dict(zip(reversed(hashgrid.MIX_ENCODERS), calls))
    kernel = grads(hashgrid.mix_encode)
    kernel2 = grads(hashgrid.mix_encode)
    checks["rows_idx_bitwise_eager"] = all(
        torch.equal(rows[e], eager_rows[name][0])
        and torch.equal(idx[e], eager_rows[name][1])
        for e, name in enumerate(hashgrid.MIX_ENCODERS))
    checks["table_grads_bitwise_eager"] = all(
        torch.equal(a, c) for a, c in zip(kernel[1:], eager[1:]))
    checks["step_same_bits_twice"] = all(
        torch.equal(a, c) for a, c in zip(kernel, kernel2))
    mag = hashgrid_dx_magnitudes(tables, x, g, spec)
    err = (kernel[0].double() - eager[0].double()).abs()
    checks["dx_within_tolerance"] = bool(
        (err <= HASHGRID_DX_RTOL * mag).all())
    dx_bitwise = torch.equal(kernel[0], eager[0])
    used = float((err / (HASHGRID_DX_RTOL * mag).clamp(min=1e-300)).max())

    # times, each behind hold_device (device time of calls back to back)
    scatter = [(r, i, t.shape[0]) for r, i, t in zip(rows, idx, tables)]
    with torch.no_grad():
        fwd_ms = time_ms(lambda: hashgrid_encode(x, tables, spec),
                         HASHGRID_REPS)
        fwd_plain_ms = time_ms(lambda: hashgrid_encode_plain(x, tables, spec),
                               HASHGRID_PLAIN_REPS)
    bwd_ms = time_ms(lambda: hashgrid_encode_bwd(x, tables, g, spec),
                     HASHGRID_REPS)
    scatter_ms = time_ms(lambda: [grid_scatter(*c) for c in scatter],
                         HASHGRID_REPS)
    step_ms = time_ms(lambda: grads(hashgrid.mix_encode), HASHGRID_REPS)
    plain_step_ms = time_ms(lambda: grads(hashgrid.mix_encode_plain),
                            HASHGRID_PLAIN_REPS)
    tab_bytes = sum(t.numel() * 4 for t in tables)
    n_rows = sum(r.shape[0] for r in rows)
    n_levels = spec.output_dim // spec.n_features
    # the forward reads x and the tables and writes out; the backward
    # reads x, g and the tables and writes the rows, their indices and dx;
    # operations: ~9 a dimension and level, ~3 + 2F a corner (forward),
    # ~3 times that with the backward
    corners = n_rows
    fwd_ops = corners * (3 + 2 * spec.n_features) + 9 * 3 * n_levels * N
    fwd_bound = bound(4 * N * (3 + spec.output_dim) + tab_bytes, fwd_ops)
    bwd_bound = bound(4 * N * (3 + spec.output_dim + 3) + tab_bytes
                      + n_rows * (4 * spec.n_features + 8), 3 * fwd_ops)
    card = torch.cuda.get_device_name(0)
    ptx = ptxas_report(build.build_log("hashgrid_encode"))
    shapes = {"rows": N, "levels": n_levels, "features": spec.n_features,
              "corner_rows": n_rows, "table_bytes": tab_bytes,
              # the forward's corner reads, served by L2 and L1 (not in
              # its HBM bound)
              "corner_read_bytes": n_rows * 4 * spec.n_features,
              "x_outside_unit_cube": int((~torch.all(
                  (x >= 0) & (x <= 1), dim=-1)).sum())}
    common = dict(route="cuda",
                  source="bloomscene_tpu_torch/csrc/hashgrid_encode.cu",
                  # no TPU kernel: XLA's fusion of the plain jnp encoder
                  replaces="bloomscene_tpu/ops/hashgrid.py:105",
                  library_ms=None, card=card, shapes=shapes, **ptx)
    fwd_row = dict(name="hashgrid_encode", max_abs_err=max_abs(out, plain),
                   ms=fwd_ms, plain_ms=fwd_plain_ms, bound_ms=fwd_bound[0],
                   bound_by=fwd_bound[1], bound_share=fwd_bound[0] / fwd_ms,
                   **common)
    bwd_row = dict(name="hashgrid_encode_bwd",
                   max_abs_err=max(max_abs(a, c) for a, c in
                                   zip(kernel, eager)),
                   ms=bwd_ms, plain_ms=plain_step_ms - fwd_plain_ms,
                   bound_ms=bwd_bound[0], bound_by=bwd_bound[1],
                   bound_share=bwd_bound[0] / bwd_ms,
                   hashgrid_bwd_ms=scatter_ms,
                   # _MixEncode forward and backward, the table sums
                   # included, against the eager path's forward and
                   # autograd backward
                   step_ms=step_ms, plain_step_ms=plain_step_ms,
                   dx_bitwise_eager=dx_bitwise,
                   dx_max_abs_err=max_abs(kernel[0], eager[0]),
                   dx_max_tolerance_used=used,
                   dx_rtol_of_magnitudes=HASHGRID_DX_RTOL, checks=checks,
                   **common)
    return fwd_row, bwd_row, all(checks.values())


def stamp_phase():
    """Phase 34: the stamp kernel on a ``[LOOP_CHUNK, STAMP_SLOTS]`` card
    buffer of other values, as the device loop stamps: for rows in range
    the cell at [counter, slot] alone is written, for rows outside none,
    the same cells as the plain version writes on the CPU; readings of
    stamps launched in turn never go back, and the card's time between two
    of them lies within the host's bracketing readings of them. Then its
    device time a stamp back to back and a stamp node in a replayed graph,
    and the timer's least nonzero step -> (its kernel row, ok)."""
    from bloomscene_tpu_torch.ops.cuda import build
    from bloomscene_tpu_torch.ops.cuda.stamp import stamp, stamp_plain
    from bloomscene_tpu_torch.train.loop import STAMP_SLOTS
    dev = torch.device("cuda")
    shape = (LOOP_CHUNK, STAMP_SLOTS)
    gen = torch.Generator().manual_seed(SEED + 34)
    base = torch.randint(-2 ** 40, 2 ** 40, shape, generator=gen,
                         dtype=torch.int64)

    def written(fn, device, row: int, slot: int) -> torch.Tensor:
        buf = base.clone().to(device)
        counter = torch.full((1,), row, dtype=torch.int64, device=device)
        fn(buf, counter, slot)
        return buf.cpu() != base

    checks = {}
    cases = [(3, 5), (0, 0), (LOOP_CHUNK - 1, STAMP_SLOTS - 1),
             (LOOP_CHUNK, 7), (-1, 7), (1 << 40, 0)]
    for row, slot in cases:
        want = torch.zeros(shape, dtype=torch.bool)
        if 0 <= row < LOOP_CHUNK:
            want[row, slot] = True
        got, plain = written(stamp, dev, row, slot), written(
            stamp_plain, "cpu", row, slot)
        checks[f"row_{row}_slot_{slot}"] = (torch.equal(got, want)
                                            and torch.equal(plain, want))

    # stamps in turn, each bracketed by the host's clock; the counter set
    # on the card, behind the stream
    buf = torch.zeros(shape, dtype=torch.int64, device=dev)
    counter = torch.zeros((1,), dtype=torch.int64, device=dev)
    counter.fill_(2)
    host = []
    for i in range(8):
        h0 = time.perf_counter_ns()
        stamp(buf, counter, i)
        torch.cuda.synchronize()
        host.append((h0, time.perf_counter_ns()))
        time.sleep(0.002)
    t = buf[2, :8].cpu().tolist()
    checks["never_back"] = all(b >= a for a, b in zip(t, t[1:]))
    checks["within_host_brackets"] = all(
        host[j][0] - host[i][1] <= t[j] - t[i] <= host[j][1] - host[i][0]
        for i in range(8) for j in range(i + 1, 8))
    checks["other_rows_unwritten"] = bool(
        (buf[:2] == 0).all() and (buf[3:] == 0).all()
        and (buf[2, 8:] == 0).all())

    # back to back: device time a stamp
    ms = time_ms(lambda: stamp(buf, counter, 0), STAMP_REPS)
    # a graph of stamps in a chain, as the device loop's step holds them;
    # the timer's resolution: the greatest common divisor of their steps
    line = torch.zeros((1, STAMP_SLOTS), dtype=torch.int64, device=dev)
    zero = torch.zeros((1,), dtype=torch.int64, device=dev)
    n_nodes, reps = STAMP_GRAPH
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin()
        for slot in range(n_nodes):
            stamp(line, zero, slot)
        graph.capture_end()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    node_ms = start.elapsed_time(end) / (reps * n_nodes)
    steps = np.diff(line.cpu().numpy()[0, :n_nodes])
    checks["graph_never_back"] = bool((steps >= 0).all())
    t0 = time.perf_counter()
    cpu_buf, cpu_counter = base.clone(), torch.zeros((1,), dtype=torch.int64)
    for _ in range(STAMP_REPS):
        stamp_plain(cpu_buf, cpu_counter, 0)
    plain_ms = 1e3 * (time.perf_counter() - t0) / STAMP_REPS
    b = bound(16, 0)
    row = dict(name="stamp", route="cuda",
               source="bloomscene_tpu_torch/csrc/stamp.cu",
               # no TPU kernel: the JAX package reads its step's layers
               # from the XLA profiler's trace
               replaces=None, max_abs_err=None, ms=ms, plain_ms=plain_ms,
               bound_ms=b[0], bound_by=b[1], library_ms=None,
               graph_node_ms=node_ms, graph_nodes=n_nodes,
               timer_resolution_ns=int(np.gcd.reduce(steps[steps > 0])),
               card=torch.cuda.get_device_name(0), checks=checks,
               shapes={"rows": LOOP_CHUNK, "slots": STAMP_SLOTS},
               **ptxas_report(build.build_log("stamp")))
    return row, all(checks.values())


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA card", file=sys.stderr)
        return 1
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    from bloomscene_tpu_torch.config import GSConfig
    from bloomscene_tpu_torch.ops.cuda import build, wrappers
    from bloomscene_tpu_torch.pipeline.bloomscene import render_model
    failed = []

    # 1. build
    card = card_name_and_power()
    t0 = time.perf_counter()
    build.build_all()
    for name in build.KERNELS:
        build.library(name)
    ptxas = {name: [ln.strip() for ln in build.build_log(name).splitlines()
                    if "Used" in ln or "spill" in ln]
             for name in build.KERNELS}
    # every kernel keeps its state in registers: a spill, or no report to
    # show there is none, fails
    spills = {name: ptxas_report(build.build_log(name))["spill_bytes"]
              for name in build.KERNELS}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "card": card, "ptxas": ptxas, "spill_bytes": spills})
    if any(v != 0 for v in spills.values()):
        failed.append("build (a kernel spills, or has no ptxas report)")

    # 2. scene
    cfg = GSConfig(voxel_size=0.03)
    t0 = time.perf_counter()
    points = room_points(N_POINTS, SEED)
    model, voxel = trained_scale_model(points, cfg, SEED, "cuda")
    torch.cuda.synchronize()
    n_anchors = model.state.num_alive()
    emit({"phase": "scene", "points": int(points.shape[0]),
          "voxel_size": voxel, "anchors": n_anchors,
          "capacity": model.state.capacity,
          "seconds": time.perf_counter() - t0})

    # 3. main path
    cams = orbit_cameras(N_FRAMES, 512, 512, repo)
    counters = wrappers()
    for fn in counters.values():
        fn.launches = 0
    stats: list = []
    frames, depths, fps = render_model(model, cams, cfg, mode="eval",
                                       device="cuda", frame_stats=stats)
    launches = {name: fn.launches for name, fn in counters.items()}
    for i, s in enumerate(stats):
        emit({"phase": "frame", "frame": i, **s})
    finite = all(np.isfinite(f).all() and np.isfinite(d).all()
                 for f, d in zip(frames, depths))
    shapes = all(f.shape == (512, 512, 3) and d.shape == (512, 512)
                 for f, d in zip(frames, depths))
    pairs_ok = all(s["num_pairs"] > 0 for s in stats)
    # the measuring pass decodes each camera once too (count_pairs)
    counts_ok = all(v == {"blend_backward": 0, "hashgrid_bwd": 0,
                          "gather_rows_bwd": 0, "hashgrid_encode_bwd": 0,
                          "stamp": 0, "emission_sums": 0,
                          "hashgrid_encode": 2 * len(frames)}.get(
                              name, len(frames))
                    for name, v in launches.items())
    emit({"phase": "render", "frames": len(frames), "fps": fps,
          "card": card, "launches": launches, "finite": finite,
          "shapes_ok": shapes, "pairs_ok": pairs_ok,
          "launches_ok": counts_ok,
          "mean_color": float(np.mean([f.mean() for f in frames]))})
    if not (finite and shapes and pairs_ok and counts_ok):
        failed.append("render")

    # 4. kernels against their plain versions
    rows, ok = kernel_checks(model, cams[0], cfg,
                             stats[0]["visible_capacity"],
                             stats[0]["pair_capacity"])
    for row in rows:
        emit({"phase": "kernel", "at": "render_frame", "card": card, **row})
    failed += [name for name, good in ok.items() if not good]

    # 5. small reference
    ref, ref_ok = reference_check(model, cfg, 128)
    emit({"phase": "reference", **ref, "ok": ref_ok})
    if not ref_ok:
        failed.append("reference")

    # 6. gradients through the tile blend, card against CPU
    gref, gref_ok = grad_reference_check(model, cfg, 128)
    emit({"phase": "grad_reference", **gref, "ok": gref_ok})
    if not gref_ok:
        failed.append("grad_reference")

    # 7. the training path (perturbs and trains the model in place; the
    # later phases start from a copy of the untrained one)
    from bloomscene_tpu_torch.convert import model_to
    fresh = model_to(model, model.state.device)
    trainer, cfg_t, views, steps, summary, train_ok = train_phase(
        model, cams, frames, depths, voxel, counters)
    for step in steps:
        emit({"phase": "train_step", **step})
    emit({"phase": "train", "card": card, **summary, "ok": train_ok})
    if not train_ok:
        failed.append("train")

    # 8. the kernels on one training step's inputs: K3, K4, K1 at the
    # training shapes, K2
    row, k2_ok, fwd_rows, fwd_ok = train_kernel_checks(trainer, cfg_t, views)
    for r in fwd_rows:
        emit({"phase": "kernel", "at": "train_step", "card": card, **r})
    emit({"phase": "kernel", "at": "train_step", "card": card, **row})
    failed += [f"{name} (train step)" for name, good in fwd_ok.items()
               if not good]
    if not k2_ok:
        failed.append("blend_backward")
    es_row, es_ok = emission_sums_check(trainer, cfg_t, views)
    emit({"phase": "kernel", "at": "train_step", "card": card, **es_row})
    if not es_ok:
        failed.append("emission_sums")

    # 9. one phase-2 step's gradients, card against CPU
    p2ref, p2ref_ok = phase2_grad_reference(fresh, 128, repo)
    emit({"phase": "phase2_grad_reference", **p2ref, "ok": p2ref_ok})
    if not p2ref_ok:
        failed.append("phase2_grad_reference")

    # 10. the whole schedule: phases 0-2, the bounds refresh, two
    # densification steps
    workdir = os.path.join(repo, "outputs", "chip_smoke")
    os.makedirs(workdir, exist_ok=True)
    ckpt = os.path.join(workdir, "schedule_trainer.npz")
    trainer_s, cfg_s, views_s, s_steps, s_dens, s_summary, s_ok = \
        schedule_phase(model_to(fresh, fresh.state.device), cams, frames,
                       depths, voxel, counters, save_path=ckpt)
    for step in s_steps:
        emit({"phase": "schedule_step", **step})
    for d in s_dens:
        emit({"phase": "densify", **d})
    emit({"phase": "schedule", "card": card, **s_summary, "ok": s_ok})
    if not s_ok:
        failed.append("schedule")
    # the host loop at step 40, which phase 22's device loop is held to
    # (phases 11, 12 and 19 move this trainer on)
    snapshot = os.path.join(repo, "outputs", "chip_smoke_loop",
                            "schedule_step40.npz")
    trainer_s.save(snapshot)
    s_records = [dict(r) for r in trainer_s.history]
    # the schedule's checkpoint, restored into a fresh trainer and run on
    resume, resume_ok = resume_check(
        model_to(fresh, fresh.state.device), trainer_s, cfg_s,
        cams[0].intrinsics, voxel, views_s, ckpt)
    emit({"phase": "resume", "card": card, **(s_summary["checkpoint"] or {}),
          **resume, "ok": resume_ok})
    if not resume_ok:
        failed.append("resume")

    # 11. the kernels on a phase-2 step's inputs after the densification
    s_row, s_k2_ok, s_fwd_rows, s_fwd_ok = train_kernel_checks(
        trainer_s, cfg_s, views_s, phase=2)
    for r in s_fwd_rows + [s_row]:
        emit({"phase": "kernel", "at": "schedule_step", "card": card, **r})
    failed += [f"{name} (schedule step)" for name, good in s_fwd_ok.items()
               if not good]
    if not s_k2_ok:
        failed.append("blend_backward (schedule step)")

    # 12. the hash grid's backward on one phase-2 step's rows
    hg_row, hg_ok = hashgrid_row(capture_grid_scatter(trainer_s, cfg_s,
                                                      views_s))
    emit({"phase": "kernel", "at": "schedule_step", "card": card, **hg_row})
    if not hg_ok:
        failed.append("hashgrid_bwd")

    # 13. the codec on the schedule's model
    decoded, codec, codec_ok = codec_phase(
        trainer_s.model, cfg_s, workdir)
    emit({"phase": "codec", "card": card, **codec, "ok": codec_ok})
    if not codec_ok:
        failed.append("codec")

    # 14. the decoded scene's orbit, beside the encoded scene's eval orbit
    enc_frames, _, eval_fps = render_model(trainer_s.model, cams, cfg,
                                           mode="eval", device="cuda")
    for fn in counters.values():
        fn.launches = 0
    d_stats: list = []
    d_frames, d_depths, d_fps = render_model(decoded, cams, cfg,
                                             mode="decoded", device="cuda",
                                             frame_stats=d_stats)
    d_launches = {name: fn.launches for name, fn in counters.items()}
    d_checks = {
        "finite": all(np.isfinite(f).all() and np.isfinite(d).all()
                      for f, d in zip(d_frames, d_depths)),
        "shapes": all(f.shape == (512, 512, 3) for f in d_frames),
        "pairs": all(s_["num_pairs"] > 0 for s_ in d_stats),
        "launches_once_a_frame": all(
            v == (len(d_frames) if name in ("pair_expansion",
                                            "slab_expansion",
                                            "blend_forward") else 0)
            for name, v in d_launches.items())}
    emit({"phase": "decoded_orbit", "card": card, "frames": len(d_frames),
          "decoded_fps": d_fps, "eval_fps": eval_fps,
          "eval_fps_untrained_scene": fps, "launches": d_launches,
          "frame_ms": [s_["ms"] for s_ in d_stats],
          "visible_anchors": [s_["visible_anchors"] for s_ in d_stats],
          "num_pairs": [s_["num_pairs"] for s_ in d_stats],
          # the decoded attributes are the encoded scene's, quantized
          "mean_abs_diff_to_eval": float(np.mean(
              [np.abs(a - b).mean() for a, b in zip(d_frames, enc_frames)])),
          "checks": d_checks, "ok": all(d_checks.values())})
    if not all(d_checks.values()):
        failed.append("decoded_orbit")

    # 15. the kernels at the decoded frame's shapes
    d_rows, d_ok = kernel_checks(decoded, cams[0], cfg,
                                 d_stats[0]["visible_capacity"],
                                 d_stats[0]["pair_capacity"], mode="decoded")
    for r in d_rows:
        emit({"phase": "kernel", "at": "decoded_frame", "card": card, **r})
    failed += [f"{name} (decoded frame)" for name, good in d_ok.items()
               if not good]

    # 16. the tile path against the dense golden blend
    golden, golden_ok = golden_check(64)
    emit({"phase": "golden", "card": card, **golden, "ok": golden_ok})
    if not golden_ok:
        failed.append("golden")

    # 17. capacity growth, then a phase-2 step and the kernels at the
    # grown shape
    trainer_g, cfg_g, views_g, g_summary, g_ok = growth_phase(
        fresh, cams, frames, depths, voxel, counters)
    emit({"phase": "growth", "card": card, **g_summary, "ok": g_ok})
    if not g_ok:
        failed.append("growth")
    g_ref, g_ref_ok = phase2_grad_reference(trainer_g.model, 128, repo)
    emit({"phase": "growth_grad_reference", **g_ref, "ok": g_ref_ok})
    if not g_ref_ok:
        failed.append("growth_grad_reference")
    g_row, g_k2_ok, g_fwd_rows, g_fwd_ok = train_kernel_checks(
        trainer_g, cfg_g, views_g, phase=2)
    for r in g_fwd_rows + [g_row]:
        emit({"phase": "kernel", "at": "growth_step", "card": card, **r})
    failed += [f"{name} (grown)" for name, good in g_fwd_ok.items()
               if not good]
    if not g_k2_ok:
        failed.append("blend_backward (grown)")

    # 18. K1 and K2 at tiles 8, 12, 16, 40 and 64
    tiles, tiles_ok = tile_checks(model_to(fresh, fresh.state.device),
                                  cams[0], cfg)
    emit({"phase": "tiles", "card": card, "tiles": tiles, "ok": tiles_ok})
    if not tiles_ok:
        failed.append("tiles")

    # 19. phase-2 steps with the kernel against index_add_
    ab, ab_ok = phase2_ab(trainer_s, views_s, counters)
    emit({"phase": "phase2_ab", "card": card, **ab, "ok": ab_ok})
    if not ab_ok:
        failed.append("phase2_ab")
    # phase 7's trainer stays for phase 26
    del trainer_s, trainer_g
    torch.cuda.empty_cache()

    # 20. the CLI as a user runs it: generate, train, compress, save,
    # render the orbit and the eval views
    pipe_dir = os.path.join(workdir, "pipeline")
    bs, pipe, pipe_ok = pipeline_phase(repo, pipe_dir, counters, card)
    emit({"phase": "pipeline", **pipe, "ok": pipe_ok})
    if not pipe_ok:
        failed.append("pipeline")
    # the kernels on the inputs of the pipeline's last training step
    from bloomscene_tpu_torch.train.loop import phase_of_step
    p_row, p_k2_ok, p_fwd_rows, p_fwd_ok = train_kernel_checks(
        bs.trainer, bs.cfg, bs.train_views(),
        phase=phase_of_step(bs.trainer.step, bs.cfg))
    for r in p_fwd_rows + [p_row]:
        emit({"phase": "kernel", "at": "pipeline_step", "card": card, **r})
    failed += [f"{name} (pipeline step)" for name, good in p_fwd_ok.items()
               if not good]
    if not p_k2_ok:
        failed.append("blend_backward (pipeline step)")

    # 21. a cold start from the pipeline's files
    cold_bs, cold, cold_ok = cold_start_phase(pipe_dir, bs, counters, card)
    emit({"phase": "cold_start", **cold, "ok": cold_ok})
    if not cold_ok:
        failed.append("cold_start")
    # the kernels at its first decoded frame's shapes
    c_rows, c_ok = kernel_checks(
        cold_bs.decoded_model, cold_bs.scene.preset_cameras["rotate360"][0],
        cold_bs.cfg, cold["overflow"]["visible_capacity"],
        cold["overflow"]["pair_capacity"], mode="decoded")
    for r in c_rows:
        emit({"phase": "kernel", "at": "cold_start_frame", "card": card,
              **r})
    failed += [f"{name} (cold start frame)" for name, good in c_ok.items()
               if not good]
    del cold_bs, bs
    torch.cuda.empty_cache()

    # 22. the device loop (CUDA graphs of the step) over the schedule,
    # against the host loop's state at step 40
    from bloomscene_tpu_torch.train.loop import Trainer
    reference = Trainer(perturbed(model_to(fresh, fresh.state.device), SEED),
                        cfg_s, cams[0].intrinsics, voxel, seed=SEED)
    reference.restore(snapshot)
    dl, dl_ok = device_loop_phase(model_to(fresh, fresh.state.device), cams,
                                  frames, depths, voxel, counters, reference,
                                  s_records, s_summary)
    del reference
    emit({"phase": "device_loop", "card": card, **dl, "ok": dl_ok})
    if not dl_ok:
        failed.append("device_loop")

    # 23. the device loop across a capacity growth
    dlg, dlg_ok = device_loop_growth_phase(fresh, cams, frames, depths,
                                           voxel, counters)
    emit({"phase": "device_loop_growth", "card": card, **dlg, "ok": dlg_ok})
    if not dlg_ok:
        failed.append("device_loop_growth")

    # 24. the batched trainer at full width
    dp, dp_ok = dp_phase(fresh, cams, frames, depths, voxel, counters)
    emit({"phase": "dp", "card": card, **dp, "ok": dp_ok})
    if not dp_ok:
        failed.append("dp")

    # 25. fit_single_view, host loop and device loop
    fit, fit_ok, f_fwd_rows, f_row = fit_phase(workdir, counters)
    for r in f_fwd_rows + [f_row]:
        emit({"phase": "kernel", "at": "fit_step", "card": card, **r})
    emit({"phase": "fit_single_view", "card": card, **fit, "ok": fit_ok})
    if not fit_ok:
        failed.append("fit_single_view")

    # 26. K1 and K2 on strips of positions, against the full call
    t0 = time.perf_counter()
    strips, strips_ok, strip_entries = strip_phase(
        model_to(fresh, fresh.state.device), cams[0], cfg, trainer, cfg_t,
        views)
    emit({"phase": "strip_kernels", "card": card, "tiles": STRIP_TILES,
          "inputs": strips,
          # the same full calls' times in phases 4 and 8 of this run
          "k1_ms_phase4": rows[2]["ms"], "k1_ms_phase8": fwd_rows[2]["ms"],
          "k2_ms_phase8": row["ms"],
          "seconds": time.perf_counter() - t0, "ok": strips_ok})
    if not strips_ok:
        failed.append("strip_kernels")
    del trainer
    torch.cuda.empty_cache()

    # 27-30. the parallel layer: RANKS gloo ranks on the card (the
    # tile-parallel render and step, the data-parallel trainer, the
    # ring), then one NCCL rank
    job = parallel_job(os.path.join(workdir, "parallel"), fresh, cams,
                       frames, depths, voxel)
    t0 = time.perf_counter()
    (tp, tp_ok), (dpm, dpm_ok), (nccl, nccl_ok), (ring, ring_ok) = \
        parallel_phases(os.path.join(workdir, "parallel"), job)
    parallel_s = time.perf_counter() - t0
    for name, summary_, good in (("tile_parallel", tp, tp_ok),
                                 ("dp_mesh", dpm, dpm_ok),
                                 ("nccl_world1", nccl, nccl_ok),
                                 ("ring", ring, ring_ok)):
        emit({"phase": name, "card": card, **summary_, "ok": good})
        if not good:
            failed.append(name)
    emit({"phase": "parallel_seconds", "seconds": parallel_s})

    # 31. run_fullscale's path, short: 128x128, 60 steps across phases
    # 0-2 and two surgeries in the device loop, the codec's byte-exact
    # re-encode, the decoded orbit, the eval views
    t0 = time.perf_counter()
    fs_bs, fs, fs_ok = fullscale_short_phase(
        os.path.join(workdir, "fullscale_short"), counters, card)
    emit({"phase": "fullscale_short", **fs, "ok": fs_ok})
    if not fs_ok:
        failed.append("fullscale_short")
    # the kernels on the inputs of its last training step
    fs_row, fs_k2_ok, fs_fwd_rows, fs_fwd_ok = train_kernel_checks(
        fs_bs.trainer, fs_bs.cfg, fs_bs.train_views(),
        phase=phase_of_step(fs_bs.trainer.step, fs_bs.cfg))
    for r in fs_fwd_rows + [fs_row]:
        emit({"phase": "kernel", "at": "fullscale_short_step", "card": card,
              **r})
    failed += [f"{name} (fullscale_short step)"
               for name, good in fs_fwd_ok.items() if not good]
    if not fs_k2_ok:
        failed.append("blend_backward (fullscale_short step)")
    del fs_bs
    torch.cuda.empty_cache()
    emit({"phase": "fullscale_short_seconds",
          "seconds": time.perf_counter() - t0})

    # 32. the compacted decode at run_fullscale's visible_capacity: the
    # host and device loops, the step's gradients against the dense
    # decode's, the padding's cotangents, gather_rows_bwd against its
    # plain version, the step and backward times
    t0 = time.perf_counter()
    cs, cs_ok, cs_row = compacted_step_phase(fresh, cams, frames, depths,
                                             voxel, counters)
    emit({"phase": "compacted_step", "card": card, **cs,
          "seconds": time.perf_counter() - t0, "ok": cs_ok})
    if not cs_ok:
        failed.append("compacted_step")
    emit({"phase": "kernel", "at": "compacted_step", "card": card, **cs_row})

    # 33. the hash-grid encoder's kernel, forward and backward, at phase 2's
    # scene's rows against the eager path and the twin, with its times
    t0 = time.perf_counter()
    hge_row, hgb_row, hge_ok = hashgrid_encode_phase(fresh, cfg)
    for r in (hge_row, hgb_row):
        emit({"phase": "kernel", "at": "hashgrid_encode", **r})
    emit({"phase": "hashgrid_encode", "card": card, "ok": hge_ok,
          "seconds": time.perf_counter() - t0})
    if not hge_ok:
        failed.append("hashgrid_encode")

    # 34. the stamp kernel: the one cell written, rows outside unwritten,
    # against its plain version; its times
    t0 = time.perf_counter()
    st_row, st_ok = stamp_phase()
    emit({"phase": "kernel", "at": "stamp", **st_row})
    emit({"phase": "stamp", "card": card, "ok": st_ok,
          "seconds": time.perf_counter() - t0})
    if not st_ok:
        failed.append("stamp")

    shape_keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                  "library_ms", "shapes")
    for r, t, u, d, g, pp, c, f, fs_r in zip(
            rows, fwd_rows, s_fwd_rows, d_rows, g_fwd_rows, p_fwd_rows,
            c_rows, f_fwd_rows, fs_fwd_rows):
        r["train_shape"] = {k: t[k] for k in shape_keys}
        r["schedule_shape"] = {k: u[k] for k in shape_keys}
        r["decoded_shape"] = {k: d[k] for k in shape_keys}
        r["growth_shape"] = {k: g[k] for k in shape_keys}
        r["pipeline_shape"] = {k: pp[k] for k in shape_keys}
        r["cold_start_shape"] = {k: c[k] for k in shape_keys}
        r["fit_single_view_shape"] = {k: f[k] for k in shape_keys}
        r["fullscale_short_shape"] = {k: fs_r[k] for k in shape_keys}
    row["schedule_shape"] = {k: s_row[k] for k in shape_keys}
    row["growth_shape"] = {k: g_row[k] for k in shape_keys}
    row["pipeline_shape"] = {k: p_row[k] for k in shape_keys}
    row["fit_single_view_shape"] = {k: f_row[k] for k in shape_keys}
    row["fullscale_short_shape"] = {k: fs_row[k] for k in shape_keys}
    # the strips of phase 26 at tile 16: 512 of the 1,024 positions
    rows[2]["strip_shape"] = strip_entries["k1_render"]
    rows[2]["train_strip_shape"] = strip_entries["k1_train"]
    row["strip_shape"] = strip_entries["k2_train"]
    row["render_strip_shape"] = strip_entries["k2_render"]
    rows += [row, es_row, hg_row, cs_row, hge_row, hgb_row, st_row]
    # a kernel's launches are those of the main paths: render, train, the
    # schedule, the decoded orbit, the growth run, the CLI's pipeline and
    # its cold start, the device loop (a captured launch counted once a
    # replay) and its growth run, the batched trainer and fit_single_view
    # (both loops)
    fit_launches = {k: fit["host_loop"]["launches"][k]
                    + fit["device_loop"]["launches"][k] for k in counters}
    paths = {"render": launches, "train": summary["launches"],
             "schedule": s_summary["launches"], "decoded": d_launches,
             "growth": g_summary["launches"], "pipeline": pipe["launches"],
             "cold_start": cold["launches"], "device_loop": dl["launches"],
             "device_loop_growth": dlg["launches"], "dp": dp["launches"],
             "fit_single_view": fit_launches,
             "tile_parallel": tp["launches"], "dp_mesh": dpm["launches"],
             "nccl_world1": nccl["launches"],
             "fullscale_short": fs["launches"],
             "compacted_step": cs["launches"]}
    for r in rows:
        for path, counts in paths.items():
            r[f"launches_{path}"] = counts[r["name"]]
        r["launches"] = sum(r[f"launches_{p}"] for p in paths)
    failed += [f"{r['name']} (never launched)" for r in rows
               if r["launches"] == 0]

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            *(f"launches_{p}" for p in paths),
            "block", "dynamic_smem_bytes", "static_smem_bytes", "registers",
            "spill_bytes", "graph_node_ms", "timer_resolution_ns",
            "train_shape", "schedule_shape", "decoded_shape",
            "growth_shape", "pipeline_shape", "cold_start_shape",
            "fit_single_view_shape", "fullscale_short_shape", "strip_shape",
            "train_strip_shape", "render_strip_shape", "stats_shape")
    print(card, flush=True)
    emit({"kernels": [{k: r[k] for k in keys if k in r} for r in rows]})
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

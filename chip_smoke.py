#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU and
check them.

    python3 chip_smoke.py

Phases, each printed with its wall time and bounded by a watchdog:

1. device: require CUDA; print the card's name and power limit.
2. build: with the persistent kernel cache on in a fresh temporary
   directory (``$SPLATPU_TORCH_COMPILE_CACHE``, which the CLIs and the
   bench called below and every child process then use), compile
   ``splatpu_torch/csrc/*.cu`` with nvcc, one process per source, all at
   once; print the cache key, the build's and each source's nvcc seconds
   and the registers of the kernels in ``PTXAS_NAMES``, and fail if one is
   missing.  Then one child process loads the library from that cache:
   it must compile nothing, load the entry this process published and
   run K1 on a fixed input (``CACHE_CASE``, binned on the CPU from a seed)
   to outputs bitwise this process's (image, depth, final T, ``last``).
3. prng: ``core/prng.py``'s draws on the card against the same draws on
   the CPU, bit for bit: ``split`` and ``random_bits`` of three keys,
   ``uniform`` at the network's and a cloud's shapes and bounds,
   ``normal`` at 500,224 x 3 (stage 1's config-4 capacity; its bitwise
   share printed, 2 ulp at most), the config-3 network from ``key(0)``;
   and ``make_random_cloud(key(0), 120000, ...)`` on the card against
   ``runs/acceptance_truth/truth_n120000.npz`` (the uniform fields bit
   for bit, quaternions and log scales 1e-6).
4. compare: the forward-composite kernel K1 against its plain PyTorch
   version on the real 100,585-Gaussian cloud, five orbit cameras at
   320x180, one launch: image 2e-5, depth 2e-4, final T 2e-5, ``last``
   identical (as in every forward comparison below).
5. compare_bwd: at 5 x 320x180 and 5 x 1280x720 (five cameras of the
   training rig, the config-3 cloud at t = 0), on the cotangents of
   0.8 L1 + 0.2 (1 - SSIM) against the image shifted by a few pixels (plus
   small depth and final-T terms): the backward composite K2 against its
   plain version (per-pair rows), the routing kernel K3 against the plain
   routing, the whole ``CompositeTable`` backward "cuda" against "plain" on
   d(table), each scaled per row by the reference's largest value, 1e-4; and
   K2 + routing run twice, bitwise identical.
6. compare_manual: K4 (``kernel="manual"``), forward and backward, against
   its plain versions at 5 x 320x180 (orbit cameras) with 3 and with 9
   colour channels (the 9 from a seeded generator), the forward held as
   K1's; rows, the 16-row routing and the
   ``CompositeTable`` backward 1e-4 scaled per row; backward and routing
   bitwise identical across two runs.  Then one direct call whose ``gid``
   holds 2^24 + 2^20 slots, four tiles' segments placed above position
   2^24 and every other tile empty, against the plain versions handed the
   window of ``gid`` that holds those segments.
7. compare_padded: K5 (the padded composite), forward and backward, against
   its plain versions at 5 x 320x180 on padded pair streams built on the
   card at 16 px tiles, 3 and 9 channels, the same tolerances, the routing
   in its padded slot mode (the stream's ``q_of_slot``) and the
   ``CompositeG`` backward "cuda" against "plain".
8. serve, serve_manual, serve_padded: ``run_inference`` at full width: the
   config-3 checkpoint's network (hidden 128, 3 blocks, head settings from
   its stage2_result.json), the real cloud, five 1280x720 orbit views per
   timestep; ``serve`` 150 timesteps plus t=0 through K1, the other two
   NEW_SERVE_TIMESTEPS plus t=0 (a depth cut) through K4 and through K5 at
   a 16 px budget measured at 16 px.  Every kernel count is zeroed just
   before ``run_inference`` and read just after; the path's forward kernel
   must have run at every render and no other composite at all.  Then
   ``serve`` runs VIDEO_TIMESTEPS timesteps again with an output
   directory: the PNG frames and one video per camera (without imageio a
   GIF through PIL holding every frame at 1280x720, looping).
9. train, train_manual, train_padded: ``train`` at full width, cut in depth:
   the real cloud, the checkpoint's network with a fresh Adam, the head
   settings of its result file, targets rendered on the card from the cloud
   moved as in the config-3 run (27 cameras, 1280x720, uint8),
   ``view_staging="device_u8"``, five views per step, shuffled timesteps;
   ``train`` TRAIN_TIMESTEPS x TRAIN_ITERATIONS through K1/K2,
   ``train_manual`` (``binning_overrides={"kernel": "manual"}``) and
   ``train_padded`` (``renderer="cuda_padded"``, a 16 px budget measured at
   16 px) NEW_TRAIN_TIMESTEPS x NEW_TRAIN_ITERATIONS, instead of 150 x 40.
   Every kernel count is zeroed just before ``train`` and read just after;
   each step must launch its path's forward, backward and the routing
   kernel once, and no other composite.
10. measure, measure_manual, measure_padded: each forward kernel at the
   served shapes (the t=0 frame's inputs) against its plain version, CUDA-
   event times of both, and the bound from this run's bytes and the work
   its data needs.
11. measure_bwd, measure_manual, measure_padded: each forward kernel again
   at the training shapes (five 1280x720 rig views at the trainer's final
   budget) against its plain version, its time and bound there; each
   backward kernel (and the routing) at those shapes against its plain
   version, CUDA-event times,
   the plain versions' times, one ``index_add_`` of the kept pairs' rows by
   (view, gid) as the routing's library yardstick, and the bounds from this
   run's inputs; the slots per (view, Gaussian) of both streams, and the
   routing in its padded mode at the padded path's training shapes against
   its plain version, with its time, the plain version's, one
   ``index_add_`` of the in-budget slots' rows by (view, gid) and its bound.

12. bwd_tiles: at 5 x 320x180 with 8 and 24 px tiles (``NEW_BWD_TILES``):
   K1 and K4's forward there against their plain versions (``last``
   identical), and K2 and K4's backward from that ``last``, held as in
   compare_bwd; then K2, and after it K4's backward, at those tiles at the
   training shapes (five 1280x720 rig views at each tile's demand budget)
   against its plain version, its time and its bound.  It runs after the
   measure phases so that the serve, train and measure phases follow the
   same work as before these tiles existed.
12b. large_tiles: the same at 5 x 320x180 with 40, 48, 56 and 64 px tiles
   (``LARGE_TILES``): K1 and K4's forward against their plain versions
   (``last`` identical), K2 and K4's backward from that ``last`` as in
   compare_bwd; K1, K2 and K4's forward and backward at the training
   shapes at each of those tiles, each against its plain version (K4's
   against K1's and K2's plain outputs where its inputs, outputs and
   cotangents are bitwise K1's), with its time and its bound, and at 48
   and 64 px (``LARGE_TIMED``) the plain K1's and K2's time (one run);
   then ``train`` for one step
   and ``run_inference`` for one timestep, at full width, with
   ``binning_overrides={"tile": 64}`` and with
   ``binning_overrides={"exact_tie_order": False}`` (32 px), every count
   zeroed before each and read after: K1, K2 and the routing once in the
   step, K1 once per render, nothing else.
13. train_options: ``train`` at full width, 2 timesteps, from the same
   start each time: ``view_batching="vmap"`` and ``"map"`` (five renders
   per step; its per-step losses within 1e-5 relative of vmap's) and
   ``compute_dtype="bfloat16"`` (finite losses), 1 iteration each; then
   the three view stagings (``"device"``, ``"host"``, ``"device_rotate"``
   with 8 resident cameras restaged every iteration) of the views as the
   sequence loader gives them (float32),
   STAGING_ITERATIONS iterations each, whose wall time per sequence
   iteration (the card synchronised at each iteration's end; staging,
   steps and logging included) is printed beside the steps' CUDA-event
   times; each run through K1, K2 and the routing only.
14. cli: the command line end to end at full width.  BASELINE config 3 as
   a sequence on disk (the config-3 cloud as
   ``densified_initial_gaussian_cloud_parameters.npz``; 27 rig cameras x 3
   frames at 1280x720 rendered on the card, frame 0 unmoved, written as
   JPEG through PIL, or PNG without it); ``cli.train`` for 2 iterations x
   2 timesteps with host staging and a checkpoint per iteration, then
   again for a third iteration resumed from that checkpoint with
   device_rotate staging (8 resident cameras, restaged every iteration),
   config 3's head flags; then ``cli.render`` of the bundle.  Checks the
   checkpoint's ``seq_it``, the resumed run's first step (5), finite losses
   and ``mean-image-loss`` rows, the bundle's files, the standalone
   render's frames within 1 level of the trainer's, a video per orbit
   camera, and that only K1, K2 and the routing launched; prints ms per
   step and wall ms per iteration by staging mode, the checkpoint write,
   the sequence load and the videos.
15. knn_native: 250,000 points from a seed through ``knn`` (which routes
   them to the native KD-tree), timed beside the port's own
   ``knn_bruteforce`` on the card, against brute force on the card: indices
   identical to a brute force in the tree's float32 arithmetic, squared
   distances within 1e-6 relative of float64's (near ties, where float32
   and float64 order two neighbours differently, are counted).

16. stage1_step (stage 1 at BASELINE config 2: the 27 rig cameras at
   1280x720, image and segmentation targets rendered on the card from the
   config-3 truth cloud, every third truth Gaussian as the 33,528 initial
   points, capacity factor 6.0 -> 201,216 slots): one stage-1 iteration
   (``Stage1Steps.forward_backward``: the dual render of one view, image +
   3 x segmentation loss, gradients) through K1, K2 and the routing and
   through the plain versions, on the initial cloud and on the truth
   (its means moved by a seeded N(0, 0.005^2)) padded to 201,216 slots, at
   the default budget grown as ``fit`` grows it on overflow: the CUDA step
   run twice, bitwise identical in every output; the loss 1e-5 relative,
   both images 2e-5 and ``last`` identical against the plain versions;
   every parameter's gradient and the means2d_offset collector's 1e-4
   scaled per row, both runs differentiating the L1 term with the plain
   run's signs (``L1Signs``: rounding flips sign(x - target) on pixels
   whose residual is near 0; the flips and the gradients with them left
   in are printed).
17. stage1: ``fit`` at config 2 with the reference schedule for
   S1_ITERATIONS iterations (a depth cut from 30,000; it crosses the
   mutations at 500 and 600): ms per iteration (CUDA events between
   iteration ends, and the host clock; medians of the non-mutation
   iterations after the first 20, and each mutation's), ``n_alive`` and
   the counts of each mutation, every budget growth, the first and last
   losses; fails unless the loss falls, no overflow is left at the end,
   and every iteration launched K1, K2 and the routing twice.  Then K1
   and K2 at the stage-1 shape (one view, the fitted cloud of 201,216
   slots) against their plain versions, timed, with their bounds.
18. stage1_options: a scaled schedule (mutations every 10 from 10, opacity
   reset and big prune from 20, the window and its final prune at 40, past
   the last iteration, so the resumed clouds stay alive), 4 views per step,
   the pair budget a quarter of the initial cloud's demand with an
   overflow check every 5 iterations: 20 iterations writing a checkpoint,
   then two resumes from it to 40, which must carry ``i``, the growths and
   the grown budget and end bitwise equal with Gaussians alive; then 4
   iterations each with
   ``kernel="manual"`` (K4) and ``renderer="cuda_padded"`` at 16 px (K5),
   each launching only its own kernels.
19. cli_densify: the config-2 scene written as a sequence (one frame of 27
   JPEG views, PNG masks, ``init_pt_cld.npz``); ``cli.densify`` for
   S1_CLI_ITERATIONS[0] iterations with a checkpoint every 10, then resumed
   to S1_CLI_ITERATIONS[1]; the metrics rows, the written cloud (read by
   ``io.checkpoint.load_cloud``), the set-up times (sequence load, each
   checkpoint write of the 201,216-slot state).

The distributed modes (``splatpu_torch.dist``): ranks started by
``dist.launch`` share the card over gloo (NCCL refuses two ranks on one
device); each rank counts its own kernel launches (zeroed just before its
path, read just after) and sends them back.  These phases show that the
sharded paths run and agree with the single-process run, not that they
scale: every rank computes on the same card.

20. dist_render: the config-3 cloud and one 1280x720 orbit view cut into
   DIST_STRIPS strips, one per rank, through K1
   (``make_tile_sharded_render``), the strips gathered into the whole
   image on every rank: each strip, and the gathered image, within 2e-5
   of the whole render (strips are expected bit for bit), the gather
   changing no value, K1 once per rank; prints each rank's rows' error and
   how many of its pixels name another last contributor (a Gaussian id)
   than the whole render.
21. dist_train: config 3 at full width (the real cloud, the checkpoint's
   network and head settings with a fresh Adam, 27 rig views at 1280x720
   as uint8, five per step padded to six), 2 timesteps x 2 iterations with
   ``mesh_cameras=2`` over 2 ranks, against the single-process ``train``
   of the same config and start: every step's loss
   1e-5 relative, the final parameters within 2e-2 of how far they moved,
   both ranks' parameters bitwise equal, two sharded runs bitwise equal,
   K1, K2 and the routing once per step in each rank; ms per step of both.
22. dist_2d: the same on the 2 x 2 grid (4 ranks: ``mesh_cameras=2``,
   ``mesh_tiles=2``), 2 timesteps x 2 iterations (the depth of the JAX
   package's test of this step).
23. dist_stage1: config 2 at full width with ``mesh_tiles=2`` (2 ranks)
   for DIST_S1_ITERATIONS iterations (the JAX package's test's), a
   mutation (clones) at 2 and a budget of four times the initial cloud's
   demand, against the
   single-process ``fit``: every iteration's loss 1e-5 relative, no
   overflow, the alive masks identical after each mutation, the means and
   opacity logits within rtol 1e-4 and atol 1e-6 (the JAX package's gate),
   both ranks' clouds bitwise equal, K1, K2 and the routing twice per
   iteration in each rank.
24. train_batch: two config-3 sequences written as the ``cli`` phase
   writes one (frames 0-2 and 5-7 of the motion) trained by
   ``cli.train_batch`` over 2 processes (ranks), one sequence each, 2
   iterations x 2 timesteps; each sequence's network bitwise equal to that
   of an independent ``cli.train`` run of it.

25. acceptance: the acceptance scene of the JAX package
   (``runs/acceptance_truth/truth_n120000.npz``, 27 rig cameras at
   1280x720) through ``splatpu_torch.tools.acceptance``: ``floor`` of
   ``runs/s1_ceiling_r4b/densified_cloud.npz``, every per-camera PSNR
   within ACCEPT_FLOOR_DB of the JAX package's floor script run on a CPU
   (``runs/acceptance_truth/floor_jax_cpu.json``) and each timestep's mean
   within ACCEPT_FLOOR_DB of ``runs/floor_100k.json`` (the TPU's, whose
   per-camera values the JAX package itself misses by up to 0.13 dB off
   the TPU; printed); then
   ``stage1`` for ACCEPT_ITERATIONS iterations from the 40,000 truth points
   (``fit`` counted: every iteration must launch K1, K2 and the routing
   twice and no other composite), its per-iteration ``total_loss`` printed
   beside ``runs/s1_ceiling_r4b/stage1_metrics.jsonl``'s, with both runs'
   overflowed steps and budget growths (the TPU grew to max_pairs 960,512
   and max_span 64 at 100); it fails unless the mean ``total_loss`` of the
   iterations is within ACCEPT_LOSS_RTOL of the TPU log's.

26. acceptance_config4: BASELINE config 4, the JAX package's
   250,000-Gaussian truth (``runs/acceptance_truth/truth_n250000.npz``)
   at the same rig, through the same tool.  ``stage1`` for
   ACCEPT4_ITERATIONS iterations from its 83,333 points at the TPU run's
   final prune 0.05 (counted as in acceptance); the first ``total_loss``
   within ACCEPT_FIRST_LOSS_RTOL of the JAX package's on a CPU
   (``first_loss_jax_cpu_n250000.json``, from
   ``scripts/acceptance_first_loss.py``; the TPU's, 0.57% away, printed)
   and the mean within ACCEPT_LOSS_RTOL of the TPU log's
   (``config4_tpu_reference.json``, copied from ``runs/config4_s1``, which
   is not sent to the card).  Then ``stage2`` of the truth animated with
   ``runs/config4_250k``'s settings (the faithful quirk head, host
   staging) for ACCEPT4_STAGE2 sequence iterations x timesteps at its
   demand-sized budget: every step logged, no overflow, K2 and the routing
   once per step (the first step's loss printed beside the TPU's: both
   from the JAX package's network draw of ``key(seed)``); and the same
   steps from the same network in this process and over 2 camera ranks
   (gloo, the one card) under dist_train's gates, the single-process
   losses within 1e-5 of the tool's.  Shows that config 4's camera
   sharding runs and agrees, not that it scales.

27. bench: ``bench_torch.main(profile=BENCH_PROFILE)``, the port's bench
   entry (``bench.py``'s workload: one forward + backward of 100,000 random
   Gaussians from the JAX package's ``key(0)`` draw at 1280x720, 32 px
   tiles, 400,128 pairs), which prints its lines and the card's busy share
   over BENCH_PROFILE calls; its run counted: K1, K2 and the routing once per
   forward + backward and nothing else, no overflow; ``time_fn``'s per-call
   mean and spread printed with its timer, which must be the host clock.
   Then one forward + backward through the kernels against the plain versions (loss 1e-5
   relative, image, depth, final T and ``last`` as every forward, the five
   gradient groups 1e-4 scaled per row), and K1, K2 and the routing at
   that shape on the bench loss's cotangents: times, the plain versions'
   (K1's too), ``index_add_`` for the routing, bounds.

Prints one ``{"kernels": [...]}`` JSON line (the routing once per slot
mode, each with the launches of its paths; the forwards also with their
time and bound at the training shapes, ``train_ms`` and
``train_bound_ms``; K1 and K2 also at the stage-1 shape, ``stage1_ms`` and
``stage1_bound_ms``; K2 and K4's backward also at 8 and 24 px tiles at
the training shapes, and K1 and K2 at 48 and 64 px there, ``tiles``; K1,
K2 and the routing also at the bench
shape, ``bench_*``), then the card line, and last
``{"ok": true, "device": {...}}``.  Any failure exits non-zero; nothing is
caught and continued.  Imports nothing of JAX.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import faulthandler
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CLOUD = ROOT / "runs" / "s1_ceiling_r4b" / "densified_cloud.npz"
N_GAUSSIANS = 100585   # alive in CLOUD
RUN = ROOT / "runs" / "config3_100k_r5"
TIMESTEPS = 150
SERVE_SIZE = (1280, 720)
COMPARE_SIZE = (320, 180)
TRAIN_TIMESTEPS = 8    # depth cut: config 3 trains 150 timesteps
TRAIN_ITERATIONS = 2   # depth cut: config 3 trains 40 sequence iterations
NEW_SERVE_TIMESTEPS = 10    # depth cut of serve_manual / serve_padded
NEW_TRAIN_TIMESTEPS = 2     # depth cut of train_manual / train_padded
NEW_TRAIN_ITERATIONS = 2
CHANNELS = (3, 9)      # colour channels K4 and K5 are compared at
NEW_BWD_TILES = (8, 24)  # the backward body's tiles besides 16 and 32 (px)
LARGE_TILES = (40, 48, 56, 64)  # the bodies' tiles above 32 px
LARGE_TIMED = (48, 64)          # of them, the plain K1 and K2 timed at the training shapes
LARGE_PATH_TILE = 64            # large_tiles: the train step and served timestep
OPTION_TIMESTEPS = 2     # train_options: timesteps per run
STAGING_ITERATIONS = 6   # train_options: sequence iterations per staging mode
CLI_FRAMES = 3           # cli: frames 0..2 of the sequence, T = 2 trainable
VIDEO_TIMESTEPS = 2      # serve: the rollout written as frames and videos
BENCH_PROFILE = 5        # bench: calls profiled for the card's busy share
KNN_POINTS = 250_000     # knn_native: above the native route's 200,000
KNN_K = 20
S1_CAPACITY_FACTOR = 6.0   # config 2: 33,528 points -> 201,216 slots
S1_POINTS = 33_528
S1_CAPACITY = 201_216
S1_ITERATIONS = 610        # depth cut: config 2 fits 30,000 iterations
S1_OPTION_VIEWS = 4        # stage1_options: views per step
S1_OPTION_ITERATIONS = (20, 40)  # stage1_options: checkpoint at the first, resume to the second
S1_PATH_ITERATIONS = 4     # stage1_options: the K4 and K5 runs
S1_CLI_ITERATIONS = (30, 40)     # cli_densify: first run, then resumed to
DIST_STRIPS = (2,)         # dist_render: strips per view, one rank each (depth cut: 4 strips
                           # repeat the check; tests/test_torch_tile_sharding.py holds them)
DIST_ITERATIONS = 2        # dist_train, dist_2d: sequence iterations (config 3: 40)
DIST_TIMESTEPS = 2         # dist_train, dist_2d: timesteps (config 3: 150)
DIST_S1_ITERATIONS = 4     # dist_stage1: iterations (config 2: 30,000; JAX's test: 4)
DIST_S1_MUTATE = 2         # dist_stage1: the mutation (clones) at 2
ACCEPT_TRUTH = ROOT / "runs" / "acceptance_truth" / "truth_n120000.npz"
ACCEPT_FLOOR = ROOT / "runs" / "floor_100k.json"      # the TPU's floor of that scene
ACCEPT_FLOOR_CPU = ROOT / "runs" / "acceptance_truth" / "floor_jax_cpu.json"  # the JAX
                                                    # package's, on a CPU
ACCEPT_TPU_LOG = ROOT / "runs" / "s1_ceiling_r4b" / "stage1_metrics.jsonl"
ACCEPT_ITERATIONS = 120    # acceptance: stage-1 iterations (config 2: 8,000 or 30,000)
ACCEPT_FLOOR_DB = 0.05     # acceptance: per-camera floor PSNR against the TPU's
ACCEPT_LOSS_RTOL = 0.02    # acceptance: mean total_loss of the run against the TPU log's
ACCEPT4_TRUTH = ROOT / "runs" / "acceptance_truth" / "truth_n250000.npz"  # BASELINE config 4
ACCEPT4_FIRST_LOSS = ROOT / "runs" / "acceptance_truth" / "first_loss_jax_cpu_n250000.json"
ACCEPT4_TPU = ROOT / "runs" / "acceptance_truth" / "config4_tpu_reference.json"
ACCEPT4_POINTS = 83_333     # acceptance_config4: every third of the truth
ACCEPT4_ITERATIONS = 20     # acceptance_config4: stage-1 iterations (config 4: 15,000)
ACCEPT4_PRUNE = 0.05        # the TPU run's final prune
ACCEPT4_STAGE2 = (2, 2)     # acceptance_config4: sequence iterations x timesteps (30 x 150)
ACCEPT_FIRST_LOSS_RTOL = 1e-4  # the first stage-1 loss against the JAX package's on a CPU
ACCEPT4_CAPACITY = 500_224  # stage 1's slots on the config-4 truth: the split noise's rows
PRNG_SEEDS = (0, 7, 2**31)  # prng: the keys drawn on the card and on the CPU
CACHE_CASE = (5, 2_000, 320, 180)  # build: the K1 check's seed, Gaussians, width, height
# build: the child process that loads the library from the cache; argv: the
# K1 input file, the output file.  torch is imported before the clock starts,
# as in every caller of the library.
CACHE_CHILD = """
import json, sys, time
import torch
import chip_smoke
from splatpu_torch import _build
from splatpu_torch.obs.cache import enable_compilation_cache
enable_compilation_cache()
t0 = time.perf_counter()
_build.load_library()
load_s = time.perf_counter() - t0
chip_smoke.cache_k1(sys.argv[1], "cuda", sys.argv[2])
print(json.dumps({"build_cached": _build.build_cached, "compiled": sorted(_build.source_seconds),
                  "load_s": load_s, "path": str(_build.library_path())}))
"""
DIST_TIMEOUT_S = 240       # every launch of ranks: its result within this, or it fails
DIST_RENDERER = "cuda"     # the distributed phases' render path
BIG_P = (1 << 24) + (1 << 20)  # gid slots of K4's large-budget call
BIG_BASE = 1 << 24             # where its segments start
BIG_TILES = 4
BWD_TOL = 1e-4         # scaled per row by the reference's largest value
DEVICE = "cuda"
TOL = {"image": 2e-5, "depth": 2e-4, "final_T": 2e-5}

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W).
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
# FP32 operations per evaluated (pixel, pair): dx, dy (2), the quadratic form
# (9), exp (1), opacity scale (1), min (1), two cut tests (2).  Per
# contribution: 1 - alpha, T * (1 - alpha), the T test, w = alpha * T, and a
# multiply-add per colour channel and for depth (2 each).
OPS_PER_EVAL = 16

# ptxas's (mangled) kernel names -> the names printed with their registers:
# the 3-channel instances at the tiles the paths use (the table kernels'
# template arguments are <C, tile>), the routing's 10 rows in both slot
# modes (<R, padded>), and the 9-channel and 16-row instances.  The build
# phase fails if one is missing from nvcc's log.
PTXAS_NAMES = {
    "composite_fwd_kernelILi3ELi32E": "composite_fwd",
    "composite_fwd_kernelILi3ELi16E": "composite_fwd tile 16",
    "composite_bwd_kernelILi3ELi32E": "composite_bwd",
    "composite_bwd_kernelILi3ELi16E": "composite_bwd tile 16",
    "composite_bwd_kernelILi3ELi8E": "composite_bwd tile 8",
    "composite_bwd_kernelILi3ELi24E": "composite_bwd tile 24",
    "manual_bwd_kernelILi3ELi8E": "composite_manual_bwd tile 8",
    "manual_bwd_kernelILi3ELi24E": "composite_manual_bwd tile 24",
    "manual_bwd_kernelILi9ELi8E": "composite_manual_bwd C=9 tile 8",
    "manual_bwd_kernelILi9ELi24E": "composite_manual_bwd C=9 tile 24",
    **{f"{k}_kernelILi3ELi{t}E": f"{n} tile {t}" for t in LARGE_TILES
       for k, n in (("composite_fwd", "composite_fwd"), ("composite_bwd", "composite_bwd"),
                    ("manual_fwd", "composite_manual_fwd"),
                    ("manual_bwd", "composite_manual_bwd"))},
    **{f"{k}_kernelILi9ELi{t}E": f"{n} C=9 tile {t}" for t in LARGE_TILES
       for k, n in (("manual_fwd", "composite_manual_fwd"), ("manual_bwd", "composite_manual_bwd"))},
    "route_pairs_kernelILi10ELb0E": "route_pairs",
    "route_pairs_kernelILi10ELb1E": "route_pairs padded",
    "route_pairs_kernelILi16ELb1E": "route_pairs R=16 padded",
    "manual_fwd_kernelILi3ELi32E": "composite_manual_fwd",
    "manual_bwd_kernelILi3ELi32E": "composite_manual_bwd",
    "manual_fwd_kernelILi9ELi32E": "composite_manual_fwd C=9",
    "manual_bwd_kernelILi9ELi32E": "composite_manual_bwd C=9",
    "padded_fwd_kernelILi3E": "padded_fwd", "padded_bwd_kernelILi3E": "padded_bwd",
    "padded_fwd_kernelILi9E": "padded_fwd C=9", "padded_bwd_kernelILi9E": "padded_bwd C=9",
}


def ops_per_contribution(c: int) -> int:
    return 4 + 2 * (c + 1)


# Backward, per evaluated (pixel, pair): the forward's 16.  Per live pair:
# 1 - alpha, the T division, chat (2 + 2C), w, dalpha (3), the suffix update
# (2), dpower (2), the rows (mx 4, my 4, ca 3, cb 3, cc 3, depth 1, colour C)
# and the sum of the 7 + C rows over the pixels.
def ops_bwd_per_live(c: int) -> int:
    return 30 + 3 * c + 7 + c


def launch_counts() -> dict:
    """Every kernel's launch counter (``splatpu_torch.obs.profiling.COUNTERS``)."""
    from splatpu_torch.obs import profiling

    return profiling.launch_counts()


def zero_counts() -> None:
    from splatpu_torch.obs import profiling

    profiling.zero_counts()


class StepLog:
    """The trainer's logger: per-step metrics as floats, the kernel launches
    each step made, budget growths, and whether the first step changed the
    network's parameters."""

    def __init__(self, net, expected):
        self.net = net
        self.expected = expected
        self.before = {k: v.detach().clone() for k, v in net.state_dict().items()}
        self.seen = None
        self.steps, self.growth_steps, self.growths = [], set(), 0
        self.changed_after_first = False
        self.iteration_ms = []

    def log(self, metrics, step):
        if "budget_growth" in metrics:
            self.growths = int(metrics["budget_growth"])
            self.growth_steps.add(step)
            print(f"  step {step}: budget growth -> {metrics}", flush=True)
            return
        now = launch_counts()
        launched = {k: n - (self.seen or {}).get(k, 0) for k, n in now.items()}
        self.seen = now
        m = {k: float(v) for k, v in metrics.items()}
        m["launched"] = launched
        if not self.steps:
            self.changed_after_first = any(
                not bool((v == self.before[k]).all()) for k, v in self.net.state_dict().items())
        self.steps.append((step, m))
        print(f"  step {step:2d}: loss {m['total']:.6f} (l1 {m['l1']:.5f} ssim {m['ssim']:.5f}"
              f" rig {m['rigidity']:.3e}) grad_norm {m['grad_norm']:.4e} lr"
              f" {m['learning_rate']:.4e} {m['step_ms']:.2f} ms; pairs {int(m['pairs'])}"
              f" / budget {int(m['max_pairs'])}; launches"
              f" {[launched[k] for k in self.expected]} of {list(self.expected)}", flush=True)

    def flush(self):
        pass


def rig_cams(dev, w, h, n=None):
    """The rig cameras (the first ``n``, or all 27) at w x h, batched."""
    import numpy as np
    import torch

    from splatpu_torch.core.types import Camera
    from splatpu_torch.tools.train_scene import rig_cameras

    cams = rig_cameras(w, h)[:n]
    return Camera(w2c=torch.from_numpy(np.stack([c[0] for c in cams])).to(dev),
                  K=torch.from_numpy(np.stack([c[1] for c in cams])).to(dev), width=w, height=h)


def cotangents(image, depth, tfin):
    """The cotangents of 0.8 L1 + 0.2 (1 - SSIM) against the image shifted by
    (3, 5) px, + 0.1 mean depth + 0.05 mean T."""
    import torch

    from splatpu_torch.core.ssim import ssim

    leaves = [x.detach().clone().requires_grad_(True) for x in (image, depth, tfin)]
    target = torch.roll(image, shifts=(3, 5), dims=(2, 3))
    loss = (0.8 * (leaves[0] - target).abs().mean() + 0.2 * (1.0 - ssim(leaves[0], target))
            + 0.1 * leaves[1].mean() + 0.05 * leaves[2].mean())
    return tuple(g.contiguous() for g in torch.autograd.grad(loss, leaves))


def table_case(args, cams, binning, fwd):
    """The exact stream's kernel inputs, ``fwd``'s outputs on them and their
    cotangents."""
    import torch

    from splatpu_torch.render.exact import composite_inputs

    streams, k = composite_inputs(args, cams, binning)
    kin = (k["table"].detach(), k["gid"], k["start"], k["end"],
           torch.zeros(args.colors.shape[1], device=args.colors.device))
    out = fwd(*kin, **k["geometry"])
    return dict(
        kin=kin, geo=k["geometry"], out=out, fwd=out[2:], cot=cotangents(*out[:3]),
        binning=binning,
        offsets=torch.stack([s.offsets for s in streams]),
        counts=torch.stack([s.counts for s in streams]),
        lane=torch.stack([s.lane for s in streams]),
    )


def bwd_case(args, cams, dev, binning=None):
    """K1's forward at ``cams`` and its cotangents (``table_case``)."""
    import splatpu_torch.render.composite as composite
    from splatpu_torch.render.api import demand_binning, measure_binning_demand

    if binning is None:
        binning = demand_binning(*measure_binning_demand(args, cams))
    return table_case(args, cams, binning, composite.composite_fwd_cuda)


def padded_case(args, cams, binning):
    """The padded pair streams' K5 inputs (records gathered by gid), K5's
    forward outputs on them, their cotangents, and the routing's inputs."""
    import torch

    import splatpu_torch.render.padded as padded
    from splatpu_torch.render.binning import build_pair_stream, tile_grid
    from splatpu_torch.render.composite import pack_table

    streams = [build_pair_stream(args, cams.view(i), binning) for i in range(cams.num_views)]
    table = torch.stack([pack_table(s.splats.mean2d, s.splats.conic, s.g_opacity,
                                    s.splats.depth, s.g_colors) for s in streams]).detach()
    gid = torch.stack([s.gid for s in streams])
    rows = torch.arange(len(streams), device=gid.device)[:, None]
    stack = lambda f: torch.stack([getattr(s, f) for s in streams])  # noqa: E731
    tiles_x, tiles_y = tile_grid(cams.width, cams.height, 16)
    geo = dict(tiles_x=tiles_x, tiles_y=tiles_y, width=cams.width, height=cams.height)
    kin = (table[rows, gid.long()].contiguous(), stack("start"), stack("end"),
           torch.zeros(args.colors.shape[1], device=gid.device))
    out = padded.padded_fwd_cuda(*kin, **geo)
    return dict(kin=kin, geo=geo, out=out, fwd=out[2:], cot=cotangents(*out[:3]), table=table,
                gid=gid, pos=stack("q_of_slot"), offsets=stack("emit_offsets"),
                counts=stack("emit_counts"))


def ptxas_summary(log: str) -> dict:
    """kernel -> 'N registers, M B smem; S bytes spill stores, ...' from
    nvcc's -Xptxas -v lines."""
    out, name, spill = {}, None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = next((v for k, v in PTXAS_NAMES.items() if k in line), None)
            spill = ""
        elif "bytes spill stores" in line:
            spill = line.strip()
        elif name and "Used" in line and "registers" in line:
            out[name] = f"{line.split('ptxas info    :')[-1].strip()}; {spill}"
    return out


def print_slot_runs(what, counts) -> None:
    """The emission slots per (view, Gaussian): the routing walks each run
    serially."""
    c = counts.reshape(-1).long()
    print(f"  {what}: slots per (view, Gaussian) max {int(c.max())}, mean"
          f" {float(c.float().mean()):.3f}, over 32 {int((c > 32).sum())} of {c.numel()},"
          f" over 128 {int((c > 128).sum())}", flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


@contextlib.contextmanager
def phase(name: str, budget_s: int):
    """Print the phase's wall time; kill the process if it outlives budget_s
    (a watchdog thread, so a hang inside CUDA is bounded too)."""
    faulthandler.dump_traceback_later(budget_s, exit=True)
    t0 = time.perf_counter()
    print(f"[{name}] start", flush=True)
    yield
    faulthandler.cancel_dump_traceback_later()
    print(f"[{name}] done in {time.perf_counter() - t0:.2f} s", flush=True)


def compare(got, ref) -> dict:
    import torch

    for name, a in zip(("image", "depth", "final_T"), got[:3]):
        if not bool(torch.isfinite(a).all()):
            fail(f"kernel {name} has non-finite values")
    err = {k: float((a - b).abs().max()) for k, a, b in zip(TOL, got[:3], ref[:3])}
    err["last_mismatches"] = int((got[3] != ref[3]).sum())
    return err


def check_errors(err: dict, where: str) -> None:
    """Fail unless image, depth and final T are within TOL and ``last`` is
    identical on every pixel."""
    line = ", ".join(f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}" for k, v in err.items())
    print(f"  {where}: max|d| {line}", flush=True)
    for k, tol in TOL.items():
        if not err[k] <= tol:
            fail(f"{where}: {k} max|d| {err[k]:.3e} > {tol}")
    if err["last_mismatches"]:
        fail(f"{where}: last contributor differs on {err['last_mismatches']} pixels")


def check_rows(where: str, errs: dict) -> None:
    print(f"  {where}: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + " (scaled per row)", flush=True)
    for k, v in errs.items():
        if not v <= BWD_TOL:
            fail(f"{where}: {k} scaled error {v:.3e} > {BWD_TOL}")


def check_only(counts: dict, expected: set, where: str) -> None:
    """Fail if a kernel outside ``expected`` launched on this path."""
    stray = {k: n for k, n in counts.items() if n and k not in expected}
    if stray:
        fail(f"{where}: kernels of another path launched: {stray}")


def fwd_bound(c, v, hw, evals, contribs, bytes_in):
    """(bound ms, bytes ms, ops ms, bytes, ops) of a forward composite: its
    inputs read once and its outputs (C + 3 values per pixel) written once;
    the operations its data needs."""
    bytes_moved = bytes_in + 4 * (c + v * hw * (c + 3))
    ops = OPS_PER_EVAL * evals + ops_per_contribution(c) * contribs
    t_bytes, t_ops = 1e3 * bytes_moved / PEAK_BYTES_S, 1e3 * ops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops), t_bytes, t_ops, bytes_moved, ops


def table_bytes_in(kin) -> int:
    """A table forward's input bytes: the table, each pair's gid, the
    segments' start and end."""
    v, n, rec = kin[0].shape
    return 4 * (v * n * rec + int(kin[3][:, -1].sum()) + 2 * kin[2].numel())


def padded_bytes_in(kin) -> int:
    """K5's input bytes: the records of the pairs in the segments, start and
    end."""
    rec = kin[0].shape[2]
    return 4 * (int((kin[2] - kin[1]).sum()) * rec + 2 * kin[1].numel())


def measure_fwd(label, fwd, fwd_plain, kin, geo, out, bytes_in, time_plain=True, plain_reps=2):
    """A forward kernel's outputs ``out`` on ``kin`` against its plain
    version, the kernel's CUDA-event time (and the plain version's), and its
    bound from ``bytes_in`` and the work this input needs.  Returns (numbers,
    contributions per pixel)."""
    from splatpu_torch.tools.measure import cuda_ms

    *ref, n_eval, n_contrib = fwd_plain(*kin, **geo, with_counts=True)
    err = compare(out, ref)
    check_errors(err, label)
    ms = cuda_ms(lambda: fwd(*kin, **geo), reps=20, warmup=3)
    plain_ms = (cuda_ms(lambda: fwd_plain(*kin, **geo), reps=plain_reps, warmup=plain_reps // 2)
                if time_plain else None)
    v, c = out[0].shape[:2]
    evals, contribs = int(n_eval.sum()), int(n_contrib.sum())
    bound = fwd_bound(c, v, geo["width"] * geo["height"], evals, contribs, bytes_in)
    plain = f", plain {plain_ms:.2f} ms" if time_plain else ""
    print(f"  {label}: {ms:.4f} ms/launch{plain}; bound {bound[0]:.4f} ms (bytes {bound[3]} ->"
          f" {bound[1]:.4f} ms, FP32 ops {bound[4]} -> {bound[2]:.4f} ms); evaluations {evals},"
          f" contributions {contribs}", flush=True)
    return dict(err=max(err["image"], err["depth"], err["final_T"]), ms=ms, plain_ms=plain_ms,
                bound=bound), n_contrib


def bwd_work(kin_start, last, geo, n_live):
    """Backward evaluations (every pixel from its tile's start to its last)
    and live steps (the forward's contributions)."""
    import torch

    from splatpu_torch.render.composite import to_tiles

    last_t = to_tiles(last[:, None].long(), geo["tiles_x"], geo["tiles_y"], geo.get("tile", 16),
                      fill=-1)[..., 0]
    start_t = kin_start.reshape(-1).long()[:, None]
    evals = int(torch.where(last_t >= 0, last_t - start_t + 1, torch.zeros_like(last_t)).sum())
    return evals, int(n_live.sum())


def kernel_entry(name, source, replaces, by_path, err, ms, plain_ms, bound, library_ms=None,
                 train=None, tiles=None, stage1=None, bench=None):
    """One entry of the kernels line; ``train``: a forward's numbers at the
    training shapes; ``tiles``: a backward's at other tiles there;
    ``stage1``: the numbers at the stage-1 shape; ``bench``: at the bench
    shape (``bench_torch.py``'s one view)."""
    bound_by = lambda b: "operations" if b[2] >= b[1] else "bytes"  # noqa: E731
    entry = {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": sum(by_path.values()), "launches_by_path": by_path, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound_by(bound),
        "library_ms": library_ms,
    }
    if train is not None:
        entry.update(train_ms=train["ms"], train_bound_ms=train["bound"][0],
                     train_max_abs_err=train["err"])
    if tiles is not None:
        entry["tiles"] = tiles
    if stage1 is not None:
        entry.update(stage1_ms=stage1["ms"], stage1_bound_ms=stage1["bound"][0],
                     stage1_max_abs_err=stage1["err"])
    if bench is not None:
        entry.update(bench_ms=bench["ms"], bench_bound_ms=bench["bound"][0],
                     bench_bound_by=bound_by(bench["bound"]), bench_max_abs_err=bench["err"],
                     bench_plain_ms=bench["plain_ms"], bench_library_ms=bench.get("library_ms"))
    return entry


def serve_path(name, net, cloud, config, expected_fwd, timesteps):
    """``run_inference`` with every count zeroed just before and read just
    after; checks the frames and that ``expected_fwd`` (and nothing else)
    launched at every render.  Returns (counts, stats)."""
    import numpy as np
    import torch

    from splatpu_torch.dynamics.deform import normalize_and_encode_means_and_rotations
    from splatpu_torch.train.inference import run_inference

    enc = normalize_and_encode_means_and_rotations(
        cloud.means, cloud.rotation_quaternions, quirk_compat=config.quirk_compat)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    frames, stats = run_inference(net, cloud, enc, config, width=SERVE_SIZE[0],
                                  height=SERVE_SIZE[1], device=DEVICE)
    serve_s = time.perf_counter() - t0
    counts = launch_counts()
    step_ms = np.array(stats["timestep_ms"])
    print(f"  {timesteps} timesteps + t=0, 5 x {SERVE_SIZE[0]}x{SERVE_SIZE[1]} each, renderer"
          f" {config.renderer!r}, kernel {stats['binning'].kernel!r}, tile"
          f" {stats['binning'].tile}: {serve_s:.2f} s wall", flush=True)
    print(f"  pair budget {stats['max_pairs']} (demand {stats['demand_pairs']},"
          f" span demand {stats['demand_span']} -> max_span {stats['max_span']});"
          f" pairs used (max per view) {stats['pairs_used']}", flush=True)
    print(f"  growths {stats['growths']}, residual overflow {stats['residual_overflow']},"
          f" renders {stats['renders']}, non-finite values {stats['nonfinite_pixels']}",
          flush=True)
    print(f"  launches {counts}", flush=True)
    print(f"  per-timestep ms (CUDA events): mean {step_ms.mean():.3f}"
          f" median {np.median(step_ms):.3f} min {step_ms.min():.3f}"
          f" max {step_ms.max():.3f}", flush=True)
    for cam, fr in frames.items():
        shape = (SERVE_SIZE[1], SERVE_SIZE[0], 3)
        if len(fr) != timesteps + 1 or fr[0].shape != shape or fr[0].dtype != np.uint8:
            fail(f"{name}: camera {cam}: {len(fr)} frames of {fr[0].shape} {fr[0].dtype}")
        print(f"  camera {cam}: mean t=0 {fr[0].mean():.3f}, t={timesteps // 2}"
              f" {fr[timesteps // 2].mean():.3f}, t={timesteps} {fr[-1].mean():.3f}", flush=True)
    if stats["nonfinite_pixels"]:
        fail(f"{name}: {stats['nonfinite_pixels']} non-finite image values")
    if stats["residual_overflow"]:
        fail(f"{name}: binning overflow left after growth")
    if counts[expected_fwd] != stats["renders"] or stats["renders"] < timesteps + 1:
        fail(f"{name}: {expected_fwd} launched {counts[expected_fwd]} times in"
             f" {stats['renders']} renders, expected one per render, >= {timesteps + 1}")
    check_only(counts, {expected_fwd}, name)
    if all(fr[0].mean() < 1.0 for fr in frames.values()):
        fail(f"{name}: every t=0 frame is black")
    return counts, stats


def iteration_clock(ends):
    """An ``on_iteration`` for ``train`` that appends, after each sequence
    iteration, the host clock once the card has finished its work: the
    differences are the wall time of an iteration, view staging, steps,
    logging and checkpoint write included."""
    import torch

    def on_iteration(*_):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())

    return on_iteration


def train_path(name, cloud, views, tcfg, expected, n_steps, per_step=1):
    """``train`` with every count zeroed just before and read just after;
    checks each step's launches (``expected`` ``per_step`` times each,
    nothing else), losses, gradients and budget.  Returns (counts, log)."""
    import numpy as np
    import torch

    import splatpu_torch.train.stage2 as stage2
    from splatpu_torch.io.checkpoint import load_stage2_run

    tnet, _ = load_stage2_run(RUN, device=DEVICE)
    log = StepLog(tnet, expected)
    ends = []
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    stage2.train(cloud, views, tcfg, logger=log, initial_net=tnet, device=DEVICE,
                 on_iteration=iteration_clock(ends))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = launch_counts()
    step_ms = np.array([m["step_ms"] for _, m in log.steps])
    log.iteration_ms = [1e3 * (b - a) for a, b in zip(ends, ends[1:])]
    print(f"  train(): {n_steps} steps in {train_s:.2f} s wall (setup and staging"
          f" included); step ms (CUDA events, the steps only) mean {step_ms.mean():.2f} median"
          f" {np.median(step_ms):.2f} min {step_ms.min():.2f} max {step_ms.max():.2f}; wall ms"
          f" per sequence iteration after the first {[round(x, 2) for x in log.iteration_ms]};"
          f" launches {counts}; growths {log.growths}", flush=True)
    if len(log.steps) != n_steps:
        fail(f"{name}: logged {len(log.steps)} steps, expected {n_steps}")
    for k in expected:
        if counts[k] != n_steps * per_step:
            fail(f"{name}: {k} launched {counts[k]} times in {n_steps} steps, expected"
                 f" {n_steps * per_step}")
    check_only(counts, set(expected), name)
    for step_idx, m in log.steps:
        if not np.isfinite(m["total"]):
            fail(f"{name} step {step_idx}: non-finite loss {m['total']}")
        if not (np.isfinite(m["grad_norm"]) and m["grad_norm"] > 0):
            fail(f"{name} step {step_idx}: grad_norm {m['grad_norm']}")
        if any(n != (per_step if k in expected else 0) for k, n in m["launched"].items()):
            fail(f"{name} step {step_idx}: kernel launches {m['launched']}")
        if m["binning_overflow"] and step_idx not in log.growth_steps:
            fail(f"{name} step {step_idx}: binning overflow not followed by growth")
    if log.steps[-1][1]["binning_overflow"]:
        fail(f"{name}: binning overflow left after growth at the last step")
    if not log.changed_after_first:
        fail(f"{name}: parameters unchanged after the first step")
    return counts, log


def compare_table_bwd(where, case, bwd, bwd_plain, impl, refs=None):
    """A table kernel's backward and the routing against their plain
    versions, the ``CompositeTable`` backward ``impl`` against its plain
    twin, and the backward + routing run twice, bitwise identical.
    ``refs``: a dict that keeps the plain backward's rows and the plain
    twin's d(table) for a later call on equal inputs, which reuses them."""
    import torch

    import splatpu_torch.render.route as route
    from splatpu_torch.render.exact import CompositeTable
    from splatpu_torch.tools.measure import row_scaled_err

    kin, geo, cot = case["kin"], case["geo"], case["cot"]

    def d_table_of(key):
        table = kin[0].clone().requires_grad_(True)
        outs = CompositeTable.apply(table, kin[4], *kin[1:4], case["offsets"],
                                    case["counts"], case["lane"], geo, key)
        torch.autograd.backward(outs[:3], cot)
        return table.grad

    rows = bwd(*kin, *case["fwd"], *cot, **geo)
    torch.cuda.synchronize()
    refs = {} if refs is None else refs
    if "rows" not in refs:
        refs["rows"] = bwd_plain(*kin, *case["fwd"], *cot, **geo)
        refs["d_table"] = d_table_of(("plain", impl[1]))
    rows_ref = refs["rows"]
    pos = route.pos_of_slot_of(case["offsets"], kin[1], case["lane"])
    routed = route.route_pairs_cuda(rows, pos, case["offsets"], case["counts"])
    routed_ref = route.route_pairs_plain(rows, pos, case["offsets"], case["counts"])
    d_table = {"cuda": d_table_of(impl), "plain": refs["d_table"]}
    again = route.route_pairs_cuda(bwd(*kin, *case["fwd"], *cot, **geo), pos,
                                   case["offsets"], case["counts"])
    torch.cuda.synchronize()
    for name, x in (("rows", rows), ("routed", routed), ("d_table", d_table["cuda"])):
        if not bool(torch.isfinite(x).all()) or not bool((x != 0).any()):
            fail(f"{where}: {name} non-finite or all zero")
    check_rows(f"{where}, pairs/view max {int(kin[3][:, -1].max())}", {
        "rows": row_scaled_err(rows, rows_ref),
        "routing": row_scaled_err(routed, routed_ref),
        "CompositeTable d_table": row_scaled_err(d_table["cuda"], d_table["plain"]),
    })
    if not torch.equal(again, routed):
        fail(f"{where}: backward + routing not bitwise identical across two runs")
    print(f"  {where}: backward + routing bitwise identical across two runs", flush=True)


def big_budget_case(case):
    """K4 on one view whose four longest segments sit above pair position
    2^24 in a gid of BIG_P slots, every other tile empty, against the plain
    versions on the window of gid that holds those segments."""
    import torch

    import splatpu_torch.render.composite as composite
    from splatpu_torch.tools.measure import row_scaled_err

    table, gid, start, end, bg = (x[:1] if x.dim() > 1 else x for x in case["kin"])
    geo = case["geo"]
    lengths = (end - start)[0]
    tiles = torch.argsort(lengths, descending=True)[:BIG_TILES]
    dev = gid.device
    window = torch.cat([gid[0, int(start[0, t]):int(end[0, t])] for t in tiles.tolist()])
    lens = lengths[tiles]
    offs = torch.cumsum(lens, 0) - lens
    start_w = torch.zeros_like(start)
    end_w = torch.zeros_like(end)
    start_w[0, tiles] = offs.int()
    end_w[0, tiles] = (offs + lens).int()
    n_win = window.numel()
    gid_big = torch.zeros((1, BIG_P), dtype=torch.int32, device=dev)
    gid_big[0, BIG_BASE:BIG_BASE + n_win] = window
    start_b = torch.where(end_w > start_w, start_w + BIG_BASE, start_w)
    end_b = torch.where(end_w > start_w, end_w + BIG_BASE, end_w)
    got = composite.composite_manual_fwd_cuda(table, gid_big, start_b, end_b, bg, **geo)
    torch.cuda.synchronize()
    ref = composite.composite_manual_fwd_plain(table, window[None].contiguous(), start_w, end_w,
                                               bg, **geo)
    ref_last = torch.where(ref[3] >= 0, ref[3] + BIG_BASE, ref[3])
    where = f"P = 2^24 + 2^20, {BIG_TILES} tiles ({n_win} pairs) above 2^24"
    check_errors(compare(got, (*ref[:3], ref_last)), where)
    if not bool((got[3] >= BIG_BASE).any()):
        fail(f"{where}: no pixel's last position lies above 2^24")
    cot = cotangents(*got[:3])
    last_w = torch.where(got[3] >= 0, got[3] - BIG_BASE, got[3])
    rows = composite.composite_manual_bwd_cuda(table, gid_big, start_b, end_b, bg, got[2], got[3],
                                               *cot, **geo)
    again = composite.composite_manual_bwd_cuda(table, gid_big, start_b, end_b, bg, got[2],
                                                got[3], *cot, **geo)
    torch.cuda.synchronize()
    rows_ref = composite.composite_manual_bwd_plain(table, window[None].contiguous(), start_w,
                                                    end_w, bg, got[2], last_w, *cot, **geo)
    inside = rows[0, BIG_BASE:BIG_BASE + n_win]
    outside = max(float(rows[0, :BIG_BASE].abs().max()),
                  float(rows[0, BIG_BASE + n_win:].abs().max()))
    check_rows(where, {"rows": row_scaled_err(inside, rows_ref[0])})
    if outside != 0.0 or not bool((inside != 0).any()):
        fail(f"{where}: rows outside the window {outside}, or none inside")
    if not torch.equal(rows, again):
        fail(f"{where}: backward not bitwise identical across two runs")
    print(f"  {where}: rows outside the window zero; backward bitwise identical across two"
          f" runs; rows {tuple(rows.shape)}", flush=True)


def compare_padded_case(where, args, cams, binning):
    """K5's forward and backward, the routing over the padded slots and the
    ``CompositeG`` backward, each against its plain version."""
    import torch

    import splatpu_torch.render.padded as padded
    import splatpu_torch.render.route as route
    from splatpu_torch.tools.measure import row_scaled_err

    case = padded_case(args, cams, binning)
    kin, geo, cot = case["kin"], case["geo"], case["cot"]
    torch.cuda.synchronize()
    ref = padded.padded_fwd_plain(*kin, **geo)
    check_errors(compare(case["out"], ref), where)
    rows = padded.padded_bwd_cuda(*kin, *case["fwd"], *cot, **geo)
    torch.cuda.synchronize()
    rows_ref = padded.padded_bwd_plain(*kin, *case["fwd"], *cot, **geo)
    routing = (case["pos"], case["offsets"], case["counts"])
    routed = route.route_pairs_cuda(rows, *routing, padded=True)
    routed_ref = route.route_pairs_plain(rows, *routing, padded=True)
    d_table = {}
    for impl in ("cuda", "plain"):
        table = case["table"].clone().requires_grad_(True)
        outs = padded.CompositeG.apply(table, kin[3], case["gid"], kin[1], kin[2], case["pos"],
                                       case["offsets"], case["counts"], geo, impl)
        torch.autograd.backward(outs[:3], cot)
        d_table[impl] = table.grad
    again = route.route_pairs_cuda(padded.padded_bwd_cuda(*kin, *case["fwd"], *cot, **geo),
                                   *routing, padded=True)
    torch.cuda.synchronize()
    for name, x in (("rows", rows), ("routed", routed), ("d_table", d_table["cuda"])):
        if not bool(torch.isfinite(x).all()) or not bool((x != 0).any()):
            fail(f"{where}: {name} non-finite or all zero")
    check_rows(f"{where}, padded length {kin[0].shape[1]}", {
        "rows": row_scaled_err(rows, rows_ref),
        "routing": row_scaled_err(routed, routed_ref),
        "CompositeG d_table": row_scaled_err(d_table["cuda"], d_table["plain"]),
    })
    if not torch.equal(again, routed):
        fail(f"{where}: backward + routing not bitwise identical across two runs")
    print(f"  {where}: backward + routing bitwise identical across two runs", flush=True)


def compare_tile(args, cams, tile):
    """K1 and K4's forward at ``tile`` against their plain versions
    (``last`` identical), and K2 and K4's backward from that ``last``, held
    as in compare_bwd.  K4's plain versions are K1's and K2's walk, so
    where K4's inputs, forward outputs and cotangents equal K1's, their
    outputs are held against the plain outputs already computed."""
    import torch

    import splatpu_torch.render.composite as composite
    from splatpu_torch.render.api import demand_binning, measure_binning_demand

    b = demand_binning(*measure_binning_demand(args, cams, tile=tile), tile=tile)
    seen, refs = (), {}
    for kernel, label, fwd_name, bwd_name in (("grid", "K2", "composite_fwd", "composite_bwd"),
                                              ("manual", "K4", "composite_manual_fwd",
                                               "composite_manual_bwd")):
        case = table_case(args, cams, dataclasses.replace(b, kernel=kernel),
                          getattr(composite, f"{fwd_name}_cuda"))
        torch.cuda.synchronize()
        where = f"{label} {cams.width}x{cams.height}, V={cams.num_views}, tile {tile}"
        inputs = (*case["kin"], *case["out"], *case["cot"], case["offsets"], case["counts"],
                  case["lane"])
        if seen and all(map(torch.equal, seen, inputs)):
            print(f"  {where}: inputs, outputs and cotangents bitwise K1's; the plain outputs"
                  f" reused", flush=True)
        else:
            seen = inputs
            refs = {"fwd": getattr(composite, f"{fwd_name}_plain")(*case["kin"], **case["geo"])}
        check_errors(compare(case["out"], refs["fwd"]), f"{where}, forward")
        compare_table_bwd(where, case, getattr(composite, f"{bwd_name}_cuda"),
                          getattr(composite, f"{bwd_name}_plain"), ("cuda", kernel), refs)
        del case


def table_bwd_bound(kin, geo, last, n_live):
    """A table backward's work and bound: (evaluations, live steps, bytes,
    FP32 ops, bytes ms, ops ms).  Bytes: the table, each pair's gid, the
    segments, the per-pixel inputs and cotangents read once, the rows
    written once."""
    v, n, rec = kin[0].shape
    p = kin[1].shape[1]
    c = rec - 7
    evals, live = bwd_work(kin[2], last, geo, n_live)
    hw = geo["width"] * geo["height"]
    pairs = int(kin[3][:, -1].sum())
    b_bytes = 4 * (v * n * rec + pairs + 2 * kin[2].numel() + c + v * hw * (c + 4) + v * p * rec)
    b_ops = OPS_PER_EVAL * evals + ops_bwd_per_live(c) * live
    return (evals, live, b_bytes, b_ops, 1e3 * b_bytes / PEAK_BYTES_S,
            1e3 * b_ops / PEAK_FP32_FLOPS)


def measure_bwd_tile(label, case, fwd_plain, bwd, bwd_plain, time_plain=False, n_live=None):
    """A table backward at ``case``'s tile: its rows against the plain
    version's (1e-4 scaled per row), its time and its bound there; with
    ``time_plain`` the plain version's time too (the run compared, timed).
    ``n_live``: the forward's contributions per pixel, if already counted."""
    import torch

    from splatpu_torch.tools.measure import cuda_ms, row_scaled_err

    kin, geo, cot, (tfin, last) = case["kin"], case["geo"], case["cot"], case["fwd"]
    if n_live is None:
        *_, n_live = fwd_plain(*kin, **geo, with_counts=True)
    run = lambda: bwd(*kin, tfin, last, *cot, **geo)  # noqa: E731
    rows = run()
    torch.cuda.synchronize()
    ref = {}

    def run_plain():
        ref["rows"] = bwd_plain(*kin, tfin, last, *cot, **geo)

    plain_ms = None
    if time_plain:
        plain_ms = cuda_ms(run_plain, reps=1, warmup=0)
    else:
        run_plain()
    rows_ref = ref.pop("rows")
    check_rows(label, {"rows": row_scaled_err(rows, rows_ref)})
    err = float((rows - rows_ref).abs().max())
    del rows_ref
    ms = cuda_ms(run, reps=20, warmup=3)
    evals, live, b_bytes, b_ops, t_bytes, t_ops = table_bwd_bound(kin, geo, last, n_live)
    bound = max(t_bytes, t_ops)
    v, p, rec = kin[0].shape[0], kin[1].shape[1], kin[0].shape[2]
    plain = f", plain {plain_ms:.2f} ms" if time_plain else ""
    print(f"  {label}: {ms:.4f} ms/launch{plain}; bound {bound:.4f} ms (bytes {b_bytes} ->"
          f" {t_bytes:.4f} ms, of them {4 * v * p * rec} the rows of every budget slot, which"
          f" the wrapper zeroes; FP32 ops {b_ops} -> {t_ops:.4f} ms); pairs"
          f" {int(kin[3][:, -1].sum())} of {v * p} slots, evaluations {evals}, live {live}",
          flush=True)
    out = {"ms": ms, "bound_ms": bound, "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "max_abs_err": err}
    if time_plain:
        out["plain_ms"] = plain_ms
    return out


def tile_numbers(numbers) -> dict:
    """``measure_fwd``'s numbers as an entry of a kernel's ``tiles``."""
    bound = numbers["bound"]
    out = {"ms": numbers["ms"], "bound_ms": bound[0],
           "bound_by": "operations" if bound[2] >= bound[1] else "bytes",
           "max_abs_err": numbers["err"]}
    if numbers["plain_ms"] is not None:
        out["plain_ms"] = numbers["plain_ms"]
    return out


def large_tiles_path(dev, args, cloud, views, net, head, base_cfg):
    """The large_tiles phase (module docstring).  Returns the numbers by
    tile of K1, K2, K4's forward and K4's backward, and {path: (counts,
    stats or log)}."""
    import torch

    import splatpu_torch.render.composite as composite
    from splatpu_torch.render.api import demand_binning, measure_binning_demand
    from splatpu_torch.train.stage2 import Stage2Config

    t0 = time.perf_counter()
    cams = rig_cams(dev, *COMPARE_SIZE, 5)
    for tile in LARGE_TILES:
        compare_tile(args, cams, tile)
        print(f"  (tile {tile} compared: {time.perf_counter() - t0:.2f} s into the phase)",
              flush=True)
    k1_tiles, k2_tiles, k4f_tiles, k4b_tiles = {}, {}, {}, {}
    cams = rig_cams(dev, *SERVE_SIZE, 5)
    for tile in LARGE_TILES:
        timed = tile in LARGE_TIMED
        b = demand_binning(*measure_binning_demand(args, cams, tile=tile), tile=tile)
        case = bwd_case(args, cams, dev, binning=b)
        kin, geo = case["kin"], case["geo"]
        # The plain forward's outputs and counts, and the plain backward's
        # rows, once each: K4's plain versions are K1's and K2's walk.
        fwd_ref = composite.composite_fwd_plain(*kin, **geo, with_counts=True)
        rows_ref = {}

        def fwd_plain(*a, with_counts=False, **k):
            return fwd_ref if with_counts else composite.composite_fwd_plain(*a, **k)

        def bwd_plain(*a, **k):
            rows_ref["rows"] = composite.composite_bwd_plain(*a, **k)
            return rows_ref["rows"]

        k1, n_live = measure_fwd(f"K1 tile {tile} at the training shapes (budget {b.max_pairs})",
                                 composite.composite_fwd_cuda, fwd_plain, kin, geo, case["out"],
                                 table_bytes_in(kin), time_plain=timed, plain_reps=1)
        k1_tiles[str(tile)] = tile_numbers(k1)
        k2_tiles[str(tile)] = measure_bwd_tile(
            f"K2 tile {tile} at the training shapes", case, fwd_plain,
            composite.composite_bwd_cuda, bwd_plain, time_plain=timed, n_live=n_live)
        case4 = table_case(args, cams, dataclasses.replace(b, kernel="manual"),
                           composite.composite_manual_fwd_cuda)
        same = all(map(torch.equal, (*kin, *case["out"], *case["cot"]),
                       (*case4["kin"], *case4["out"], *case4["cot"])))
        print(f"  K4 tile {tile}: inputs, outputs and cotangents"
              f" {'bitwise K1' if same else 'not bitwise K1'}'s", flush=True)
        if not same:
            fwd_plain, bwd_plain = (composite.composite_manual_fwd_plain,
                                    composite.composite_manual_bwd_plain)
        k4f, _ = measure_fwd(f"K4 fwd tile {tile} at the training shapes",
                             composite.composite_manual_fwd_cuda, fwd_plain, case4["kin"],
                             case4["geo"], case4["out"], table_bytes_in(case4["kin"]),
                             time_plain=False)
        k4f_tiles[str(tile)] = tile_numbers(k4f)
        k4b_tiles[str(tile)] = measure_bwd_tile(
            f"K4 bwd tile {tile} at the training shapes", case4, fwd_plain,
            composite.composite_manual_bwd_cuda,
            (lambda *a, **k: rows_ref["rows"]) if same else bwd_plain, n_live=n_live)
        del case, case4, kin, fwd_ref, rows_ref
        print(f"  (tile {tile} timed: {time.perf_counter() - t0:.2f} s into the phase)", flush=True)
    torch.cuda.synchronize()

    out = {}
    expected = ("composite_fwd", "composite_bwd", "route_pairs")
    one_step = dict(total_iterations=1, timestep_count=1)
    for name, overrides in ((f"tile{LARGE_PATH_TILE}", {"tile": LARGE_PATH_TILE}),
                            ("tie_order_off", {"exact_tie_order": False})):
        print(f"  train_{name}: 1 step, binning_overrides {overrides}", flush=True)
        out[f"train_{name}"] = train_path(
            f"train_{name}", cloud, views[:1],
            dataclasses.replace(base_cfg, binning_overrides=overrides, **one_step), expected, 1)
        config = Stage2Config(timestep_count=1, renderer="cuda", quirk_compat=head["quirk_compat"],
                              binning_overrides=overrides)
        print(f"  serve_{name}: 1 timestep + t=0, binning_overrides {overrides}", flush=True)
        counts, stats = serve_path(f"serve_{name}", net, cloud, config, "composite_fwd", 1)
        b = stats["binning"]
        if (b.tile, b.exact_tie_order) != (overrides.get("tile", 32),
                                           overrides.get("exact_tie_order", True)):
            fail(f"serve_{name}: served with tile {b.tile}, exact_tie_order {b.exact_tie_order}")
        out[f"serve_{name}"] = (counts, stats)
    return k1_tiles, k2_tiles, k4f_tiles, k4b_tiles, out


def options_paths(cloud, views, base_cfg):
    """train_options: from the same start (the checkpoint's network, a fresh
    Adam) the three view stagings, map batching and a bfloat16 network;
    map's per-step losses against vmap's, and each staging's wall time per
    sequence iteration.  Returns {path: (counts, log)}."""
    import numpy as np

    expected = ("composite_fwd", "composite_bwd", "route_pairs")
    cfg = dataclasses.replace(base_cfg, total_iterations=STAGING_ITERATIONS,
                              timestep_count=OPTION_TIMESTEPS, view_staging="device")
    one = dict(total_iterations=1)
    staging = {"train_options_device": "device", "train_options_host": "host",
               "train_options_rotate": "device_rotate"}
    out = {}
    # The stagings get the views as the sequence loader gives them: float32.
    as_loaded = [[dataclasses.replace(v, image=v.image.astype(np.float32) / 255.0)
                  for v in per_t] for per_t in views[:OPTION_TIMESTEPS]]
    for name, changes, per_step in (
        ("train_options_vmap", one, 1),
        ("train_options_map", {"view_batching": "map", **one}, cfg.views_per_step),
        ("train_options_bf16", {"compute_dtype": "bfloat16", **one}, 1),
        ("train_options_device", {}, 1),
        ("train_options_host", {"view_staging": "host"}, 1),
        ("train_options_rotate", {"view_staging": "device_rotate", "resident_cameras": 8,
                                  "restage_every": 1}, 1),
    ):
        run_cfg = dataclasses.replace(cfg, **changes)
        print(f"  {name}: {changes or 'device staging'}", flush=True)
        out[name] = train_path(name, cloud, as_loaded if name in staging else
                               views[:OPTION_TIMESTEPS], run_cfg, expected,
                               run_cfg.total_iterations * OPTION_TIMESTEPS, per_step=per_step)
    if out["train_options_bf16"][1].net.config.compute_dtype != "bfloat16":
        fail("train_options: the bfloat16 run's network did not compute in bfloat16")
    for (step, vm), (_, mm) in zip(out["train_options_vmap"][1].steps,
                                   out["train_options_map"][1].steps):
        for key in ("total", "l1", "ssim", "rigidity"):
            rel = abs(mm[key] - vm[key]) / max(abs(vm[key]), 1e-30)
            if not rel <= 1e-5:
                fail(f"train_options step {step}: map {key} {mm[key]} vs vmap {vm[key]}"
                     f" (relative {rel:.3e} > 1e-5)")
    print("  map's per-step losses within 1e-5 relative of vmap's", flush=True)
    for name, mode in staging.items():
        log = out[name][1]
        wall = log.iteration_ms
        steps = [m["step_ms"] for _, m in log.steps]
        if len(wall) != STAGING_ITERATIONS - 1 or not all(np.isfinite(wall)):
            fail(f"{name}: wall times per iteration {wall}")
        print(f"  staging {mode}: wall ms per sequence iteration ({OPTION_TIMESTEPS} steps,"
              f" staging included) {[round(x, 2) for x in wall]}, median {np.median(wall):.2f};"
              f" step ms (CUDA events, the steps only) median {np.median(steps):.2f}",
              flush=True)
    return out


def cli_path(dev, cloud, head):
    """The cli phase (module docstring): returns the launch counts."""
    import json
    import tempfile

    import numpy as np
    import torch

    import splatpu_torch.cli.render as cli_render
    import splatpu_torch.cli.train as cli_train
    import splatpu_torch.train.stage2 as stage2
    from splatpu_torch.data.dataset import save_synthetic_sequence
    from splatpu_torch.io.checkpoint import load_checkpoint, save_cloud
    from splatpu_torch.io.images import have_pil, read_image
    from splatpu_torch.tools.train_scene import render_targets

    timed = {"load": [], "checkpoint": [], "payload": [], "put": []}

    def timer(fn, key):
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            timed[key].append(1e3 * (time.perf_counter() - t0))
            return out
        return wrapped

    with tempfile.TemporaryDirectory(prefix="splatpu_cli_") as tmp:
        tmp = Path(tmp)
        seq, out, ckpt = tmp / "config3", tmp / "out", tmp / "ckpt.msgpack"
        t0 = time.perf_counter()
        frames = render_targets(cloud, CLI_FRAMES, *SERVE_SIZE, impl="cuda", device=dev, start=0)
        images = np.stack([[v.image for v in per_t] for per_t in frames])
        suffix = ".jpg" if have_pil() else ".png"
        pc = torch.cat([cloud.means, cloud.colors, cloud.segmentation_masks[:, :1]], 1)
        save_synthetic_sequence(
            seq, images, np.zeros(images.shape[:2] + images.shape[3:], np.uint8),
            np.stack([[v.K for v in per_t] for per_t in frames]),
            np.stack([[v.w2c for v in per_t] for per_t in frames]), pc.cpu().numpy(),
            image_suffix=suffix)
        save_cloud(seq / "densified_initial_gaussian_cloud_parameters.npz", cloud)
        del frames, images
        print(f"  sequence: {CLI_FRAMES} frames x 27 cameras at {SERVE_SIZE[0]}x{SERVE_SIZE[1]}"
              f" ({suffix[1:]}, PIL {'present' if have_pil() else 'absent'}), cloud"
              f" {cloud.capacity} Gaussians; written in {time.perf_counter() - t0:.2f} s",
              flush=True)
        heads = (["--delta-scale", str(head["delta_scale"])]
                 + ([] if head["double_residual"] else ["--no-double-residual"])
                 + (["--zero-init-head"] if head["zero_init_head"] else [])
                 + (["--time-gate-head"] if head["time_gate_head"] else []))
        common = [str(head["lr"]), "128", "3", "-t", str(CLI_FRAMES - 1), "-o", str(out),
                  "--device", DEVICE, *heads]
        patched = {(cli_train, "load_timestep_views"): "load", (cli_train, "load_cloud"): "load",
                   (stage2, "save_checkpoint"): "checkpoint",
                   (stage2, "checkpoint_payload"): "payload", (stage2.HostPrefetch, "put"): "put"}
        originals = {k: getattr(*k) for k in [*patched, (cli_train, "train")]}
        for (mod, attr), key in patched.items():
            setattr(mod, attr, timer(getattr(mod, attr), key))
        ends = []  # per cli.train run, the iteration clock's marks

        def clocked_train(*a, **kw):
            ends.append([])
            return originals[(cli_train, "train")](*a, on_iteration=iteration_clock(ends[-1]),
                                                   **kw)

        cli_train.train = clocked_train
        try:
            torch.cuda.synchronize()
            zero_counts()
            t0 = time.perf_counter()
            cli_train.main(["config3", str(tmp), "2", "1", *common, "--view-staging", "host",
                            "--checkpoint-every", "1", "--checkpoint-path", str(ckpt)])
            first_s = time.perf_counter() - t0
            seq_it = int(load_checkpoint(ckpt)["seq_it"])
            run = out / "config3"
            n_first = len((run / "train_metrics.jsonl").read_text().splitlines())
            t0 = time.perf_counter()
            cli_train.main(["config3", str(tmp), "3", "1", *common,
                            "--view-staging", "device_rotate", "--resident-cameras", "8",
                            "--restage-every", "1", "--resume-from", str(ckpt)])
            second_s = time.perf_counter() - t0
            bundle = run / "deformation_network"
            t0 = time.perf_counter()
            cli_render.main([str(bundle), "--timesteps", str(CLI_FRAMES - 1), "--width",
                             str(SERVE_SIZE[0]), "--height", str(SERVE_SIZE[1]), "--device",
                             DEVICE])
            torch.cuda.synchronize()
            render_s = time.perf_counter() - t0
            counts = launch_counts()
        finally:
            for (mod, attr), fn in originals.items():
                setattr(mod, attr, fn)
        rows = [json.loads(x) for x in (run / "train_metrics.jsonl").read_text().splitlines()]
        steps = [r for r in rows if "total" in r]
        evals = [r for r in rows if "mean-image-loss" in r]
        resumed = [r["step"] for r in rows[n_first:] if "total" in r]
        print(f"  cli.train (host staging): {first_s:.2f} s; resumed (device_rotate): "
              f"{second_s:.2f} s; cli.render: {render_s:.2f} s; launches {counts}", flush=True)
        by_mode = {"host": [r["step_ms"] for r in steps if r["step"] <= 4],
                   "device_rotate": [r["step_ms"] for r in steps if r["step"] > 4]}
        for (mode, ms), marks in zip(by_mode.items(), ends):
            wall = [round(1e3 * (b - a), 2) for a, b in zip(marks, marks[1:])]
            print(f"  {mode} staging: ms per step (CUDA events, the steps only)"
                  f" {[round(x, 3) for x in ms]}, median {np.median(ms):.3f}; wall ms per"
                  f" sequence iteration after the first (staging and checkpoint write included)"
                  f" {wall or 'none: one iteration'}", flush=True)
        print(f"  checkpoint write ms: {[round(x, 3) for x in timed['checkpoint']]}; its payload"
              f" built in {[round(x, 3) for x in timed['payload']]}", flush=True)
        print(f"  host staging: each step's gather into pinned memory and copy start"
              f" (HostPrefetch.put, host clock) ms {[round(x, 3) for x in timed['put']]}",
              flush=True)
        print(f"  sequence load ms (cloud, then each timestep's 27 views, per run):"
              f" {[round(x, 3) for x in timed['load']]}", flush=True)
        print(f"  mean-image-loss rows: {[(r['step'], round(r['mean-image-loss'], 6)) for r in evals]}",
              flush=True)
        vis = run / "visualizations"
        videos = sorted(p.name for p in vis.iterdir() if p.suffix in (".mp4", ".gif"))
        print(f"  output: videos {videos}", flush=True)
        if len(videos) != 5:
            fail(f"cli: videos written {videos}, expected one per orbit camera")
        if seq_it != 1:
            fail(f"cli: the first run's checkpoint holds seq_it {seq_it}, expected 1")
        if [r["step"] for r in steps] != [1, 2, 3, 4, 5, 6] or resumed[:1] != [5]:
            fail(f"cli: logged steps {[r['step'] for r in steps]}, resumed {resumed}")
        if len(evals) != 2 * (CLI_FRAMES - 1):
            fail(f"cli: {len(evals)} mean-image-loss rows")
        if not all(np.isfinite(r[k]) for r in steps for k in ("total", "grad_norm")) or not all(
                np.isfinite(r["mean-image-loss"]) for r in evals):
            fail("cli: a non-finite loss or mean-image-loss")
        for f in ("densified_initial_gaussian_cloud_parameters.npz", "config.json",
                  "network_params.msgpack"):
            if not (bundle / f).is_file():
                fail(f"cli: bundle file {f} missing")
        if not (run / "config.json").is_file():
            fail("cli: config.json missing")
        worst = 0
        for cam in ("000", "090", "180", "270", "top"):
            for t in range(CLI_FRAMES):
                a = read_image(bundle / "renders" / "frames" / cam / f"{t:06d}.png").astype(int)
                b = read_image(vis / "frames" / cam / f"{t:06d}.png").astype(int)
                if a.shape != (SERVE_SIZE[1], SERVE_SIZE[0], 3) or a.shape != b.shape:
                    fail(f"cli: frame {cam}/{t} shapes {a.shape} {b.shape}")
                worst = max(worst, int(np.abs(a - b).max()))
        print(f"  cli.render frames vs cli.train's: max |d| {worst} uint8 levels", flush=True)
        if worst > 1:
            fail(f"cli: standalone render differs from the trainer's frames by {worst} levels")
    expected = {"composite_fwd", "composite_bwd", "route_pairs"}
    check_only(counts, expected, "cli")
    if counts["composite_bwd"] != 6 or counts["route_pairs"] != 6 or counts["composite_fwd"] < 6:
        fail(f"cli: launches {counts}, expected 6 backward and routing launches")
    return counts


def knn_native_check(dev):
    """knn_native (module docstring)."""
    import numpy as np
    import torch

    import splatpu_torch.neighbors.knn as knn_mod
    from splatpu_torch.neighbors import native

    t0 = time.perf_counter()
    if not native.available():
        fail("knn_native: the native kNN library did not build")
    build_s = time.perf_counter() - t0
    pts = torch.from_numpy(np.random.default_rng(KNN_POINTS).uniform(
        -1.0, 1.0, (KNN_POINTS, 3)).astype(np.float32)).to(dev)
    calls = []
    real = native.knn_native
    native.knn_native = lambda *a, **kw: calls.append(1) or real(*a, **kw)
    try:
        t0 = time.perf_counter()
        idx, d2 = knn_mod.knn(pts, KNN_K)
        torch.cuda.synchronize()
        native_s = time.perf_counter() - t0
    finally:
        native.knn_native = real
    if not calls or idx.device != pts.device:
        fail("knn_native: knn did not route 250,000 points to the native KD-tree")
    # The port's brute force on the card at this size: what knn would run
    # without the native route.
    t0 = time.perf_counter()
    bf_idx, _ = knn_mod.knn_bruteforce(pts, KNN_K)
    torch.cuda.synchronize()
    bruteforce_s = time.perf_counter() - t0
    bf_apart = int((bf_idx.long() != idx.long()).sum())
    del bf_idx
    # The card's brute force, two ways: in the tree's own float32 arithmetic
    # (d2 = dx dx + dy dy + dz dz of p - q, op by op; ties to the lower
    # index, as the tree's (d2, index) heap orders them), whose neighbours
    # must be the tree's exactly; and in float64, against which the tree's
    # squared distances must hold 1e-6 relative (its order can differ from
    # float64's only where two distances lie within float32 rounding).
    t0 = time.perf_counter()
    p64 = pts.double()
    sq = (p64 * p64).sum(1)
    ref_idx, ref64_idx = [], []
    rows_of = lambda r0, m: torch.arange(r0, r0 + m, device=dev)  # noqa: E731
    for r0 in range(0, KNN_POINTS, 512):
        q = pts[r0:r0 + 512]
        m = q.shape[0]
        diff = [pts[None, :, a] - q[:, None, a] for a in range(3)]
        d = diff[0] * diff[0] + diff[1] * diff[1] + diff[2] * diff[2]
        d[torch.arange(m, device=dev), rows_of(r0, m)] = float("inf")
        vals, ids = torch.topk(d, KNN_K + 8, dim=1, largest=False)
        ids, order = torch.sort(ids, dim=1)
        vals = torch.gather(vals, 1, order)
        _, order = torch.sort(vals, dim=1, stable=True)
        ref_idx.append(torch.gather(ids, 1, order)[:, :KNN_K])
        d64 = sq[r0:r0 + m, None] + sq[None] - 2.0 * (p64[r0:r0 + m] @ p64.T)
        d64[torch.arange(m, device=dev), rows_of(r0, m)] = float("inf")
        ref64_idx.append(torch.topk(d64, KNN_K, dim=1, largest=False).indices)
    ref_idx, ref64_idx = torch.cat(ref_idx), torch.cat(ref64_idx)
    exact64 = ((p64[idx.long()] - p64[:, None]) ** 2).sum(-1)
    torch.cuda.synchronize()
    brute_s = time.perf_counter() - t0
    mismatches = int((idx.long() != ref_idx).sum())
    near_ties = int((idx.long() != ref64_idx).sum())
    rel = float(((d2.double() - exact64).abs() / exact64).max())
    print(f"  {KNN_POINTS} points, k {KNN_K}: library build {build_s:.2f} s, knn (native"
          f" KD-tree, host, copies included) {native_s:.2f} s, knn_bruteforce on the card"
          f" {bruteforce_s:.2f} s (entries ordered otherwise than the tree's: {bf_apart}),"
          f" the reference brute forces on the card {brute_s:.2f} s;"
          f" index mismatches against the float32 brute force {mismatches}; squared distances"
          f" max relative {rel:.3e} against float64; entries ordered otherwise than by float64"
          f" distance (near ties) {near_ties}", flush=True)
    if mismatches:
        fail(f"knn_native: {mismatches} indices differ from the brute force's")
    if not rel <= 1e-6:
        fail(f"knn_native: squared distances {rel:.3e} relative from float64's, > 1e-6")


class Stage1Log:
    """A stage-1 logger: each iteration's metrics kept as device tensors and
    read after the run (so the loop is not synchronised per iteration),
    budget growths printed as they come."""

    def __init__(self):
        self.rows, self.growths = [], []

    def log(self, metrics, step):
        if "budget_growth" in metrics:
            print(f"  iteration {step}: budget growth -> {metrics}", flush=True)
            self.growths.append((step, dict(metrics)))
            return
        self.rows.append((step, metrics))

    def flush(self):
        pass

    def floats(self):
        return [(step, {k: float(v) for k, v in m.items()}) for step, m in self.rows]


def s1_capacity(n_points: int) -> int:
    return -(-int(n_points * S1_CAPACITY_FACTOR) // 256) * 256


def stage1_scene(dev, truth):
    """The config-2 scene (module docstring): (points, views with their
    targets on the card, scene radius)."""
    import torch

    from splatpu_torch.tools.train_scene import (
        render_stage1_targets,
        rig_scene_radius,
        stage1_points,
    )

    t0 = time.perf_counter()
    views = render_stage1_targets(truth, *SERVE_SIZE, impl="cuda", device=dev)
    torch.cuda.synchronize()
    pc = stage1_points(truth)
    radius = rig_scene_radius(*SERVE_SIZE)
    print(f"  config 2: {len(views)} cameras at {SERVE_SIZE[0]}x{SERVE_SIZE[1]}, targets rendered"
          f" in {time.perf_counter() - t0:.2f} s; {len(pc)} initial points of {truth.capacity},"
          f" capacity {s1_capacity(len(pc))}; scene radius {radius:.4f}", flush=True)
    if len(pc) != S1_POINTS or s1_capacity(len(pc)) != S1_CAPACITY:
        fail(f"config 2: {len(pc)} points, capacity {s1_capacity(len(pc))}")
    for v in views:
        if not (bool(torch.isfinite(v.image).all()) and bool(torch.isfinite(v.segmentation).all())):
            fail("config 2: non-finite targets")
    return pc, views, radius


def s1_budget(steps, cloud, pick, binning, name):
    """``binning`` grown as ``fit``'s overflow checks grow it (the span
    before the pairs) until one iteration's renders fit."""
    from splatpu_torch.render.binning import grow_for_span_overflow

    for _ in range(5):
        out = steps.forward_backward(cloud, pick, binning, param_grads=False).image
        if not bool(out.overflowed.any()):
            return binning
        span = bool(out.span_overflowed.any())
        binning = (grow_for_span_overflow(binning, cloud.capacity) if span else
                   dataclasses.replace(binning, max_pairs=min(binning.max_pairs * 2, 1 << 24)))
        print(f"  {name}: the {'span' if span else 'pair'} budget overflowed; grown to"
              f" max_pairs {binning.max_pairs}, max_span {binning.max_span}", flush=True)
    fail(f"stage1_step, {name}: the render still overflows after 5 growths")


class L1Signs:
    """Stage 1's per-view image loss with the L1 term's signs recorded in
    one run and replayed in the next.  Float rounding in the forward can
    flip sign(x - target) where a residual is near 0, which changes that
    pixel's L1 cotangent by 2 x 0.8 / (3 H W) however close the kernels
    are.  Recording, it is ``image_losses`` exactly; replaying, its value
    differs only on the flipped pixels, and both runs differentiate the
    same function."""

    def __init__(self):
        self.signs, self.replay, self.calls, self.flips = [], False, 0, []

    def __call__(self, rendered, target):
        import torch

        from splatpu_torch.core.ssim import ssim
        from splatpu_torch.train.losses import L1_WEIGHT, SSIM_WEIGHT

        r = rendered - target
        sign = torch.sign(r.detach())
        if self.replay:
            ref = self.signs[self.calls % len(self.signs)]
            self.flips.append(int((ref != sign).sum()))
            sign = ref
        else:
            self.signs.append(sign)
        self.calls += 1
        l1 = (sign * r).mean(dim=(1, 2, 3))
        return L1_WEIGHT * l1 + SSIM_WEIGHT * (1.0 - ssim(rendered, target, size_average=False))


def stage1_step_check(dev, truth, pc, views, radius):
    """stage1_step (module docstring)."""
    import numpy as np
    import torch

    import splatpu_torch.train.stage1 as stage1
    from splatpu_torch.core.types import cloud_from_arrays
    from splatpu_torch.render.api import resolve_binning
    from splatpu_torch.tools.measure import row_scaled_err
    from splatpu_torch.train.optim import Stage1Adam

    cap = s1_capacity(len(pc))
    staged = stage1.stage_views(views, dev)
    pick = torch.tensor([0], device=dev)
    # The truth renders its own targets exactly (zero loss, zero gradients):
    # its means are moved by a seeded N(0, 0.005^2) first.
    jitter = torch.from_numpy(np.random.default_rng(1).normal(
        0.0, 0.005, tuple(truth.means.shape)).astype(np.float32)).to(dev)
    clouds = {"initial cloud": stage1.initialize_cloud(pc, cap, device=dev),
              "truth moved, padded": cloud_from_arrays(
                  **dict(truth.param_dict(), means=truth.means + jitter), capacity=cap,
                  device=dev)}

    def steps_of(impl, cloud):
        return stage1.Stage1Steps(stage1.Stage1Config(renderer=impl), radius, staged,
                                  *SERVE_SIZE, Stage1Adam(cloud.param_dict()))

    def step(impl, cloud, binning):
        t0 = time.perf_counter()
        out = steps_of(impl, cloud).forward_backward(cloud, pick, binning)
        torch.cuda.synchronize()
        print(f"  {name}, {impl}: one iteration's renders and gradients in"
              f" {1e3 * (time.perf_counter() - t0):.1f} ms (host clock); pairs"
              f" {int(out.image.total_pairs.max())} of {binning.max_pairs}", flush=True)
        return out

    def grad_rows(got, ref):
        rows = {"means2d_offset": row_scaled_err(got.offset_grad, ref.offset_grad)}
        rows.update({k: row_scaled_err(g, ref.grads[k]) for k, g in got.grads.items()})
        return rows

    image_losses = stage1.image_losses
    for name, cloud in clouds.items():
        where = f"stage1_step, {name}"
        binning = s1_budget(steps_of("cuda", cloud), cloud, pick, resolve_binning(cap), name)
        got, again = step("cuda", cloud, binning), step("cuda", cloud, binning)
        same = {"total": torch.equal(got.total, again.total),
                "images": torch.equal(got.image.image, again.image.image)
                and torch.equal(got.segmentation.image, again.segmentation.image),
                "means2d_offset": torch.equal(got.offset_grad, again.offset_grad)}
        same.update({k: torch.equal(g, again.grads[k]) for k, g in got.grads.items()})
        if not all(same.values()):
            fail(f"{where}: two CUDA runs differ: {same}")
        print(f"  {where}: two CUDA runs bitwise identical in {list(same)}", flush=True)
        del again
        signs = L1Signs()
        stage1.image_losses = signs
        try:
            ref = step("plain", cloud, binning)
            signs.replay = True
            matched = step("cuda", cloud, binning)
        finally:
            stage1.image_losses = image_losses
        if bool(got.image.overflowed.any()):
            fail(f"{where}: the render overflowed its budget")
        rel = abs(float(got.total) - float(ref.total)) / abs(float(ref.total))
        errs = {tag: float((a.image - b.image).detach().abs().max())
                for tag, a, b in (("image", got.image, ref.image),
                                  ("segmentation", got.segmentation, ref.segmentation))}
        last = {tag: int((a.last_contributor != b.last_contributor).sum())
                for tag, a, b in (("image", got.image, ref.image),
                                  ("segmentation", got.segmentation, ref.segmentation))}
        print(f"  {where}: loss {float(got.total):.6f} (plain {float(ref.total):.6f}, relative"
              f" {rel:.3e}); max|d| " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f"; last mismatches {last}", flush=True)
        print(f"  {where}: L1 signs of the CUDA run's residuals other than the plain run's"
              f" (image, segmentation): {signs.flips}; its gradients with those left in: "
              + ", ".join(f"{k} {v:.3e}" for k, v in grad_rows(got, ref).items())
              + " (scaled per row)", flush=True)
        check_rows(f"{where}, gradients (both runs on the plain run's L1 signs)",
                   grad_rows(matched, ref))
        if not rel <= 1e-5:
            fail(f"{where}: loss relative error {rel:.3e} > 1e-5")
        if not max(errs.values()) <= TOL["image"]:
            fail(f"{where}: image error {errs} > {TOL['image']}")
        if any(last.values()):
            fail(f"{where}: last contributor differs on {last} pixels")
        if not float(got.offset_grad.abs().max()) > 0:
            fail(f"{where}: the means2d_offset gradient is zero")
        del got, ref, matched


def stage1_path(dev, pc, views, radius):
    """stage1 (module docstring): returns (counts, fitted cloud, final binning)."""
    import numpy as np
    import torch

    import splatpu_torch.train.stage1 as stage1

    cfg = stage1.Stage1Config(iterations=S1_ITERATIONS, capacity_factor=S1_CAPACITY_FACTOR,
                              renderer="cuda")
    log = Stage1Log()
    marks = []
    seen = {}
    real_dual = stage1.render_dual

    def spy(*a, config=None, **kw):
        seen["binning"] = config
        return real_dual(*a, config=config, **kw)

    def on_iteration(i, cloud, metrics):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((i, ev, time.perf_counter()))

    stage1.render_dual = spy
    try:
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        cloud, _ = stage1.fit(pc, views, radius, cfg, logger=log, on_iteration=on_iteration,
                              on_iteration_every=1, device=DEVICE)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        counts = launch_counts()
    finally:
        stage1.render_dual = real_dual
    rows = log.floats()
    mutation = cfg.densify.is_mutation_iter
    ev_ms = {b[0]: a[1].elapsed_time(b[1]) for a, b in zip(marks, marks[1:])}
    wall_ms = {b[0]: 1e3 * (b[2] - a[2]) for a, b in zip(marks, marks[1:])}
    plain_its = [i for i in ev_ms if i >= 20 and not mutation(i)]
    print(f"  fit: {S1_ITERATIONS} iterations in {fit_s:.2f} s wall (initialisation and"
          f" staging included); launches {counts}; final budget: max_pairs"
          f" {seen['binning'].max_pairs}, max_span {seen['binning'].max_span}", flush=True)
    print(f"  ms per non-mutation iteration after the first 20 ({len(plain_its)}): CUDA events"
          f" median {np.median([ev_ms[i] for i in plain_its]):.3f} (min"
          f" {min(ev_ms[i] for i in plain_its):.3f}, max {max(ev_ms[i] for i in plain_its):.3f}),"
          f" wall median {np.median([wall_ms[i] for i in plain_its]):.3f}", flush=True)
    by_step = dict(rows)
    for i in sorted(i for i in ev_ms if mutation(i)):
        m = by_step[i]
        print(f"  mutation {i}: {ev_ms[i]:.3f} ms CUDA events, {wall_ms[i]:.3f} ms wall; cloned"
              f" {int(m['cloned'])}, split {int(m['split'])}, pruned {int(m['pruned'])}, dropped"
              f" {int(m['dropped_for_capacity'])}; n_alive {int(m['n_alive'])}", flush=True)
    totals = [m["total_loss"] for _, m in rows]
    first, last = float(np.mean(totals[:20])), float(np.mean(totals[-20:]))
    print(f"  total_loss first {totals[0]:.6f}, last {totals[-1]:.6f}; mean of the first 20"
          f" {first:.6f}, of the last 20 {last:.6f}; growths {len(log.growths)}; n_alive at the"
          f" end {int(rows[-1][1]['n_alive'])}", flush=True)
    if [s for s, _ in rows] != list(range(S1_ITERATIONS)):
        fail("stage1: logged iterations are not 0..S1_ITERATIONS - 1")
    if not all(np.isfinite(t) for t in totals):
        fail("stage1: a non-finite loss")
    if not last < first:
        fail(f"stage1: the loss did not fall ({first} -> {last})")
    if rows[-1][1]["binning_overflow"]:
        fail("stage1: binning overflow left at the last iteration")
    if sum(1 for i in ev_ms if mutation(i)) != 2:
        fail("stage1: expected the mutations at 500 and 600")
    expected = {"composite_fwd", "composite_bwd", "route_pairs"}
    for k in expected:
        if counts[k] != 2 * S1_ITERATIONS:
            fail(f"stage1: {k} launched {counts[k]} times, expected 2 per iteration")
    check_only(counts, expected, "stage1")
    return counts, cloud, seen["binning"]


def stage1_options_path(dev, pc, views, radius):
    """stage1_options (module docstring): returns {path: counts}."""
    import tempfile

    import numpy as np
    import torch

    import splatpu_torch.train.stage1 as stage1
    from splatpu_torch.core.types import Camera, activate_cloud
    from splatpu_torch.growth.densify import DensifyConfig
    from splatpu_torch.io.checkpoint import load_checkpoint
    from splatpu_torch.render.api import measure_binning_demand, resolve_binning

    cap = s1_capacity(len(pc))
    # The window ends past the last iteration: its final prune (opacity
    # under 0.25) just after the reset to 0.01 at 20 would leave no
    # Gaussian alive to compare.
    dcfg = DensifyConfig(mutate_start=10, mutate_every=10, opacity_reset_every=20,
                         prune_big_start=20, window_end=S1_OPTION_ITERATIONS[1])
    cams = Camera(w2c=torch.from_numpy(np.stack([v.w2c for v in views])).to(dev),
                  K=torch.from_numpy(np.stack([v.K for v in views])).to(dev),
                  width=SERVE_SIZE[0], height=SERVE_SIZE[1])
    demand, _ = measure_binning_demand(
        activate_cloud(stage1.initialize_cloud(pc, cap, device=dev)), cams)
    quarter = max(256, demand // 4 // 256 * 256)
    binning = dataclasses.replace(resolve_binning(cap), max_pairs=quarter)
    print(f"  pair demand of the initial cloud (max over the views) {demand}; budget {quarter}",
          flush=True)
    out = {}
    with tempfile.TemporaryDirectory(prefix="splatpu_s1_") as tmp:
        ckpt = str(Path(tmp) / "stage1.msgpack")
        base = stage1.Stage1Config(
            iterations=S1_OPTION_ITERATIONS[0], capacity_factor=S1_CAPACITY_FACTOR,
            renderer="cuda", densify=dcfg, views_per_step=S1_OPTION_VIEWS, binning=binning,
            overflow_check_every=5, checkpoint_every=S1_OPTION_ITERATIONS[0],
            checkpoint_path=ckpt)
        torch.cuda.synchronize()
        zero_counts()
        log = Stage1Log()
        stage1.fit(pc, views, radius, base, logger=log, device=DEVICE)
        saved = load_checkpoint(ckpt)
        print("  (the schedule resets every opacity to 0.01 at 20 and mutates again at 30)",
              flush=True)
        print(f"  first run: {S1_OPTION_ITERATIONS[0]} iterations; checkpoint i"
              f" {int(saved['i'])}, growths {int(saved['growths'])}, max_pairs"
              f" {int(saved['max_pairs'])}, max_span {int(saved['max_span'])}", flush=True)
        for step, m in log.floats():
            if "cloned" in m:
                print(f"  mutation {step}: cloned {int(m['cloned'])}, split {int(m['split'])},"
                      f" pruned {int(m['pruned'])}; n_alive {int(m['n_alive'])}", flush=True)
        if int(saved["i"]) != S1_OPTION_ITERATIONS[0] - 1 or int(saved["growths"]) < 1 or int(
                saved["max_pairs"]) <= quarter:
            fail("stage1_options: the checkpoint does not hold the iteration and a grown budget")
        resumed = []
        for run in range(2):
            log = Stage1Log()
            seen = []
            real_dual = stage1.render_dual

            def spy(*a, config=None, **kw):
                seen.append((config.max_pairs, config.max_span))
                return real_dual(*a, config=config, **kw)

            stage1.render_dual = spy
            try:
                cloud, _ = stage1.fit(pc, views, radius, dataclasses.replace(
                    base, iterations=S1_OPTION_ITERATIONS[1], checkpoint_every=0), logger=log,
                    resume_from=ckpt, device=DEVICE)
            finally:
                stage1.render_dual = real_dual
            rows = log.floats()
            growth_ids = [int(m["budget_growth"]) for _, m in log.growths]
            print(f"  resume {run + 1}: iterations {rows[0][0]}..{rows[-1][0]}, first budget"
                  f" {seen[0]}, growths {growth_ids}, total_loss {rows[0][1]['total_loss']:.6f}"
                  f" -> {rows[-1][1]['total_loss']:.6f}, n_alive {int(rows[-1][1]['n_alive'])}",
                  flush=True)
            if rows[0][0] != S1_OPTION_ITERATIONS[0] or seen[0] != (
                    int(saved["max_pairs"]), int(saved["max_span"])):
                fail(f"stage1_options: resume {run + 1} did not carry i and the budget")
            if any(g <= int(saved["growths"]) for g in growth_ids):
                fail(f"stage1_options: resume {run + 1} restarted the growth count")
            resumed.append(cloud)
        torch.cuda.synchronize()
        out["stage1_options"] = launch_counts()
    a, b = resumed
    if not (int(a.n_alive()) > 0 and int(b.n_alive()) > 0):
        fail(f"stage1_options: the resumed clouds hold {int(a.n_alive())} and {int(b.n_alive())}"
             " alive Gaussians")
    same = {k: torch.equal(getattr(a, k), getattr(b, k))
            for k in ("alive", "means", "colors", "segmentation_masks", "rotation_quaternions",
                      "opacity_logits", "log_scales")}
    print(f"  the two resumed clouds at {S1_OPTION_ITERATIONS[1]} ({int(a.n_alive())} alive):"
          f" bitwise equal {same}", flush=True)
    if not all(same.values()):
        fail("stage1_options: two resumes from one checkpoint differ")
    n_its = S1_OPTION_ITERATIONS[0] + 2 * (S1_OPTION_ITERATIONS[1] - S1_OPTION_ITERATIONS[0])
    expected = {"composite_fwd", "composite_bwd", "route_pairs"}
    for k in expected:
        if out["stage1_options"][k] != 2 * n_its:
            fail(f"stage1_options: {k} launched {out['stage1_options'][k]} times in {n_its}"
                 " iterations")
    check_only(out["stage1_options"], expected, "stage1_options")
    for name, changes, expected in (
        ("stage1_manual", dict(binning_overrides={"kernel": "manual"}),
         {"composite_manual_fwd", "composite_manual_bwd", "route_pairs"}),
        ("stage1_padded", dict(renderer="cuda_padded", binning_overrides={"tile": 16}),
         {"padded_fwd", "padded_bwd", "route_pairs"}),
    ):
        cfg = stage1.Stage1Config(**{
            "iterations": S1_PATH_ITERATIONS, "capacity_factor": S1_CAPACITY_FACTOR,
            "renderer": "cuda", "densify": dcfg, "views_per_step": S1_OPTION_VIEWS, **changes})
        log = Stage1Log()
        torch.cuda.synchronize()
        zero_counts()
        stage1.fit(pc, views, radius, cfg, logger=log, device=DEVICE)
        torch.cuda.synchronize()
        counts = out[name] = launch_counts()
        rows = log.floats()
        print(f"  {name} ({changes}): losses {[round(m['total_loss'], 6) for _, m in rows]};"
              f" launches {counts}", flush=True)
        if not all(np.isfinite(m["total_loss"]) for _, m in rows):
            fail(f"{name}: a non-finite loss")
        for k in expected:
            if counts[k] != 2 * S1_PATH_ITERATIONS:
                fail(f"{name}: {k} launched {counts[k]} times, expected 2 per iteration")
        check_only(counts, expected, name)
    return out


def cli_densify_path(dev, pc, views):
    """cli_densify (module docstring): returns the launch counts."""
    import json
    import tempfile

    import numpy as np
    import torch

    import splatpu_torch.cli.densify as cli_densify
    import splatpu_torch.train.stage1 as stage1
    from splatpu_torch.data.dataset import save_synthetic_sequence
    from splatpu_torch.io.checkpoint import load_checkpoint, load_cloud
    from splatpu_torch.io.images import have_pil

    timed = {"load": [], "checkpoint": []}

    def timer(fn, key):
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            timed[key].append(1e3 * (time.perf_counter() - t0))
            return out
        return wrapped

    with tempfile.TemporaryDirectory(prefix="splatpu_densify_") as tmp:
        seq, ckpt = Path(tmp) / "config2", Path(tmp) / "stage1.msgpack"
        t0 = time.perf_counter()
        images = torch.stack([v.image for v in views])
        images = torch.round(torch.clamp(images, 0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy()
        segs = (torch.stack([v.segmentation[0] for v in views]) > 0.5).cpu().numpy()
        suffix = ".jpg" if have_pil() else ".png"
        save_synthetic_sequence(seq, images[None], segs[None].astype(np.float32),
                                np.stack([v.K for v in views])[None],
                                np.stack([v.w2c for v in views])[None], pc, image_suffix=suffix)
        print(f"  sequence: 1 frame x {len(views)} cameras ({suffix[1:]}), {len(pc)} points;"
              f" written in {time.perf_counter() - t0:.2f} s", flush=True)
        patched = {(cli_densify, "load_timestep_views"): "load",
                   (cli_densify, "load_initial_point_cloud"): "load",
                   (stage1, "save_checkpoint"): "checkpoint"}
        originals = {k: getattr(*k) for k in patched}
        for (mod, attr), key in patched.items():
            setattr(mod, attr, timer(getattr(mod, attr), key))
        try:
            torch.cuda.synchronize()
            zero_counts()
            common = [str(seq), "--capacity-factor", str(S1_CAPACITY_FACTOR), "--device", DEVICE,
                      "--checkpoint-path", str(ckpt)]
            t0 = time.perf_counter()
            cli_densify.main([*common, "--iterations", str(S1_CLI_ITERATIONS[0]),
                              "--checkpoint-every", "10"])
            first_s = time.perf_counter() - t0
            saved_i = int(load_checkpoint(ckpt)["i"])
            t0 = time.perf_counter()
            cli_densify.main([*common, "--iterations", str(S1_CLI_ITERATIONS[1]),
                              "--resume-from", str(ckpt)])
            torch.cuda.synchronize()
            second_s = time.perf_counter() - t0
            counts = launch_counts()
        finally:
            for (mod, attr), fn in originals.items():
                setattr(mod, attr, fn)
        rows = [json.loads(x) for x in (seq / "densify_metrics.jsonl").read_text().splitlines()]
        written = seq / "densified_initial_gaussian_cloud_parameters.npz"
        t0 = time.perf_counter()
        cloud = load_cloud(written, device=dev)
        load_cloud_ms = 1e3 * (time.perf_counter() - t0)
    print(f"  cli.densify: {first_s:.2f} s, resumed {second_s:.2f} s; launches {counts}",
          flush=True)
    print(f"  sequence load ms (points, then the 27 views, per run):"
          f" {[round(x, 3) for x in timed['load']]}; checkpoint write ms (201,216-slot state):"
          f" {[round(x, 3) for x in timed['checkpoint']]}; written cloud read in"
          f" {load_cloud_ms:.3f} ms", flush=True)
    print(f"  metrics rows {len(rows)}, total_loss {rows[0]['total_loss']:.6f} ->"
          f" {rows[-1]['total_loss']:.6f}; written cloud {cloud.capacity} slots,"
          f" {int(cloud.n_alive())} alive", flush=True)
    if saved_i != S1_CLI_ITERATIONS[0] - 1:
        fail(f"cli_densify: the checkpoint holds i {saved_i}")
    if [r["step"] for r in rows] != list(range(S1_CLI_ITERATIONS[1])):
        fail(f"cli_densify: logged steps {[r['step'] for r in rows]}")
    if not all(np.isfinite(r["total_loss"]) for r in rows):
        fail("cli_densify: a non-finite loss")
    if cloud.capacity % 256 or int(cloud.n_alive()) != int(rows[-1]["n_alive"]):
        fail("cli_densify: the written cloud does not hold the fit's alive Gaussians")
    expected = {"composite_fwd", "composite_bwd", "route_pairs"}
    for k in expected:
        if counts[k] != 2 * S1_CLI_ITERATIONS[1]:
            fail(f"cli_densify: {k} launched {counts[k]} times")
    check_only(counts, expected, "cli_densify")
    return counts


def rank_totals(results) -> dict:
    """The ranks' launch counts, summed."""
    return {k: sum(r["counts"][k] for r in results) for k in results[0]["counts"]}


def check_ranks(results, where: str) -> None:
    """Every rank imported nothing of JAX and reported its place."""
    for i, r in enumerate(results):
        if r["jax_modules"] or r["rank"] != i:
            fail(f"{where}: rank {i} reports rank {r['rank']}, JAX modules {r['jax_modules']}")


def launch_ranks(fn, n, args, where: str):
    """``dist.launch`` of ``n`` ranks on the card, a rendezvous directory
    of its own, every rank's output printed; the ranks' results."""
    import tempfile

    from splatpu_torch.dist.launch import launch

    with tempfile.TemporaryDirectory(prefix="splatpu_ranks_") as rdv:
        t0 = time.perf_counter()
        results = launch(fn, n, args, rdv, device=DEVICE, timeout_s=DIST_TIMEOUT_S)
    counts = [r["counts"] if "counts" in r else r["runs"][0]["counts"] for r in results]
    print(f"  {where}: {n} ranks on one card over gloo, {time.perf_counter() - t0:.2f} s wall"
          f" (start-up included); launches per rank"
          f" {[{k: v for k, v in c.items() if v} for c in counts]}", flush=True)
    check_ranks(results, where)
    return results


def dist_render_path(dev, cloud):
    """dist_render (module docstring): the launches summed over the ranks."""
    import numpy as np
    import torch

    from splatpu_torch.core.types import activate_cloud
    from splatpu_torch.dist import ranks
    from splatpu_torch.render.api import demand_binning, measure_binning_demand, render
    from splatpu_torch.render.exact import composite_inputs
    from splatpu_torch.train.inference import create_orbit_cameras

    args = activate_cloud(cloud)
    cam = next(iter(create_orbit_cameras(*SERVE_SIZE, device=dev).values()))
    binning = demand_binning(*measure_binning_demand(args, cam))
    with torch.no_grad():
        full = render(args, cam, impl=DIST_RENDERER, config=binning)
        _, k = composite_inputs(args, cam, binning)
        gid = k["gid"].long()
        last = full.last_contributor
        full_gid = torch.where(last >= 0, torch.gather(gid, 1, last.clamp(min=0).reshape(
            gid.shape[0], -1)).reshape(last.shape), -1).cpu().numpy()
    image = full.image.cpu().numpy()
    args_np = {f: getattr(args, f).detach().cpu().numpy()
               for f in ("means3d", "colors", "rotations", "opacities", "scales")}
    camera = dict(w2c=cam.w2c.cpu().numpy(), K=cam.K.cpu().numpy(), width=SERVE_SIZE[0],
                  height=SERVE_SIZE[1])
    total = {k: 0 for k in launch_counts()}
    w, h = SERVE_SIZE
    print(f"  one orbit view at {w}x{h}, {cloud.capacity} Gaussians, budget {binning.max_pairs}"
          f" pairs, tile {binning.tile}", flush=True)
    for n in DIST_STRIPS:
        results = launch_ranks(ranks.strips_on_rank, n, (args_np, camera, n, DIST_RENDERER,
                                                         binning, DEVICE),
                               f"{n} strips")
        bad = []
        for r in results:
            sh = r["strip"].shape[-2]  # the last strip ends with the image
            rows = slice(min(r["row0"], h), min(r["row0"] + sh, h))  # empty below the image
            n_rows = rows.stop - rows.start
            own = (float(np.abs(r["strip"][..., :n_rows, :] - image[..., rows, :]).max())
                   if n_rows else 0.0)
            moved = int((r["image"][..., r["row0"]:r["row0"] + sh, :] != r["strip"]).sum())
            err = float(np.abs(r["image"][..., :h, :] - image).max())
            mism = int((r["last_gid"][..., :n_rows, :] != full_gid[..., rows, :]).sum())
            print(f"  {n} strips, rank {r['rank']} (image rows {rows.start}..{rows.stop - 1}):"
                  f" its strip max|d| {own:.3e} against the whole render's rows; the gathered"
                  f" image holds it with {moved} values changed and lies {err:.3e} from the"
                  f" whole render; last contributor (Gaussian id) differs on {mism} of"
                  f" {n_rows * w} pixels", flush=True)
            if not (own <= TOL["image"] and err <= TOL["image"]) or moved:
                bad.append(r["rank"])
            if r["counts"]["composite_fwd"] != 1:
                fail(f"dist_render: rank {r['rank']} launched K1 {r['counts']['composite_fwd']}"
                     " times, expected once")
        if bad:
            fail(f"dist_render: {n} strips, ranks {bad} outside {TOL['image']} of the whole"
                 " render, or their strips changed by the gather")
        for k, v in rank_totals(results).items():
            total[k] += v
    check_only(total, {"composite_fwd"}, "dist_render")
    return total


def dist_train_path(dev, cloud, base_cfg, card, name, cameras, tiles, timesteps):
    """dist_train / dist_2d (module docstring): the launches summed over the
    ranks of the sharded runs."""
    from splatpu_torch.io.checkpoint import load_stage2_net
    from splatpu_torch.tools.train_scene import render_targets

    cfg = dataclasses.replace(base_cfg, total_iterations=DIST_ITERATIONS,
                              timestep_count=timesteps, renderer=DIST_RENDERER)
    # The checkpoint's network, as the train phase starts from: a fresh
    # zero-init head would make the first step's gradients of every other
    # layer exactly 0, and Adam turns the next near-0 ones into whole steps.
    init = {k: v.numpy() for k, v in load_stage2_net(RUN / "stage2_ckpt.msgpack").items()}
    views = render_targets(cloud, timesteps, *SERVE_SIZE, impl="cuda", device=dev)
    print(f"  config 3 at full width: {timesteps} timesteps x {DIST_ITERATIONS} iterations,"
          f" 5 of 27 views at {SERVE_SIZE[0]}x{SERVE_SIZE[1]} per step (padded to 6), the"
          f" checkpoint's network (hidden {cfg.hidden_dim} x {cfg.residual_blocks} blocks)"
          f" with a fresh Adam; mesh {cameras} cameras x {tiles} tiles", flush=True)
    return hold_sharded(name, CLOUD, views, cfg, init, cameras, tiles, card)[0]


def hold_sharded(name, cloud_path, views, cfg, init, cameras, tiles, card):
    """``cfg``'s run from ``init`` (a network state of numpy arrays) on
    ``views`` in this process against two runs over a (cameras, tiles)
    grid of ranks (module docstring, dist_train): (the launches summed
    over the ranks of the first sharded run, the single run's rows)."""
    import tempfile

    import numpy as np
    import torch

    from splatpu_torch.dist import ranks

    n_steps = cfg.total_iterations * cfg.timestep_count
    with tempfile.TemporaryDirectory(prefix="splatpu_dist_") as tmp:
        vpath = str(Path(tmp) / "views.npz")
        ranks.save_views(vpath, views)
        del views
        torch.cuda.synchronize()
        single = ranks.train_on_rank(str(cloud_path), vpath, cfg, DEVICE, init)["runs"][0]
        results = launch_ranks(ranks.train_on_rank, cameras * tiles,
                               (str(cloud_path), vpath, dataclasses.replace(
                                   cfg, mesh_cameras=cameras, mesh_tiles=tiles), DEVICE, init, 2),
                               name)
    runs = [r["runs"] for r in results]
    rows = runs[0][0]["rows"]
    if [s for s, _ in rows] != [s for s, _ in single["rows"]] or len(rows) != n_steps:
        fail(f"{name}: logged steps {[s for s, _ in rows]}, single {[s for s, _ in single['rows']]}")
    worst = 0.0
    for (step, a), (_, b) in zip(single["rows"], rows):
        rel = abs(b["total"] - a["total"]) / abs(a["total"])
        worst = max(worst, rel)
        print(f"  step {step}: loss single {a['total']:.7f}, sharded {b['total']:.7f} (rel"
              f" {rel:.2e}); grad_norm {a['grad_norm']:.5e} / {b['grad_norm']:.5e}; step ms"
              f" {a['step_ms']:.2f} / {b['step_ms']:.2f}", flush=True)
        if not rel <= 1e-5:
            fail(f"{name} step {step}: loss {b['total']} against {a['total']} (rel {rel:.2e})")
        if b["binning_overflow"]:
            fail(f"{name} step {step}: binning overflow")
    ratios = {}
    for k, v in single["params"].items():
        moved = float(np.abs(v - init[k]).max())
        d = float(np.abs(runs[0][0]["params"][k] - v).max())
        ratios[k] = d / moved if moved else (0.0 if d == 0 else np.inf)
    worst_key = max(ratios, key=ratios.get)
    ratio = ratios[worst_key]
    a, b, s0 = (single["params"][worst_key], runs[0][0]["params"][worst_key], init[worst_key])
    at = np.unravel_index(int(np.argmax(np.abs(b - a))), a.shape)
    print(f"  {name}: the worst element, {worst_key}{list(at)}, moved {float(a[at] - s0[at]):.3e}"
          f" in the single run and {float(b[at] - s0[at]):.3e} sharded; the tensor's largest"
          f" move {float(np.abs(a - s0).max()):.3e}", flush=True)
    equal_ranks = all(np.array_equal(rr[0]["params"][k], runs[0][0]["params"][k])
                      for rr in runs for k in init)
    equal_runs = all(np.array_equal(rr[1]["params"][k], rr[0]["params"][k])
                     for rr in runs for k in init)
    ms = lambda rs: float(np.median([m["step_ms"] for _, m in rs]))  # noqa: E731
    print(f"  {name}: losses within {worst:.2e} relative; parameters within {ratio:.2e} of their"
          f" movement (gate 2e-2; {worst_key}); every rank's parameters bitwise equal"
          f" {equal_ranks}; two sharded runs bitwise equal {equal_runs}", flush=True)
    print(f"  {name}: ms per step (CUDA events, median of {n_steps}) single process"
          f" {ms(single['rows']):.2f}, {cameras * tiles} ranks sharing the card"
          f" {ms(rows):.2f} (second run {ms(runs[0][1]['rows']):.2f}); wall s per run single"
          f" {single['seconds']:.2f}, sharded {runs[0][0]['seconds']:.2f}; {card}", flush=True)
    if not ratio <= 2e-2:
        fail(f"{name}: parameters {ratio:.2e} of their movement from the single-process run")
    if not (equal_ranks and equal_runs):
        fail(f"{name}: ranks or runs differ")
    expected = {"composite_fwd", "composite_bwd", "route_pairs"}
    for i, r in enumerate(results):
        for run in r["runs"]:
            if any(run["counts"][k] != n_steps for k in expected):
                fail(f"{name}: rank {i} launched {run['counts']} in {n_steps} steps")
    total = {k: sum(r["runs"][0]["counts"][k] for r in results)
             for k in results[0]["runs"][0]["counts"]}
    check_only(total, expected, name)
    return total, single["rows"]


def dist_stage1_path(dev, pc, views, radius, card):
    """dist_stage1 (module docstring): the launches summed over the ranks."""
    import tempfile

    import numpy as np
    import torch

    import splatpu_torch.train.stage1 as stage1
    from splatpu_torch.core.types import Camera, activate_cloud
    from splatpu_torch.dist import ranks
    from splatpu_torch.growth.densify import DensifyConfig
    from splatpu_torch.render.api import demand_binning, measure_binning_demand

    cap = s1_capacity(len(pc))
    cams = Camera(w2c=torch.from_numpy(np.stack([v.w2c for v in views])).to(dev),
                  K=torch.from_numpy(np.stack([v.K for v in views])).to(dev),
                  width=SERVE_SIZE[0], height=SERVE_SIZE[1])
    demand = measure_binning_demand(
        activate_cloud(stage1.initialize_cloud(pc, cap, device=dev)), cams)
    # Stage 1's Adam (eps 1e-15) moves a parameter whose gradient is
    # rounding noise by a whole step with the noise's sign, so the strips'
    # summation order parts the parameters from the single run's more with
    # every iteration while the images stay identical; the JAX package
    # holds them to its gate after 4 iterations, and so does this phase.
    # Clones only (every densified Gaussian counts as small): a split places
    # its children through the rotation of an isotropic Gaussian, moved so.
    # The budget holds the cloned cloud: an overflow drops other splats in
    # the strips than in the whole render.
    cfg = stage1.Stage1Config(
        iterations=DIST_S1_ITERATIONS, capacity_factor=S1_CAPACITY_FACTOR, renderer=DIST_RENDERER,
        binning=demand_binning(4 * demand[0], demand[1]), densify=DensifyConfig(
            mutate_start=DIST_S1_MUTATE, mutate_every=DIST_S1_MUTATE,
            window_end=DIST_S1_MUTATE, clone_scale_factor=1e3))
    print(f"  config 2 at full width: {len(views)} views at {SERVE_SIZE[0]}x{SERVE_SIZE[1]},"
          f" {len(pc)} points, {cap} slots, {DIST_S1_ITERATIONS} iterations, the mutation at"
          f" {DIST_S1_MUTATE} (clones only); budget"
          f" {cfg.binning.max_pairs} pairs, span {cfg.binning.max_span} (initial demand {demand})",
          flush=True)
    as_np = lambda x: x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)  # noqa: E731
    with tempfile.TemporaryDirectory(prefix="splatpu_dist_s1_") as tmp:
        vpath = str(Path(tmp) / "views.npz")
        ranks.save_views(vpath, [[dict(w2c=as_np(v.w2c), K=as_np(v.K), width=v.width,
                                       height=v.height, image=as_np(v.image),
                                       segmentation=as_np(v.segmentation)) for v in views]])
        torch.cuda.synchronize()
        single = ranks.fit_on_rank(pc, vpath, radius, cfg, device=DEVICE)
        results = launch_ranks(ranks.fit_on_rank, 2, (pc, vpath, radius, dataclasses.replace(
            cfg, mesh_tiles=2), DEVICE), "dist_stage1")
    rows = results[0]["rows"]
    if [s for s, _ in rows] != list(range(DIST_S1_ITERATIONS)):
        fail(f"dist_stage1: logged iterations {[s for s, _ in rows]}")
    worst = 0.0
    for (i, a), (_, b) in zip(single["rows"], rows):
        rel = abs(b["total_loss"] - a["total_loss"]) / abs(a["total_loss"])
        worst = max(worst, rel)
        if b["binning_overflow"] or a["binning_overflow"]:
            fail(f"dist_stage1 iteration {i}: binning overflow")
        if "cloned" in a:
            print(f"  mutation {i}: single cloned {int(a['cloned'])}, split {int(a['split'])},"
                  f" pruned {int(a['pruned'])}, n_alive {int(a['n_alive'])}; strips cloned"
                  f" {int(b['cloned'])}, split {int(b['split'])}, pruned {int(b['pruned'])},"
                  f" n_alive {int(b['n_alive'])}", flush=True)
        if not rel <= 1e-5:
            fail(f"dist_stage1 iteration {i}: loss {b['total_loss']} against {a['total_loss']}")
    mutations = [m for _, m in single["rows"] if "cloned" in m]
    if not mutations or not any(m["cloned"] for m in mutations):
        fail("dist_stage1: no clone happened")
    for i, mask in single["alive"].items():
        for r in results:
            d = np.nonzero(r["alive"][i] != mask)[0]
            if len(d):
                fail(f"dist_stage1: alive masks differ after mutation {i} at {len(d)} slots"
                     f" (first {d[:10].tolist()})")
        if not mask.any():
            fail(f"dist_stage1: no Gaussian alive after mutation {i}")
    same = all(np.array_equal(r["cloud"][k], results[0]["cloud"][k]) for r in results
               for k in results[0]["cloud"])
    gate = {}
    for k in ("means", "opacity_logits"):
        a, b = single["cloud"][k], results[0]["cloud"][k]
        gate[k] = float((np.abs(b - a) / (1e-6 + 1e-4 * np.abs(a))).max())
    print(f"  dist_stage1: losses within {worst:.2e} relative; alive masks identical after"
          f" mutations {sorted(single['alive'])}; max |d| / (1e-6 + 1e-4 |x|) {gate} (gate 1);"
          f" both ranks' clouds bitwise equal {same}", flush=True)
    print(f"  dist_stage1: wall s of the whole fit ({DIST_S1_ITERATIONS} iterations, set-up"
          f" included) single {single['seconds']:.3f}, 2 strips sharing the card"
          f" {results[0]['seconds']:.3f}; {card}", flush=True)
    if not all(v <= 1.0 for v in gate.values()):
        fail(f"dist_stage1: parameters outside rtol 1e-4, atol 1e-6: {gate}")
    if not same:
        fail("dist_stage1: the ranks' clouds differ")
    expected = {"composite_fwd", "composite_bwd", "route_pairs"}
    for i, r in enumerate(results):
        if any(r["counts"][k] != 2 * DIST_S1_ITERATIONS for k in expected):
            fail(f"dist_stage1: rank {i} launched {r['counts']}")
    total = rank_totals(results)
    check_only(total, expected, "dist_stage1")
    return total


def train_batch_path(dev, cloud):
    """train_batch (module docstring): the launches summed over the ranks."""
    import tempfile

    import numpy as np
    import torch

    import splatpu_torch.cli.train as cli_train
    from splatpu_torch.data.dataset import save_synthetic_sequence
    from splatpu_torch.dist import ranks
    from splatpu_torch.io.checkpoint import load_checkpoint, save_cloud
    from splatpu_torch.io.images import have_pil
    from splatpu_torch.tools.train_scene import render_targets

    names = ("seq_a", "seq_b")
    with tempfile.TemporaryDirectory(prefix="splatpu_batch_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        suffix = ".jpg" if have_pil() else ".png"
        pc = torch.cat([cloud.means, cloud.colors, cloud.segmentation_masks[:, :1]], 1)
        for name, start in zip(names, (0, 5)):
            frames = render_targets(cloud, CLI_FRAMES, *SERVE_SIZE, impl="cuda", device=dev,
                                    start=start)
            images = np.stack([[v.image for v in per_t] for per_t in frames])
            save_synthetic_sequence(
                tmp / name, images, np.zeros(images.shape[:2] + images.shape[3:], np.uint8),
                np.stack([[v.K for v in per_t] for per_t in frames]),
                np.stack([[v.w2c for v in per_t] for per_t in frames]), pc.cpu().numpy(),
                image_suffix=suffix)
            save_cloud(tmp / name / "densified_initial_gaussian_cloud_parameters.npz", cloud)
            del frames, images
        print(f"  two sequences (frames 0..{CLI_FRAMES - 1} and 5..{4 + CLI_FRAMES} of the"
              f" config-3 motion), 27 cameras at {SERVE_SIZE[0]}x{SERVE_SIZE[1]} ({suffix[1:]});"
              f" written in {time.perf_counter() - t0:.2f} s", flush=True)
        common = ["2", "1", "0.001", "128", "3", "-t", str(CLI_FRAMES - 1), "--device", DEVICE,
                  "--renderer", DIST_RENDERER, "--checkpoint-every", "1"]
        argv = [str(tmp), *common, "--sequences", *names, "-o", str(tmp / "batch"),
                "--num-processes", "2"]
        results = launch_ranks(ranks.cli_on_rank, 2, ("splatpu_torch.cli.train_batch", argv),
                               "train_batch")
        for p, name in enumerate(names):
            rec = json.loads((tmp / "batch" / name / "result.json").read_text())
            t0 = time.perf_counter()
            cli_train.main([name, str(tmp), *common, "-o", str(tmp / "alone"),
                            "--checkpoint-path", str(tmp / f"{name}.msgpack")])
            alone_s = time.perf_counter() - t0
            a = load_checkpoint(tmp / "batch" / name / "stage2_ckpt.msgpack")
            b = load_checkpoint(tmp / f"{name}.msgpack")
            la, lb = flat_leaves(a["net_params"]), flat_leaves(b["net_params"])
            same = la.keys() == lb.keys() and all(np.array_equal(la[k], lb[k]) for k in la)
            print(f"  {name}: trained by process {rec['process']} of {rec['process_count']} in"
                  f" {rec['wall_seconds']:.2f} s, last loss {rec['last_step']['total']:.6f};"
                  f" an independent cli.train run ({alone_s:.2f} s with its orbit render):"
                  f" networks bitwise equal {same}", flush=True)
            if rec["process"] != p or not same:
                fail(f"train_batch: {name} (process {rec['process']}) differs from cli.train's")
    expected = {"composite_fwd", "composite_bwd", "route_pairs"}
    n_steps = 2 * (CLI_FRAMES - 1)
    for i, r in enumerate(results):
        if any(r["counts"][k] != n_steps for k in expected):
            fail(f"train_batch: rank {i} launched {r['counts']}, expected {n_steps} steps")
    total = rank_totals(results)
    check_only(total, expected, "train_batch")
    return total


def counted_stage1(argv: list):
    """``acceptance.main(argv)`` (a ``stage1`` run) with its ``fit``
    counted: (the result, the metrics rows, each iteration's launches, the
    budget growths, the fit's launches, the wall seconds)."""
    import torch

    import splatpu_torch.train.stage1 as stage1
    from splatpu_torch.tools import acceptance

    launched, growths = [], []
    real_fit = stage1.fit

    class Tee:
        """The tool's logger, plus each iteration's launches."""

        def __init__(self, inner):
            self.inner, self.seen = inner, launch_counts()

        def log(self, metrics, step):
            if "budget_growth" in metrics:
                growths.append((step, {k: int(v) for k, v in metrics.items()}))
            else:
                now = launch_counts()
                launched.append({k: n - self.seen[k] for k, n in now.items()})
                self.seen = now
            self.inner.log(metrics, step)

        def flush(self):
            self.inner.flush()

    def counted_fit(*a, logger=None, **kw):
        torch.cuda.synchronize()
        zero_counts()
        out = real_fit(*a, logger=Tee(logger), **kw)
        torch.cuda.synchronize()
        counts.update(launch_counts())
        return out

    counts = {}
    stage1.fit = counted_fit
    try:
        t0 = time.perf_counter()
        result = acceptance.main(argv)
    finally:
        stage1.fit = real_fit
    wall = time.perf_counter() - t0
    out = Path(argv[argv.index("--out") + 1])
    rows = [json.loads(line) for line in open(out / "stage1_metrics.jsonl")]
    return result, rows, launched, growths, counts, wall


def check_stage1_launches(where: str, launched: list, counts: dict) -> None:
    """Every iteration launched K1, K2 and the routing twice, nothing else."""
    expected = {"composite_fwd", "composite_bwd", "route_pairs"}
    for i, c in enumerate(launched):
        bad = {k: n for k, n in c.items() if n != (2 if k in expected else 0)}
        if bad:
            fail(f"{where}: iteration {i} launched {bad}, expected 2 each of {sorted(expected)}")
    check_only(counts, expected, where)


def ulps(a, b):
    """|a - b| in float32 units in the last place, elementwise (int64)."""
    import torch

    def ordered(x):
        i = x.float().contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    return (ordered(a.cpu()) - ordered(b.cpu())).abs()


def prng_check(dev):
    """prng (module docstring)."""
    import numpy as np
    import torch

    from splatpu_torch.core import prng
    from splatpu_torch.data.synthetic import make_random_cloud
    from splatpu_torch.dynamics.network import DeformationNetConfig, init_deformation_net

    bound = lambda f: float(np.float32(1.0) / np.sqrt(np.float32(f)))  # noqa: E731
    uniform_cases = (((192, 128), -bound(192), bound(192)), ((128, 128), -bound(128), bound(128)),
                     ((1000, 3), 0.004, 0.02), ((1000, 3), -1.0, 1.0))
    for seed in PRNG_SEEDS:
        k = prng.key(seed)
        for num in (2, 6, 8):  # split's hash of its counters 0..num-1, on the card
            flat = torch.arange(num, device=dev)
            got = torch.stack(prng.threefry2x32(tuple(int(w) for w in k), flat >> 32,
                                                flat & 0xFFFFFFFF), -1)
            if not np.array_equal(got.cpu().numpy(), prng.split(k, num)):
                fail(f"prng: split(key({seed}), {num}) on the card differs from the CPU's")
        for shape in ((1000,), (1000, 3), (64, 128)):
            if not torch.equal(prng.random_bits(k, shape, dev).cpu(),
                               prng.random_bits(k, shape, "cpu")):
                fail(f"prng: random_bits(key({seed}), {shape}) differs on the card")
        for shape, lo, hi in uniform_cases:
            d = ulps(prng.uniform(k, shape, lo, hi, dev), prng.uniform(k, shape, lo, hi, "cpu"))
            if d.max() > 0:
                fail(f"prng: uniform(key({seed}), {shape}, {lo}, {hi}) on the card: largest"
                     f" {int(d.max())} ulp, bitwise share {float((d == 0).double().mean()):.6f}")
    shape = (ACCEPT4_CAPACITY, 3)
    k = prng.key(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = prng.normal(k, shape, dev)
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    want = prng.normal(k, shape, "cpu")
    cpu_ms = (time.perf_counter() - t0) * 1e3
    d = ulps(got, want)
    share = float((d == 0).double().mean())
    print(f"  split, random_bits and uniform on the card bitwise the CPU's (seeds {PRNG_SEEDS});"
          f" normal {shape}: largest {int(d.max())} ulp, bitwise share {share:.6f}; {card_ms:.2f}"
          f" ms on the card (host clock, synchronised), {cpu_ms:.1f} ms on the CPU", flush=True)
    if d.max() > 2:
        fail(f"prng: normal on the card {int(d.max())} ulp from the CPU's")
    cfg = DeformationNetConfig(hidden_dim=128, residual_blocks=3)
    card_net = init_deformation_net(k, cfg, device=dev).state_dict()
    for name, p in init_deformation_net(k, cfg, device="cpu").state_dict().items():
        if not torch.equal(card_net[name].cpu(), p):
            fail(f"prng: the fresh network's {name} drawn on the card differs from the CPU's")
    truth = np.load(ACCEPT_TRUTH)
    n = truth["means"].shape[0]
    cloud = make_random_cloud(k, n, extent=1.0, scale_range=(0.004, 0.02), device=dev)
    worst = {}
    for f in ("means", "colors", "segmentation_masks", "opacity_logits",
              "rotation_quaternions", "log_scales"):
        got = getattr(cloud, f).cpu().numpy()
        worst[f] = float(np.abs(got - truth[f]).max())
        limit = 1e-6 if f in ("rotation_quaternions", "log_scales") else 0.0
        if not worst[f] <= limit:
            fail(f"prng: make_random_cloud(key(0), {n}) {f} {worst[f]:.3e} from"
                 f" {ACCEPT_TRUTH.name}'s (limit {limit})")
    print(f"  the config-3 network drawn on the card bitwise the CPU's; make_random_cloud(key(0),"
          f" {n}) on the card against {ACCEPT_TRUTH.name}: largest |d| "
          + ", ".join(f"{f} {v:.2e}" for f, v in worst.items()), flush=True)


def acceptance_path(dev):
    """acceptance (module docstring): the fit's launch counts."""
    import tempfile

    import numpy as np

    from splatpu_torch.tools import acceptance

    common = ["--truth", str(ACCEPT_TRUTH), "--device", DEVICE]
    with tempfile.TemporaryDirectory(prefix="splatpu_acceptance_") as tmp:
        t0 = time.perf_counter()
        got = acceptance.main(["floor", "--out", f"{tmp}/floor", *common])["floor_psnr"]
        tpu = json.loads(ACCEPT_FLOOR.read_text())["floor_psnr"]
        cpu = json.loads(ACCEPT_FLOOR_CPU.read_text())["floor_psnr"]
        worst_cam, worst_mean = 0.0, 0.0
        fmt = lambda xs: " ".join(f"{x:.4f}" for x in xs)  # noqa: E731
        for t, row in tpu.items():
            d_cpu = max(abs(a - b) for a, b in zip(got[t]["per_cam"], cpu[t]["per_cam"]))
            d_tpu = max(abs(a - b) for a, b in zip(got[t]["per_cam"], row["per_cam"]))
            d_mean = abs(got[t]["mean"] - row["mean"])
            worst_cam, worst_mean = max(worst_cam, d_cpu), max(worst_mean, d_mean)
            print(f"  floor {t}: port {fmt(got[t]['per_cam'])}; JAX on a CPU"
                  f" {fmt(cpu[t]['per_cam'])} (largest |d| {d_cpu:.5f}); TPU"
                  f" {fmt(row['per_cam'])} (largest |d| {d_tpu:.4f}, of the means {d_mean:.4f}) dB",
                  flush=True)
        print(f"  floor in {time.perf_counter() - t0:.2f} s; per camera against the JAX package"
              f" on a CPU {worst_cam:.5f} dB, means against the TPU's {worst_mean:.5f} dB (limit"
              f" {ACCEPT_FLOOR_DB} each)", flush=True)
        if worst_cam > ACCEPT_FLOOR_DB or worst_mean > ACCEPT_FLOOR_DB:
            fail(f"acceptance: floor PSNR {worst_cam:.5f} dB per camera from the JAX package's,"
                 f" {worst_mean:.5f} dB in the mean from the TPU's")

        result, rows, launched, growths, counts, wall = counted_stage1(
            ["stage1", "--iters", str(ACCEPT_ITERATIONS), "--out", f"{tmp}/s1", "--print-every",
             "20", *common])
    port = [r for r in rows if "total_loss" in r]
    with open(ACCEPT_TPU_LOG) as f:
        tpu_rows = [json.loads(line) for line in f]
    tpu = [r for r in tpu_rows if "total_loss" in r and r["step"] < ACCEPT_ITERATIONS]
    tpu_growths = [(r["step"], r) for r in tpu_rows
                   if "budget_growth" in r and r["step"] < ACCEPT_ITERATIONS]
    if [r["step"] for r in port] != list(range(ACCEPT_ITERATIONS)):
        fail("acceptance: logged iterations are not 0..ACCEPT_ITERATIONS - 1")
    losses = lambda rs: " ".join(f"{r['total_loss']:.4f}" for r in rs)  # noqa: E731
    for c0 in range(0, ACCEPT_ITERATIONS, 10):
        print(f"  total_loss {c0:3d}-{c0 + 9:3d}: port {losses(port[c0:c0 + 10])}", flush=True)
        print(f"  {'':19s}TPU  {losses(tpu[c0:c0 + 10])}", flush=True)
    mean_port = float(np.mean([r["total_loss"] for r in port]))
    mean_tpu = float(np.mean([r["total_loss"] for r in tpu]))
    ovf = lambda rs: sum(r["binning_overflow"] > 0 for r in rs)  # noqa: E731
    print(f"  stage1: {ACCEPT_ITERATIONS} iterations in {wall:.2f} s wall (targets, points and"
          f" the final evaluation included); overflowed iterations port {ovf(port)}, TPU"
          f" {ovf(tpu)}; budget growths port {growths}, TPU {tpu_growths}; PSNR of the first 5"
          f" views at the end {result['psnr_mean']:.4f} dB", flush=True)
    rel = abs(mean_port - mean_tpu) / mean_tpu
    print(f"  mean total_loss over 0-{ACCEPT_ITERATIONS - 1}: port {mean_port:.6f}, TPU"
          f" {mean_tpu:.6f}, relative {rel:.4%} (limit {ACCEPT_LOSS_RTOL:.0%})", flush=True)
    if rel > ACCEPT_LOSS_RTOL:
        fail(f"acceptance: mean total_loss {mean_port} vs the TPU's {mean_tpu}")
    check_stage1_launches("acceptance", launched, counts)
    return counts


def acceptance_config4_path(dev, card):
    """acceptance_config4 (module docstring): the launches of the fit, the
    tool's stage-2 run and the first sharded run's ranks, summed."""
    import tempfile

    import numpy as np
    import torch

    from splatpu_torch.core import prng
    from splatpu_torch.dynamics.network import init_deformation_net
    from splatpu_torch.tools import acceptance
    from splatpu_torch.train.stage2 import Stage2Config

    ref = json.loads(ACCEPT4_TPU.read_text())
    jax_cpu = json.loads(ACCEPT4_FIRST_LOSS.read_text())
    common = ["--truth", str(ACCEPT4_TRUTH), "--device", DEVICE]
    n_its = ACCEPT4_ITERATIONS
    with tempfile.TemporaryDirectory(prefix="splatpu_config4_") as tmp:
        result, rows, launched, growths, s1_counts, wall = counted_stage1(
            ["stage1", "--iters", str(n_its), "--prune-opacity-final", str(ACCEPT4_PRUNE),
             "--out", f"{tmp}/s1", "--print-every", "10", *common])
        port = [r for r in rows if "total_loss" in r]
        if [r["step"] for r in port] != list(range(n_its)):
            fail("acceptance_config4: logged iterations are not 0..ACCEPT4_ITERATIONS - 1")
        if int(port[0]["n_alive"]) != ACCEPT4_POINTS:
            fail(f"acceptance_config4: {port[0]['n_alive']} initial points, not {ACCEPT4_POINTS}")
        tpu = ref["stage1"]["total_loss"][:n_its]
        fmt = lambda xs: " ".join(f"{x:.4f}" for x in xs)  # noqa: E731
        for c0 in range(0, n_its, 10):
            print(f"  total_loss {c0:3d}-{c0 + 9:3d}: port"
                  f" {fmt([r['total_loss'] for r in port[c0:c0 + 10]])}", flush=True)
            print(f"  {'':19s}TPU  {fmt(tpu[c0:c0 + 10])}", flush=True)
        first, first_cpu, first_tpu = port[0]["total_loss"], jax_cpu["total_loss"], tpu[0]
        rel_first = abs(first - first_cpu) / first_cpu
        mean_port = float(np.mean([r["total_loss"] for r in port]))
        mean_tpu = float(np.mean(tpu))
        rel = abs(mean_port - mean_tpu) / mean_tpu
        ovf = sum(r["binning_overflow"] > 0 for r in port)
        print(f"  stage1 on the 250,000-Gaussian truth: {len(port)} iterations from"
              f" {ACCEPT4_POINTS} points ({result['cameras']} cameras at {result['resolution']},"
              f" final prune {ACCEPT4_PRUNE}) in {wall:.2f} s wall (targets and the final"
              f" evaluation included); overflowed iterations port {ovf}, TPU"
              f" {sum(f > 0 for f in ref['stage1']['binning_overflow'][:n_its])}; budget growths"
              f" {growths}", flush=True)
        print(f"  first total_loss: port {first:.7f}, the JAX package on a CPU {first_cpu:.7f}"
              f" (relative {rel_first:.2e}, limit {ACCEPT_FIRST_LOSS_RTOL:.0e}), TPU"
              f" {first_tpu:.7f} ({abs(first - first_tpu) / first_tpu:.4%} from the port's)",
              flush=True)
        print(f"  mean total_loss over 0-{n_its - 1}: port {mean_port:.6f}, TPU {mean_tpu:.6f},"
              f" relative {rel:.4%} (limit {ACCEPT_LOSS_RTOL:.0%})", flush=True)
        if rel_first > ACCEPT_FIRST_LOSS_RTOL:
            fail(f"acceptance_config4: first loss {first} vs the JAX package's {first_cpu}")
        if rel > ACCEPT_LOSS_RTOL:
            fail(f"acceptance_config4: mean total_loss {mean_port} vs the TPU's {mean_tpu}")
        check_stage1_launches("acceptance_config4", launched, s1_counts)

        iters, timesteps = ACCEPT4_STAGE2
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        got = acceptance.main(["stage2", "--cloud", str(ACCEPT4_TRUTH), "--iters", str(iters),
                               "--timesteps", str(timesteps), "--out", f"{tmp}/s2", *common])
        torch.cuda.synchronize()
        s2_counts = launch_counts()
        wall = time.perf_counter() - t0
        rows2 = [json.loads(line) for line in open(f"{tmp}/s2/stage2_metrics.jsonl")]
    steps = [r for r in rows2 if "total" in r]
    n_steps = iters * timesteps
    print(f"  stage2 through the tool ({got['reference_run']}'s settings: head {got['head']},"
          f" schedule {got['schedule']}, staging {got['staging']}): {iters} x {timesteps} steps"
          f" on the {got['gaussians']}-Gaussian truth at a budget of {got['max_pairs']} pairs"
          f" (the TPU's whole run: 1,578,752) in {wall:.2f} s wall (staging and the rollout"
          f" evaluation included); rollout {got['rollout_psnr']}", flush=True)
    for r in steps:
        print(f"  step {r['step']}: loss {r['total']:.6f} (l1 {r['l1']:.5f} ssim"
              f" {r['ssim']:.5f} rig {r['rigidity']:.3e}) lr {r['learning_rate']:.4e}"
              f" {r['step_ms']:.2f} ms", flush=True)
    tpu_first = ref["stage2"]["total"][0]
    print(f"  the TPU's first steps (150 timesteps, the same network draw): losses"
          f" {fmt(ref['stage2']['total'])}; step 1"
          f" {abs(steps[0]['total'] - tpu_first) / tpu_first:.2%} from the port's", flush=True)
    if got["reference_run"] != "runs/config4_250k" or not got["head"]["quirk_compat"]:
        fail(f"acceptance_config4: stage2 took {got['reference_run']}'s head {got['head']}")
    if [r["step"] for r in steps] != list(range(1, n_steps + 1)) or not got["completed"]:
        fail("acceptance_config4: stage2 did not log every step")
    if got["binning"]["overflow_steps"] or not np.isfinite([r["total"] for r in steps]).all():
        fail(f"acceptance_config4: stage2 overflowed or diverged ({got['binning']})")
    expected = {"composite_fwd", "composite_bwd", "route_pairs"}
    if not (s2_counts["composite_bwd"] == s2_counts["route_pairs"] == n_steps
            and s2_counts["composite_fwd"] >= n_steps):
        fail(f"acceptance_config4: stage2 launched {s2_counts} in {n_steps} steps")
    check_only(s2_counts, expected, "acceptance_config4 stage2")

    # The same steps in this process and over 2 camera ranks.
    args = acceptance.parser().parse_args(["stage2", *common])
    scene = acceptance.load_scene(args)
    settings = acceptance.stage2_settings(scene.truth.capacity, args)
    imgs = acceptance.stage_truth_views(scene, timesteps, settings["motion"])
    w2c, K = scene.camera.w2c.cpu().numpy(), scene.camera.K.cpu().numpy()
    views = [[dict(camera_index=i, w2c=w2c[i], K=K[i], width=scene.width, height=scene.height,
                   image=imgs[t, i], segmentation=np.zeros((3, 1, 1), np.float32))
              for i in range(scene.count)] for t in range(timesteps)]
    del scene, imgs
    cfg = Stage2Config(total_iterations=iters, warmup_iterations=max(1, iters // 10),
                       timestep_count=timesteps, renderer=DIST_RENDERER, **settings["config"])
    net = init_deformation_net(prng.key(cfg.seed), cfg.net_config(), device="cpu")
    init = {k: v.numpy() for k, v in net.state_dict().items()}
    print(f"  2 camera ranks: the same {iters} x {timesteps} steps, 5 of 27 views per step"
          " (padded to 6), the network the tool drew from key(seed)", flush=True)
    total, single = hold_sharded("acceptance_config4", ACCEPT4_TRUTH, views, cfg, init, 2, 1,
                                 card)
    worst = max(abs(b["total"] - a["total"]) / abs(a["total"])
                for a, (_, b) in zip(steps, single))
    print(f"  the single-process run against the tool's: losses within {worst:.2e} relative",
          flush=True)
    if not worst <= 1e-5:
        fail(f"acceptance_config4: the single-process run's losses {worst:.2e} from the tool's")
    return {k: s1_counts[k] + s2_counts[k] + total[k] for k in total}


def flat_leaves(tree, prefix="") -> dict:
    """A checkpoint tree's arrays by path."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def video_path(net, cloud, head):
    """``run_inference`` of VIDEO_TIMESTEPS timesteps with an output
    directory: one video per orbit camera (a GIF through PIL where imageio
    is absent) holding every frame at the served size, and the PNG frames.
    Returns the launch counts."""
    import tempfile

    from PIL import Image

    from splatpu_torch.dynamics.deform import normalize_and_encode_means_and_rotations
    from splatpu_torch.io.video import have_imageio
    from splatpu_torch.train.inference import run_inference
    from splatpu_torch.train.stage2 import Stage2Config

    config = Stage2Config(timestep_count=VIDEO_TIMESTEPS, renderer="cuda",
                          quirk_compat=head["quirk_compat"])
    enc = normalize_and_encode_means_and_rotations(
        cloud.means, cloud.rotation_quaternions, quirk_compat=config.quirk_compat)
    with tempfile.TemporaryDirectory(prefix="splatpu_video_") as tmp:
        zero_counts()
        t0 = time.perf_counter()
        frames, stats = run_inference(net, cloud, enc, config, width=SERVE_SIZE[0],
                                      height=SERVE_SIZE[1], device=DEVICE, output_directory=tmp)
        wall = time.perf_counter() - t0
        counts = launch_counts()
        videos = stats["videos"]
        print(f"  video: {VIDEO_TIMESTEPS} timesteps + t=0 written in {wall:.2f} s wall: "
              + ", ".join(f"{k} {v.name}" for k, v in videos.items()), flush=True)
        if sorted(videos) != sorted(frames):
            fail(f"serve video: videos for {sorted(videos)}, cameras {sorted(frames)}")
        for name, path in videos.items():
            if not path.is_file():
                fail(f"serve video: camera {name} has no video ({path})")
            pngs = sorted((Path(tmp) / "frames" / name).glob("*.png"))
            if len(pngs) != VIDEO_TIMESTEPS + 1:
                fail(f"serve video: camera {name} has {len(pngs)} PNG frames")
            if have_imageio():
                continue
            with Image.open(path) as im:
                got = (path.suffix, im.n_frames, im.size, im.info.get("loop"))
            if got != (".gif", VIDEO_TIMESTEPS + 1, SERVE_SIZE, 0):
                fail(f"serve video: camera {name}: (suffix, frames, size, loop) {got}")
    if counts["composite_fwd"] != stats["renders"]:
        fail(f"serve video: {counts['composite_fwd']} K1 launches in {stats['renders']} renders")
    check_only(counts, {"composite_fwd"}, "serve video")
    return counts


def bench_path(dev):
    """``bench_torch.main`` at full size, every count zeroed just before
    and read just after: K1, K2 and the routing once per forward + backward
    and nothing else, no overflow; then one forward + backward through the
    kernels against the plain versions on the same inputs: the loss 1e-5
    relative, image, depth, final T and ``last`` as every forward, the five
    gradient groups 1e-4 scaled per row.  Returns the launch counts."""
    import torch

    import bench_torch
    from splatpu_torch.tools.measure import row_scaled_err

    torch.cuda.synchronize()
    zero_counts()
    result = bench_torch.main(profile=BENCH_PROFILE)
    counts = launch_counts()
    expected = ("composite_fwd", "composite_bwd", "route_pairs")
    # time_fn runs warmup + 1 warm-up calls, as the JAX package's does.
    calls = (1 + BENCH_PROFILE + bench_torch.WARMUP + 1 + bench_torch.ITERS
             + bench_torch.CHAIN * (bench_torch.CHAIN_WARMUP + 1 + bench_torch.CHAIN_ITERS))
    print(f"  bench: {calls} forward + backward calls, launches {counts}", flush=True)
    print(f"  bench per call (time_fn): mean {result['ms']:.4f} ms, spread"
          f" {result['spread_ms']:.4f} ms, timer {result['timer']}", flush=True)
    if result["timer"] != "host_clock":
        fail(f"bench: time_fn's timer is {result['timer']}, not the host clock")
    if result["overflowed"]:
        fail("bench: the render overflowed its pair budget")
    if any(counts[k] != calls for k in expected) or result["launches"] != counts:
        fail(f"bench: launches {counts} (bench_torch's own count {result['launches']}),"
             f" expected {calls} of each of {expected}")
    check_only(counts, set(expected), "bench")

    cloud, cam, config = bench_torch.scene(dev)
    target = torch.zeros((3, cam.height, cam.width), device=dev)
    runs = {impl: bench_torch.loss_and_grads(cloud, cloud.param_dict(), cam, config, target,
                                             impl=impl) for impl in ("cuda", "plain")}
    (loss, out, grads), (loss_ref, out_ref, grads_ref) = runs["cuda"], runs["plain"]
    fields = lambda o: tuple(x.detach() for x in (  # noqa: E731
        o.image, o.depth, o.final_transmittance, o.last_contributor))
    check_errors(compare(fields(out), fields(out_ref)), "bench forward, cuda against plain")
    rel = abs(float(loss) / float(loss_ref) - 1.0)
    print(f"  bench loss {float(loss):.8f}, plain {float(loss_ref):.8f} (relative {rel:.2e})",
          flush=True)
    if not rel <= 1e-5:
        fail(f"bench: loss {float(loss)} against the plain versions' {float(loss_ref)}")
    check_rows("bench gradients, cuda against plain",
               {k: row_scaled_err(g, grads_ref[k]) for k, g in grads.items()})
    return counts


def bench_case(dev):
    """The kernels' inputs at the bench shape (``table_case``), with the
    cotangents of the bench's loss, mean |image| + 0.1 mean depth."""
    import torch

    import bench_torch
    import splatpu_torch.render.composite as composite
    from splatpu_torch.core.types import activate_cloud, stack_cameras

    cloud, cam, config = bench_torch.scene(dev)
    case = table_case(activate_cloud(cloud), stack_cameras([cam]), config,
                      composite.composite_fwd_cuda)
    image, depth, tfin = case["out"][:3]
    case["cot"] = (torch.sign(image) / image.numel(),
                   torch.full_like(depth, 0.1 / depth.numel()), torch.zeros_like(tfin))
    return case


def cache_case(path) -> None:
    """The build phase's K1 input: ``make_random_cloud(key(seed), n)`` seen
    by the bench's look-at camera at ``CACHE_CASE``'s size, binned on the
    CPU at its demand budget; saved to ``path``."""
    import torch

    from splatpu_torch.core import prng
    from splatpu_torch.core.types import activate_cloud, stack_cameras
    from splatpu_torch.data.synthetic import make_lookat_camera, make_random_cloud
    from splatpu_torch.render.api import demand_binning, measure_binning_demand
    from splatpu_torch.render.exact import composite_inputs

    seed, n, w, h = CACHE_CASE
    args = activate_cloud(make_random_cloud(prng.key(seed), n, extent=1.2,
                                            scale_range=(0.01, 0.04), device="cpu"))
    cams = stack_cameras([make_lookat_camera(eye=(0, 0, -4.0), width=w, height=h, focal=0.8 * w,
                                             device="cpu")])
    _, k = composite_inputs(args, cams, demand_binning(*measure_binning_demand(args, cams)))
    torch.save({"kin": [k["table"].detach(), k["gid"], k["start"], k["end"], torch.zeros(3)],
                "geo": k["geometry"]}, path)


def cache_k1(path, dev, out_path=None):
    """K1 once on ``cache_case``'s input from ``path``; its outputs on the
    host (saved to ``out_path`` where given)."""
    import torch

    import splatpu_torch.render.composite as composite

    case = torch.load(path)
    out = composite.composite_fwd_cuda(*(x.to(dev) for x in case["kin"]), **case["geo"])
    out = [x.cpu() for x in out]
    if out_path is not None:
        torch.save(out, out_path)
    return out


def cache_check(dev) -> None:
    """build (module docstring): the child process that loads the library
    from the cache and runs K1, against this process's K1."""
    import torch

    from splatpu_torch import _build

    with tempfile.TemporaryDirectory(prefix="splatpu_cache_k1_") as tmp:
        cache_case(f"{tmp}/in.pt")
        mine = cache_k1(f"{tmp}/in.pt", dev)
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-c", CACHE_CHILD, f"{tmp}/in.pt", f"{tmp}/out.pt"], cwd=ROOT,
            capture_output=True, text=True, timeout=180)
        wall = time.perf_counter() - t0
        if child.returncode != 0:
            fail(f"the cache's child process exited {child.returncode}:\n{child.stdout}"
                 f"{child.stderr}")
        got = json.loads(child.stdout.splitlines()[-1])
        theirs = torch.load(f"{tmp}/out.pt")
    print(f"  child process: build_cached {got['build_cached']}, compiled {got['compiled']},"
          f" library loaded in {got['load_s']:.3f} s, process {wall:.2f} s in all", flush=True)
    if not got["build_cached"] or got["compiled"]:
        fail("the child process compiled instead of loading the cached library")
    if got["path"] != str(_build.library_path()):
        fail(f"the child loaded {got['path']}, not the entry {_build.library_path()}")
    names = ("image", "depth", "final_T", "last")
    differ = [k for k, a, b in zip(names, mine, theirs) if not torch.equal(a, b)]
    seed, n, w, h = CACHE_CASE
    print(f"  K1 on {n} Gaussians from key({seed}) at {w}x{h}: the child's outputs"
          f" {'differ in ' + str(differ) if differ else 'bitwise this process'}'s; pixels drawn"
          f" {int((mine[3] >= 0).sum())} of {w * h}", flush=True)
    if differ or not all(bool(torch.isfinite(x).all()) for x in mine[:3]):
        fail(f"K1 from the cached library: {differ} differ, or not finite")
    if not (mine[3] >= 0).any():
        fail("K1 on the cache check's input drew no pixel")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", flush=True)
        return 1
    if not (ROOT / "splatpu_torch").is_dir():
        print("FAIL: splatpu_torch/ is not beside chip_smoke.py", flush=True)
        return 1

    import numpy as np

    import splatpu_torch.render.composite as composite
    import splatpu_torch.render.padded as padded
    import splatpu_torch.render.route as route
    from splatpu_torch import _build
    from splatpu_torch.core.types import Camera, RenderArgs, activate_cloud, stack_cameras
    from splatpu_torch.io.checkpoint import load_cloud, load_stage2_run
    from splatpu_torch.render.api import demand_binning, measure_binning_demand
    from splatpu_torch.render.exact import composite_inputs
    from splatpu_torch.tools.measure import cuda_ms, row_scaled_err
    from splatpu_torch.train.inference import create_orbit_cameras
    from splatpu_torch.train.stage2 import Stage2Config, compact_cloud

    dev = torch.device(DEVICE)
    t_start = time.perf_counter()

    with phase("device", 60):
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip().splitlines()[0]
        kind = torch.cuda.get_device_name(0)
        print(f"  card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
        from splatpu_torch.io.images import have_pil
        from splatpu_torch.io.video import have_imageio

        have = {"PIL": have_pil(), "imageio": have_imageio(),
                "tqdm": importlib.util.find_spec("tqdm") is not None}
        print("  image I/O and progress: " + ", ".join(
            f"{k} {'present' if v else 'absent'}" for k, v in have.items())
            + ("" if have["PIL"] else "; images through the port's PNG codec")
            + ("" if have["imageio"] else "; frames as PNG through the codec, videos as GIF"
                                          " through PIL"),
            flush=True)

    with phase("build", 300):
        cache_dir = tempfile.mkdtemp(prefix="splatpu_kernels_")
        atexit.register(shutil.rmtree, cache_dir, True)
        os.environ["SPLATPU_TORCH_COMPILE_CACHE"] = cache_dir
        from splatpu_torch.obs.cache import enable_compilation_cache

        enable_compilation_cache()
        if _build.cache_dir != Path(cache_dir).resolve():
            fail(f"the cache is at {_build.cache_dir}, not $SPLATPU_TORCH_COMPILE_CACHE")
        _build.load_library()
        if _build.build_cached:
            fail("a fresh cache directory held the kernel library")
        print(f"  nvcc: {_build.build_seconds:.2f} s, key {_build.build_meta['key']}", flush=True)
        print("  nvcc wall by source (all at once): " + ", ".join(
            f"{k} {v:.2f} s" for k, v in sorted(_build.build_meta["nvcc_seconds"].items(),
                                                key=lambda kv: -kv[1])), flush=True)
        regs = ptxas_summary(_build.build_log)
        for k, v in regs.items():
            print(f"  ptxas {k}: {v}", flush=True)
        missing = sorted(set(PTXAS_NAMES.values()) - set(regs))
        if missing:
            fail(f"nvcc's log names no register count for {missing}")
        if re.search(r"[1-9]\d* bytes spill", _build.build_log):
            print("  (some instances spill: see the log's spill lines)", flush=True)
        cache_check(dev)

    with phase("prng", 10):
        prng_check(dev)

    with phase("compare", 180):
        cloud = compact_cloud(load_cloud(CLOUD, device=dev))
        if cloud.capacity != N_GAUSSIANS:
            fail(f"expected {N_GAUSSIANS} alive Gaussians, got {cloud.capacity}")
        args = activate_cloud(cloud)
        w, h = COMPARE_SIZE
        cams_small = stack_cameras(list(create_orbit_cameras(w, h, device=dev).values()))
        cfg_small = demand_binning(*measure_binning_demand(args, cams_small))
        _, k = composite_inputs(args, cams_small, cfg_small)
        bg = torch.zeros(3, device=dev)
        kin = (k["table"], k["gid"], k["start"], k["end"], bg)
        got = composite.composite_fwd_cuda(*kin, **k["geometry"])
        torch.cuda.synchronize()
        ref = composite.composite_fwd_plain(*kin, **k["geometry"])
        print(f"  {w}x{h}, V=5, pairs/view max {int(k['end'][:, -1].max())}", flush=True)
        check_errors(compare(got, ref), f"{w}x{h}")

    with phase("compare_bwd", 300):
        for w, h in (COMPARE_SIZE, SERVE_SIZE):
            case = bwd_case(args, rig_cams(dev, w, h, 5), dev)
            compare_table_bwd(f"K2 {w}x{h}, V=5", case, composite.composite_bwd_cuda,
                              composite.composite_bwd_plain, ("cuda", "grid"))
            del case

    # Colours from a seeded generator for the 9-channel comparisons.
    colors9 = torch.from_numpy(np.random.default_rng(9).uniform(
        0.0, 1.0, (cloud.capacity, 9)).astype(np.float32)).to(dev)
    args_by_c = {3: args, 9: RenderArgs(args.means3d, colors9, args.rotations, args.opacities,
                                        args.scales)}

    with phase("compare_manual", 300):
        w, h = COMPARE_SIZE
        for c in CHANNELS:
            binning = dataclasses.replace(
                demand_binning(*measure_binning_demand(args_by_c[c], cams_small)), kernel="manual")
            case = table_case(args_by_c[c], cams_small, binning, composite.composite_manual_fwd_cuda)
            torch.cuda.synchronize()
            ref = composite.composite_manual_fwd_plain(*case["kin"], **case["geo"])
            check_errors(compare(case["out"], ref), f"K4 {w}x{h}, V=5, C={c}")
            compare_table_bwd(f"K4 {w}x{h}, V=5, C={c}", case, composite.composite_manual_bwd_cuda,
                              composite.composite_manual_bwd_plain, ("cuda", "manual"))
        big_budget_case(case)
        del case

    with phase("compare_padded", 300):
        for c in CHANNELS:
            binning16 = demand_binning(*measure_binning_demand(args_by_c[c], cams_small, tile=16),
                                       tile=16)
            compare_padded_case(f"K5 {w}x{h}, V=5, C={c}", args_by_c[c], cams_small, binning16)
        del args_by_c

    net, head = load_stage2_run(RUN, device=dev)
    c = net.config
    print(f"  net: hidden {c.hidden_dim}, blocks {c.residual_blocks}, in {c.input_dim},"
          f" out {c.output_dim}; head {head}", flush=True)
    orbit = stack_cameras(list(create_orbit_cameras(*SERVE_SIZE, device=dev).values()))
    served = {}

    with phase("serve", 420):
        config = Stage2Config(timestep_count=TIMESTEPS, renderer="cuda",
                              quirk_compat=head["quirk_compat"])
        served["serve"] = serve_path("serve", net, cloud, config, "composite_fwd", TIMESTEPS)
        served["serve_video"] = (video_path(net, cloud, head), None)

    with phase("serve_manual", 240):
        demand = measure_binning_demand(args, orbit)
        config = Stage2Config(timestep_count=NEW_SERVE_TIMESTEPS, renderer="cuda",
                              quirk_compat=head["quirk_compat"],
                              binning=demand_binning(*demand, overrides={"kernel": "manual"}))
        print(f"  depth cut: {NEW_SERVE_TIMESTEPS} timesteps (config 3 serves {TIMESTEPS})",
              flush=True)
        served["serve_manual"] = serve_path("serve_manual", net, cloud, config,
                                            "composite_manual_fwd", NEW_SERVE_TIMESTEPS)

    with phase("serve_padded", 240):
        config = Stage2Config(
            timestep_count=NEW_SERVE_TIMESTEPS, renderer="cuda_padded",
            quirk_compat=head["quirk_compat"],
            binning=demand_binning(*measure_binning_demand(args, orbit, tile=16), tile=16))
        print(f"  depth cut: {NEW_SERVE_TIMESTEPS} timesteps (config 3 serves {TIMESTEPS})",
              flush=True)
        served["serve_padded"] = serve_path("serve_padded", net, cloud, config, "padded_fwd",
                                            NEW_SERVE_TIMESTEPS)

    trained = {}
    with phase("train", 480):
        from splatpu_torch.tools.train_scene import render_targets

        t0 = time.perf_counter()
        views = render_targets(cloud, TRAIN_TIMESTEPS, *SERVE_SIZE, impl="cuda", device=dev)
        torch.cuda.synchronize()
        print(f"  targets: {TRAIN_TIMESTEPS} timesteps x {len(views[0])} cameras,"
              f" {SERVE_SIZE[0]}x{SERVE_SIZE[1]} uint8, rendered in"
              f" {time.perf_counter() - t0:.2f} s", flush=True)
        tc = net.config
        base_cfg = Stage2Config(
            total_iterations=TRAIN_ITERATIONS, warmup_iterations=1,
            learning_rate=head["lr"], hidden_dim=tc.hidden_dim,
            residual_blocks=tc.residual_blocks, views_per_step=5,
            timestep_count=TRAIN_TIMESTEPS, renderer="cuda",
            quirk_compat=head["quirk_compat"], view_staging="device_u8",
            timestep_order="shuffled", overflow_check_every=1,
            **{k: head[k] for k in ("delta_scale", "double_residual", "zero_init_head",
                                    "time_gate_head")},
        )
        print(f"  depth cut: {TRAIN_TIMESTEPS} timesteps x {TRAIN_ITERATIONS} sequence"
              f" iterations (config 3: 150 x 40); width untouched", flush=True)
        trained["train"] = train_path(
            "train", cloud, views, base_cfg, ("composite_fwd", "composite_bwd", "route_pairs"),
            TRAIN_ITERATIONS * TRAIN_TIMESTEPS)
        train_binning = dataclasses.replace(
            demand_binning(*measure_binning_demand(args, rig_cams(dev, *SERVE_SIZE))),
            max_pairs=int(trained["train"][1].steps[-1][1]["max_pairs"]))
        views = views[:NEW_TRAIN_TIMESTEPS]

    new_cfg = dataclasses.replace(base_cfg, total_iterations=NEW_TRAIN_ITERATIONS,
                                  timestep_count=NEW_TRAIN_TIMESTEPS)
    new_steps = NEW_TRAIN_ITERATIONS * NEW_TRAIN_TIMESTEPS
    with phase("train_manual", 300):
        print(f"  depth cut: {NEW_TRAIN_TIMESTEPS} timesteps x {NEW_TRAIN_ITERATIONS} sequence"
              f" iterations; binning_overrides kernel='manual'", flush=True)
        trained["train_manual"] = train_path(
            "train_manual", cloud, views,
            dataclasses.replace(new_cfg, binning_overrides={"kernel": "manual"}),
            ("composite_manual_fwd", "composite_manual_bwd", "route_pairs"), new_steps)

    with phase("train_padded", 300):
        t0_cams = Camera(w2c=torch.from_numpy(np.stack([v.w2c for v in views[0]])).to(dev),
                         K=torch.from_numpy(np.stack([v.K for v in views[0]])).to(dev),
                         width=SERVE_SIZE[0], height=SERVE_SIZE[1])
        padded_binning = demand_binning(*measure_binning_demand(args, t0_cams, tile=16), tile=16,
                                        headroom=new_cfg.binning_headroom)
        print(f"  depth cut: {NEW_TRAIN_TIMESTEPS} timesteps x {NEW_TRAIN_ITERATIONS} sequence"
              f" iterations; renderer 'cuda_padded', 16 px budget {padded_binning.max_pairs}",
              flush=True)
        trained["train_padded"] = train_path(
            "train_padded", cloud, views,
            dataclasses.replace(new_cfg, renderer="cuda_padded", binning=padded_binning),
            ("padded_fwd", "padded_bwd", "route_pairs"), new_steps)


    with phase("measure", 300):
        _, k = composite_inputs(args, orbit, served["serve"][1]["binning"])
        kin = (k["table"], k["gid"], k["start"], k["end"], bg)
        geo = k["geometry"]
        print(f"  V={kin[0].shape[0]} N={kin[0].shape[1]} pairs={int(kin[3][:, -1].sum())}",
              flush=True)
        k1, _ = measure_fwd(f"K1 {SERVE_SIZE[0]}x{SERVE_SIZE[1]} (t=0 inputs)",
                            composite.composite_fwd_cuda, composite.composite_fwd_plain, kin, geo,
                            composite.composite_fwd_cuda(*kin, **geo), table_bytes_in(kin))

    def measure_table_bwd(label, case, fwd_label, fwd, fwd_plain, bwd, bwd_plain,
                          shapes="the training shapes", time_plain_fwd=False):
        """At ``shapes``: a table forward (errors, time, bound, the plain
        version's time with ``time_plain_fwd``), its backward and the
        routing (errors, times, the index_add_ yardstick and both bounds)."""
        kin, geo, cot, (tfin, last) = case["kin"], case["geo"], case["cot"], case["fwd"]
        kf, n_live = measure_fwd(f"{fwd_label} at {shapes}", fwd, fwd_plain, kin, geo,
                                 case["out"], table_bytes_in(kin), time_plain=time_plain_fwd)
        offsets, counts, lane = case["offsets"], case["counts"], case["lane"]
        run = lambda: bwd(*kin, tfin, last, *cot, **geo)  # noqa: E731
        run_plain = lambda: bwd_plain(*kin, tfin, last, *cot, **geo)  # noqa: E731
        rows = run()
        pos = route.pos_of_slot_of(offsets, kin[1], lane)
        routed = route.route_pairs_cuda(rows, pos, offsets, counts)
        v, n, rec = kin[0].shape
        p = kin[1].shape[1]
        c = rec - 7
        # The library yardstick: one index_add_ of the kept pairs' rows by
        # (view, gid), index and rows gathered beforehand (not timed).
        kept = lane >= 0
        index = (kin[1].long() + n * torch.arange(v, device=dev)[:, None])[kept]
        kept_rows = rows[kept]
        library = lambda: torch.zeros((v * n, rec), device=dev).index_add_(0, index, kept_rows)  # noqa: E731
        lib_err = float((library().reshape(v, n, rec) - routed).abs().max())
        rows_ref = run_plain()
        routed_ref = route.route_pairs_plain(rows, pos, offsets, counts)
        check_rows(f"{label} at {shapes}", {
            "rows": row_scaled_err(rows, rows_ref), "routing": row_scaled_err(routed, routed_ref)})
        errs = (float((rows - rows_ref).abs().max()), float((routed - routed_ref).abs().max()))
        del rows_ref
        b_ms = cuda_ms(run, reps=20, warmup=3)
        b_plain_ms = cuda_ms(run_plain, reps=2, warmup=1)
        r_ms = cuda_ms(lambda: route.route_pairs_cuda(rows, pos, offsets, counts), reps=50,
                       warmup=5)
        r_plain_ms = cuda_ms(lambda: route.route_pairs_plain(rows, pos, offsets, counts),
                             reps=5, warmup=1)
        r_lib_ms = cuda_ms(library, reps=50, warmup=5)
        evals, live, b_bytes, b_ops, b_tb, b_to = table_bwd_bound(kin, geo, last, n_live)
        pairs = int(kin[3][:, -1].sum())
        n_kept = int(kept.sum())
        r_bytes = 4 * (n_kept * rec + v * p + 2 * v * n + v * n * rec)
        r_ops = n_kept * rec
        r_tb, r_to = 1e3 * r_bytes / PEAK_BYTES_S, 1e3 * r_ops / PEAK_FP32_FLOPS
        print(f"  V={v} N={n} P={p} pairs={pairs} kept={n_kept}; backward evaluations {evals},"
              f" live {live}", flush=True)
        print_slot_runs("exact stream", counts)
        print(f"  {label} {b_ms:.4f} ms/launch, plain {b_plain_ms:.2f} ms; bound"
              f" {max(b_tb, b_to):.4f} ms (bytes {b_bytes} -> {b_tb:.4f} ms, FP32 ops"
              f" {b_ops} -> {b_to:.4f} ms)", flush=True)
        print(f"  routing {r_ms:.4f} ms/launch, plain {r_plain_ms:.3f} ms, index_add_"
              f" {r_lib_ms:.4f} ms (max |d| vs kernel {lib_err:.3e}); bound"
              f" {max(r_tb, r_to):.4f} ms (bytes {r_bytes} -> {r_tb:.4f} ms, adds"
              f" {r_ops} -> {r_to:.5f} ms)", flush=True)
        return (kf,
                dict(err=errs[0], ms=b_ms, plain_ms=b_plain_ms, bound=(max(b_tb, b_to), b_tb, b_to)),
                dict(err=errs[1], ms=r_ms, plain_ms=r_plain_ms, bound=(max(r_tb, r_to), r_tb, r_to),
                     library_ms=r_lib_ms))

    with phase("measure_bwd", 300):
        case = bwd_case(args, rig_cams(dev, *SERVE_SIZE, 5), dev, binning=train_binning)
        k1_train, k2, k3 = measure_table_bwd(
            "K2", case, "K1", composite.composite_fwd_cuda, composite.composite_fwd_plain,
            composite.composite_bwd_cuda, composite.composite_bwd_plain)
        del case

    with phase("measure_manual", 300):
        b = served["serve_manual"][1]["binning"]
        case = table_case(args, orbit, b, composite.composite_manual_fwd_cuda)
        k4f, _ = measure_fwd(f"K4 fwd {SERVE_SIZE[0]}x{SERVE_SIZE[1]} (t=0 inputs, C=3)",
                             composite.composite_manual_fwd_cuda,
                             composite.composite_manual_fwd_plain, case["kin"], case["geo"],
                             case["out"], table_bytes_in(case["kin"]))
        manual_train = dataclasses.replace(
            train_binning, kernel="manual",
            max_pairs=int(trained["train_manual"][1].steps[-1][1]["max_pairs"]))
        case = table_case(args, rig_cams(dev, *SERVE_SIZE, 5), manual_train,
                          composite.composite_manual_fwd_cuda)
        k4f_train, k4b, _ = measure_table_bwd(
            "K4 bwd", case, "K4 fwd", composite.composite_manual_fwd_cuda,
            composite.composite_manual_fwd_plain, composite.composite_manual_bwd_cuda,
            composite.composite_manual_bwd_plain)
        del case

    with phase("measure_padded", 300):
        case = padded_case(args, orbit, served["serve_padded"][1]["binning"])
        kin = case["kin"]
        print(f"  K5 V={kin[0].shape[0]} Pp={kin[0].shape[1]} pairs={int((kin[2] - kin[1]).sum())}",
              flush=True)
        k5f, _ = measure_fwd(f"K5 fwd {SERVE_SIZE[0]}x{SERVE_SIZE[1]} (t=0 inputs, C=3)",
                             padded.padded_fwd_cuda, padded.padded_fwd_plain, kin, case["geo"],
                             case["out"], padded_bytes_in(kin))
        pb = trained["train_padded"][1]
        case = padded_case(args, rig_cams(dev, *SERVE_SIZE, 5), dataclasses.replace(
            padded_binning, max_pairs=int(pb.steps[-1][1]["max_pairs"])))
        kin, geo, cot, (tfin, last) = case["kin"], case["geo"], case["cot"], case["fwd"]
        k5f_train, n_live = measure_fwd(
            "K5 fwd at the training shapes", padded.padded_fwd_cuda, padded.padded_fwd_plain, kin,
            geo, case["out"], padded_bytes_in(kin), time_plain=False)
        run = lambda: padded.padded_bwd_cuda(*kin, tfin, last, *cot, **geo)  # noqa: E731
        run_plain = lambda: padded.padded_bwd_plain(*kin, tfin, last, *cot, **geo)  # noqa: E731
        rows, rows_ref = run(), run_plain()
        check_rows("K5 bwd at the training shapes", {"rows": row_scaled_err(rows, rows_ref)})
        k5b_err = float((rows - rows_ref).abs().max())
        del rows_ref
        b_ms = cuda_ms(run, reps=20, warmup=3)
        b_plain_ms = cuda_ms(run_plain, reps=2, warmup=1)
        evals, live = bwd_work(kin[1], last, geo, n_live)
        v, pp, rec = kin[0].shape
        c = rec - 7
        pairs = int((kin[2] - kin[1]).sum())
        hw = SERVE_SIZE[0] * SERVE_SIZE[1]
        b_bytes = 4 * (pairs * rec + 2 * kin[1].numel() + c + v * hw * (c + 4) + v * pp * rec)
        b_ops = OPS_PER_EVAL * evals + ops_bwd_per_live(c) * live
        b_tb, b_to = 1e3 * b_bytes / PEAK_BYTES_S, 1e3 * b_ops / PEAK_FP32_FLOPS
        print(f"  K5 bwd V={v} Pp={pp} pairs={pairs}; evaluations {evals}, live {live}:"
              f" {b_ms:.4f} ms/launch, plain {b_plain_ms:.2f} ms; bound {max(b_tb, b_to):.4f} ms"
              f" (bytes {b_bytes} -> {b_tb:.4f} ms, FP32 ops {b_ops} -> {b_to:.4f} ms)",
              flush=True)
        k5b = dict(err=k5b_err, ms=b_ms, plain_ms=b_plain_ms, bound=(max(b_tb, b_to), b_tb, b_to))
        pos, offsets, counts = case["pos"], case["offsets"], case["counts"]
        run = lambda: route.route_pairs_cuda(rows, pos, offsets, counts, padded=True)  # noqa: E731
        run_plain = lambda: route.route_pairs_plain(rows, pos, offsets, counts, padded=True)  # noqa: E731
        print_slot_runs("padded stream", counts)
        routed, routed_ref = run(), run_plain()
        check_rows("routing, padded mode, at the training shapes",
                   {"routing": row_scaled_err(routed, routed_ref)})
        rp_err = float((routed - routed_ref).abs().max())
        # The library yardstick at these shapes: one index_add_ of the rows
        # of the slots inside the budget by (view, gid), gathered beforehand
        # (not timed); the same function unless the render overflowed.
        s_len, n = pos.shape[1], offsets.shape[1]
        in_budget = (torch.arange(s_len, device=dev)[None]
                     < counts.long().sum(1, keepdim=True))
        q = pos.long()
        index = (torch.gather(case["gid"].long(), 1, q)
                 + n * torch.arange(v, device=dev)[:, None])[in_budget]
        slot_rows = torch.gather(rows, 1, q[..., None].expand(-1, -1, rec))[in_budget]
        library = lambda: torch.zeros((v * n, rec), device=dev).index_add_(0, index, slot_rows)  # noqa: E731
        lib_err = float((library().reshape(v, n, rec) - routed).abs().max())
        rp_ms = cuda_ms(run, reps=50, warmup=5)
        rp_plain_ms = cuda_ms(run_plain, reps=5, warmup=1)
        rp_lib_ms = cuda_ms(library, reps=50, warmup=5)
        # Bytes: the rows and slot-map entries of the slots inside the budget
        # once each (a clipped slot reads slot S - 1's again), the offsets
        # and counts, the table written once; one add per row of every slot.
        n_read = int(in_budget.sum())
        rp_bytes = 4 * (n_read * (rec + 1) + 2 * v * n + v * n * rec)
        rp_ops = int(counts.long().sum()) * rec
        rp_tb, rp_to = 1e3 * rp_bytes / PEAK_BYTES_S, 1e3 * rp_ops / PEAK_FP32_FLOPS
        print(f"  routing, padded mode (S={s_len}, slots in budget {n_read}): {rp_ms:.4f}"
              f" ms/launch, plain {rp_plain_ms:.3f} ms, index_add_ {rp_lib_ms:.4f} ms (max |d|"
              f" vs kernel {lib_err:.3e}); bound {max(rp_tb, rp_to):.4f} ms (bytes {rp_bytes} ->"
              f" {rp_tb:.4f} ms, adds {rp_ops} -> {rp_to:.5f} ms)", flush=True)
        k3p = dict(err=rp_err, ms=rp_ms, plain_ms=rp_plain_ms,
                   bound=(max(rp_tb, rp_to), rp_tb, rp_to), library_ms=rp_lib_ms)
        del case, rows, routed, routed_ref, index, slot_rows

    # The 8 and 24 px tiles run after the serve, train and measure phases,
    # so that those run after the same work as before these tiles existed.
    with phase("bwd_tiles", 300):
        cams5 = rig_cams(dev, *COMPARE_SIZE, 5)
        for tile in NEW_BWD_TILES:
            compare_tile(args, cams5, tile)
        k2_tiles, k4_tiles = {}, {}
        cams5 = rig_cams(dev, *SERVE_SIZE, 5)
        tile_binnings = {tile: demand_binning(*measure_binning_demand(args, cams5, tile=tile),
                                              tile=tile) for tile in NEW_BWD_TILES}
        for tile, b in tile_binnings.items():
            case = bwd_case(args, cams5, dev, binning=b)
            k2_tiles[str(tile)] = measure_bwd_tile(
                f"K2 tile {tile} at the training shapes", case, composite.composite_fwd_plain,
                composite.composite_bwd_cuda, composite.composite_bwd_plain)
            del case
        for tile, b in tile_binnings.items():
            case = table_case(args, cams5, dataclasses.replace(b, kernel="manual"),
                              composite.composite_manual_fwd_cuda)
            k4_tiles[str(tile)] = measure_bwd_tile(
                f"K4 bwd tile {tile} at the training shapes", case,
                composite.composite_manual_fwd_plain, composite.composite_manual_bwd_cuda,
                composite.composite_manual_bwd_plain)
            del case

    # The tiles above 32 px, after the phases that time the others.
    with phase("large_tiles", 180):
        k1_large, k2_large, k4f_large, k4b_large, large = large_tiles_path(
            dev, args, cloud, views, net, head, base_cfg)
        served.update({k: v for k, v in large.items() if k.startswith("serve_")})
        trained.update({k: v for k, v in large.items() if k.startswith("train_")})

    # These phases run after the measure phases, so that the kernels are
    # timed after the same work as before the phases existed.
    with phase("train_options", 300):
        print(f"  depth cut: {STAGING_ITERATIONS} iterations x {OPTION_TIMESTEPS} timesteps per"
              f" staging mode, 1 iteration for map and bfloat16", flush=True)
        trained.update(options_paths(cloud, views, base_cfg))
        del views

    with phase("cli", 420):
        trained["cli"] = (cli_path(dev, cloud, head), None)

    with phase("knn_native", 180):
        knn_native_check(dev)

    with phase("stage1_step", 300):
        s1_pc, s1_views, s1_radius = stage1_scene(dev, cloud)
        stage1_step_check(dev, cloud, s1_pc, s1_views, s1_radius)

    with phase("stage1", 420):
        print(f"  depth cut: {S1_ITERATIONS} iterations (config 2 fits 30,000); width untouched",
              flush=True)
        counts, fitted, s1_binning = stage1_path(dev, s1_pc, s1_views, s1_radius)
        trained["stage1"] = (counts, None)
        case = table_case(activate_cloud(fitted), rig_cams(dev, *SERVE_SIZE, 1), s1_binning,
                          composite.composite_fwd_cuda)
        k1_s1, k2_s1, _ = measure_table_bwd(
            "K2", case, "K1", composite.composite_fwd_cuda, composite.composite_fwd_plain,
            composite.composite_bwd_cuda, composite.composite_bwd_plain,
            shapes="the stage-1 shape (one view, the fitted cloud)")
        del case, fitted

    with phase("stage1_options", 420):
        for name, counts in stage1_options_path(dev, s1_pc, s1_views, s1_radius).items():
            trained[name] = (counts, None)

    with phase("cli_densify", 300):
        trained["cli_densify"] = (cli_densify_path(dev, s1_pc, s1_views), None)

    # The distributed modes: ranks started with dist.launch share the card
    # over gloo; each phase holds them against the single-process run.
    with phase("dist_render", 300):
        trained["dist_render"] = (dist_render_path(dev, cloud), None)

    with phase("dist_train", 300):
        trained["dist_train"] = (dist_train_path(dev, cloud, base_cfg, card, "dist_train", 2, 1,
                                                 DIST_TIMESTEPS), None)

    with phase("dist_2d", 300):
        trained["dist_2d"] = (dist_train_path(dev, cloud, base_cfg, card, "dist_2d", 2, 2,
                                              DIST_TIMESTEPS), None)

    with phase("dist_stage1", 300):
        trained["dist_stage1"] = (dist_stage1_path(dev, s1_pc, s1_views, s1_radius, card), None)
        del s1_views

    with phase("train_batch", 300):
        trained["train_batch"] = (train_batch_path(dev, cloud), None)

    with phase("acceptance", 180):
        trained["acceptance"] = (acceptance_path(dev), None)

    with phase("acceptance_config4", 420):
        trained["acceptance_config4"] = (acceptance_config4_path(dev, card), None)

    with phase("bench", 60):
        trained["bench"] = (bench_path(dev), None)
        case = bench_case(dev)
        k1_b, k2_b, k3_b = measure_table_bwd(
            "K2", case, "K1", composite.composite_fwd_cuda, composite.composite_fwd_plain,
            composite.composite_bwd_cuda, composite.composite_bwd_plain,
            shapes="the bench shape (one view, 100,000 random Gaussians)", time_plain_fwd=True)
        del case

    for k, v in ptxas_summary(_build.build_log).items():
        print(f"  ptxas {k}: {v}", flush=True)
    launched = {path: counts for path, (counts, _) in {**served, **trained}.items()}
    by_path = lambda name: {p: c[name] for p, c in launched.items() if c[name]}  # noqa: E731
    # The routing kernel has one counter; its slot mode follows the path.
    routes = by_path("route_pairs")
    routes_padded = {p: k for p, k in routes.items() if p in ("train_padded", "stage1_padded")}
    routes_exact = {p: k for p, k in routes.items() if p not in routes_padded}
    kernels = [
        kernel_entry("composite_fwd", "splatpu_torch/csrc/composite_fwd.cu",
                     "splatpu/render/exact.py:856 (_fwd_kernel_grid)", by_path("composite_fwd"),
                     **k1, train=k1_train, tiles=k1_large, stage1=k1_s1, bench=k1_b),
        kernel_entry("composite_bwd", "splatpu_torch/csrc/composite_bwd.cu",
                     "splatpu/render/exact.py:994 (_bwd_kernel_grid)", by_path("composite_bwd"),
                     **k2, tiles={**k2_tiles, **k2_large}, stage1=k2_s1, bench=k2_b),
        kernel_entry("route_pairs", "splatpu_torch/csrc/route_pairs.cu",
                     "splatpu/render/exact.py:1320 (_cumsum_pairs_pallas)", routes_exact, **k3,
                     bench=k3_b),
        kernel_entry("route_pairs_padded", "splatpu_torch/csrc/route_pairs.cu",
                     "splatpu/render/exact.py:1320 (_cumsum_pairs_pallas); slot semantics of"
                     " splatpu/render/pallas_composite.py:507-513", routes_padded, **k3p),
        kernel_entry("composite_manual_fwd", "splatpu_torch/csrc/composite_manual_fwd.cu",
                     "splatpu/render/exact.py:608 (_fwd_kernel)", by_path("composite_manual_fwd"),
                     **k4f, train=k4f_train, tiles=k4f_large),
        kernel_entry("composite_manual_bwd", "splatpu_torch/csrc/composite_manual_bwd.cu",
                     "splatpu/render/exact.py:679 (_bwd_kernel)", by_path("composite_manual_bwd"),
                     **k4b, tiles={**k4_tiles, **k4b_large}),
        kernel_entry("padded_fwd", "splatpu_torch/csrc/padded_fwd.cu",
                     "splatpu/render/pallas_composite.py:113 (_fwd_kernel)",
                     by_path("padded_fwd"), **k5f, train=k5f_train),
        kernel_entry("padded_bwd", "splatpu_torch/csrc/padded_bwd.cu",
                     "splatpu/render/pallas_composite.py:200 (_bwd_kernel)",
                     by_path("padded_bwd"), **k5b),
    ]
    for entry in kernels:
        if not entry["launches"]:
            fail(f"{entry['name']} launched on no path")
    print(f"total {time.perf_counter() - t_start:.2f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

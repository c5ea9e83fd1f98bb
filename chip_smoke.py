"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card and
``nvcc`` (``/usr/local/cuda/bin``). Phases, each of which ends the run with
a nonzero exit if it fails:

1. device: the card's name and power limit (``nvidia-smi``), CUDA version;
2. build: compiles the port's CUDA kernels from ``se2lam_tpu_torch/csrc``
   and prints ptxas's report of each kernel: registers, static shared
   memory and spills;
3. kernel against plain: the FAST+NMS kernel against its plain PyTorch
   version on the card, bitwise over the whole map: the five pyramid levels
   of a rendered bench frame in one launch, a ragged table of random levels
   in one launch, a one-level call on a random 231x309 image, and the
   levels of a uniform-noise frame; times a frame's launch in a CUDA graph
   (the bench frame and the noise frame) and eagerly, each level as a
   one-level call, and the plain version, with CUDA events;
4. extractor: the ORB extractor on the card against the same extractor on
   the CPU, on one bench frame;
5. main path: ORB extraction and the tracking step over 20 frames of the
   synthetic bench world at 640x480, 1000 features, 5 levels, re-seeding
   the reference frame where the step asks for a keyframe; checks the
   launches (one FAST+NMS launch a frame), poses, feature and match counts
   and the keyframe timing;
6. Schur kernel against plain: the Schur point-reduction kernel against
   its plain PyTorch version (the einsum pair) on random SPD systems at
   (K, M) = (2, 130), (2, 1000), (4, 12), (8, 130), (24, 512), (48, 2048),
   (256, 8192), on zeroed point columns (from mid-chunk and from a chunk
   boundary: the same bits as the shorter call), and S bitwise symmetric
   outside its diagonal 3x3 blocks; times it, the plain version and one
   ``torch.einsum`` call, each in a CUDA graph and eagerly, at the
   mini-BA (2, 1000), local-BA and global-BA shapes;
7. mapping: the synchronous SLAM loop, ``SlamSystem(cfg,
   enable_loops=False)`` at the bench configuration with the default
   ``Capacity``, over 60 frames of the bench world with noisy odometry,
   for 3 RANSAC draws: keyframe insertion (its projection match through
   the windowed top-2 kernel), pruning and local BA (the Schur kernel, at
   (K, M) = (48, 2048)) on the card. Checks the launches of all three
   kernels, that every local BA descends, finite poses, the
   keyframe count and ATE against the JAX package's spread, and the
   Schur kernel on the damped system of a real local BA of the run
   (``real_schur_check``);
8. localization: the counted SLAM run's map saved with ``save_map`` and
   loaded back (every field and the vocabulary bitwise); the windowed
   top-2 kernel against its plain version, exact on all four outputs, at
   (8192, 1000), (8191, 997), (200, 300), with every gated distance tied
   at N2 = 1, 31, 32, 33, 997, on all-gated rows and on the real inputs of
   the first tracked localization frame, and its times;
   ``Localizer(cfg, ms, vocab)`` cold on frames 10-49 for 3 RANSAC
   draws, every projection match a kernel launch, localized count and
   error against the JAX package's spread; ``SlamSystem.resume`` on the
   saved map over frames 30-59: relocalized frame, keyframes inserted,
   every local BA descending, the launches of all three kernels;
9. levels past the FAST+NMS kernel's 8-entry table: 9- and 10-level
   pyramids of the bench frame, each level bitwise equal to the plain
   version, two launches a frame, and the extractor's forward pass at
   that depth;
10. loop closing: ``SlamSystem(cfg)`` with its defaults (loops on) at the
   bench configuration with the default ``Capacity`` (256 keyframes, 8192
   points), the keyframe cadence (2-8 frames) and untouched loop gates of
   the JAX package's reference-gates test, on that test's scene (a 72-frame
   lap plus 24 revisit frames of ``SyntheticWorld(n_landmarks=1200,
   room=10.0, seed=4)``), for 2 RANSAC draws: each closes a loop, its
   corrected trajectory beats raw odometry, its keyframe count and ATE lie
   inside the JAX package's spread; every launch of the three kernels is
   counted, the Schur kernel's at the local-BA and the joint-GBA shapes
   (256, 8192); the Schur kernel on the joint GBA's real damped system
   (``real_schur_check``), and its times there; the first closure's
   verification inputs are kept for phase 23; loop-stage (and within it the
   verifications' and pose-only solves'), pose-graph, joint-GBA and
   vocabulary-training times;
11. capacity relief: the same scene and configuration, loops on, with the
   banks cut to 16 keyframes and 2048 points: both reliefs run, the map's
   tables stay consistent after every relief, the BoW bank's rows are
   nonzero exactly on valid keyframes, the corrected trajectory is finite;
12. batch extraction: 32 bench frames in one ``OrbExtractor.forward_batch``
   call, 20 FAST+NMS launches (all levels of all frames), frame by frame
   bitwise the features of ``forward``, its peak device memory and its
   time beside 32 ``forward`` calls;
13. chunked and pipelined SLAM: the mapping phase's 60 frames (loops off,
   seed 0 draws) through ``process_chunk`` (chunks of 8), ``process_async``
   (depth 2) and ``process_chunk_async`` (chunks of 8), each beside
   ``process`` in deterministic mode (see ``deterministic``; phases 13
   and 14 run in a child process, see ``phase_feeds``): the same keyframe
   frames, raw and corrected poses bitwise, every kernel's launches; then each feed timed outside that mode: frames/s and control
   reads a frame; then the loop phase's first draw through ``process`` and
   ``process_chunk`` in deterministic mode: the same keyframes and
   closures;
14. chunked and pipelined localization: frames 10-49 of the localization
   phase through ``Localizer.process_chunk`` (chunks of 8) and
   ``process_async`` beside ``process``, in deterministic mode: the same
   tracked frames, poses bitwise, frames/s, K2 launches and the steps run
   frozen after a loss;
15. fleet tracking: B = 1, 2, 4, 8 robots, robot b on
   ``SyntheticWorld(n_landmarks=500, seed=b)`` at the bench widths for 16
   frames, one ``make_fleet_tracker`` step a frame for the whole fleet:
   each robot's decisions (need_kf, inlier, tracked and parallax counts)
   and feature matches bitwise those of that robot alone through the same
   step at B = 1, its poses (odometry's) within 1e-5, ⌈5B/8⌉ FAST+NMS
   launches a step, ms per robot-frame and peak memory;
16. fleet localization: B = 4 robots (starts 10, 12, 14, 16, odometry
   noise seeds 20-23) x 4 chunks of 8 frames on the saved map, one
   ``make_fleet_localizer`` step a chunk: every robot's poses and tracked
   flags bitwise those of the same robot in a fleet of one; the fleet of
   one against ``Localizer.process_chunk`` chunk by chunk, both started
   from the same carried pose and odometry (tracked flags equal, poses
   within 1e-3), the old whole-run difference printed beside it; exactly
   one K2 launch a chunk step for the whole fleet, robot-frames/s;
17. batched K2 on the fleet's first real step (B = 4, N1 = 8192, N2 =
   1000): one batched launch bitwise equal to the 4 single launches and
   to the batched plain version, all-ties inputs at B = 3, times in a
   graph and eagerly beside the 4 single launches, and its bound;
18. dataset and drivers: the mapping phase's 60 frames written as uint8 to
   a DatasetRoom under ``build/chip_smoke/`` with the port's writer (BMPs,
   odometry, ground truth, CamConfig.yml and Settings.yml);
   ``SystemConfig.from_yaml`` of the written files against the
   configuration (every field the reference's YAML carries); the
   native decoder (required: PIL is not installed there) bitwise on every
   frame, and its ms a frame; SLAM frames/s from disk beside the same
   decoded frames from memory, and the ``run_dataset`` driver's wall time.
   In the deterministic child: ``drivers.run_dataset.main`` on the
   directory (loops off) gives the keyframe frames and poses of an
   in-process ``SlamSystem.process`` over the same decoded frames,
   bitwise, and the map it writes reloads bitwise;
19. live serving: a ``SlamServer`` (chunks of 8, then pipelined at depth 2)
   on 127.0.0.1 in a thread, a ``LiveClient`` streaming the 60 frames. In
   the deterministic child: 60 replies in order, all valid, their poses
   bitwise those of ``process_chunk`` (and of ``process_async``) on a
   fresh system; a ``Localizer`` served on the saved map's frames 10-49
   against ``Localizer.process_chunk``. Outside that mode: frames/s
   served, the client's reply latency (median, p95) and the card's
   round trip (``utils.timing.measure_rtt``); a missing reply fails;
20. map merging at the bench widths: two robots' maps (``SlamSystem(cfg,
   enable_loops=False)``, the loop phase's keyframe cadence) on
   overlapping segments of ``examples/fleet_demo.py``'s circuit, merged
   with ``merge_maps`` for 3 draws (generators 42, 43, 44): the Schur
   kernel's launches at (256, 8192) in the joint GBA and its check on
   that real system, the merged map's tables consistent, its keyframes
   both maps', at least one point fused, B's keyframes within 0.5 m of
   ground truth in A's gauge, the pair, inliers, fused points and B's
   error held to the JAX package's spread (``examples/merge_draws.py``);
   the merged map saved and reloaded bitwise; a ``Localizer`` on it
   relocalizing in both halves; a 2-robot fleet localizer on it (one K2
   launch a chunk step); ``merge_many`` over three segments;
   ``SlamSystem.resume`` on it adding keyframes; the merge's host time and
   its parts (vocabulary, candidate verification, pose graph, joint GBA)
   by CUDA events.

21. mesh solvers: ``entry.dryrun_multichip`` on a mesh of 4 blocks of the
   card (``make_mesh(4, device="cuda")``): the map-block partitioned local
   BA (K=64, M=2048, P=8) against the single-device solver, the
   edge-sharded pose graph (K=256), Hamming and BoW scoring over a split
   bank, fleet tracking over the blocks, the matrix-free PCG joint BA at
   64/2048 against the single optimum and at bank scale (K=2048,
   M=65536, P=6) against ground truth, and the JAX package's 320x240
   revisit session on the mesh, with the JAX asserts; each solve's
   seconds; K3's launches and shapes (one launch per block per LM step at
   (64, 512)), each block's first launch against its plain version in f64
   (in the deterministic child, after the runtime);
22. the mesh session: the loop phase's scene at the bench widths and the
   default Capacity, one draw, ``SlamSystem(cfg, mesh=...)`` on the 4
   blocks: the BoW bank split over them, the pose graph edge-sharded, the
   joint GBA partitioned (K3 at (256, 2048) on each block): the loop
   phase's JAX spread, a loop closed, every kernel's launches (K3: the
   local BAs' plus 4 a joint-GBA step), each block of the first joint GBA
   on its real damped system in f64 (block 0 timed beside the einsum and
   its bound), frames/s beside the single-device loop phase's;
23. slice 8: the 2-KF mini-BA constraint
   (``loopclose.build_loop_constraint_ba``) on the loop phase's first
   closure beside the pose-only one: 10 Schur launches at (2, N), the
   kernel on its first damped system, the relative pose bitwise the
   optimized poses' ``se2.minus``, a symmetric information with clamped
   eigenvalues, the same call on the CPU within MINI_BA_*, its ms;
   ``localmap.remove_outlier_obs`` on the saved mapping map, clean and
   with one point moved 5 m: the victim gone and killed, the tables
   consistent and bitwise the CPU's; the extractor with Harris rescoring
   on 4 bench frames: every output but ``response`` bitwise the output
   without it, ``forward_batch`` bitwise ``forward``, the same K1
   launches, ``response`` within HARRIS_RTOL of the CPU's;
24. slice 9, outside deterministic mode: the mapping phase's 60 frames
   through the split feed (``receive_odo_data``/``receive_img_data``, the
   order alternating), ``get_current_vehicle_pose()`` after each pair
   bitwise the counted ``process`` run's pose on the same generator, the
   same keyframes and K1/K2/K3 launches, then ``request_finish``,
   ``wait_for_finish`` and ``save_map``/``load_map`` bitwise; F7: phase
   7's real local BA, the dense pose graph at K = 256 and the loop phase's
   first joint GBA at (256, 8192), each 5 times on the same inputs, every
   run bitwise the first; the 320x240 barrel-distortion scene of the JAX
   package's ``tests/test_distortion_e2e.py`` (36 frames) on the card and
   on the CPU with the same RANSAC draws: the same keyframes, ATE under 0.3
   and within 0.02 m of the CPU's, a K1 launch a frame; the 160x120 vision
   blackout of ``tests/test_vision_loss.py`` (frames 12-17 blank, or
   noise): finite poses, a keyframe after it, live and corrected ATE under
   0.3.
In the child of phases 13-14 also the runtime: ``parallel.runtime`` over
NCCL at world size 1 holding the 4 blocks, whose psum and distributed pose
graph equal the in-process mesh's bitwise (deterministic mode). Phases 15
and 16 also run their fleets cut over the 4 blocks (``shard_fleet``),
each robot bitwise its fleet without a mesh.

Every phase prints its seconds, and the run its total.

The Schur kernel is held, on every system, to its plain version evaluated
in f64 on the same f32 inputs: random SPD systems within SCHUR_REL_TOL of
max|S| (``schur_check``), real damped systems within SCHUR_ABS_REL_MAX of
their products' magnitude sum, with a one-point control
(``real_schur_check``).

It prints the kernels' JSON line before the last line, and last
``{"ok": true, "device": {...}}``. Nothing of JAX is imported.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from se2lam_tpu_torch import localizer as loc_mod
from se2lam_tpu_torch import localmap, loopclose, mapmerge, tracking
from se2lam_tpu_torch import vocab as vocab_mod
from se2lam_tpu_torch.config import SystemConfig
from se2lam_tpu_torch.drivers import run_dataset as run_dataset_driver
from se2lam_tpu_torch.entry import default_cfg, dryrun_multichip, entry, session_cfg
from se2lam_tpu_torch.frontend import fast_nms as K1
from se2lam_tpu_torch.frontend import windowed_match as K2
from se2lam_tpu_torch.frontend.orb import OrbExtractor, OrbFeatures
from se2lam_tpu_torch.io import (
    DatasetRoom, LiveClient, SlamServer, load_map, native_loader, save_map, write_dataset_room,
)
from se2lam_tpu_torch.io.synthetic import SyntheticWorld, map_gauge
from se2lam_tpu_torch.io.trajectory import ate_se2
from se2lam_tpu_torch.kernels import build_all, load_library, ptxas_summary
from se2lam_tpu_torch.kernels.samples import k2_inputs, k2_robot_inputs
from se2lam_tpu_torch.localizer import Localizer
from se2lam_tpu_torch.mapstate import MapState
from se2lam_tpu_torch.parallel import make_fleet_localizer, make_fleet_tracker, make_mesh
from se2lam_tpu_torch.parallel.dist_loop import ShardedRows
from se2lam_tpu_torch.solver import ba
from se2lam_tpu_torch.solver import schur as K3
from se2lam_tpu_torch.system import SlamSystem
from se2lam_tpu_torch.utils.timing import measure_rtt

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 (non-tensor) op/s
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# FAST+NMS per pixel: 4 B read, 3 maps of 4 B written; f32 operations: 16
# differences, 16 negations, 32 threshold subtractions, 32 clamps, 30 adds,
# 1 max, 64 threshold compares, 2 selects, 2 x (8 maxima + 2 compares +
# 1 select) for the two NMS maps
FAST_BYTES_PER_PX = 16
FAST_OPS_PER_PX = 16 + 16 + 32 + 32 + 30 + 1 + 64 + 2 + 2 * 11
T_HIGH, T_LOW = 20.0, 7.0
# levels of the ragged K1 table: tile indices crossing level boundaries,
# levels smaller than a 64x32 output tile, one 40x72 input tile, and
# (32, 64) exactly one output tile
K1_RAGGED = [(231, 309), (17, 33), (8, 8), (40, 72), (32, 64)]
N_FRAMES = 20
N_DRAWS = 8        # RANSAC draws of the main path
# Schur kernel: the JAX package's own kernel tolerance
# (tests/test_pallas_schur.py), relative to the largest entry
SCHUR_REL_TOL = 1e-5
SCHUR_SHAPES = [(2, 130), (2, 1000), (4, 12), (8, 130), (24, 512), (48, 2048), (256, 8192)]
SCHUR_ZERO_FROM = (65, 96)      # zeroed point columns of (8, 130): mid-chunk, chunk boundary
MINI_BA_SHAPE = (2, 1000)       # (2 keyframes, n_features): the 2-KF mini-BA of slice 8
LOCAL_BA_SHAPE = (48, 2048)     # (local_kfs + local_ref_kfs, local_mps), default Capacity
GLOBAL_BA_SHAPE = (256, 8192)   # (max_kfs, max_mps): the loop-closing slice's joint BA
MAP_FRAMES = 60
MAP_DRAWS = 3      # RANSAC draws of the SLAM loop
ODO_NOISE = (0.004, 0.002, 0.002)   # per-step odometry noise of tests/test_system.py
# The JAX package's spread on these frames (examples/slam_draws.py, CPU,
# 6 draws): 4 keyframes in every draw, live ATE 0.00938-0.01520 m. A draw
# on the card passes with exactly that keyframe count and an ATE no worse
# than 1.5x the worst JAX draw.
JAX_KF = 4
JAX_ATE_MAX = 0.015198489440248385
# windowed top-2 (K2): the int8 tensor-core peak (NVIDIA data sheet), and
# the gate's operations on every pair (2 differences, 2 absolute values,
# 2 window and 2 octave compares, 2 validity ands)
INT8_OPS_PER_S = 1979e12
K2_GATE_OPS = 10
K2_SHAPES = [(8192, 1000), (8191, 997), (200, 300)]
K2_TIED_N2 = (1, 31, 32, 33, 997)   # columns of the all-ties check (pool=1), around a warp's 32
MAP_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke" / "map"
LOC_FRAMES = range(10, 50)
RESUME_FRAMES = range(30, 60)
LOC_NOISE = (0.002, 0.001, 0.001)   # fresh odometry noise, seed 9
LOC_DRAWS = 3
# The JAX package's spread on these frames (examples/loc_draws.py, CPU, 6
# draws, reloc_min_inliers=45): the Localizer relocalizes at frame 10 and
# localizes all 40 frames, median error 0.05264 m, in every draw; resume
# relocalizes at frame 30 and inserts 2 keyframes, median error
# 0.06470-0.09131 m. A card draw passes with the same frames and counts and
# a median error no worse than 1.5x the worst JAX draw.
JAX_LOC_FIRST, JAX_LOC_N, JAX_LOC_ERR_MAX = 10, 40, 0.052635375410318375
JAX_RESUME_FRAME, JAX_RESUME_KF, JAX_RESUME_ERR_MAX = 30, 2, 0.09130726009607315
F1_LEVELS = (9, 10)     # past the kernel's 8-entry level table: two launches a frame
# loop closing: the reference-gates scene of the JAX package's
# tests/test_loop_reference_gates.py, its keyframe cadence, the bench widths
LOOP_CADENCE = dict(min_frames_between_kf=2, max_frames_between_kf=8)
LOOP_NOISE = (0.004, 0.002, 0.002)   # odometry noise per step, seed 3
# 2 draws (3 before the mesh phases came): the mesh session of phase 22 runs
# the scene a third time, held to the same spread, and the script keeps near
# half of its time limit
LOOP_DRAWS = 2
# The JAX package's spread on these frames (examples/loop_draws.py, CPU, 4
# draws): 28-29 keyframes, 2 loops closed in every draw, live ATE
# 0.02551-0.03153 m, corrected ATE 0.01315-0.02227 m, raw odometry's
# 0.03049 m. A card draw passes with a keyframe count in that range, at
# least one loop, a corrected ATE below raw odometry's, and live and
# corrected ATEs no worse than 1.5x the worst JAX draw.
JAX_LOOP_KF = (28, 29)
JAX_LOOP_ATE_MAX = 0.031525466523794274
JAX_LOOP_ATE_CORRECTED_MAX = 0.022268728356580062
# the Schur kernel on every real damped system (a local BA's, a joint
# GBA's, a point block's; real_schur_check): its error from the f64 plain
# version against the sum of its products' magnitudes, two f32 roundings;
# the f32 einsum pair reads 1.3e-9 to 4.1e-9 of it on the dry run's blocks
# (CPU). Taking out the live point with the largest contribution must read
# at least SCHUR_CONTROL_MIN times the bound under the same measure: the
# measure still sees a sum that lost a point
SCHUR_ABS_REL_MAX = 1.2e-7
SCHUR_CONTROL_MIN = 10.0
# capacity relief on the same scene: bank sizes at which both reliefs run
# (examples/loop_draws.py, CPU)
RELIEF_KFS, RELIEF_MPS, RELIEF_FRAMES = 16, 2048, 72
# slice 5: the chunked and pipelined feeds, and fleets
BATCH_FRAMES = 32
FEED_K, FEED_DEPTH = 8, 2
# the feeds against process() run the same eager ops, and in deterministic
# mode give process()'s poses bit for bit (keyframe frames, raw and
# corrected SLAM poses, localization poses all equal); fleet localization
# against one robot's process_chunk runs batched ops, whose sums may take
# another order: within the JAX package's own tolerance between its feeds
# (tests/test_localizer.py)
FEED_LOC_POSE_TOL = 1e-3
FLEET_SIZES, FLEET_FRAMES = (1, 2, 4, 8), 16
FLEET_POSE_TOL = 1e-5          # the JAX package's tests/test_fleet.py
FLEET_LOC_STARTS, FLEET_LOC_K, FLEET_LOC_CHUNKS = (10, 12, 14, 16), 8, 4
# the mesh phases: 4 blocks on the one card (make_mesh(4, device="cuda")),
# as the JAX package's mesh runs on forced host devices
MESH_BLOCKS = 4
FLEET_LOC_NOISE_SEED = 20      # robot r's odometry noise seed is 20 + r
# slice 6: the DatasetRoom written from the mapping phase's frames, the
# driver's output, and the live server
DATA_DIR = MAP_DIR.parent / "dataset"
DRIVER_DIR = MAP_DIR.parent / "run_dataset"
SERVE_CHUNK, SERVE_DEPTH = 8, 2
LIVE_TIMEOUT_S = 120.0         # a reply later than this fails the phase
CAMERA_FPS = 30.0              # the paced client's rate, a camera's
# map merging: examples/fleet_demo.py's circuit at the bench widths, with
# the loop phase's keyframe cadence (at the default 8-30 frames neither
# package merges it: robot A keeps ~5 keyframes 36 degrees apart)
MERGE_CIRCLE, MERGE_A, MERGE_B = 80, range(0, 48), range(24, 80)
MERGE_NOISE_SEED = 0
MERGE_DRAWS = (42, 43, 44)
MERGE_MANY_SEGMENTS = (range(0, 40), range(24, 64), range(48, 80))
MERGE_B_ERR_MAX = 0.5          # tests/test_mapmerge.py:82
# The JAX package's spread on this scene (examples/merge_draws.py, CPU:
# `--maps 8 --draws 1` and `--maps 12 --first-map 8 --draws 1`, mapping
# draws 0-19; `--maps 3 --draws 3` shows the merge draws change nothing):
# in every draw the seam is a view both robots keyframed (frame 43 in 16
# draws, 35 in 3, 39 in 1), so the alignment takes the zero-baseline path;
# 188-214 alignment inliers, 56-114 points fused, B's worst keyframe error
# in A's gauge 0.0926-0.1414 m. A card draw passes with such a seam (one
# frame, inside the overlap), no fewer alignment inliers and fused points
# than the fewest of any JAX draw (a seam no weaker than JAX's; more is no
# fault: the card's maps hold other keyframes and points), and an error no
# worse than 1.5x the worst JAX draw (the rule of the other phases' errors).
JAX_MERGE_PAIR_FRAMES = ((43, 43), (35, 35), (39, 39))
JAX_MERGE_ALIGN_MIN, JAX_MERGE_FUSED_MIN = 188, 56
JAX_MERGE_B_ERR_MAX = 0.14142055809497833
# slice 8: the 2-KF mini-BA constraint on the loop phase's first closure,
# card against CPU in the same process. Over 6 fresh loop-scene maps on an
# H100 (700 W; examples/torch_check_spread.py --mini-ba 5 and a
# chip_smoke.py run) the gate kept the same pairs on both devices, the
# relative pose moved up to 3.05e-4 (along the 2-view gauge direction: two
# calls on the card differ by up to 1.5e-4) and the information up to
# 6.95e-4 of its largest entry
MINI_BA_ITERS = 10              # build_loop_constraint_ba's LM steps, a K3 launch each
MINI_BA_N_GOOD_TOL = 1          # pairs whose chi2 gate may flip between the devices
MINI_BA_MEAS_TOL = 1e-3         # the relative pose, m and rad
MINI_BA_INFO_RTOL = 5e-3        # of max|info|
# Harris rescoring on the card against the CPU, relative to max|R| on the
# frame: level 0 is the same adds in the same order; the upper levels'
# pixels differ in the last ulp through the pyramid's products. Read
# 8.3e-8 to 1.12e-7 on the 4 frames (H100, 700 W)
HARRIS_RTOL = 1e-6
HARRIS_FRAMES = (0, 5, 10, 15)  # main-path frames of the bench world
OUTLIER_SHIFT = (5.0, 5.0, 3.0)  # the JAX package's tests/test_outliers.py corruption
# slice 9 (phase 24): the split feed; F7, the solvers' sums repeatable on the
# card outside deterministic mode; lens distortion and a vision blackout
ODOSLAM_DIR = MAP_DIR.parent / "odoslam_map"
F7_REPEATS = 5
F7_PG_K = 256                   # phase_runtime's pose graph
F7_PG_LOOPS = ((0, F7_PG_K - 30), (10, F7_PG_K - 5), (40, F7_PG_K - 1))
F7_PG_ITERS = 20
SMALL_FRAMES = 36               # tests/test_distortion_e2e.py, tests/test_vision_loss.py
SMALL_ATE_MAX = 0.3             # those tests' bound
SMALL_ODO_NOISE = (0.002, 0.001, 0.001)
DIST_COEFFS = (-0.25, 0.08, 0.0005, -0.0005, 0.0)   # their noticeable barrel
DIST_ATE_TOL = 0.02             # card against the port on the CPU (tests/test_torch_system.py)
BLACKOUT = range(12, 18)        # 6 unusable frames
BLACKOUT_TCB = np.array([[0, 0, 1, 0], [-1, 0, 0, 0], [0, -1, 0, 0.5], [0, 0, 0, 1]],
                        np.float32)
# local BA's ms a keyframe before and after F7's repair (medians of 12
# mapping runs each, the parent's port and the repaired one in turns, parent
# first and last: examples/torch_check_spread.py --ba-ms 3 on an H100 80GB
# HBM3 at 700 W); ``index_put_(accumulate=True)`` in place of the
# segment sum read 112.4 against 88.1 and was not adopted
F7_IN_TURNS = dict(parent_ms=98.22, repaired_ms=89.69, runs=12)


def log(msg):
    print(msg, flush=True)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    return smi


def phase_build():
    t0 = time.perf_counter()
    libs = build_all()
    load_library("fast_nms")
    log(f"build: {sorted(libs)} in {time.perf_counter() - t0:.2f} s")
    for name, lib in sorted(libs.items()):
        for k in ptxas_summary(lib.with_suffix(".log").read_text()):
            log(f"ptxas {name}: " + json.dumps(k))


def events_ms(fn, reps=50, warmup=5):
    """Median over ``reps`` of the CUDA-event time of one ``fn()``."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def graph_ms(fn, inner=20, reps=50):
    """Device time of one ``fn()`` without the host's launch cost: ``inner``
    calls captured in a CUDA graph, the median over ``reps`` replays timed
    with CUDA events, divided by ``inner``."""
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(inner):
            fn()
    return events_ms(g.replay, reps=reps, warmup=3) / inner


def sprinkled_image(rng, H, W):
    """uint8-valued noise with 30 bright 3x3 blocks (corners on purpose)."""
    img = rng.integers(0, 256, (H, W)).astype(np.float32)
    for _ in range(30):
        y, x = rng.integers(20, H - 20), rng.integers(20, W - 20)
        img[y - 1: y + 2, x - 1: x + 2] = 250.0
    return img


def k1_check(got, levels, what):
    """K1's maps against the plain version, level by level: bitwise equal.
    Returns the largest |difference| (0 when equal)."""
    max_err = 0.0
    for img, maps in zip(levels, got):
        want = K1.fast_nms_plain(img, T_HIGH, T_LOW)
        torch.cuda.synchronize()
        for name, g, w in zip(("nms_high", "nms_low", "raw_low"), maps, want):
            err = float((g - w).abs().max())
            max_err = max(max_err, err)
            if g.shape != img.shape or not torch.equal(g, w):
                raise SystemExit(f"chip_smoke: K1 {name} differs from plain at "
                                 f"{tuple(img.shape)} of {what}: max |diff| {err}")
    return max_err


def phase_kernel(extract, world, gt0):
    """K1 against its plain version, and the times of both."""
    img0 = torch.from_numpy(world.render(gt0)).cuda()
    levels = [lv.contiguous() for lv in extract.pyramid(img0)]
    rng = np.random.default_rng(0)
    extra = torch.from_numpy(sprinkled_image(rng, 231, 309)).cuda()
    ragged = [torch.from_numpy(rng.integers(0, 256, s).astype(np.float32)).cuda()
              for s in K1_RAGGED]
    # the kernel skips the full test where the compass pre-test fails, as on
    # the rendered frame's flat background; uniform noise runs it nearly
    # everywhere
    noise = [lv.contiguous() for lv in extract.pyramid(torch.from_numpy(
        rng.integers(0, 256, tuple(img0.shape)).astype(np.float32)).cuda())]
    n0 = K1.fast_nms.launches
    bench = K1.fast_nms_levels(levels, T_HIGH, T_LOW)
    max_err = max(
        k1_check(bench, levels, "the bench frame"),
        k1_check(K1.fast_nms_levels(ragged, T_HIGH, T_LOW), ragged, "the ragged table"),
        k1_check([K1.fast_nms(extra, T_HIGH, T_LOW)], [extra], "a one-level call"),
        k1_check(K1.fast_nms_levels(noise, T_HIGH, T_LOW), noise, "a noise frame"))
    if K1.fast_nms.launches != n0 + 4:
        raise SystemExit(f"chip_smoke: K1 launched {K1.fast_nms.launches - n0} times "
                         "for 4 calls")
    if any(int((lo > 0).sum()) == 0 for _, lo, _ in bench):
        raise SystemExit("chip_smoke: K1 found no corner on a level of the bench frame")
    shapes = [tuple(lv.shape) for lv in levels]
    log(f"kernel: K1 bitwise equal to plain on {shapes} in one launch, on {K1_RAGGED} "
        "in one launch, on (231, 309) alone and on a noise frame's levels")
    t = dict(
        level_ms=[graph_ms(lambda lv=lv: K1.fast_nms(lv, T_HIGH, T_LOW)) for lv in levels],
        ms=graph_ms(lambda: K1.fast_nms_levels(levels, T_HIGH, T_LOW)),
        noise_ms=graph_ms(lambda: K1.fast_nms_levels(noise, T_HIGH, T_LOW)),
        eager_ms=events_ms(lambda: K1.fast_nms_levels(levels, T_HIGH, T_LOW), reps=200),
        plain_ms=graph_ms(lambda: K1.fast_nms_levels_plain(levels, T_HIGH, T_LOW)),
        plain_eager_ms=events_ms(lambda: K1.fast_nms_levels_plain(levels, T_HIGH, T_LOW)),
    )
    px = sum(h * w for h, w in shapes)
    bytes_s = FAST_BYTES_PER_PX * px / HBM_BYTES_PER_S
    ops_s = FAST_OPS_PER_PX * px / F32_OPS_PER_S
    t.update(
        px=px, max_abs_err=max_err,
        bound_ms=1e3 * max(bytes_s, ops_s),
        bound_by="bytes" if bytes_s >= ops_s else "operations",
    )
    log("kernel times (ms per 5-level frame): " + json.dumps(
        {k: t[k] for k in ("ms", "noise_ms", "eager_ms", "plain_ms", "plain_eager_ms",
                           "bound_ms", "level_ms")}))
    return t


def phase_extractor(extract, oc, img):
    """The extractor on the card against the same extractor on the CPU,
    whose plain path the CPU tests hold against the JAX package: the
    moment and pattern-bank products sum in another order on the card,
    which may move an angle and, rarely, a descriptor bit."""
    fg = extract(torch.from_numpy(img).cuda())
    fc = OrbExtractor(oc, device="cpu")(torch.from_numpy(img))
    v = fc.valid
    if not (torch.equal(fg.valid.cpu(), v) and torch.equal(fg.octave.cpu(), fc.octave)):
        raise SystemExit("chip_smoke: the card's keypoint slots differ from the CPU's")
    xy_err = float((fg.xy.cpu()[v] - fc.xy[v]).abs().max())
    same = (fg.desc_bits.cpu().view(torch.int32) == fc.desc_bits.view(torch.int32)).all(1)
    same_share = float(same[v].float().mean())
    log(f"extractor: card vs CPU on {int(v.sum())} keypoints: max |xy diff| "
        f"{xy_err} px, descriptors equal on {same_share:.4f} of them")
    if xy_err > 1e-3 or same_share < 0.99:
        raise SystemExit("chip_smoke: the card's features differ from the CPU's")


def _se2_ref_pose(ref_pose, ref_odo, odo):
    """compose(ref_pose, minus(odo, ref_odo)) in float64 on the host."""
    dx, dy = odo[0] - ref_odo[0], odo[1] - ref_odo[1]
    c, s = math.cos(ref_odo[2]), math.sin(ref_odo[2])
    rel = (c * dx + s * dy, -s * dx + c * dy, odo[2] - ref_odo[2])
    c, s = math.cos(ref_pose[2]), math.sin(ref_pose[2])
    return np.array([
        ref_pose[0] + rel[0] * c - rel[1] * s,
        ref_pose[1] + rel[0] * s + rel[1] * c,
        ref_pose[2] + rel[2],
    ])


def run_path(cfg, oc, extract, imgs, odos, gt, seed):
    """One pass of the main path over the frames: extraction and the
    tracking step, the RANSAC draws from a generator seeded with ``seed``;
    the reference frame is re-seeded where the step asks for a keyframe
    (keyframe insertion itself belongs to the mapping slice)."""
    dev = imgs[0].device
    N = oc.n_slots
    view_mp = torch.zeros((N, 3), dtype=torch.float32, device=dev)
    no_obs = torch.zeros(N, dtype=torch.bool, device=dev)

    def reseed(feats, pose, odo):
        return tracking.init_track_state(feats, pose, odo, 0, view_mp, no_obs)

    gen = torch.Generator(device=dev).manual_seed(seed)
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(3)] for _ in imgs]
    t0 = time.perf_counter()
    ev[0][0].record()
    feats = extract(imgs[0])
    ev[0][1].record()
    ts = reseed(feats, odos[0], odos[0])
    valid, results, refs, need_at = [feats.n], [], [], []
    for i in range(1, len(imgs)):
        ev[i][0].record()
        feats = extract(imgs[i])
        ev[i][1].record()
        refs.append((ts.ref_pose, ts.ref_odom))
        ts, res = tracking.track_frame(ts, feats, odos[i], cfg, generator=gen)
        ev[i][2].record()
        valid.append(feats.n)
        results.append(res)
        if bool(res.need_kf):   # the caller's one read per frame
            need_at.append(i)
            ts = reseed(ts.cur_feats, ts.cur_pose, ts.cur_odom)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0

    # every pose is the odometry prediction, finite
    for (ref_pose, ref_odo), r, i in zip(refs, results, range(1, len(imgs))):
        pose = r.pose.double().cpu().numpy()
        want = _se2_ref_pose(ref_pose.double().cpu().numpy(),
                             ref_odo.double().cpu().numpy(), gt[i].astype(np.float64))
        d = pose - want
        d[2] = math.remainder(d[2], 2 * math.pi)
        if not np.isfinite(pose).all() or np.abs(d).max() > 1e-5:
            raise SystemExit(f"chip_smoke: seed {seed} frame {i} pose {pose} is "
                             f"not the odometry prediction {want}")
    f = ts.cur_feats
    if f.xy.shape != (N, 2) or f.desc_bits.shape != (N, 8) or not torch.isfinite(f.xy).all():
        raise SystemExit("chip_smoke: extractor output has the wrong shape or is not finite")
    return dict(
        seed=seed, n_valid=[int(v) for v in valid],
        n_matched=[int(r.n_matched) for r in results], need_kf_at=need_at,
        extract_ms_per_frame=float(np.median(
            [e[0].elapsed_time(e[1]) for e in ev])),
        track_ms_per_frame=float(np.median(
            [e[1].elapsed_time(e[2]) for e in ev[1:]])),
        loop_s=loop_s, frames_per_s=len(imgs) / loop_s,
    )


def within_jax_spread(run):
    """The bounds every RANSAC draw of the JAX package met on these frames
    (examples/kf_timing_draws.py): >= 850 valid features a frame, >= 120
    matches a tracked frame, the first keyframe request at frame 9-14."""
    need = run["need_kf_at"]
    return (min(run["n_valid"]) >= 850 and min(run["n_matched"]) >= 120
            and bool(need) and 9 <= need[0] <= 14)


def phase_main_path(cfg, oc, extract, world, gt):
    """The counted run of the main path, then more RANSAC draws."""
    dev = torch.device("cuda")
    imgs = [torch.from_numpy(world.render(p)).to(dev) for p in gt]
    odos = [torch.from_numpy(p).to(dev) for p in gt]
    # the packaged entry point (device=None: the card), which also warms up
    # every op of the path before the counted run
    step, example_args = entry()
    _, res = step(*example_args)
    if not torch.isfinite(res.pose).all() or int(res.n_matched) < 100:
        raise SystemExit(f"chip_smoke: entry() step gave {res}")

    K1.fast_nms.launches = 0
    run = run_path(cfg, oc, extract, imgs, odos, gt, seed=0)
    launches = K1.fast_nms.launches
    log("main path: " + json.dumps(dict(run, k1_launches=launches)))
    if launches != len(imgs):
        raise SystemExit(f"chip_smoke: K1 launched {launches} times, "
                         f"want one a frame x {len(imgs)}")

    # The keyframe request depends on the RANSAC draw: in the JAX package
    # the first comes at frame 11 for most draws, with >= 150 matches every
    # frame, and at 13-14 for the rest, with matches down to ~125. Every
    # draw must stay inside that spread, and some draw must take the
    # frame-11 branch.
    runs = [run] + [run_path(cfg, oc, extract, imgs, odos, gt, seed=s)
                    for s in range(1, N_DRAWS)]
    log("draws: " + json.dumps([(r["need_kf_at"], min(r["n_matched"])) for r in runs]))
    bad = [r["seed"] for r in runs if not within_jax_spread(r)]
    if bad:
        raise SystemExit(f"chip_smoke: draws {bad} leave the JAX package's spread")
    if not any(r["need_kf_at"][0] == 11 and min(r["n_matched"]) >= 150 for r in runs):
        raise SystemExit("chip_smoke: no draw took the frame-11 keyframe branch")
    return launches


def spd_inverses(g, M, dev):
    """Inverses of M random SPD 3x3 blocks, contiguous, on ``dev``."""
    L = torch.randn((M, 3, 3), generator=g)
    return torch.linalg.inv(L @ L.transpose(-1, -2) + torch.eye(3)).contiguous().to(dev)


def schur_check(Hpx, Hxx_inv, what):
    """The kernel against the plain version on the same random SPD inputs,
    evaluated in f64: within SCHUR_REL_TOL of its largest entry (these
    systems do not cancel; real ones go through ``real_schur_check``).
    Returns (max |S − S_plain|, relative error)."""
    got = K3.point_reduction(Hpx, Hxx_inv)
    want = K3.point_reduction_plain(Hpx.double(), Hxx_inv.double())
    torch.cuda.synchronize()
    err = float((got.double() - want).abs().max())
    rel = err / max(float(want.abs().max()), 1e-30)
    if not math.isfinite(rel) or rel > SCHUR_REL_TOL:
        raise SystemExit(f"chip_smoke: Schur kernel differs from plain on {what}: "
                         f"relative error {rel} > {SCHUR_REL_TOL}")
    return err, rel


def schur_bound(K, M):
    """(bound ms, bound_by): the f32 operations the function needs, T and
    one triangle of the symmetric S, 2·M·(9·3K + 3·3K(3K+1)/2), over
    67 TFLOP/s, against each input read once and S written once over
    3.35 TB/s. The kernel computes the full S, about twice that work."""
    R = 3 * K
    ops = 2 * M * (9 * R + 3 * R * (R + 1) // 2)
    nbytes = 4 * (9 * K * M + 9 * M + 9 * K * K)
    ops_s, bytes_s = ops / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(ops_s, bytes_s), "operations" if ops_s >= bytes_s else "bytes"


def phase_schur():
    """The Schur kernel against its plain version at every listed shape
    and on zeroed point columns, then its times."""
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    errs = {}
    inputs = {}
    for K, M in SCHUR_SHAPES:
        Hpx = torch.randn((K, 3, M, 3), generator=g).to(dev)
        Hxx_inv = spd_inverses(g, M, dev)
        errs[(K, M)] = schur_check(Hpx, Hxx_inv, f"random SPD (K, M) = ({K}, {M})")
        inputs[(K, M)] = (Hpx, Hxx_inv)
    # zeroed point columns (invalid points) add exact zeros
    Hpx, Hxx_inv = inputs[(8, 130)]
    for z in SCHUR_ZERO_FROM:
        Hz = Hpx.clone()
        Hz[:, :, z:] = 0.0
        full = K3.point_reduction(Hz, Hxx_inv)
        part = K3.point_reduction(Hz[:, :, :z].contiguous(), Hxx_inv[:z].contiguous())
        torch.cuda.synchronize()
        if not torch.equal(full, part):
            raise SystemExit(f"chip_smoke: point columns zeroed from {z} changed the Schur "
                             "kernel's result")
    # the kernel mirrors its upper tiles: S_red[k, l] = S_red[l, k]ᵀ bitwise for k != l
    for K, M in SCHUR_SHAPES:
        S = K3.point_reduction(*inputs[(K, M)])
        off = ~torch.eye(K, dtype=torch.bool, device=dev)
        if not torch.equal(S[off], S.permute(1, 0, 3, 2)[off]):
            raise SystemExit(f"chip_smoke: Schur S is not symmetric at (K, M) = ({K}, {M})")
    log("kernel: Schur within " + json.dumps(
        {f"{K}x{M}": rel for (K, M), (_, rel) in errs.items()})
        + " of plain (f64); zero columns exact; off-diagonal blocks symmetric")

    times = {}
    for K, M in (MINI_BA_SHAPE, LOCAL_BA_SHAPE, GLOBAL_BA_SHAPE):
        Hpx, Hxx_inv = inputs[(K, M)]
        bound, by = schur_bound(K, M)
        fns = dict(
            kernel=lambda: K3.point_reduction(Hpx, Hxx_inv),
            plain=lambda: K3.point_reduction_plain(Hpx, Hxx_inv),
            library=lambda: torch.einsum("kamb,mbd,lcmd->klac", Hpx, Hxx_inv, Hpx),
        )
        t = {name: (graph_ms(f, inner=10, reps=20), events_ms(f, reps=20))
             for name, f in fns.items()}
        times[(K, M)] = dict(
            ms=t["kernel"][0], eager_ms=t["kernel"][1],
            plain_ms=t["plain"][0], plain_eager_ms=t["plain"][1],
            library_ms=t["library"][0], library_eager_ms=t["library"][1],
            below_library=t["kernel"][0] < t["library"][0],
            bound_ms=bound, bound_by=by, max_abs_err=errs[(K, M)][0],
            rel_err=errs[(K, M)][1],
        )
        log(f"kernel times Schur (K, M) = ({K}, {M}) (ms; graph, and eager_): "
            + json.dumps(times[(K, M)]))
    return times


class StageTimer:
    """CUDA events around every call of a module-level function, read
    after the run (the wrapper adds no host synchronisation)."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.events = []

    def __enter__(self):
        def timed(*args, **kw):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = self.orig(*args, **kw)
            b.record()
            self.events.append((a, b))
            return out

        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)

    def ms(self):
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


def run_slam(cfg, imgs, odos, gt, seed):
    """One pass of the SLAM loop with RANSAC draws seeded ``seed``."""
    slam = SlamSystem(cfg, enable_loops=False,
                      generator=torch.Generator(device="cuda").manual_seed(seed))
    slam.log_ba = True
    with StageTimer(tracking, "track_frame") as tr, \
            StageTimer(localmap, "insert_and_optimize") as ins, \
            StageTimer(localmap, "run_local_ba") as lba:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for img, odo in zip(imgs, odos):
            slam.process(img, odo)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        track_ms, insert_ms, ba_ms = tr.ms(), ins.ms(), lba.ms()
    est = np.asarray([p for _, p in slam.trajectory])
    cor = slam.corrected_trajectory()[:, 1:3]
    for rec in slam.ba_log:
        if not rec["chi2"] <= rec["chi2_init"]:
            raise SystemExit(f"chip_smoke: seed {seed}: local BA did not descend: {rec}")
    poses = slam.ms.kf_pose[: slam.n_keyframes()]
    if not np.isfinite(est).all() or not bool(torch.isfinite(poses).all()):
        raise SystemExit(f"chip_smoke: seed {seed}: a pose is not finite")
    return slam, dict(
        seed=seed, kf_frames=slam.kf_frame_ids, n_kf=len(slam.kf_frame_ids),
        n_local_ba=slam.n_local_ba, n_mp=slam.n_map_points(),
        ate=ate_se2(est[:, :2], gt[:, :2])[0], ate_corrected=ate_se2(cor, gt[:, :2])[0],
        chi2_ratio_max=max(r["chi2"] / r["chi2_init"] for r in slam.ba_log),
        frames_per_s=len(imgs) / loop_s, loop_s=loop_s,
        track_ms_per_frame=float(np.median(track_ms)),
        insert_ms_per_kf=float(np.median(insert_ms)),
        local_ba_ms_per_kf=float(np.median(ba_ms)),
    )


def within_jax_spread_slam(run):
    """The rule stated at JAX_KF/JAX_ATE_MAX."""
    return run["n_kf"] == JAX_KF and run["ate"] <= 1.5 * JAX_ATE_MAX


def phase_mapping(cfg, world):
    """The counted SLAM loop, more RANSAC draws, then the Schur kernel on
    the system of the last local BA of the counted run."""
    dev = torch.device("cuda")
    gt = world.circle_trajectory(352, radius=2.5)[:MAP_FRAMES]
    odo = world.odometry(gt, noise=ODO_NOISE, seed=1)
    imgs = [torch.from_numpy(world.render(p)).to(dev) for p in gt]
    # warm-up on the first frames: every op of the loop is loaded once
    run_slam(cfg, imgs[:12], odo[:12], gt[:12], seed=99)

    K1.fast_nms.launches = K2.windowed_top2.launches = K3.point_reduction.launches = 0
    with Counted(localmap, "match_by_projection_streamed") as im:
        slam, run = run_slam(cfg, imgs, odo, gt, seed=0)
    k1, k2, k3 = K1.fast_nms.launches, K2.windowed_top2.launches, K3.point_reduction.launches
    log("mapping: " + json.dumps(dict(run, k1_launches=k1, k2_launches=k2, k3_launches=k3,
                                      insert_projection_matches=im.calls)))
    if k1 != MAP_FRAMES:
        raise SystemExit(f"chip_smoke: K1 launched {k1} times in the SLAM loop, "
                         f"want one a frame x {MAP_FRAMES}")
    if k2 != im.calls or k2 < 1:
        raise SystemExit(f"chip_smoke: K2 launched {k2} times in the SLAM loop for "
                         f"{im.calls} projection matches of keyframe insertion")
    if run["n_local_ba"] < 1 or k3 != cfg.local_iter * run["n_local_ba"]:
        raise SystemExit(f"chip_smoke: the Schur kernel launched {k3} times, want "
                         f"{cfg.local_iter} x {run['n_local_ba']} local BAs")
    runs = [run] + [run_slam(cfg, imgs, odo, gt, seed=s)[1] for s in range(1, MAP_DRAWS)]
    log("mapping draws: " + json.dumps([(r["n_kf"], r["ate"], r["ate_corrected"]) for r in runs]))
    bad = [r["seed"] for r in runs if not within_jax_spread_slam(r)]
    if bad:
        raise SystemExit(f"chip_smoke: SLAM draws {bad} leave the JAX package's spread "
                         f"(keyframes {JAX_KF}, ATE <= {1.5 * JAX_ATE_MAX})")

    real = real_schur_check(*local_ba_system(slam, cfg),
                            f"the local BA of KF {slam._ref_kf_host}", times=False)
    return slam, run, k1, k2, k3, real


def local_ba_system(slam, cfg):
    """(Hpx, Hxx⁻¹) of a real local BA: the window of the SLAM run's last
    keyframe on its final map, assembled and damped as the solver's first
    LM step does."""
    dev = slam.ms.kf_pose.device
    c = tracking.constants(cfg, dev)
    win = localmap.build_local_ba(slam.ms, slam._ref_kf_host, cfg)
    cfg_ba = ba.BAConfig()
    _, _, Hpx, Hxx_inv, _, _ = ba.damped_system(
        win.prob, c["cam"], c["Tcb"], cfg_ba, torch.tensor(cfg_ba.lm_init_lambda, device=dev))
    return Hpx, Hxx_inv


def k2_check(args, what):
    """K2 against its plain version on the same inputs: all four outputs
    equal. Returns the largest |distance difference| (0 when equal)."""
    got = K2.windowed_top2(*args)
    want = K2.windowed_top2_plain(*args)
    torch.cuda.synchronize()
    for name, g, w in zip(("best", "second", "argbest", "argsecond"), got, want):
        if g.dtype != w.dtype or not torch.equal(g, w):
            raise SystemExit(f"chip_smoke: K2 {name} differs from plain on {what}: "
                             f"{int((g != w).sum())} rows")
    return max(float((g - w).abs().max()) for g, w in zip(got[:2], want[:2]))


def k2_bound(args):
    """(bound ms, bound_by, all-pairs bound ms, gated pairs) at these
    inputs. Operations: a dot product of 256 int8 values (512 operations)
    for each pair the gate lets through, over the int8 tensor-core peak,
    plus the gate's operations on every pair over the f32 peak. Bytes:
    each input read once, each output written once. The all-pairs bound
    counts a dot product for every pair."""
    N1, N2 = args[0].shape[0], args[6].shape[0]
    gated = int(K2.windowed_gate(*args[1:6], *args[7:10]).sum())
    ops_s = gated * 512 / INT8_OPS_PER_S + N1 * N2 * K2_GATE_OPS / F32_OPS_PER_S
    nbytes = sum(a.numel() * a.element_size() for a in args) + N1 * 16
    bytes_s = nbytes / HBM_BYTES_PER_S
    all_pairs_s = max(N1 * N2 * 512 / INT8_OPS_PER_S, bytes_s)
    return (1e3 * max(ops_s, bytes_s), "operations" if ops_s >= bytes_s else "bytes",
            1e3 * all_pairs_s, gated)


def phase_k2():
    """K2 against its plain version at every listed shape and on all-gated
    rows."""
    errs = {}
    for i, (N1, N2) in enumerate(K2_SHAPES):
        x = [a.cuda() for a in k2_inputs(N1, N2, seed=i)]
        errs[(N1, N2)] = k2_check(x, f"random ({N1}, {N2})")
    for N2 in K2_TIED_N2:
        x = [a.cuda() for a in k2_inputs(300, N2, seed=5, pool=1)]
        k2_check(x, f"all distances tied (300, {N2})")
    x = [a.cuda() for a in k2_inputs(300, 200, seed=9)]
    x[2] = torch.full_like(x[2], -1.0)          # a negative window admits nothing
    k2_check(x, "all-gated rows")
    best, second, arg, arg2 = K2.windowed_top2(*x)
    if not (bool((best == 1e9).all()) and bool((second == 1e9).all())
            and not bool(arg.any()) and not bool(arg2.any())):
        raise SystemExit("chip_smoke: K2 all-gated rows are not (1e9, 1e9, 0, 0)")
    log(f"kernel: K2 equal to plain on all four outputs at {K2_SHAPES}, with all distances "
        f"tied at N2 = {K2_TIED_N2}, and on all-gated rows")
    return max(errs.values())


def phase_save_reload(slam, path=MAP_DIR):
    """save_map, then load_map on the card: every field and the vocabulary
    bitwise equal."""
    vocab = slam.save_map(str(path))
    ms, vocab2, info = load_map(str(path))
    if vocab is None or vocab2 is None:
        raise SystemExit("chip_smoke: save_map wrote no vocabulary")
    pairs = [(f"ms_{n}", getattr(slam.ms, n), getattr(ms, n)) for n in MapState._fields]
    pairs += [("vocab_words", vocab.words, vocab2.words), ("vocab_idf", vocab.idf, vocab2.idf)]
    for name, a, b in pairs:
        if (a.dtype != b.dtype or a.shape != b.shape or b.device.type != "cuda"
                or a.cpu().numpy().tobytes() != b.cpu().numpy().tobytes()):
            raise SystemExit(f"chip_smoke: {name} differs after save_map/load_map")
    log(f"save/reload: {len(pairs)} arrays bitwise equal, {info['n_kf']} keyframes, "
        f"{info['n_mp']} map points, vocabulary {tuple(vocab.words.shape)}")
    return ms, vocab2


class Counted:
    """Counts the calls of a module-level function, and keeps the arguments
    of the first call and the result of the latest (the wrapper adds no
    host synchronisation)."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.calls, self.first, self.last = 0, None, None

    def __enter__(self):
        def counted(*args, **kw):
            self.calls += 1
            if self.first is None:
                self.first = (args, kw)
            self.last = self.orig(*args, **kw)
            return self.last

        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def run_localize(cfg, ms, vocab, imgs, odo, gt_map, frames, seed):
    """One cold localization pass; returns the run's numbers, the counted
    projection matches and the K2 inputs of its first tracked frame."""
    loc = Localizer(cfg, ms, vocab,
                    generator=torch.Generator(device="cuda").manual_seed(seed))
    real = None
    with Counted(loc_mod, "_project_and_match") as pm, \
            Counted(K2, "projection_match_inputs") as inputs, \
            StageTimer(loc_mod, "_localize_step") as st, \
            StageTimer(loc_mod, "_project_and_match") as mt, \
            StageTimer(loc_mod, "solve_pose_only") as pt, \
            StageTimer(Localizer, "_relocalize") as rt:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        poses, frame_ms = [], []
        for i in frames:
            f0 = time.perf_counter()
            poses.append(loc.process(imgs[i], odo[i]))      # ends in a host read
            frame_ms.append(1e3 * (time.perf_counter() - f0))
            if real is None and loc.trajectory[-1][2]:
                real = inputs.last
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        step_ms, match_ms, pose_ms, reloc_ms = st.ms(), mt.ms(), pt.ms(), rt.ms()
    hit = [(i, p) for i, p in zip(frames, poses) if p is not None]
    if not all(np.isfinite(p).all() for _, p in hit):
        raise SystemExit(f"chip_smoke: localization draw {seed}: a pose is not finite")
    errs = [float(np.linalg.norm(p[:2] - gt_map[i])) for i, p in hit]
    run_localize.last = loc
    return dict(
        seed=seed, first=hit[0][0] if hit else None, n_localized=len(hit),
        n_tracked=sum(t for _, _, t in loc.trajectory),
        median_err=float(np.median(errs)) if errs else None,
        frames_per_s=len(frames) / loop_s, loop_s=loop_s,
        frame_wall_ms_median=float(np.median(frame_ms)), frame_wall_ms_max=max(frame_ms),
        slowest_frame=frames[int(np.argmax(frame_ms))],
        localize_step_ms_per_frame=float(np.median(step_ms)) if step_ms else None,
        project_match_ms_per_call=float(np.median(match_ms)),
        pose_only_ms_per_call=float(np.median(pose_ms)),
        reloc_ms=reloc_ms, projection_matches=pm.calls,
    ), real


def profile_frame(loc, img, odo):
    """One more localization frame under ``torch.profiler``: the CUDA
    kernels it launched, their summed device time, the frame's wall time
    (ends in a synchronise), the device's idle share, and the five kernels
    launched most often (name, launches, device ms). None where the
    profiler saw no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loc.process(img, odo)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return None
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    return dict(cuda_kernels=len(kernels), device_busy_ms=busy_us / 1e3,
                wall_ms=wall_us / 1e3, device_idle_share=1.0 - busy_us / wall_us,
                tracked=bool(loc.trajectory[-1][2]),
                top_kernels=[(name[:60], n, us / 1e3) for name, (n, us) in top])


def within_jax_spread_loc(run):
    """The rule stated at JAX_LOC_FIRST/JAX_LOC_N/JAX_LOC_ERR_MAX."""
    return (run["first"] == JAX_LOC_FIRST and run["n_localized"] == JAX_LOC_N
            and run["median_err"] <= 1.5 * JAX_LOC_ERR_MAX)


def phase_localization(cfg, world, slam):
    """Save and reload the SLAM run's map, localize on it (the counted draw
    and more RANSAC draws), check and time K2 on the real inputs of the
    first tracked frame, then resume SLAM on the saved map."""
    dev = torch.device("cuda")
    gt = world.circle_trajectory(352, radius=2.5)[:MAP_FRAMES]
    gt_map = map_gauge(gt)
    odo = world.odometry(gt, noise=LOC_NOISE, seed=9)
    imgs = [torch.from_numpy(world.render(p)).to(dev) for p in gt]
    ms, vocab = phase_save_reload(slam)
    # warm-up: a short pass loads every op of the path once
    run_localize(cfg, ms, vocab, imgs, odo, gt_map, LOC_FRAMES[:4], seed=99)

    K1.fast_nms.launches = 0
    K2.windowed_top2.launches = 0
    run, real = run_localize(cfg, ms, vocab, imgs, odo, gt_map, LOC_FRAMES, seed=0)
    k1, k2 = K1.fast_nms.launches, K2.windowed_top2.launches
    log("localization: " + json.dumps(dict(run, k1_launches=k1, k2_launches=k2)))
    if k2 != run["projection_matches"] or k2 < len(LOC_FRAMES) - 1:
        raise SystemExit(f"chip_smoke: K2 launched {k2} times for "
                         f"{run['projection_matches']} projection matches")
    if k1 != len(LOC_FRAMES):
        raise SystemExit(f"chip_smoke: K1 launched {k1} times in localization, "
                         f"want one a frame x {len(LOC_FRAMES)}")
    last = LOC_FRAMES[-1]
    log("localization frame profile: " + json.dumps(
        profile_frame(run_localize.last, imgs[last], odo[last])))
    runs = [run] + [run_localize(cfg, ms, vocab, imgs, odo, gt_map, LOC_FRAMES, seed=s)[0]
                    for s in range(1, LOC_DRAWS)]
    log("localization draws: " + json.dumps(
        [(r["first"], r["n_localized"], r["median_err"]) for r in runs]))
    bad = [r["seed"] for r in runs if not within_jax_spread_loc(r)]
    if bad:
        raise SystemExit(f"chip_smoke: localization draws {bad} leave the JAX package's "
                         f"spread (first frame {JAX_LOC_FIRST}, {JAX_LOC_N} localized, "
                         f"median error <= {1.5 * JAX_LOC_ERR_MAX})")

    # K2 on the real inputs of the first tracked frame, then its times there
    if real is None or tuple(real[0].shape) != (cfg.cap.max_mps, 256):
        raise SystemExit("chip_smoke: no tracked frame gave K2 inputs at the bank's size")
    real = tuple(real)
    real_err = k2_check(real, "the first tracked localization frame")
    bound, by, all_pairs, gated = k2_bound(real)
    t = dict(
        shape=(real[0].shape[0], real[6].shape[0]), gated_pairs=gated,
        found_rows=int((K2.windowed_top2(*real)[0] < 1e9).sum()),
        ms=graph_ms(lambda: K2.windowed_top2(*real)),
        eager_ms=events_ms(lambda: K2.windowed_top2(*real)),
        plain_ms=graph_ms(lambda: K2.windowed_top2_plain(*real)),
        plain_eager_ms=events_ms(lambda: K2.windowed_top2_plain(*real)),
        bound_ms=bound, bound_by=by, bound_all_pairs_ms=all_pairs, max_abs_err=real_err,
    )
    log("kernel times K2 (ms) on the first tracked frame: " + json.dumps(t))

    return k1, k2, t, phase_resume(cfg, imgs, odo, gt_map)


def phase_resume(cfg, imgs, odo, gt_map):
    """SlamSystem.resume on the saved map: the relocalized frame, the
    keyframes inserted, every local BA descending, and every kernel's
    launches."""
    slam = SlamSystem.resume(cfg, str(MAP_DIR), enable_loops=False)   # the card
    slam.log_ba = True
    n_kf0 = slam.n_keyframes()
    K1.fast_nms.launches = K2.windowed_top2.launches = K3.point_reduction.launches = 0
    with Counted(loc_mod, "_project_and_match") as pm, \
            Counted(localmap, "match_by_projection_streamed") as im:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        poses = [slam.process(imgs[i], odo[i]) for i in RESUME_FRAMES]
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
    k1, k2, k3 = K1.fast_nms.launches, K2.windowed_top2.launches, K3.point_reduction.launches
    hit = [(i, p) for i, p in zip(RESUME_FRAMES, poses) if np.linalg.norm(p) > 1e-6]
    errs = [float(np.linalg.norm(p[:2] - gt_map[i])) for i, p in hit]
    run = dict(
        reloc_frame=hit[0][0] if hit else None, kf_inserted=slam.n_keyframes() - n_kf0,
        median_err=float(np.median(errs)) if errs else None, n_local_ba=slam.n_local_ba,
        chi2_ratio_max=max((r["chi2"] / r["chi2_init"] for r in slam.ba_log), default=None),
        frames_per_s=len(RESUME_FRAMES) / loop_s, projection_matches=pm.calls,
        insert_projection_matches=im.calls,
        k1_launches=k1, k2_launches=k2, k3_launches=k3,
    )
    log("resume: " + json.dumps(run))
    for rec in slam.ba_log:
        if not rec["chi2"] <= rec["chi2_init"]:
            raise SystemExit(f"chip_smoke: resume: local BA did not descend: {rec}")
    if not all(np.isfinite(p).all() for p in poses) or not bool(
            torch.isfinite(slam.ms.kf_pose[: slam.n_keyframes()]).all()):
        raise SystemExit("chip_smoke: resume: a pose is not finite")
    if not (run["reloc_frame"] == JAX_RESUME_FRAME and run["kf_inserted"] == JAX_RESUME_KF
            and run["median_err"] <= 1.5 * JAX_RESUME_ERR_MAX):
        raise SystemExit(f"chip_smoke: resume leaves the JAX package's spread (relocalized "
                         f"at {JAX_RESUME_FRAME}, {JAX_RESUME_KF} keyframes inserted, median "
                         f"error <= {1.5 * JAX_RESUME_ERR_MAX})")
    # every projection match is a K2 launch: the relocalization's and one
    # for each keyframe insertion
    if k1 != len(RESUME_FRAMES) or pm.calls < 1 or im.calls < 1 or (
            k2 != pm.calls + im.calls) or (
            run["n_local_ba"] < 1 or k3 != cfg.local_iter * run["n_local_ba"]):
        raise SystemExit(f"chip_smoke: resume launches K1 {k1}, K2 {k2} for {pm.calls} + "
                         f"{im.calls} projection matches (relocalization + insertion), "
                         f"K3 {k3} for {run['n_local_ba']} local BAs")
    return run


def phase_f1(world):
    """9- and 10-level pyramids of the bench frame: each level bitwise
    equal to the plain version, one launch per group of 8 levels; the
    extractor's forward pass launches the same two."""
    out = {}
    for n in F1_LEVELS:
        cfg, oc = default_cfg(n_levels=n)
        ext = OrbExtractor(oc)
        img = torch.from_numpy(world.render(world.circle_trajectory(352, radius=2.5)[0])).cuda()
        levels = [lv.contiguous() for lv in ext.pyramid(img)]
        n0 = K1.fast_nms.launches
        err = k1_check(K1.fast_nms_levels(levels, T_HIGH, T_LOW), levels, f"{n} levels")
        n1 = K1.fast_nms.launches
        feats = ext(img)
        torch.cuda.synchronize()
        n2 = K1.fast_nms.launches
        if n1 - n0 != 2 or n2 - n1 != 2:
            raise SystemExit(f"chip_smoke: {n} levels launched K1 {n1 - n0} times in one call "
                             f"and {n2 - n1} in an extraction, want 2 and 2")
        top = int((feats.octave[feats.valid] == n - 1).sum())
        if top == 0:
            raise SystemExit(f"chip_smoke: no keypoint on level {n - 1} of {n}")
        out[n] = dict(max_abs_err=err, launches_call=n1 - n0, launches_extract=n2 - n1,
                      top_level_keypoints=top)
    log("F1: " + json.dumps(out))
    return out


def table_consistency(ms):
    """The forward/inverse observation-table invariants of the JAX
    package's tests/test_prune.check_consistency, vectorized: every live
    inverse entry (point, slot) names a valid keyframe whose forward row
    points back at the point, and every forward entry of a valid keyframe
    names a valid point that lists it."""
    obs_kf, obs_ft, kf_obs, n_obs, mv, kv = (
        t.cpu().numpy().astype(np.int64) for t in (
            ms.mp_obs_kf, ms.mp_obs_feat, ms.kf_obs_mp, ms.mp_n_obs, ms.mp_valid, ms.kf_valid))
    mv, kv = mv.astype(bool), kv.astype(bool)
    K, N = kf_obs.shape
    live = (np.arange(obs_kf.shape[1])[None] < n_obs[:, None]) & mv[:, None]
    m = np.nonzero(live)[0]
    k, f = obs_kf[live], obs_ft[live]
    if not ((k >= 0).all() and kv[k].all() and (kf_obs[k, f] == m).all()):
        return False
    kk, ff = np.nonzero((kf_obs >= 0) & kv[:, None])
    mm = kf_obs[kk, ff]
    return bool(mv[mm].all() and np.isin((mm * K + kk) * N + ff, (m * K + k) * N + f).all())


def loop_frames(world):
    lap = world.circle_trajectory(72)
    gt = np.concatenate([lap, lap[:24]])
    return gt, world.odometry(gt, noise=LOOP_NOISE, seed=3)


def loop_scene(world):
    """The loop phase's configuration, ground truth, odometry and frames."""
    gt, odo = loop_frames(world)
    imgs = [torch.from_numpy(world.render(p)).to("cuda") for p in gt]
    return default_cfg()[0].replace(**LOOP_CADENCE), gt, odo, imgs


def run_loop(cfg, imgs, odo, gt, seed, mesh=None):
    """One pass of SlamSystem(cfg) with its defaults over the loop scene;
    tracking's RANSAC draws seeded ``seed``, the loop closer's 42 + seed.
    With ``mesh`` the global stage runs distributed and staged (its
    stage, pose-graph and joint-GBA timers then time ``start_async``'s
    stages through ``verify_and_build_batch``, ``run_global_ba_dist`` and
    ``run_global_ba_joint_dist``)."""
    slam = SlamSystem(cfg, mesh=mesh, generator=torch.Generator(device="cuda").manual_seed(seed))
    lc = slam._loop_closer
    lc.generator = torch.Generator(device="cuda").manual_seed(42 + seed)
    slam.log_ba = True
    sfx = "" if mesh is None else "_dist"
    with StageTimer(loopclose, "loop_stage") as st, \
            StageTimer(loopclose, "verify_and_build_batch") as vb, \
            StageTimer(loopclose, "solve_pose_only") as po, \
            StageTimer(loopclose, "run_global_ba" + sfx) as pg, \
            StageTimer(loopclose, "run_global_ba_joint" + sfx) as jg, \
            StageTimer(vocab_mod, "train_vocab") as tv:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for img, o in zip(imgs, odo):
            slam.process(img, o)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        stage_ms, pg_ms, joint_ms, vocab_ms = st.ms(), pg.ms(), jg.ms(), tv.ms()
        verify_ms, pose_only_ms = vb.ms(), po.ms()
    est = np.asarray([p for _, p in slam.trajectory])
    cor = slam.corrected_trajectory()
    if not np.isfinite(est).all() or not np.isfinite(cor).all():
        raise SystemExit(f"chip_smoke: loop draw {seed}: a pose is not finite")
    for rec in slam.ba_log:
        if not rec["chi2"] <= rec["chi2_init"]:
            raise SystemExit(f"chip_smoke: loop draw {seed}: local BA did not descend: {rec}")
    return slam, dict(
        seed=seed, kf_frames=slam.kf_frame_ids, n_kf=len(slam.kf_frame_ids),
        n_loops=lc.n_loops_closed, last_loop=lc.last_loop, renewal_gbas=lc.n_renewal_gbas,
        n_local_ba=slam.n_local_ba, n_joint_gba=len(joint_ms), n_pose_graph=len(pg_ms),
        vocab_trainings=lc.n_vocab_trainings, vocab_train_ms=vocab_ms,
        ate=ate_se2(est[:, :2], gt[:, :2])[0],
        ate_corrected=ate_se2(cor[:, 1:3], gt[:, :2])[0],
        ate_odometry=ate_se2(odo[:, :2], gt[:, :2])[0],
        loop_stage_ms_per_kf=median(stage_ms), loop_stage_ms_max=max(stage_ms, default=None),
        verify_build_ms_per_kf=median(verify_ms),
        pose_only_ms_per_call=median(pose_only_ms), pose_only_calls=len(pose_only_ms),
        pose_graph_ms=pg_ms, joint_gba_ms=joint_ms,
        frames_per_s=len(imgs) / loop_s, loop_s=loop_s,
        host_reads_per_frame=slam.host_reads / len(imgs),
    )


def median(xs):
    """The median of a list of times, None for an empty one."""
    return float(np.median(xs)) if xs else None


def loop_draw_ok(run):
    """The rule stated at JAX_LOOP_*."""
    return (run["n_loops"] >= 1 and run["ate_corrected"] < run["ate_odometry"]
            and JAX_LOOP_KF[0] <= run["n_kf"] <= JAX_LOOP_KF[1]
            and run["ate"] <= 1.5 * JAX_LOOP_ATE_MAX
            and run["ate_corrected"] <= 1.5 * JAX_LOOP_ATE_CORRECTED_MAX)


def phase_loop(world):
    """The counted loop-closing run (every kernel launch and the Schur
    kernel's shapes), more RANSAC draws, then the Schur kernel on the
    damped system of the first joint GBA of the counted run."""
    cfg, gt, odo, imgs = loop_scene(world)

    # the shape of every Schur reduction the solver asks for (the kernel's
    # own counter counts its launches)
    shapes = []
    reduce_orig = ba.schur_reduce

    def reduce_spy(Hpp, bp, Hpx, Hxx_inv, bx):
        shapes.append((Hpx.shape[0], Hpx.shape[2]))
        return reduce_orig(Hpp, bp, Hpx, Hxx_inv, bx)

    K1.fast_nms.launches = K2.windowed_top2.launches = K3.point_reduction.launches = 0
    ba.schur_reduce = reduce_spy
    try:
        with Counted(localmap, "match_by_projection_streamed") as im, \
                first_closure() as (joint_in, closing):
            slam, run = run_loop(cfg, imgs, odo, gt, seed=0)
    finally:
        ba.schur_reduce = reduce_orig
    k1, k2, k3 = K1.fast_nms.launches, K2.windowed_top2.launches, K3.point_reduction.launches
    joint_shape = (cfg.cap.max_kfs, cfg.cap.max_mps)
    local_shape = (cfg.cap.local_kfs + cfg.cap.local_ref_kfs, cfg.cap.local_mps)
    n_joint = sum(s == joint_shape for s in shapes)
    log("loop: " + json.dumps(dict(run, k1_launches=k1, k2_launches=k2, k3_launches=k3,
                                   k3_joint_launches=n_joint,
                                   insert_projection_matches=im.calls)))
    want_k3 = cfg.local_iter * run["n_local_ba"] + cfg.gm_joint_ba_iters * run["n_joint_gba"]
    if (k1 != len(imgs) or k2 != im.calls or k2 < 1 or k3 != want_k3
            or set(shapes) != {local_shape, joint_shape} or run["n_joint_gba"] < 1
            or n_joint != cfg.gm_joint_ba_iters * run["n_joint_gba"]):
        raise SystemExit(
            f"chip_smoke: loop launches K1 {k1} (want {len(imgs)}), K2 {k2} for {im.calls} "
            f"insertion matches, K3 {k3} (want {want_k3}) at shapes {sorted(set(shapes))}, "
            f"{n_joint} at the joint-GBA shape {joint_shape} for {run['n_joint_gba']} joint GBAs")
    runs = [run] + [run_loop(cfg, imgs, odo, gt, seed=s)[1] for s in range(1, LOOP_DRAWS)]
    log("loop draws: " + json.dumps([(r["n_kf"], r["n_loops"], r["ate"], r["ate_corrected"],
                                      r["ate_odometry"]) for r in runs]))
    bad = [r["seed"] for r in runs if not loop_draw_ok(r)]
    if bad:
        raise SystemExit(f"chip_smoke: loop draws {bad} leave the JAX package's spread "
                         f"(keyframes {JAX_LOOP_KF}, >= 1 loop, corrected ATE below odometry, "
                         f"ATE <= {1.5 * JAX_LOOP_ATE_MAX}, corrected <= "
                         f"{1.5 * JAX_LOOP_ATE_CORRECTED_MAX})")

    # the Schur kernel on the first joint GBA's real damped system
    joint = joint_schur_check(joint_in.first, "the loop phase's joint GBA")
    return dict(k1=k1, k2=k2, k3=k3, k3_joint=n_joint, run=run, joint=joint, draws=runs,
                closing=closing, joint_first=joint_in.first)


@contextlib.contextmanager
def first_closure():
    """Yields (the ``run_global_ba_joint`` call counter, a dict that gets
    the inputs of the first closure's verification: map, keyframe, loop
    candidate and its match indices). Those are the latest
    ``verify_and_build_batch`` call's before the first joint GBA, which
    only a closure runs; the loop candidate is its last row."""
    joint_in = Counted(loopclose, "run_global_ba_joint")
    closing = {}
    orig = loopclose.verify_and_build_batch

    def spy(ms, k, cands, *args, **kw):
        out = orig(ms, k, cands, *args, **kw)
        if joint_in.calls == 0:
            closing.update(ms=ms, k=k, cand=cands[-1], match_idx=out[0][-1])
        return out

    loopclose.verify_and_build_batch = spy
    try:
        with joint_in:
            yield joint_in, closing
    finally:
        loopclose.verify_and_build_batch = orig


def joint_schur_check(first_call, what, times=True):
    """The Schur kernel on the real damped system of a joint GBA, given the
    arguments of its ``run_global_ba_joint`` call (``real_schur_check``)."""
    dev = torch.device("cuda")
    (ms_in, cfg_in), kw = first_call[0][:2], first_call[1]
    c = tracking.constants(cfg_in, dev)
    prob = loopclose._joint_problem(ms_in, cfg_in)
    ba_cfg = loopclose._joint_ba_cfg(ms_in, cfg_in, kw.get("iters", cfg_in.gm_joint_ba_iters))
    _, _, Hpx, Hxx_inv, _, _ = ba.damped_system(
        prob, c["cam"], c["Tcb"], ba_cfg, torch.tensor(ba_cfg.lm_init_lambda, device=dev))
    joint = real_schur_check(Hpx, Hxx_inv, what, times)
    joint.update(valid_points=int(prob.point_valid.sum()), valid_kfs=int(prob.pose_valid.sum()),
                 valid_obs=int(prob.obs_valid.sum()))
    return joint


def schur_readings(Hpx, Hxx_inv):
    """The Schur kernel on a real damped system against the plain version
    in f64, its error measured against the sum of the products' magnitudes
    (max of the plain version on |Hpx| and |Hxx⁻¹|, the scale a
    floating-point sum of products is accurate to). Hxx⁻¹ reaches ~1e6
    along weakly observed depth directions whose products cancel in S, by
    1e2-1e4 on these systems, and local BA's float ``index_add_`` moves the
    inputs from run to run; so the error against max|S| (``rel_err``,
    beside the f32 einsum pair's and the cancellation) says how much
    cancelled, not how well the kernel sums. The control: the f64 plain
    version without the live point whose largest diagonal term is largest,
    under the same measure."""
    H64, I64 = Hpx.double(), Hxx_inv.double()
    want = K3.point_reduction_plain(H64, I64)
    scale = float(K3.point_reduction_plain(H64.abs(), I64.abs()).abs().max())
    got = K3.point_reduction(Hpx, Hxx_inv)
    plain32 = K3.point_reduction_plain(Hpx, Hxx_inv)
    torch.cuda.synchronize()
    err = float((got.double() - want).abs().max())
    einsum_err = float((plain32.double() - want).abs().max())
    smax = float(want.abs().max())
    live = int((Hpx.abs().sum((0, 1, 3)) > 0).sum())
    out = dict(shape_KM=(Hpx.shape[0], Hpx.shape[2]), live_points=live, max_abs_err=err,
               abs_rel_err=err / scale if scale > 0 else (math.inf if err else 0.0),
               abs_rel_bound=SCHUR_ABS_REL_MAX, max_abs_S=smax, magnitude_scale=scale)
    if scale > 0:
        # a point's contribution Hpx_m Hxx⁻¹_m Hpx_mᵀ is positive
        # semidefinite: its largest entry is a diagonal one
        m = int(torch.einsum("kamb,mbd,kamd->kam", H64, I64, H64).amax((0, 1)).argmax())
        H_drop = H64.clone()
        H_drop[:, :, m] = 0.0
        control = float((K3.point_reduction_plain(H_drop, I64) - want).abs().max()) / scale
        out.update(rel_err=err / smax, einsum_f32_rel_err=einsum_err / smax,
                   einsum_f32_abs_rel_err=einsum_err / scale, cancellation=scale / smax,
                   control_point=m, control_abs_rel=control,
                   control_over_bound=control / SCHUR_ABS_REL_MAX)
    return out


def schur_readings_ok(out):
    """Within SCHUR_ABS_REL_MAX of the magnitude scale, exact zeros on a
    system with no live point (a bank's tail block), and the control at
    least SCHUR_CONTROL_MIN times the bound."""
    return (math.isfinite(out["abs_rel_err"]) and out["abs_rel_err"] <= SCHUR_ABS_REL_MAX
            and (out["magnitude_scale"] == 0
                 or out["control_over_bound"] >= SCHUR_CONTROL_MIN))


def real_schur_check(Hpx, Hxx_inv, what, times=True):
    """``schur_readings`` on a real damped system, held to
    ``schur_readings_ok``; with ``times``, the kernel's, the plain
    version's and the einsum's times there."""
    out = schur_readings(Hpx, Hxx_inv)
    if not schur_readings_ok(out):
        raise SystemExit(f"chip_smoke: Schur kernel on {what}: " + json.dumps(out))
    if times:
        bound, by = schur_bound(Hpx.shape[0], Hpx.shape[2])
        fns = dict(kernel=lambda: K3.point_reduction(Hpx, Hxx_inv),
                   plain=lambda: K3.point_reduction_plain(Hpx, Hxx_inv),
                   library=lambda: torch.einsum("kamb,mbd,lcmd->klac", Hpx, Hxx_inv, Hpx))
        t = {name: (graph_ms(f, inner=10, reps=20), events_ms(f, reps=20))
             for name, f in fns.items()}
        out.update(ms=t["kernel"][0], eager_ms=t["kernel"][1], plain_ms=t["plain"][0],
                   plain_eager_ms=t["plain"][1], library_ms=t["library"][0],
                   library_eager_ms=t["library"][1], bound_ms=bound, bound_by=by)
    log(f"kernel: Schur on {what}'s real damped system (ms; graph, and eager_): "
        + json.dumps(out))
    return out


def phase_relief(world):
    """Both reliefs on the loop scene with the banks cut to RELIEF_KFS
    keyframes and RELIEF_MPS points, loops on."""
    import dataclasses

    dev = torch.device("cuda")
    cfg = default_cfg()[0].replace(**LOOP_CADENCE)
    cfg = cfg.replace(cap=dataclasses.replace(cfg.cap, max_kfs=RELIEF_KFS, max_mps=RELIEF_MPS))
    gt, odo = loop_frames(world)
    gt, odo = gt[:RELIEF_FRAMES], odo[:RELIEF_FRAMES]
    imgs = [torch.from_numpy(world.render(p)).to(dev) for p in gt]
    slam = SlamSystem(cfg, generator=torch.Generator(device="cuda").manual_seed(0))
    reliefs = []
    for name in ("_relieve_capacity", "_relieve_mp_capacity"):
        def checked(fn=getattr(slam, name), name=name):
            out = fn()
            reliefs.append((name, table_consistency(slam.ms)))
            return out
        setattr(slam, name, checked)
    K1.fast_nms.launches = K2.windowed_top2.launches = K3.point_reduction.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for img, o in zip(imgs, odo):
        slam.process(img, o)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    k1, k2, k3 = K1.fast_nms.launches, K2.windowed_top2.launches, K3.point_reduction.launches
    lc = slam._loop_closer
    bank, valid = lc.bank.cpu().numpy(), slam.ms.kf_valid.cpu().numpy()
    bank_ok = bool(np.any(bank[valid] != 0, axis=1).all() and not np.any(bank[~valid] != 0))
    cor = slam.corrected_trajectory()
    run = dict(capacity_compactions=slam.capacity_compactions,
               mp_compactions=slam.mp_compactions, mp_culled_weak=slam.mp_culled_weak,
               anchors_reanchored=slam.anchors_reanchored, n_kf_inserted=len(slam.kf_frame_ids),
               kf_frames=slam.kf_frame_ids, reliefs_consistent=[ok for _, ok in reliefs],
               bank_rows_match_valid=bank_ok, at_capacity=slam.at_capacity,
               ate_corrected=ate_se2(cor[:, 1:3], gt[:, :2])[0], frames_per_s=len(gt) / loop_s,
               k1_launches=k1, k2_launches=k2, k3_launches=k3)
    log("relief: " + json.dumps(run))
    if (slam.capacity_compactions < 1 or slam.mp_compactions < 1 or not reliefs
            or not all(ok for _, ok in reliefs) or not bank_ok or not np.isfinite(cor).all()
            or k1 != len(gt)):
        raise SystemExit("chip_smoke: capacity relief failed its checks: " + json.dumps(run))
    return run


# -- slice 5: batch extraction, the chunked and pipelined feeds, fleets --


def batch_vs_forward(fb, f1, what):
    """A batched extraction's frame against ``forward`` on the same frame:
    every field bitwise equal (the batch builds each frame's pyramid with
    ``forward``'s own products)."""
    for name in f1._fields:
        if not torch.equal(getattr(fb, name), getattr(f1, name)):
            raise SystemExit(f"chip_smoke: batched extraction's {name} differs from forward "
                             f"on {what}")


def phase_batch_extract(extract, oc, world):
    """BATCH_FRAMES bench frames in one forward_batch call."""
    gt = world.circle_trajectory(352, radius=2.5)[:BATCH_FRAMES]
    imgs = torch.from_numpy(np.stack([world.render(p) for p in gt]).astype(np.uint8)).cuda()
    extract.forward_batch(imgs[:2])                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    K1.fast_nms.launches = 0
    fb = extract.forward_batch(imgs)
    torch.cuda.synchronize()
    launches = K1.fast_nms.launches
    peak = torch.cuda.max_memory_allocated() - base
    want = -(-oc.n_levels * BATCH_FRAMES // K1.MAX_LEVELS)
    if launches != want:
        raise SystemExit(f"chip_smoke: a {BATCH_FRAMES}-frame batch launched K1 {launches} "
                         f"times, want {want}")
    for i in range(BATCH_FRAMES):
        batch_vs_forward(tracking.chunk_frame(fb, i), extract(imgs[i]), f"frame {i}")
    batch_ms = events_ms(lambda: extract.forward_batch(imgs), reps=5, warmup=1)
    frames_ms = events_ms(lambda: [extract(im) for im in imgs], reps=5, warmup=1)
    out = dict(frames=BATCH_FRAMES, k1_launches=launches, peak_bytes_above_inputs=peak,
               peak_mib=peak / 2**20, equal_to_forward=True,
               batch_ms_per_frame=batch_ms / BATCH_FRAMES,
               forward_ms_per_frame=frames_ms / BATCH_FRAMES)
    log("batch extraction: " + json.dumps(out))
    return out


def chunk_k1_launches(n, k, n_levels, boot=1):
    """K1 launches of a chunked SLAM feed over n frames in chunks of k: the
    bootstrap frame alone, then every chunk's remaining frames in one batch."""
    total = boot
    for i in range(0, n, k):
        live = min(k, n - i) - (boot if i == 0 else 0)
        total += -(-n_levels * live // K1.MAX_LEVELS)
    return total


def feed_slam(cfg, imgs, odo, feed, seed=0, enable_loops=False):
    """One SLAM run through ``feed``; tracking's draws seeded ``seed``, the
    loop closer's 42 + seed."""
    slam = SlamSystem(cfg, enable_loops=enable_loops,
                      generator=torch.Generator(device="cuda").manual_seed(seed))
    if enable_loops:
        slam._loop_closer.generator = torch.Generator(device="cuda").manual_seed(42 + seed)
    slam.pipeline_depth = FEED_DEPTH
    n = len(imgs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if feed == "process":
        for img, o in zip(imgs, odo):
            slam.process(img, o)
    elif feed == "process_async":
        for img, o in zip(imgs, odo):
            slam.process_async(img, o)
        slam.flush_async()
    elif feed == "process_chunk":
        for i in range(0, n, FEED_K):
            slam.process_chunk(imgs[i:i + FEED_K], odo[i:i + FEED_K])
    else:
        for i in range(0, n, FEED_K):
            slam.process_chunk_async(imgs[i:i + FEED_K], odo[i:i + FEED_K])
        slam.flush_chunk_async()
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    est = np.asarray([p for _, p in slam.trajectory])
    if len(est) != n or not np.isfinite(est).all():
        raise SystemExit(f"chip_smoke: the {feed} feed returned {len(est)} poses or a "
                         "pose that is not finite")
    return slam, dict(feed=feed, kf_frames=slam.kf_frame_ids, frames_per_s=n / loop_s,
                      loop_s=loop_s, host_reads_per_frame=slam.host_reads / n)


@contextlib.contextmanager
def deterministic():
    """``torch.use_deterministic_algorithms`` over a comparison of two feeds.
    Local BA and the vocabulary accumulate floats with ``index_add_`` and
    ``scatter_add_``, whose CUDA versions add in a different order from run
    to run, so two runs of the same feed differ in the last ulps and, over
    many keyframes and a loop closure, in their decisions. In this mode
    those ops take their deterministic versions; an op without one warns
    (logged) instead of raising."""
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield
    finally:
        torch.use_deterministic_algorithms(prev)
    msgs = sorted({str(w.message)[:160] for w in caught})
    if msgs:
        log("deterministic mode warned: " + json.dumps(msgs))


FEEDS = ("process_chunk", "process_async", "process_chunk_async")


def phase_feeds_slam(cfg, world, loop):
    """The chunked and pipelined SLAM feeds beside process() on the mapping
    phase's frames, compared in deterministic mode and timed outside it;
    then the loop phase's first draw (``loop``: ``loop_scene``) through
    process() and process_chunk, in deterministic mode."""
    dev = torch.device("cuda")
    gt = world.circle_trajectory(352, radius=2.5)[:MAP_FRAMES]
    odo = world.odometry(gt, noise=ODO_NOISE, seed=1)
    imgs = [torch.from_numpy(world.render(p)).to(dev) for p in gt]
    for feed in ("process_chunk", "process_chunk_async"):   # warm-up
        feed_slam(cfg, imgs[:12], odo[:12], feed, seed=99)
    with deterministic():
        ref, ref_run = feed_slam(cfg, imgs, odo, "process")
        ref_est = np.asarray([p for _, p in ref.trajectory])
        ref_cor = ref.corrected_trajectory()
        runs, launches = [ref_run], {}
        for feed in FEEDS:
            K1.fast_nms.launches = K2.windowed_top2.launches = K3.point_reduction.launches = 0
            with Counted(localmap, "match_by_projection_streamed") as im:
                slam, run = feed_slam(cfg, imgs, odo, feed)
            k1, k2, k3 = (K1.fast_nms.launches, K2.windowed_top2.launches,
                          K3.point_reduction.launches)
            est = np.asarray([p for _, p in slam.trajectory])
            run.update(
                pose_max_diff=float(np.abs(est - ref_est).max()),
                corrected_max_diff=float(np.abs(slam.corrected_trajectory() - ref_cor).max()),
                k1_launches=k1, k2_launches=k2, k3_launches=k3, n_local_ba=slam.n_local_ba)
            runs.append(run)
            launches[feed] = dict(k1=k1, k2=k2, k3=k3)
            want_k1 = (MAP_FRAMES if feed == "process_async"
                       else chunk_k1_launches(MAP_FRAMES, FEED_K, cfg.max_level))
            if (run["kf_frames"] != ref_run["kf_frames"]
                    or run["pose_max_diff"] != 0.0 or run["corrected_max_diff"] != 0.0
                    or k1 != want_k1
                    or k2 != im.calls or k2 < 1 or k3 != cfg.local_iter * slam.n_local_ba
                    or slam.n_local_ba < 1):
                raise SystemExit(f"chip_smoke: the {feed} feed against process: " + json.dumps(
                    dict(run, want_kf_frames=ref_run["kf_frames"], want_k1=want_k1,
                         insert_projection_matches=im.calls)))
    log("feeds (SLAM loop, loops off, deterministic mode): " + json.dumps(runs))
    timing = [feed_slam(cfg, imgs, odo, feed)[1] for feed in ("process",) + FEEDS]
    log("feeds (SLAM loop, loops off, timed): " + json.dumps(
        [{k: r[k] for k in ("feed", "kf_frames", "frames_per_s", "host_reads_per_frame")}
         for r in timing]))

    # the loop phase's first draw (tracking seed 0, loop closer 42)
    cfg_l, _, odo_l, imgs_l = loop
    loop_runs = []
    with deterministic():
        for feed in ("process", "process_chunk"):
            slam, run = feed_slam(cfg_l, imgs_l, odo_l, feed, seed=0, enable_loops=True)
            lc = slam._loop_closer
            run.update(n_loops=lc.n_loops_closed, last_loop=lc.last_loop)
            loop_runs.append(run)
    log("feeds (loop phase, draw 0, deterministic mode): " + json.dumps(loop_runs))
    want, got = loop_runs
    if (got["kf_frames"] != want["kf_frames"] or got["n_loops"] != want["n_loops"]
            or got["last_loop"] != want["last_loop"] or want["n_loops"] < 1):
        raise SystemExit("chip_smoke: the chunked loop draw differs from process()")
    return dict(runs=runs, timing=timing, launches=launches, loop=loop_runs)


def feed_localize(cfg, ms, vocab, imgs, odo, feed, seed=0):
    loc = Localizer(cfg, ms, vocab, generator=torch.Generator(device="cuda").manual_seed(seed))
    loc.pipeline_depth = FEED_DEPTH
    frames = list(LOC_FRAMES)
    K2.windowed_top2.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if feed == "process":
        for i in frames:
            loc.process(imgs[i], odo[i])
    elif feed == "process_async":
        for i in frames:
            loc.process_async(imgs[i], odo[i])
        loc.flush_async()
    else:
        for c in range(0, len(frames), FEED_K):
            f = frames[c:c + FEED_K]
            loc.process_chunk([imgs[i] for i in f], [odo[i] for i in f])
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    return loc, dict(feed=feed, frames_per_s=len(frames) / loop_s, loop_s=loop_s,
                     k2_launches=K2.windowed_top2.launches,
                     n_tracked=sum(t for _, _, t in loc.trajectory),
                     host_reads_per_frame=loc.host_reads / len(frames),
                     frozen_steps=loc.frozen_steps)


def phase_feeds_localization(cfg, world, ms, vocab):
    dev = torch.device("cuda")
    gt = world.circle_trajectory(352, radius=2.5)[:MAP_FRAMES]
    odo = world.odometry(gt, noise=LOC_NOISE, seed=9)
    imgs = [torch.from_numpy(world.render(p)).to(dev) for p in gt]
    feed_localize(cfg, ms, vocab, imgs, odo, "process_chunk", seed=99)     # warm-up
    with deterministic():
        ref, ref_run = feed_localize(cfg, ms, vocab, imgs, odo, "process")
        feeds = [feed_localize(cfg, ms, vocab, imgs, odo, feed)
                 for feed in ("process_chunk", "process_async")]
    runs = [ref_run]
    for loc, run in feeds:
        feed = run["feed"]
        flags = [t for _, _, t in loc.trajectory] == [t for _, _, t in ref.trajectory]
        holes = [(p is None) for _, p, _ in loc.trajectory] == [
            (p is None) for _, p, _ in ref.trajectory]
        diffs = [float(np.abs(p - q).max()) for (_, p, _), (_, q, _)
                 in zip(loc.trajectory, ref.trajectory) if p is not None and q is not None]
        run.update(same_tracked=flags and holes, pose_max_diff=max(diffs, default=0.0))
        runs.append(run)
        if not (flags and holes) or run["pose_max_diff"] != 0.0 or (
                run["k2_launches"] < run["n_tracked"]):
            raise SystemExit(f"chip_smoke: the Localizer's {feed} feed against process: "
                             + json.dumps(run))
    log("feeds (localization, deterministic mode): " + json.dumps(runs))
    return runs


FEEDS_CHILD_TIMEOUT_S = 600


def phase_feeds(map_dir):
    """Phases 13 and 14, and the deterministic parts of 18 and 19, in a
    child process, which alone sets cuBLAS's
    deterministic workspace (``CUBLAS_WORKSPACE_CONFIG``, read once, when a
    process first uses cuBLAS; ``torch.use_deterministic_algorithms`` needs
    it). Every other phase runs with cuBLAS's default workspace. The child
    builds nothing: it loads the kernels built here and the saved map.
    Returns the child's results: the SLAM and localization feeds, the
    dataset driver and the live server against their feeds."""
    out = Path(map_dir).parent / "feeds.json"
    out.unlink(missing_ok=True)
    sys.stdout.flush()
    r = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--feeds", str(out)],
                       env=dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8"),
                       timeout=FEEDS_CHILD_TIMEOUT_S)
    if r.returncode != 0:
        raise SystemExit(f"chip_smoke: the feeds' process exited with code {r.returncode}")
    return json.loads(out.read_text())


def feeds_main(out):
    """The child of ``phase_feeds``: phases 13 and 14, the run_dataset
    driver of phase 18 and the comparisons of phase 19, their results as
    JSON in ``out``."""
    if os.environ.get("CUBLAS_WORKSPACE_CONFIG") != ":4096:8":
        raise SystemExit("chip_smoke --feeds: run with CUBLAS_WORKSPACE_CONFIG=:4096:8")
    cfg, _ = default_cfg()
    world = SyntheticWorld(cfg, n_landmarks=500, seed=0)
    loop = loop_scene(SyntheticWorld(cfg, n_landmarks=1200, room=10.0, seed=4))
    feeds = timed("feeds slam", phase_feeds_slam, cfg, world, loop)
    ms, vocab, _ = load_map(str(MAP_DIR))
    loc_feeds = timed("feeds localization", phase_feeds_localization, cfg, world, ms, vocab)
    driver = timed("dataset driver", phase_dataset_driver)
    live = timed("live serving (deterministic)", phase_live_compare, cfg, world, ms, vocab)
    mesh = make_mesh(MESH_BLOCKS, device="cuda")
    rt = timed("runtime", phase_runtime, mesh)
    with deterministic():
        solvers = timed("mesh solvers", phase_mesh_solvers, mesh)
    Path(out).write_text(json.dumps(dict(slam=feeds, localization=loc_feeds, driver=driver,
                                         live=live, runtime=rt, mesh_solvers=solvers)))
    return 0


def phase_fleet_tracking(cfg, oc, mesh=None):
    """B robots, robot b on its own world, one fleet step a frame; with
    ``mesh``, B = MESH_BLOCKS robots cut over its blocks beside the same
    fleet without one (bitwise)."""
    dev = torch.device("cuda")
    Bmax = max(FLEET_SIZES)
    imgs, odos = [], []
    for b in range(Bmax):
        w = SyntheticWorld(cfg, n_landmarks=500, seed=b)
        gt = w.circle_trajectory(352, radius=2.5)[:FLEET_FRAMES]
        imgs.append(np.stack([w.render(p) for p in gt]))
        odos.append(gt)
    imgs = torch.from_numpy(np.stack(imgs)).to(dev)                 # (B, T, H, W)
    odos = torch.from_numpy(np.stack(odos).astype(np.float32)).to(dev)
    noise = torch.stack([torch.stack([
        tracking.draw_track_noise(g, cfg) for _ in range(1, FLEET_FRAMES)])
        for g in (torch.Generator(device=dev).manual_seed(b) for b in range(Bmax))])
    fns = make_fleet_tracker(cfg, oc)
    mesh_fns = make_fleet_tracker(cfg, oc, mesh=mesh) if mesh is not None else None

    def run(robots, on_mesh=False):
        init_fn, step_fn, extract_fn = mesh_fns if on_mesh else fns
        rb = list(robots)
        ts = init_fn(extract_fn(imgs[rb, 0]), odos[rb, 0], odos[rb, 0])
        out = []
        torch.cuda.synchronize()
        K1.fast_nms.launches = 0
        t0 = time.perf_counter()
        for t in range(1, FLEET_FRAMES):
            ts, res = step_fn(ts, imgs[rb, t], odos[rb, t], noise[rb, t - 1])
            if on_mesh:
                res, ts_h = res.gather(), ts.gather()
            else:
                ts_h = ts
            # the caller's one read a step: every robot's decisions, pose
            # and feature matches (integers, exact in f32)
            out.append(torch.cat([
                torch.stack([res.need_kf, res.n_matched, res.n_tracked_old, ts_h.n_good_prl],
                            1).to(torch.float32),
                res.pose, ts_h.match_idx.to(torch.float32)], 1).cpu().numpy())
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        return np.stack(out, 1), dt, K1.fast_nms.launches   # (B, T-1, 7 + N)

    run(range(2))                                  # warm-up
    alone = [run([b])[0][0] for b in range(Bmax)]
    out = {}
    for B in FLEET_SIZES:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        got, dt, k1 = run(range(B))
        peak = torch.cuda.max_memory_allocated() - base
        steps = FLEET_FRAMES - 1
        want_k1 = steps * -(-cfg.max_level * B // K1.MAX_LEVELS)
        diff = max(float(np.abs(got[b][:, 4:7] - alone[b][:, 4:7]).max()) for b in range(B))
        # the pose comes from odometry alone; the decisions and matches are
        # what the batched extraction, match and RANSAC compute
        dec_diff = [(b, s) for b in range(B) for s in range(steps)
                    if not np.array_equal(got[b, s, :4], alone[b][s, :4])]
        midx_diff = [(b, s) for b in range(B) for s in range(steps)
                     if not np.array_equal(got[b, s, 7:], alone[b][s, 7:])]
        out[B] = dict(ms_per_robot_frame=1e3 * dt / (B * steps), steps=steps, k1_launches=k1,
                      k1_per_step=k1 / steps, pose_max_diff_vs_alone=diff,
                      decision_steps_differing_alone=dec_diff,
                      match_steps_differing_alone=midx_diff, peak_mib=peak / 2**20,
                      min_matched=float(got[:, :, 1].min()),
                      need_kf_steps=int(got[:, :, 0].sum()))
        if (k1 != want_k1 or diff > FLEET_POSE_TOL or dec_diff or midx_diff
                or not np.isfinite(got).all() or got[:, :, 1].max() < 50):
            raise SystemExit(f"chip_smoke: fleet tracking at B = {B}: " + json.dumps(
                dict(out[B], want_k1=want_k1)))
    if mesh is not None:
        Bm = mesh.size
        got, _, k1 = run(range(Bm), on_mesh=True)
        ref = run(range(Bm))[0]
        out["mesh"] = dict(B=Bm, blocks=mesh.size, k1_launches=k1,
                           bitwise_vs_no_mesh=bool(np.array_equal(got, ref)))
        if not out["mesh"]["bitwise_vs_no_mesh"]:
            raise SystemExit("chip_smoke: fleet tracking on the mesh differs from the fleet "
                             "without one: " + json.dumps(out["mesh"]))
    log("fleet tracking: " + json.dumps(out))
    return out


def se2_minus_np(p, ref):
    """The SE(2) pose ``p`` in ``ref``'s frame, in float64 on the host."""
    dx, dy = p[0] - ref[0], p[1] - ref[1]
    c, s = math.cos(ref[2]), math.sin(ref[2])
    return np.array([c * dx + s * dy, -s * dx + c * dy,
                     math.remainder(p[2] - ref[2], 2 * math.pi)])


def phase_fleet_localization(cfg, world, ms, vocab, mesh=None):
    """``fleet_localization_run`` and its checks (``fleet_loc_ok``)."""
    run, real = fleet_localization_run(cfg, world, ms, vocab, mesh)
    if not fleet_loc_ok(run):
        raise SystemExit("chip_smoke: fleet localization failed its checks")
    return run, real


def fleet_loc_ok(run):
    """Phase 16's checks of a ``fleet_localization_run``."""
    return (run["fleet_bitwise_fleet_of_one"] and run["flags_equal_chunkwise"]
            and run["pose_max_diff_chunkwise"] <= FEED_LOC_POSE_TOL
            and all(x == run["k"] for x in run["k2_launches_per_chunk"])
            and run["tracked"] >= 0.95 * run["robot_frames"] and run["mesh_bitwise"] is not False)


def fleet_localization_run(cfg, world, ms, vocab, mesh=None):
    """B robots x chunks of k frames on the saved map, one fleet step a
    chunk. Checks (``fleet_loc_ok``): (i) every robot's poses and tracked flags at B bitwise
    those of the same robot in a fleet of one; (ii) the fleet of one held
    against ``Localizer.process_chunk`` chunk by chunk, both runs of a
    chunk started from the same carried pose and odometry, within
    FEED_LOC_POSE_TOL (the JAX package's comparison of its feeds,
    ``tests/test_localizer.py``); the old whole-run difference against one
    continuous ``process_chunk`` run is printed beside them. With ``mesh``
    the fleet's robots are cut over its blocks (``shard_fleet``). Returns
    the run and the arguments of the fleet's first batched K2 launch."""
    dev = torch.device("cuda")
    B, k, n_chunks = len(FLEET_LOC_STARTS), FLEET_LOC_K, FLEET_LOC_CHUNKS
    gt = world.circle_trajectory(352, radius=2.5)[:MAP_FRAMES]
    first, last = min(FLEET_LOC_STARTS), max(FLEET_LOC_STARTS) + k * n_chunks
    frame_img = {i: torch.from_numpy(world.render(gt[i])).to(dev) for i in range(first, last)}
    odos = [world.odometry(gt, noise=LOC_NOISE, seed=FLEET_LOC_NOISE_SEED + r).astype(np.float32)
            for r in range(B)]
    pose0 = np.stack([se2_minus_np(gt[s], gt[0]) for s in FLEET_LOC_STARTS]).astype(np.float32)
    last0 = np.stack([odos[r][s] for r, s in enumerate(FLEET_LOC_STARTS)])

    def chunk(c, robots):
        fr = [[FLEET_LOC_STARTS[r] + c * k + j for j in range(k)] for r in robots]
        im = torch.stack([torch.stack([frame_img[i] for i in row]) for row in fr])
        od = np.stack([odos[r][row] for r, row in zip(robots, fr)])
        return im, od

    extract_fn, step_fn = make_fleet_localizer(cfg, ms)
    if mesh is not None:
        m_extract, m_step = make_fleet_localizer(cfg, ms, mesh=mesh)

    def run_fleet(robots, on_mesh=False):
        rb = list(robots)
        pose_b, last_b = torch.from_numpy(pose0[rb]).to(dev), torch.from_numpy(last0[rb]).to(dev)
        poses, tracked, k2, carries = [], [], [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c in range(n_chunks):
            carries.append((pose_b.cpu().numpy(), last_b.cpu().numpy()))
            im, od = chunk(c, rb)
            od = torch.from_numpy(od).to(dev)
            K2.windowed_top2.launches = 0
            if on_mesh:
                p, t = (x.gather() for x in m_step(pose_b, last_b, m_extract(im), od))
            else:
                p, t = step_fn(pose_b, last_b, extract_fn(im), od)
            k2.append(K2.windowed_top2.launches)
            # the host's one read a chunk; a lost robot's carry stays frozen
            h = torch.cat([t.to(torch.float32)[..., None], p], -1).cpu().numpy()
            poses.append(h[..., 1:])
            tracked.append(h[..., 0] > 0)
            pose_b = p[:, -1]
            last_b = torch.where(t.all(1)[:, None], od[:, -1], last_b)
        torch.cuda.synchronize()
        return (np.concatenate(poses, 1), np.concatenate(tracked, 1), k2,
                time.perf_counter() - t0, carries)

    run_fleet(range(B))                                           # warm-up
    with Counted(K2, "_top2_batched_op") as spy:
        poses, tracked, k2, dt, _ = run_fleet(range(B))
    if spy.calls != k * n_chunks or spy.first is None:
        raise SystemExit(f"chip_smoke: fleet localization made {spy.calls} batched K2 calls")
    real = tuple(spy.first[0])

    # (i) each robot in the fleet against itself in a fleet of one
    alone = [run_fleet([r]) for r in range(B)]
    fleet_bitwise = all(np.array_equal(poses[r], alone[r][0][0])
                        and np.array_equal(tracked[r], alone[r][1][0]) for r in range(B))
    mesh_bitwise = None
    if mesh is not None:
        mp, mt = run_fleet(range(B), on_mesh=True)[:2]
        mesh_bitwise = bool(np.array_equal(mp, poses) and np.array_equal(mt, tracked))

    # (ii) the fleet of one against Localizer.process_chunk, chunk by chunk
    loc = Localizer(cfg, ms, vocab)
    chunk_diffs, flags_ok = [], True
    for r in range(B):
        p1, t1, carries = alone[r][0][0], alone[r][1][0], alone[r][4]
        for c in range(n_chunks):
            im, od = chunk(c, [r])
            loc.set_pose(carries[c][0][0], carries[c][1][0])
            out = loc.process_chunk(list(im[0]), list(od[0]))
            fl = list(map(bool, t1[c * k:(c + 1) * k]))
            upto = fl.index(False) if False in fl else k
            flags_ok &= [p is not None for p in out[:upto]] == fl[:upto]
            chunk_diffs += [float(np.abs(p1[c * k + j] - out[j]).max()) for j in range(upto)
                            if out[j] is not None]

    # the old comparison: one continuous process_chunk run a robot
    singles, single_s = [], 0.0
    for r in range(B):
        loc = Localizer(cfg, ms, vocab)
        loc.set_pose(pose0[r], last0[r])
        out = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c in range(n_chunks):
            im, od = chunk(c, [r])
            out.extend(loc.process_chunk(list(im[0]), list(od[0])))
        torch.cuda.synchronize()
        single_s += time.perf_counter() - t0
        singles.append(out)
    whole = []
    for r in range(B):
        fl = list(map(bool, tracked[r]))
        upto = fl.index(False) if False in fl else len(fl)
        whole += [float(np.abs(poses[r, j] - singles[r][j]).max()) for j in range(upto)
                  if singles[r][j] is not None]
    n = B * k * n_chunks
    run = dict(B=B, k=k, chunks=n_chunks, robot_frames=n, tracked=int(tracked.sum()),
               robot_frames_per_s=n / dt, single_robot_frames_per_s=n / single_s,
               k2_launches_per_chunk=k2, fleet_bitwise_fleet_of_one=fleet_bitwise,
               pose_max_diff_chunkwise=max(chunk_diffs, default=0.0),
               flags_equal_chunkwise=flags_ok, pose_tol=FEED_LOC_POSE_TOL,
               pose_max_diff_whole_run=max(whole, default=0.0),
               mesh_bitwise=mesh_bitwise, n1_n2=(real[0].shape[0], real[6].shape[1]))
    log("fleet localization: " + json.dumps(run))
    return run, real


def k2_batched_check(args, what):
    """One batched launch against the single launches robot by robot and
    against the batched plain version: all four outputs equal."""
    n0 = K2.windowed_top2.launches
    got = K2.windowed_top2_batched(*args)
    if K2.windowed_top2.launches != n0 + 1:
        raise SystemExit("chip_smoke: the batched K2 call was not one launch")
    plain = K2.windowed_top2_batched_plain(*args)
    B = args[1].shape[0]
    for b in range(B):
        one = [a if i in (0, 2, 3, 4) else a[b] for i, a in enumerate(args)]
        for name, g, p, w in zip(("best", "second", "argbest", "argsecond"), got, plain,
                                 K2.windowed_top2(*one)):
            if not (torch.equal(g[b], w) and torch.equal(p[b], w)):
                raise SystemExit(f"chip_smoke: batched K2 {name} of robot {b} differs on {what}")
    torch.cuda.synchronize()


def k2_batched_bound(args):
    """(bound ms, bound_by) of one batched launch: B times the single
    bound's work (each robot's gated pairs' dot products over the int8
    peak, the gate on all its pairs over the f32 peak), bytes read and
    written once."""
    B = args[1].shape[0]
    gated = sum(int(K2.windowed_gate(args[1][b], *args[2:5], args[5][b], args[7][b],
                                     args[8][b], args[9][b]).sum()) for b in range(B))
    N1, N2 = args[0].shape[0], args[6].shape[1]
    ops_s = gated * 512 / INT8_OPS_PER_S + B * N1 * N2 * K2_GATE_OPS / F32_OPS_PER_S
    nbytes = sum(a.numel() * a.element_size() for a in args) + B * N1 * 16
    bytes_s = nbytes / HBM_BYTES_PER_S
    return 1e3 * max(ops_s, bytes_s), "operations" if ops_s >= bytes_s else "bytes", gated


def phase_k2_batched(real):
    k2_batched_check(real, "the fleet's first real step")
    ties, _ = k2_robot_inputs(3, 300, 997, seed=6, pool=1)
    k2_batched_check([a.cuda() for a in ties], "all-ties inputs at B = 3")
    B = real[1].shape[0]
    singles = [[a if i in (0, 2, 3, 4) else a[b].contiguous() for i, a in enumerate(real)]
               for b in range(B)]
    bound, by, gated = k2_batched_bound(real)
    t = dict(
        B=B, shape_N1N2=(real[0].shape[0], real[6].shape[1]), gated_pairs=gated,
        ms=graph_ms(lambda: K2.windowed_top2_batched(*real)),
        eager_ms=events_ms(lambda: K2.windowed_top2_batched(*real)),
        singles_ms=graph_ms(lambda: [K2.windowed_top2(*x) for x in singles]),
        singles_eager_ms=events_ms(lambda: [K2.windowed_top2(*x) for x in singles]),
        # one robot eagerly through the wrapper (a direct launch for plain
        # tensors), through the custom op that vmap reaches, and through the
        # ctypes launch beneath both: the host cost of the op's dispatch
        single_eager_ms=events_ms(lambda: K2.windowed_top2(*singles[0])),
        single_op_eager_ms=events_ms(lambda: K2._top2_op(*singles[0])),
        single_direct_eager_ms=events_ms(lambda: K2._launch(None, singles[0])),
        op_eager_ms=events_ms(lambda: K2._top2_batched_op(*real)),
        plain_ms=graph_ms(lambda: K2.windowed_top2_batched_plain(*real), inner=5, reps=20),
        plain_eager_ms=events_ms(lambda: K2.windowed_top2_batched_plain(*real), reps=20),
        bound_ms=bound, bound_by=by, max_abs_err=0.0,
    )
    log("kernel times K2 batched (ms) on the fleet's first real step: " + json.dumps(t))
    return t


# -- slice 6: the dataset and its driver, live serving, map merging --


def mapping_frames(world):
    """The mapping phase's ground truth, odometry and frames, the frames as
    the uint8 a dataset on disk and the wire carry."""
    gt = world.circle_trajectory(352, radius=2.5)[:MAP_FRAMES]
    odo = world.odometry(gt, noise=ODO_NOISE, seed=1)
    return gt, odo, [np.clip(world.render(p), 0, 255).astype(np.uint8) for p in gt]


def dataset_root():
    return str(DATA_DIR / "DatasetRoom")


def dataset_cfg():
    """The configuration read back from the written dataset's YAMLs."""
    return SystemConfig.from_yaml(str(DATA_DIR / "CamConfig.yml"), str(DATA_DIR / "Settings.yml"))


def feed_frames(slam, frames):
    """``slam.process`` over (image, odometry) pairs: (frames fed, seconds,
    ending in a synchronise)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = 0
    for img, o in frames:
        slam.process(img, o)
        n += 1
    torch.cuda.synchronize()
    return n, time.perf_counter() - t0


def phase_dataset(cfg, world):
    """Write the mapping phase's frames as a DatasetRoom, read the YAMLs and
    frames back through the native decoder, and time SLAM from disk beside
    the same frames from memory and the driver end to end."""
    import dataclasses
    import shutil

    gt, odo, frames = mapping_frames(world)
    shutil.rmtree(DATA_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    root = write_dataset_room(str(DATA_DIR), frames, odo, cfg, gt=gt)
    write_s = time.perf_counter() - t0
    ycfg = dataset_cfg()
    # the reference's format carries Tbc as a Rodrigues vector printed to 10
    # digits, and the keyframe cadence only as fps (fps // 3 to fps frames)
    same = dataclasses.replace(ycfg, Tbc=cfg.Tbc, min_frames_between_kf=cfg.min_frames_between_kf,
                               max_frames_between_kf=cfg.max_frames_between_kf) == cfg
    tbc_err = float(np.abs(np.asarray(ycfg.Tbc) - np.asarray(cfg.Tbc)).max())
    cadence = (ycfg.min_frames_between_kf, ycfg.max_frames_between_kf)
    if not same or tbc_err > 1e-9 or cadence != (cfg.fps // 3, cfg.fps):
        raise SystemExit(f"chip_smoke: SystemConfig.from_yaml of the written dataset differs: "
                         f"fields equal {same}, Tbc {tbc_err}, cadence {cadence}")
    ds = DatasetRoom(root)
    if not ds.use_native:
        raise SystemExit("chip_smoke: DatasetRoom did not take the native decoder")
    t0 = time.perf_counter()
    decoded = list(ds)
    stream_s = time.perf_counter() - t0
    bad = [i for i, ((img, _), want) in enumerate(zip(decoded, frames))
           if img.dtype != np.uint8 or not np.array_equal(img, want)]
    if len(decoded) != MAP_FRAMES or bad:
        raise SystemExit(f"chip_smoke: the dataset read back {len(decoded)} frames, "
                         f"frames {bad} differ from those written")
    decode_ms = []
    for i in range(MAP_FRAMES):
        t0 = time.perf_counter()
        native_loader.decode_bmp(ds.image_path(i))
        decode_ms.append(1e3 * (time.perf_counter() - t0))

    # timed outside deterministic mode: disk against memory, the driver
    mem = [(torch.from_numpy(img), o) for img, o in decoded]
    feed_frames(SlamSystem(ycfg, enable_loops=False), mem[:12])            # warm-up
    K1.fast_nms.launches = K2.windowed_top2.launches = K3.point_reduction.launches = 0
    slam = SlamSystem(ycfg, enable_loops=False,
                      generator=torch.Generator(device="cuda").manual_seed(0))
    n_disk, disk_s = feed_frames(slam, DatasetRoom(root))
    k1, k2, k3 = K1.fast_nms.launches, K2.windowed_top2.launches, K3.point_reduction.launches
    n_mem, mem_s = feed_frames(SlamSystem(ycfg, enable_loops=False,
                                          generator=torch.Generator(device="cuda").manual_seed(0)),
                               mem)
    t0 = time.perf_counter()
    run_dataset_driver.main([root, "--out", str(DRIVER_DIR.parent / "run_dataset_timed"),
                             "--frames", str(MAP_FRAMES), "--no-loops"])
    driver_s = time.perf_counter() - t0
    out = dict(frames=n_disk, write_s=write_s, decode_ms_per_frame=float(np.median(decode_ms)),
               prefetch_stream_ms_per_frame=1e3 * stream_s / MAP_FRAMES,
               disk_frames_per_s=n_disk / disk_s, memory_frames_per_s=n_mem / mem_s,
               driver_wall_s=driver_s, kf_frames=slam.kf_frame_ids, tbc_err=tbc_err,
               cadence=cadence, k1_launches=k1, k2_launches=k2, k3_launches=k3,
               n_local_ba=slam.n_local_ba)
    log("dataset: " + json.dumps(out))
    if k1 != MAP_FRAMES or k2 < 1 or k3 != ycfg.local_iter * slam.n_local_ba or k3 < 1:
        raise SystemExit("chip_smoke: SLAM from disk launched " + json.dumps(out))
    return out


def slam_bits(slam):
    """What the disk and serving comparisons hold bitwise: keyframe frames,
    the live keyframe poses and every frame's pose."""
    n = slam.n_keyframes()
    return (slam.kf_frame_ids, slam.ms.kf_pose[:n].cpu().numpy().tobytes(),
            np.asarray([p for _, p in slam.trajectory], np.float32).tobytes())


def phase_dataset_driver():
    """In the deterministic child: the run_dataset driver on the written
    dataset against ``process`` over the same decoded frames, and its saved
    map reloaded."""
    import shutil

    shutil.rmtree(DRIVER_DIR, ignore_errors=True)
    root = dataset_root()
    with deterministic():
        slam = run_dataset_driver.main([root, "--out", str(DRIVER_DIR), "--frames",
                                        str(MAP_FRAMES), "--no-loops"])
        ref = SlamSystem(dataset_cfg(), enable_loops=False,
                         generator=torch.Generator(device="cuda").manual_seed(0))
        feed_frames(ref, DatasetRoom(root))
    ms, _vocab, info = load_map(str(DRIVER_DIR / "map"))
    reload_ok = all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(ms, slam.ms))
    out = dict(kf_frames=slam.kf_frame_ids, want_kf_frames=ref.kf_frame_ids,
               same_bits=slam_bits(slam) == slam_bits(ref), map_reloads_bitwise=reload_ok,
               n_kf_saved=info["n_kf"])
    log("dataset driver (deterministic mode): " + json.dumps(out))
    if not (out["same_bits"] and reload_ok and slam.n_keyframes() >= 2):
        raise SystemExit("chip_smoke: the run_dataset driver against process: " + json.dumps(out))
    return out


def serve(system, frames, odos, fps=0.0, **kw):
    """Stream (frame, odometry) pairs through a ``SlamServer`` on 127.0.0.1
    in a thread: a sender thread writes every frame (as fast as it can, or
    paced at ``fps``) while this thread reads the replies. Returns the
    replies (frame id, pose, valid) and each frame's send and reply times.
    A reply missing for LIVE_TIMEOUT_S fails."""
    import threading

    srv = SlamServer(system, **kw).start()
    t_send = [0.0] * len(frames)
    t_recv = [0.0] * len(frames)
    replies = []
    try:
        H, W = frames[0].shape
        cl = LiveClient(srv.address, H, W, timeout_s=LIVE_TIMEOUT_S)

        def send():
            t0 = time.perf_counter()
            for i, (img, o) in enumerate(zip(frames, odos)):
                if fps > 0:
                    time.sleep(max(0.0, t0 + i / fps - time.perf_counter()))
                t_send[i] = time.perf_counter()
                cl.send_frame(img, o)

        sender = threading.Thread(target=send, daemon=True)
        sender.start()
        for _ in frames:
            try:
                fid, pose, ok = cl.recv_pose()
            except (OSError, ConnectionError) as e:
                raise SystemExit(f"chip_smoke: the live server sent {len(replies)} of "
                                 f"{len(frames)} replies, then: {e!r}")
            t_recv[fid] = time.perf_counter()
            replies.append((fid, pose, ok))
        sender.join(timeout=LIVE_TIMEOUT_S)
        cl.close()
    finally:
        srv.stop()
    if [r[0] for r in replies] != list(range(len(frames))) or srv.frames_served != len(frames):
        raise SystemExit(f"chip_smoke: the live server replied to frames "
                         f"{[r[0] for r in replies]} ({srv.frames_served} served)")
    return replies, np.asarray(t_send), np.asarray(t_recv)


def live_inputs(world):
    _, odo, frames = mapping_frames(world)
    return frames, np.asarray(odo, np.float32)


def fresh_slam(cfg):
    return SlamSystem(cfg, enable_loops=False,
                      generator=torch.Generator(device="cuda").manual_seed(0))


def phase_live_compare(cfg, world, ms, vocab):
    """In the deterministic child: served SLAM (chunked, then pipelined)
    and a served Localizer, each against the feed it drives on a fresh
    estimator; the poses cross the wire as f32, so they compare bitwise."""
    frames, odo = live_inputs(world)
    loc_odo = np.asarray(world.odometry(world.circle_trajectory(352, radius=2.5)[:MAP_FRAMES],
                                        noise=LOC_NOISE, seed=9), np.float32)
    out = {}
    with deterministic():
        replies, _, _ = serve(fresh_slam(cfg), frames, odo, chunk=SERVE_CHUNK)
        ref = fresh_slam(cfg)
        want = np.concatenate([ref.process_chunk(frames[i:i + SERVE_CHUNK], odo[i:i + SERVE_CHUNK])
                               for i in range(0, MAP_FRAMES, SERVE_CHUNK)])
        got = np.stack([r[1] for r in replies])
        out["chunked"] = dict(all_valid=all(r[2] for r in replies),
                              same_bits=got.tobytes() == want.astype(np.float32).tobytes())

        replies, _, _ = serve(fresh_slam(cfg), frames, odo, pipeline=SERVE_DEPTH)
        ref = fresh_slam(cfg)
        ref.pipeline_depth = SERVE_DEPTH
        for img, o in zip(frames, odo):
            ref.process_async(img, o)
        ref.flush_async()
        want = np.stack([p for _, p in ref.trajectory]).astype(np.float32)
        got = np.stack([r[1] for r in replies])
        out["pipelined"] = dict(all_valid=all(r[2] for r in replies),
                                same_bits=got.tobytes() == want.tobytes())

        li = [frames[i] for i in LOC_FRAMES]
        lo = loc_odo[list(LOC_FRAMES)]

        def loc():
            return Localizer(cfg, ms, vocab, generator=torch.Generator(device="cuda").manual_seed(7))

        K2.windowed_top2.launches = 0
        replies, _, _ = serve(loc(), li, lo, chunk=SERVE_CHUNK)
        k2 = K2.windowed_top2.launches
        ref = loc()
        want = []
        for c in range(0, len(li), SERVE_CHUNK):
            want.extend(ref.process_chunk(li[c:c + SERVE_CHUNK], lo[c:c + SERVE_CHUNK]))
        flags = [r[2] for r in replies] == [p is not None for p in want]
        same = flags and all(r[1].tobytes() == np.asarray(w, np.float32).tobytes()
                             for r, w in zip(replies, want) if w is not None)
        out["localizer"] = dict(localized=sum(r[2] for r in replies), same_flags=flags,
                                same_bits=same, k2_launches=k2)
    log("live serving (deterministic mode): " + json.dumps(out))
    if not (out["chunked"]["all_valid"] and out["chunked"]["same_bits"]
            and out["pipelined"]["all_valid"] and out["pipelined"]["same_bits"]
            and same and out["localizer"]["localized"] >= len(LOC_FRAMES) // 2
            and k2 >= out["localizer"]["localized"]):
        raise SystemExit("chip_smoke: the live server against its feeds: " + json.dumps(out))
    return out


def phase_live_timed(cfg, world):
    """Outside deterministic mode, chunked and pipelined: frames/s served
    to a client that sends as fast as it can, with the kernels' launches,
    and the reply latency (median, p95) of a client paced at a camera's
    CAMERA_FPS; then the card's round trip."""
    frames, odo = live_inputs(world)
    out = {}
    for name, kw in (("chunked", dict(chunk=SERVE_CHUNK)), ("pipelined", dict(pipeline=SERVE_DEPTH))):
        K1.fast_nms.launches = K2.windowed_top2.launches = K3.point_reduction.launches = 0
        replies, ts, tr = serve(fresh_slam(cfg), frames, odo, **kw)
        launches = dict(k1_launches=K1.fast_nms.launches, k2_launches=K2.windowed_top2.launches,
                        k3_launches=K3.point_reduction.launches)
        paced, ps, pr = serve(fresh_slam(cfg), frames, odo, fps=CAMERA_FPS, **kw)
        lat = 1e3 * (pr - ps)
        out[name] = dict(frames_per_s=len(frames) / (tr.max() - ts.min()),
                         burst_latency_ms_median=float(np.median(1e3 * (tr - ts))),
                         paced_fps=CAMERA_FPS, latency_ms_median=float(np.median(lat)),
                         latency_ms_p95=float(np.percentile(lat, 95)),
                         all_valid=all(r[2] for r in replies + paced), **launches)
    out["rtt_ms"] = 1e3 * measure_rtt(reps=20)
    log("live serving (timed): " + json.dumps(out))
    if not all(out[n]["all_valid"] and min(out[n]["k1_launches"], out[n]["k2_launches"],
                                           out[n]["k3_launches"]) >= 1
               for n in ("chunked", "pipelined")):
        raise SystemExit("chip_smoke: the timed live runs: " + json.dumps(out))
    return out


def merge_cfg():
    return default_cfg()[0].replace(**LOOP_CADENCE)


def merge_scene():
    """The merge phase's world, circuit and a segment's frames on the card
    with its own odometry (noise integrated from the segment's start)."""
    cfg = merge_cfg()
    world = SyntheticWorld(cfg, n_landmarks=800, room=12.0, seed=1)
    gt = np.asarray(world.circle_trajectory(MERGE_CIRCLE))

    def segment(frames):
        g = gt[list(frames)]
        return ([torch.from_numpy(world.render(p)).to("cuda") for p in g],
                world.odometry(g, noise=ODO_NOISE, seed=MERGE_NOISE_SEED))
    return cfg, world, gt, segment


def build_map(cfg, imgs, odo):
    slam = SlamSystem(cfg, enable_loops=False,
                      generator=torch.Generator(device="cuda").manual_seed(0))
    feed_frames(slam, zip(imgs, odo))
    return slam


def live_frame_ids(slam):
    """Frame ids (segment-relative) of the live keyframes in slot order: the
    order of ``merge_maps``' compaction."""
    valid = slam.ms.kf_valid.cpu().numpy()[: len(slam.kf_frame_ids)]
    return [f for f, v in zip(slam.kf_frame_ids, valid) if v]


def merge_draw_ok(run):
    """The rule stated at JAX_MERGE_*."""
    fa, fb = run["pair_frames"]
    return (fa == fb and MERGE_B[0] <= fa <= MERGE_A[-1]
            and run["align_inliers"] >= JAX_MERGE_ALIGN_MIN
            and run["mps_fused"] >= JAX_MERGE_FUSED_MIN
            and run["b_kf_err_max"] <= 1.5 * JAX_MERGE_B_ERR_MAX)


def phase_merge():
    """Two robots' maps merged at the bench widths for MERGE_DRAWS, every
    check of the merged map, then its uses: save/reload, a Localizer, a
    fleet localizer, merge_many and resume."""
    dev = torch.device("cuda")
    cfg, world, gt, segment = merge_scene()
    seg_a, seg_b = segment(MERGE_A), segment(MERGE_B)
    feed_frames(SlamSystem(cfg, enable_loops=False), zip(*(x[:12] for x in seg_a)))  # warm-up
    K1.fast_nms.launches = K2.windowed_top2.launches = K3.point_reduction.launches = 0
    slam_a, slam_b = build_map(cfg, *seg_a), build_map(cfg, *seg_b)
    mapping = dict(k1_launches=K1.fast_nms.launches, k2_launches=K2.windowed_top2.launches,
                   k3_launches=K3.point_reduction.launches,
                   n_local_ba=slam_a.n_local_ba + slam_b.n_local_ba)
    if (mapping["k1_launches"] != len(MERGE_A) + len(MERGE_B) or mapping["k2_launches"] < 1
            or mapping["k3_launches"] != cfg.local_iter * mapping["n_local_ba"]):
        raise SystemExit("chip_smoke: the merge phase's mapping launched " + json.dumps(mapping))
    fa, fb = live_frame_ids(slam_a), live_frame_ids(slam_b)
    a0 = gt[MERGE_A[0]]
    want_b = map_gauge(np.concatenate([a0[None], gt[[MERGE_B[f] for f in fb]]]))[1:]

    shapes = []
    reduce_orig = ba.schur_reduce

    def reduce_spy(Hpp, bp, Hpx, Hxx_inv, bx):
        shapes.append((Hpx.shape[0], Hpx.shape[2]))
        return reduce_orig(Hpp, bp, Hpx, Hxx_inv, bx)

    runs, merged0 = [], None
    for seed in MERGE_DRAWS:
        shapes.clear()
        K1.fast_nms.launches = K2.windowed_top2.launches = K3.point_reduction.launches = 0
        ba.schur_reduce = reduce_spy
        try:
            with Counted(mapmerge, "run_global_ba_joint") as jg, \
                    StageTimer(vocab_mod, "train_vocab") as tv, \
                    StageTimer(mapmerge, "align_transform") as al, \
                    StageTimer(mapmerge, "verify_loop") as vl, \
                    StageTimer(mapmerge, "run_global_ba") as pg, \
                    StageTimer(mapmerge, "run_global_ba_joint") as jt:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                merged, info = mapmerge.merge_maps(
                    slam_a.ms, slam_b.ms, cfg,
                    generator=torch.Generator(device=dev).manual_seed(seed))
                torch.cuda.synchronize()
                merge_s = time.perf_counter() - t0
                parts = dict(vocab_ms=sum(tv.ms()), align_ms=sum(al.ms()), verify_ms=sum(vl.ms()),
                             pose_graph_ms=sum(pg.ms()), joint_gba_ms=sum(jt.ms()))
        finally:
            ba.schur_reduce = reduce_orig
        k1, k2, k3 = K1.fast_nms.launches, K2.windowed_top2.launches, K3.point_reduction.launches
        ka, kb = info["pair"]
        kp = merged.kf_pose.cpu().numpy()
        b_err = np.linalg.norm(kp[len(fa):len(fa) + len(fb), :2] - want_b, axis=1)
        run = dict(seed=seed, pair=[ka, kb], pair_frames=[MERGE_A[fa[ka]], MERGE_B[fb[kb]]],
                   bow_score=info["bow_score"], align_inliers=info["align_inliers"],
                   n_kp=info["n_kp"], n_mp_pairs=info["n_mp_pairs"], mps_fused=info["mps_fused"],
                   seam_edge_inliers=info["seam_edge_inliers"], gba_chi2=info["gba_chi2"],
                   joint_chi2=info["joint_chi2"], n_kf=int(merged.n_kf), n_kf_a=len(fa),
                   n_kf_b=len(fb), b_kf_err_max=float(b_err.max()), merge_s=merge_s, **parts,
                   consistent=table_consistency(merged), k1_launches=k1, k2_launches=k2,
                   k3_launches=k3, k3_shapes=sorted(set(shapes)))
        joint = joint_schur_check(jg.first, f"the merge's joint GBA (draw {seed})",
                                  times=merged0 is None)
        run["joint_schur_abs_rel_err"] = joint["abs_rel_err"]
        run["joint_schur_rel_err"] = joint["rel_err"]
        runs.append(run)
        log("merge: " + json.dumps(run))
        if (k3 != cfg.gm_joint_ba_iters or set(shapes) != {GLOBAL_BA_SHAPE}
                or not run["consistent"] or run["n_kf"] != len(fa) + len(fb)
                or run["mps_fused"] < 1 or run["b_kf_err_max"] >= MERGE_B_ERR_MAX
                or not bool(torch.isfinite(merged.kf_pose).all())):
            raise SystemExit(f"chip_smoke: merge draw {seed} failed its checks")
        if merged0 is None:
            merged0, info0, joint0 = merged, info, joint
    bad = [r["seed"] for r in runs if not merge_draw_ok(r)]
    if bad:
        raise SystemExit(f"chip_smoke: merge draws {bad} leave the JAX package's spread "
                         f"(a seam of one view inside the overlap, as JAX's "
                         f"{JAX_MERGE_PAIR_FRAMES}, align inliers >= {JAX_MERGE_ALIGN_MIN}, "
                         f"fused >= {JAX_MERGE_FUSED_MIN}, B's keyframe error <= "
                         f"{1.5 * JAX_MERGE_B_ERR_MAX})")

    # the merged map saved and reloaded, then served
    mdir = MAP_DIR.parent / "merged"
    save_map(str(mdir), merged0, info0["vocab"])
    ms, vocab, _ = load_map(str(mdir))
    if not (all(torch.equal(a, b) for a, b in zip(ms, merged0))
            and all(torch.equal(a, b) for a, b in zip(vocab, info0["vocab"]))):
        raise SystemExit("chip_smoke: the merged map differs after save_map/load_map")
    K1.fast_nms.launches = K2.windowed_top2.launches = 0
    loc = Localizer(cfg, ms, vocab, generator=torch.Generator(device=dev).manual_seed(7))
    halves = {}
    for half, f in (("A", 8), ("B", 60)):         # one query a half; reloc may take 3 frames
        hits = []
        for j in range(3):
            p = loc.process(torch.from_numpy(world.render(gt[f + j])).to(dev),
                            np.asarray(gt[f + j], np.float32))
            hits.append(p is not None)
        halves[half] = hits
    localizer = dict(halves=halves, k1_launches=K1.fast_nms.launches,
                     k2_launches=K2.windowed_top2.launches)

    # a two-robot fleet on the merged map, one robot a half
    K = 8
    extract_l, step_l = make_fleet_localizer(cfg, ms)
    starts = (12, 64)
    imgs = torch.stack([torch.stack([torch.from_numpy(world.render(gt[s + 1 + i]))
                                     for i in range(K)]) for s in starts]).to(dev)
    odos = np.stack([gt[s + 1: s + 1 + K] for s in starts]).astype(np.float32)
    seeds = np.stack([np.concatenate([map_gauge(np.stack([a0, gt[s]]))[1],
                                      [math.atan2(math.sin(gt[s, 2] - a0[2]),
                                                  math.cos(gt[s, 2] - a0[2]))]])
                      for s in starts]).astype(np.float32)
    feats = extract_l(imgs)
    K2.windowed_top2.launches = 0
    poses, tracked = step_l(seeds, gt[list(starts)].astype(np.float32), feats, odos)
    tracked = tracked.cpu().numpy()
    fleet = dict(k2_launches=K2.windowed_top2.launches, chunk_steps=K,
                 tracked_per_robot=tracked.sum(1).tolist())
    log("merged map served: " + json.dumps(dict(localizer=localizer, fleet=fleet)))
    if not (any(halves["A"]) and any(halves["B"]) and fleet["k2_launches"] == K
            and min(fleet["tracked_per_robot"]) >= K // 2):
        raise SystemExit("chip_smoke: the merged map's localizers failed: "
                         + json.dumps(dict(localizer=localizer, fleet=fleet)))

    # resume mapping on the merged map, in B's half
    res = SlamSystem.resume(cfg, str(mdir), enable_loops=False,
                            generator=torch.Generator(device=dev).manual_seed(0))
    kf0 = res.n_keyframes()
    feed_frames(res, ((torch.from_numpy(world.render(gt[f])).to(dev),
                       np.asarray(gt[f], np.float32)) for f in range(60, 80)))
    resume = dict(relocalized=not res._resume_pending, kf_before=kf0,
                  kf_after=res.n_keyframes(), consistent=table_consistency(res.ms))
    # merge_many: three robots on thirds of the circuit
    maps = [build_map(cfg, *segment(s)).ms for s in MERGE_MANY_SEGMENTS]
    many, infos = mapmerge.merge_many(maps, cfg)
    many_out = dict(n_kf=int(many.n_kf), want_n_kf=sum(int(m.kf_valid.sum()) for m in maps),
                    fused=[i["mps_fused"] for i in infos], consistent=table_consistency(many))
    log("merged map resumed, merge_many: " + json.dumps(dict(resume=resume, merge_many=many_out)))
    if not (resume["relocalized"] and resume["kf_after"] > kf0 and resume["consistent"]
            and many_out["n_kf"] == many_out["want_n_kf"] and many_out["consistent"]
            and min(many_out["fused"]) >= 1):
        raise SystemExit("chip_smoke: resume or merge_many on the merged map failed")
    return dict(mapping=mapping, runs=runs, joint=joint0, localizer=localizer, fleet=fleet,
                resume=resume, merge_many=many_out)


def schur_spy(keep_shape=None, keep=0):
    """A stand-in for ``ba.schur_reduce`` that records every call's (K, M)
    and keeps the (Hpx, Hxx⁻¹) of the first ``keep`` calls at
    ``keep_shape``; install with ``spied_schur``."""
    spy = dict(shapes=[], kept=[])
    orig = ba.schur_reduce

    def reduce_spy(Hpp, bp, Hpx, Hxx_inv, bx):
        shape = (Hpx.shape[0], Hpx.shape[2])
        spy["shapes"].append(shape)
        if shape == keep_shape and len(spy["kept"]) < keep:
            spy["kept"].append((Hpx, Hxx_inv))
        return orig(Hpp, bp, Hpx, Hxx_inv, bx)

    spy["fn"], spy["orig"] = reduce_spy, orig
    return spy


@contextlib.contextmanager
def spied_schur(spy):
    ba.schur_reduce = spy["fn"]
    try:
        yield spy
    finally:
        ba.schur_reduce = spy["orig"]


def phase_mesh_solvers(mesh):
    """``entry.dryrun_multichip`` on ``mesh`` (MESH_BLOCKS blocks of the
    card): every distributed path at the JAX package's dry-run shapes with
    its asserts, each solve's seconds, K3's launches and shapes, and K3
    against its plain version in f64 on each block of the distributed
    local BA's first step, at (64, 512). Run in the child in deterministic
    mode: the local BA's float scatter-adds otherwise add in another order
    from run to run, and one solve's points move between two runs of
    itself by as much as the dry run's 1e-3 point tolerance
    (``examples/torch_check_spread.py --ba``)."""
    block = (64, 2048 // mesh.size)
    spy = schur_spy(block, mesh.size)
    K1.fast_nms.launches = K2.windowed_top2.launches = K3.point_reduction.launches = 0
    with spied_schur(spy):
        try:
            out = dryrun_multichip(mesh.size, device="cuda")
        except AssertionError as e:
            raise SystemExit(f"chip_smoke: dryrun_multichip on {mesh}: {e!r}")
    k1, k2, k3 = K1.fast_nms.launches, K2.windowed_top2.launches, K3.point_reduction.launches
    checks = [real_schur_check(Hpx, Hxx_inv, f"block {b} of the distributed local BA",
                               times=False) for b, (Hpx, Hxx_inv) in enumerate(spy["kept"])]
    shapes = sorted(set(spy["shapes"]))
    cfg_s = session_cfg()
    # 3 LM steps x blocks at (64, 512); the single solves at (64, 2048);
    # the session's local BAs at (16, 512), its joint GBAs a block each at
    # (64, 1024)
    want = {block, (64, 2048), (cfg_s.cap.local_kfs + cfg_s.cap.local_ref_kfs,
                                cfg_s.cap.local_mps),
            (cfg_s.cap.max_kfs, cfg_s.cap.max_mps // mesh.size)}
    out.update(k1_launches=k1, k2_launches=k2, k3_launches=k3, k3_shapes=shapes,
               k3_calls=len(spy["shapes"]), k3_block_checks=checks, blocks=mesh.size)
    log("mesh solvers: " + json.dumps(out))
    if k1 < 1 or k2 < 1:
        raise SystemExit(f"chip_smoke: the mesh solvers' session launched K1 {k1}, K2 {k2} times")
    if (len(checks) != mesh.size or k3 != len(spy["shapes"]) or set(shapes) != want
            or spy["shapes"].count(block) != 3 * mesh.size):
        raise SystemExit(f"chip_smoke: mesh solvers' K3 launches {k3} at {shapes}, "
                         f"want the shapes {sorted(want)}")
    return out


def phase_mesh_session(world, mesh, single):
    """The loop phase's scene at the bench widths with the default
    Capacity, one draw, ``SlamSystem(cfg, mesh=mesh)``: the bank split
    over the blocks, the pose graph edge-sharded, the joint GBA
    partitioned with K3 on each block at (max_kfs, max_mps / n). Held to
    the loop phase's JAX spread; K3's launches counted; each block of the
    first joint GBA checked on its real damped system in f64 and block 0
    timed; frames/s beside the single-device loop phase's (``single``)."""
    cfg, gt, odo, imgs = loop_scene(world)
    block = (cfg.cap.max_kfs, cfg.cap.max_mps // mesh.size)
    spy = schur_spy(block, mesh.size)
    K1.fast_nms.launches = K2.windowed_top2.launches = K3.point_reduction.launches = 0
    with spied_schur(spy):
        slam, run = run_loop(cfg, imgs, odo, gt, seed=0, mesh=mesh)
    k3 = K3.point_reduction.launches
    lc = slam._loop_closer
    local = (cfg.cap.local_kfs + cfg.cap.local_ref_kfs, cfg.cap.local_mps)
    want_k3 = (cfg.local_iter * run["n_local_ba"]
               + mesh.size * cfg.gm_joint_ba_iters * run["n_joint_gba"])
    bank_blocks = len(lc.bank.blocks) if isinstance(lc.bank, ShardedRows) else 0
    run.update(k1_launches=K1.fast_nms.launches, k2_launches=K2.windowed_top2.launches,
               k3_launches=k3, k3_want=want_k3, k3_shapes=sorted(set(spy["shapes"])),
               k3_block_launches=spy["shapes"].count(block), dist=lc._dist,
               bank_blocks=bank_blocks, single_device_frames_per_s=single["frames_per_s"],
               single_device_kf=single["n_kf"], single_device_ate_corrected=single["ate_corrected"])
    log("mesh session: " + json.dumps(run))
    if (not loop_draw_ok(run) or not lc._dist or bank_blocks != mesh.size or k3 != want_k3
            or run["k1_launches"] != len(imgs) or run["k2_launches"] < 1
            or set(spy["shapes"]) != {local, block} or run["n_joint_gba"] < 1
            or len(spy["kept"]) != mesh.size):
        raise SystemExit("chip_smoke: the mesh session failed its checks (keyframes "
                         f"{JAX_LOOP_KF}, >= 1 loop, the JAX spread, the bank in {mesh.size} "
                         f"blocks, K3 {k3} launches, want {want_k3})")
    blocks = []
    for b, (Hpx, Hxx_inv) in enumerate(spy["kept"]):
        # live points sit in the bank's low slots, so the tail blocks hold none
        blocks.append(real_schur_check(Hpx, Hxx_inv, f"block {b} of the mesh session's joint GBA",
                                       times=b == 0))
    log("mesh session blocks' live points: " + json.dumps([b["live_points"] for b in blocks]))
    return dict(run=run, blocks=blocks)


def phase_runtime(mesh):
    """``parallel.runtime`` in this process: world size 1 over NCCL, a
    mesh of the same blocks as ``mesh`` on the card. The distributed pose
    graph (K = 256) and a psum of ``arange`` through it equal, bitwise,
    the in-process mesh's (run in deterministic mode: the solver's float
    scatter-adds then add in one order)."""
    import socket

    from se2lam_tpu_torch.parallel import dist_solve_pose_graph, runtime
    from se2lam_tpu_torch.solver.posegraph import synthetic_pose_graph

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    runtime.init_distributed(coordinator=f"127.0.0.1:{port}", num_processes=1, process_id=0,
                             device="cuda", blocks_per_device=mesh.size)
    try:
        gm = runtime.global_mesh()
        x = torch.arange(4.0 * mesh.size, device="cuda")
        psum = [float(m.psum([b.sum() for b in m.split(x)])[0]) for m in (gm, mesh)]
        K = 256
        pg = synthetic_pose_graph(np.random.default_rng(0), K,
                                  loop_pairs=[(0, K - 30), (10, K - 5), (40, K - 1)],
                                  device="cuda")
        got = {}
        with deterministic():
            for name, m in (("runtime", gm), ("mesh", mesh)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got[name] = dist_solve_pose_graph(pg, m, iters=20, cg_iters=48)[0]
                torch.cuda.synchronize()
                got[name + "_s"] = time.perf_counter() - t0
        backend = runtime.backend()
    finally:
        runtime.shutdown()
    out = dict(backend=backend, world_size=1, blocks=gm.size, psum=psum,
               pose_graph_bitwise=bool(torch.equal(got["runtime"], got["mesh"])),
               runtime_s=got["runtime_s"], mesh_s=got["mesh_s"])
    log("runtime: " + json.dumps(out))
    if (backend != "nccl" or psum != [float(np.arange(4 * mesh.size).sum())] * 2
            or not out["pose_graph_bitwise"]):
        raise SystemExit("chip_smoke: the NCCL runtime's mesh differs from the in-process one")
    return out


def phase_mini_ba(cfg, closing):
    """The 2-KF mini-BA constraint (``loopclose.build_loop_constraint_ba``)
    on the loop phase's first closure (map, keyframe, loop candidate and
    its verified matches), beside the pose-only ``build_loop_constraint``:
    MINI_BA_ITERS K3 launches at (2, N); K3 on the mini-BA's first damped
    system (``real_schur_check``); ``meas`` bitwise ``se2.minus`` of the
    optimized poses; ``info`` symmetric with eigenvalues in [1e-6, 1e4 +
    the diagonal shift] (to within the reconstruction's 8·eps·λmax); the
    same call on the CPU within MINI_BA_*; the call's ms (CUDA events)."""
    from se2lam_tpu_torch.ops import se2

    if not closing:
        raise SystemExit("chip_smoke: the loop phase recorded no closure for the mini-BA")
    ms, k, cand, midx = (closing[n] for n in ("ms", "k", "cand", "match_idx"))
    shape = (2, ms.N)
    spy = schur_spy(shape, 1)
    K3.point_reduction.launches = 0
    with spied_schur(spy), Counted(loopclose, "solve_local_ba") as sba:
        meas, info, n_good, _ = loopclose.build_loop_constraint_ba(ms, k, cand, midx, cfg)
    launches = K3.point_reduction.launches
    if launches != MINI_BA_ITERS or spy["shapes"] != [shape] * MINI_BA_ITERS:
        raise SystemExit(f"chip_smoke: the mini-BA launched K3 {launches} times at "
                         f"{sorted(set(spy['shapes']))}, want {MINI_BA_ITERS} at {shape}")
    k3 = real_schur_check(*spy["kept"][0], "the mini-BA's first LM step", times=False)
    opt = sba.last[0]
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    loopclose.build_loop_constraint_ba(ms, k, cand, midx, cfg)
    b.record()
    pose_only = loopclose.build_loop_constraint(ms, k, cand, midx, cfg)
    cpu = mini_ba_cpu_diff(cfg, closing, meas, info, n_good)
    ev = np.linalg.eigvalsh(info.double().cpu().numpy())
    shift = 1e-6 + 8.0 * float(torch.finfo(torch.float32).eps) * ev.max()
    out = dict(
        shape_KM=shape, k3_launches=launches, k3=k3, ms=a.elapsed_time(b),
        meas=meas.tolist(), info=info.tolist(), n_good=int(n_good), n_pairs=int((midx >= 0).sum()),
        eigenvalues=ev.tolist(), meas_is_minus=bool(torch.equal(meas, se2.minus(opt[1], opt[0]))),
        symmetric=bool(torch.equal(info, info.T)), **cpu,
        pose_only=dict(meas=pose_only[0].tolist(), info=pose_only[1].tolist(),
                       n_good=int(pose_only[2])))
    log("mini-BA constraint: " + json.dumps(out))
    if not (out["meas_is_minus"] and out["symmetric"] and ev.min() >= 1e-6
            and ev.max() <= 1e4 + 2 * shift and int(n_good) >= 1
            and out["cpu_n_good_diff"] <= MINI_BA_N_GOOD_TOL
            and out["cpu_meas_diff"] <= MINI_BA_MEAS_TOL
            and out["cpu_info_rel_diff"] <= MINI_BA_INFO_RTOL):
        raise SystemExit("chip_smoke: the mini-BA constraint failed its checks")
    return out


def mini_ba_cpu_diff(cfg, closing, meas, info, n_good):
    """``build_loop_constraint_ba`` on the same closure on the CPU, and its
    differences from the card's (meas, info, n_good)."""
    ms, k, cand, midx = (closing[n] for n in ("ms", "k", "cand", "match_idx"))
    k_c, cand_c, midx_c = (torch.as_tensor(x).cpu() for x in (k, cand, midx))
    meas_c, info_c, n_good_c, _ = loopclose.build_loop_constraint_ba(
        MapState(*(t.cpu() for t in ms)), k_c, cand_c, midx_c, cfg)
    return dict(cpu=dict(meas=meas_c.tolist(), info=info_c.tolist(), n_good=int(n_good_c)),
                cpu_n_good_diff=abs(int(n_good) - int(n_good_c)),
                cpu_meas_diff=float((meas.cpu() - meas_c).abs().max()),
                cpu_info_rel_diff=float((info.cpu() - info_c).abs().max() / info_c.abs().max()))


def phase_outliers(cfg, ms):
    """``localmap.remove_outlier_obs`` on the saved mapping map at its last
    keyframe, then with a point moved by OUTLIER_SHIFT (the first valid
    point whose observers all lie in the local window, so that all its
    observations turn outliers): the victim gone from every keyframe row
    and killed, the tables consistent, every integer table and ``n_bad``
    bitwise the CPU's on the same map; the smallest |chi2 − th_huber2| of
    the window's observations (how far the gate is from a flip between
    the devices)."""
    cur = int(torch.nonzero(ms.kf_valid).max())
    local_kfs = localmap.local_graph_masks(ms, cur)[0]
    P = ms.mp_obs_kf.shape[1]
    live = torch.arange(P, device=ms.mp_n_obs.device)[None] < ms.mp_n_obs[:, None]
    all_local = (live <= local_kfs[ms.mp_obs_kf.clamp(min=0).long()]).all(1)
    victim = int(torch.nonzero(ms.mp_valid & all_local & (ms.mp_n_obs >= 2))[0])
    shift = torch.tensor([OUTLIER_SHIFT], dtype=ms.mp_pos.dtype, device=ms.mp_pos.device)
    bad_ms = ms._replace(mp_pos=ms.mp_pos.index_add(
        0, torch.tensor([victim], device=ms.mp_pos.device), shift))
    tables = ("kf_obs_mp", "mp_obs_kf", "mp_obs_feat", "mp_n_obs", "mp_valid")
    out = {}
    for name, m in (("clean", ms), ("corrupted", bad_ms)):
        got, n_bad = localmap.remove_outlier_obs(m, cur, cfg)
        want, n_bad_c = localmap.remove_outlier_obs(MapState(*(t.cpu() for t in m)), cur, cfg)
        has, chi2 = localmap.local_obs_chi2(m, cur, cfg)
        out[name] = dict(
            n_bad=int(n_bad), n_bad_cpu=int(n_bad_c), local_obs=int(has.sum()),
            chi2_margin=float((chi2[has] - cfg.th_huber2).abs().min()),
            bitwise_cpu=all(torch.equal(getattr(got, f).cpu(), getattr(want, f)) for f in tables),
            consistent=table_consistency(got), victim_in_rows=bool((got.kf_obs_mp == victim).any()),
            victim_valid=bool(got.mp_valid[victim]), live_points=int(got.mp_valid.sum()))
    log(f"outlier removal at KF {cur}, victim {victim}: " + json.dumps(out))
    c, v = out["clean"], out["corrupted"]
    if not (c["bitwise_cpu"] and v["bitwise_cpu"] and c["consistent"] and v["consistent"]
            and c["n_bad"] == c["n_bad_cpu"] and v["n_bad"] == v["n_bad_cpu"]
            and v["n_bad"] > c["n_bad"] and not v["victim_in_rows"] and not v["victim_valid"]):
        raise SystemExit("chip_smoke: outlier removal failed its checks")
    return out


def phase_harris(oc, extract, world, gt):
    """The extractor with Harris rescoring (``use_harris``) on HARRIS_FRAMES
    of the bench world: every output but ``response`` bitwise the card's
    output without it, ``forward_batch`` bitwise ``forward`` frame by
    frame, the same K1 launches as without it (one a frame, ⌈levels·4/8⌉
    for the batch), ``response`` within HARRIS_RTOL of max|R| from the
    CPU's on the same slots; the eager ms a frame with and without it."""
    ext = OrbExtractor(oc._replace(use_harris=True))
    ext_cpu = OrbExtractor(oc._replace(use_harris=True), device="cpu")
    imgs = torch.stack([torch.from_numpy(world.render(gt[i])) for i in HARRIS_FRAMES]).cuda()
    launches = {}
    for name, fn in (("off", lambda: [extract(im) for im in imgs]),
                     ("on", lambda: [ext(im) for im in imgs]),
                     ("off_batch", lambda: extract.forward_batch(imgs)),
                     ("on_batch", lambda: ext.forward_batch(imgs))):
        K1.fast_nms.launches = 0
        launches[name] = (fn(), K1.fast_nms.launches)
    (off, n_off), (on, n_on) = launches["off"], launches["on"]
    (_, n_off_b), (batch, n_on_b) = launches["off_batch"], launches["on_batch"]
    fields = [f for f in OrbFeatures._fields if f != "response"]
    rel = []
    for i, img in enumerate(imgs):
        if not all(torch.equal(getattr(on[i], f), getattr(off[i], f)) for f in fields):
            raise SystemExit(f"chip_smoke: Harris changed more than the response of frame {i}")
        if not all(torch.equal(getattr(batch, f)[i], getattr(on[i], f))
                   for f in OrbFeatures._fields):
            raise SystemExit(f"chip_smoke: Harris forward_batch differs from forward at frame {i}")
        fc = ext_cpu(img.cpu())
        v = fc.valid
        if not (torch.equal(on[i].valid.cpu(), v) and torch.equal(on[i].octave.cpu(), fc.octave)):
            raise SystemExit(f"chip_smoke: Harris keypoint slots differ from the CPU's, frame {i}")
        r_c = fc.response[v]
        rel.append(float((on[i].response.cpu()[v] - r_c).abs().max() / r_c.abs().max()))
    out = dict(frames=list(HARRIS_FRAMES), k1_launches=n_on, k1_launches_off=n_off,
               k1_launches_batch=n_on_b, k1_launches_batch_off=n_off_b,
               response_rel_diff_cpu=rel, rel_tol=HARRIS_RTOL,
               max_abs_response=float(on[0].response.abs().max()),
               eager_ms=events_ms(lambda: ext(imgs[0]), reps=20),
               eager_ms_off=events_ms(lambda: extract(imgs[0]), reps=20))
    log("Harris extraction: " + json.dumps(out))
    levels = sum(q > 0 for q in oc.level_quotas)
    if not (n_on == n_off == len(imgs) and n_on_b == n_off_b == -(-levels * len(imgs) // 8)
            and max(rel) <= HARRIS_RTOL):
        raise SystemExit("chip_smoke: Harris extraction failed its checks")
    return out


def phase_slice8(cfg, oc, extract, world, gt, closing, ms):
    """Slice 8: the mini-BA constraint, outlier removal, Harris rescoring."""
    return dict(mini_ba=phase_mini_ba(cfg, closing), outliers=phase_outliers(cfg, ms),
                harris=phase_harris(oc, extract, world, gt))


def phase_odoslam(cfg, world, ref, launches):
    """The mapping phase's frames through the split feed
    (``receive_odo_data``/``receive_img_data``, the odometry first on even
    frames, the image first on odd ones; timestamps ignored), outside
    deterministic mode: after each pair ``get_current_vehicle_pose()``
    bitwise the pose of the mapping phase's counted ``process`` run on the
    same generator (seed 0), the same keyframe frames and the same K1, K2
    and K3 launches; then ``request_finish``, ``wait_for_finish`` and a
    ``save_map``/``load_map`` round trip, bitwise."""
    gt = world.circle_trajectory(352, radius=2.5)[:MAP_FRAMES]
    odo = world.odometry(gt, noise=ODO_NOISE, seed=1)
    imgs = [torch.from_numpy(world.render(p)).to("cuda") for p in gt]
    slam = SlamSystem(cfg, enable_loops=False,
                      generator=torch.Generator(device="cuda").manual_seed(0))
    K1.fast_nms.launches = K2.windowed_top2.launches = K3.point_reduction.launches = 0
    poses = []
    for i, (img, o) in enumerate(zip(imgs, odo)):
        stamp = i / CAMERA_FPS
        if i % 2 == 0:
            slam.receive_odo_data(*o, stamp)
            slam.receive_img_data(img, stamp)
        else:
            slam.receive_img_data(img, stamp)
            slam.receive_odo_data(*o, stamp)
        poses.append(slam.get_current_vehicle_pose())
    got = (K1.fast_nms.launches, K2.windowed_top2.launches, K3.point_reduction.launches)
    want = np.asarray([p for _, p in ref.trajectory])
    poses = np.asarray(poses)
    slam.request_finish()
    slam.wait_for_finish()
    out = dict(frames=slam.frame_id, kf_frames=slam.kf_frame_ids, launches=got,
               mapping_launches=launches, deterministic_mode=torch.are_deterministic_algorithms_enabled(),
               shape=list(poses.shape), poses_bitwise=bool(np.array_equal(poses, want)),
               max_pose_diff=float(np.abs(poses - want).max()) if poses.shape == want.shape
               else None, finished=slam._finished)
    log("OdoSLAM feed: " + json.dumps(out))
    if not (out["poses_bitwise"] and slam.frame_id == MAP_FRAMES and got == tuple(launches)
            and slam.kf_frame_ids == ref.kf_frame_ids and slam._finished
            and not out["deterministic_mode"]):
        raise SystemExit("chip_smoke: the split feed differs from process on the same "
                         "generator, or its launches from the mapping phase's")
    phase_save_reload(slam, ODOSLAM_DIR)
    return dict(out, k1_launches=got[0], k2_launches=got[1], k3_launches=got[2])


def repeat_diff(fn, n=F7_REPEATS):
    """``fn()`` ``n`` times: whether every result equals the first bitwise,
    the largest difference from it, and each call's ms (CUDA events)."""
    outs, times = [], []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        outs.append(tuple(fn()))
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    pairs = [(x, y) for o in outs[1:] for x, y in zip(outs[0], o)]
    return dict(bitwise=all(torch.equal(x, y) for x, y in pairs),
                max_diff=max(float((x.double() - y.double()).abs().max()) for x, y in pairs
                             if x.is_floating_point()),
                ms=times)


def f7_repeats(cfg, slam, joint_first, n=F7_REPEATS):
    """F7: phase 7's real local BA (the window of the SLAM run's last
    keyframe, K3 at (48, 2048)), the dense pose graph at K = 256 and the
    loop phase's first joint GBA (K3 at (256, 8192)), each run ``n`` times
    on the same inputs outside deterministic mode (``repeat_diff``)."""
    from se2lam_tpu_torch.solver.posegraph import solve_pose_graph, synthetic_pose_graph

    kf = slam._ref_kf_host
    pg = synthetic_pose_graph(np.random.default_rng(0), F7_PG_K, loop_pairs=F7_PG_LOOPS,
                              device="cuda")
    (ms_j, cfg_j), kw = joint_first[0][:2], joint_first[1]
    solves = dict(
        local_ba=lambda: localmap.run_local_ba(slam.ms, kf, cfg)[0],
        pose_graph=lambda: solve_pose_graph(pg, iters=F7_PG_ITERS)[:1],
        joint_gba=lambda: loopclose.run_global_ba_joint(ms_j, cfg_j, **kw)[0])
    return {name: repeat_diff(fn, n) for name, fn in solves.items()}


def phase_f7(cfg, slam, joint_first, run):
    """F7 on the card: ``f7_repeats``, every solve bitwise its first run,
    outside deterministic mode; beside it this run's local-BA ms a
    keyframe and the in-turn measurement's."""
    if torch.are_deterministic_algorithms_enabled():
        raise SystemExit("chip_smoke: F7 must be checked outside deterministic mode")
    out = f7_repeats(cfg, slam, joint_first)
    log("F7 local BA ms a keyframe: " + json.dumps(dict(
        this_run=run["local_ba_ms_per_kf"], in_turns=F7_IN_TURNS)))
    log(f"F7 ({F7_REPEATS} runs each, outside deterministic mode): " + json.dumps(out))
    bad = [k for k, v in out.items() if not v["bitwise"] or v["max_diff"] != 0.0]
    if bad:
        raise SystemExit(f"chip_smoke: F7: {bad} differ between runs on the same inputs")
    return out


def distortion_cfg():
    """The 320x240 barrel scene of tests/test_distortion_e2e.py."""
    cfg, oc = default_cfg(width=320, height=240, n_features=256, n_levels=2)
    return cfg.replace(
        fx=260.0, fy=260.0, cx=160.0, cy=120.0, dist=DIST_COEFFS,
        min_frames_between_kf=2, max_frames_between_kf=8, local_iter=6,
        cap=dataclasses.replace(cfg.cap, n_features=oc.n_slots, max_kfs=64, max_mps=4096,
                                local_kfs=8, local_ref_kfs=8, local_mps=512, ransac_trials=64))


def blackout_cfg():
    """The 160x120 scene of tests/test_vision_loss.py."""
    cfg, oc = default_cfg(width=160, height=120, n_features=128, n_levels=2)
    return cfg.replace(
        fx=130.0, fy=130.0, cx=80.0, cy=60.0, Tbc=tuple(np.linalg.inv(BLACKOUT_TCB).ravel()),
        min_frames_between_kf=1, max_frames_between_kf=4, local_iter=4,
        cap=dataclasses.replace(cfg.cap, n_features=oc.n_slots, max_kfs=24, max_mps=1024,
                                local_kfs=6, local_ref_kfs=6, local_mps=256, ransac_trials=32))


def small_run(cfg, frames, device, gumbels=None):
    """``SlamSystem(cfg, enable_loops=False)`` over (image, odometry) pairs
    on ``device``: tracking's draws from ``gumbels`` (one a frame) or the
    system's own generator; its trajectory, finite at every frame."""
    slam = SlamSystem(cfg, enable_loops=False, device=device,
                      generator=torch.Generator(device=device).manual_seed(0))
    for i, (img, o) in enumerate(frames):
        pose = slam.process(img, o, gumbel=None if gumbels is None else gumbels[i])
        if not np.isfinite(pose).all():
            raise SystemExit(f"chip_smoke: frame {i} on {device}: a pose is not finite")
    return slam


def phase_distortion():
    """The barrel scene on the card and the port on the CPU, both on the
    same RANSAC draws (``tracking.draw_track_noise`` from a seeded CPU
    generator): the same keyframe frames, a K1 launch a frame, the JAX
    test's asserts, ATE within DIST_ATE_TOL of the CPU's."""
    cfg = distortion_cfg()
    world = SyntheticWorld(cfg, n_landmarks=600, room=10.0, seed=4)
    frames = list(world.sequence(SMALL_FRAMES, noise=SMALL_ODO_NOISE))
    g = torch.Generator().manual_seed(0)
    gumbels = [tracking.draw_track_noise(g, cfg) for _ in frames]
    K1.fast_nms.launches = K2.windowed_top2.launches = K3.point_reduction.launches = 0
    card = small_run(cfg, frames, "cuda", gumbels)
    k1, k2, k3 = K1.fast_nms.launches, K2.windowed_top2.launches, K3.point_reduction.launches
    cpu = small_run(cfg, frames, "cpu", gumbels)
    ate = {}
    for name, s in (("card", card), ("cpu", cpu)):
        est = np.asarray([p for _, p in s.trajectory])
        ate[name] = ate_se2(est[:, :2], world.gt[: len(est), :2])[0]
    out = dict(undistort=card._undistort, kf_frames=card.kf_frame_ids,
               kf_frames_cpu=cpu.kf_frame_ids, n_kf=card.n_keyframes(),
               n_mp=card.n_map_points(), n_mp_cpu=cpu.n_map_points(), ate=ate["card"],
               ate_cpu=ate["cpu"], k1_launches=k1, k2_launches=k2, k3_launches=k3)
    log("distortion: " + json.dumps(out))
    if not (card._undistort and card.kf_frame_ids == cpu.kf_frame_ids and k1 == SMALL_FRAMES
            and k3 == cfg.local_iter * card.n_local_ba and k2 >= 1
            and out["n_kf"] >= 3 and out["n_mp"] > 40 and ate["card"] < SMALL_ATE_MAX
            and abs(ate["card"] - ate["cpu"]) < DIST_ATE_TOL):
        raise SystemExit("chip_smoke: the distortion run failed its checks")
    return out


def phase_blackout():
    """Both flavors of tests/test_vision_loss.py on the card (frames 12-17
    blank, or noise from ``default_rng(9)``): finite poses, a keyframe
    after the blackout, live and corrected ATE under SMALL_ATE_MAX, a K1
    launch a frame."""
    cfg = blackout_cfg()
    out = {}
    for flavor in ("blank", "noise"):
        world = SyntheticWorld(cfg, n_landmarks=300, room=10.0, seed=5)
        rng = np.random.default_rng(9)
        frames = []
        for i, (img, o) in enumerate(world.sequence(SMALL_FRAMES, noise=SMALL_ODO_NOISE)):
            if i in BLACKOUT:
                img = (np.zeros_like(img) if flavor == "blank"
                       else rng.integers(0, 255, img.shape).astype(img.dtype))
            frames.append((img, o))
        K1.fast_nms.launches = K2.windowed_top2.launches = K3.point_reduction.launches = 0
        slam = small_run(cfg, frames, "cuda")
        gt = np.asarray(world.gt[:SMALL_FRAMES])
        est = np.asarray([p for _, p in slam.trajectory])
        corr = slam.corrected_trajectory()
        out[flavor] = dict(
            kf_frames=slam.kf_frame_ids, k1_launches=K1.fast_nms.launches,
            k2_launches=K2.windowed_top2.launches, k3_launches=K3.point_reduction.launches,
            n_local_ba=slam.n_local_ba,
            ate=ate_se2(est[:, :2], gt[:, :2])[0],
            ate_corrected=ate_se2(corr[:, 1:3], gt[corr[:, 0].astype(int), :2])[0],
            corrected_finite=bool(np.isfinite(corr).all()))
    log("blackout: " + json.dumps(out))
    for flavor, r in out.items():
        if not (max(r["kf_frames"]) > BLACKOUT.stop and r["ate"] < SMALL_ATE_MAX
                and r["ate_corrected"] < SMALL_ATE_MAX and r["corrected_finite"]
                and r["k1_launches"] == SMALL_FRAMES
                and r["k3_launches"] == cfg.local_iter * r["n_local_ba"]):
            raise SystemExit(f"chip_smoke: the {flavor} blackout failed its checks")
    return out


def phase_slice9(cfg, world, slam, run, launches, joint_first):
    """Slice 9: the split feed, F7, distortion, the blackout."""
    return dict(odoslam=phase_odoslam(cfg, world, slam, launches),
                f7=phase_f7(cfg, slam, joint_first, run), distortion=phase_distortion(),
                blackout=phase_blackout())


def timed(name, fn, *args):
    """Run one phase and print its seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    return out


def main():
    t_start = time.perf_counter()
    smi = phase_device()
    timed("build", phase_build)
    cfg, oc = default_cfg()
    extract = OrbExtractor(oc)   # device=None: the card
    world = SyntheticWorld(cfg, n_landmarks=500, seed=0)
    gt = world.circle_trajectory(352, radius=2.5)[:N_FRAMES]
    t = timed("kernel", phase_kernel, extract, world, gt[0])
    timed("extractor", phase_extractor, extract, oc, world.render(gt[5]))
    launches = timed("main path", phase_main_path, cfg, oc, extract, world, gt)
    ts = timed("schur", phase_schur)
    slam, run, k1_map, k2_map, k3_map, real_ba = timed("mapping", phase_mapping, cfg, world)
    k2_err = timed("k2", phase_k2)
    k1_loc, k2_loc, t2, res = timed("localization", phase_localization, cfg, world, slam)
    f1 = timed("f1", phase_f1, world)
    loop_world = SyntheticWorld(cfg, n_landmarks=1200, room=10.0, seed=4)
    lp = timed("loop", phase_loop, loop_world)
    relief = timed("relief", phase_relief, loop_world)
    batch = timed("batch extraction", phase_batch_extract, extract, oc, world)
    data = timed("dataset", phase_dataset, cfg, world)
    child = timed("feeds, driver, live serving (child process)", phase_feeds, MAP_DIR)
    feeds, loc_feeds = child["slam"], child["localization"]
    ms, vocab, _ = load_map(str(MAP_DIR))
    mesh = make_mesh(MESH_BLOCKS, device="cuda")
    fleet = timed("fleet tracking", phase_fleet_tracking, cfg, oc, mesh)
    fleet_loc, real_b = timed("fleet localization", phase_fleet_localization, cfg, world, ms,
                              vocab, mesh)
    t2b = timed("k2 batched", phase_k2_batched, real_b)
    live = timed("live serving (timed)", phase_live_timed, cfg, world)
    merge = timed("merge", phase_merge)
    mesh_solvers = child["mesh_solvers"]
    mesh_run = timed("mesh session", phase_mesh_session, loop_world, mesh, lp["run"])
    slice8 = timed("slice 8", phase_slice8, cfg, oc, extract, world, gt, lp["closing"], ms)
    slice9 = timed("slice 9", phase_slice9, cfg, world, slam, run, (k1_map, k2_map, k3_map),
                   lp["joint_first"])
    slice9_launches = {name: dict(
        launches_odoslam=slice9["odoslam"][f"k{i}_launches"],
        launches_distortion=slice9["distortion"][f"k{i}_launches"],
        launches_blackout={f: v[f"k{i}_launches"] for f, v in slice9["blackout"].items()})
        for i, name in ((1, "k1"), (2, "k2"), (3, "k3"))}
    slice6 = {name: {f"launches_{p}": v[f"k{i}_launches"] for p, v in (
        ("dataset", data), ("live_chunked", live["chunked"]), ("live_pipelined", live["pipelined"]),
        ("merge_mapping", merge["mapping"]), ("merge", merge["runs"][0]))}
        for i, name in ((1, "k1"), (2, "k2"), (3, "k3"))}
    kernel = dict(
        name="fast_nms", route="cuda", source="se2lam_tpu_torch/csrc/fast_nms.cu",
        replaces="se2lam_tpu/frontend/pallas_fast.py:101", launches=k1_map,
        launches_tracking_path=launches, launches_localization=k1_loc,
        launches_resume=res["k1_launches"], launches_loop=lp["k1"],
        launches_relief=relief["k1_launches"],
        launches_f1={n: v["launches_extract"] for n, v in f1.items()},
        max_abs_err=max([t["max_abs_err"]] + [v["max_abs_err"] for v in f1.values()]),
        max_abs_diff=t["max_abs_err"],
        ms=t["ms"], level_ms=t["level_ms"], noise_ms=t["noise_ms"], eager_ms=t["eager_ms"],
        plain_ms=t["plain_ms"], plain_eager_ms=t["plain_eager_ms"],
        bound_ms=t["bound_ms"], bound_us=1e3 * t["bound_ms"], bound_by=t["bound_by"],
        library_ms=None, px_per_frame=t["px"], card=smi,
        launches_batch_extraction=batch["k1_launches"],
        launches_feeds={f: v["k1"] for f, v in feeds["launches"].items()},
        launches_fleet_tracking={B: v["k1_launches"] for B, v in fleet.items()},
        launches_merged_localizer=merge["localizer"]["k1_launches"], **slice6["k1"],
        launches_fleet_tracking_mesh=fleet["mesh"]["k1_launches"],
        launches_mesh_solvers=mesh_solvers["k1_launches"],
        launches_mesh_session=mesh_run["run"]["k1_launches"],
        launches_harris=slice8["harris"]["k1_launches"],
        launches_harris_batch=slice8["harris"]["k1_launches_batch"], **slice9_launches["k1"],
    )
    loc, glob = ts[LOCAL_BA_SHAPE], ts[GLOBAL_BA_SHAPE]
    schur_kernel = dict(
        name="schur_reduce", route="cuda", source="se2lam_tpu_torch/csrc/schur_reduce.cu",
        replaces="se2lam_tpu/solver/pallas_schur.py:91", launches=k3_map,
        max_abs_err=loc["max_abs_err"], rel_err=loc["rel_err"], real_local_ba=real_ba,
        ms=loc["ms"], eager_ms=loc["eager_ms"], plain_ms=loc["plain_ms"],
        plain_eager_ms=loc["plain_eager_ms"], bound_ms=loc["bound_ms"],
        bound_by=loc["bound_by"], library_ms=loc["library_ms"],
        library_eager_ms=loc["library_eager_ms"], shape_KM=LOCAL_BA_SHAPE,
        global_ba=dict(glob, shape_KM=GLOBAL_BA_SHAPE), launches_loop=lp["k3"],
        launches_loop_joint_shape=lp["k3_joint"], launches_relief=relief["k3_launches"],
        joint_gba=lp["joint"], card=smi,
        launches_feeds={f: v["k3"] for f, v in feeds["launches"].items()},
        merge_joint_gba=merge["joint"],
        merge_joint_abs_rel_err=[r["joint_schur_abs_rel_err"] for r in merge["runs"]],
        merge_joint_rel_err=[r["joint_schur_rel_err"] for r in merge["runs"]], **slice6["k3"],
        launches_mesh_solvers=mesh_solvers["k3_launches"],
        mesh_solvers_shapes_KM=mesh_solvers["k3_shapes"],
        mesh_solvers_block_checks=mesh_solvers["k3_block_checks"],
        launches_mesh_session=mesh_run["run"]["k3_launches"],
        launches_mesh_session_per_block=mesh_run["run"]["k3_block_launches"],
        mesh_session_shapes_KM=mesh_run["run"]["k3_shapes"], mesh_session_blocks=mesh_run["blocks"],
        launches_mini_ba=slice8["mini_ba"]["k3_launches"],
        mini_ba_shape_KM=slice8["mini_ba"]["shape_KM"],
        mini_ba=dict(ts[MINI_BA_SHAPE], shape_KM=MINI_BA_SHAPE),
        mini_ba_real=slice8["mini_ba"]["k3"], **slice9_launches["k3"],
        f7={name: dict(v, ms=median(v["ms"])) for name, v in slice9["f7"].items()},
    )
    match_kernel = dict(
        name="windowed_top2", route="cuda", source="se2lam_tpu_torch/csrc/windowed_top2.cu",
        replaces="se2lam_tpu/frontend/pallas_match.py:137", launches=k2_loc,
        launches_mapping=k2_map, launches_resume=res["k2_launches"], launches_loop=lp["k2"],
        launches_relief=relief["k2_launches"], max_abs_err=max(k2_err, t2["max_abs_err"]),
        ms=t2["ms"], eager_ms=t2["eager_ms"], plain_ms=t2["plain_ms"],
        plain_eager_ms=t2["plain_eager_ms"], bound_ms=t2["bound_ms"], bound_by=t2["bound_by"],
        bound_all_pairs_ms=t2["bound_all_pairs_ms"], gated_pairs=t2["gated_pairs"],
        library_ms=None, shape_N1N2=t2["shape"], card=smi,
        launches_feeds={f: v["k2"] for f, v in feeds["launches"].items()},
        launches_localization_feeds={r["feed"]: r["k2_launches"] for r in loc_feeds},
        launches_fleet_localization_per_chunk=fleet_loc["k2_launches_per_chunk"],
        batched=t2b, launches_merged_localizer=merge["localizer"]["k2_launches"],
        launches_merged_fleet_per_chunk=merge["fleet"]["k2_launches"],
        launches_live_localizer=child["live"]["localizer"]["k2_launches"], **slice6["k2"],
        launches_mesh_solvers=mesh_solvers["k2_launches"],
        launches_mesh_session=mesh_run["run"]["k2_launches"], **slice9_launches["k2"],
    )
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [kernel, schur_kernel, match_kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(feeds_main(sys.argv[2]) if sys.argv[1:2] == ["--feeds"] else main())

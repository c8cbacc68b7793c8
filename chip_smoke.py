"""Smoke run of the PyTorch port (fasttrack_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--ba-float32]

`--ba-float32` solves the local bundle adjustment in float32, as the JAX
package does, where the port solves in float64 (ba_assembly.SOLVE_DTYPE):
phases 10 and 11 then show what that costs (a larger ATE; card and CPU part
at the first adjustment, so phase 11 fails).

Phases, each printing a line; any failure raises and exits non-zero:
1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles both CUDA kernels from ops/csrc with nvcc (sm_90a), side
   by side, and the host kernels' C++ library (ops/csrc/fasttrack_native.cpp,
   g++) beside them;
3. kernels against plain: hamming_penalty_matrix (bitwise equal) and the
   fused hamming_penalty_topk (values and indices equal) against their
   plain PyTorch versions at the tracker's shapes, the local mapper's
   (10240 x 1024 stacked triangulation rows, a 3000 x 1024 fusion matrix),
   ragged ones, N < K, inputs built to tie (also across the top-K
   kernel's key tiles at 4,096 keys), zero rows (a tenth of the queries and
   all but 40 keys, under 1e9 penalties), K = 2 as match_fisheye
   calls it (validity penalties of 1e9, so that whole rows tie), and K = 1
   as the flat vocabulary's quantization calls it (1024 x 4096, zero
   penalties; with rows tied at 1e9; a tied 700 x 64) beside matrix kernel
   + torch.argmin, and K = 1 past the kernel's 4,096 words as `_assign`
   runs it for a wider vocabulary (1024 x 5000 in two launches merged on
   the card, rows tied across and inside the chunks), and any K past the
   kernel's 4,096 keys as a settings file with more features gives it
   (1024 x 5000 at K 64 and K 2, and tied rows: one launch per chunk of
   4,096 keys, the lists merged on the card, ROADMAP F46); device
   time of each beside
   its plain version,
   what the fused kernel replaces (matrix kernel + stable sort) and
   matrix kernel + torch.topk;
4. hot path: tracking_hot_path on consecutive 752x480 stereo frames
   (8 levels, 1024 features, a 2048-point local map built from the
   previous frame's stereo keypoints), one packed device->host fetch per
   frame, with per-frame checks and ms/frame;
5. card against CPU: the same frame through the port on the CPU, held to
   the golden-check thresholds (keypoint overlap, descriptor bits, depth);
6. fused step: the tracker's per-frame chain frame -> twm_step -> tlm_step
   -> one packed fetch on consecutive frames at the same width, against a
   device-resident point store of 8192 rows with 4096 local-map candidate
   slots, the host side as the tracker does it (parity.py), with per-frame
   checks and ms/frame;
7. fused step, card against CPU: one frame's twm_step and tlm_step on the
   CPU from the same keypoints and blocks;
8. tracker: a rendered 752x480 stereo sequence (datasets.synthetic: two
   depths, 6-DOF motion, ground truth) through Tracker.track_stereo from
   the first frame: stereo initialization, one stepwise frame (reference
   keyframe, local map), then fused single-fetch frames, keyframes and new
   map points over the real map, with per-frame checks, the ATE against
   ground truth and ms/frame;
9. tracker, card against CPU: the first frames again through
   Tracker(device="cpu"): states, keyframes, bindings and poses;
10. system, inline mapping: the whole rendered sequence through
   System(Settings(...), Sensor.STEREO, vocabulary=False).track_stereo:
   tracker -> keyframe -> LocalMapper.process_keyframe (cull points,
   triangulate against 10 neighbours in one 10240-row top-K launch, fuse
   duplicates with one matrix launch per target keyframe, local bundle
   adjustment over 16 keyframes x 2048 points, cull keyframes), with
   per-frame and per-keyframe checks, each adjustment's chi2 before and
   after, the ATE against ground truth, ms/frame and ms/keyframe by step;
11. system, card against CPU: the first frames (three keyframes, one
   adjustment) again through System(device="cpu"): states, paths, keyframe
   frames, map-point counts and poses; the CPU run goes in the renderer's
   process while phases 12-15 run on the card, and is checked after them;
12. system, mapping on its own thread (async_mapping=True): every frame OK,
   the mapper drained and idle after shutdown, the ATE;
13. stereo-inertial system in its default configuration:
   System(Settings(...), Sensor.IMU_STEREO) with the shipped vocabulary
   (the loop closer takes every keyframe inline)
   .track_stereo(left, right, t, imu=samples) over a
   rendered 160-frame sequence (8 s) with its exact 200 Hz IMU stream,
   inline mapping: keyframes every 0.25 s until the mapper initializes the
   IMU (>= 6 keyframes over >= 2 s), then the inertial fused frames
   (twm_step -> tlm_step_vi -> one fetch), the VI pose optimizers on
   stepwise frames, local inertial bundle adjustments (13 states, 1024
   points) and the full inertial BA stage 5 s after init; per-frame and
   per-keyframe checks (every frame OK, 1 fetch and 3 tracker top-k
   launches per fused inertial frame, store uploads only at map changes),
   the frame of IMU init, the gyro bias (the stream has none), the share of
   stepwise frames and fetches per frame (ROADMAP F8), the ATE, ms/frame of
   fused, stepwise and keyframe frames and ms per inertial window on the
   host's clock, the loop closer's ms per keyframe, loops, merges and
   launches;
14. the inertial programs, card against CPU, replayed: the first three
   inertial fused frames' tlm_step_vi and the first local inertial BA
   window of phase 13, recorded with their inputs, run again on the CPU
   from the same inputs: bindings equal, poses and velocities within 1e-3,
   biases within 1e-4, H within 1e-2 of its largest entry; the window
   also in float64 on both (ROADMAP P5);
15. BASELINE.md's toggle matrix on the visual Tracker (no mapper): the first
   N_TOGGLE_FRAMES frames of phase 8's sequence (N_TOGGLE_HOST_FRAMES for
   the masks with host extraction) through seven trackers in
   turns, frame by frame: masks 1111 with and without pose optimization,
   0000 with and without, 1000, 1100 and 0011 (the host sides of the
   offload toggles: ops/host_kernels.py over the native library). Per
   configuration: every frame OK, the ATE, ms/frame on the host's clock,
   the Stats medians of extraction, the motion-model and local-map stages,
   fetches per frame, and the tracker's kernel launches by the stage that
   made them, checked against the mask (a toggle that is off never
   launches its device matcher; under 0000 the only launch is the
   reference-keyframe matcher's, which runs on the device under every mask
   as in the JAX package); BASELINE.md's published row beside each;
16. the stereo-inertial system under mask 0000 (BASELINE.md's CPU row),
   in a process of its own beside phases 17-18 (its frames are host NumPy;
   as phases 24-25 beside 22-23, so the lines of 16-18 and 22-25 say that
   their times were taken beside another process on the same card and host):
   the first N_HOST_INERTIAL_FRAMES frames of phase 13's sequence with
   their IMU samples, inline mapping: every frame OK, IMU init, |bg|, the
   ATE (<= 0.02 m over the frames after init; over all of them the bound
   that tools/host_route_drift.py's readings set, ROADMAP F15), ms/frame
   before and after init, and no tracker launch of a Hamming kernel but the
   reference-keyframe matcher's;
17. relocalization: System(Settings(...), Sensor.STEREO) with the shipped
   vocabulary (place recognition on, the default) over frames 0-59 of phase
   10's sequence, 3 blank frames (RECENTLY_LOST), then frames 0-11 again
   (tests/test_tracking_e2e.py's offset view at full size): re-acquired
   within those frames in the same map, the camera centre against the
   ground truth (limit: twice the JAX package's paired reading, at most
   0.25 m), relocalization's BoW candidates, PnP inliers, inliers after
   the rebind and top-k launches at K = 2, the re-acquiring frame's ms;
   then frame 59 relocalized against the keyframe database itself (>= 50
   inliers, within twice the JAX package's paired reading), since a
   re-acquisition through the reference keyframe does not run
   relocalization;
18. loop closing: (a) tests/test_gba_merge.py's drifted map
   (datasets.synthetic.drifted_loop_scene, its points with viewing normals
   and distance bands), through LoopCloser.process_keyframe with a
   vocabulary trained by the port's train_vocabulary, so that its
   quantization is the top-K kernel at K = 1: the loop closes, its fusion
   merges the return leg's duplicate points through the matrix kernel, the
   global BA runs, the drift falls below 0.6 of what it was, the same on
   the CPU within 1e-3, and one Sim3 refinement's kernel launches (ROADMAP
   K13);
   (b) System(Sensor.STEREO) with the shipped vocabulary over the rendered
   loop (datasets.synthetic trajectory="loop"): loops closed and global BAs
   as the JAX package's paired reading says, the ATE (limit twice the JAX
   package's), ms/frame of frames with and without a keyframe and of
   loop-closing ones, the loop closer's ms and launches per keyframe;
19. inertial loop closing: (a) tests/test_inertial_loop.py's scene
   (drifted_loop_scene(inertial=True): an IMU-initialized map whose drifted
   return leg carries drifted velocities) through LoopCloser.process_keyframe
   on the card: the loop closes through the 4-DoF essential graph, every
   vertex update keeps world z within 1e-6, the corrected velocities follow
   the corrected trajectory (0.25 m/s) and the outbound leg's stay (0.2),
   the same on the CPU within 1e-5; (b) the post-loop global BA of phase
   13's IMU-initialized map: LoopCloser._run_global_ba takes the mapper's
   converged full inertial BA (sweeps, windows, ms), a second call runs one
   sweep and moves no keyframe by more than 1e-3 m (its kernel launches
   counted by the profiler), and the keyframes' ATE stays within 0.02 m;
20. the Atlas map merge: (a) tests/test_gba_merge.py's two maps
   (two_map_scene) through LoopCloser.process_keyframe with the global BA:
   one merge through the routing of process_keyframe, the emptied map gone
   and the old one current, the welded centres within 0.15 m of the truth,
   the merge's own K = 2 and matrix launches, the same on the CPU within
   1e-5; (b) the default System(Sensor.STEREO) over frames 0-79 of phase
   18b's loop, 7 blank frames 1 s apart (a new map starts), frames 20-59
   again (the new map's world is frame 20's camera, 1.47 m and 4.1 degrees
   from the old map's): the merges, the ATE of the frames fed again and,
   after the merging frame, the camera centres in the old map's world
   without alignment, as the JAX package's paired reading gates them (1
   merge; twice its ATE and twice its centre error);
21. the threads: (a) the drifted map through LoopCloser(run_async=True)'s
   insert_keyframe: the loop closes on the closer's thread and its global
   BA on its own; then tests/test_gba_merge.py::test_gba_off_critical_path's
   drifted leg, its global BA on its thread while 4 keyframes go into the
   map under the lock: threads joined, no thread error, the reprojection
   error below 0.5 of its start; (b) System(Sensor.IMU_STEREO,
   async_mapping=True) with the shipped vocabulary over the first 50 frames
   of phase 13's sequence: every frame OK, IMU init, the ATE, the queues
   drained, no mapper, loop-closer or global-BA thread alive after
   shutdown(), no thread error, ms/frame;
22. EuRoC's rig as distributed (datasets.synthetic.euroc_radtan_rig: a
   radtan pair with EuRoC's calibration, camera 2 rotated 0.8 deg, the body
   90 deg about z from camera 1): (a) System(Sensor.IMU_STEREO) in its
   default configuration over 60 rendered 752x480 frames with their IMU
   stream, rectified at start-up (the IMU extrinsic composed with the
   rectifying rotation, ROADMAP F10): every frame OK, IMU init, |bg|, the
   ATE (<= 0.02 m, and up to the init), ms/frame with the host remap of
   both images apart;
   (b) the visual System over its first 30 frames asked for 376x240
   (Camera.newWidth / newHeight), resized and then rectified: every frame
   OK, the ATE (<= 0.02 m);
23. TUM-VI's rig as distributed (tumvi_kb8_rig: a KB8 fisheye pair with
   TUM-VI's calibration at 512x512, an image circle 50 deg off the axis):
   (a) System(Sensor.IMU_STEREO) in its default configuration over 60
   rendered frames, through the fisheye route: >= 100 keypoints with a
   triangulated depth on the first frame, one K = 2 launch (match_fisheye)
   on every frame, fused inertial frames after the IMU init with 1 fetch
   each, every frame OK, IMU init, |bg|, the ATE (<= 0.02 m, and up to the
   init); (b) the
   visual System's first 6 frames on the card against System(device="cpu"):
   states, paths, keyframes, poses within 1e-3; 23a also prints how many
   local-BA steps the KB8 window's behind-the-camera rule rejected
   (ROADMAP F24);
24. the visual monocular System (M9b): (a) System(Sensor.MONOCULAR) in its
   default configuration (the shipped vocabulary, the loop closer inline
   with a free scale) over the first 60 frames of phase 10's sequence:
   two-view initialization, the fused frames (1 fetch each), the mapper's
   epipolar triangulation as the only source of points; per-frame states,
   the init frame, OK frames, keyframes, map points, the Sim(3)-aligned
   ATE beside the RMS motion, ms/frame of fused, stepwise and keyframe
   frames, the two-view attempts' ms and both kernels' launches by stage,
   gated against the JAX package's paired reading of the same frames
   (ROADMAP F31: both degrade at this width); (b) reconstruct_two_view on
   24a's init correspondences on the card and on the CPU (the same model
   and success, R 1e-3 rad, good_mask 99%; its ms and device kernels a
   call, ROADMAP K17), and the System's first 8 frames on both (the same
   states, camera centres within 1e-3 of the map's unit median depth).
25. the monocular-inertial System (M9c): (a) System(Sensor.IMU_MONOCULAR)
   in its default configuration (the shipped vocabulary, the loop closer
   inline with the scale fixed) over 24a's frames with their 200 Hz IMU
   stream, up to the frame of its first scale refinement (cut there for
   the run's time): the two-view init, the IMU init with its scale, the
   scale refinement, every frame after the IMU init OK, the Sim(3) scale of
   those frames within 5% of 1.0 and their SE(3) ATE beside their RMS
   motion, ms/frame of stepwise, fused inertial and keyframe frames, the
   IMU init's and the refinements' ms, the inertial windows' flipped steps
   (ROADMAP F24), both kernels' launches by stage; then the scene of
   tests/test_torch_mono_inertial.py (320x240), whose frames after the IMU
   init are inertial fused frames of a monocular frame: 1 fetch and 2
   top-k launches each (on 24a's frames every frame after the init makes
   a keyframe, and F8 keeps such frames stepwise); (b) the first inertial window after 25a's IMU init
   solved again on the CPU from the same inputs, in float32 (P5): the
   states within phase 14's tolerance.
26. the RGB-D System (M9d) at ORB-SLAM3's TUM1.yaml sizes (640x480 at 30
   fps, 1000 features, 8 levels, bf 40, ThDepth 40) on the rendered sweep
   with its exact depth maps (datasets.synthetic.generate_rgbd_sequence):
   (a) System(Sensor.RGBD) in its default configuration (the shipped
   vocabulary, the loop closer inline) over 60 frames: every frame OK and
   stepwise (ROADMAP F40), fetches and depths per frame, keyframes, map
   points, the SE(3) ATE (at most 0.02 m and twice the JAX package's
   paired reading, RGBD_JAX), ms/frame of stepwise and keyframe frames,
   both kernels' launches by stage; (b) System(Sensor.IMU_RGBD) over 80
   frames with their 200 Hz IMU stream (T_b_c1 = I): the IMU init after
   2 s, every frame from it on OK, |bg|, the SE(3) ATE (at most 0.02 m
   over all frames and over those after the init), ms/frame of stepwise
   frames before and after the init and of keyframe frames; (c)
   process_rgbd_frame on frame 0 on the card and on the CPU (keypoint
   overlap, u_right and depth equal on the common keypoints), and 26a's
   frames up to its second keyframe (its first fusion) through the default
   System on both: states, keyframes, camera centres within 1e-3 m.
27. atlas save and load (M9e) and the KITTI driver (M9f): (a) phase 17's
   atlas, saved after its frame 59, loaded into a new default System that
   tracks frames 50-71: the loaded counts equal the saved ones, re-acquired
   within 3 frames and OK from then on, the ATE over the resumed frames
   (<= 0.02 m), both kernels launched after the load; the same frames
   through a new System in localization mode (no keyframe added); the
   card-written file loaded into System(device="cpu") and saved again,
   equal array for array, neither file naming anything but NumPy; (b)
   phase 21b's atlas, written by its shutdown (Settings.save_atlas), loaded
   through Settings.load_atlas by a new System(Sensor.IMU_STEREO) on frames
   50-64 of phase 13's sequence with their IMU samples: IMU-initialized,
   the bias the saved newest keyframe's, every frame OK from the third on,
   the ATE (<= 0.02 m; ROADMAP F45); (c) examples/torch_kitti_stereo.py
   in this process at KITTI00-02.yaml's setting (1241x376, 10 fps, 2000
   features, 8 levels, FAST 20/7, ThDepth 35, baseline 0.537 m) on 20
   rendered frames written in KITTI's layout: every frame OK, 20 lines of
   f_traj_kitti.txt, the ATE (<= 0.02 m and twice the JAX package's
   paired reading, KITTI_JAX), both kernels' launches by shape, each top-K
   shape one that phase 3 holds.
28. multi-device (M10), on shards of the one card (one H100 cannot show
   NCCL between cards, an interconnect's rate or a window larger than one
   card holds): (a) parallel.distributed_bundle_adjustment on
   tools/bench_multichip.py's window (100 keyframes, 10,240 points, 8
   observations a point; parallel.dryrun.make_problem) at 1, 2 and 4
   shards of cuda:0, 8 iterations, in float32 and float64: ms per
   iteration and its split (shard compute, reduce, solve, back-substitution,
   cost, fetch; CUDA events), in float64 the same accepted steps, costs,
   poses and inliers at every shard count, in float32 (where rounding
   decides the steps) each final cost within 1% of the float64 run's
   reduction from its start,
   and the 1-shard mesh's first 2 iterations against the CPU; (b)
   tools/torch_bench_multichip.py --processes 2: two processes sharing the
   card over gloo, one shard each, on the JAX worker's window (40 x 4,096):
   both exit 0, the final cost that of one process with 2 shards, the
   all-reduce's share of an iteration; (c) LocalMapper(mesh=make_mesh(2))
   ._local_ba on tests/test_parallel.py's drifted map: the reprojection
   error halved, the corrupted observations dropped, the same on the CPU,
   beside the unsharded card mapper; (d) sharded_extract_batch of 8 frames
   at 752x480 over 1, 2 and 4 shards: every frame's keypoints those of
   extract_orb, as sets.

Phase 3 also holds both kernels at phase 27c's KITTI shapes (top-K at
2000 x 2000 with K 64 and K 2, 4096 x 2000 and 20480 x 2048; the matrix at
541 x 2000 and 167 x 2000), and times torch._int_mm of the +-1 descriptors
at the matrix kernel's shapes: the int8 product the kernel computes in its body
(Hamming = (256 - q.k) / 2), without the penalties, as its library
yardstick.

Phases 8 to 12 and 15 share one rendered sequence: phase 8 tracks its first 40
frames with no mapper, so that its ATE stands beside the system's over the
same frames. Phases 13, 16 and 21b share another; phase 19b adjusts phase
13's map. Phases 26a-c share the RGB-D scene. Phase 27a loads phase 17's
atlas, 27b phase 21b's; 27c's KITTI layout is rendered and written in the
renderer's process, into a temporary directory with the atlas files.

The line before the last two is a JSON object of the kernels; the last is
{"ok": true, "device": {...}}. Each kernel's `launches` is what the
twenty-nine paths (phases 4, 6, 8, 10, 13, 15, 16, 17, 18a, 18b, 19a, 20a,
20b, 21a, 21b, 22a, 22b, 23a, 23b's card run, 24a, 24b's card run, 25a's
two, 26a, 26b, 26c's card run, 27a, 27b and 27c) launched, counted from 0
at each path's start (phase 19b launches neither; 27a counts its tracking
after the load, not its localization-mode run); `launches_relocalization` and
`launches_loop_closing` are the part of phases 17-18 that relocalization
and the loop closer made, and `launches_merge` the part of phases 20a and
20b that `_merge_maps` made (the top-K kernel's K = 2 verification, the
matrix kernel's fusion at the weld); `launches_multi_device` is phase
28's, counted from 0 at its start: none, since the sharded BA and the
extraction are plain PyTorch (ROADMAP K16). The matrix kernel is launched by the system paths alone (map-point
fusion); no tracker path calls it since its top-K was fused.
Imports nothing of JAX.
"""

import concurrent.futures
import dataclasses
import json
import multiprocessing
import os
import pickle
import runpy
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import types

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from fasttrack_tpu_torch import (
    ba_assembly,
    convert,
    frame_pipeline,
    fused_track,
    local_mapping,
    loop_closing,
    native,
    parity,
    slam_map,
    tracking,
)
from fasttrack_tpu_torch.bow.vocabulary import train_vocabulary
from fasttrack_tpu_torch.cameras import host_camera, make_kannala_brandt8, make_pinhole
from fasttrack_tpu_torch.datasets import synthetic
from fasttrack_tpu_torch.datasets.synthetic import (
    LOOP_FX,
    LOOP_H,
    LOOP_W,
    drifted_leg_scene,
    drifted_loop_scene,
    generate_sequence,
    mean_reprojection_error,
    noisy_leg_scene,
    two_map_scene,
)
from fasttrack_tpu_torch.evaluation import absolute_trajectory_error
from fasttrack_tpu_torch.frame_pipeline import (
    pack_frame_for_host,
    pack_hot_path_for_host,
    process_stereo_frame_stacked,
    tracking_hot_path,
    unpack_hot_path,
)
from fasttrack_tpu_torch.geometry import se3_identity
from fasttrack_tpu_torch.kernels import KernelConfig
from fasttrack_tpu_torch.ops import hamming_kernel
from fasttrack_tpu_torch.ops.extractor import OrbConfig, extract_orb
from fasttrack_tpu_torch.ops.stereo_match import valid_penalty
from fasttrack_tpu_torch.ops.topk import top_k
from fasttrack_tpu_torch.optim import ba_core
from fasttrack_tpu_torch.optim.inertial import local_inertial_ba
from fasttrack_tpu_torch.parallel import (
    distributed_bundle_adjustment,
    make_mesh,
    sharded_extract_batch,
)
from fasttrack_tpu_torch.parallel import dryrun as mesh_dryrun
from fasttrack_tpu_torch.settings import Settings
from fasttrack_tpu_torch.slam_map import Atlas
from fasttrack_tpu_torch.system import Sensor, System
from fasttrack_tpu_torch.tracking import Tracker
from tools.torch_bench_multichip import run_multiprocess

H, W = 480, 752
CFG = OrbConfig(height=H, width=W, n_features=1024, n_levels=8)
INTRINSICS = (458.654, 457.296, 367.215, 248.375)  # EuRoC cam0, as bench.py
BF = 47.9
N_MAP = 2048
N_WARMUP, N_FRAMES = 3, 10      # hot path
N_FUSED_FRAMES = 12             # fused step, after the same warm-up
STORE_CAP = 8192                # rows of the device-resident point store
KEYFRAME_EVERY = 4              # frames between insertions of new map points
STEP = (3, 5)  # (dy, dx) px the view moves per frame: content moves (-5, -3)
TOP_K = 64
FUSION_SHAPE = (3000, 1024)     # candidate points x keypoints of a fusion's reverse pass
# the tracker's shapes, PERF.md's 4096 x 1024 row, a ragged one and a fusion's
# KITTI's widths (phase 27c, 2,000 features a camera): the stereo match,
# TWM and the reference-keyframe match at 2000 x 2000, TLM at 4096 x 2000,
# the triangulation's 10 neighbours of 2,048-row capacity; the matrix at the
# two fusions of PR 14's call A
KITTI_FUSION_SHAPES = [(541, 2000), (167, 2000)]
KITTI_TOPK_SHAPES = [(2000, 2000, 64), (2000, 2000, 2), (4096, 2000, 64), (20480, 2048, 64)]
MATRIX_SHAPES = [(1024, 1024), (2048, 1024), (4096, 1024), (1200, 1000), FUSION_SHAPE,
                 *KITTI_FUSION_SHAPES]
EPI_ROWS = 10 * 1024            # the mapper's 10 neighbour keyframes, stacked
# (M, N, kind of input, K); 33 x 40 has N < K. "validity": what match_fisheye
# gives the kernel (penalties 0 or 1e9, invalid rows tie across all columns).
# The last three hold the kernel's tiling: ties across its key tiles and the
# K <= 2 path at the widest N, and zero rows ("zeros").
TOPK_CASES = [(1024, 1024, "random", 64), (2048, 1024, "random", 64), (4096, 1024, "random", 64),
              (1200, 1000, "random", 64), (33, 40, "random", 64), (1024, 1024, "tied", 64),
              (1024, 1024, "validity", 2), (1000, 900, "validity", 2), (1024, 1024, "tied", 2),
              (EPI_ROWS, 1024, "validity", 64), (1024, 4096, "words", 1),
              (1024, 4096, "validity", 1), (700, 64, "tied", 1),
              (2000, 2000, "random", 64), (2000, 2000, "validity", 2), (4096, 2000, "random", 64),
              (20480, 2048, "validity", 64), (1024, 4096, "tied", 64), (1024, 4096, "validity", 2),
              (1024, 1024, "zeros", 64)]
# K = 1: the flat vocabulary's quantization (bow/vocabulary.py:_assign), the
# shipped flat vocabulary's 4096 words at the kernel's MAX_N, zero penalties
CHUNKED_SHAPE = (1024, 5000)    # K = 1 past MAX_N: a wider flat vocabulary in two launches
# Past MAX_N keys (ROADMAP F46): one launch per chunk of MAX_N keys, merged on
# the card; a settings file with more than 4,096 features a camera
PAST_MAX_N_CASES = [(1024, 5000, "random", 64), (1024, 5000, "random", 2),
                    (1024, 5000, "tied", 64)]
N_SYSTEM_FRAMES = 100           # the rendered sequence; phases 10 and 12 (its first 40)
N_TRACKER_FRAMES = 40           # of them, phase 8 (no mapper)
N_TRACKER_CPU_FRAMES = 6        # of them, again on the CPU in phase 9
# ATE RMSE limit of phase 8 (m). The same 40 frames through Tracker(device="cpu")
# give 0.0033 m; the limit leaves room for f32 sums taken in another order and
# for a keyframe decision that falls a frame earlier or later.
ATE_LIMIT_M = 0.02
N_ASYNC_FRAMES = 50             # phase 12: three keyframes, one adjustment
MAX_SYSTEM_CPU_FRAMES = 48      # phase 11 stops after the frame that follows the third keyframe
SYSTEM_CPU_THREADS = 4          # phase 11's CPU run, beside the card phases on the same host
N_INERTIAL_FRAMES = 160         # phase 13: 8 s, IMU init at ~2 s, the 5 s full-BA stage after it
N_REPLAY_FRAMES = 3             # phase 14: inertial fused frames replayed on the CPU
# Phases 15 and 16 run the host extractor, whose NumPy pyramid takes ~2 s a
# frame on the card's host; phase 15 is cut from 40 frames to 24, then to 12
# (medians over the last 10) to make room for phases 22-23, and phase 16
# from 60 frames to 50 (9 after its IMU init) to make room for phase 25;
# for phase 26, phase 15's masks with host extraction run 6 frames (medians
# over the last 4) and phase 16 45 (4 after its IMU init), so that the
# whole run stays inside its time limit
N_TOGGLE_FRAMES = 12            # phase 15: of phase 8's sequence, per configuration
N_TOGGLE_HOST_FRAMES = 6        # phase 15: the same, for the masks that extract on the host
N_HOST_INERTIAL_FRAMES = 45     # phase 16: of phase 13's sequence (IMU init at frame 40)
# Phase 16's ATE over all its frames. Before IMU init the host extractor's map
# lets a local BA pull the keyframes by centimetres, in the JAX package as in
# the port (ROADMAP F15). tools/host_route_drift.py on the card's host CPU read
# 0.0248 m for the JAX package and 0.0366 m for the port over these 60 frames
# (seeds 1 and 2: 0.0682 / 0.0753 m and 0.0220 / 0.0043 m). The limit is twice
# the JAX package's reading on this sequence; the frames after init are held
# to ATE_LIMIT_M.
HOST_ROUTE_ATE_LIMIT_M = 0.05
# phase 15's configurations (mask, pose optimization) and BASELINE.md's
# published tracking ms/frame for each (MH01 / V101 / room1 / corridor1,
# stereo-inertial): FastTrack on the reference's paper rig, hardware
# unrecorded; a yardstick, not the port's number and not a target
TOGGLE_CONFIGS = [("1111", True), ("1111", False), ("0000", True), ("0000", False),
                  ("1000", True), ("1100", True), ("0011", True)]
BASELINE_MS = {("0000", True): (15.95, 14.86, 15.48, 16.05),
               ("1000", True): (9.80, 10.17, 11.70, 11.95),
               ("1100", True): (9.10, 9.16, 11.11, 11.58),
               ("0011", True): (15.66, 14.69, 13.02, 13.61),
               ("0000", False): (13.82, 12.79, 10.18, 10.93),
               ("1111", False): (6.83, 6.62, 5.74, 6.41)}
# Phase 17: phase 10's sequence, frames 0-59, 3 blank frames, frames 0-11
# again; phase 18b: the rendered loop. Their gates come from
# tools/place_recognition_reading.py, the JAX package and the port each on
# the card's host CPU (PERF.md §6). Phase 17: the JAX package re-acquires on
# the first frame fed again, 0.0011 m from the truth (the port 0.0004 m);
# the limit is twice that, under the JAX test's 0.25 m. Frame 59 relocalized
# against the database: the JAX package 0.0104 m from the truth with 74
# inliers (the port 0.0093 m, 86); the limit is twice that. Phase 18b: neither
# package closes a loop in 240 frames of the rendered loop (ROADMAP F7), so
# the phase runs one 10 s lap, 200 frames, and bounds the ATE at twice the
# JAX package's reading there (0.1279 m; the port's 0.0699 m).
N_RELOC_TRACKED, N_RELOC_BLANK, N_RELOC_AGAIN = 60, 3, 12
RELOC_JAX_ERROR_M = 0.0011
RELOC_LIMIT_M = min(2 * RELOC_JAX_ERROR_M, 0.25)
RELOC_DIRECT_JAX_ERROR_M = 0.0104
RELOC_DIRECT_LIMIT_M = min(2 * RELOC_DIRECT_JAX_ERROR_M, 0.25)
N_LOOP_FRAMES = 200
LOOP_JAX_CLOSES = False
LOOP_JAX_ATE_M = 0.1279
LOOP_ATE_LIMIT_M = 2 * LOOP_JAX_ATE_M
DRIFT_RATIO = 0.6               # phase 18a: tests/test_gba_merge.py's bound on the drift left
N_ASYNC_INERTIAL_FRAMES = 50    # phase 21b: of phase 13's sequence (IMU init near frame 40)
# Phase 20b: frames 0-79 of phase 18b's loop, 7 blank frames 1 s apart (6
# span exactly time_recently_lost, 5 s, which does not pass it: the next
# frame re-acquires in the old map), frames 20-59 again, so that the new
# map's world (frame 20's camera) is offset from the old map's (frame 0's)
# and the weld has to undo it. The gates come from
# tools/place_recognition_reading.py's merge reading on the card's host CPU:
# the JAX package merges once, at the 5th frame fed again (frame 24); the
# frames fed again have an ATE RMSE of 0.4797 m (SE(3) alignment over the
# two worlds: it cannot see the weld), 0.0082 m after the merging frame,
# and after it the camera centres lie at most 0.0876 m from the truth in
# the old map's world without alignment, the gate that sees the weld (the
# port: the 5th frame, 0.4667, 0.0044 and 0.0391 m).
N_MERGE_TRACKED, N_MERGE_BLANK, N_MERGE_AGAIN = 80, 7, 40
MERGE_AGAIN_FROM = 20
MERGE_JAX_MERGES = 1
MERGE_JAX_ATE_M = 0.4797
MERGE_ATE_LIMIT_M = 2 * MERGE_JAX_ATE_M
MERGE_JAX_ATE_AFTER_M = 0.0082
MERGE_JAX_CENTRE_M = 0.0876
MERGE_CENTRE_LIMIT_M = 2 * MERGE_JAX_CENTRE_M
# Phases 22 and 23: the camera rigs of the reference's datasets as they are
# distributed, rendered by datasets.synthetic with their IMU streams in a
# body frame 90 deg about z from camera 1: EuRoC's distorted pinhole pair
# at 752x480 (cam0's and cam1's intrinsics and radtan coefficients, camera 2
# 0.11 m along x and 0.8 deg about x; rectified at start-up) and TUM-VI's
# KB8 fisheye pair at 512x512 (its calibration, 0.101 m, the plane 3 m
# away, an image circle KB8_FOV_DEG off the axis).
N_RIG_FRAMES = 60               # phases 22a and 23a: IMU init at ~2 s
N_RESIZE_FRAMES = 30            # phase 22b: its first 30 frames
RESIZE_TO = (376, 240)          # phase 22b: Camera.newWidth / newHeight
KB8_SIZE = 512
KB8_PLANE_Z = 3.0
# Phase 23's image circle. With the renderer's 75 deg most keypoints lie on
# the plane seen far off and at a grazing angle, where no stereo depth passes
# the parallax gate and a KB8 map makes no epipolar points: both packages
# read ~0.15 m there (ROADMAP F25, rig_reading.py). At 50 deg the route
# reaches fused inertial frames and the 0.02 m gate.
KB8_FOV_DEG = 50.0
N_FISHEYE_CPU_FRAMES = 6        # phase 23b
MIN_FISHEYE_DEPTHS = 100        # Tracking::StereoInitialization's threshold
# Phase 24: the visual monocular System (M9b) over the first N_MONO_FRAMES
# frames of phase 10's sequence (already rendered), the shipped vocabulary,
# inline. At this width both packages' monocular Systems degrade on the
# rendered sweep (ROADMAP F31), so phase 24a's gates are relative to the JAX
# package's reading of the same frames on the card's host CPU
# (rig_reading.mono_reading("jax"), PERF.md §6): its initialization frame
# (the port's within one frame of it), its OK frames (the port's no more than
# 3 fewer), its first loss after the init (None: none) and its Sim(3)-aligned
# ATE over the frames before that loss (the port's over the same frames no
# more than twice it). Phase 24b holds the card to the CPU instead. The
# reading (an NVIDIA H100 machine's host CPU): the JAX package initializes at frame 2,
# is OK on 48 frames, loses track at frame 50 (its 909 map points went to 0
# at frame 49's keyframe) and reads 0.0258 m over frames 2-49 (Sim(3), scale
# 1.29); the port on the CPU: frame 2, all 58 after it OK, 0.0403 m over
# them (its monocular windows reject flipped steps, ROADMAP F24).
N_MONO_FRAMES = 60
N_MONO_CPU_FRAMES = 8           # phase 24b: of phase 24a's frames
MONO_JAX = {"init_frame": 2, "frames_ok": 48, "first_loss": 50, "ate_m": 0.02579}
MONO_INIT_SLACK, MONO_OK_SLACK, MONO_ATE_FACTOR = 1, 3, 2.0
# Phase 25: the monocular-inertial System (M9c) over 24a's frames with their
# IMU stream, on to the frame of its first scale refinement (at most
# N_MI_FRAMES of phase 10's sequence). The gates are the renderer's truth
# from the IMU init's frame on (the JAX package loses track right after its
# init on the same scene: ROADMAP F35). After the init the reference ratio
# is 0.75 above 350 inliers (F38): with the monocular 0.9 every frame after
# the init made a keyframe here, and none was fused.
N_MI_FRAMES = 70
MI_SCALE_TOL = 0.05             # the Sim(3) scale of the frames from the IMU init on
MI_ATE_LIMIT_M = 0.02           # their SE(3) ATE (an H100 read 0.0091 m over 16 frames)
# Phases 26a-c: the RGB-D System at the sizes of ORB-SLAM3's
# Examples/RGB-D/TUM1.yaml (640x480 at 30 fps, 1000 features, 8 levels,
# scale 1.2, FAST 20/7, Camera.bf 40.0, ThDepth 40.0, so th_depth 3.125 m
# at the renderer's fx = 512), on the rendered sweep (seed 3) with its exact
# depth maps; 26b runs its first N_RGBD_INERTIAL_FRAMES with the IMU stream,
# 26a the first N_RGBD_FRAMES (the sweep's period is 3 s for both)
RGBD_H, RGBD_W, RGBD_FPS, RGBD_SEED = 480, 640, 30.0, 3
RGBD_FEATURES, RGBD_BF, RGBD_TH_DEPTH = 1000, 40.0, 40.0
N_RGBD_FRAMES = 60
N_RGBD_INERTIAL_FRAMES = 80     # the IMU init after its 2 s of keyframes, at frame ~65
N_RGBD_CPU_FRAMES = 6           # phase 26c, if 26a made fewer than two keyframes
# Phase 26a-b's paired reading: the JAX package's System(Sensor.RGBD) and
# System(Sensor.IMU_RGBD) in their default configuration over the same
# frames, on the card's host CPU (rig_reading.rgbd_reading("jax", inertial,
# "chip")); 26a's ATE limit is twice its ATE, and at most ATE_LIMIT_M
RGBD_JAX = {"frames_ok": 60, "keyframes": 6, "ate_m": 0.006312, "imu_init_frame": 65,
            "ate_inertial_m": 0.006586}
RGBD_ATE_FACTOR = 2
# Phases 27a-c: atlas save and load (M9e), the KITTI driver (M9f). 27a: the
# default System of phase 17 saved after frames 0-59, loaded into a new
# System that tracks frames 50-71 (from the sequence's middle, on past the
# saved map's last frame): 22 frames, because a tracker over a map it knows
# makes its first keyframe by the 20-frame spacing rule (max_frames), at
# the 21st frame, and only a keyframe runs the mapper's fusion, the matrix
# kernel; 27b: phase 21b's stereo-inertial System saved on shutdown after
# its 50 frames, loaded through Settings.load_atlas and fed frames 50-64
# with their IMU samples (its second frame is a keyframe: ROADMAP F45)
N_ATLAS_FROM, N_ATLAS_FRAMES, N_ATLAS_INERTIAL_FRAMES = 50, 22, 15
ATLAS_REACQUIRE_FRAMES = 3      # 27a: re-acquired within this many resumed frames
ATLAS_INERTIAL_OK_FROM = 2      # 27b: every resumed frame OK from the third on
# 27c: KITTI's published stereo setting, ORB-SLAM3's Examples/Stereo/
# KITTI00-02.yaml (1241x376 at 10 fps, 2000 features, 8 levels, scale 1.2,
# FAST 20/7, ThDepth 35, baseline 0.537 m), over 20 frames of the rendered
# sweep with the renderer's own pinhole (fx = 0.8 w; KITTI's is 718.856),
# written in KITTI's layout and run through examples/torch_kitti_stereo.py
KITTI_W, KITTI_H, KITTI_FPS, KITTI_BASELINE = 1241, 376, 10.0, 0.537
N_KITTI_FRAMES = 20
KITTI_FEATURES, KITTI_LEVELS, KITTI_SCALE, KITTI_FAST, KITTI_TH_DEPTH = 2000, 8, 1.2, (20, 7), 35.0
# 27c's paired reading: the JAX package's examples/kitti_stereo.py on the same
# layout, on the card's host CPU (rig_reading.kitti_reading("jax"), PR 14
# call A, an NVIDIA H100 machine's host: every frame tracked, 0.012363 m);
# the port's ATE limit is twice its ATE, and at most ATE_LIMIT_M
KITTI_JAX = {"ate_m": 0.012363490489364401, "frames_ok": 20, "trajectory_lines": 20}
KITTI_ATE_FACTOR = 2
# Phase 28 (M10): the landmark-sharded BA on tools/bench_multichip.py's
# window (100 keyframes, 10,240 points, 8 observations a point) at 1, 2 and 4
# shards of the card, 8 LM iterations, in float32 (the benches') and float64
# (the mapper's window, P4); 28b two processes sharing the card over gloo on
# the JAX worker's window; 28c the mapper with a mesh on
# tests/test_parallel.py's drifted map; 28d a batch extracted over the shards
MESH_WINDOW = (100, 10240, 8)   # keyframes, points, observations a point
MESH_SHARDS = (1, 2, 4)
MESH_ITERS = 8
MESH_CPU_ITERS = 2              # 28a: the 1-shard mesh's first iterations, again on the CPU
# 28a-b: in float32 the steps are decided by rounding on this window (on
# the CPU the second step is rejected in float32 and accepted in float64; on
# the card 4 shards accepted 2 steps of 8 and stopped 10% above the float64
# optimum, 1 shard 4; the JAX package's own table moves with N too,
# MULTICHIP_r05.json): a float32 run is held to have made 99% of the
# reduction that float64 makes (initial cost to optimum), and two float32
# runs of one window to the same within 1% of their reduction
MESH_F32_COST_TOL = 0.01
RANKS_WINDOW = {"BMC_K": "40", "BMC_L": "4096", "BMC_ITERS": "6"}   # the JAX worker's window
RANKS_TIMEOUT_S = 300
N_MESH_FRAMES = 8               # 28d: frames of phase 10's sequence in one batch
HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory (NVIDIA data sheet)
INT8_OPS_PER_S = 1979e12        # dense int8 tensor-core rate: a +-1 product is an int8 MAC


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    check(len(out) >= 1, "nvidia-smi printed no card")
    return out[0].strip()


def device_kernels(prof):
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]


# Set while a phase runs beside phases of another process on the same card
# and host (phase 16 beside 17-18, 24-25 beside 22-23): the phase's line
# says so, since its times are taken under that contention.
BESIDE = ""


def beside(note, fn, *args):
    """fn(*args), its phases' lines marked with `note`."""
    global BESIDE
    BESIDE = f" [{note}]"
    try:
        return fn(*args)
    finally:
        BESIDE = ""


TIMER = {"mode": "profiler"}    # "events" once the tracer has failed; never back


def profiler_ms(fn, calls, windows):
    """Median over `windows` windows of the summed duration of the kernels
    one call launches, from torch.profiler over `calls` calls; None when
    the tracer does not deliver. The tracer can lose the first few kernels
    of a window (after an earlier window that also traced the host it loses
    exactly the first two), so each window opens with 8 spin kernels that
    are not counted. A window that shows no kernel, or some kernel not a
    whole number of times per call, is taken again; three such windows in
    a row and the tracer is given up."""
    readings, spoilt = [], 0
    while len(readings) < windows:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(8):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        by_name = {}
        for k in device_kernels(prof):
            if "spin_kernel" not in k.name:
                by_name.setdefault(k.name, []).append(k.time_range.elapsed_us())
        if not by_name or any(len(d) % calls for d in by_name.values()):
            spoilt += 1
            if spoilt == 3:
                print("timer: torch.profiler gave three timing windows in a row with no kernel or "
                      "with dropped kernel events (last: "
                      + str({n[:60]: len(d) for n, d in by_name.items()}) + f" over {calls} calls); "
                      "every later device time is taken with CUDA events behind a spin kernel")
                return None
            continue
        spoilt = 0
        readings.append(sum(np.sum(d) for d in by_name.values()) / calls / 1e3)
    return float(np.median(readings))


def events_ms(fn, calls, windows):
    """Median over `windows` windows of the time between two CUDA events
    around `calls` calls, per call. A spin kernel holds the stream while the
    host queues the first event, every call and the last event, so the
    events bracket the kernels running back to back and none of the host's
    time: a window in which the spin ended before the host was done (the
    first event already reached) is taken again behind a longer spin. The
    gaps between consecutive kernels are inside the reading, which the
    profiler's kernel durations leave out."""
    readings, spin = [], 20_000_000
    while len(readings) < windows:
        first, last = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(spin)
        first.record()
        for _ in range(calls):
            fn()
        last.record()
        host_was_late = first.query()
        torch.cuda.synchronize()
        if host_was_late:
            spin *= 2
            check(spin < 2_000_000_000, "the host cannot queue a timing window behind a spin kernel")
            continue
        readings.append(first.elapsed_time(last) / calls)
    return float(np.median(readings))


def device_ms(fn, calls=20, windows=3) -> float:
    """Device time of one call in ms, by TIMER["mode"]: the profiler's
    kernel durations, or, once the tracer has failed in this run, CUDA
    events that bracket the kernels alone. Never a host clock."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    if TIMER["mode"] == "profiler":
        ms = profiler_ms(fn, calls, windows)
        if ms is not None:
            return ms
        TIMER["mode"] = "events"
    return events_ms(fn, calls, windows)


def in_turns(plain, kern):
    """(kernel ms, plain ms, timer): plain, kernel, kernel, plain, all four
    by one timer; taken again if the timer changed on the way."""
    while True:
        mode = TIMER["mode"]
        p1, k1, k2, p2 = device_ms(plain), device_ms(kern), device_ms(kern), device_ms(plain)
        if TIMER["mode"] == mode:
            return (k1 + k2) / 2, (p1 + p2) / 2, mode


def kernel_inputs(rng, M, N, device, kind="random"):
    """+-1 descriptors and penalties among 0, small values, 1e9 and 2e9
    (where f32 rounding makes the addition order matter); "words": zero
    penalties, as the vocabulary's quantization gives them; "tied": rows
    drawn from 4 descriptors, so that most distances are equal; "validity":
    penalties as match_fisheye makes them from validity masks (a fifth of
    the rows and columns at 1e9: such a row ties across all its columns);
    "zeros": zero rows under 1e9 penalties on both sides, as the point
    store's empty rows and the tracker's padded gathers give them (a tenth
    of the queries; all keys but 40, fewer than K, so that a row's
    penalised slots reach the output), and +1 queries with 40 to 60
    entries at -1, whose distance to a zero key is 128, not their count of
    -1 entries (a kernel that read only signs would see 1e9 + 64 there,
    not 1e9 + 128)."""
    if kind == "zeros":
        q = np.ones((M, 256), np.int8)
        for row, n_neg in enumerate(rng.integers(40, 61, M)):
            q[row, rng.choice(256, n_neg, replace=False)] = -1
        zero_q = rng.random(M) < 0.1
        q[zero_q] = 0
        k = np.zeros((N, 256), np.int8)
        valid_k = rng.choice(N, min(40, N), replace=False)
        k[valid_k] = 2 * rng.integers(0, 2, (len(valid_k), 256)) - 1
        qp = np.where(zero_q, 1e9, 0.0).astype(np.float32)
        kp = np.full(N, 1e9, np.float32)
        kp[valid_k] = 0.0
    elif kind == "words":
        q = (2 * rng.integers(0, 2, (M, 256)) - 1).astype(np.int8)
        k = (2 * rng.integers(0, 2, (N, 256)) - 1).astype(np.int8)
        qp, kp = np.zeros(M, np.float32), np.zeros(N, np.float32)
    elif kind == "validity":
        q = (2 * rng.integers(0, 2, (M, 256)) - 1).astype(np.int8)
        k = (2 * rng.integers(0, 2, (N, 256)) - 1).astype(np.int8)
        qp = valid_penalty(torch.from_numpy(rng.random(M) > 0.2)).numpy()
        kp = valid_penalty(torch.from_numpy(rng.random(N) > 0.2)).numpy()
    elif kind == "tied":
        base = (2 * rng.integers(0, 2, (4, 256)) - 1).astype(np.int8)
        q, k = base[rng.integers(0, 4, M)], base[rng.integers(0, 4, N)]
        pens = np.asarray([0.0, 0.5, 1e9, 2e9], np.float32)
        qp, kp = rng.choice(pens, M), rng.choice(pens, N)
    else:
        q = (2 * rng.integers(0, 2, (M, 256)) - 1).astype(np.int8)
        k = (2 * rng.integers(0, 2, (N, 256)) - 1).astype(np.int8)
        qp = rng.choice(np.asarray([0.0, 1e9, 3.0e6, 0.5], np.float32), M)
        kp = rng.choice(np.asarray([0.0, 1e9, 2.0e9, 7.25], np.float32), N)
    arrays = (q, k, qp.astype(np.float32), kp.astype(np.float32))
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)


def bound_ms(M, N, out_bytes):
    """The least time the card could take: the larger of the bytes that must
    move (each operand read once as int8, penalties, the output written
    once) over the memory rate and the M * N * 256 int8 multiply-adds over
    the tensor cores' rate. Returns (ms, "bytes" or "operations")."""
    by_bytes = ((M + N) * (256 + 4) + out_bytes) / HBM_BYTES_PER_S * 1e3
    by_ops = 2.0 * M * N * 256 / INT8_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def phase_matrix_kernel(device, card):
    rng = np.random.default_rng(0)
    kern = hamming_kernel.hamming_penalty_matrix
    plain = hamming_kernel.hamming_penalty_matrix_reference
    rows, max_err = {}, 0.0
    for M, N in MATRIX_SHAPES:
        args = kernel_inputs(rng, M, N, device)
        before = kern.launches
        got = kern(*args)
        torch.cuda.synchronize()
        check(kern.launches == before + 1, f"matrix launch counter did not count at {(M, N)}")
        want = plain(*args)
        check(torch.equal(got, want), f"matrix kernel differs from plain at {(M, N)}")
        max_err = max(max_err, float((got - want).abs().max()))
        k_ms, p_ms, timer = in_turns(lambda: plain(*args), lambda: kern(*args))
        b, by = bound_ms(M, N, M * N * 4)
        # the library yardstick: the int8 product the kernel computes in its
        # body (Hamming = (256 - q.k) / 2), one torch._int_mm call, product
        # only, no penalties; checked against the plain version without them
        q, k = args[0], args[1]
        dot = torch._int_mm(q, k.t())
        zero_q, zero_k = torch.zeros_like(args[2]), torch.zeros_like(args[3])
        check(torch.equal((256 - dot).float() / 2, plain(q, k, zero_q, zero_k)),
              f"torch._int_mm's product is not the Hamming distance at {(M, N)}")
        lib_ms = device_ms(lambda: torch._int_mm(q, k.t()))
        rows[(M, N)] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b, "bound_by": by, "timer": timer,
                        "library_ms": lib_ms}
        print(f"phase 3 matrix kernel against plain {(M, N)}: bitwise equal; device time ({timer}) "
              f"kernel {k_ms * 1e3:.2f} us, plain {p_ms * 1e3:.2f} us, "
              f"bound {b * 1e3:.2f} us ({by}); library yardstick torch._int_mm (product only, "
              f"no penalties) {lib_ms * 1e3:.2f} us ({card})")
    return rows, max_err


def phase_topk_kernel(device, card):
    rng = np.random.default_rng(1)
    kern = hamming_kernel.hamming_penalty_topk
    plain = hamming_kernel.hamming_penalty_topk_reference
    matrix = hamming_kernel.hamming_penalty_matrix
    rows, max_err, mismatches = {}, 0.0, 0

    def replaced(*args, k):   # what the matchers did before: kernel matrix, stable sort, slice
        neg, idx = top_k(-matrix(*args), min(k, args[1].shape[0]))
        return -neg, idx

    for M, N, kind, K in TOPK_CASES:
        args = kernel_inputs(rng, M, N, device, kind)
        before = kern.launches
        values, indices = kern(*args, K)
        torch.cuda.synchronize()
        check(kern.launches == before + 1, f"top-k launch counter did not count at {(M, N, K)}")
        want_v, want_i = plain(*args, K)
        check(values.shape == want_v.shape == (M, min(K, N)), f"top-k shape at {(M, N, K)}")
        bad = int((indices != want_i).sum())
        mismatches += bad
        max_err = max(max_err, float((values - want_v).abs().max()))
        check(torch.equal(values, want_v) and bad == 0,
              f"top-k kernel differs from plain at {(M, N, kind, K)}: {bad} indices")
        line = f"phase 3 top-k kernel against plain {(M, N)} K={K} {kind}: values and indices equal"
        if kind == "validity":
            tie_rows = int((args[2] > 0).sum())
            check(tie_rows > 0, f"no penalised row among the inputs at {(M, N, K)}")
            line += f" ({tie_rows} rows penalised by 1e9 tie across their columns)"
        if kind == "zeros":
            zero_slots = int((want_v == 1e9 + 128).sum())
            check(zero_slots > 0, f"no zero key's slot among the outputs at {(M, N, K)}")
            line += (f" ({int((args[0] == 0).all(1).sum())} zero query rows; {zero_slots} output "
                     f"slots at 1e9 + 128, a query against a zero key)")
        if M >= 1024 and kind != "tied" and (M, N, K) not in rows:
            while True:
                k_ms, p_ms, timer = in_turns(lambda: plain(*args, K), lambda: kern(*args, K))
                rep = device_ms(lambda: replaced(*args, k=K))
                lib = device_ms(lambda: torch.topk(matrix(*args), K, largest=False))
                amin = device_ms(lambda: torch.argmin(matrix(*args), dim=1)) if K == 1 else None
                if TIMER["mode"] == timer:
                    break
            b, by = bound_ms(M, N, M * K * 12)
            rows[(M, N, K)] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b, "bound_by": by,
                               "replaced_ms": rep, "matrix_plus_torch_topk_ms": lib, "timer": timer}
            line += (f"; device time ({timer}) kernel {k_ms * 1e3:.2f} us, plain "
                     f"{p_ms * 1e3:.2f} us, matrix kernel + stable sort {rep * 1e3:.2f} us, "
                     f"matrix kernel + torch.topk {lib * 1e3:.2f} us (its tie order is unspecified), "
                     f"bound {b * 1e3:.2f} us ({by})")
            if K == 1:
                rows[(M, N, K)]["matrix_plus_torch_argmin_ms"] = amin
                line += f", matrix kernel + torch.argmin {amin * 1e3:.2f} us"
        print(f"{line} ({card})")
    return rows, max_err, mismatches


def phase_assign_chunked(device, card):
    """K = 1 past the kernel's MAX_N words: bow/vocabulary.py:_assign
    quantizes a 5,000-word flat vocabulary in two launches (4,096 + 904
    words) merged on the card. Held against its plain version (the argmin
    of the plain Hamming matrix, on the card) with rows tied across the
    chunks and inside the second one and words that only the second chunk
    holds."""
    from fasttrack_tpu_torch.bow.vocabulary import _assign, _assign_reference

    rng = np.random.default_rng(2)
    M, N = CHUNKED_SHAPE
    q = (2 * rng.integers(0, 2, (M, 256)) - 1).astype(np.int8)
    k = (2 * rng.integers(0, 2, (N, 256)) - 1).astype(np.int8)
    k[4500:4600] = k[:100]                      # ties across the chunks: the lower index wins
    q[200:300] = k[:100]
    k[hamming_kernel.MAX_N:hamming_kernel.MAX_N + 64] = q[:64]   # exact only past MAX_N
    k[4800:4864] = q[:64]                       # ties inside the second chunk
    q_t, k_t = (torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (q, k))
    kern = hamming_kernel.hamming_penalty_topk
    before = kern.launches_by_k[1]
    got = _assign(q_t, k_t)
    torch.cuda.synchronize()
    n_launches = kern.launches_by_k[1] - before
    want = _assign_reference(q_t, k_t)
    check(n_launches == -(-N // hamming_kernel.MAX_N),
          f"chunked K = 1: {n_launches} launches for {N} words")
    bad = int((got != want).sum())
    check(bad == 0 and bool((want >= hamming_kernel.MAX_N).any()),
          f"chunked K = 1 differs from plain at {(M, N)}: {bad} words")
    k_ms, p_ms, timer = in_turns(lambda: _assign_reference(q_t, k_t), lambda: _assign(q_t, k_t))
    b, by = bound_ms(M, N, M * 4)
    print(f"phase 3 chunked K=1 (_assign, {N} words in {n_launches} launches of at most "
          f"{hamming_kernel.MAX_N}) against plain {(M, N)}: words equal (ties across and inside "
          f"the chunks, {int((want >= hamming_kernel.MAX_N).sum())} rows whose word is past "
          f"MAX_N); device time ({timer}) {k_ms * 1e3:.2f} us, plain {p_ms * 1e3:.2f} us, bound "
          f"{b * 1e3:.2f} us ({by}) ({card})")
    return {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b, "bound_by": by, "timer": timer,
            "launches_per_call": n_launches}, bad


def phase_topk_past_max_n(device, card):
    """ROADMAP F46: `hamming_penalty_topk` past the kernel's MAX_N keys, as a
    settings file with more than 4,096 features a camera gives the stereo
    match: one launch per chunk of at most MAX_N keys at K_c = min(K, chunk
    width), the chunks' lists merged on the card (`merge_topk_chunks`),
    held against the plain version with values and indices exact (rows tied
    across the chunks too). Timed beside the plain version, with the merge
    alone."""
    rng = np.random.default_rng(3)
    kern = hamming_kernel.hamming_penalty_topk
    plain = hamming_kernel.hamming_penalty_topk_reference
    rows, mismatches = {}, 0
    for M, N, kind, K in PAST_MAX_N_CASES:
        args = kernel_inputs(rng, M, N, device, kind)
        before, before_k = kern.launches, dict(kern.launches_by_k)
        values, indices = kern(*args, K)
        torch.cuda.synchronize()
        n_chunks = -(-N // hamming_kernel.MAX_N)
        check(kern.launches == before + n_chunks,
              f"past MAX_N: {kern.launches - before} launches at {(M, N, K)}")
        check(kern.launches_by_k[K] - before_k.get(K, 0) == n_chunks,
              f"past MAX_N: launches by K at {(M, N, K)}")
        want_v, want_i = plain(*args, K)
        bad = int((indices != want_i).sum())
        mismatches += bad
        check(torch.equal(values, want_v) and bad == 0,
              f"past MAX_N: the kernel differs from plain at {(M, N, kind, K)}: {bad} indices")
        past = int((want_i >= hamming_kernel.MAX_N).any(1).sum())
        line = (f"phase 3 top-k kernel past MAX_N {(M, N)} K={K} {kind}: {n_chunks} launches a "
                f"call, values and indices equal ({past} rows list a key past MAX_N)")
        if kind != "tied":
            check(past > 0, f"past MAX_N: no row lists a key of the second chunk at {(M, N, K)}")
            q, k, qp, kp = args
            parts = [(*kern(q, k[c0:c0 + hamming_kernel.MAX_N], qp,
                            kp[c0:c0 + hamming_kernel.MAX_N],
                            min(K, N - c0, hamming_kernel.MAX_N)), c0)
                     for c0 in range(0, N, hamming_kernel.MAX_N)]
            while True:
                k_ms, p_ms, timer = in_turns(lambda: plain(*args, K), lambda: kern(*args, K))
                merge_ms = device_ms(lambda: hamming_kernel.merge_topk_chunks(parts, K))
                if TIMER["mode"] == timer:
                    break
            b, by = bound_ms(M, N, M * K * 12)
            rows[f"{M}x{N}, K {K}"] = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b,
                                      "bound_by": by, "merge_ms": merge_ms, "timer": timer,
                                      "launches_per_call": n_chunks}
            line += (f"; device time ({timer}) {k_ms * 1e3:.2f} us (the merge {merge_ms * 1e3:.2f} "
                     f"us of it), plain {p_ms * 1e3:.2f} us, bound {b * 1e3:.2f} us ({by})")
        print(f"{line} ({card})")
    return rows, mismatches


def host_frame(f32, desc) -> dict:
    f = f32.cpu().numpy()
    return {"x": f[0], "y": f[1], "level": f[2].astype(np.int32), "angle": f[3],
            "valid": f[6] > 0.5, "depth": f[5], "desc_packed": desc.cpu().numpy()}


def reprojection_rms(pos, R, t, x, y) -> float:
    """RMS pixel distance between world points `pos` seen from (R, t) and
    the keypoints (x, y)."""
    if len(pos) == 0:
        return float("inf")
    Xc = pos @ R.T + t
    u = INTRINSICS[0] * Xc[:, 0] / Xc[:, 2] + INTRINSICS[2]
    v = INTRINSICS[1] * Xc[:, 1] / Xc[:, 2] + INTRINSICS[3]
    return float(np.sqrt(np.mean((u - x) ** 2 + (v - y) ** 2)))


def phase_hot_path(device, frames, card):
    cam = make_pinhole(*INTRINSICS, W, H, device=device)
    bf = torch.tensor(BF, device=device)
    min_z = torch.tensor(BF / INTRINSICS[0], device=device)
    T0 = se3_identity(device=device)
    shift = (-float(STEP[1]), -float(STEP[0]))
    n_kp = CFG.total_features

    fd = process_stereo_frame_stacked(torch.from_numpy(frames[0]).to(device), CFG, bf, min_z)
    prev = host_frame(*pack_frame_for_host(fd))
    kern = hamming_kernel.hamming_penalty_topk
    kern.launches = 0
    hamming_kernel.hamming_penalty_matrix.launches = 0
    times, stats, last = [], [], 0
    for i in range(1, len(frames)):
        mp = parity.map_from_frame(prev, INTRINSICS, N_MAP, CFG.n_levels, shift=shift)
        local_map = convert.map_from_numpy(**mp, device=device)
        torch.cuda.synchronize()
        before = kern.launches
        t0 = time.perf_counter()
        images = torch.from_numpy(frames[i]).to(device)
        fd, res, opt = tracking_hot_path(images, CFG, bf, min_z, cam, T0, *local_map)
        buf = pack_hot_path_for_host(fd, res, opt).cpu()   # the frame's one fetch
        dt = (time.perf_counter() - t0) * 1e3
        host = unpack_hot_path(buf.numpy(), n_kp, N_MAP)

        n_valid = int(host["valid"].sum())
        n_stereo = int((host["depth"] > 0).sum())
        n_match = int(host["match_ok"].sum())
        pose_ok = bool(np.isfinite(host["R"]).all() and np.isfinite(host["t"]).all())
        check(kern.launches == before + 2, f"frame {i}: {kern.launches - before} kernel launches, not 2")
        check(n_valid > 0 and n_stereo > 0 and n_match > 0 and pose_ok,
              f"frame {i}: valid={n_valid} stereo={n_stereo} matches={n_match} pose finite={pose_ok}")
        # the pose must explain the matches: reprojection of the inliers
        inl, j = host["inliers"], host["match_idx"]
        rms = reprojection_rms(mp["pos"][inl], host["R"], host["t"], host["x"][j][inl], host["y"][j][inl])
        check(host["n_inliers"] >= 0.5 * n_match and rms < 3.0,
              f"frame {i}: {host['n_inliers']} inliers of {n_match} matches, reprojection rms {rms:.2f} px")
        if i > N_WARMUP:
            times.append(dt)
        stats.append((n_valid, n_stereo, n_match, host["n_inliers"], rms))
        prev, last = host, i
    launches = kern.launches
    check(launches == 2 * (len(frames) - 1), f"hot path launched the top-k kernel {launches} times")
    s = np.asarray(stats, np.float64)
    print(
        f"phase 4 hot path: {len(times)} timed frames (+{N_WARMUP} warm-up) at {W}x{H}, "
        f"{CFG.n_levels} levels, {CFG.n_features} features, map {N_MAP}: "
        f"median {np.median(times):.3f} ms/frame, p90 {np.percentile(times, 90):.3f} ms/frame "
        f"(per-frame sync: one packed fetch) on {card}; per frame median: "
        f"valid {np.median(s[:, 0]):.0f}, stereo {np.median(s[:, 1]):.0f}, "
        f"matches {np.median(s[:, 2]):.0f}, inliers {np.median(s[:, 3]):.0f}, "
        f"reprojection rms {np.median(s[:, 4]):.3f} px; top-k kernel launches {launches} (2 per frame), "
        f"matrix kernel launches {hamming_kernel.hamming_penalty_matrix.launches}"
    )
    return launches, hamming_kernel.hamming_penalty_matrix.launches, prev, last


def phase_card_vs_cpu(frames, card_frame, i):
    bf, min_z = torch.tensor(BF), torch.tensor(BF / INTRINSICS[0])
    fd = process_stereo_frame_stacked(torch.from_numpy(frames[i]), CFG, bf, min_z)
    k = fd.kps
    cpu = {"x": k.x.numpy(), "y": k.y.numpy(), "level": k.level.numpy(), "valid": k.valid.numpy(),
           "depth": fd.depth.numpy(), "desc_packed": k.desc_packed.numpy()}
    report = parity.golden_compare(card_frame, cpu)
    print(f"phase 5 card against CPU (frame {i}): {json.dumps(report)}")
    check(report["pass"], f"card and CPU disagree beyond the golden thresholds: {report}")


def phase_fused_step(device, frames, card):
    """The tracker's OK-state frame, host side as Tracker._track_fused: the
    world is the first frame's camera; map points are made from stereo
    keypoints at the first frame and every KEYFRAME_EVERY-th after it, and
    the store is uploaded again only then."""
    cam = make_pinhole(*INTRINSICS, W, H, device=device)
    cam_host = host_camera(cam)
    bf = torch.tensor(BF, device=device)
    min_z = torch.tensor(BF / INTRINSICS[0], device=device)
    scales = np.asarray([CFG.scale_factor**l for l in range(CFG.n_levels)], np.float64)
    N = M = CFG.total_features
    P = parity.TLM_CAP
    depth_m = BF / 7.0  # the frames' right image is the left shifted by 7 px

    fd = process_stereo_frame_stacked(torch.from_numpy(frames[0]).to(device), CFG, bf, min_z)
    last = host_frame(*pack_frame_for_host(fd))
    R_last, t_last = np.eye(3), np.zeros(3)
    velocity = (np.eye(3), np.zeros(3))   # T_cur o T_last^-1 of the previous step
    store = parity.new_store(STORE_CAP)

    def add_points(frame, mp_rows, R, t):
        sel = np.where((frame["depth"] > 0) & (mp_rows < 0))[0]
        mp_rows[sel] = parity.store_add_points(store, frame, sel, R, t, INTRINSICS, scales)
        return convert.store_from_numpy(
            store["pos"], store["desc_signed"], store["normal"], store["min_dist"],
            store["max_dist"], device=device,
        )

    last_rows = np.full(N, -1, np.int64)
    store_dev = add_points(last, last_rows, R_last, t_last)
    uploads = 1

    kern = hamming_kernel.hamming_penalty_topk
    kern.launches = 0
    hamming_kernel.hamming_penalty_matrix.launches = 0
    times, stats, kept = [], [], None
    for i in range(1, len(frames)):
        R_pred = velocity[0] @ R_last
        t_pred = velocity[0] @ t_last + velocity[1]
        q7, q_rows = parity.twm_query_block(
            store, last_rows, last["level"], last["angle"], cam_host, R_pred, t_pred, scales
        )
        cand = np.arange(store["n_rows"])[::-1]          # newest points first
        cand_rows, cand_ok, _ = parity.tlm_candidate_block(store, cand, P)
        torch.cuda.synchronize()
        before = kern.launches
        t0 = time.perf_counter()
        images = torch.from_numpy(frames[i]).to(device)
        qb = convert.query_block_from_numpy(q7, q_rows, cand_rows, cand_ok, device=device)
        T0 = convert.se3_from_numpy(R_pred, t_pred, device=device)
        fd = process_stereo_frame_stacked(images, CFG, bf, min_z)
        twm = fused_track.twm_step(fd.kps, fd.u_right, CFG, bf, cam, T0,
                                   qb.q7, qb.q_rows, store_dev.pos, store_dev.desc)
        tlm = fused_track.tlm_step(fd.kps, fd.u_right, CFG, bf, cam, twm,
                                   qb.cand_rows, qb.cand_ok, *store_dev)
        buf = fused_track.pack_fused_for_host(fd, twm, tlm).cpu()   # the frame's one fetch
        dt = (time.perf_counter() - t0) * 1e3
        f32, packed, idxA, keepA, idxB, keepB, in_frustum, tail = fused_track.unpack_fused(
            buf.numpy(), N, M, P
        )

        check(kern.launches == before + 3,
              f"fused frame {i}: {kern.launches - before} top-k launches, not 3 "
              "(stereo, motion-model search, local-map search)")
        frame = {"x": f32[0], "y": f32[1], "level": f32[2].astype(np.int32), "angle": f32[3],
                 "depth": f32[5], "valid": f32[6] > 0.5, "desc_packed": packed}
        R = parity.orthonormalize(tail[:9].reshape(3, 3).astype(np.float64))
        t = tail[9:12].astype(np.float64)
        n_twm, n_tlm = int(keepA.sum()), int(keepB.sum())
        pose_ok = bool(np.isfinite(tail).all())
        check(n_twm > 0 and n_tlm > 0 and pose_ok,
              f"fused frame {i}: TWM matches {n_twm}, TLM matches {n_tlm}, pose finite={pose_ok}")
        rows = parity.bind_fused_frame(N, last_rows, idxA, keepA, cand_rows.astype(np.int64),
                                       cand_ok, idxB, keepB, f32[8] > 0.5)
        # keypoints the final optimization was given: TWM inliers and TLM matches
        twm_kp = idxA[keepA]
        n_bound = len(np.union1d(twm_kp[f32[7][twm_kp] > 0.5], idxB[keepB]))
        n_inl = int(tail[13])
        b = rows >= 0
        rms = reprojection_rms(store["pos"][rows[b]].astype(np.float64), R, t,
                               frame["x"][b], frame["y"][b])
        check(n_inl >= 0.5 * n_bound and rms < 3.0,
              f"fused frame {i}: {n_inl} inliers of {n_bound} bindings, reprojection rms {rms:.2f} px")
        if i > N_WARMUP:
            times.append(dt)
        stats.append((n_twm, n_tlm, int(in_frustum.sum()), n_inl, rms))
        if i == len(frames) - 1:   # kept for the card-against-CPU phase
            kept = dict(kps=fd.kps, u_right=fd.u_right, T0=(R_pred, t_pred), q7=q7, q_rows=q_rows,
                        cand_rows=cand_rows, cand_ok=cand_ok, twm=twm, tlm=tlm,
                        store={k: v.copy() for k, v in store.items() if k != "n_rows"})

        # the motion model, and new map points at a keyframe
        R_rel = R @ R_last.T
        velocity = (R_rel, t - R_rel @ t_last)
        R_last, t_last, last, last_rows = R, t, frame, rows
        if i % KEYFRAME_EVERY == 0:
            store_dev = add_points(last, last_rows, R_last, t_last)
            uploads += 1

    launches = kern.launches
    check(launches == 3 * (len(frames) - 1), f"fused path launched the top-k kernel {launches} times")
    # The view walked STEP px per frame over a plane at depth_m. A plane seen
    # head-on leaves rotation and translation nearly interchangeable, so the
    # trajectory is held to where it puts the first frame's centre point.
    n = len(frames) - 1
    centre = R_last @ np.asarray([0.0, 0.0, depth_m]) + t_last
    u = INTRINSICS[0] * centre[0] / centre[2] + INTRINSICS[2]
    v = INTRINSICS[1] * centre[1] / centre[2] + INTRINSICS[3]
    want_u, want_v = INTRINSICS[2] - n * STEP[1], INTRINSICS[3] - n * STEP[0]
    drift = float(np.hypot(u - want_u, v - want_v))
    check(drift < 3.0, f"trajectory: the first centre point lands at ({u:.2f}, {v:.2f}) px after "
                       f"{n} frames, expected ({want_u:.2f}, {want_v:.2f})")
    s = np.asarray(stats, np.float64)
    print(
        f"phase 6 fused step: {len(times)} timed frames (+{N_WARMUP} warm-up) at {W}x{H}, "
        f"{CFG.n_levels} levels, {CFG.n_features} features, store {STORE_CAP} rows "
        f"({store['n_rows']} live, {uploads} uploads), {M} queries, {P} candidate slots: "
        f"median {np.median(times):.3f} ms/frame, p90 {np.percentile(times, 90):.3f} ms/frame "
        f"(per-frame sync: one packed fetch) on {card}; per frame median: "
        f"TWM matches {np.median(s[:, 0]):.0f}, TLM matches {np.median(s[:, 1]):.0f}, "
        f"in frustum {np.median(s[:, 2]):.0f}, inliers {np.median(s[:, 3]):.0f}, "
        f"reprojection rms {np.median(s[:, 4]):.3f} px; after {n} frames the first frame's centre "
        f"point is {drift:.3f} px from where the walk puts it; top-k kernel launches {launches} "
        f"(3 per frame), matrix kernel launches {hamming_kernel.hamming_penalty_matrix.launches}"
    )
    return launches, hamming_kernel.hamming_penalty_matrix.launches, kept


def phase_fused_card_vs_cpu(kept):
    """The last fused frame's two steps on the CPU, from the card's
    keypoints and the same blocks: matches equal, poses within 1e-3."""
    cpu = torch.device("cpu")
    kps = type(kept["kps"])(*(f.to(cpu) for f in kept["kps"]))
    st = kept["store"]
    store = convert.store_from_numpy(st["pos"], st["desc_signed"], st["normal"], st["min_dist"],
                                     st["max_dist"], device=cpu)
    qb = convert.query_block_from_numpy(kept["q7"], kept["q_rows"], kept["cand_rows"],
                                        kept["cand_ok"], device=cpu)
    cam = make_pinhole(*INTRINSICS, W, H, device=cpu)
    bf = torch.tensor(BF)
    u_right = kept["u_right"].to(cpu)
    twm = fused_track.twm_step(kps, u_right, CFG, bf, cam,
                               convert.se3_from_numpy(*kept["T0"], device=cpu),
                               qb.q7, qb.q_rows, store.pos, store.desc)
    tlm = fused_track.tlm_step(kps, u_right, CFG, bf, cam, twm, qb.cand_rows, qb.cand_ok, *store)
    report = {}
    for name, card, host in (("twm", kept["twm"], twm), ("tlm", kept["tlm"], tlm)):
        keep_equal = torch.equal(card.keep.to(cpu), host.keep)
        k = host.keep
        idx_equal = torch.equal(card.idx.to(cpu)[k], host.idx[k])
        dR = float((card.pose_R.to(cpu) - host.pose_R).abs().max())
        dt = float((card.pose_t.to(cpu) - host.pose_t).abs().max())
        report[name] = {"keep_equal": keep_equal, "idx_equal_where_kept": idx_equal,
                        "matches": int(k.sum()), "pose_R_maxdiff": dR, "pose_t_maxdiff": dt}
        check(keep_equal and idx_equal and dR < 1e-3 and dt < 1e-3,
              f"fused step card against CPU, {name}: {report[name]}")
    print(f"phase 7 fused step card against CPU: {json.dumps(report)}")


def tracker_step(tracker, frame, entry=None, imu=None, mono=False, depth=None) -> dict:
    """One frame of the rendered sequence through `track_stereo` of `entry`
    (a System; by default the tracker itself), with the IMU samples `imu`
    if given, or its left image through `track_monocular` if `mono`, or its
    left image and the depth map `depth` through `track_rgbd`, timed
    on the host's clock (the call ends after its last fetch), and what the
    checks read. A frame went stepwise if it recorded `orb_extraction` (the
    fused path records it only when it falls back). A frame with no pose
    yet (a monocular tracker before its initialization) has R and t None."""
    series = tracker.stats.series
    counts = {k: len(series[k]) for k in ("orb_extraction", "device_fetches", "store_uploads")}
    kern = hamming_kernel.hamming_penalty_topk
    launches, top2 = kern.launches, kern.launches_by_k[2]
    if tracker.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    if mono:
        entry.track_monocular(frame.left, frame.timestamp, imu=imu)
    elif depth is not None:
        entry.track_rgbd(frame.left, depth, frame.timestamp, imu=imu)
    elif imu is None:
        (entry or tracker).track_stereo(frame.left, frame.right, frame.timestamp)
    else:
        entry.track_stereo(frame.left, frame.right, frame.timestamp, imu=imu)
    ms = (time.perf_counter() - t0) * 1e3
    last, m = tracker.last_frame, tracker.atlas.current
    return {
        "ms": ms, "state": tracker.state.name,
        "path": "stepwise" if len(series["orb_extraction"]) > counts["orb_extraction"] else "fused",
        "fetches": len(series["device_fetches"]) - counts["device_fetches"],
        "uploads": len(series["store_uploads"]) - counts["store_uploads"],
        "launches": kern.launches - launches, "launches_k2": kern.launches_by_k[2] - top2,
        "keyframes": m.n_keyframes(), "mappoints": m.n_mappoints(),
        "bound": int((last.mp_ids >= 0).sum()), "inliers": tracker.n_inliers,
        "stereo": int((last.valid & (last.depth > 0)).sum()),
        "mp_ids": last.mp_ids.copy(),
        "R": None if last.R_cw is None else last.R_cw.copy(),
        "t": None if last.t_cw is None else last.t_cw.copy(),
    }


def frame_ms(rows):
    """(median, p90, count) of the rows' host ms, zeros for no rows."""
    v = [r["ms"] for r in rows]
    return (float(np.median(v)), float(np.percentile(v, 90)), len(v)) if v else (0.0, 0.0, 0)


def make_tracker(seq, device, kernel_config=None) -> Tracker:
    cam = make_pinhole(seq.fx, seq.fy, seq.cx, seq.cy, W, H, device=device)
    return Tracker(cam, CFG, seq.fx * seq.baseline, Atlas(), kernel_config=kernel_config,
                   device=device)


def trajectory_ate(trajectory, seq) -> dict:
    t_est = np.asarray([t for t, _, _ in trajectory])
    p_est = np.asarray([-R.T @ t_ for _, R, t_ in trajectory])
    return absolute_trajectory_error(t_est, p_est, seq.gt_t, seq.gt_pos)


def reset_launch_counts():
    kern = hamming_kernel.hamming_penalty_topk
    kern.launches = 0
    kern.launches_by_k.clear()
    kern.launches_by_rows.clear()
    kern.launches_by_shape.clear()
    hamming_kernel.hamming_penalty_matrix.launches = 0
    hamming_kernel.hamming_penalty_matrix.launches_by_shape.clear()
    return kern


def phase_tracker(device, seq, card):
    """The whole tracking thread on the card: Tracker.track_stereo over the
    first N_TRACKER_FRAMES frames of the rendered sequence, with no local
    mapper (the tracker makes the close stereo points of each keyframe
    itself)."""
    kern = reset_launch_counts()
    tracker = make_tracker(seq, device)
    log = [tracker_step(tracker, f) for f in seq.frames[:N_TRACKER_FRAMES]]

    first = log[0]
    check(first["state"] == "OK" and first["stereo"] > 300 and first["keyframes"] == 1,
          f"tracker frame 0 did not initialize: {first['state']}, {first['stereo']} stereo points "
          "(the gate is 100)")
    for i, r in enumerate(log[1:], 1):
        check(r["state"] == "OK", f"tracker frame {i}: state {r['state']}")
        check(np.isfinite(r["R"]).all() and np.isfinite(r["t"]).all(), f"tracker frame {i}: pose")
    series = tracker.stats.series
    check(log[1]["path"] == "stepwise" and len(series["trk"]) >= 1 and len(series["tlm"]) >= 1
          and log[1]["launches_k2"] == 1,
          f"tracker frame 1 did not go stepwise through the reference keyframe (K = 2) and the "
          f"local map: {log[1]['path']}, K=2 launches {log[1]['launches_k2']}")
    fused = [r for r in log[2:] if r["path"] == "fused"]
    for i, r in enumerate(log[2:], 2):
        if r["path"] != "fused":
            print(f"phase 8 tracker frame {i} went stepwise: the motion-model search of the fused "
                  f"frame found fewer than 10 inliers ({r['fetches']} fetches, "
                  f"{r['inliers']} inliers)")
        else:
            check(r["fetches"] == 1, f"tracker frame {i}: {r['fetches']} fetches on the fused path")
            check(r["launches"] == 3 and r["launches_k2"] == 0,
                  f"tracker frame {i}: {r['launches']} top-k launches on the fused path, not 3")
    check(len(fused) >= 30, f"only {len(fused)} of {len(log) - 2} frames took the fused path")
    n_kf = log[-1]["keyframes"]
    check(n_kf >= 2, f"{n_kf} keyframes after {len(log)} frames")
    # the device mirror follows the map: uploaded by the first fused frame
    # and by the first one after each keyframe, by no other frame
    pending, kf_before = True, 0
    for i, r in enumerate(log):
        want = int(pending and r["path"] == "fused")
        check(r["uploads"] == want,
              f"tracker frame {i} ({r['path']}): {r['uploads']} uploads of the point store, "
              f"not {want}")
        pending = (pending and not want) or r["keyframes"] != kf_before
        kf_before = r["keyframes"]
    uploads = len(series["store_uploads"])

    ate = trajectory_ate(tracker.trajectory, seq)
    check(ate["n"] == N_TRACKER_FRAMES and ate["rmse"] < ATE_LIMIT_M,
          f"tracker ATE RMSE {ate['rmse']:.4f} m over {ate['n']} frames, limit {ATE_LIMIT_M} m")

    times = [r["ms"] for r in fused[N_WARMUP:]]
    med = lambda key, rows=fused: float(np.median([r[key] for r in rows]))
    host = {k: float(np.median(series[k][N_WARMUP:]))
            for k in ("fused_host_pre", "fused_dispatch", "fused_host_post")}
    # the fused frames end the run, so their waits end the series
    sync = float(np.median(series["sync_ms"][-(len(fused) - N_WARMUP):]))
    print(
        f"phase 8 tracker: {len(log)} frames at {W}x{H}, {CFG.n_levels} levels, "
        f"{CFG.n_features} features through Tracker.track_stereo on {card}: frame 0 initialized "
        f"with {first['stereo']} stereo points ({first['mappoints']} map points); frame 1 stepwise "
        f"(reference keyframe K=2, local map) {log[1]['ms']:.1f} ms, {log[1]['fetches']} fetches; "
        f"{len(fused)} fused frames, 1 fetch and 3 top-k launches each: median "
        f"{np.median(times):.3f} ms/frame, p90 {np.percentile(times, 90):.3f} ms/frame over "
        f"{len(times)} (after {N_WARMUP} warm-up); of it on the host's clock, median: packing the "
        f"blocks {host['fused_host_pre']:.3f} ms, dispatch of the device chain "
        f"{host['fused_dispatch']:.3f} ms, wait in the fetch {sync:.3f} ms, bookkeeping after it "
        f"{host['fused_host_post']:.3f} ms; per fused frame median: bound {med('bound'):.0f}, "
        f"inliers {med('inliers'):.0f}; keyframes {n_kf}, map points {log[-1]['mappoints']}, "
        f"store uploads {uploads} (rows {tracker.atlas.current.store.n_rows} of "
        f"{tracker.atlas.current.store.cap}); ATE RMSE {ate['rmse']:.4f} m (limit {ATE_LIMIT_M}); "
        f"top-k kernel launches {kern.launches} ({dict(kern.launches_by_k)} by K), matrix kernel "
        f"launches {hamming_kernel.hamming_penalty_matrix.launches}"
    )
    return (kern.launches, hamming_kernel.hamming_penalty_matrix.launches, kern.launches_by_k[2],
            log, ate["rmse"])


def phase_tracker_card_vs_cpu(seq, card_log):
    """The first frames through Tracker(device="cpu"): the same state and
    path per frame, the same keyframes, bindings equal on >= 98% of the
    keypoints, poses within 1e-3."""
    tracker = make_tracker(seq, "cpu")
    report = []
    for i, frame in enumerate(seq.frames[:N_TRACKER_CPU_FRAMES]):
        cpu, card = tracker_step(tracker, frame), card_log[i]
        same = float((cpu["mp_ids"] == card["mp_ids"]).mean())
        dR = float(np.abs(cpu["R"] - card["R"]).max())
        dt = float(np.abs(cpu["t"] - card["t"]).max())
        report.append({"frame": i, "state": cpu["state"], "path": cpu["path"],
                       "keyframes": cpu["keyframes"], "mp_ids_equal": same,
                       "pose_R_maxdiff": dR, "pose_t_maxdiff": dt})
        check((cpu["state"], cpu["path"], cpu["keyframes"], cpu["mappoints"])
              == (card["state"], card["path"], card["keyframes"], card["mappoints"])
              and same >= 0.98 and dR < 1e-3 and dt < 1e-3,
              f"tracker card against CPU, frame {i}: {report[-1]} against card state "
              f"{card['state']}, path {card['path']}, keyframes {card['keyframes']}")
    print(f"phase 9 tracker card against CPU: {json.dumps(report)}")


def make_system(seq, device, async_mapping=False, vocabulary=False) -> System:
    """The stereo system at full width, built directly (no YAML); phases
    10-12 run it without place recognition, phases 17 and 18b with the
    shipped vocabulary (vocabulary=None, the default)."""
    settings = Settings(
        camera1=make_pinhole(seq.fx, seq.fy, seq.cx, seq.cy, W, H, device=device),
        bf=seq.fx * seq.baseline, baseline=seq.baseline, width=W, height=H,
        n_features=CFG.n_features, n_levels=CFG.n_levels, scale_factor=CFG.scale_factor,
    )
    return System(settings, Sensor.STEREO, async_mapping=async_mapping, vocabulary=vocabulary,
                  device=device)


MAPPER_COUNTS = ("lm_triangulation_passes", "lm_fuse_searches", "lm_local_bas",
                 "lm_points_culled", "lm_points_triangulated", "lm_points_fused",
                 "lm_keyframes_culled", "lm_device_fetches", "lm_inertial_bas",
                 "lm_imu_inits", "lm_full_inertial_bas")


def watch_mapper(system, keyframes):
    """Wraps the inline mapper's process_keyframe: per keyframe, what it
    launched (both kernels' counts before and after) and what its own
    counters say it did, appended to `keyframes`."""
    mapper = system.local_mapper
    series = system.stats.series
    kern, matrix = hamming_kernel.hamming_penalty_topk, hamming_kernel.hamming_penalty_matrix
    inner = mapper.process_keyframe

    def process_keyframe(kf):
        before = {k: sum(series[k]) for k in MAPPER_COUNTS}
        topk, rows, mat = kern.launches, kern.launches_by_rows[EPI_ROWS], matrix.launches
        inner(kf)
        row = {k: int(sum(series[k]) - before[k]) for k in MAPPER_COUNTS}
        row.update(kid=kf.kid, frame_id=kf.frame_id, topk=kern.launches - topk,
                   topk_epi_rows=kern.launches_by_rows[EPI_ROWS] - rows,
                   matrix=matrix.launches - mat)
        keyframes.append(row)

    mapper.process_keyframe = process_keyframe


def watch_bundle_adjustment(adjustments):
    """Wraps the solver the mapper calls: per adjustment, the summed chi2 of
    its final inliers at the poses and points it was given and at those it
    returns (one fetch more per adjustment, inside its timed step)."""
    inner = local_mapping.local_bundle_adjustment

    def solve(prob, cam, bf, **kw):
        res = inner(prob, cam, bf, **kw)

        def cost(poses, points):
            r, _ = ba_core.residuals(poses, points, cam, bf, prob.obs_uv, prob.obs_ur)
            chi2 = torch.sum(r * r, dim=-1) * prob.inv_sigma2
            return torch.where(res.inlier_mask, chi2, 0.0).sum()

        finite = torch.isfinite(res.poses.R).all() & torch.isfinite(res.poses.t).all()
        before, after, ok, n_inl, n_obs = (x.item() for x in (
            cost(prob.poses, prob.points), cost(res.poses, res.points), finite,
            res.inlier_mask.sum(), prob.mask.sum()))
        adjustments.append({"chi2_before": before, "chi2_after": after, "finite": bool(ok),
                            "inliers": int(n_inl), "observations": int(n_obs),
                            "cameras": int(prob.mask.any(dim=0).sum()),
                            "points": int(prob.point_free.sum())})
        return res

    local_mapping.local_bundle_adjustment = solve
    return inner


def phase_system(device, seq, card, tracker_ate):
    """The system a user calls, inline mapping, on the card: every frame of
    the rendered sequence through System.track_stereo."""
    kern = reset_launch_counts()
    matrix = hamming_kernel.hamming_penalty_matrix
    system = make_system(seq, device)
    keyframes, adjustments = [], []
    watch_mapper(system, keyframes)
    solver = watch_bundle_adjustment(adjustments)
    try:
        log = []
        for f in seq.frames:
            n_kf = len(keyframes)
            r = tracker_step(system.tracker, f, entry=system)
            r["mapped"] = keyframes[n_kf:]      # the keyframes this frame handed to the mapper
            log.append(r)
    finally:
        local_mapping.local_bundle_adjustment = solver
    system.shutdown()

    series = system.stats.series
    for i, r in enumerate(log):
        check(r["state"] == "OK", f"system frame {i}: state {r['state']}")
        check(np.isfinite(r["R"]).all() and np.isfinite(r["t"]).all(), f"system frame {i}: pose")
        check(len(r["mapped"]) <= 1, f"system frame {i}: {len(r['mapped'])} keyframes")
        if r["path"] == "fused":
            mapper_topk = sum(k["topk"] for k in r["mapped"])
            check(r["fetches"] == 1, f"system frame {i}: {r['fetches']} tracker fetches, fused path")
            check(r["launches"] - mapper_topk == 3 and r["launches_k2"] == 0,
                  f"system frame {i}: {r['launches'] - mapper_topk} top-k launches of the tracker "
                  "on the fused path, not 3")
    fused = [r for r in log[2:] if r["path"] == "fused"]
    check(len(fused) >= len(log) - 6, f"only {len(fused)} of {len(log) - 2} frames fused")

    # per keyframe: the launches agree with what the mapper says it did
    for k in keyframes:
        check(k["topk"] == k["topk_epi_rows"] == k["lm_triangulation_passes"]
              and k["topk"] in (0, 1, 2),
              f"keyframe {k['kid']}: {k['topk']} top-k launches ({k['topk_epi_rows']} of "
              f"{EPI_ROWS} rows) for {k['lm_triangulation_passes']} triangulation passes")
        check(k["matrix"] == k["lm_fuse_searches"],
              f"keyframe {k['kid']}: {k['matrix']} matrix launches for "
              f"{k['lm_fuse_searches']} fusion searches")
        check(k["lm_device_fetches"] == k["lm_triangulation_passes"] + k["lm_fuse_searches"]
              + k["lm_local_bas"] + k["lm_inertial_bas"],
              f"keyframe {k['kid']}: {k['lm_device_fetches']} mapper fetches")
    n_kf, n_ba = len(keyframes), len(adjustments)
    check(n_kf >= 5 and n_ba >= 3, f"{n_kf} keyframes and {n_ba} bundle adjustments")
    check(n_ba == sum(k["lm_local_bas"] for k in keyframes), "adjustments seen and counted differ")
    total = {k: sum(row[k] for row in keyframes) for k in MAPPER_COUNTS}
    check(total["lm_points_triangulated"] > 0, "triangulation created no point")
    check(total["lm_points_fused"] > 0, "fusion fused no point")
    check(matrix.launches == total["lm_fuse_searches"] > 0, "the matrix kernel was not launched")
    check(kern.launches_by_rows[EPI_ROWS] == total["lm_triangulation_passes"] > 0,
          f"no {EPI_ROWS}-row top-k launch")
    for j, a in enumerate(adjustments):
        check(a["finite"] and a["chi2_after"] <= a["chi2_before"],
              f"bundle adjustment {j}: chi2 of its inliers {a['chi2_before']:.1f} -> "
              f"{a['chi2_after']:.1f}, poses finite={a['finite']}")
    # the device mirror: uploaded by the first fused frame after a map change
    # (a keyframe, with what the mapper did to the map), by no other frame
    pending = True
    for i, r in enumerate(log):
        want = int(pending and r["path"] == "fused")
        check(r["uploads"] == want,
              f"system frame {i} ({r['path']}): {r['uploads']} uploads of the point store, not {want}")
        pending = (pending and not want) or bool(r["mapped"])
    uploads = len(series["store_uploads"])
    check(uploads <= 1 + n_kf, f"{uploads} uploads of the store for {n_kf} keyframes")

    ate = trajectory_ate(system.tracker.trajectory, seq)
    ate_first = trajectory_ate(system.tracker.trajectory[:N_TRACKER_FRAMES], seq)
    check(ate["n"] == len(seq.frames) and ate["rmse"] <= ATE_LIMIT_M,
          f"system ATE RMSE {ate['rmse']:.4f} m over {ate['n']} frames, limit {ATE_LIMIT_M} m")

    plain = [r["ms"] for r in fused[N_WARMUP:] if not r["mapped"]]
    with_kf = [r["ms"] for r in log[1:] if r["mapped"]]
    step = {k: (float(np.median(series[k])), float(np.max(series[k]))) for k in (
        "lm_total", "lm_track_new_points", "lm_cull_points", "lm_triangulate", "lm_fuse",
        "lm_local_ba", "lm_cull_keyframes")}
    m = system.atlas.current
    print(
        f"phase 10 system, inline mapping: {len(log)} frames at {W}x{H}, {CFG.n_levels} levels, "
        f"{CFG.n_features} features through System.track_stereo on {card}: every frame OK, "
        f"{len(fused)} fused frames (1 tracker fetch and 3 tracker top-k launches each); frames "
        f"without a keyframe: median {np.median(plain):.3f} ms/frame, p90 "
        f"{np.percentile(plain, 90):.3f} over {len(plain)}; frames with a keyframe (mapping inline): "
        f"median {np.median(with_kf):.3f} ms/frame, p90 {np.percentile(with_kf, 90):.3f} over "
        f"{len(with_kf)}; per keyframe, median (max) ms: "
        + ", ".join(f"{k[3:]} {v[0]:.2f} ({v[1]:.2f})" for k, v in step.items())
        + f"; keyframes processed {n_kf} (culled {total['lm_keyframes_culled']}), in the map "
        f"{m.n_keyframes()}; map points {m.n_mappoints()}, culled {total['lm_points_culled']}, "
        f"triangulated {total['lm_points_triangulated']}, fused {total['lm_points_fused']}; "
        f"triangulation passes {total['lm_triangulation_passes']} (one {EPI_ROWS}-row top-k launch "
        f"each), fusion searches {total['lm_fuse_searches']} (one matrix launch each), bundle "
        f"adjustments {n_ba}, mapper fetches {total['lm_device_fetches']}; store uploads {uploads}; "
        f"ATE RMSE {ate['rmse']:.4f} m over {ate['n']} frames (limit {ATE_LIMIT_M}); over the first "
        f"{N_TRACKER_FRAMES} frames {ate_first['rmse']:.4f} m against phase 8's tracking-only "
        f"{tracker_ate:.4f} m; top-k kernel launches {kern.launches} "
        f"({dict(kern.launches_by_rows)} by rows), matrix kernel launches {matrix.launches}"
    )
    print("phase 10 bundle adjustments: " + json.dumps(adjustments))
    print("phase 10 keyframes: " + json.dumps(keyframes))
    return kern.launches, matrix.launches, kern.launches_by_rows[EPI_ROWS], log


def system_cpu_run(seq):
    """Phase 11's CPU side, in the renderer's process (off the card phases'
    path): the frames of `seq` through System(device="cpu") on
    SYSTEM_CPU_THREADS threads; each frame's tracker_step row, the bundle
    adjustments run and the keyframes made."""
    torch.set_num_threads(SYSTEM_CPU_THREADS)
    system = make_system(seq, "cpu")
    keep = ("state", "path", "keyframes", "mappoints", "R", "t")
    rows = [{k: r[k] for k in keep}
            for r in (tracker_step(system.tracker, f, entry=system) for f in seq.frames)]
    system.shutdown()
    return rows, int(sum(system.stats.series["lm_local_bas"])), system.atlas.current.n_keyframes()


def start_system_card_vs_cpu(pool, seq, card_log):
    """Phase 11's CPU run, started in `pool` on the first frames of phase
    10, as far as the frame after the third keyframe (one bundle
    adjustment); returns (future, n, the third keyframe's frame)."""
    made = np.cumsum([len(r["mapped"]) for r in card_log])
    check(made[-1] >= 3 and int(np.argmax(made >= 3)) + 2 <= MAX_SYSTEM_CPU_FRAMES,
          f"the card's keyframes by frame: {made.tolist()}")
    third = int(np.argmax(made >= 3))
    n = third + 2
    return pool.submit(system_cpu_run, seq._replace(frames=seq.frames[:n])), n, third


def phase_system_card_vs_cpu(card_log, cpu_run):
    """Phase 11: the CPU run of start_system_card_vs_cpu against phase 10's
    frames on the card: the same state, path and keyframe frames, map-point
    count within 2%, poses within 1e-3 (the adjustment sums in another order
    on the card)."""
    future, n, third = cpu_run
    rows, bundle_adjustments, keyframes = future.result()
    worst = {"frames": n, "third_keyframe_at": third, "pose_R_maxdiff": 0.0, "pose_t_maxdiff": 0.0,
             "mappoints_maxdiff": 0}
    for i, cpu in enumerate(rows):
        card = card_log[i]
        dR = float(np.abs(cpu["R"] - card["R"]).max())
        dt = float(np.abs(cpu["t"] - card["t"]).max())
        dmp = abs(cpu["mappoints"] - card["mappoints"])
        check((cpu["state"], cpu["path"], cpu["keyframes"]) == (card["state"], card["path"],
                                                                card["keyframes"])
              and dmp <= 0.02 * card["mappoints"] and dR < 1e-3 and dt < 1e-3,
              f"system card against CPU, frame {i}: CPU {cpu['state']}, {cpu['path']}, "
              f"{cpu['keyframes']} keyframes, {cpu['mappoints']} map points; card {card['state']}, "
              f"{card['path']}, {card['keyframes']}, {card['mappoints']}; pose diff {dR:.2e}, {dt:.2e}")
        worst["pose_R_maxdiff"] = max(worst["pose_R_maxdiff"], dR)
        worst["pose_t_maxdiff"] = max(worst["pose_t_maxdiff"], dt)
        worst["mappoints_maxdiff"] = max(worst["mappoints_maxdiff"], dmp)
    worst["bundle_adjustments"], worst["keyframes"] = bundle_adjustments, keyframes
    check(worst["bundle_adjustments"] >= 1 and worst["keyframes"] >= 3, f"phase 11 ran {worst}")
    print(f"phase 11 system card against CPU over {n} frames: {json.dumps(worst)}")


def phase_system_async(device, seq, card):
    """Mapping on its own thread: the tracker's thread and the mapper's both
    launch work on the card and share the map under its lock."""
    system = make_system(seq, device, async_mapping=True)
    inserted, inner = [], system.local_mapper.insert_keyframe

    def insert_keyframe(kf):
        inserted.append(kf.kid)
        inner(kf)

    system.local_mapper.insert_keyframe = insert_keyframe
    times, depth = [], 0
    for i, f in enumerate(seq.frames[:N_ASYNC_FRAMES]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        system.track_stereo(f.left, f.right, f.timestamp)
        times.append((time.perf_counter() - t0) * 1e3)
        depth = max(depth, system.local_mapper.queue_size())
        check(system.tracking_state.name == "OK", f"async frame {i}: state {system.tracking_state.name}")
    t0 = time.perf_counter()
    while not system.local_mapper.is_idle():
        check(time.perf_counter() - t0 < 120, "the mapper's queue did not drain in 120 s")
        time.sleep(0.005)
    drain = time.perf_counter() - t0
    system.shutdown()
    mapper = system.local_mapper
    check(mapper.is_idle() and mapper.queue_size() == 0 and not mapper._thread.is_alive(),
          "the mapper is not idle after shutdown")
    processed = int(sum(system.stats.series["lm_keyframes"]))
    check(processed == len(inserted) >= 2, f"{processed} keyframes processed, {len(inserted)} inserted")
    ate = trajectory_ate(system.tracker.trajectory, seq)
    check(ate["n"] == N_ASYNC_FRAMES and ate["rmse"] <= ATE_LIMIT_M,
          f"async ATE RMSE {ate['rmse']:.4f} m over {ate['n']} frames, limit {ATE_LIMIT_M} m")
    print(
        f"phase 12 system, async mapping: {N_ASYNC_FRAMES} frames on {card}: every frame OK, "
        f"median {np.median(times[2 + N_WARMUP:]):.3f} ms/frame, p90 "
        f"{np.percentile(times[2 + N_WARMUP:], 90):.3f}; keyframes inserted {len(inserted)}, "
        f"processed {processed}, deepest queue {depth}, drained {drain * 1e3:.1f} ms after the last "
        f"frame, mapper idle and stopped; bundle adjustments "
        f"{int(sum(system.stats.series['lm_local_bas']))}; ATE RMSE {ate['rmse']:.4f} m "
        f"(limit {ATE_LIMIT_M})"
    )


def make_inertial_system(seq, device, kernel_config=None, vocabulary=False,
                         async_mapping=False, save_atlas=None, load_atlas=None) -> System:
    """The stereo-inertial system at full width, built directly (no YAML):
    the renderer's body frame is the left camera's (T_b_c1 = I) and its IMU
    stream is exact at 200 Hz; the noise densities are the settings'
    defaults (EuRoC's). Phases 13 and 21b run its default configuration,
    the shipped vocabulary (vocabulary=None); phase 16 runs without place
    recognition, the input its bound was set on. Phase 21b saves its atlas
    on shutdown (Settings.save_atlas), 27b loads it (Settings.load_atlas)."""
    settings = Settings(
        camera1=make_pinhole(seq.fx, seq.fy, seq.cx, seq.cy, W, H, device=device),
        bf=seq.fx * seq.baseline, baseline=seq.baseline, width=W, height=H,
        n_features=CFG.n_features, n_levels=CFG.n_levels, scale_factor=CFG.scale_factor,
        T_b_c1=np.eye(4), imu_frequency=200.0, save_atlas=save_atlas, load_atlas=load_atlas,
    )
    return System(settings, Sensor.IMU_STEREO, kernel_config=kernel_config,
                  async_mapping=async_mapping, vocabulary=vocabulary, device=device)


def imu_between(seq, t0, t1):
    """The IMU samples in (t0, t1] as (t, acc, gyro), what track_stereo takes."""
    sel = np.where((seq.imu_t > t0) & (seq.imu_t <= t1))[0]
    return [(float(seq.imu_t[i]), seq.imu_acc[i], seq.imu_gyro[i]) for i in sel]


def record_inertial_programs(keep_flipped=False):
    """Wraps the tracker's tlm_step_vi and the mapper's local_inertial_ba:
    the first N_REPLAY_FRAMES calls of the one and the first call of the
    other are kept with their inputs and outputs for phases 14 and 25b;
    with `keep_flipped`, also the first later window that rejected a
    flipped step (its count fetched once more until one is found). Returns
    the record and a function that puts both back."""
    rec = {"tlm_step_vi": [], "local_inertial_ba": [], "flipped": []}
    inner_tlm, inner_ba = tracking.tlm_step_vi, local_mapping.local_inertial_ba

    def tlm_step_vi(*args):
        out = inner_tlm(*args)
        if len(rec["tlm_step_vi"]) < N_REPLAY_FRAMES:
            rec["tlm_step_vi"].append((args, out))
        return out

    def local_ba(*args, **kw):
        out = inner_ba(*args, **kw)
        if not rec["local_inertial_ba"]:
            rec["local_inertial_ba"].append((args, out, kw))
        elif keep_flipped and not rec["flipped"] and int(out.n_flipped):
            rec["flipped"].append((args, out, kw))
        return out

    tracking.tlm_step_vi, local_mapping.local_inertial_ba = tlm_step_vi, local_ba

    def restore():
        tracking.tlm_step_vi, local_mapping.local_inertial_ba = inner_tlm, inner_ba

    return rec, restore


def phase_system_inertial(device, seq, card):
    """The stereo-inertial system a user calls in its default configuration
    (the shipped vocabulary, so the loop closer takes every keyframe),
    inline mapping, on the card: every frame of a rendered sequence with its
    IMU samples through System.track_stereo."""
    kern = reset_launch_counts()
    matrix = hamming_kernel.hamming_penalty_matrix
    system = make_inertial_system(seq, device, vocabulary=None)
    keyframes, lc_rows = [], []
    watch_mapper(system, keyframes)
    watch_loop_closer(system.loop_closer, lc_rows)
    rec, restore = record_inertial_programs()
    try:
        log, t_prev = [], -1.0
        for f in seq.frames:
            n_kf = len(keyframes)
            r = tracker_step(system.tracker, f, entry=system,
                             imu=imu_between(seq, t_prev, f.timestamp))
            r["mapped"] = keyframes[n_kf:]
            r["imu_initialized"] = bool(system.atlas.current.imu_initialized)
            log.append(r)
            t_prev = f.timestamp
    finally:
        restore()
    system.shutdown()

    series = system.stats.series
    for i, r in enumerate(log):
        check(r["state"] == "OK", f"inertial frame {i}: state {r['state']}")
        check(np.isfinite(r["R"]).all() and np.isfinite(r["t"]).all(), f"inertial frame {i}: pose")
        check(len(r["mapped"]) <= 1, f"inertial frame {i}: {len(r['mapped'])} keyframes")
        if r["path"] == "fused":
            mapper_topk = sum(k["topk"] for k in r["mapped"])
            check(r["imu_initialized"], f"inertial frame {i} fused before IMU init")
            check(r["fetches"] == 1, f"inertial frame {i}: {r['fetches']} tracker fetches, fused path")
            check(r["launches"] - mapper_topk == 3 and r["launches_k2"] == 0,
                  f"inertial frame {i}: {r['launches'] - mapper_topk} top-k launches of the tracker "
                  "on the fused path, not 3")
    check(any(r["imu_initialized"] for r in log), "the IMU never initialized")
    init_frame = next(i for i, r in enumerate(log) if r["imu_initialized"])
    init_kf = next(k for r in log[init_frame:init_frame + 1] for k in r["mapped"])
    bg = system.tracker.bias[0]
    check(np.linalg.norm(bg) < 0.05, f"gyro bias {bg} (the stream has none)")
    fused = [r for r in log if r["path"] == "fused"]
    stepwise = [r for r in log if r["path"] == "stepwise"]
    check(len(fused) >= 20, f"{len(fused)} fused inertial frames")
    # the loop closer runs inside the mapper's keyframe (inline): its own
    # launches are told apart by its wrapper
    lc_by_kid = {r["kid"]: r for r in lc_rows}
    check(len(lc_rows) == int(sum(series["lm_keyframes"])) > 0,
          f"the loop closer saw {len(lc_rows)} keyframes")
    for k in keyframes:
        lc = lc_by_kid.get(k["kid"], {"k1": 0, "k2": 0, "matrix": 0})
        check(k["topk"] - lc["k1"] - lc["k2"] == k["topk_epi_rows"] == k["lm_triangulation_passes"]
              and k["matrix"] - lc["matrix"] == k["lm_fuse_searches"]
              and k["lm_device_fetches"] == k["lm_triangulation_passes"] + k["lm_fuse_searches"]
              + k["lm_local_bas"] + k["lm_inertial_bas"],
              f"inertial keyframe {k['kid']}: launches and fetches disagree with the mapper: {k}")
    lc_k = {key: sum(r[key] for r in lc_rows) for key in ("k1", "k2", "matrix")}
    total = {k: sum(row[k] for row in keyframes) for k in MAPPER_COUNTS}
    check(total["lm_imu_inits"] == 1 and total["lm_inertial_bas"] >= 2
          and total["lm_full_inertial_bas"] >= 1,
          f"{total['lm_imu_inits']} IMU inits, {total['lm_inertial_bas']} inertial windows, "
          f"{total['lm_full_inertial_bas']} full inertial BAs")
    check(matrix.launches == total["lm_fuse_searches"] + lc_k["matrix"] > 0,
          "the matrix kernel was not launched")
    check(kern.launches_by_rows[EPI_ROWS] == total["lm_triangulation_passes"] > 0,
          f"no {EPI_ROWS}-row top-k launch")
    lc = system.loop_closer
    check(lc.n_thread_errors == 0, f"{lc.n_thread_errors} thread errors")
    pending = True
    for i, r in enumerate(log):
        want = int(pending and r["path"] == "fused")
        check(r["uploads"] == want,
              f"inertial frame {i} ({r['path']}): {r['uploads']} uploads of the store, not {want}")
        pending = (pending and not want) or bool(r["mapped"])
    uploads = len(series["store_uploads"])
    ate = trajectory_ate(system.tracker.trajectory, seq)
    check(ate["n"] == len(seq.frames) and ate["rmse"] <= ATE_LIMIT_M,
          f"inertial ATE RMSE {ate['rmse']:.4f} m over {ate['n']} frames, limit {ATE_LIMIT_M} m")

    after = log[init_frame + 1:]
    times = {
        "fused inertial frames without a keyframe":
            frame_ms([r for r in fused[N_WARMUP:] if not r["mapped"]]),
        "stepwise frames without a keyframe, after IMU init":
            frame_ms([r for r in after if r["path"] == "stepwise" and not r["mapped"]]),
        "stepwise frames before IMU init, no keyframe":
            frame_ms([r for r in log[1:init_frame] if not r["mapped"]]),
        "frames with a keyframe": frame_ms([r for r in log[1:] if r["mapped"]]),
    }
    windows = series["lm_inertial_window"]
    fetches = sum(r["fetches"] for r in log)
    m = system.atlas.current
    print(
        f"phase 13 stereo-inertial system, inline mapping: {len(log)} frames at {W}x{H} "
        f"({seq.frames[-1].timestamp:.2f} s, IMU at 200 Hz), {CFG.n_levels} levels, "
        f"{CFG.n_features} features through System.track_stereo(..., imu=...) on {card}: every "
        f"frame OK; IMU initialized at frame {init_frame} (keyframe {init_kf['kid']}, "
        f"{sum(len(r['mapped']) for r in log[:init_frame + 1])} keyframes made by then), gyro bias "
        f"|bg| {np.linalg.norm(bg):.5f} rad/s; {len(fused)} fused inertial frames (1 fetch and 3 "
        f"tracker top-k launches each; {int(sum(series['fused_vi_frames'])) - len(fused)} more "
        "fell back to the stepwise path after their fetch), "
        f"{len(stepwise)} stepwise ({len(stepwise) / len(log):.3f} of all frames; after init "
        f"{sum(r['path'] == 'stepwise' for r in after) / max(len(after), 1):.3f}); fetches per frame "
        f"{fetches / len(log):.3f} (after init {sum(r['fetches'] for r in after) / max(len(after), 1):.3f}); "
        f"VI pose optimizations on stepwise frames: {int(sum(series['vi_pose_anchor']))} anchored on "
        f"the keyframe, {int(sum(series['vi_pose_lastframe']))} on the last frame; ms/frame median, "
        f"p90 (count): " + "; ".join(f"{k} {v[0]:.3f}, {v[1]:.3f} ({v[2]})" for k, v in times.items())
        + f"; inertial windows {len(windows)} (one per keyframe after init, one at init, and "
        f"those of the {total['lm_full_inertial_bas']} full-BA stage(s) reached), ms each on the "
        f"host's clock median {np.median(windows):.3f}, max {np.max(windows):.3f}; keyframes processed "
        f"{len(keyframes)} (culled {total['lm_keyframes_culled']}), in the map {m.n_keyframes()}, "
        f"visual local BAs {total['lm_local_bas']}, map points {m.n_mappoints()}; store uploads "
        f"{uploads}; ATE RMSE {ate['rmse']:.4f} m over {ate['n']} frames (limit {ATE_LIMIT_M}); "
        f"top-k kernel launches {kern.launches} ({dict(kern.launches_by_rows)} by rows), matrix "
        f"kernel launches {matrix.launches}; the loop closer (the shipped vocabulary, quantized "
        f"on the host): {len(lc_rows)} keyframes, ms per keyframe median "
        f"{np.median([r['ms'] for r in lc_rows]):.1f}, max {np.max([r['ms'] for r in lc_rows]):.1f}, "
        f"loops closed {lc.n_loops_closed}, maps merged {lc.n_maps_merged}, global BAs "
        f"{lc.n_gba_runs}, its launches {lc_k} (top-k K = 1 and K = 2, matrix)"
    )
    print("phase 13 keyframes: " + json.dumps(keyframes))
    check(len(rec["tlm_step_vi"]) == N_REPLAY_FRAMES and rec["local_inertial_ba"],
          "phase 13 recorded too few inertial calls to replay")
    return kern.launches, matrix.launches, rec, system, lc_k


def to_device(x, device):
    """Tensors inside (nested) NamedTuples and tuples, and a Camera's
    parameters, moved to `device`; anything else as it is."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if dataclasses.is_dataclass(x) and hasattr(x, "params"):
        return dataclasses.replace(x, params=x.params.to(device))
    if isinstance(x, tuple):
        items = [to_device(v, device) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def with_float(x, dtype):
    """The floating tensors inside (nested) NamedTuples and tuples as `dtype`."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype) if x.is_floating_point() else x
    if isinstance(x, tuple):
        items = [with_float(v, dtype) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def state_diffs(a, b) -> dict:
    cpu = torch.device("cpu")
    return {f: float((getattr(a, f).to(cpu).double() - getattr(b, f).to(cpu).double()).abs().max())
            for f in ("R_wb", "p_w", "v_w", "bg", "ba")}


def state_close(d) -> bool:
    return max(d["R_wb"], d["p_w"], d["v_w"]) < 1e-3 and max(d["bg"], d["ba"]) < 1e-4


def phase_inertial_card_vs_cpu(rec):
    """Phase 13's recorded inertial programs again on the CPU, from the
    same inputs."""
    cpu = torch.device("cpu")
    frames = []
    for i, (args, card) in enumerate(rec["tlm_step_vi"]):
        host = fused_track.tlm_step_vi(*to_device(args, cpu))
        same = {f: torch.equal(getattr(card, f).to(cpu), getattr(host, f))
                for f in ("keep", "in_frustum", "inliers")}
        k = host.keep
        same["idx_where_kept"] = torch.equal(card.idx.to(cpu)[k], host.idx[k])
        d = state_diffs(card, host)
        H_rel = float((card.H.to(cpu) - host.H).abs().max() / host.H.abs().max())
        row = {"frame": i, **same, "matches": int(k.sum()), "n_inliers": int(host.n_inliers),
               **{f"{f}_maxdiff": v for f, v in d.items()}, "H_rel_maxdiff": H_rel}
        frames.append(row)
        check(all(same.values()) and state_close(d) and H_rel < 1e-2,
              f"tlm_step_vi card against CPU, recorded frame {i}: {row}")
    (args, card, kw), = rec["local_inertial_ba"]
    prob = args[0]
    dtype = prob.points.dtype
    windows = {}
    other = torch.float32 if dtype == torch.float64 else torch.float64
    for name, card_res, a in (
        (str(dtype).split(".")[-1], card, args),
        (str(other).split(".")[-1], None, (with_float(prob, other),) + tuple(args[1:])),
    ):
        if card_res is None:
            card_res = local_inertial_ba(*a, **kw)
        host = local_inertial_ba(*to_device(a, cpu), **kw)
        d = state_diffs(card_res.states, host.states)
        free = prob.point_free.to(cpu)
        windows[name] = {
            **{f"{f}_maxdiff": v for f, v in d.items()},
            "points_maxdiff": float((card_res.points.to(cpu).double()
                                     - host.points.double()).abs()[free].max()),
            "inlier_mask_differences": int((card_res.inlier_mask.to(cpu) != host.inlier_mask).sum()),
            "observations": int(prob.mask.sum()), "free_states": int(prob.state_free.sum()),
            "free_points": int(free.sum()),
        }
        windows[name]["holds"] = state_close(d)
    solved = str(dtype).split(".")[-1]
    check(windows[solved]["holds"],
          f"local_inertial_ba card against CPU in {solved}, the mapper's type: {windows}")
    print(f"phase 14 inertial programs card against CPU: tlm_step_vi {json.dumps(frames)}; "
          f"first local inertial BA window (mapper solves in {solved}; the other type replayed "
          f"for comparison): {json.dumps(windows)}")


TRACKER_STAGES = (
    ("stereo", frame_pipeline, "_stereo_match_stage"),   # the device stereo matcher
    ("twm", tracking, "twm_match_packed"),               # stepwise motion-model matcher
    ("tlm", tracking, "tlm_match_packed"),               # stepwise local-map matcher
    ("trk", tracking, "match_fisheye"),                  # reference-keyframe matcher
    ("fused", tracking, "twm_step"),                     # the fused frame's two steps
    ("fused", tracking, "tlm_step"),
    ("fused", tracking, "tlm_step_vi"),
)


def watch_tracker_stages(stages=TRACKER_STAGES):
    """Wraps the tracker's device stages that launch a Hamming kernel:
    counts[stage] = [top-k launches, matrix launches, calls], summed over
    the calls made while the wrappers are in. Returns (counts, restore)."""
    kern, matrix = hamming_kernel.hamming_penalty_topk, hamming_kernel.hamming_penalty_matrix
    counts = {name: [0, 0, 0] for name, _, _ in stages}
    inner = [(module, attr, getattr(module, attr)) for _, module, attr in stages]

    def wrap(name, fn):
        def stage(*args, **kwargs):
            topk, mat = kern.launches, matrix.launches
            out = fn(*args, **kwargs)
            c = counts[name]
            c[0] += kern.launches - topk
            c[1] += matrix.launches - mat
            c[2] += 1
            return out
        return stage

    for (name, module, attr), (_, _, fn) in zip(stages, inner):
        setattr(module, attr, wrap(name, fn))

    def restore():
        for module, attr, fn in inner:
            setattr(module, attr, fn)

    return counts, restore


def stage_snapshot(counts) -> dict:
    return {name: list(c) for name, c in counts.items()}


def stage_delta(after, before) -> dict:
    return {name: [a - b for a, b in zip(after[name], before[name])] for name in after}


def mask_name(mask, po) -> str:
    return f"{mask} PO {'on' if po else 'off'}"


def phase_toggle_matrix(device, seq, card):
    """BASELINE.md's toggle matrix on the visual Tracker: one tracker per
    configuration, all fed frame by frame in turns, so that the host's
    drift within the call falls on every configuration alike."""
    reset_launch_counts()
    counts, restore = watch_tracker_stages()
    trackers = [make_tracker(seq, device, KernelConfig.from_bitmask(m, pose_optimization=po))
                for m, po in TOGGLE_CONFIGS]
    logs = [[] for _ in TOGGLE_CONFIGS]
    n_frames = [N_TOGGLE_FRAMES if m[0] == "1" else N_TOGGLE_HOST_FRAMES
                for m, _ in TOGGLE_CONFIGS]
    try:
        for i, f in enumerate(seq.frames[:N_TOGGLE_FRAMES]):
            for tr, log, n in zip(trackers, logs, n_frames):
                if i >= n:
                    continue
                before = stage_snapshot(counts)
                r = tracker_step(tr, f)
                r["stages"] = stage_delta(stage_snapshot(counts), before)
                log.append(r)
    finally:
        restore()
    kern, matrix = hamming_kernel.hamming_penalty_topk, hamming_kernel.hamming_penalty_matrix
    check(sum(r["launches"] for log in logs for r in log) == kern.launches
          and matrix.launches == 0,
          f"phase 15: {kern.launches} top-k and {matrix.launches} matrix launches in all, "
          f"{sum(r['launches'] for log in logs for r in log)} seen by the trackers' frames")
    rows = []
    for (mask, po), tr, log in zip(TOGGLE_CONFIGS, trackers, logs):
        name = mask_name(mask, po)
        for i, r in enumerate(log):
            check(r["state"] == "OK", f"phase 15 {name} frame {i}: state {r['state']}")
            check(np.isfinite(r["R"]).all() and np.isfinite(r["t"]).all(),
                  f"phase 15 {name} frame {i}: pose")
        stages = {k: [sum(r["stages"][k][j] for r in log) for j in range(3)]
                  for k in log[0]["stages"]}
        topk = {k: v[0] for k, v in stages.items()}
        check(sum(topk.values()) == sum(r["launches"] for r in log)
              and all(v[1] == 0 for v in stages.values()),
              f"phase 15 {name}: the tracker's launches {sum(r['launches'] for r in log)} are not "
              f"those of its stages {stages}")
        orb, stereo, slp, pe = (c == "1" for c in mask)
        # a stage whose toggle is off never launches on the card; one that
        # is on launches where its stage ran
        check((topk["stereo"] > 0) == (orb and stereo),
              f"phase 15 {name}: {topk['stereo']} stereo launches")
        check(topk["tlm"] + topk["fused"] == 0 if not slp else topk["tlm"] + topk["fused"] > 0,
              f"phase 15 {name}: local-map launches {topk['tlm']} stepwise, {topk['fused']} fused")
        check(topk["twm"] == 0 if not pe else topk["twm"] + topk["fused"] > 0,
              f"phase 15 {name}: motion-model launches {topk['twm']}")
        # the reference-keyframe matcher runs on the device under every mask
        # (JAX tracking.py: match_fisheye is not toggled), one K = 2 launch
        # per call
        check(topk["trk"] == stages["trk"][2] == len(tr.stats.series["trk"]),
              f"phase 15 {name}: {topk['trk']} reference-keyframe launches for "
              f"{len(tr.stats.series['trk'])} calls")
        if mask == "0000":
            check(sum(topk.values()) - topk["trk"] == 0,
                  f"phase 15 {name}: the tracker launched a Hamming kernel outside the "
                  f"reference-keyframe matcher: {topk}")
        fused = sum(r["path"] == "fused" for r in log)
        check(fused == 0 if mask != "1111" or not po else fused >= N_TOGGLE_FRAMES - 6,
              f"phase 15 {name}: {fused} fused frames")
        ate = trajectory_ate(tr.trajectory, seq)
        check(ate["n"] == len(log) and ate["rmse"] < ATE_LIMIT_M,
              f"phase 15 {name}: ATE RMSE {ate['rmse']:.4f} m over {ate['n']} frames, "
              f"limit {ATE_LIMIT_M} m")
        times = [r["ms"] for r in log[2:]]

        def median(series):
            v = tr.stats.series.get(series, [])
            return float(np.median(v)) if v else None

        row = {"mask": mask, "po": po, "frames": len(log), "timed_frames": len(times),
               "ms_median": float(np.median(times)), "ms_p90": float(np.percentile(times, 90)),
               "orb_extraction_ms_median": median("orb_extraction"),
               "twm_ms_median": median("twm"), "tlm_ms_median": median("tlm"),
               "fused_frames": fused,
               "fetches_per_frame": sum(r["fetches"] for r in log) / len(log),
               "topk_launches_by_stage": topk, "matrix_launches": 0,
               "ate_rmse_m": ate["rmse"], "baseline_md_ms": BASELINE_MS.get((mask, po))}
        rows.append(row)
        base = row["baseline_md_ms"]
        fmt = lambda v: "n/a" if v is None else f"{v:.3f}"
        print(f"phase 15 toggle matrix, {name}: {len(log)} frames at {W}x{H} on {card}: every "
              f"frame OK; ms/frame median {row['ms_median']:.3f}, p90 {row['ms_p90']:.3f} over "
              f"{len(times)} (host clock, frames after the first two); Stats medians ms: "
              f"orb_extraction {fmt(row['orb_extraction_ms_median'])}, twm "
              f"{fmt(row['twm_ms_median'])}, tlm {fmt(row['tlm_ms_median'])} (stepwise frames); "
              f"{fused} fused frames; fetches per frame {row['fetches_per_frame']:.3f}; the "
              f"tracker's top-k launches by stage {topk}, matrix launches 0; ATE RMSE "
              f"{ate['rmse']:.4f} m; BASELINE.md's published row (the reference's paper rig, "
              f"hardware unrecorded): "
              + ("none published" if base is None else
                 " / ".join(f"{v:.2f}" for v in base) + " ms/frame (MH01 / V101 / room1 / "
                 "corridor1)"))
    print("phase 15 configurations: " + json.dumps(rows))
    return kern.launches, matrix.launches, rows


def phase_system_inertial_host(device, seq, card):
    """BASELINE.md's CPU row: the stereo-inertial system a user calls with
    every offload toggle off (pose optimization on, on the card as in the
    JAX package), inline mapping."""
    kern = reset_launch_counts()
    matrix = hamming_kernel.hamming_penalty_matrix
    system = make_inertial_system(seq, device, KernelConfig.from_bitmask("0000"))
    keyframes, rotations = [], []
    watch_mapper(system, keyframes)
    m = system.atlas.current
    inner_rotation = m.apply_scaled_rotation

    def apply_scaled_rotation(R_gw, scale, *args, **kwargs):
        rotations.append(np.asarray(R_gw, np.float64).copy())
        return inner_rotation(R_gw, scale, *args, **kwargs)

    m.apply_scaled_rotation = apply_scaled_rotation   # IMU init rotates the world once
    counts, restore = watch_tracker_stages()
    try:
        log, t_prev = [], -1.0
        for f in seq.frames[:N_HOST_INERTIAL_FRAMES]:
            n_kf = len(keyframes)
            r = tracker_step(system.tracker, f, entry=system,
                             imu=imu_between(seq, t_prev, f.timestamp))
            r["mapped"] = keyframes[n_kf:]
            r["imu_initialized"] = bool(system.atlas.current.imu_initialized)
            log.append(r)
            t_prev = f.timestamp
    finally:
        restore()
    system.shutdown()
    for i, r in enumerate(log):
        check(r["state"] == "OK", f"phase 16 frame {i}: state {r['state']}")
        check(r["path"] == "stepwise", f"phase 16 frame {i}: {r['path']}")
        check(np.isfinite(r["R"]).all() and np.isfinite(r["t"]).all(), f"phase 16 frame {i}: pose")
    check(any(r["imu_initialized"] for r in log), "phase 16: the IMU never initialized")
    init_frame = next(i for i, r in enumerate(log) if r["imu_initialized"])
    bg = system.tracker.bias[0]
    check(np.linalg.norm(bg) < 0.05, f"phase 16: gyro bias {bg} (the stream has none)")
    check(len(rotations) == 1, f"phase 16: {len(rotations)} world rotations, IMU init makes one")
    tilt = float(np.degrees(np.arccos(np.clip((np.trace(rotations[0]) - 1) / 2, -1.0, 1.0))))
    # The trajectory keeps each frame's pose as tracked: frames up to the
    # init are in the world before its rotation, the others after it.
    traj = system.tracker.trajectory
    ate = trajectory_ate(traj, seq)
    ate_pre, ate_post = trajectory_ate(traj[:init_frame + 1], seq), trajectory_ate(
        traj[init_frame + 1:], seq)
    check(ate["n"] == N_HOST_INERTIAL_FRAMES and ate_post["rmse"] <= ATE_LIMIT_M
          and ate["rmse"] <= HOST_ROUTE_ATE_LIMIT_M,
          f"phase 16: ATE RMSE {ate_post['rmse']:.4f} m over the {ate_post['n']} frames after IMU "
          f"init (limit {ATE_LIMIT_M} m), {ate['rmse']:.4f} m over all {ate['n']} (limit "
          f"{HOST_ROUTE_ATE_LIMIT_M} m), {ate_pre['rmse']:.4f} m before init")
    mapper_topk = sum(k["topk"] for k in keyframes)
    mapper_matrix = sum(k["matrix"] for k in keyframes)
    tracker_topk, tracker_matrix = kern.launches - mapper_topk, matrix.launches - mapper_matrix
    check(tracker_matrix == 0 and tracker_topk == counts["trk"][0] == counts["trk"][2]
          and sum(c[0] for k, c in counts.items() if k != "trk") == 0,
          f"phase 16: the tracker launched {tracker_topk} top-k and {tracker_matrix} matrix "
          f"kernels, by stage {counts}")

    times = {
        "before IMU init, no keyframe":
            frame_ms([r for r in log[2:init_frame] if not r["mapped"]]),
        "after IMU init, no keyframe":
            frame_ms([r for r in log[init_frame + 1:] if not r["mapped"]]),
        "frames with a keyframe": frame_ms([r for r in log[1:] if r["mapped"]]),
    }
    series = system.stats.series
    print(
        f"phase 16{BESIDE} stereo-inertial system, mask 0000 PO on, inline mapping: {len(log)} frames at "
        f"{W}x{H} through System.track_stereo(..., imu=...) on {card}: every frame OK and "
        f"stepwise; IMU initialized at frame {init_frame}, |bg| {np.linalg.norm(bg):.5f} rad/s; "
        f"ms/frame median, p90 (count): "
        + "; ".join(f"{k} {v[0]:.3f}, {v[1]:.3f} ({v[2]})" for k, v in times.items())
        + f"; Stats medians ms: orb_extraction {np.median(series['orb_extraction']):.3f}, "
        f"twm {np.median(series['twm']):.3f}, tlm {np.median(series['tlm']):.3f}; fetches per "
        f"frame {sum(r['fetches'] for r in log) / len(log):.3f}; keyframes {len(keyframes)}; "
        f"the init's world rotation {tilt:.3f} deg; ATE RMSE {ate_post['rmse']:.4f} m over the "
        f"{ate_post['n']} frames after init (limit {ATE_LIMIT_M}), {ate_pre['rmse']:.4f} m over "
        f"the {ate_pre['n']} up to it, {ate['rmse']:.4f} m over all (limit "
        f"{HOST_ROUTE_ATE_LIMIT_M}; ROADMAP F15: the host extractor's map drifts before init, in "
        f"the JAX package too); the tracker's top-k launches "
        f"{tracker_topk} (all the reference-keyframe matcher's), matrix 0; the mapper's top-k "
        f"{mapper_topk}, matrix {mapper_matrix}; BASELINE.md's CPU row (0000, PO on; the "
        f"reference's paper rig, hardware unrecorded): "
        + " / ".join(f"{v:.2f}" for v in BASELINE_MS[("0000", True)])
        + " ms/frame (MH01 / V101 / room1 / corridor1)"
    )
    return kern.launches, matrix.launches


def watch_loop_closer(lc, rows):
    """Wraps the loop closer's process_keyframe: per keyframe, the kernels
    it launched (top-K at K = 1 and K = 2, matrix), its ms on the host's
    clock (synchronised) and whether it closed a loop, appended to `rows`."""
    kern, matrix = hamming_kernel.hamming_penalty_topk, hamming_kernel.hamming_penalty_matrix
    inner = lc.process_keyframe

    def process_keyframe(kf_id):
        k1, k2, mat = kern.launches_by_k[1], kern.launches_by_k[2], matrix.launches
        if lc.device.type == "cuda":
            torch.cuda.synchronize(lc.device)
        t0 = time.perf_counter()
        closed = inner(kf_id)
        if lc.device.type == "cuda":
            torch.cuda.synchronize(lc.device)
        rows.append({"kid": kf_id, "closed": bool(closed), "ms": (time.perf_counter() - t0) * 1e3,
                     "k1": kern.launches_by_k[1] - k1, "k2": kern.launches_by_k[2] - k2,
                     "matrix": matrix.launches - mat})
        return closed

    lc.process_keyframe = process_keyframe


def watch_merge(lc, rows):
    """Wraps the loop closer's _merge_maps: per attempt, whether it welded,
    its ms on the host's clock (synchronised; with the global BA when the
    closer is synchronous) and the K = 2 and matrix launches it made,
    appended to `rows`."""
    kern, matrix = hamming_kernel.hamming_penalty_topk, hamming_kernel.hamming_penalty_matrix
    inner = lc._merge_maps

    def merge_maps(*args):
        k2, mat = kern.launches_by_k[2], matrix.launches
        if lc.device.type == "cuda":
            torch.cuda.synchronize(lc.device)
        t0 = time.perf_counter()
        ok = inner(*args)
        if lc.device.type == "cuda":
            torch.cuda.synchronize(lc.device)
        rows.append({"welded": ok, "ms": (time.perf_counter() - t0) * 1e3,
                     "k2": kern.launches_by_k[2] - k2, "matrix": matrix.launches - mat})
        return ok

    lc._merge_maps = merge_maps


def centre_error(seq, R_cw, t_cw, i) -> float:
    """Distance of a camera centre from frame i's ground truth, both in the
    first camera's frame (the system's world)."""
    R0, t0 = seq.frames[0].R_wc, seq.frames[0].t_wc
    return float(np.linalg.norm(-R_cw.T @ t_cw - R0.T @ (seq.frames[i].t_wc - t0)))


def phase_relocalization(device, seq, card, atlas_path):
    """Relocalization on the card: the default System over phase 10's
    sequence, lost on blank frames, then shown the start of the sequence
    again (tests/test_tracking_e2e.py's offset view at full size). Its atlas
    after the tracked frames goes to `atlas_path` (phase 27a loads it);
    returns its keyframe and map-point counts besides the launches."""
    kern = reset_launch_counts()
    matrix = hamming_kernel.hamming_penalty_matrix
    system = make_system(seq, device, vocabulary=None)
    tracker = system.tracker
    attempts, log = [], []
    inner = tracker._relocalization

    def relocalization(frame):
        k2 = kern.launches_by_k[2]
        ok = inner(frame)
        attempts.append({"frame": len(log), "ok": ok, "launches_k2": kern.launches_by_k[2] - k2})
        return ok

    tracker._relocalization = relocalization
    for f in seq.frames[:N_RELOC_TRACKED]:
        log.append(tracker_step(tracker, f, entry=system))
    for i, r in enumerate(log):
        check(r["state"] == "OK", f"phase 17 frame {i}: state {r['state']}")
    n_maps, n_kf = system.atlas.n_maps(), system.atlas.current.n_keyframes()
    t0 = time.perf_counter()
    system.save_atlas(atlas_path)
    saved = {"keyframes": n_kf, "mappoints": system.atlas.current.n_mappoints(),
             "save_ms": (time.perf_counter() - t0) * 1e3, "bytes": os.path.getsize(atlas_path)}
    tracked = tracker.last_frame      # frame N_RELOC_TRACKED - 1, for the direct check below
    blank = np.full_like(seq.frames[0].left, 127)
    t = seq.frames[N_RELOC_TRACKED - 1].timestamp
    for _ in range(N_RELOC_BLANK):
        t += 0.05
        log.append(tracker_step(tracker, types.SimpleNamespace(left=blank, right=blank,
                                                                timestamp=t), entry=system))
    check(log[-1]["state"] == "RECENTLY_LOST",
          f"phase 17: after {N_RELOC_BLANK} blank frames the state is {log[-1]['state']}")
    again, errors = [], []
    for i, f in enumerate(seq.frames[:N_RELOC_AGAIN]):
        t += 0.05
        again.append(tracker_step(tracker, types.SimpleNamespace(left=f.left, right=f.right,
                                                                  timestamp=t), entry=system))
        errors.append(centre_error(seq, again[-1]["R"], again[-1]["t"], i))
    system.shutdown()
    states = [r["state"] for r in again]
    check("OK" in states, f"phase 17: not re-acquired in {N_RELOC_AGAIN} frames: {states}")
    back = states.index("OK")
    check(all(x == "OK" for x in states[back:]), f"phase 17: lost again after re-acquiring: {states}")
    check(system.atlas.n_maps() == n_maps, f"phase 17: {system.atlas.n_maps()} maps, not {n_maps}")
    check(errors[back] <= RELOC_LIMIT_M,
          f"phase 17: the re-acquired pose is {errors[back]:.4f} m from the truth, limit "
          f"{RELOC_LIMIT_M} m (twice the JAX package's reading, at most 0.25 m)")
    # The relocalization path itself, which a re-acquisition through the
    # reference keyframe does not take: the last tracked frame before the
    # blank ones relocalized against the keyframe database (BoW, the K = 2
    # match, PnP, pose optimization), its tracked pose beside the result.
    scenario = list(attempts)
    R_before, t_before = tracked.R_cw.copy(), tracked.t_cw.copy()
    direct = relocalization(tracked)
    direct_inliers = tracker.n_inliers
    moved = float(np.linalg.norm(-tracked.R_cw.T @ tracked.t_cw + R_before.T @ t_before))
    direct_error = centre_error(seq, tracked.R_cw, tracked.t_cw, N_RELOC_TRACKED - 1)
    check(direct and direct_inliers >= 50 and attempts[-1]["launches_k2"] >= 1
          and direct_error <= RELOC_DIRECT_LIMIT_M,
          f"phase 17: relocalizing frame {N_RELOC_TRACKED - 1} against the database: {direct}, "
          f"{direct_inliers} inliers, {attempts[-1]['launches_k2']} K = 2 launches, "
          f"{direct_error:.4f} m from the truth (limit {RELOC_DIRECT_LIMIT_M}, twice the JAX "
          "package's reading)")
    series = system.stats.series
    relocated = [a for a in scenario if a["ok"]]
    reloc_launches = sum(a["launches_k2"] for a in attempts)
    print(
        f"phase 17{BESIDE} relocalization: System(Sensor.STEREO) with the shipped vocabulary on {card}, "
        f"frames 0-{N_RELOC_TRACKED - 1} of phase 10's sequence every one OK ({n_kf} keyframes), "
        f"{N_RELOC_BLANK} blank frames -> RECENTLY_LOST, frames 0-{N_RELOC_AGAIN - 1} again: "
        f"states {states}; re-acquired at frame {back} "
        f"({'by relocalization' if any(a['frame'] == N_RELOC_TRACKED + N_RELOC_BLANK + back for a in relocated) else 'through the reference keyframe'}), "
        f"{again[back]['ms']:.1f} ms, centre error {errors[back]:.4f} m (limit {RELOC_LIMIT_M}), "
        f"at frame {N_RELOC_AGAIN - 1} {errors[-1]:.4f} m; maps {n_maps} -> {system.atlas.n_maps()}; "
        f"relocalization attempts (frame, ok) {[(a['frame'], a['ok']) for a in scenario]}; frame "
        f"{N_RELOC_TRACKED - 1} relocalized against the database: {direct_inliers} inliers, "
        f"{direct_error:.4f} m from the truth (limit {RELOC_DIRECT_LIMIT_M}), {moved:.4f} m from "
        f"its tracked pose; over all "
        f"attempts, BoW candidates "
        f"{[int(x) for x in series['reloc_candidates']]}, PnP inliers "
        f"{[int(x) for x in series['reloc_pnp_inliers']]}, inliers after the rebind "
        f"{[int(x) for x in series['reloc_inliers']]}; top-k launches at K = 2 by relocalization "
        f"{reloc_launches}; loops closed {system.loop_closer.n_loops_closed}; top-k kernel "
        f"launches {kern.launches} ({dict(kern.launches_by_k)} by K), matrix kernel launches "
        f"{matrix.launches}; atlas after frame {N_RELOC_TRACKED - 1} saved: {saved['keyframes']} "
        f"keyframes, {saved['mappoints']} map points, {saved['bytes']} bytes in "
        f"{saved['save_ms']:.1f} ms"
    )
    return kern.launches, matrix.launches, reloc_launches, saved


def phase_loop_closing_map(device, card):
    """The loop path on the card, deterministic: tests/test_gba_merge.py's
    drifted map (drifted_loop_scene) through LoopCloser.process_keyframe with
    a vocabulary from the port's train_vocabulary (so its quantization is the
    top-K kernel at K = 1), then the same on the CPU."""
    calls = []
    inner_opt = loop_closing.optimize_sim3

    def optimize_sim3(*args, **kw):
        calls.append((args, kw))
        return inner_opt(*args, **kw)

    def run(dev):
        atlas, out, back, descs, drift = drifted_loop_scene(slam_map)
        cam = make_pinhole(LOOP_FX, LOOP_FX, LOOP_W / 2, LOOP_H / 2, LOOP_W, LOOP_H, device=dev)
        voc = train_vocabulary(np.concatenate([descs, descs]), n_words=64, iters=2, device=dev)
        K = np.array([[LOOP_FX, 0, LOOP_W / 2], [0, LOOP_FX, LOOP_H / 2], [0, 0, 1.0]])
        lc = loop_closing.LoopCloser(atlas, voc, K, camera=cam, bf=1.0, run_gba=True,
                                     min_consistency=2, device=dev)
        rows = []
        watch_loop_closer(lc, rows)
        before = drift(back)
        reset_launch_counts()
        for kf in out + back:
            lc.process_keyframe(kf.kid)
        poses = {k: (kf.R_cw.copy(), kf.t_cw.copy()) for k, kf in atlas.current.keyframes.items()}
        return lc, rows, before, drift(back), poses

    loop_closing.optimize_sim3 = optimize_sim3
    try:
        lc, rows, before, after, poses = run(device)
    finally:
        loop_closing.optimize_sim3 = inner_opt
    kern, matrix = hamming_kernel.hamming_penalty_topk, hamming_kernel.hamming_penalty_matrix
    launches = {"topk": kern.launches, "k1": kern.launches_by_k[1], "k2": kern.launches_by_k[2],
                "matrix": matrix.launches}
    check(any(r["closed"] for r in rows) and lc.n_loops_closed >= 1,
          f"phase 18a: the loop did not close: {rows}")
    check(lc.n_gba_runs >= 1, f"phase 18a: {lc.n_gba_runs} global BAs after the loop")
    check(after < DRIFT_RATIO * before,
          f"phase 18a: drift {before:.4f} m before, {after:.4f} m after (ratio {DRIFT_RATIO})")
    # the loop's fusion (fuse_mappoints_into) merges the return leg's
    # duplicate points through the matrix kernel
    check(launches["k1"] == len(rows) and launches["k2"] >= 1 and launches["matrix"] >= 1,
          f"phase 18a: launches {launches} for {len(rows)} keyframes")
    # ROADMAP K13: one Sim3 refinement of this loop, its kernels counted by
    # the profiler and its time on the host's clock
    args, kw = calls[0]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        inner_opt(*args, **kw)
        torch.cuda.synchronize()
    k13_launches = len(device_kernels(prof))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    inner_opt(*args, **kw)
    k13_ms = (time.perf_counter() - t0) * 1e3
    _, cpu_rows, _, _, cpu_poses = run("cpu")
    worst = max(max(float(np.abs(poses[k][0] - cpu_poses[k][0]).max()),
                    float(np.abs(poses[k][1] - cpu_poses[k][1]).max())) for k in poses)
    check(sorted(poses) == sorted(cpu_poses) and worst <= 1e-3
          and [r["closed"] for r in rows] == [r["closed"] for r in cpu_rows],
          f"phase 18a: card against CPU, keyframe poses part by {worst:.2e} (limit 1e-3)")
    loop_row = next(r for r in rows if r["closed"])
    print(
        f"phase 18a{BESIDE} loop closing, drifted map: {len(rows)} keyframes (6 outbound, 3 returning with "
        f"a 0.06 rad / 0.3 m drift, {LOOP_W}x{LOOP_H}) through LoopCloser.process_keyframe on "
        f"{card}: loop closed at keyframe {lc.last_loop_kf_id}, global BAs {lc.n_gba_runs}; drift "
        f"{before:.4f} m -> {after:.4f} m (limit {DRIFT_RATIO} x); loop-closing keyframe "
        f"{loop_row['ms']:.1f} ms, the others median "
        f"{np.median([r['ms'] for r in rows if not r['closed']]):.1f} ms; launches {launches} "
        f"(K = 1: one per keyframe, the flat vocabulary's quantization); the Sim3 refinement "
        f"(ROADMAP K13): {k13_launches} kernel launches, {k13_ms:.1f} ms per call; card against "
        f"CPU: the same closures, keyframe poses within {worst:.2e} (limit 1e-3)"
    )
    return launches, k13_launches, k13_ms


def phase_loop_closing_system(device, card, loop_seq):
    """The default System over a rendered loop (`loop_seq`, the future of
    its rendering): a lap that returns to its start, every keyframe through
    the loop closer inline."""
    t0 = time.perf_counter()
    seq = loop_seq.result()
    render_s = time.perf_counter() - t0
    kern = reset_launch_counts()
    matrix = hamming_kernel.hamming_penalty_matrix
    system = make_system(seq, device, vocabulary=None)
    lc, rows, log = system.loop_closer, [], []
    watch_loop_closer(lc, rows)
    for f in seq.frames:
        n = len(rows)
        log.append(tracker_step(system.tracker, f, entry=system))
        log[-1]["lc"] = rows[n:]
    system.shutdown()
    ate = trajectory_ate(system.tracker.trajectory, seq)
    not_ok = [i for i, r in enumerate(log) if r["state"] != "OK"]
    closures = [(i, r["lc"][0]["kid"]) for i, r in enumerate(log) if any(x["closed"] for x in r["lc"])]
    lc_k = {k: sum(r[k] for r in rows) for k in ("k1", "k2", "matrix")}
    if LOOP_JAX_CLOSES:
        check(lc.n_loops_closed >= 1 and lc.n_gba_runs >= 1,
              f"phase 18b: {lc.n_loops_closed} loops closed, {lc.n_gba_runs} global BAs "
              "(the JAX package closes one on this sequence)")
    check(ate["n"] == N_LOOP_FRAMES and ate["rmse"] <= LOOP_ATE_LIMIT_M,
          f"phase 18b: ATE RMSE {ate['rmse']:.4f} m over {ate['n']} frames, limit "
          f"{LOOP_ATE_LIMIT_M} m (twice the JAX package's reading)")
    check(len(rows) == int(sum(system.stats.series["lm_keyframes"])) > 0,
          f"phase 18b: the loop closer saw {len(rows)} keyframes")
    plain = [r["ms"] for r in log[2:] if not r["lc"]]
    keyframed = [r["ms"] for r in log[1:] if r["lc"] and not any(x["closed"] for x in r["lc"])]
    closing = [r["ms"] for r in log if any(x["closed"] for x in r["lc"])]
    lc_ms = [r["ms"] for r in rows]
    print(
        f"phase 18b{BESIDE} loop closing, System(Sensor.STEREO) with the shipped vocabulary over "
        f"{N_LOOP_FRAMES} frames of the rendered loop at {W}x{H} (waited {render_s:.1f} s for its "
        f"rendering) on "
        f"{card}: frames not OK {not_ok}; loops closed {lc.n_loops_closed} at (frame, keyframe) "
        f"{closures}, global BAs {lc.n_gba_runs}; ATE RMSE {ate['rmse']:.4f} m (limit "
        f"{LOOP_ATE_LIMIT_M}, the JAX package's reading {LOOP_JAX_ATE_M}); keyframes "
        f"{len(rows)}, in the map {system.atlas.current.n_keyframes()}; ms/frame median (p90, n): "
        f"without a keyframe {np.median(plain):.1f} ({np.percentile(plain, 90):.1f}, {len(plain)}), "
        f"with a keyframe {np.median(keyframed):.1f} ({np.percentile(keyframed, 90):.1f}, "
        f"{len(keyframed)}), closing a loop "
        f"{[round(x, 1) for x in closing]}; the loop closer per keyframe median "
        f"{np.median(lc_ms):.1f} ms, max {np.max(lc_ms):.1f}; its launches {lc_k} (top-k K = 1 and "
        f"K = 2, matrix); top-k kernel launches {kern.launches} ({dict(kern.launches_by_k)} by "
        f"K), matrix kernel launches {matrix.launches}"
    )
    return kern.launches, matrix.launches, lc_k


def loop_scene_camera(dev):
    return make_pinhole(LOOP_FX, LOOP_FX, LOOP_W / 2, LOOP_H / 2, LOOP_W, LOOP_H, device=dev)


LOOP_K = np.array([[LOOP_FX, 0, LOOP_W / 2], [0, LOOP_FX, LOOP_H / 2], [0, 0, 1.0]])


def phase_inertial_loop_map(device, card):
    """(a) Inertial loop closing on the card, deterministic:
    tests/test_inertial_loop.py's scene (drifted_loop_scene(inertial=True):
    an IMU-initialized map whose drifted return leg carries drifted
    velocities) through LoopCloser.process_keyframe with a 64-word
    vocabulary trained by the port (K = 1 on the card), then on the CPU."""
    inner = loop_closing.optimize_essential_graph_4dof

    def run(dev):
        atlas, out, back, descs, _ = drifted_loop_scene(slam_map, inertial=True)
        voc = train_vocabulary(np.concatenate([descs, descs]), n_words=64, iters=2, device=dev)
        lc = loop_closing.LoopCloser(atlas, voc, LOOP_K, camera=loop_scene_camera(dev), bf=1.0,
                                     run_gba=False, min_consistency=2, device=dev)
        graphs, rows = [], []

        def graph_4dof(poses, edges, fixed, *a, **kw):
            graphs.append((dict(poses), inner(poses, edges, fixed, *a, **kw)))
            return graphs[-1][1]

        loop_closing.optimize_essential_graph_4dof = graph_4dof
        watch_loop_closer(lc, rows)
        try:
            reset_launch_counts()
            for kf in out + back:
                lc.process_keyframe(kf.kid)
        finally:
            loop_closing.optimize_essential_graph_4dof = inner
        state = {k: (kf.R_cw.copy(), kf.t_cw.copy(), np.asarray(kf.velocity, np.float64))
                 for k, kf in atlas.current.keyframes.items()}
        return lc, rows, graphs, out, back, state

    lc, rows, graphs, out, back, state = run(device)
    kern, matrix = hamming_kernel.hamming_penalty_topk, hamming_kernel.hamming_penalty_matrix
    launches = {"topk": kern.launches, "k1": kern.launches_by_k[1], "k2": kern.launches_by_k[2],
                "matrix": matrix.launches}
    check(lc.n_loops_closed == 1 and len(graphs) == 1,
          f"phase 19a: {lc.n_loops_closed} loops closed, the 4-DoF graph ran {len(graphs)} times")
    ez = np.array([0.0, 0.0, 1.0])
    poses, opt = graphs[0]
    tilt = max(float(np.linalg.norm(
        loop_closing.sim3_mul(loop_closing.sim3_inv(opt[k]), poses[k])[1] @ ez - ez))
        for k in poses)
    check(tilt < 1e-6, f"phase 19a: a vertex update of the 4-DoF graph tilts z by {tilt:.2e}")
    fd = max(float(np.linalg.norm(np.asarray(back[k].velocity) - (back[k + 1].center - back[k].center)))
             for k in range(len(back) - 1))
    outbound = max(float(np.linalg.norm(np.asarray(kf.velocity) - [0.4, 0.0, 0.0]))
                   for kf in out[:3])
    check(fd < 0.25 and outbound < 0.2,
          f"phase 19a: velocities {fd:.4f} m/s from the corrected trajectory's differences (limit "
          f"0.25), the outbound leg's moved {outbound:.4f} (limit 0.2)")
    check(launches["k1"] == len(rows) and launches["k2"] >= 1,
          f"phase 19a: launches {launches} for {len(rows)} keyframes")
    _, cpu_rows, _, _, _, cpu_state = run("cpu")
    worst = max(float(np.abs(a - b).max()) for k in state for a, b in zip(state[k], cpu_state[k]))
    check(sorted(state) == sorted(cpu_state) and worst <= 1e-5
          and [r["closed"] for r in rows] == [r["closed"] for r in cpu_rows],
          f"phase 19a: card against CPU, poses and velocities part by {worst:.2e} (limit 1e-5)")
    print(
        f"phase 19a inertial loop closing, drifted inertial map: {len(rows)} keyframes "
        f"({LOOP_W}x{LOOP_H}, IMU-initialized, velocities drifted with the poses) through "
        f"LoopCloser.process_keyframe on {card}: loop closed at keyframe {lc.last_loop_kf_id}, the "
        f"4-DoF essential graph over {len(opt)} vertices, the largest tilt of world z by a vertex "
        f"update {tilt:.2e} (limit 1e-6); velocities against the corrected trajectory's "
        f"differences {fd:.4f} m/s (limit 0.25), outbound leg moved {outbound:.4f} (limit 0.2); "
        f"loop-closing keyframe {next(r['ms'] for r in rows if r['closed']):.1f} ms; launches "
        f"{launches}; card against CPU: poses and velocities within {worst:.2e} (limit 1e-5)"
    )
    return launches


def keyframe_ate(m, seq) -> dict:
    kfs = sorted(m.keyframes.values(), key=lambda k: k.kid)
    return absolute_trajectory_error(np.asarray([k.timestamp for k in kfs]),
                                     np.asarray([k.center for k in kfs]), seq.gt_t, seq.gt_pos)


def phase_inertial_global_ba(system, seq, card):
    """(b) The post-loop global BA of an IMU-initialized map at full size:
    LoopCloser._run_global_ba on phase 13's map must take the mapper's
    converged full inertial BA; called twice, the second sweep finds the
    fixed point."""
    mapper, lc = system.local_mapper, system.loop_closer
    m = system.atlas.current
    check(m.imu_initialized, "phase 19b: phase 13's map is not IMU-initialized")
    # Neither package marks a live map inertial (Map.is_inertial is set only
    # where an atlas is loaded, ROADMAP F16), so a loop in phase 13's run
    # would take the visual graph and BA; the phase marks the map as an
    # inertial atlas's would be, as tests/test_inertial_loop.py does.
    was_inertial = m.is_inertial
    m.is_inertial = True
    calls, inner = [], mapper.full_inertial_ba_converged

    def converged(kf, *a, **kw):
        calls.append(inner(kf, *a, **kw))
        return calls[-1]

    mapper.full_inertial_ba_converged = converged
    windows = system.stats.series["lm_inertial_window"]
    kern = reset_launch_counts()
    ate_before = keyframe_ate(m, seq)
    n_windows = len(windows)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lc._run_global_ba()
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    first_windows = len(windows) - n_windows
    before = {k: kf.t_cw.copy() for k, kf in m.keyframes.items()}
    n_windows = len(windows)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        lc._run_global_ba()
        torch.cuda.synchronize()
        second_ms = (time.perf_counter() - t0) * 1e3
    second_launches = len(device_kernels(prof))
    second_windows = len(windows) - n_windows
    mapper.full_inertial_ba_converged = inner
    moved = max(float(np.abs(m.keyframes[k].t_cw - t).max()) for k, t in before.items())
    ate = keyframe_ate(m, seq)
    check(len(calls) == 2 and lc.n_gba_runs == 2,
          f"phase 19b: the global BA took the full inertial BA {len(calls)} times of 2")
    check(calls[1] == 1 and moved <= 1e-3,
          f"phase 19b: the second call ran {calls[1]} sweeps and moved a keyframe {moved:.2e} m "
          "(want 1 and <= 1e-3)")
    check(ate["rmse"] <= ATE_LIMIT_M,
          f"phase 19b: keyframe ATE RMSE {ate['rmse']:.4f} m after the global BA, limit {ATE_LIMIT_M}")
    check(kern.launches == 0 and hamming_kernel.hamming_penalty_matrix.launches == 0,
          "phase 19b: a Hamming kernel launched in the inertial BA")
    print(
        f"phase 19b post-loop global BA of phase 13's IMU-initialized map ({m.n_keyframes()} "
        f"keyframes; is_inertial was {was_inertial}, set) on {card}: LoopCloser._run_global_ba -> "
        f"full_inertial_ba_converged: "
        f"{calls[0]} sweeps, {first_windows} inertial windows, {first_ms:.1f} ms; again: "
        f"{calls[1]} sweep, {second_windows} windows, {second_launches} kernel launches, "
        f"{second_ms:.1f} ms, keyframes moved at most {moved:.2e} m (limit 1e-3); keyframe ATE "
        f"RMSE {ate_before['rmse']:.4f} m before, {ate['rmse']:.4f} m after (limit {ATE_LIMIT_M})"
    )


def phase_map_merge(device, card):
    """(a) The Atlas map merge on the card, deterministic: tests/test_gba_merge.py's
    two maps (two_map_scene) through LoopCloser.process_keyframe, the old
    map's keyframes while it is current, then the new map's, with the global
    BA after the weld; then the same on the CPU."""
    def run(dev):
        atlas, m_old, m_new, kfs_a, kfs_b, descs = two_map_scene(slam_map)
        voc = train_vocabulary(np.concatenate([descs, descs]), n_words=64, iters=2, device=dev)
        lc = loop_closing.LoopCloser(atlas, voc, LOOP_K, camera=loop_scene_camera(dev), bf=1.0,
                                     run_gba=True, device=dev)
        atlas.set_kf_database(lc.db)
        merges, rows = [], []
        watch_merge(lc, merges)
        watch_loop_closer(lc, rows)
        reset_launch_counts()
        atlas.change_map(m_old)
        for kf in kfs_a:
            lc.process_keyframe(kf.kid)
        atlas.change_map(m_new)
        for kf in kfs_b:
            lc.process_keyframe(kf.kid)
        poses = {k: (kf.R_cw.copy(), kf.t_cw.copy()) for k, kf in atlas.current.keyframes.items()}
        merge = {key: sum(x[key] for x in merges) for key in ("k2", "matrix")}
        return lc, atlas, m_old, m_new, kfs_b, rows, merge, poses

    lc, atlas, m_old, m_new, kfs_b, rows, merge, poses = run(device)
    kern, matrix = hamming_kernel.hamming_penalty_topk, hamming_kernel.hamming_penalty_matrix
    launches = {"topk": kern.launches, "k1": kern.launches_by_k[1], "k2": kern.launches_by_k[2],
                "matrix": matrix.launches}
    check(lc.n_maps_merged == 1 and lc.n_loops_closed == 0 and lc.n_gba_runs == 1,
          f"phase 20a: {lc.n_maps_merged} merges, {lc.n_loops_closed} loops, {lc.n_gba_runs} "
          "global BAs")
    check(atlas.current is m_old and m_new not in atlas.maps and atlas.n_maps() == 1
          and sorted(lc.db.kf_bows) == sorted(m_old.keyframes),
          "phase 20a: the emptied map was not removed or the old map is not current")
    errors = [float(np.linalg.norm(kf.center - [0.8 + 0.4 * k, 0.0, 0.0]))
              for k, kf in enumerate(kfs_b)]
    check(max(errors) < 0.15, f"phase 20a: welded centres {errors} m from the truth (limit 0.15)")
    check(merge["k2"] >= 1 and merge["matrix"] >= 1,
          f"phase 20a: the merge launched {merge} (K = 2 and matrix)")
    _, _, _, _, _, cpu_rows, _, cpu_poses = run("cpu")
    worst = max(max(float(np.abs(poses[k][0] - cpu_poses[k][0]).max()),
                    float(np.abs(poses[k][1] - cpu_poses[k][1]).max())) for k in poses)
    check(sorted(poses) == sorted(cpu_poses) and worst <= 1e-5
          and [r["closed"] for r in rows] == [r["closed"] for r in cpu_rows],
          f"phase 20a: card against CPU, keyframe poses part by {worst:.2e} (limit 1e-5)")
    merge_row = next(r for r in rows if r["closed"])
    print(
        f"phase 20a Atlas map merge: two maps ({LOOP_W}x{LOOP_H}; 8 keyframes, then 4 after a "
        f"loss in a frame 0.15 rad and 0.83 m off) through LoopCloser.process_keyframe on {card}: "
        f"merged at keyframe {merge_row['kid']} into the old map, maps left {atlas.n_maps()}, "
        f"global BAs {lc.n_gba_runs}; welded centres at most {max(errors):.4f} m from the truth "
        f"(limit 0.15); the merging keyframe {merge_row['ms']:.1f} ms (global BA included); "
        f"launches {launches}, of them the merge's {merge} (K = 2 verification, matrix fusion); "
        f"card against CPU: keyframe poses within {worst:.2e} (limit 1e-5)"
    )
    return launches, merge


def phase_map_merge_system(device, card, loop_seq):
    """(b) A merge inside the visual default System: frames 0-79 of phase
    18b's rendered loop, 7 blank frames 1 s apart (lost past
    time_recently_lost, so a new map starts), then frames 20-59 again with
    the timestamps running on; the new map, whose world is frame 20's
    camera, must weld into the old one, whose world is frame 0's."""
    seq = loop_seq.result()
    kern = reset_launch_counts()
    matrix = hamming_kernel.hamming_penalty_matrix
    system = make_system(seq, device, vocabulary=None)
    lc, atlas = system.loop_closer, system.atlas
    merge, log = [], []
    watch_merge(lc, merge)
    for f in seq.frames[:N_MERGE_TRACKED]:
        log.append(tracker_step(system.tracker, f, entry=system))
    check(all(r["state"] == "OK" for r in log), "phase 20b: a frame before the loss not OK")
    n_kf = atlas.current.n_keyframes()
    blank = np.full_like(seq.frames[0].left, 127)
    t = seq.frames[N_MERGE_TRACKED - 1].timestamp
    for _ in range(N_MERGE_BLANK):
        t += 1.0
        log.append(tracker_step(system.tracker, types.SimpleNamespace(
            left=blank, right=blank, timestamp=t), entry=system))
    maps_after_loss = atlas.n_maps()
    again, merged_at = [], None
    revisit = range(MERGE_AGAIN_FROM, MERGE_AGAIN_FROM + N_MERGE_AGAIN)
    for i, j in enumerate(revisit):
        f = seq.frames[j]
        t += 0.05
        merged = lc.n_maps_merged
        again.append(tracker_step(system.tracker, types.SimpleNamespace(
            left=f.left, right=f.right, timestamp=t), entry=system))
        if merged_at is None and lc.n_maps_merged > merged:
            merged_at = i
    system.shutdown()
    check(maps_after_loss == 2 and log[-1]["state"] == "NOT_INITIALIZED",
          f"phase 20b: after {N_MERGE_BLANK} blank frames {maps_after_loss} maps, state "
          f"{log[-1]['state']} (a new map should start)")
    check(all(r["state"] == "OK" for r in again), "phase 20b: a frame fed again not OK")
    check(lc.n_maps_merged == MERGE_JAX_MERGES and atlas.n_maps() == 1 and lc.n_thread_errors == 0,
          f"phase 20b: {lc.n_maps_merged} merges (the JAX package's reading: "
          f"{MERGE_JAX_MERGES}), {atlas.n_maps()} maps left")
    # the merging frame's own pose is logged in the new map's world (the
    # tracker records the frame after the inline mapper, and so the weld, ran)
    after = slice(merged_at + 1, None)
    check(len(again[after]) >= 3, f"phase 20b: merged at frame {merged_at} fed again, too late")

    def ate_of(js, rows):
        return absolute_trajectory_error(
            np.asarray([seq.frames[j].timestamp for j in js]),
            np.asarray([-r["R"].T @ r["t"] for r in rows]), seq.gt_t, seq.gt_pos)["rmse"]

    ate, ate_after = ate_of(revisit, again), ate_of(revisit[after], again[after])
    check(ate <= MERGE_ATE_LIMIT_M,
          f"phase 20b: ATE RMSE of the frames fed again {ate:.4f} m, limit {MERGE_ATE_LIMIT_M} "
          f"(twice the JAX package's reading)")
    welded = [x for x in merge if x["welded"]]
    check(welded and welded[0]["k2"] >= 1 and welded[0]["matrix"] >= 1,
          f"phase 20b: the merge's launches {merge}")
    errors = [centre_error(seq, r["R"], r["t"], j) for j, r in zip(revisit, again)]
    offset, errors = min(errors[:merged_at + 1]), errors[after]
    check(offset > 1.0, f"phase 20b: before the merge the camera centres {offset:.4f} m from the "
          f"truth in the old map's world (the new map's world should be offset by 1.47 m)")
    check(max(errors) <= MERGE_CENTRE_LIMIT_M,
          f"phase 20b: after the merge a camera centre {max(errors):.4f} m from the truth in the "
          f"old map's world, limit {MERGE_CENTRE_LIMIT_M} (twice the JAX package's reading)")
    print(
        f"phase 20b Atlas map merge in System(Sensor.STEREO) with the shipped vocabulary on "
        f"{card}: frames 0-{N_MERGE_TRACKED - 1} of the rendered loop ({n_kf} keyframes), "
        f"{N_MERGE_BLANK} blank frames 1 s apart -> {maps_after_loss} maps, frames "
        f"{revisit[0]}-{revisit[-1]} again: merged at frame {merged_at} fed again (the JAX "
        f"package's reading: 1 merge, at frame 4), maps left {atlas.n_maps()}, keyframes "
        f"{atlas.current.n_keyframes()}, global BAs {lc.n_gba_runs}; merge attempts "
        f"{[(x['welded'], round(x['ms'], 1)) for x in merge]} (welded, ms with the global BA), "
        f"the merging frame {again[merged_at]['ms']:.1f} ms; ATE RMSE of the frames fed again "
        f"{ate:.4f} m (limit {MERGE_ATE_LIMIT_M}), of those after the merging frame "
        f"{ate_after:.4f} m (the JAX package's reading {MERGE_JAX_ATE_AFTER_M}); the camera "
        f"centres up to the merging frame at least {offset:.4f} m "
        f"from the truth in the old map's world (the new map's offset), after it at most "
        f"{max(errors):.4f} m (limit {MERGE_CENTRE_LIMIT_M}); the merge's launches "
        f"K = 2 {welded[0]['k2']}, matrix {welded[0]['matrix']}; top-k kernel launches "
        f"{kern.launches} ({dict(kern.launches_by_k)} by K), matrix kernel launches "
        f"{matrix.launches}"
    )
    return kern.launches, matrix.launches, welded[0]


def phase_loop_threads(device, card):
    """(a) The loop-closer and global-BA threads on the card: the drifted
    map fed through insert_keyframe from this thread to
    LoopCloser(run_async=True), the loop closing on the closer's thread;
    then tests/test_gba_merge.py::test_gba_off_critical_path's drifted leg,
    its global BA on its own thread while 4 keyframes go into the map under
    its lock."""
    atlas, out, back, descs, drift = drifted_loop_scene(slam_map)
    voc = train_vocabulary(np.concatenate([descs, descs]), n_words=64, iters=2, device=device)
    kern, matrix = reset_launch_counts(), hamming_kernel.hamming_penalty_matrix
    lc = loop_closing.LoopCloser(atlas, voc, LOOP_K, camera=loop_scene_camera(device), bf=1.0,
                                 run_gba=True, min_consistency=2, run_async=True, device=device)
    threads, inner = [], lc.process_keyframe

    def process_keyframe(kid):
        threads.append(threading.current_thread())
        return inner(kid)

    lc.process_keyframe = process_keyframe
    before = drift(back)
    t0 = time.perf_counter()
    for kf in out + back:
        lc.insert_keyframe(kf)
    while len(threads) < len(out + back) or not lc._queue.empty() or lc.n_gba_runs < 1 \
            or (lc._gba_thread is not None and lc._gba_thread.is_alive()):
        check(time.perf_counter() - t0 < 120, "phase 21a: the closer did not finish in 120 s")
        time.sleep(0.005)
    closed_s = time.perf_counter() - t0
    lc.stop()
    check(lc.n_loops_closed == 1 and all(t is lc._thread for t in threads)
          and not lc._thread.is_alive() and not lc._gba_thread.is_alive()
          and lc.n_thread_errors == 0,
          f"phase 21a: loops {lc.n_loops_closed}, threads {set(t.name for t in threads)}, "
          f"errors {lc.n_thread_errors}")
    after = drift(back)
    check(after < DRIFT_RATIO * before, f"phase 21a: drift {before:.4f} -> {after:.4f} m")
    closer_launches = {"topk": kern.launches, "k1": kern.launches_by_k[1],
                       "k2": kern.launches_by_k[2], "matrix": matrix.launches}

    atlas, kfs, pts_w, descs = noisy_leg_scene(slam_map)
    m = atlas.current
    e0 = mean_reprojection_error(m)
    orig = sorted(m.keyframes)
    gba = loop_closing.LoopCloser(atlas, None, LOOP_K, camera=loop_scene_camera(device), bf=1.0,
                                  run_async=True, run_gba=True, device=device)
    t0 = time.perf_counter()
    gba._start_gba(fixed_kf_ids={kfs[0].kid})
    check(gba._gba_thread.is_alive(), "phase 21a: the global BA thread did not start")
    inserted_ms = []
    for i in range(4):
        t1 = time.perf_counter()
        with m.lock:
            synthetic._loop_leg(slam_map, atlas, pts_w, descs, 1, kf_x0=4.0 + 0.4 * i)
        inserted_ms.append((time.perf_counter() - t1) * 1e3)
        time.sleep(0.02)
    gba._gba_thread.join(timeout=300)
    gba_s = time.perf_counter() - t0
    gba.stop()
    e1 = mean_reprojection_error(m, orig)
    check(not gba._gba_thread.is_alive() and not gba._thread.is_alive() and gba.n_gba_runs == 1
          and gba.n_thread_errors == 0 and len(m.keyframes) == len(orig) + 4,
          "phase 21a: the global BA thread did not finish, or a thread failed")
    check(e1 < 0.5 * e0, f"phase 21a: reprojection error {e0:.3f} -> {e1:.3f} px (limit 0.5 x)")
    print(
        f"phase 21a threads on {card}: the drifted map's 9 keyframes through "
        f"insert_keyframe -> the closer's thread: loop closed at keyframe {lc.last_loop_kf_id}, "
        f"global BA on its own thread, drift {before:.4f} -> {after:.4f} m, all done "
        f"{closed_s:.2f} s after the first insert, launches {closer_launches}; a drifted "
        f"12-keyframe leg's global BA on its thread while 4 keyframes went into the map under "
        f"its lock (each insert waited {max(inserted_ms):.1f} ms at most): joined after "
        f"{gba_s:.2f} s, reprojection error {e0:.3f} -> {e1:.3f} px (limit 0.5 x); threads "
        f"joined, errors {lc.n_thread_errors + gba.n_thread_errors}"
    )
    return closer_launches


def phase_system_inertial_async(device, seq, card, atlas_path):
    """(b) The stereo-inertial System in its default configuration with
    mapping on its own thread: the tracker's thread, the mapper's and the
    loop closer's (and a global BA's, if a loop closes) share the card and
    the map. Its settings name `atlas_path` to save the atlas to on
    shutdown (phase 27b loads it)."""
    kern = reset_launch_counts()
    matrix = hamming_kernel.hamming_penalty_matrix
    system = make_inertial_system(seq, device, vocabulary=None, async_mapping=True,
                                  save_atlas=atlas_path)
    mapper, lc = system.local_mapper, system.loop_closer
    inserted, inner = [], mapper.insert_keyframe

    def insert_keyframe(kf):
        inserted.append(kf.kid)
        inner(kf)

    mapper.insert_keyframe = insert_keyframe
    times, t_prev, depth = [], -1.0, 0
    for i, f in enumerate(seq.frames[:N_ASYNC_INERTIAL_FRAMES]):
        n = len(inserted)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        system.track_stereo(f.left, f.right, f.timestamp, imu=imu_between(seq, t_prev, f.timestamp))
        times.append(((time.perf_counter() - t0) * 1e3, len(inserted) > n))
        t_prev = f.timestamp
        depth = max(depth, mapper.queue_size())
        check(system.tracking_state.name == "OK",
              f"phase 21b frame {i}: state {system.tracking_state.name}")
    t0 = time.perf_counter()
    while not (mapper.is_idle() and lc._queue.empty()):
        check(time.perf_counter() - t0 < 120, "phase 21b: the queues did not drain in 120 s")
        time.sleep(0.005)
    drain = time.perf_counter() - t0
    system.shutdown()
    alive = [name for name, t in (("mapper", mapper._thread), ("loop closer", lc._thread),
                                  ("global BA", lc._gba_thread)) if t is not None and t.is_alive()]
    check(not alive and mapper.queue_size() == 0, f"phase 21b: alive after shutdown: {alive}")
    check(os.path.isfile(atlas_path), f"phase 21b: shutdown wrote no atlas to {atlas_path}")
    check(lc.n_thread_errors == 0, f"phase 21b: {lc.n_thread_errors} thread errors")
    check(system.atlas.current.imu_initialized, "phase 21b: the IMU never initialized")
    processed = int(sum(system.stats.series["lm_keyframes"]))
    check(processed == len(inserted) >= 6, f"{processed} keyframes processed, {len(inserted)} inserted")
    ate = trajectory_ate(system.tracker.trajectory, seq)
    check(ate["n"] == N_ASYNC_INERTIAL_FRAMES and ate["rmse"] <= ATE_LIMIT_M,
          f"phase 21b: ATE RMSE {ate['rmse']:.4f} m over {ate['n']} frames, limit {ATE_LIMIT_M}")
    plain = [ms for ms, kf in times[2:] if not kf]
    keyframed = [ms for ms, kf in times[1:] if kf]
    print(
        f"phase 21b stereo-inertial system, async mapping, the shipped vocabulary: "
        f"{N_ASYNC_INERTIAL_FRAMES} frames at {W}x{H} with IMU on {card}: every frame OK, IMU "
        f"initialized, ms/frame median {np.median(plain):.3f}, p90 {np.percentile(plain, 90):.3f} "
        f"({len(plain)} frames without a keyframe), keyframe frames {[round(x, 1) for x in keyframed]}; "
        f"keyframes inserted {len(inserted)}, processed {processed}, deepest mapper queue {depth}, "
        f"queues drained {drain * 1e3:.1f} ms after the last frame; the loop closer: loops "
        f"{lc.n_loops_closed}, merges {lc.n_maps_merged}, global BAs {lc.n_gba_runs}; no thread alive after shutdown, thread errors {lc.n_thread_errors}; "
        f"ATE RMSE {ate['rmse']:.4f} m (limit {ATE_LIMIT_M}); top-k kernel launches "
        f"{kern.launches} ({dict(kern.launches_by_k)} by K), matrix kernel launches "
        f"{matrix.launches} (all threads)"
    )
    return kern.launches, matrix.launches


def rig_settings(seq, rig, device, width, height, **kw) -> Settings:
    """A user's settings for a rendered rig (datasets.synthetic.Rig): both
    cameras, the radtan coefficients of a pinhole pair, the extrinsic, the
    body rotated from camera 1 (T_b_c1), the IMU at 200 Hz, 8 levels and
    1024 features."""
    T_b_c1 = np.eye(4)
    T_b_c1[:3, :3] = rig.R_bc
    make = make_pinhole if rig.kind == "radtan" else make_kannala_brandt8
    return Settings(
        camera_type="PinHole" if rig.kind == "radtan" else "KannalaBrandt8",
        camera1=make(*rig.params1, width, height, device=device),
        camera2=make(*rig.params2, width, height, device=device),
        dist1=rig.dist1, dist2=rig.dist2, T_c1_c2=rig.T_c1_c2,
        bf=seq.fx * seq.baseline, baseline=seq.baseline, width=width, height=height,
        n_features=CFG.n_features, n_levels=CFG.n_levels, scale_factor=CFG.scale_factor,
        T_b_c1=T_b_c1, imu_frequency=200.0, **kw,
    )


def run_rig(system, seq, n, inertial, stages=None):
    """The first `n` frames of `seq` through `system` (with their IMU
    samples if `inertial`), one tracker_step row each, with the stage
    launches of the frame when `stages` (watch_tracker_stages' counts) is
    given."""
    log, t_prev = [], -1.0
    for f in seq.frames[:n]:
        before = stage_snapshot(stages) if stages is not None else None
        imu = imu_between(seq, t_prev, f.timestamp) if inertial else None
        r = tracker_step(system.tracker, f, entry=system, imu=imu if inertial else None)
        r["imu_initialized"] = bool(system.atlas.current.imu_initialized)
        if stages is not None:
            r["stages"] = stage_delta(stage_snapshot(stages), before)
        log.append(r)
        t_prev = f.timestamp
    return log


def rig_report(log, system, seq, name):
    """Checks shared by phases 22a and 23a: every frame OK with a finite
    pose, the IMU initialized, |bg| (the stream has none), the ATE over all
    frames and over those up to the init; returns
    (init frame, ATE, ms/frame median and p90 of the frames after the
    first two, of fused and stepwise frames)."""
    for i, r in enumerate(log):
        check(r["state"] == "OK", f"{name} frame {i}: state {r['state']}")
        check(np.isfinite(r["R"]).all() and np.isfinite(r["t"]).all(), f"{name} frame {i}: pose")
    check(any(r["imu_initialized"] for r in log), f"{name}: the IMU never initialized")
    init = next(i for i, r in enumerate(log) if r["imu_initialized"])
    bg = system.tracker.bias[0]
    check(np.linalg.norm(bg) < 0.05, f"{name}: gyro bias {bg} (the stream has none)")
    ate = trajectory_ate(system.tracker.trajectory, seq)
    check(ate["n"] == len(log) and ate["rmse"] <= ATE_LIMIT_M,
          f"{name}: ATE RMSE {ate['rmse']:.4f} m over {ate['n']} frames, limit {ATE_LIMIT_M} m")

    times = {"all frames": frame_ms(log[2:]),
             "fused": frame_ms([r for r in log[2:] if r["path"] == "fused"]),
             "stepwise": frame_ms([r for r in log[2:] if r["path"] == "stepwise"])}
    # the trajectory keeps each frame's pose as tracked: frames up to the
    # init are in the world before its rotation, the others after it
    traj = system.tracker.trajectory
    ate["rmse_before_init"] = trajectory_ate(traj[:init + 1], seq)["rmse"]
    check(ate["rmse_before_init"] <= ATE_LIMIT_M,
          f"{name}: ATE RMSE up to the IMU init {ate['rmse_before_init']:.4f} m, limit "
          f"{ATE_LIMIT_M} m")
    # the yardstick for the ATE: the ground truth's own RMS motion about its mean
    gt = np.asarray(seq.gt_pos[:len(log)])
    ate["rms_motion"] = float(np.sqrt(((gt - gt.mean(0)) ** 2).sum(1).mean()))
    ate["rmse_after_init"] = trajectory_ate(traj[init + 1:], seq)["rmse"]
    return init, ate, times, bg


def phase_rectified_inertial(device, seq, rig, card):
    """EuRoC's rig as distributed: System(Sensor.IMU_STEREO) in its default
    configuration (the shipped vocabulary) over a distorted pinhole pair
    with a rotated extrinsic, rectified at start-up (the remap tables once,
    both images remapped on the host every frame) and the IMU extrinsic
    composed with the rectifying rotation (ROADMAP F10)."""
    kern = reset_launch_counts()
    matrix = hamming_kernel.hamming_penalty_matrix
    system = System(rig_settings(seq, rig, device, W, H), Sensor.IMU_STEREO, device=device)
    check(system._rect is not None, "phase 22a: the pair was not rectified")
    R1 = system._rect.R1
    r1_deg = float(np.degrees(np.arccos(np.clip((np.trace(R1) - 1) / 2, -1, 1))))
    log = run_rig(system, seq, N_RIG_FRAMES, inertial=True)
    system.shutdown()
    init, ate, times, bg = rig_report(log, system, seq, "phase 22a")
    remap = system.stats.series["rectify_remap"]
    check(len(remap) == N_RIG_FRAMES, f"phase 22a: {len(remap)} remapped frames")
    fused = [r for r in log if r["path"] == "fused"]
    for r in fused:
        check(r["fetches"] == 1, f"phase 22a: {r['fetches']} fetches on a fused frame")
    print(
        f"phase 22a{BESIDE} rectified EuRoC pair, stereo-inertial, default configuration: "
        f"{len(log)} rendered {W}x{H} frames of a radtan pair (camera 2 rotated "
        f"0.8 deg; R1 {r1_deg:.3f} deg; new fx {float(system.tracker.camera.params[0]):.3f}, "
        f"bf {system.settings.bf:.4f}) through System.track_stereo(..., imu=...) on {card}: "
        f"every frame OK; IMU initialized at frame {init}, |bg| {np.linalg.norm(bg):.5f} "
        f"rad/s; {len(fused)} fused frames (1 fetch each); ATE RMSE {ate['rmse']:.4f} m "
        f"(limit {ATE_LIMIT_M}; the trajectory moves {ate['rms_motion']:.4f} m RMS; up to "
        f"init {ate['rmse_before_init']:.4f}, after it "
        f"{ate['rmse_after_init']:.4f}); ms/frame median, p90 (count), the remap included: "
        + "; ".join(f"{k} {v[0]:.3f}, {v[1]:.3f} ({v[2]})" for k, v in times.items())
        + f"; the host remap of both images alone: median {np.median(remap):.3f} ms, p90 "
        f"{np.percentile(remap, 90):.3f} ms; keyframes {system.atlas.current.n_keyframes()}; "
        f"top-k launches {kern.launches} ({dict(kern.launches_by_k)} by K), matrix launches "
        f"{matrix.launches}"
    )
    return kern.launches, matrix.launches


def phase_resize(device, seq, rig, card):
    """Camera.newWidth / newHeight: the visual System (the shipped
    vocabulary) given the same distorted pair at 752x480 and asked for
    376x240: the intrinsics scaled once, every frame resized on the host,
    then rectified at the working size."""
    kern = reset_launch_counts()
    matrix = hamming_kernel.hamming_penalty_matrix
    w, h = RESIZE_TO
    system = System(rig_settings(seq, rig, device, W, H, new_width=w, new_height=h),
                    Sensor.STEREO, device=device)
    check(system.tracker.cfg.width == w and system.tracker.cfg.height == h
          and system._rect is not None, "phase 22b: not resized and rectified")
    log = run_rig(system, seq, N_RESIZE_FRAMES, inertial=False)
    system.shutdown()
    for i, r in enumerate(log):
        check(r["state"] == "OK", f"phase 22b frame {i}: state {r['state']}")
    ate = trajectory_ate(system.tracker.trajectory, seq)
    check(ate["n"] == N_RESIZE_FRAMES and ate["rmse"] <= ATE_LIMIT_M,
          f"phase 22b: ATE RMSE {ate['rmse']:.4f} m over {ate['n']} frames, limit {ATE_LIMIT_M} m")
    times = [r["ms"] for r in log[2:]]
    series = system.stats.series
    print(
        f"phase 22b{BESIDE} input resize: {N_RESIZE_FRAMES} frames of phase 22a's {W}x{H} pair through "
        f"System(Sensor.STEREO) asked for {w}x{h} on {card}: every frame OK; ATE RMSE "
        f"{ate['rmse']:.4f} m (limit {ATE_LIMIT_M}); ms/frame median {np.median(times):.3f}, p90 "
        f"{np.percentile(times, 90):.3f} over {len(times)}, of it on the host: resize "
        f"{np.median(series['input_resize']):.3f} ms, remap {np.median(series['rectify_remap']):.3f} "
        f"ms (medians); keyframes {system.atlas.current.n_keyframes()}; top-k launches "
        f"{kern.launches}, matrix launches {matrix.launches}"
    )
    return kern.launches, matrix.launches


FISHEYE_STAGE = ("fisheye", frame_pipeline, "match_fisheye")   # the fisheye frame's K = 2


def phase_fisheye_inertial(device, seq, rig, card):
    """TUM-VI's rig as distributed: System(Sensor.IMU_STEREO) in its default
    configuration over a KB8 fisheye pair, which takes the fisheye route:
    both images extracted on the card, the pair matched by one launch of
    the top-K kernel at K = 2 and triangulated there, depth where the match
    passes the parallax and reprojection gates."""
    kern = reset_launch_counts()
    matrix = hamming_kernel.hamming_penalty_matrix
    system = System(rig_settings(seq, rig, device, KB8_SIZE, KB8_SIZE), Sensor.IMU_STEREO,
                    device=device)
    check(system.tracker.stereo_rig is not None, "phase 23a: no fisheye rig")
    lc_rows = []
    watch_loop_closer(system.loop_closer, lc_rows)
    stages, restore = watch_tracker_stages(TRACKER_STAGES + (FISHEYE_STAGE,))
    try:
        log = run_rig(system, seq, N_RIG_FRAMES, inertial=True, stages=stages)
    finally:
        restore()
    system.shutdown()
    init, ate, times, bg = rig_report(log, system, seq, "phase 23a")
    first = log[0]
    check(first["stereo"] >= MIN_FISHEYE_DEPTHS,
          f"phase 23a: {first['stereo']} keypoints with a triangulated depth on frame 0")
    for i, r in enumerate(log):
        st = r["stages"]
        check(st["fisheye"][2] == 1 and st["fisheye"][0] == 1,
              f"phase 23a frame {i}: {st['fisheye'][0]} K = 2 launches in {st['fisheye'][2]} "
              "fisheye matches, not one")
        if r["path"] == "fused":
            check(r["fetches"] == 1, f"phase 23a frame {i}: {r['fetches']} fetches, fused")
    fused = [r for r in log if r["path"] == "fused"]
    after = log[init + 1:]
    # the inertial fused step through a KB8 camera (tlm_step_vi)
    check(any(r["path"] == "fused" for r in after),
          "phase 23a: no fused frame after the IMU init")
    stepwise_after = sum(r["path"] == "stepwise" for r in after)
    k2_fisheye = sum(r["stages"]["fisheye"][0] for r in log)
    print(
        f"phase 23a{BESIDE} KB8 fisheye pair, stereo-inertial, default configuration: {len(log)} "
        f"rendered {KB8_SIZE}x{KB8_SIZE} frames through System.track_stereo(..., imu=...) on "
        f"{card}: every frame OK; frame 0: {first['stereo']} keypoints with a triangulated "
        f"depth; one K = 2 launch (match_fisheye) per frame, {k2_fisheye} in all; IMU "
        f"initialized at frame {init}, |bg| {np.linalg.norm(bg):.5f} rad/s; {len(fused)} fused "
        f"frames (1 fetch each), {stepwise_after} of the {len(after)} frames after init "
        f"stepwise; keyframes processed {int(sum(system.stats.series['lm_keyframes']))}; "
        f"ATE RMSE {ate['rmse']:.4f} m (limit {ATE_LIMIT_M}; the trajectory moves "
        f"{ate['rms_motion']:.4f} m RMS; up to init {ate['rmse_before_init']:.4f}, after it "
        f"{ate['rmse_after_init']:.4f}) with {int(sum(system.stats.series['lm_ba_steps_rejected']))} "
        f"local-BA steps rejected behind the cameras (ROADMAP F24) in "
        f"{int(sum(system.stats.series['lm_local_bas']))} visual local BAs; ms/frame "
        f"median, p90 (count): "
        + "; ".join(f"{k} {v[0]:.3f}, {v[1]:.3f} ({v[2]})" for k, v in times.items())
        + f"; keyframes {system.atlas.current.n_keyframes()}, map points "
        f"{system.atlas.current.n_mappoints()}; top-k launches {kern.launches} "
        f"({dict(kern.launches_by_k)} by K), matrix launches {matrix.launches}; the loop "
        f"closer {len(lc_rows)} keyframes"
    )
    return kern.launches, matrix.launches, k2_fisheye


def phase_fisheye_card_vs_cpu(device, seq, rig, card):
    """The first frames of the KB8 pair through the visual System on the
    card and through System(device="cpu"): the same state, path and
    keyframes per frame, poses within 1e-3."""
    kern = reset_launch_counts()
    matrix = hamming_kernel.hamming_penalty_matrix
    logs = []
    for dev in (device, "cpu"):
        system = System(rig_settings(seq, rig, dev, KB8_SIZE, KB8_SIZE), Sensor.STEREO,
                        vocabulary=False, device=dev)
        logs.append(run_rig(system, seq, N_FISHEYE_CPU_FRAMES, inertial=False))
        system.shutdown()
        if dev == device:
            launches = (kern.launches, matrix.launches)
    worst = {"frames": N_FISHEYE_CPU_FRAMES, "pose_R_maxdiff": 0.0, "pose_t_maxdiff": 0.0}
    for i, (gpu, cpu) in enumerate(zip(*logs)):
        dR = float(np.abs(cpu["R"] - gpu["R"]).max())
        dt = float(np.abs(cpu["t"] - gpu["t"]).max())
        check((cpu["state"], cpu["path"], cpu["keyframes"]) == (gpu["state"], gpu["path"],
                                                                gpu["keyframes"])
              and dR < 1e-3 and dt < 1e-3,
              f"phase 23b frame {i}: CPU {cpu['state']}, {cpu['path']}, {cpu['keyframes']} "
              f"keyframes; card {gpu['state']}, {gpu['path']}, {gpu['keyframes']}; pose diff "
              f"{dR:.2e}, {dt:.2e}")
        worst["pose_R_maxdiff"] = max(worst["pose_R_maxdiff"], dR)
        worst["pose_t_maxdiff"] = max(worst["pose_t_maxdiff"], dt)
    worst["paths"] = [r["path"] for r in logs[0]]
    print(f"phase 23b KB8 fisheye pair, the visual System card against CPU ({card}): "
          f"{json.dumps(worst)}")
    return launches


def mono_settings(seq, device) -> Settings:
    """A user's monocular settings for phase 10's rendered camera: 8 levels,
    1024 features, no stereo baseline."""
    return Settings(camera1=make_pinhole(seq.fx, seq.fy, seq.cx, seq.cy, W, H, device=device),
                    bf=0.0, width=W, height=H, n_features=CFG.n_features,
                    n_levels=CFG.n_levels, scale_factor=CFG.scale_factor)


INIT_STAGE = ("init", tracking, "search_by_projection")   # the initializer's level-0 search


def run_mono(system, seq, n, keyframes=None, stages=None):
    """The first `n` frames of `seq` through `system.track_monocular`, one
    tracker_step row each, with the keyframes the frame handed to the
    mapper (watch_mapper's rows) and its stage launches when given."""
    log = []
    for f in seq.frames[:n]:
        before = stage_snapshot(stages) if stages is not None else None
        n_kf = len(keyframes) if keyframes is not None else 0
        r = tracker_step(system.tracker, f, entry=system, mono=True)
        r["mapped"] = keyframes[n_kf:] if keyframes is not None else []
        if stages is not None:
            r["stages"] = stage_delta(stage_snapshot(stages), before)
        log.append(r)
    return log


def sim3_ate(trajectory, seq):
    if len(trajectory) < 3:
        return None
    return absolute_trajectory_error(
        np.asarray([t for t, _, _ in trajectory]),
        np.asarray([-R.T @ t_ for _, R, t_ in trajectory]),
        seq.gt_t, seq.gt_pos, with_scale=True)


def phase_mono_system(device, seq, card):
    """The visual monocular System (M9b) in its default configuration on the
    card: two-view initialization, the fused frames, the mapper's epipolar
    triangulation as the only source of points, the loop closer with a free
    scale; the gates from the JAX package's reading (MONO_JAX)."""
    kern = reset_launch_counts()
    matrix = hamming_kernel.hamming_penalty_matrix
    system = System(mono_settings(seq, device), Sensor.MONOCULAR, device=device)
    check(system.tracker.monocular and system.loop_closer.fix_scale is False,
          "phase 24a: not a monocular System with a free-scale loop closer")
    keyframes, lc_rows, attempts = [], [], []
    watch_mapper(system, keyframes)
    watch_loop_closer(system.loop_closer, lc_rows)
    inner_tv = tracking.reconstruct_two_view

    def two_view(p1, p2, K, **kw):
        topk, mat = kern.launches, matrix.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = inner_tv(p1, p2, K, **kw)
        torch.cuda.synchronize()
        attempts.append({"ms": (time.perf_counter() - t0) * 1e3, "success": res.success,
                         "homography": res.used_homography, "matches": len(p1),
                         "inliers": res.n_inliers, "scores": res.scores,
                         "good": int(res.good_mask.sum()), "parallax_deg": res.parallax_deg,
                         "launches": kern.launches - topk + matrix.launches - mat,
                         "inputs": (p1, p2, K)})
        return res

    tracking.reconstruct_two_view = two_view
    stages, restore = watch_tracker_stages(TRACKER_STAGES + (INIT_STAGE,))
    try:
        log = run_mono(system, seq, N_MONO_FRAMES, keyframes, stages)
    finally:
        restore()
        tracking.reconstruct_two_view = inner_tv
    system.shutdown()

    states = [r["state"] for r in log]
    check("OK" in states, f"phase 24a: never initialized: {''.join(s[0] for s in states)}")
    init = states.index("OK")
    loss = next((i for i in range(init, len(states)) if states[i] != "OK"), None)
    n_ok = states.count("OK")
    for i, r in enumerate(log):
        if r["R"] is not None:
            check(np.isfinite(r["R"]).all() and np.isfinite(r["t"]).all(), f"phase 24a frame {i}: pose")
        if r["path"] == "fused":
            check(r["fetches"] == 1, f"phase 24a frame {i}: {r['fetches']} tracker fetches, fused")
    check(attempts and attempts[-1]["success"], "phase 24a: no successful two-view attempt")
    traj = system.tracker.trajectory
    ate = sim3_ate(traj, seq)
    jax_loss = MONO_JAX["first_loss"]
    t_cut = seq.frames[jax_loss].timestamp if jax_loss is not None else np.inf
    ate_cut = sim3_ate([e for e in traj if e[0] < t_cut], seq)
    check(abs(init - MONO_JAX["init_frame"]) <= MONO_INIT_SLACK,
          f"phase 24a: initialized at frame {init}, the JAX package at {MONO_JAX['init_frame']}")
    check(n_ok >= MONO_JAX["frames_ok"] - MONO_OK_SLACK,
          f"phase 24a: {n_ok} OK frames, the JAX package {MONO_JAX['frames_ok']}")
    ate_limit = MONO_ATE_FACTOR * MONO_JAX["ate_m"]
    check(ate_cut is not None and ate_cut["rmse"] <= ate_limit,
          f"phase 24a: Sim(3) ATE up to the JAX package's first loss "
          f"{None if ate_cut is None else round(ate_cut['rmse'], 4)} m, limit {ate_limit:.4f} m")
    check(kern.launches > 0 and matrix.launches > 0, "phase 24a: a kernel was not launched")

    after = log[init + 1:]
    unmapped = [r for r in after if not r["mapped"]]
    times = {"fused": frame_ms([r for r in unmapped if r["path"] == "fused"]),
             "stepwise": frame_ms([r for r in unmapped if r["path"] == "stepwise"]),
             "keyframe": frame_ms([r for r in after if r["mapped"]])}
    fused = [r for r in log if r["path"] == "fused"]
    # [top-k, matrix] launches of each tracker stage
    by_stage = {name: [sum(r["stages"][name][j] for r in log) for j in (0, 1)] for name in stages}
    mapper = {"triangulation (10240 rows)": sum(k["topk_epi_rows"] for k in keyframes),
              "mapper top-k all": sum(k["topk"] for k in keyframes),
              "fusion (matrix)": sum(k["matrix"] for k in keyframes)}
    closer = {k: sum(r[k] for r in lc_rows) for k in ("k1", "k2", "matrix")}
    gt = np.asarray(seq.gt_pos[:len(log)])
    rms_motion = float(np.sqrt(((gt - gt.mean(0)) ** 2).sum(1).mean()))
    ok_attempt = attempts[-1]
    series = system.stats.series
    print(
        f"phase 24a{BESIDE} monocular System, default configuration: {len(log)} frames of phase 10's "
        f"{W}x{H} sequence through System(Sensor.MONOCULAR).track_monocular on {card}: states "
        f"{''.join(s[0] for s in states)}; initialized at frame {init} (the JAX package "
        f"{MONO_JAX['init_frame']}), {n_ok - 1} OK frames after it ({n_ok} OK in all; the JAX "
        f"package {MONO_JAX['frames_ok']}), first loss after the init {loss}; two-view attempts "
        f"{len(attempts)}, the successful one "
        f"{'H' if ok_attempt['homography'] else 'F'} from {ok_attempt['matches']} matches "
        f"(SH {ok_attempt['scores'][0]:.1f}, SF {ok_attempt['scores'][1]:.1f}; "
        f"{ok_attempt['inliers']} inliers), {ok_attempt['good']} points, parallax "
        f"{ok_attempt['parallax_deg']:.3f} deg, "
        f"{ok_attempt['ms']:.1f} ms (all attempts: median "
        f"{np.median([a['ms'] for a in attempts]):.1f} ms; Hamming launches in them "
        f"{sum(a['launches'] for a in attempts)}); the init frame {log[init]['ms']:.1f} ms; "
        f"keyframes {system.atlas.current.n_keyframes()} ({len(keyframes)} processed), map points "
        f"{system.atlas.current.n_mappoints()}, points triangulated "
        f"{int(sum(series['lm_points_triangulated']))}, local BAs {int(sum(series['lm_local_bas']))} "
        f"with {int(sum(series['lm_ba_steps_rejected']))} steps rejected behind the cameras; "
        f"Sim(3) ATE RMSE {ate['rmse']:.4f} m at scale {ate['scale']:.4f} over {ate['n']} frames, "
        f"up to the JAX package's first loss {ate_cut['rmse']:.4f} m over {ate_cut['n']} (limit "
        f"{ate_limit:.4f}), the trajectory moves {rms_motion:.4f} m RMS; ms/frame median, p90 "
        f"(count) after the init: "
        + "; ".join(f"{k} {v[0]:.3f}, {v[1]:.3f} ({v[2]})" for k, v in times.items())
        + f"; {len(fused)} fused frames, 1 fetch each; top-k launches {kern.launches} "
        f"({dict(kern.launches_by_k)} by K), by stage: tracker {by_stage}, mapper {mapper}, loop "
        f"closer {closer} over {len(lc_rows)} keyframes ({sum(r['closed'] for r in lc_rows)} "
        f"loops); matrix launches {matrix.launches}"
    )
    return kern.launches, matrix.launches, ok_attempt["inputs"]


def phase_mono_card_vs_cpu(device, seq, card, init_inputs):
    """(a) reconstruct_two_view on phase 24a's initialization
    correspondences, on the card and on the CPU: the same model and
    success, R within 1e-3 rad, good_mask on >= 99% of the points; its ms
    and its kernel launches on the card (ROADMAP K17); (b) the first
    N_MONO_CPU_FRAMES frames through the monocular System on the card and
    on the CPU: the same state on every frame, camera centres within 1e-3
    (the map's scale: its median depth at the init is 1, in both)."""
    from fasttrack_tpu_torch.optim.two_view import reconstruct_two_view

    p1, p2, K = init_inputs
    card_res = reconstruct_two_view(p1, p2, K, device=device)
    cpu_res = reconstruct_two_view(p1, p2, K, device="cpu")
    dR = float(np.arccos(np.clip((np.trace(card_res.R.T @ cpu_res.R) - 1) / 2, -1, 1)))
    agree = float(np.mean(card_res.good_mask == cpu_res.good_mask))
    check((card_res.success, card_res.used_homography) == (cpu_res.success,
                                                            cpu_res.used_homography)
          and dR < 1e-3 and agree >= 0.99,
          f"phase 24b two-view: card {card_res.success}/{card_res.used_homography}, CPU "
          f"{cpu_res.success}/{cpu_res.used_homography}, R {dR:.2e} rad, good_mask {agree:.4f}")
    host_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reconstruct_two_view(p1, p2, K, device=device)
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        reconstruct_two_view(p1, p2, K, device=device)
        torch.cuda.synchronize()
    k17_launches = len(device_kernels(prof)) or None      # None: the tracer delivered nothing
    k17_busy = sum(k.time_range.elapsed_us() for k in device_kernels(prof)) / 1e3

    kern = reset_launch_counts()
    matrix = hamming_kernel.hamming_penalty_matrix
    logs = []
    for dev in (device, "cpu"):
        system = System(mono_settings(seq, dev), Sensor.MONOCULAR, device=dev)
        logs.append(run_mono(system, seq, N_MONO_CPU_FRAMES))
        system.shutdown()
        if dev == device:
            launches = (kern.launches, matrix.launches)
    worst = 0.0
    for i, (gpu, cpu) in enumerate(zip(*logs)):
        check(gpu["state"] == cpu["state"] and (gpu["R"] is None) == (cpu["R"] is None),
              f"phase 24b frame {i}: card {gpu['state']}, CPU {cpu['state']}")
        if gpu["R"] is not None:
            d = float(np.linalg.norm(-gpu["R"].T @ gpu["t"] + cpu["R"].T @ cpu["t"]))
            check(d < 1e-3, f"phase 24b frame {i}: camera centres {d:.2e} apart")
            worst = max(worst, d)
    print(
        f"phase 24b monocular, card against CPU ({card}): two-view on phase 24a's "
        f"{len(p1)} init correspondences: {'H' if card_res.used_homography else 'F'} on both, "
        f"success {card_res.success}, R {dR:.2e} rad apart, good_mask agrees on "
        f"{100 * agree:.2f}%; on the card {host_ms[0]:.1f} ms the first call, then median "
        f"{np.median(host_ms[1:]):.1f} ms (host clock, synchronised; ROADMAP K17), "
        f"{k17_launches} device kernels a call, {k17_busy:.3f} ms of them busy (torch.profiler); "
        f"the System's first {N_MONO_CPU_FRAMES} frames: states "
        f"{''.join(r['state'][0] for r in logs[0])} on both, camera centres at most {worst:.2e} "
        f"apart; top-k launches {launches[0]}, matrix launches {launches[1]} (the card's run)"
    )
    return launches


def phase_mono_inertial_system(device, seq, card):
    """The monocular-inertial System (M9c) in its default configuration on
    the card: the two-view init, the IMU init that gives the map its metric
    scale, the scale refinements, the inertial fused frames; the gates from
    the renderer's truth after the IMU init."""
    kern = reset_launch_counts()
    matrix = hamming_kernel.hamming_penalty_matrix
    settings = dataclasses.replace(mono_settings(seq, device), imu_frequency=200.0,
                                   T_b_c1=np.eye(4))
    system = System(settings, Sensor.IMU_MONOCULAR, device=device)
    check(system.tracker.monocular and system.tracker.use_imu
          and system.loop_closer.fix_scale is True,
          "phase 25a: not a monocular-inertial System with a fixed-scale loop closer")
    keyframes, lc_rows = [], []
    watch_mapper(system, keyframes)
    watch_loop_closer(system.loop_closer, lc_rows)
    rec, restore_rec = record_inertial_programs(keep_flipped=True)
    stages, restore = watch_tracker_stages(TRACKER_STAGES + (INIT_STAGE,))
    log, t_prev = [], -1.0
    series = system.stats.series
    try:
        for f in seq.frames[:N_MI_FRAMES]:
            if series["lm_scale_refinement_scale"]:
                break       # cut for the run's time: the frames after the first refinement
            before = stage_snapshot(stages)
            n_kf = len(keyframes)
            r = tracker_step(system.tracker, f, entry=system, mono=True,
                             imu=imu_between(seq, t_prev, f.timestamp))
            r["mapped"] = keyframes[n_kf:]
            r["stages"] = stage_delta(stage_snapshot(stages), before)
            r["imu_initialized"] = bool(system.atlas.current.imu_initialized)
            log.append(r)
            t_prev = f.timestamp
    finally:
        restore()
        restore_rec()
    system.shutdown()

    states = [r["state"] for r in log]
    state_str = "".join(s[0] for s in states)
    check("OK" in states, f"phase 25a: never initialized: {state_str}")
    init = states.index("OK")
    check(any(r["imu_initialized"] for r in log), f"phase 25a: the IMU never initialized: {state_str}")
    imu_init = next(i for i, r in enumerate(log) if r["imu_initialized"])
    refined = series["lm_scale_refinement_scale"]
    check(len(refined) >= 1, "phase 25a: no scale refinement")
    after = log[imu_init:]
    check(all(r["state"] == "OK" for r in after),
          f"phase 25a: a frame from the IMU init (frame {imu_init}) on is not OK: {state_str}")
    for i, r in enumerate(log):
        if r["R"] is not None:
            check(np.isfinite(r["R"]).all() and np.isfinite(r["t"]).all(), f"phase 25a frame {i}: pose")
        if r["path"] == "fused":
            check(r["imu_initialized"], f"phase 25a frame {i}: fused before the IMU init")
            check(r["fetches"] == 1, f"phase 25a frame {i}: {r['fetches']} tracker fetches, fused")
    fused_at = [imu_init + j for j, r in enumerate(after) if r["path"] == "fused"]
    fused = [log[i] for i in fused_at]
    check(len(fused) >= 1, "phase 25a: no inertial fused frame after the IMU init")
    for r in fused:
        mapper_topk = sum(k["topk"] for k in r["mapped"])
        check(r["launches"] - mapper_topk == 2 and r["launches_k2"] == 0,
              f"phase 25a: a fused frame took {r['launches'] - mapper_topk} tracker top-k "
              f"launches, not 2")
    t_imu = seq.frames[imu_init].timestamp
    part = [e for e in system.tracker.trajectory if e[0] >= t_imu]
    sim3 = sim3_ate(part, seq)
    se3 = trajectory_ate(part, seq)
    check(sim3 is not None and abs(sim3["scale"] - 1.0) <= MI_SCALE_TOL,
          f"phase 25a: Sim(3) scale from the IMU init on {None if sim3 is None else sim3['scale']}")
    check(se3["rmse"] <= MI_ATE_LIMIT_M,
          f"phase 25a: SE(3) ATE from the IMU init on {se3['rmse']:.4f} m, limit {MI_ATE_LIMIT_M} m")
    check(kern.launches > 0 and matrix.launches > 0, "phase 25a: a kernel was not launched")
    check(rec["local_inertial_ba"], "phase 25a recorded no inertial window")

    times = {"stepwise, no keyframe": frame_ms([r for r in log[init + 1:] if r["path"] == "stepwise"
                                           and not r["mapped"]]),
             "fused inertial, no keyframe": frame_ms([r for r in fused if not r["mapped"]]),
             "keyframe": frame_ms([r for r in log[init + 1:] if r["mapped"]])}
    by_stage = {name: [sum(r["stages"][name][j] for r in log) for j in (0, 1)] for name in stages}
    mapper = {"triangulation (10240 rows)": sum(k["topk_epi_rows"] for k in keyframes),
              "mapper top-k all": sum(k["topk"] for k in keyframes),
              "fusion (matrix)": sum(k["matrix"] for k in keyframes)}
    closer = {k: sum(r[k] for r in lc_rows) for k in ("k1", "k2", "matrix")}
    gt = np.asarray(seq.gt_pos[imu_init:len(log)])
    rms_motion = float(np.sqrt(((gt - gt.mean(0)) ** 2).sum(1).mean()))
    m = system.atlas.current
    print(
        f"phase 25a{BESIDE} monocular-inertial System, default configuration: {len(log)} frames of phase "
        f"10's {W}x{H} sequence with their 200 Hz IMU stream through "
        f"System(Sensor.IMU_MONOCULAR).track_monocular(..., imu=...) on {card}: states "
        f"{state_str}; two-view init at frame {init}, IMU init at frame {imu_init} with scale "
        f"{series['lm_imu_init_scale'][0]:.4f}; scale refinements {len(refined)} solving "
        f"{[round(x, 5) for x in refined]}, applied {int(sum(series['lm_scale_applied']))}; from "
        f"the IMU init on {sum(r['state'] == 'OK' for r in after)} of {len(after)} frames OK, Sim(3) "
        f"scale {sim3['scale']:.4f} (1.0 is right) over {sim3['n']} frames, SE(3) ATE RMSE "
        f"{se3['rmse']:.4f} m (limit {MI_ATE_LIMIT_M}) beside their RMS motion {rms_motion:.4f} m; "
        f"keyframes {m.n_keyframes()} ({len(keyframes)} processed), map points {m.n_mappoints()}; "
        f"ms/frame median, p90 (count) after the two-view init: "
        + "; ".join(f"{k} {v[0]:.3f}, {v[1]:.3f} ({v[2]})" for k, v in times.items())
        + f"; {len(fused)} fused inertial frames (frames {fused_at}), "
        f"fetches per fused frame {sum(r['fetches'] for r in fused) / len(fused):.3f}, tracker "
        f"top-k launches 2 each; lm_imu_init ms "
        f"{[round(x, 1) for x in series['lm_imu_init'][-1:]]} (the call that initialized), "
        f"lm_scale_refinement ms {[round(x, 1) for x in series['lm_scale_refinement']]}; inertial "
        f"windows {int(sum(series['lm_inertial_bas']))} with "
        f"{int(sum(series['lm_inertial_steps_flipped']))} steps rejected behind the cameras, visual "
        f"local BAs {int(sum(series['lm_local_bas']))} with {int(sum(series['lm_ba_steps_rejected']))}; "
        f"top-k launches {kern.launches} ({dict(kern.launches_by_k)} by K), by stage: tracker "
        f"{by_stage}, mapper {mapper}, loop closer {closer} over {len(lc_rows)} keyframes; matrix "
        f"launches {matrix.launches}"
    )
    return kern.launches, matrix.launches, rec


def phase_mono_inertial_card_vs_cpu(rec, card):
    """25a's first inertial window after the IMU init, and the first in
    which the card rejected a step that moved a live observation behind its
    camera, solved again on the CPU from the same inputs, in float32 as the
    mapper solves it (P5): the states within phase 14's tolerance and the
    same count of rejected steps."""
    cpu = torch.device("cpu")
    windows = [("the first window after the IMU init", rec["local_inertial_ba"][0])]
    windows += [("the first with a flipped step", w) for w in rec["flipped"]]
    rows = []
    for name, (args, card_res, kw) in windows:
        prob = args[0]
        host = local_inertial_ba(*to_device(args, cpu), **kw)
        d = state_diffs(card_res.states, host.states)
        free = prob.point_free.to(cpu)
        pts = float((card_res.points.to(cpu).double() - host.points.double()).abs()[free].max())
        flipped = (int(card_res.n_flipped), int(host.n_flipped))
        check(prob.points.dtype == torch.float32 and state_close(d),
              f"phase 25b: {name} card against CPU: {d}")
        check(flipped[0] == flipped[1], f"phase 25b: {name}: flipped steps card, CPU {flipped}")
        rows.append(
            f"{name} ({int(prob.state_free.sum())} free states, {int(free.sum())} points, "
            f"{int(prob.mask.sum())} observations, mono edges only: "
            f"{bool((prob.obs_ur < 0).all())}): states max diff {json.dumps(d)}, points "
            f"{pts:.2e}, inlier masks differ on "
            f"{int((card_res.inlier_mask.to(cpu) != host.inlier_mask).sum())}, flipped steps "
            f"{flipped[0]} on both")
    print(f"phase 25b monocular-inertial windows card against CPU ({card}), in float32 on both: "
          + "; ".join(rows) + ("" if rec["flipped"] else "; no window of 25a flipped a step"))


def rgbd_settings(seq, device, inertial=False, size=(RGBD_H, RGBD_W), features=RGBD_FEATURES,
                  levels=8) -> Settings:
    """ORB-SLAM3's TUM1.yaml settings (Camera.bf 40, ThDepth 40, scale 1.2,
    FAST 20/7) for the renderer's undistorted pinhole at `size` (h, w);
    with `inertial` the body frame is the camera's (T_b_c1 = I) at 200 Hz."""
    h, w = size
    kw = dict(T_b_c1=np.eye(4), imu_frequency=200.0) if inertial else {}
    return Settings(camera1=make_pinhole(seq.fx, seq.fy, seq.cx, seq.cy, w, h, device=device),
                    bf=RGBD_BF, th_depth=RGBD_TH_DEPTH, width=w, height=h, n_features=features,
                    n_levels=levels, scale_factor=1.2, ini_th_fast=20.0, min_th_fast=7.0, **kw)


def run_rgbd(system, scene, n, keyframes=None, stages=None, inertial=False):
    """The first `n` frames of the RGB-D scene (sequence, depth maps)
    through `system.track_rgbd`, with their IMU samples if `inertial`: one
    tracker_step row each, with the keyframes the frame handed to the
    mapper, its stage launches when given and whether the IMU is
    initialized after it."""
    seq, depths = scene
    log, t_prev = [], -1.0
    for f, d in zip(seq.frames[:n], depths):
        before = stage_snapshot(stages) if stages is not None else None
        n_kf = len(keyframes) if keyframes is not None else 0
        r = tracker_step(system.tracker, f, entry=system, depth=d,
                         imu=imu_between(seq, t_prev, f.timestamp) if inertial else None)
        r["mapped"] = keyframes[n_kf:] if keyframes is not None else []
        if stages is not None:
            r["stages"] = stage_delta(stage_snapshot(stages), before)
        r["imu_initialized"] = bool(system.atlas.current.imu_initialized)
        log.append(r)
        t_prev = f.timestamp
    return log


def launches_by_stage(log, stages, keyframes, lc_rows):
    """[top-k, matrix] launches of each tracker stage, and the mapper's and
    the loop closer's, over a run."""
    tracker = {name: [sum(r["stages"][name][j] for r in log) for j in (0, 1)] for name in stages}
    mapper = {"triangulation (10240 rows)": sum(k["topk_epi_rows"] for k in keyframes),
              "mapper top-k all": sum(k["topk"] for k in keyframes),
              "fusion (matrix)": sum(k["matrix"] for k in keyframes)}
    closer = {k: sum(r[k] for r in lc_rows) for k in ("k1", "k2", "matrix")}
    return f"tracker {tracker}, mapper {mapper}, loop closer {closer} over {len(lc_rows)} keyframes"


def phase_rgbd_system(device, scene, card):
    """The RGB-D System (M9d) in its default configuration on the card (the
    shipped vocabulary, the loop closer inline with the scale fixed): the
    stereo initialization from the depth map, stepwise frames only (ROADMAP
    F40), the mapper's triangulation and fusion; gated against the
    renderer's truth and the JAX package's reading (RGBD_JAX)."""
    seq, _ = scene
    kern = reset_launch_counts()
    matrix = hamming_kernel.hamming_penalty_matrix
    system = System(rgbd_settings(seq, device), Sensor.RGBD, device=device)
    check(not system.tracker.monocular and system.loop_closer.fix_scale is True
          and system._rect is None,
          "phase 26a: not a stereo-like RGB-D System with a fixed-scale loop closer")
    check(abs(system.tracker.th_depth - RGBD_TH_DEPTH * RGBD_BF / seq.fx) < 1e-9,
          f"phase 26a: th_depth {system.tracker.th_depth}")
    keyframes, lc_rows = [], []
    watch_mapper(system, keyframes)
    watch_loop_closer(system.loop_closer, lc_rows)
    stages, restore = watch_tracker_stages()
    try:
        log = run_rgbd(system, scene, N_RGBD_FRAMES, keyframes, stages)
    finally:
        restore()
    system.shutdown()

    states = [r["state"] for r in log]
    state_str = "".join(s[0] for s in states)
    check(states == ["OK"] * len(log), f"phase 26a: a frame is not OK: {state_str}")
    for i, r in enumerate(log):
        check(np.isfinite(r["R"]).all() and np.isfinite(r["t"]).all(), f"phase 26a frame {i}: pose")
        # the RGB-D route is never fused, in the JAX package either (F40)
        check(r["path"] == "stepwise", f"phase 26a frame {i}: {r['path']}")
    check(log[0]["stereo"] >= 100, f"phase 26a: {log[0]['stereo']} depths on the first frame")
    ate = trajectory_ate(system.tracker.trajectory, seq)
    ate_limit = min(ATE_LIMIT_M, RGBD_ATE_FACTOR * RGBD_JAX["ate_m"])
    check(ate["n"] == N_RGBD_FRAMES and ate["rmse"] <= ate_limit,
          f"phase 26a: SE(3) ATE RMSE {ate['rmse']:.4f} m over {ate['n']} frames, limit "
          f"{ate_limit:.4f} m")
    check(kern.launches > 0 and matrix.launches > 0, "phase 26a: a kernel was not launched")
    times = {"stepwise, no keyframe": frame_ms([r for r in log[1:] if not r["mapped"]]),
             "keyframe": frame_ms([r for r in log[1:] if r["mapped"]])}
    fetches = [r["fetches"] for r in log[1:]]
    m = system.atlas.current
    gt = np.asarray(seq.gt_pos[:len(log)])
    rms_motion = float(np.sqrt(((gt - gt.mean(0)) ** 2).sum(1).mean()))
    print(
        f"phase 26a RGB-D System, default configuration: {len(log)} frames of the rendered sweep "
        f"at {RGBD_W}x{RGBD_H}, {RGBD_FPS:g} fps, with their exact depth maps (TUM1.yaml's "
        f"sizes: {RGBD_FEATURES} features, 8 levels, bf {RGBD_BF}, ThDepth {RGBD_TH_DEPTH}, "
        f"th_depth {system.tracker.th_depth:.3f} m) through System(Sensor.RGBD).track_rgbd on "
        f"{card}: states {state_str}; initialized at frame {states.index('OK')}; keyframes "
        f"{m.n_keyframes()} ({len(keyframes)} processed; the JAX package "
        f"{RGBD_JAX['keyframes']}), map points {m.n_mappoints()}; SE(3) ATE RMSE "
        f"{ate['rmse']:.4f} m over {ate['n']} frames (limit {ate_limit:.4f}; the JAX package "
        f"{RGBD_JAX['ate_m']:.4f}) beside {rms_motion:.4f} m of RMS motion; ms/frame median, p90 "
        f"(count): " + "; ".join(f"{k} {v[0]:.3f}, {v[1]:.3f} ({v[2]})" for k, v in times.items())
        + f"; the init frame {log[0]['ms']:.1f} ms; every frame stepwise (F40), fetches per frame "
        f"{np.mean(fetches):.3f} (min {min(fetches)}, max {max(fetches)}) after the first; depths "
        f"per frame median {np.median([r['stereo'] for r in log]):.0f} (the first "
        f"{log[0]['stereo']}); top-k launches {kern.launches} ({dict(kern.launches_by_k)} by K), "
        f"by stage: {launches_by_stage(log, stages, keyframes, lc_rows)}; matrix launches "
        f"{matrix.launches}"
    )
    return kern.launches, matrix.launches, log


def phase_rgbd_inertial_system(device, scene, card):
    """The RGB-D-inertial System (M9d) in its default configuration on the
    card over the same scene with its exact 200 Hz IMU stream (T_b_c1 = I):
    the IMU init after 2 s, the VI pose optimizers on its stepwise frames,
    the inertial windows; gated against the renderer's truth."""
    seq, _ = scene
    kern = reset_launch_counts()
    matrix = hamming_kernel.hamming_penalty_matrix
    system = System(rgbd_settings(seq, device, inertial=True), Sensor.IMU_RGBD, device=device)
    check(system.tracker.use_imu and not system.tracker.monocular
          and system.loop_closer.fix_scale is True,
          "phase 26b: not an RGB-D-inertial System with a fixed-scale loop closer")
    keyframes, lc_rows = [], []
    watch_mapper(system, keyframes)
    watch_loop_closer(system.loop_closer, lc_rows)
    stages, restore = watch_tracker_stages()
    try:
        log = run_rgbd(system, scene, N_RGBD_INERTIAL_FRAMES, keyframes, stages, inertial=True)
    finally:
        restore()
    system.shutdown()

    states = [r["state"] for r in log]
    state_str = "".join(s[0] for s in states)
    check(any(r["imu_initialized"] for r in log),
          f"phase 26b: the IMU never initialized: {state_str}")
    init = next(i for i, r in enumerate(log) if r["imu_initialized"])
    check(len(log) - init - 1 >= 10,
          f"phase 26b: only {len(log) - init - 1} frames after the IMU init")
    check(all(s == "OK" for s in states[init:]),
          f"phase 26b: a frame from the IMU init (frame {init}) on is not OK: {state_str}")
    for i, r in enumerate(log):
        check(r["path"] == "stepwise", f"phase 26b frame {i}: {r['path']}")
        if r["R"] is not None:
            check(np.isfinite(r["R"]).all() and np.isfinite(r["t"]).all(), f"phase 26b frame {i}: pose")
    bg = system.tracker.bias[0]
    check(np.linalg.norm(bg) < 0.05, f"phase 26b: gyro bias {bg} (the stream has none)")
    # the frames up to the init are tracked in the world before its rotation
    traj = system.tracker.trajectory
    ate, ate_post = trajectory_ate(traj, seq), trajectory_ate(traj[init + 1:], seq)
    check(ate["rmse"] <= ATE_LIMIT_M and ate_post["rmse"] <= ATE_LIMIT_M,
          f"phase 26b: SE(3) ATE RMSE {ate['rmse']:.4f} m over {ate['n']} frames, "
          f"{ate_post['rmse']:.4f} m over the {ate_post['n']} after the IMU init (limit "
          f"{ATE_LIMIT_M} m)")
    check(kern.launches > 0 and matrix.launches > 0, "phase 26b: a kernel was not launched")
    times = {"stepwise before the IMU init, no keyframe":
             frame_ms([r for r in log[1:init] if not r["mapped"]]),
             "stepwise inertial after it, no keyframe":
             frame_ms([r for r in log[init + 1:] if not r["mapped"]]),
             "keyframe": frame_ms([r for r in log[1:] if r["mapped"]])}
    series = system.stats.series
    m = system.atlas.current
    print(
        f"phase 26b RGB-D-inertial System, default configuration: {len(log)} frames of phase "
        f"26a's scene with their 200 Hz IMU stream through "
        f"System(Sensor.IMU_RGBD).track_rgbd(..., imu=...) on {card}: states {state_str}; IMU "
        f"init at frame {init} ({seq.frames[init].timestamp:.3f} s; the JAX package "
        f"{RGBD_JAX['imu_init_frame']}), |bg| {np.linalg.norm(bg):.5f} rad/s; every frame "
        f"stepwise (F40), fetches per frame {np.mean([r['fetches'] for r in log[1:]]):.3f}; "
        f"keyframes {m.n_keyframes()} ({len(keyframes)} processed), map points "
        f"{m.n_mappoints()}; SE(3) ATE RMSE {ate['rmse']:.4f} m over {ate['n']} frames, "
        f"{ate_post['rmse']:.4f} m over the {ate_post['n']} after the init (limit "
        f"{ATE_LIMIT_M}; the JAX package {RGBD_JAX['ate_inertial_m']:.4f} over all); ms/frame "
        f"median, p90 (count): "
        + "; ".join(f"{k} {v[0]:.3f}, {v[1]:.3f} ({v[2]})" for k, v in times.items())
        + f"; lm_imu_init ms {[round(x, 1) for x in series['lm_imu_init'][-1:]]} (the call that "
        f"initialized); inertial windows {int(sum(series['lm_inertial_bas']))}; top-k launches "
        f"{kern.launches} ({dict(kern.launches_by_k)} by K), by stage: "
        f"{launches_by_stage(log, stages, keyframes, lc_rows)}; matrix launches {matrix.launches}"
    )
    return kern.launches, matrix.launches


def phase_rgbd_card_vs_cpu(device, scene, card, log_a):
    """(a) process_rgbd_frame on frame 0 on the card and on the CPU: the
    keypoints as sets (F4; the golden check's overlap), u_right and depth
    exact on the common ones; (b) 26a's frames up to its second keyframe
    (the first fusion, so both kernels run), inline, through the
    default System on the card and with device="cpu": the same states and
    keyframes, camera centres within 1e-3 m."""
    seq, depths = scene
    cfg = OrbConfig(height=RGBD_H, width=RGBD_W, n_features=RGBD_FEATURES, n_levels=8,
                    scale_factor=1.2, ini_threshold=20.0, min_threshold=7.0)

    def frame_on(dev):
        fd = frame_pipeline.process_rgbd_frame(
            torch.from_numpy(seq.frames[0].left).to(dev), torch.from_numpy(depths[0]).to(dev), cfg,
            torch.tensor(RGBD_BF, device=dev))
        return {k: v.cpu().numpy() for k, v in (
            ("x", fd.kps.x), ("y", fd.kps.y), ("level", fd.kps.level), ("valid", fd.kps.valid),
            ("u_right", fd.u_right), ("depth", fd.depth))}

    def keys(f):
        return {(float(f["x"][i]), float(f["y"][i]), int(f["level"][i])): i
                for i in np.where(f["valid"])[0]}

    on_card, on_cpu = frame_on(device), frame_on(torch.device("cpu"))
    a, b = keys(on_card), keys(on_cpu)
    both = sorted(set(a) & set(b))
    overlap = len(both) / max(len(a), len(b))
    ia, ib = np.asarray([a[k] for k in both]), np.asarray([b[k] for k in both])
    equal = all(np.array_equal(on_card[k][ia], on_cpu[k][ib]) for k in ("u_right", "depth"))
    n_depth = int((on_card["depth"][ia] > 0).sum())
    check(overlap >= 0.97 and equal and n_depth >= 100,
          f"phase 26c process_rgbd_frame: keypoint overlap {overlap:.4f}, u_right and depth "
          f"equal on the {len(both)} common keypoints: {equal}, {n_depth} with a depth")

    mapped = [i for i, r in enumerate(log_a) if r["mapped"]]
    n = mapped[1] + 1 if len(mapped) > 1 else N_RGBD_CPU_FRAMES
    kern = reset_launch_counts()
    matrix = hamming_kernel.hamming_penalty_matrix
    logs = []
    for dev in (device, "cpu"):
        system = System(rgbd_settings(seq, dev), Sensor.RGBD, device=dev)
        logs.append(run_rgbd(system, scene, n))
        system.shutdown()
        if dev == device:
            launches = (kern.launches, matrix.launches)
    worst = 0.0
    for i, (gpu, cpu) in enumerate(zip(*logs)):
        check(gpu["state"] == cpu["state"] and gpu["keyframes"] == cpu["keyframes"],
              f"phase 26c frame {i}: card {gpu['state']} {gpu['keyframes']} keyframes, CPU "
              f"{cpu['state']} {cpu['keyframes']}")
        d = float(np.linalg.norm(-gpu["R"].T @ gpu["t"] + cpu["R"].T @ cpu["t"]))
        check(d < 1e-3, f"phase 26c frame {i}: camera centres {d:.2e} m apart")
        worst = max(worst, d)
    check(launches[0] > 0 and launches[1] > 0, f"phase 26c: launches {launches} on the card")
    print(
        f"phase 26c RGB-D, card against CPU ({card}): process_rgbd_frame on frame 0: keypoint "
        f"overlap {overlap:.4f} ({len(both)} common of {len(a)} / {len(b)}), u_right and depth "
        f"equal on all of them, {n_depth} with a depth; the default System's first {n} frames "
        f"(26a's keyframes at frames {mapped[:3]}): states {''.join(r['state'][0] for r in logs[0])} "
        f"and keyframes {logs[0][-1]['keyframes']} on both, camera centres at most {worst:.2e} m "
        f"apart; top-k launches {launches[0]}, matrix launches {launches[1]} (the card's run)"
    )
    return launches


# ------------------------------------------------------- phases 27a-c (M9e, M9f)
def numpy_only_load(path):
    """Unpickle an atlas file that may name NumPy and nothing else: no torch
    object, no class of either package."""
    class NumpyOnly(pickle.Unpickler):
        def find_class(self, module, name):
            check(module.split(".")[0] == "numpy", f"{module}.{name} in the atlas file {path}")
            return super().find_class(module, name)

    with open(path, "rb") as f:
        return NumpyOnly(f).load()


def tree_differences(a, b, path="file", out=None):
    """Where two atlas trees differ in keys, types, dtypes, shapes or values
    (exact, NaN equal to NaN); an empty list if nowhere."""
    out = [] if out is None else out
    if type(a) is not type(b):
        out.append(f"{path}: {type(a).__name__} != {type(b).__name__}")
    elif isinstance(a, dict):
        if set(a) != set(b):
            out.append(f"{path}: keys differ")
        for k in set(a) & set(b):
            tree_differences(a[k], b[k], f"{path}[{k!r}]", out)
    elif isinstance(a, (list, tuple)):
        if len(a) != len(b):
            out.append(f"{path}: lengths {len(a)} != {len(b)}")
        for i, (x, y) in enumerate(zip(a, b)):
            tree_differences(x, y, f"{path}[{i}]", out)
    elif isinstance(a, np.ndarray):
        if a.dtype != b.dtype or a.shape != b.shape or not np.array_equal(a, b, equal_nan=a.dtype.kind == "f"):
            out.append(f"{path}: arrays differ ({a.dtype} {a.shape}, {b.dtype} {b.shape})")
    elif not (a == b or (isinstance(a, float) and np.isnan(a) and np.isnan(b))):
        out.append(f"{path}: {a!r} != {b!r}")
    return out


def resume_run(system, frames):
    """The resumed frames through `system` at their rendered timestamps; a
    row per frame as tracker_step gives it."""
    return [tracker_step(system.tracker, f, entry=system) for f in frames]


def phase_atlas_reuse(device, seq, card, atlas_path, saved):
    """(a) A visual map reused on the card: phase 17's atlas (the default
    System after frames 0-59) loaded into a new default System, which
    tracks frames 50-71: the loaded counts equal the saved ones, re-acquired
    within ATLAS_REACQUIRE_FRAMES frames and OK from then on, the ATE over
    the resumed frames, both kernels launched after the load; the same
    frames again through a new System in localization mode (no keyframe
    added); the card-written file loaded into System(device="cpu") and
    saved again: the two files equal array for array, neither naming
    anything but NumPy."""
    frames = seq.frames[N_ATLAS_FROM:N_ATLAS_FROM + N_ATLAS_FRAMES]
    system = make_system(seq, device, vocabulary=None)
    t0 = time.perf_counter()
    system.load_atlas(atlas_path)
    load_ms = (time.perf_counter() - t0) * 1e3
    m = system.atlas.current
    check((m.n_keyframes(), m.n_mappoints()) == (saved["keyframes"], saved["mappoints"]),
          f"phase 27a: loaded {m.n_keyframes()} keyframes and {m.n_mappoints()} points, saved "
          f"{saved['keyframes']} and {saved['mappoints']}")
    check(system.tracking_state.name == "RECENTLY_LOST", f"phase 27a: {system.tracking_state.name} after the load")
    check(len(system.loop_closer.db.kf_bows) == m.n_keyframes(),
          "phase 27a: the keyframe database does not hold every loaded keyframe")
    kern = reset_launch_counts()
    matrix = hamming_kernel.hamming_penalty_matrix
    rows = resume_run(system, frames)
    system.shutdown()
    topk, mat, by_k = kern.launches, matrix.launches, dict(kern.launches_by_k)
    states = [r["state"] for r in rows]
    check("OK" in states[:ATLAS_REACQUIRE_FRAMES],
          f"phase 27a: not re-acquired within {ATLAS_REACQUIRE_FRAMES} frames: {states}")
    back = states.index("OK")
    check(all(x == "OK" for x in states[back:]), f"phase 27a: lost after re-acquiring: {states}")
    ate = trajectory_ate(system.tracker.trajectory, seq)
    check(ate["n"] == len(frames) - back and ate["rmse"] <= ATE_LIMIT_M,
          f"phase 27a: ATE RMSE {ate['rmse']:.4f} m over {ate['n']} resumed frames, limit {ATE_LIMIT_M}")
    check(topk > 0 and mat > 0, f"phase 27a: {topk} top-k and {mat} matrix launches after the load")
    added = system.atlas.current.n_keyframes() - saved["keyframes"]
    ms = [r["ms"] for r in rows[back + 1:]]

    # the same frames in localization mode: the map is frozen
    local = make_system(seq, device, vocabulary=None)
    local.load_atlas(atlas_path)
    local.activate_localization_mode()
    loc_rows = resume_run(local, frames)
    local.shutdown()
    loc_states = [r["state"] for r in loc_rows]
    check(local.atlas.current.n_keyframes() == saved["keyframes"],
          f"phase 27a: localization mode added {local.atlas.current.n_keyframes() - saved['keyframes']} keyframes")
    check("OK" in loc_states, f"phase 27a: localization mode never re-acquired: {loc_states}")

    # the card's file on the CPU
    state = numpy_only_load(atlas_path)
    cpu = make_system(seq, "cpu", vocabulary=None)
    cpu.load_atlas(atlas_path)
    again = atlas_path + ".cpu"
    cpu.save_atlas(again)
    cpu.shutdown()
    diffs = tree_differences(numpy_only_load(again), state)
    check(not diffs, f"phase 27a: the card's atlas loaded on the CPU differs: {diffs[:5]}")
    print(
        f"phase 27a atlas reused on {card}: phase 17's atlas ({saved['keyframes']} keyframes, "
        f"{saved['mappoints']} map points, {saved['bytes']} bytes) loaded in {load_ms:.1f} ms into "
        f"a new System(Sensor.STEREO) with the shipped vocabulary; frames {N_ATLAS_FROM}-"
        f"{N_ATLAS_FROM + N_ATLAS_FRAMES - 1}: states {''.join(x[0] for x in states)}, re-acquired at "
        f"resumed frame {back} ({rows[back]['ms']:.1f} ms), keyframes added {added}; ATE RMSE "
        f"{ate['rmse']:.4f} m over {ate['n']} frames (limit {ATE_LIMIT_M}); ms/frame after it median "
        f"{np.median(ms):.1f}, p90 {np.percentile(ms, 90):.1f}; top-k launches {topk} "
        f"({by_k} by K), matrix launches {mat}; localization mode: states "
        f"{''.join(x[0] for x in loc_states)}, no keyframe added; the file loaded on the CPU and "
        f"saved again: equal array for array, NumPy only"
    )
    return topk, mat


def phase_atlas_inertial(device, seq, card, atlas_path):
    """(b) An inertial map through the settings path: phase 21b's atlas,
    written by its shutdown, loaded by a new System(Sensor.IMU_STEREO) whose
    settings name it, which resumes on frames 50-64 of phase 13's sequence
    with their IMU samples: the map IMU-initialized after the load, the
    restored bias the saved newest keyframe's, every frame OK from the
    third on, the ATE over the resumed frames; the re-acquiring frame, |bg|
    and ms/frame printed (ROADMAP F45: the tracker tracks visually until its
    first keyframe after the load, then inertially)."""
    state = numpy_only_load(atlas_path)
    md = state["maps"][-1]
    newest = md["keyframes"][max(md["keyframes"])]
    t0 = time.perf_counter()
    system = make_inertial_system(seq, device, vocabulary=None, load_atlas=atlas_path)
    build_ms = (time.perf_counter() - t0) * 1e3
    m, tr = system.atlas.current, system.tracker
    check(m.imu_initialized, "phase 27b: the loaded map is not IMU-initialized")
    check(np.array_equal(tr.bias[0], newest["imu_bias"][0])
          and np.array_equal(tr.bias[1], newest["imu_bias"][1]),
          "phase 27b: the restored bias is not the saved newest keyframe's")
    check(tr.imu_anchor_stale and tr.last_kf_id == max(md["keyframes"]),
          "phase 27b: the tracker's IMU anchor was not restored")
    kern = reset_launch_counts()
    matrix = hamming_kernel.hamming_penalty_matrix
    frames = seq.frames[N_ASYNC_INERTIAL_FRAMES:N_ASYNC_INERTIAL_FRAMES + N_ATLAS_INERTIAL_FRAMES]
    inertial = []
    rows = []
    t_prev = seq.frames[N_ASYNC_INERTIAL_FRAMES - 1].timestamp
    for f in frames:
        rows.append(tracker_step(tr, f, entry=system, imu=imu_between(seq, t_prev, f.timestamp)))
        inertial.append(tr._imu_ready())
        t_prev = f.timestamp
    system.shutdown()
    topk, mat = kern.launches, matrix.launches
    states = [r["state"] for r in rows]
    check(all(x == "OK" for x in states[ATLAS_INERTIAL_OK_FROM:]),
          f"phase 27b: not every frame OK from resumed frame {ATLAS_INERTIAL_OK_FROM} on: {states}")
    back = states.index("OK")
    ate = trajectory_ate(system.tracker.trajectory, seq)
    check(ate["rmse"] <= ATE_LIMIT_M,
          f"phase 27b: ATE RMSE {ate['rmse']:.4f} m over {ate['n']} resumed frames, limit {ATE_LIMIT_M}")
    check(topk > 0 and mat > 0, f"phase 27b: {topk} top-k and {mat} matrix launches after the load")
    bg = float(np.linalg.norm(tr.bias[0]))
    ms = [r["ms"] for r in rows[back + 1:]]
    first_inertial = inertial.index(True) if True in inertial else None
    print(
        f"phase 27b inertial atlas on {card}: phase 21b's atlas written by its shutdown "
        f"({len(md['keyframes'])} keyframes, {len(md['mappoints'])} map points), loaded through "
        f"Settings.load_atlas by System(Sensor.IMU_STEREO) in {build_ms:.1f} ms (construction "
        f"included): IMU-initialized, bias restored (|bg| {np.linalg.norm(newest['imu_bias'][0]):.5f}); "
        f"frames {N_ASYNC_INERTIAL_FRAMES}-{N_ASYNC_INERTIAL_FRAMES + N_ATLAS_INERTIAL_FRAMES - 1} "
        f"with IMU: "
        f"states {''.join(x[0] for x in states)}, re-acquired at resumed frame {back}, inertial "
        f"again from resumed frame {first_inertial} (after the first keyframe of this run, "
        f"ROADMAP F45); |bg| {bg:.5f} at the end; ATE RMSE {ate['rmse']:.4f} m over {ate['n']} "
        f"frames (limit {ATE_LIMIT_M}); ms/frame after the re-acquisition median "
        f"{np.median(ms):.1f}, p90 {np.percentile(ms, 90):.1f}; top-k launches {topk}, matrix "
        f"launches {mat}"
    )
    return topk, mat


KITTI_YAML = """%YAML:1.0
---
File.version: "1.0"
Camera.type: "PinHole"
Camera1.fx: {fx}
Camera1.fy: {fy}
Camera1.cx: {cx}
Camera1.cy: {cy}
Camera.width: {w}
Camera.height: {h}
Camera.fps: {fps}
Camera.RGB: 1
Stereo.ThDepth: {th_depth}
Stereo.b: {b}
ORBextractor.nFeatures: {features}
ORBextractor.scaleFactor: {scale}
ORBextractor.nLevels: {levels}
ORBextractor.iniThFAST: {fast0}
ORBextractor.minThFAST: {fast1}
"""


def write_kitti_layout(root):
    """Render phase 27c's sequence and write it in KITTI's odometry layout
    under `root`: image_0/%06d.png and image_1/%06d.png (8-bit), times.txt,
    the settings file KITTI.yaml (File.version 1.0) and the renderer's
    trajectory as gt.txt in the TUM format. Returns `root`. Runs in the
    renderer's process."""
    from PIL import Image

    from fasttrack_tpu_torch.nputils import matrix_to_quat

    seq = generate_sequence(n_frames=N_KITTI_FRAMES, h=KITTI_H, w=KITTI_W, fps=KITTI_FPS,
                            baseline=KITTI_BASELINE)
    for cam in ("image_0", "image_1"):
        os.makedirs(os.path.join(root, cam), exist_ok=True)
    times, gt = [], []
    for i, f in enumerate(seq.frames):
        for cam, img in (("image_0", f.left), ("image_1", f.right)):
            Image.fromarray(np.clip(np.round(img), 0, 255).astype(np.uint8)).save(
                os.path.join(root, cam, f"{i:06d}.png"))
        times.append(f"{f.timestamp:.6e}")
        q = matrix_to_quat(f.R_wc)
        p = f.t_wc
        gt.append(f"{f.timestamp:.6f} {p[0]:.9f} {p[1]:.9f} {p[2]:.9f} "
                  f"{q[1]:.9f} {q[2]:.9f} {q[3]:.9f} {q[0]:.9f}")
    with open(os.path.join(root, "times.txt"), "w") as fh:
        fh.write("\n".join(times) + "\n")
    with open(os.path.join(root, "gt.txt"), "w") as fh:
        fh.write("\n".join(gt) + "\n")
    with open(os.path.join(root, "KITTI.yaml"), "w") as fh:
        fh.write(KITTI_YAML.format(
            fx=seq.fx, fy=seq.fy, cx=seq.cx, cy=seq.cy, w=KITTI_W, h=KITTI_H, fps=KITTI_FPS,
            th_depth=KITTI_TH_DEPTH, b=KITTI_BASELINE, features=KITTI_FEATURES,
            scale=KITTI_SCALE, levels=KITTI_LEVELS, fast0=KITTI_FAST[0], fast1=KITTI_FAST[1]))
    return root


def phase_kitti(device, card, root):
    """(c) KITTI at KITTI's size: examples/torch_kitti_stereo.py run in this
    process with its arguments on phase 27c's layout (the card by
    default): every frame OK, f_traj_kitti.txt with a line a frame, the
    SE(3) ATE, both kernels launched; ms/frame and the launches at each
    shape."""
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples",
                          "torch_kitti_stereo.py")
    out = os.path.join(root, "out")
    kern = reset_launch_counts()
    matrix = hamming_kernel.hamming_penalty_matrix
    states = []
    main_fn = runpy.run_path(script)["main"]
    inner = System.track_stereo

    def track_stereo(self, *a, **kw):     # what the driver's frames did, as they went
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = inner(self, *a, **kw)
        states.append((self.tracking_state.name, (time.perf_counter() - t0) * 1e3))
        return res

    System.track_stereo = track_stereo
    try:
        system = main_fn([os.path.join(root, "KITTI.yaml"), root, "--out", out,
                          "--gt", os.path.join(root, "gt.txt")])
    finally:
        System.track_stereo = inner
    topk, mat = kern.launches, matrix.launches
    shapes_topk, shapes_matrix = dict(kern.launches_by_shape), dict(matrix.launches_by_shape)
    check(system.device.type == "cuda", f"phase 27c: the driver ran on {system.device}")
    check([x for x, _ in states] == ["OK"] * N_KITTI_FRAMES,
          f"phase 27c: states {[x for x, _ in states]}")
    rows = np.loadtxt(os.path.join(out, "f_traj_kitti.txt"))
    check(rows.shape == (N_KITTI_FRAMES, 12), f"phase 27c: f_traj_kitti.txt holds {rows.shape}")
    with open(os.path.join(out, "ate.json")) as fh:
        ate = json.load(fh)
    limit = min(ATE_LIMIT_M, KITTI_ATE_FACTOR * KITTI_JAX["ate_m"])
    check(ate["ate_rmse"] <= limit and ate["n_associated"] == N_KITTI_FRAMES,
          f"phase 27c: ATE RMSE {ate['ate_rmse']:.4f} m over {ate['n_associated']} frames, limit "
          f"{limit} (KITTI_JAX {KITTI_JAX})")
    check(topk > 0 and mat > 0, f"phase 27c: {topk} top-k and {mat} matrix launches")
    # the top-K kernel's shapes are fixed capacities: each was held to its
    # plain version in phase 3; the matrix's rows follow the map
    held = {(M, N, K) for M, N, _, K in TOPK_CASES}
    check(set(shapes_topk) <= held,
          f"phase 27c: top-k shapes not held in phase 3: {sorted(set(shapes_topk) - held)}")
    unheld_matrix = sorted(set(shapes_matrix) - set(MATRIX_SHAPES))
    ms = [t for _, t in states[2:]]
    m = system.atlas.current
    print(
        f"phase 27c KITTI at KITTI's size on {card}: examples/torch_kitti_stereo.py over "
        f"{N_KITTI_FRAMES} rendered frames at {KITTI_W}x{KITTI_H}, {KITTI_FPS} fps, baseline "
        f"{KITTI_BASELINE} m, {KITTI_FEATURES} features, {KITTI_LEVELS} levels (KITTI00-02.yaml's "
        f"setting, the renderer's fx): every frame OK, {m.n_keyframes()} keyframes, "
        f"{m.n_mappoints()} map points; f_traj_kitti.txt {rows.shape[0]} lines; ATE RMSE "
        f"{ate['ate_rmse']:.4f} m (limit {limit}; the JAX package's reading {KITTI_JAX}); ms/frame "
        f"median {np.median(ms):.1f}, p90 {np.percentile(ms, 90):.1f} over {len(ms)} frames "
        f"(System.track_stereo's calls); top-k launches {topk} by (M, N, K) "
        f"{ {str(k): v for k, v in sorted(shapes_topk.items())} }, matrix launches {mat} by (M, N) "
        f"{ {str(k): v for k, v in sorted(shapes_matrix.items())} } (of them not among phase 3's "
        f"shapes: {unheld_matrix})"
    )
    return topk, mat, shapes_topk, shapes_matrix


def split_text(split) -> str:
    return ", ".join(f"{k} {v:.2f}" for k, v in split.items())


def same_steps(a, b, rtol=1e-9) -> bool:
    """Two LM runs' accepted costs are the same steps: equal within `rtol`
    over their common length, and any further step of the longer run moves
    its cost by less than `rtol` (at the optimum float64 accepts or rejects
    steps of 1e-13 by rounding)."""
    n = min(len(a), len(b))
    rest = (a if len(a) > n else b)[n - 1:]
    return (np.allclose(a[:n], b[:n], rtol=rtol, atol=0)
            and np.allclose(rest, rest[0], rtol=rtol, atol=0))


def phase_mesh_ba(device, card):
    """(a) The landmark-sharded LM (parallel.distributed_bundle_adjustment)
    on tools/bench_multichip.py's window at 1, 2 and 4 shards of the card,
    MESH_ITERS iterations, in float32 and float64, each timed with its split
    (parallel.SectionTimer: CUDA events); then the 1-shard mesh's first
    MESH_CPU_ITERS iterations again on the CPU. Checks: in float64 the same
    accepted steps, costs, poses and inliers at every shard count, and the
    CPU's (`same_steps`); in float32 (rounding decides its steps on this
    window) every final cost within MESH_F32_COST_TOL of the float64 run's
    reduction from the optimum."""
    K, L, obs = MESH_WINDOW
    arrays, cam_args, bf, n_obs = mesh_dryrun.make_problem(K=K, L=L, obs_per_point=obs)
    rows, runs = {}, {}
    for dtype in (np.float32, np.float64):
        prob = convert.ba_problem_from_numpy(arrays, device, dtype)
        cam = make_pinhole(*cam_args, device=device)
        for n in MESH_SHARDS:
            (poses, _, costs, inlier, _), seconds, split = mesh_dryrun.timed_solve(
                prob, cam, bf, make_mesh(n, device=device), MESH_ITERS)
            check(all(np.isfinite(costs)) and costs[-1] < costs[0],
                  f"phase 28a: {dtype.__name__} at {n} shards, costs {costs}")
            runs[dtype, n] = (poses.t.cpu().numpy(), costs, inlier.cpu().numpy())
            ms = 1e3 * seconds / MESH_ITERS
            rows[f"{dtype.__name__}, {n} shards"] = {
                "ms_per_iter": ms, "split_ms_per_iter": split, "accepted": len(costs) - 1,
                "cost_final": costs[-1]}
            print(f"phase 28a sharded BA on {card}: {dtype.__name__}, {n} shards of {device}, "
                  f"window {K} keyframes x {L} points ({n_obs} observations), {MESH_ITERS} "
                  f"iterations: {ms:.2f} ms/iteration on the host's clock; split per iteration "
                  f"(CUDA events, ms) {split_text(split)}; {len(costs) - 1} steps accepted, cost "
                  f"{costs[0]:.3f} -> {costs[-1]:.3f}")
    t64, c64, i64 = runs[np.float64, 1]
    for n in MESH_SHARDS[1:]:
        t, c, i = runs[np.float64, n]
        check(same_steps(c, c64) and np.abs(t - t64).max() <= 1e-6 and np.array_equal(i, i64),
              f"phase 28a: float64 at {n} shards parts from 1 shard: costs {c} against {c64}, "
              f"poses {np.abs(t - t64).max():.3g}")
    f32 = {n: runs[np.float32, n] for n in MESH_SHARDS}
    for n, (t, c, _) in f32.items():
        check(abs(c[-1] - c64[-1]) <= MESH_F32_COST_TOL * (c64[0] - c64[-1]),
              f"phase 28a: float32 at {n} shards ends at {c[-1]:.3f}, the float64 optimum "
              f"{c64[-1]:.3f} from {c64[0]:.3f}")
    # the 1-shard mesh's first iterations again on the CPU
    cpu = torch.device("cpu")
    cpu_cam = make_pinhole(*cam_args, device=cpu)
    card_run = distributed_bundle_adjustment(convert.ba_problem_from_numpy(arrays, device, np.float64),
                                             make_pinhole(*cam_args, device=device), bf,
                                             make_mesh(1, device=device), iters=MESH_CPU_ITERS)
    cpu_run = distributed_bundle_adjustment(convert.ba_problem_from_numpy(arrays, cpu, np.float64),
                                            cpu_cam, bf, make_mesh(1, device=cpu),
                                            iters=MESH_CPU_ITERS)
    d_pose = float((card_run[0].t.cpu() - cpu_run[0].t).abs().max())
    check(same_steps(card_run[2], cpu_run[2]) and d_pose <= 1e-6,
          f"phase 28a: card against CPU, float64: costs {card_run[2]} / {cpu_run[2]}, poses {d_pose}")
    c32 = distributed_bundle_adjustment(convert.ba_problem_from_numpy(arrays, cpu), cpu_cam, bf,
                                        make_mesh(1, device=cpu), iters=0)[2]
    check(abs(c32[0] - f32[1][1][0]) <= 1e-6 * c32[0],
          f"phase 28a: card against CPU, float32 starting cost {f32[1][1][0]} / {c32[0]}")
    print(f"phase 28a card against CPU: the 1-shard mesh's first {MESH_CPU_ITERS} iterations in "
          f"float64, costs {[round(c, 6) for c in card_run[2]]} on both (rtol 1e-9), poses within "
          f"{d_pose:.3g}; float32 starting cost equal within 1e-6; float64 at 1, 2, 4 shards: the "
          f"same steps (accepted {[len(runs[np.float64, n][1]) - 1 for n in MESH_SHARDS]}, those "
          f"past the first {len(c64) - 1} below the float64 floor), costs within 1e-9, poses "
          f"within 1e-6, inliers equal; "
          f"float32 accepted steps {[len(f32[n][1]) - 1 for n in MESH_SHARDS]} at {MESH_SHARDS} "
          f"shards, final costs {[round(f32[n][1][-1], 3) for n in MESH_SHARDS]} against the "
          f"float64 optimum {c64[-1]:.3f} (limit {MESH_F32_COST_TOL:.0%} of its reduction), poses "
          f"{max(np.abs(f32[n][0] - t64).max() for n in MESH_SHARDS):.4f} m from it at most")
    return rows


def phase_mesh_ranks(device, card):
    """(b) Two processes sharing the card, one shard each, over gloo
    (tools/torch_bench_multichip.py --processes 2, RANKS_WINDOW): both exit
    0 within RANKS_TIMEOUT_S; the final cost equals the 1-process 2-shard
    mesh's on the same window within MESH_F32_COST_TOL of its reduction
    (float32; the two add the same numbers in the same order, so they
    should be equal: the line says whether they are); the all-reduce's
    share of an iteration."""
    t0 = time.perf_counter()
    out = run_multiprocess(2, 1, device=str(device), timeout=RANKS_TIMEOUT_S, env=RANKS_WINDOW)
    wall = time.perf_counter() - t0
    check(out["processes"] == 2 and out["global_shards"] == 2 and out["backend"] == "gloo",
          f"phase 28b: {out}")
    arrays, cam_args, bf, _ = mesh_dryrun.make_problem(
        K=int(RANKS_WINDOW["BMC_K"]), L=int(RANKS_WINDOW["BMC_L"]), obs_per_point=6)
    (_, _, costs, _, _), seconds, split = mesh_dryrun.timed_solve(
        convert.ba_problem_from_numpy(arrays, device), make_pinhole(*cam_args, device=device), bf,
        make_mesh(2, device=device), int(RANKS_WINDOW["BMC_ITERS"]))
    check(abs(out["cost_final"] - costs[-1]) <= MESH_F32_COST_TOL * (costs[0] - costs[-1]),
          f"phase 28b: two processes end at {out['cost_final']}, one process of 2 shards at "
          f"{costs[-1]}")
    print(f"phase 28b two processes on {card}, one shard of {device} each, over gloo (the "
          f"partial systems through the host): window {RANKS_WINDOW}, {out['ms_per_iter']:.2f} "
          f"ms/iteration, split per iteration (CUDA events, ms) "
          f"{split_text(out['split_ms_per_iter'])}: the reduce (the all-reduce and the shards' "
          f"sum) {out['reduce_share']:.1%} of an iteration; one process of 2 shards "
          f"{1e3 * seconds / int(RANKS_WINDOW['BMC_ITERS']):.2f} ms/iteration, split "
          f"{split_text(split)}; final cost {out['cost_final']:.4f} against {costs[-1]:.4f} "
          f"({'equal' if out['costs'] == costs else 'not equal'} step for step); both "
          f"processes exited 0, {wall:.1f} s with their start")
    return out


def phase_mesh_mapper(device, card):
    """(c) LocalMapper(mesh=make_mesh(2, device=card))._local_ba on
    tests/test_parallel.py's drifted map (datasets.synthetic.drifted_leg_scene):
    the reprojection error below half its start, the corrupted observations
    dropped; the same on the CPU (float64 windows on both: poses 1e-6,
    points 1e-5) and against the unsharded card mapper (its own 15-iteration
    schedule: both below half, the same observations dropped)."""
    runs = {}
    for name, dev, mesh in (("mesh", device, make_mesh(2, device=device)),
                            ("cpu", torch.device("cpu"), make_mesh(2, device="cpu")),
                            ("unsharded", device, None)):
        atlas, kfs, bad = drifted_leg_scene(slam_map)
        m = atlas.current
        e0 = mean_reprojection_error(m)
        lm = local_mapping.LocalMapper(
            atlas, make_pinhole(LOOP_FX, LOOP_FX, LOOP_W / 2, LOOP_H / 2, LOOP_W, LOOP_H,
                                device=dev), 1.0, mesh=mesh, device=dev)
        t0 = time.perf_counter()
        lm._local_ba(kfs[-1])
        ms = (time.perf_counter() - t0) * 1e3
        e1 = mean_reprojection_error(m)
        dropped = [int(kfs[-2].mp_ids[fi]) == -1 or m.mappoints.get(mid) is None
                   or kfs[-2].kid not in m.mappoints[mid].observations for fi, mid in bad]
        check(e1 < 0.5 * e0 and bad and all(dropped),
              f"phase 28c ({name}): error {e0:.4f} -> {e1:.4f} px, dropped {dropped}")
        runs[name] = (e0, e1, ms, {k.kid: k.t_cw.copy() for k in m.keyframes.values()},
                      {mid: p.position.copy() for mid, p in m.mappoints.items()},
                      lm.stats.series["lm_device_fetches"])
    mesh, cpu, plain = runs["mesh"], runs["cpu"], runs["unsharded"]
    d_pose = max(np.abs(mesh[3][k] - cpu[3][k]).max() for k in mesh[3])
    d_pts = max(np.abs(mesh[4][k] - cpu[4][k]).max() for k in mesh[4])
    check(sorted(mesh[4]) == sorted(cpu[4]) == sorted(plain[4]) and d_pose <= 1e-6
          and d_pts <= 1e-5, f"phase 28c: card against CPU, poses {d_pose}, points {d_pts}")
    d_plain = max(np.abs(mesh[3][k] - plain[3][k]).max() for k in mesh[3])
    print(f"phase 28c the mapper with a mesh on {card}: LocalMapper(mesh=make_mesh(2, {device}))"
          f"._local_ba on the drifted map: reprojection error {mesh[0]:.4f} -> {mesh[1]:.4f} px, "
          f"the 4 corrupted observations dropped, {mesh[2]:.1f} ms ({mesh[5]} fetches); on the CPU "
          f"{cpu[1]:.4f} px, poses within {d_pose:.3g} m and points {d_pts:.3g} m of the card's; "
          f"the unsharded card mapper {plain[1]:.6f} px in {plain[2]:.1f} ms ({plain[5]} fetch), "
          f"its poses {d_plain:.4f} m from the mesh mapper's")
    return runs


def phase_mesh_extraction(device, card, seq):
    """(d) parallel.sharded_extract_batch of N_MESH_FRAMES frames of phase
    10's sequence at 752x480 over 1, 2 and 4 shards of the card: every
    frame's keypoints (x, y, level, descriptor) equal extract_orb's of that
    frame, as sets (ROADMAP F4); ms a batch on the host's clock."""
    imgs = torch.from_numpy(np.stack([f.left for f in seq.frames[:N_MESH_FRAMES]])).to(device)

    def keys(kp, b=None):
        x, y, lvl, desc, valid = (t.cpu().numpy() if b is None else t[b].cpu().numpy()
                                  for t in (kp.x, kp.y, kp.level, kp.desc_packed, kp.valid))
        return {(float(x[i]), float(y[i]), int(lvl[i]), bytes(desc[i])) for i in np.where(valid)[0]}

    want = [keys(extract_orb(imgs[b], CFG)[0]) for b in range(N_MESH_FRAMES)]
    times = {}
    for n in MESH_SHARDS:
        mesh = make_mesh(n, device=device)
        sharded_extract_batch(imgs, CFG, mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        kps = sharded_extract_batch(imgs, CFG, mesh)
        torch.cuda.synchronize()
        times[n] = (time.perf_counter() - t0) * 1e3
        check(kps.x.shape == (N_MESH_FRAMES, CFG.total_features),
              f"phase 28d: {n} shards gave {tuple(kps.x.shape)}")
        for b in range(N_MESH_FRAMES):
            check(keys(kps, b) == want[b], f"phase 28d: frame {b} at {n} shards differs from "
                                            f"extract_orb's keypoints")
    print(f"phase 28d sharded extraction on {card}: {N_MESH_FRAMES} frames of {W}x{H} "
          f"({CFG.total_features} features, {CFG.n_levels} levels) over {MESH_SHARDS} shards of "
          f"{device}: every frame's keypoints equal extract_orb's, as sets; ms a batch "
          f"{ {n: round(t, 2) for n, t in times.items()} } on the host's clock")
    return times


def phase_multi_device(device, card, seq):
    """Phase 28 (M10): a-d above, with both kernels' launch counts set to 0
    before and read after (the sharded BA and the extraction are plain
    PyTorch, ROADMAP K16: they launch neither)."""
    kern = reset_launch_counts()
    matrix = hamming_kernel.hamming_penalty_matrix
    ba = phase_mesh_ba(device, card)
    ranks = phase_mesh_ranks(device, card)
    phase_mesh_mapper(device, card)
    extraction = phase_mesh_extraction(device, card, seq)
    return {"ba": ba, "ranks": ranks, "extraction_ms": extraction,
            "launches": kern.launches, "matrix_launches": matrix.launches}


def main():
    t_start = time.perf_counter()
    check(set(sys.argv[1:]) <= {"--ba-float32"}, f"unknown arguments {sys.argv[1:]}")
    if "--ba-float32" in sys.argv:
        ba_assembly.SOLVE_DTYPE = np.float32
        print("local bundle adjustment in float32 (--ba-float32), not the port's float64")
    # 1. device
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False: no GPU")
    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"phase 1 device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda}); "
          f"nvidia-smi: {card}")
    # The three rendered sequences (phases 8-12 and 15, 13-14 and 16, 18b; their
    # 752x480 frames take the host 2-3 minutes of NumPy in all) render in
    # order in a process of their own while the phases before each run.
    spawn = multiprocessing.get_context("spawn")
    # `side` runs phases 16 and 24-25, each beside inline phases of this
    # process (17-18, 22-23): their frames are mostly host work, and the
    # inline phases' results do not depend on timing
    with concurrent.futures.ProcessPoolExecutor(1, mp_context=spawn) as renderer, \
            concurrent.futures.ProcessPoolExecutor(1, mp_context=spawn) as side:
        sequences = (
            renderer.submit(generate_sequence, n_frames=N_SYSTEM_FRAMES, h=H, w=W),
            renderer.submit(generate_sequence, n_frames=N_INERTIAL_FRAMES, h=H, w=W),
            renderer.submit(generate_sequence, n_frames=N_LOOP_FRAMES, h=H, w=W,
                            trajectory="loop"),
            renderer.submit(generate_sequence, n_frames=N_RIG_FRAMES, h=H, w=W,
                            rig=synthetic.euroc_radtan_rig(W, H)),
            renderer.submit(generate_sequence, n_frames=N_RIG_FRAMES, h=KB8_SIZE, w=KB8_SIZE,
                            rig=synthetic.tumvi_kb8_rig(KB8_SIZE, KB8_SIZE,
                                                        fov_deg=KB8_FOV_DEG),
                            plane_z=KB8_PLANE_Z),
            renderer.submit(synthetic.generate_rgbd_sequence, N_RGBD_INERTIAL_FRAMES, RGBD_H,
                            RGBD_W, fps=RGBD_FPS, seed=RGBD_SEED),
        )
        # the atlas files of phases 17, 21b and 27a and phase 27c's KITTI
        # layout go to a temporary directory, removed at the end
        work = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            kitti = renderer.submit(write_kitti_layout, os.path.join(work, "kitti"))
            run_phases(device, kind, card, t_start, renderer, side, *sequences, kitti, work)
        finally:
            shutil.rmtree(work, ignore_errors=True)


def phases_mono(device, seq, card):
    """Phases 24 (the visual monocular System, a: default configuration;
    b: card against CPU) and 25 (the monocular-inertial System, a: default
    configuration; b: its first inertial window and its first with a
    flipped step, card against CPU), for a process of their own; returns
    their launch counts."""
    mono_launches, mono_matrix, init_inputs = phase_mono_system(device, seq, card)
    mono_cpu_launches, mono_cpu_matrix = phase_mono_card_vs_cpu(device, seq, card, init_inputs)
    mi_launches, mi_matrix, mi_rec = phase_mono_inertial_system(device, seq, card)
    phase_mono_inertial_card_vs_cpu(mi_rec, card)
    return mono_launches, mono_matrix, mono_cpu_launches, mono_cpu_matrix, mi_launches, mi_matrix


def run_phases(device, kind, card, t_start, renderer, side, system_seq, inertial_seq, loop_seq,
               radtan_seq, kb8_seq, rgbd_scene, kitti_layout, work):
    """Phases 2-28, then the kernels line and the last lines; `renderer` is
    the renderer's process pool, `side` the one that runs phases 16 and
    24-25, the arguments after it are the futures of the rendered sequences
    and of the KITTI layout, and `work` the temporary directory of the atlas
    files."""
    atlas17, atlas21 = os.path.join(work, "phase17.osa"), os.path.join(work, "phase21b.osa")
    # 2. build: g++ for the host library beside the two nvcc processes
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        host_lib = pool.submit(native.build)
        hamming_kernel.load_kernels()
        host_lib = host_lib.result()
    native.hamming_matrix_packed(np.zeros((1, 32), np.uint8), np.zeros((1, 32), np.uint8))
    print(f"phase 2 build: {hamming_kernel.MATRIX_SOURCE} and {hamming_kernel.TOPK_SOURCE} (nvcc) "
          f"and {native.SOURCE.name} (g++, {host_lib.name}) built side by side and loaded in "
          f"{time.perf_counter() - t0:.2f} s")

    # 3. kernels against plain
    matrix_rows, matrix_err = phase_matrix_kernel(device, card)
    topk_rows, topk_err, mismatches = phase_topk_kernel(device, card)
    chunked, chunked_bad = phase_assign_chunked(device, card)
    past_max_n, past_max_n_bad = phase_topk_past_max_n(device, card)
    print(f"elapsed {time.perf_counter() - t_start:.1f} s after phases 1-3")

    # 4. hot path, 5. card against CPU
    frames = parity.stereo_frames(1 + N_WARMUP + N_FUSED_FRAMES, H, W, seed=0, step=STEP)
    hot_frames = frames[: 1 + N_WARMUP + N_FRAMES]
    hot_launches, hot_matrix, card_frame, last = phase_hot_path(device, hot_frames, card)
    phase_card_vs_cpu(hot_frames, card_frame, last)
    print(f"elapsed {time.perf_counter() - t_start:.1f} s after phases 4-5")

    # 6. fused step, 7. card against CPU
    fused_launches, fused_matrix, kept = phase_fused_step(device, frames, card)
    phase_fused_card_vs_cpu(kept)
    print(f"elapsed {time.perf_counter() - t_start:.1f} s after phases 6-7")

    # 8. tracker, 9. card against CPU
    t0 = time.perf_counter()
    seq = system_seq.result()
    print(f"rendered {N_SYSTEM_FRAMES} stereo frames at {W}x{H} (waited "
          f"{time.perf_counter() - t0:.1f} s for them; fx {seq.fx:.1f}, baseline {seq.baseline} m)")
    tracker_launches, tracker_matrix, tracker_k2, tracker_log, tracker_ate = phase_tracker(
        device, seq, card)
    phase_tracker_card_vs_cpu(seq, tracker_log)
    print(f"elapsed {time.perf_counter() - t_start:.1f} s after phases 8-9")

    # 10. system, 11. card against CPU (the CPU run in the renderer's process
    # while phases 12-16 run; checked after them), 12. mapping on its own thread
    system_launches, system_matrix, system_epi, system_log = phase_system(
        device, seq, card, tracker_ate)
    system_cpu = start_system_card_vs_cpu(renderer, seq, system_log)
    phase_system_async(device, seq, card)
    print(f"elapsed {time.perf_counter() - t_start:.1f} s after phases 10 and 12")

    # 13. stereo-inertial system, 14. its inertial programs card against CPU
    t0 = time.perf_counter()
    seq_i = inertial_seq.result()
    print(f"rendered {N_INERTIAL_FRAMES} stereo frames at {W}x{H} with their IMU stream "
          f"({len(seq_i.imu_t)} samples; waited {time.perf_counter() - t0:.1f} s for them)")
    inertial_launches, inertial_matrix, inertial_rec, inertial_system, inertial_lc = \
        phase_system_inertial(device, seq_i, card)
    phase_inertial_card_vs_cpu(inertial_rec)
    print(f"elapsed {time.perf_counter() - t_start:.1f} s after phases 13-14")

    # 15. BASELINE.md's toggle matrix on the tracker, 16. the inertial system
    # under 0000 in a process of its own (its frames are host NumPy, ~2.5 s
    # each), beside phases 17-18, whose mapping is inline: their results do
    # not depend on timing, and phase 16's times are taken beside them
    toggle_launches, toggle_matrix, _ = phase_toggle_matrix(device, seq, card)
    print(f"elapsed {time.perf_counter() - t_start:.1f} s after phase 15")
    host_inertial = side.submit(beside, "timed beside phases 17-18 in another process",
                                phase_system_inertial_host, device, seq_i, card)
    phase_system_card_vs_cpu(system_log, system_cpu)
    del system_log, system_cpu
    print(f"elapsed {time.perf_counter() - t_start:.1f} s after phase 11's check")

    # 17. relocalization, 18. loop closing (a: a drifted map, b: the System over a loop)
    note = "timed beside phase 16 in another process"
    reloc_all, reloc_matrix, reloc_launches, reloc_saved = beside(
        note, phase_relocalization, device, seq, card, atlas17)
    print(f"elapsed {time.perf_counter() - t_start:.1f} s after phase 17")
    map_launches, k13_launches, k13_ms = beside(note, phase_loop_closing_map, device, card)
    loop_all, loop_matrix, loop_lc = beside(note, phase_loop_closing_system, device, card,
                                            loop_seq)
    print(f"elapsed {time.perf_counter() - t_start:.1f} s after phase 18")
    host_i_launches, host_i_matrix = host_inertial.result()
    print(f"elapsed {time.perf_counter() - t_start:.1f} s after phase 16 (beside phases 17-18)")

    # 19. inertial loop closing (a: a drifted inertial map, b: the post-loop
    # global BA of phase 13's map), 20. the Atlas map merge, 21. the threads
    # (a: the closer's and the global BA's, b: the stereo-inertial System with
    # async mapping)
    inertial_loop = phase_inertial_loop_map(device, card)
    phase_inertial_global_ba(inertial_system, seq_i, card)
    del inertial_system
    print(f"elapsed {time.perf_counter() - t_start:.1f} s after phase 19")
    merge_all, merge = phase_map_merge(device, card)
    merge_sys_all, merge_sys_matrix, merge_sys = phase_map_merge_system(device, card, loop_seq)
    print(f"elapsed {time.perf_counter() - t_start:.1f} s after phase 20")
    threads_lc = phase_loop_threads(device, card)
    async_i_launches, async_i_matrix = phase_system_inertial_async(device, seq_i, card, atlas21)
    print(f"elapsed {time.perf_counter() - t_start:.1f} s after phase 21")

    # 24-25 (below) in `side`, beside 22. EuRoC's distorted pair (a:
    # stereo-inertial, rectified; b: resized), 23. TUM-VI's KB8 fisheye pair
    # (a: stereo-inertial; b: card against CPU)
    mono = side.submit(beside, "timed beside phases 22-23 in another process", phases_mono,
                       device, seq, card)
    t0 = time.perf_counter()
    seq_r, seq_f = radtan_seq.result(), kb8_seq.result()
    print(f"rendered {N_RIG_FRAMES} frames of a radtan pair at {W}x{H} and {N_RIG_FRAMES} of a "
          f"KB8 pair at {KB8_SIZE}x{KB8_SIZE} with their IMU streams (waited "
          f"{time.perf_counter() - t0:.1f} s for them)")
    note = "timed beside phases 24-25 in another process"
    rect_launches, rect_matrix = beside(note, phase_rectified_inertial, device, seq_r,
                                        synthetic.euroc_radtan_rig(W, H), card)
    resize_launches, resize_matrix = beside(note, phase_resize, device, seq_r,
                                            synthetic.euroc_radtan_rig(W, H), card)
    print(f"elapsed {time.perf_counter() - t_start:.1f} s after phase 22")
    kb8_rig = synthetic.tumvi_kb8_rig(KB8_SIZE, KB8_SIZE, fov_deg=KB8_FOV_DEG)
    fish_launches, fish_matrix, fish_k2 = beside(note, phase_fisheye_inertial, device, seq_f,
                                                 kb8_rig, card)
    fish_cpu_launches, fish_cpu_matrix = phase_fisheye_card_vs_cpu(device, seq_f, kb8_rig, card)
    print(f"elapsed {time.perf_counter() - t_start:.1f} s after phase 23")

    (mono_launches, mono_matrix, mono_cpu_launches, mono_cpu_matrix, mi_launches,
     mi_matrix) = mono.result()
    print(f"elapsed {time.perf_counter() - t_start:.1f} s after phases 24-25 (beside phases 22-23)")

    # 26. the RGB-D System (a: default configuration; b: with an IMU; c: card
    # against CPU)
    t0 = time.perf_counter()
    scene = rgbd_scene.result()
    print(f"rendered {N_RGBD_INERTIAL_FRAMES} frames at {RGBD_W}x{RGBD_H} with their depth maps "
          f"and IMU stream (waited {time.perf_counter() - t0:.1f} s for them)")
    rgbd_launches, rgbd_matrix, rgbd_log = phase_rgbd_system(device, scene, card)
    rgbd_i_launches, rgbd_i_matrix = phase_rgbd_inertial_system(device, scene, card)
    rgbd_cpu_launches, rgbd_cpu_matrix = phase_rgbd_card_vs_cpu(device, scene, card, rgbd_log)
    del scene, rgbd_log
    print(f"elapsed {time.perf_counter() - t_start:.1f} s after phase 26")

    # 27. atlas save and load, the KITTI driver (a: a visual map reused; b:
    # an inertial map through the settings; c: KITTI at KITTI's size)
    atlas_launches, atlas_matrix = phase_atlas_reuse(device, seq, card, atlas17, reloc_saved)
    atlas_i_launches, atlas_i_matrix = phase_atlas_inertial(device, seq_i, card, atlas21)
    t0 = time.perf_counter()
    kitti_root = kitti_layout.result()
    print(f"rendered {N_KITTI_FRAMES} frames at {KITTI_W}x{KITTI_H} in KITTI's layout (waited "
          f"{time.perf_counter() - t0:.1f} s for them)")
    kitti_launches, kitti_matrix, kitti_shapes, kitti_matrix_shapes = phase_kitti(
        device, card, kitti_root)
    print(f"elapsed {time.perf_counter() - t_start:.1f} s after phase 27")

    # 28. multi-device (a: the sharded BA at 1, 2, 4 shards of the card; b:
    # two processes over gloo; c: the mapper with a mesh; d: sharded extraction)
    t0 = time.perf_counter()
    multi = phase_multi_device(device, card, seq)
    print(f"elapsed {time.perf_counter() - t_start:.1f} s after phase 28 (phase 28 "
          f"{time.perf_counter() - t0:.1f} s)")

    search, local_map = matrix_rows[(2048, 1024)], topk_rows[(4096, 1024, TOP_K)]
    top2, epi, fusion = topk_rows[(1024, 1024, 2)], topk_rows[(EPI_ROWS, 1024, TOP_K)], \
        matrix_rows[FUSION_SHAPE]
    top1 = topk_rows[(1024, 4096, 1)]
    timed = ("ms", "plain_ms", "bound_ms", "bound_by", "timer")
    print(json.dumps({"kernels": [
        {
            "name": "hamming_penalty_topk",
            "route": "cuda",
            "source": "fasttrack_tpu_torch/ops/csrc/hamming_topk.cu",
            "replaces": "fasttrack_tpu/ops/pallas_kernels.py:44",
            "launches": hot_launches + fused_launches + tracker_launches + system_launches
            + inertial_launches + toggle_launches + host_i_launches + reloc_all
            + map_launches["topk"] + loop_all + inertial_loop["topk"] + merge_all["topk"]
            + merge_sys_all + threads_lc["topk"] + async_i_launches + rect_launches
            + resize_launches + fish_launches + fish_cpu_launches + mono_launches
            + mono_cpu_launches + mi_launches + rgbd_launches + rgbd_i_launches
            + rgbd_cpu_launches + atlas_launches + atlas_i_launches + kitti_launches,
            "launches_hot_path": hot_launches,
            "launches_fused_step": fused_launches,
            "launches_tracker": tracker_launches,
            "launches_system": system_launches,
            "launches_system_inertial": inertial_launches,
            "launches_toggle_matrix": toggle_launches,
            "launches_system_inertial_mask_0000": host_i_launches,
            # phases 17-18: by relocalization (K = 2) and by the loop closer
            # (K = 1 and K = 2, the drifted map and the System over the loop)
            "launches_relocalization": reloc_launches,
            "launches_loop_closing": map_launches["k1"] + map_launches["k2"]
            + loop_lc["k1"] + loop_lc["k2"],
            "launches_place_recognition_phases": reloc_all + map_launches["topk"] + loop_all,
            # phases 19-21: the inertial loop (19a; 19b launches none), the
            # map merge (20a) and the part of it that _merge_maps made (its
            # K = 2 verification), the threads (21a) and the stereo-inertial
            # System with async mapping (21b, all its threads)
            "launches_inertial_loop_closing": inertial_loop["topk"],
            "launches_map_merge_phase": merge_all["topk"],
            "launches_map_merge_system": merge_sys_all,
            "launches_merge": merge["k2"] + merge_sys["k2"],
            "launches_loop_threads": threads_lc["topk"],
            "launches_system_inertial_async": async_i_launches,
            # phases 22-23: the rectified EuRoC pair (inertial, resized), the
            # KB8 pair (inertial; the visual System's frames of 23b on the card)
            "launches_rectified_inertial": rect_launches,
            "launches_resized": resize_launches,
            "launches_fisheye_inertial": fish_launches,
            "launches_fisheye_visual": fish_cpu_launches,
            # phase 24: the monocular System (a), its first frames on the card (b)
            "launches_monocular": mono_launches,
            "launches_monocular_card_vs_cpu": mono_cpu_launches,
            # phase 25a: the monocular-inertial System
            "launches_monocular_inertial": mi_launches,
            # phase 26: the RGB-D System (a), with an IMU (b), its first
            # frames on the card (c)
            "launches_rgbd": rgbd_launches,
            "launches_rgbd_inertial": rgbd_i_launches,
            "launches_rgbd_cpu": rgbd_cpu_launches,
            # phase 27: after an atlas load (a: visual, b: inertial), the
            # KITTI driver (c), with its launches by (M, N, K)
            "launches_atlas": atlas_launches,
            "launches_atlas_inertial": atlas_i_launches,
            "launches_kitti": kitti_launches,
            "launches_kitti_by_shape": {str(k): v for k, v in sorted(kitti_shapes.items())},
            # phase 28: the multi-device paths launch neither kernel (K16)
            "launches_multi_device": multi["launches"],
            "max_abs_err": topk_err,
            "index_mismatches": mismatches,
            "shape": [4096, 1024],
            "ms": local_map["ms"],
            "plain_ms": local_map["plain_ms"],
            "bound_ms": local_map["bound_ms"],
            "bound_by": local_map["bound_by"],
            "timer": local_map["timer"],
            "library_ms": None,   # no one PyTorch call computes it; see the two below
            "replaced_ms": local_map["replaced_ms"],
            "matrix_plus_torch_topk_ms": local_map["matrix_plus_torch_topk_ms"],
            # its second use: match_fisheye's best and second best (K = 2)
            "k2": {"shape": [1024, 1024], "k": 2, "launches_tracker": tracker_k2,
                   "launches_fisheye_frames": fish_k2,
                   **{key: top2[key] for key in timed + (
                       "replaced_ms", "matrix_plus_torch_topk_ms")}},
            # K = 1: the flat vocabulary's quantization (the loop closers of
            # phases 18a, 19a, 20a and 21a), and past MAX_N words in chunks
            "k1": {"shape": [1024, 4096], "k": 1,
                   "launches_loop_closing": map_launches["k1"] + loop_lc["k1"]
                   + inertial_loop["k1"] + merge_all["k1"] + threads_lc["k1"],
                   "launches_system_inertial": inertial_lc["k1"],
                   **{key: top1[key] for key in timed + (
                       "replaced_ms", "matrix_plus_torch_argmin_ms")},
                   "chunked": {"shape": list(CHUNKED_SHAPE), "mismatches": chunked_bad,
                               **chunked}},
            # past MAX_N keys (ROADMAP F46): one launch per chunk, merged on the card
            "past_max_n": {"mismatches": past_max_n_bad, **past_max_n},
            # at KITTI's widths (phase 27c's shapes, held in phase 3)
            "kitti": {f"{M}x{N}, K {K}": {key: topk_rows[(M, N, K)][key] for key in timed + (
                "replaced_ms", "matrix_plus_torch_topk_ms")} for M, N, K in KITTI_TOPK_SHAPES},
            # its third: the local mapper's triangulation, 10 neighbour keyframes stacked
            "triangulation": {"shape": [EPI_ROWS, 1024], "k": TOP_K,
                              "launches_system": system_epi,
                              **{key: epi[key] for key in timed + (
                                  "replaced_ms", "matrix_plus_torch_topk_ms")}},
        },
        {
            "name": "hamming_penalty",
            "route": "cuda",
            "source": "fasttrack_tpu_torch/ops/csrc/hamming_penalty.cu",
            "replaces": "fasttrack_tpu/ops/pallas_kernels.py:44",
            # the system paths alone launch it (map-point fusion)
            "launches": hot_matrix + fused_matrix + tracker_matrix + system_matrix
            + inertial_matrix + toggle_matrix + host_i_matrix + reloc_matrix
            + map_launches["matrix"] + loop_matrix + inertial_loop["matrix"]
            + merge_all["matrix"] + merge_sys_matrix + threads_lc["matrix"] + async_i_matrix
            + rect_matrix + resize_matrix + fish_matrix + fish_cpu_matrix + mono_matrix
            + mono_cpu_matrix + mi_matrix + rgbd_matrix + rgbd_i_matrix + rgbd_cpu_matrix
            + atlas_matrix + atlas_i_matrix + kitti_matrix,
            "on_a_driven_path": system_matrix > 0 and inertial_matrix > 0,
            "launches_hot_path": hot_matrix,
            "launches_fused_step": fused_matrix,
            "launches_tracker": tracker_matrix,
            "launches_system": system_matrix,
            "launches_system_inertial": inertial_matrix,
            "launches_toggle_matrix": toggle_matrix,
            "launches_system_inertial_mask_0000": host_i_matrix,
            # the loop closer's fusion (SearchAndFuse) after a closure
            "launches_loop_closing": map_launches["matrix"] + loop_lc["matrix"],
            "launches_place_recognition_phases": reloc_matrix + map_launches["matrix"]
            + loop_matrix,
            "launches_inertial_loop_closing": inertial_loop["matrix"],
            "launches_map_merge_phase": merge_all["matrix"],
            "launches_map_merge_system": merge_sys_matrix,
            # the weld's fusion, one per target keyframe (phases 20a and 20b)
            "launches_merge": merge["matrix"] + merge_sys["matrix"],
            "launches_loop_threads": threads_lc["matrix"],
            "launches_system_inertial_async": async_i_matrix,
            "launches_rectified_inertial": rect_matrix,
            "launches_resized": resize_matrix,
            "launches_fisheye_inertial": fish_matrix,
            "launches_fisheye_visual": fish_cpu_matrix,
            "launches_monocular": mono_matrix,
            "launches_monocular_card_vs_cpu": mono_cpu_matrix,
            "launches_monocular_inertial": mi_matrix,
            "launches_rgbd": rgbd_matrix,
            "launches_rgbd_inertial": rgbd_i_matrix,
            "launches_rgbd_cpu": rgbd_cpu_matrix,
            "launches_atlas": atlas_matrix,
            "launches_atlas_inertial": atlas_i_matrix,
            "launches_kitti": kitti_matrix,
            "launches_kitti_by_shape": {str(k): v for k, v in sorted(kitti_matrix_shapes.items())},
            "launches_multi_device": multi["matrix_launches"],
            "max_abs_err": matrix_err,
            "shape": [2048, 1024],
            "ms": search["ms"],
            "plain_ms": search["plain_ms"],
            "bound_ms": search["bound_ms"],
            "bound_by": search["bound_by"],
            "timer": search["timer"],
            # torch._int_mm of the +-1 descriptors: the product the kernel
            # computes in its body, without the penalties
            "library_ms": search["library_ms"],
            "library": "torch._int_mm (product only, no penalties)",
            "library_ms_by_shape": {f"{M}x{N}": matrix_rows[(M, N)]["library_ms"]
                                    for M, N in MATRIX_SHAPES},
            "fusion": {"shape": list(FUSION_SHAPE),
                       **{key: fusion[key] for key in timed + ("library_ms",)}},
            "kitti_fusion": {f"{M}x{N}": {key: matrix_rows[(M, N)][key]
                                          for key in timed + ("library_ms",)}
                             for M, N in KITTI_FUSION_SHAPES},
        },
    ]}))
    check(inertial_launches > 0 and inertial_matrix > 0,
          "a kernel was not launched on the stereo-inertial path")
    check(reloc_all > 0 and reloc_matrix > 0 and map_launches["k1"] > 0 and loop_all > 0
          and loop_matrix > 0, "a kernel was not launched on the place-recognition paths")
    check(inertial_loop["k1"] > 0 and inertial_loop["k2"] > 0 and merge["k2"] > 0
          and merge["matrix"] > 0 and threads_lc["topk"] > 0 and async_i_launches > 0
          and async_i_matrix > 0, "a kernel was not launched on the paths of phases 19-21")
    check(rect_launches > 0 and rect_matrix > 0 and resize_launches > 0 and fish_launches > 0
          and fish_k2 > 0 and fish_matrix > 0 and fish_cpu_launches > 0,
          "a kernel was not launched on the paths of phases 22-23")
    check(mono_launches > 0 and mono_matrix > 0 and mono_cpu_launches > 0,
          "a kernel was not launched on the paths of phase 24")
    check(mi_launches > 0 and mi_matrix > 0,
          "a kernel was not launched on the paths of phase 25")
    check(min(rgbd_launches, rgbd_matrix, rgbd_i_launches, rgbd_i_matrix, rgbd_cpu_launches,
              rgbd_cpu_matrix) > 0, "a kernel was not launched on the paths of phase 26")
    check(min(atlas_launches, atlas_matrix, atlas_i_launches, atlas_i_matrix, kitti_launches,
              kitti_matrix) > 0, "a kernel was not launched on the paths of phase 27")
    print(f"chip_smoke: all 28 phases passed in {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()

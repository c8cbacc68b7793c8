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
   ragged ones, N < K, an input built to tie, K = 2 as match_fisheye
   calls it (validity penalties of 1e9, so that whole rows tie), and K = 1
   as the flat vocabulary's quantization calls it (1024 x 4096, zero
   penalties; with rows tied at 1e9; a tied 700 x 64) beside matrix kernel
   + torch.argmin, and K = 1 past the kernel's 4,096 words as `_assign`
   runs it for a wider vocabulary (1024 x 5000 in two launches merged on
   the card, rows tied across and inside the chunks); device
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
   frames, map-point counts and poses;
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
   N_TOGGLE_FRAMES frames of phase 8's sequence through seven trackers in
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
16. the stereo-inertial system under mask 0000 (BASELINE.md's CPU row):
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
   states, paths, keyframes, poses within 1e-3.

Phase 3 also times torch._int_mm of the +-1 descriptors at the matrix
kernel's four shapes: the int8 product the kernel computes in its body
(Hamming = (256 - q.k) / 2), without the penalties, as its library
yardstick.

Phases 8 to 12 and 15 share one rendered sequence: phase 8 tracks its first 40
frames with no mapper, so that its ATE stands beside the system's over the
same frames. Phases 13, 16 and 21b share another; phase 19b adjusts phase
13's map.

The line before the last two is a JSON object of the kernels; the last is
{"ok": true, "device": {...}}. Each kernel's `launches` is what the
nineteen paths (phases 4, 6, 8, 10, 13, 15, 16, 17, 18a, 18b, 19a, 20a, 20b,
21a, 21b, 22a, 22b, 23a and 23b's card run) launched, counted from 0 at each path's start (phase 19b launches
neither); `launches_relocalization` and `launches_loop_closing` are the
part of phases 17-18 that relocalization and the loop closer made, and
`launches_merge` the part of phases 20a and 20b that `_merge_maps` made
(the top-K kernel's K = 2 verification, the matrix kernel's fusion at the
weld). The matrix kernel is launched by the system paths alone (map-point
fusion); no tracker path calls it since its top-K was fused.
Imports nothing of JAX.
"""

import concurrent.futures
import dataclasses
import json
import multiprocessing
import subprocess
import sys
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
from fasttrack_tpu_torch.ops.extractor import OrbConfig
from fasttrack_tpu_torch.ops.stereo_match import valid_penalty
from fasttrack_tpu_torch.ops.topk import top_k
from fasttrack_tpu_torch.optim import ba_core
from fasttrack_tpu_torch.optim.inertial import local_inertial_ba
from fasttrack_tpu_torch.settings import Settings
from fasttrack_tpu_torch.slam_map import Atlas
from fasttrack_tpu_torch.system import Sensor, System
from fasttrack_tpu_torch.tracking import Tracker

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
MATRIX_SHAPES = [(1024, 1024), (2048, 1024), (4096, 1024), (1200, 1000), FUSION_SHAPE]
EPI_ROWS = 10 * 1024            # the mapper's 10 neighbour keyframes, stacked
# (M, N, kind of input, K); 33 x 40 has N < K. "validity": what match_fisheye
# gives the kernel (penalties 0 or 1e9, invalid rows tie across all columns).
TOPK_CASES = [(1024, 1024, "random", 64), (2048, 1024, "random", 64), (4096, 1024, "random", 64),
              (1200, 1000, "random", 64), (33, 40, "random", 64), (1024, 1024, "tied", 64),
              (1024, 1024, "validity", 2), (1000, 900, "validity", 2), (1024, 1024, "tied", 2),
              (EPI_ROWS, 1024, "validity", 64), (1024, 4096, "words", 1),
              (1024, 4096, "validity", 1), (700, 64, "tied", 1)]
# K = 1: the flat vocabulary's quantization (bow/vocabulary.py:_assign), the
# shipped flat vocabulary's 4096 words at the kernel's MAX_N, zero penalties
CHUNKED_SHAPE = (1024, 5000)    # K = 1 past MAX_N: a wider flat vocabulary in two launches
N_SYSTEM_FRAMES = 100           # the rendered sequence; phases 10 and 12 (its first 40)
N_TRACKER_FRAMES = 40           # of them, phase 8 (no mapper)
N_TRACKER_CPU_FRAMES = 6        # of them, again on the CPU in phase 9
# ATE RMSE limit of phase 8 (m). The same 40 frames through Tracker(device="cpu")
# give 0.0033 m; the limit leaves room for f32 sums taken in another order and
# for a keyframe decision that falls a frame earlier or later.
ATE_LIMIT_M = 0.02
N_ASYNC_FRAMES = 50             # phase 12: three keyframes, one adjustment
MAX_SYSTEM_CPU_FRAMES = 48      # phase 11 stops after the frame that follows the third keyframe
N_INERTIAL_FRAMES = 160         # phase 13: 8 s, IMU init at ~2 s, the 5 s full-BA stage after it
N_REPLAY_FRAMES = 3             # phase 14: inertial fused frames replayed on the CPU
# Phases 15 and 16 run the host extractor, whose NumPy pyramid takes ~2 s a
# frame on the card's host; phase 15 is cut from 40 frames to 24, then to 12
# (medians over the last 10) to make room for phases 22-23, so that the
# whole run stays inside its time limit
N_TOGGLE_FRAMES = 12            # phase 15: of phase 8's sequence, per configuration
N_HOST_INERTIAL_FRAMES = 60     # phase 16: of phase 13's sequence (IMU init at frame 40)
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
    the rows and columns at 1e9: such a row ties across all its columns)."""
    if kind == "words":
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


def tracker_step(tracker, frame, entry=None, imu=None) -> dict:
    """One frame of the rendered sequence through `track_stereo` of `entry`
    (a System; by default the tracker itself), with the IMU samples `imu`
    if given, timed on the host's clock (the call ends after its last
    fetch), and what the checks read. A frame went stepwise if it recorded
    `orb_extraction` (the fused path records it only when it falls back)."""
    series = tracker.stats.series
    counts = {k: len(series[k]) for k in ("orb_extraction", "device_fetches", "store_uploads")}
    kern = hamming_kernel.hamming_penalty_topk
    launches, top2 = kern.launches, kern.launches_by_k[2]
    if tracker.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    if imu is None:
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
        "mp_ids": last.mp_ids.copy(), "R": last.R_cw.copy(), "t": last.t_cw.copy(),
    }


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
    hamming_kernel.hamming_penalty_matrix.launches = 0
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

    def solve(prob, cam, bf):
        res = inner(prob, cam, bf)

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


def phase_system_card_vs_cpu(seq, card_log):
    """The first frames through System(device="cpu"), as far as the frame
    after the third keyframe (one bundle adjustment): the same state, path
    and keyframe frames, map-point count within 2%, poses within 1e-3 (the
    adjustment sums in another order on the card)."""
    made = np.cumsum([len(r["mapped"]) for r in card_log])
    check(made[-1] >= 3 and int(np.argmax(made >= 3)) + 2 <= MAX_SYSTEM_CPU_FRAMES,
          f"the card's keyframes by frame: {made.tolist()}")
    third = int(np.argmax(made >= 3))
    n = third + 2
    system = make_system(seq, "cpu")
    worst = {"frames": n, "third_keyframe_at": third, "pose_R_maxdiff": 0.0, "pose_t_maxdiff": 0.0,
             "mappoints_maxdiff": 0}
    for i, frame in enumerate(seq.frames[:n]):
        cpu, card = tracker_step(system.tracker, frame, entry=system), card_log[i]
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
    system.shutdown()
    worst["bundle_adjustments"] = int(sum(system.stats.series["lm_local_bas"]))
    worst["keyframes"] = system.atlas.current.n_keyframes()
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
                         async_mapping=False) -> System:
    """The stereo-inertial system at full width, built directly (no YAML):
    the renderer's body frame is the left camera's (T_b_c1 = I) and its IMU
    stream is exact at 200 Hz; the noise densities are the settings'
    defaults (EuRoC's). Phases 13 and 21b run its default configuration,
    the shipped vocabulary (vocabulary=None); phase 16 runs without place
    recognition, the input its bound was set on."""
    settings = Settings(
        camera1=make_pinhole(seq.fx, seq.fy, seq.cx, seq.cy, W, H, device=device),
        bf=seq.fx * seq.baseline, baseline=seq.baseline, width=W, height=H,
        n_features=CFG.n_features, n_levels=CFG.n_levels, scale_factor=CFG.scale_factor,
        T_b_c1=np.eye(4), imu_frequency=200.0,
    )
    return System(settings, Sensor.IMU_STEREO, kernel_config=kernel_config,
                  async_mapping=async_mapping, vocabulary=vocabulary, device=device)


def imu_between(seq, t0, t1):
    """The IMU samples in (t0, t1] as (t, acc, gyro), what track_stereo takes."""
    sel = np.where((seq.imu_t > t0) & (seq.imu_t <= t1))[0]
    return [(float(seq.imu_t[i]), seq.imu_acc[i], seq.imu_gyro[i]) for i in sel]


def record_inertial_programs():
    """Wraps the tracker's tlm_step_vi and the mapper's local_inertial_ba:
    the first N_REPLAY_FRAMES calls of the one and the first call of the
    other are kept with their inputs and outputs for phase 14. Returns the
    record and a function that puts both back."""
    rec = {"tlm_step_vi": [], "local_inertial_ba": []}
    inner_tlm, inner_ba = tracking.tlm_step_vi, local_mapping.local_inertial_ba

    def tlm_step_vi(*args):
        out = inner_tlm(*args)
        if len(rec["tlm_step_vi"]) < N_REPLAY_FRAMES:
            rec["tlm_step_vi"].append((args, out))
        return out

    def local_ba(*args):
        out = inner_ba(*args)
        if not rec["local_inertial_ba"]:
            rec["local_inertial_ba"].append((args, out))
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

    def ms(rows):
        v = [r["ms"] for r in rows]
        return (float(np.median(v)), float(np.percentile(v, 90)), len(v)) if v else (0.0, 0.0, 0)

    after = log[init_frame + 1:]
    times = {
        "fused inertial frames without a keyframe":
            ms([r for r in fused[N_WARMUP:] if not r["mapped"]]),
        "stepwise frames without a keyframe, after IMU init":
            ms([r for r in after if r["path"] == "stepwise" and not r["mapped"]]),
        "stepwise frames before IMU init, no keyframe":
            ms([r for r in log[1:init_frame] if not r["mapped"]]),
        "frames with a keyframe": ms([r for r in log[1:] if r["mapped"]]),
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
    (args, card), = rec["local_inertial_ba"]
    prob = args[0]
    dtype = prob.points.dtype
    windows = {}
    other = torch.float32 if dtype == torch.float64 else torch.float64
    for name, card_res, a in (
        (str(dtype).split(".")[-1], card, args),
        (str(other).split(".")[-1], None, (with_float(prob, other),) + tuple(args[1:])),
    ):
        if card_res is None:
            card_res = local_inertial_ba(*a)
        host = local_inertial_ba(*to_device(a, cpu))
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
    try:
        for f in seq.frames[:N_TOGGLE_FRAMES]:
            for tr, log in zip(trackers, logs):
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
        check(ate["n"] == N_TOGGLE_FRAMES and ate["rmse"] < ATE_LIMIT_M,
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

    def ms(rows):
        v = [r["ms"] for r in rows]
        return (float(np.median(v)), float(np.percentile(v, 90)), len(v)) if v else (0.0, 0.0, 0)

    times = {
        "before IMU init, no keyframe": ms([r for r in log[2:init_frame] if not r["mapped"]]),
        "after IMU init, no keyframe": ms([r for r in log[init_frame + 1:] if not r["mapped"]]),
        "frames with a keyframe": ms([r for r in log[1:] if r["mapped"]]),
    }
    series = system.stats.series
    print(
        f"phase 16 stereo-inertial system, mask 0000 PO on, inline mapping: {len(log)} frames at "
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


def phase_relocalization(device, seq, card):
    """Relocalization on the card: the default System over phase 10's
    sequence, lost on blank frames, then shown the start of the sequence
    again (tests/test_tracking_e2e.py's offset view at full size)."""
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
        f"phase 17 relocalization: System(Sensor.STEREO) with the shipped vocabulary on {card}, "
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
        f"{matrix.launches}"
    )
    return kern.launches, matrix.launches, reloc_launches


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
        f"phase 18a loop closing, drifted map: {len(rows)} keyframes (6 outbound, 3 returning with "
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
        f"phase 18b loop closing, System(Sensor.STEREO) with the shipped vocabulary over "
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


def phase_system_inertial_async(device, seq, card):
    """(b) The stereo-inertial System in its default configuration with
    mapping on its own thread: the tracker's thread, the mapper's and the
    loop closer's (and a global BA's, if a loop closes) share the card and
    the map."""
    kern = reset_launch_counts()
    matrix = hamming_kernel.hamming_penalty_matrix
    system = make_inertial_system(seq, device, vocabulary=None, async_mapping=True)
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

    def ms(rows):
        v = [r["ms"] for r in rows]
        return (float(np.median(v)), float(np.percentile(v, 90)), len(v)) if v else (0.0, 0.0, 0)

    times = {"all frames": ms(log[2:]),
             "fused": ms([r for r in log[2:] if r["path"] == "fused"]),
             "stepwise": ms([r for r in log[2:] if r["path"] == "stepwise"])}
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
        f"phase 22a rectified EuRoC pair, stereo-inertial, default configuration: "
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
        f"phase 22b input resize: {N_RESIZE_FRAMES} frames of phase 22a's {W}x{H} pair through "
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
        f"phase 23a KB8 fisheye pair, stereo-inertial, default configuration: {len(log)} "
        f"rendered {KB8_SIZE}x{KB8_SIZE} frames through System.track_stereo(..., imu=...) on "
        f"{card}: every frame OK; frame 0: {first['stereo']} keypoints with a triangulated "
        f"depth; one K = 2 launch (match_fisheye) per frame, {k2_fisheye} in all; IMU "
        f"initialized at frame {init}, |bg| {np.linalg.norm(bg):.5f} rad/s; {len(fused)} fused "
        f"frames (1 fetch each), {stepwise_after} of the {len(after)} frames after init "
        f"stepwise; keyframes processed {int(sum(system.stats.series['lm_keyframes']))}; "
        f"ATE RMSE {ate['rmse']:.4f} m (limit {ATE_LIMIT_M}; the trajectory moves "
        f"{ate['rms_motion']:.4f} m RMS; up to init {ate['rmse_before_init']:.4f}, after it "
        f"{ate['rmse_after_init']:.4f}); ms/frame "
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
    with concurrent.futures.ProcessPoolExecutor(1, mp_context=spawn) as renderer:
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
        )
        run_phases(device, kind, card, t_start, *sequences)


def run_phases(device, kind, card, t_start, system_seq, inertial_seq, loop_seq, radtan_seq,
               kb8_seq):
    """Phases 2-23, then the kernels line and the last lines; the arguments
    after `t_start` are the futures of the rendered sequences."""
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

    # 10. system, 11. card against CPU, 12. mapping on its own thread
    system_launches, system_matrix, system_epi, system_log = phase_system(
        device, seq, card, tracker_ate)
    phase_system_card_vs_cpu(seq, system_log)
    phase_system_async(device, seq, card)
    print(f"elapsed {time.perf_counter() - t_start:.1f} s after phases 10-12")

    # 13. stereo-inertial system, 14. its inertial programs card against CPU
    t0 = time.perf_counter()
    seq_i = inertial_seq.result()
    print(f"rendered {N_INERTIAL_FRAMES} stereo frames at {W}x{H} with their IMU stream "
          f"({len(seq_i.imu_t)} samples; waited {time.perf_counter() - t0:.1f} s for them)")
    inertial_launches, inertial_matrix, inertial_rec, inertial_system, inertial_lc = \
        phase_system_inertial(device, seq_i, card)
    phase_inertial_card_vs_cpu(inertial_rec)
    print(f"elapsed {time.perf_counter() - t_start:.1f} s after phases 13-14")

    # 15. BASELINE.md's toggle matrix on the tracker, 16. the inertial system under 0000
    toggle_launches, toggle_matrix, _ = phase_toggle_matrix(device, seq, card)
    print(f"elapsed {time.perf_counter() - t_start:.1f} s after phase 15")
    host_i_launches, host_i_matrix = phase_system_inertial_host(device, seq_i, card)
    print(f"elapsed {time.perf_counter() - t_start:.1f} s after phase 16")

    # 17. relocalization, 18. loop closing (a: a drifted map, b: the System over a loop)
    reloc_all, reloc_matrix, reloc_launches = phase_relocalization(device, seq, card)
    print(f"elapsed {time.perf_counter() - t_start:.1f} s after phase 17")
    map_launches, k13_launches, k13_ms = phase_loop_closing_map(device, card)
    loop_all, loop_matrix, loop_lc = phase_loop_closing_system(device, card, loop_seq)
    print(f"elapsed {time.perf_counter() - t_start:.1f} s after phase 18")

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
    async_i_launches, async_i_matrix = phase_system_inertial_async(device, seq_i, card)
    print(f"elapsed {time.perf_counter() - t_start:.1f} s after phase 21")

    # 22. EuRoC's distorted pair (a: stereo-inertial, rectified; b: resized),
    # 23. TUM-VI's KB8 fisheye pair (a: stereo-inertial; b: card against CPU)
    t0 = time.perf_counter()
    seq_r, seq_f = radtan_seq.result(), kb8_seq.result()
    print(f"rendered {N_RIG_FRAMES} frames of a radtan pair at {W}x{H} and {N_RIG_FRAMES} of a "
          f"KB8 pair at {KB8_SIZE}x{KB8_SIZE} with their IMU streams (waited "
          f"{time.perf_counter() - t0:.1f} s for them)")
    rect_launches, rect_matrix = phase_rectified_inertial(
        device, seq_r, synthetic.euroc_radtan_rig(W, H), card)
    resize_launches, resize_matrix = phase_resize(
        device, seq_r, synthetic.euroc_radtan_rig(W, H), card)
    print(f"elapsed {time.perf_counter() - t_start:.1f} s after phase 22")
    kb8_rig = synthetic.tumvi_kb8_rig(KB8_SIZE, KB8_SIZE, fov_deg=KB8_FOV_DEG)
    fish_launches, fish_matrix, fish_k2 = phase_fisheye_inertial(device, seq_f, kb8_rig, card)
    fish_cpu_launches, fish_cpu_matrix = phase_fisheye_card_vs_cpu(device, seq_f, kb8_rig, card)
    print(f"elapsed {time.perf_counter() - t_start:.1f} s after phase 23")

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
            + resize_launches + fish_launches + fish_cpu_launches,
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
            + rect_matrix + resize_matrix + fish_matrix + fish_cpu_matrix,
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
    print(f"chip_smoke: all 23 phases passed in {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()

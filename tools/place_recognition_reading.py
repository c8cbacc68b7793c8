#!/usr/bin/env python3
"""Relocalization and loop closing of the visual stereo System with its
default vocabulary, in either package, on the CPU, at the size of
`chip_smoke.py` phases 17 and 18b.

    python tools/place_recognition_reading.py --package torch|jax

Both scenarios run `System(settings, Sensor.STEREO)` of the package named
(the shipped vocabulary, inline mapping, 752x480, 1024 features, 8 levels)
on rendered sequences (datasets.synthetic, the same bits in both packages):

- relocalization (phase 17): the 100-frame sweep of phases 8-12; frames
  0-59, then 3 blank frames (the state must be RECENTLY_LOST), then frames
  0-11 again. Prints the state of every frame fed again, the first one at
  which tracking is OK (the frame of re-acquisition), how it got there (the
  reference keyframe or relocalization, with the BoW candidates of each
  relocalization attempt), the distance of the camera centre from the
  ground truth at that frame and at the last one (both in the first
  camera's frame), the number of maps, and the loops closed; then frame 59,
  the last one tracked before the blank frames, relocalized against the
  keyframe database itself (BoW, the K = 2 match, PnP, pose optimization,
  the rebind), since a re-acquisition through the reference keyframe does
  not run relocalization: whether it succeeded, its inliers and the
  distance of its camera centre from the ground truth;
- loop closing (phase 18b): 240 frames of the `trajectory="loop"` sequence
  (a 10 s lap every 200 frames at 20 Hz; the first N frames of it are the
  N-frame sequence for every N from 200 to 240). Prints each loop closure
  with the frame and keyframe at which it happened and the global BAs run,
  then the ATE RMSE (SE(3) alignment) over the first 200, 220 and 240
  frames. The loop closer runs inline, so one run answers for every
  shorter length.

Only the package named is imported. The readings of both packages set the
gates of phases 17 and 18b (PERF.md). `relocalization_reading(package)` and
`loop_closing_reading(package)` take one part each:

    python -c 'from tools.place_recognition_reading import relocalization_reading; relocalization_reading("jax")'
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

H, W = 480, 752                 # chip_smoke.py's CFG
N_FEATURES, N_LEVELS = 1024, 8
N_SWEEP_FRAMES = 100            # chip_smoke.py's N_SYSTEM_FRAMES: phase 17's sequence
N_TRACKED, N_BLANK, N_AGAIN = 60, 3, 12
N_LOOP_FRAMES = 240
ATE_AT = (200, 220, 240)


def _package(package):
    """(make_system, generate_sequence, absolute_trajectory_error) of the
    package named."""
    if package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from fasttrack_tpu.cameras import make_pinhole
        from fasttrack_tpu.datasets.synthetic import generate_sequence
        from fasttrack_tpu.evaluation.ate import absolute_trajectory_error
        from fasttrack_tpu.settings import Settings
        from fasttrack_tpu.system import Sensor, System

        cam_kw, sys_kw = {}, {}
    else:
        from fasttrack_tpu_torch.cameras import make_pinhole
        from fasttrack_tpu_torch.datasets.synthetic import generate_sequence
        from fasttrack_tpu_torch.evaluation.ate import absolute_trajectory_error
        from fasttrack_tpu_torch.settings import Settings
        from fasttrack_tpu_torch.system import Sensor, System

        cam_kw, sys_kw = dict(device="cpu"), dict(device="cpu")

    def make_system(seq):
        settings = Settings(
            camera1=make_pinhole(seq.fx, seq.fy, seq.cx, seq.cy, W, H, **cam_kw),
            bf=seq.fx * seq.baseline, baseline=seq.baseline, width=W, height=H,
            n_features=N_FEATURES, n_levels=N_LEVELS, scale_factor=1.2,
        )
        return System(settings, Sensor.STEREO, **sys_kw)

    return make_system, generate_sequence, absolute_trajectory_error


def centre_error(seq, R_cw, t_cw, i):
    R0, t0 = seq.frames[0].R_wc, seq.frames[0].t_wc
    return float(np.linalg.norm(-R_cw.T @ t_cw - R0.T @ (seq.frames[i].t_wc - t0)))


def relocalization_reading(package):
    make_system, generate_sequence, _ = _package(package)
    tag = f"{package} {W}x{H}"
    t_start = time.perf_counter()
    seq = generate_sequence(n_frames=N_SWEEP_FRAMES, h=H, w=W)
    system = make_system(seq)
    tracker = system.tracker
    attempts = []
    reloc, detect = tracker._relocalization, tracker.reloc_db.detect_relocalization_candidates

    def relocalization(frame):
        attempts.append({"frame": tracker.frame_id, "candidates": None})
        ok = reloc(frame)
        attempts[-1]["ok"] = ok
        return ok

    def detect_relocalization_candidates(*a, **kw):
        cands = detect(*a, **kw)
        attempts[-1]["candidates"] = cands
        return cands

    tracker._relocalization = relocalization
    tracker.reloc_db.detect_relocalization_candidates = detect_relocalization_candidates
    for f in seq.frames[:N_TRACKED]:
        system.track_stereo(f.left, f.right, f.timestamp)
    print(f"{tag} relocalization: frames 0-{N_TRACKED - 1} tracked, state "
          f"{system.tracking_state.name}, {system.atlas.current.n_keyframes()} keyframes, "
          f"{system.atlas.n_maps()} maps", flush=True)
    n_maps = system.atlas.n_maps()
    tracked = tracker.last_frame      # frame N_TRACKED - 1, relocalized directly below
    blank = np.full_like(seq.frames[0].left, 127)
    t = seq.frames[N_TRACKED - 1].timestamp
    for _ in range(N_BLANK):
        t += 0.05
        system.track_stereo(blank, blank, t)
    print(f"{tag} relocalization: after {N_BLANK} blank frames the state is "
          f"{system.tracking_state.name}", flush=True)
    back, states = None, []
    for i, f in enumerate(seq.frames[:N_AGAIN]):
        t += 0.05
        n_attempts = len(attempts)
        system.track_stereo(f.left, f.right, t)
        states.append(system.tracking_state.name)
        last = tracker.last_frame
        err = centre_error(seq, last.R_cw, last.t_cw, i)
        tried = attempts[n_attempts:]
        how = ("relocalization" if any(a["ok"] for a in tried)
               else "reference keyframe" if states[-1] == "OK" else "-")
        print(f"{tag} relocalization: frame {i} again: {states[-1]} ({how}; relocalization "
              f"attempts {[(a['candidates'], a['ok']) for a in tried]}), inliers "
              f"{tracker.n_inliers}, ref keyframe {tracker.ref_kf_id}, centre error {err:.4f} m",
              flush=True)
        if back is None and states[-1] == "OK":
            back = (i, err, how)
    system.shutdown()
    last = tracker.last_frame
    print(f"{tag} relocalization reading: re-acquired at frame "
          f"{None if back is None else back[0]} of the {N_AGAIN} fed again "
          f"({None if back is None else back[2]}), centre error there "
          f"{float('nan') if back is None else back[1]:.4f} m, at frame {N_AGAIN - 1} "
          f"{centre_error(seq, last.R_cw, last.t_cw, N_AGAIN - 1):.4f} m; maps {n_maps} -> "
          f"{system.atlas.n_maps()}; loops closed {system.loop_closer.n_loops_closed}; "
          f"{time.perf_counter() - t_start:.0f} s", flush=True)
    R_before, t_before = tracked.R_cw.copy(), tracked.t_cw.copy()
    ok = relocalization(tracked)
    moved = float(np.linalg.norm(-tracked.R_cw.T @ tracked.t_cw + R_before.T @ t_before))
    print(f"{tag} direct relocalization reading: frame {N_TRACKED - 1} relocalized against the "
          f"keyframe database: {ok} (candidates {attempts[-1]['candidates']}), inliers "
          f"{tracker.n_inliers}, centre error "
          f"{centre_error(seq, tracked.R_cw, tracked.t_cw, N_TRACKED - 1):.4f} m, "
          f"{moved:.4f} m from its tracked pose", flush=True)


def loop_closing_reading(package):
    make_system, generate_sequence, absolute_trajectory_error = _package(package)
    tag = f"{package} {W}x{H}"
    t_start = time.perf_counter()
    seq = generate_sequence(n_frames=N_LOOP_FRAMES, h=H, w=W, trajectory="loop")
    system = make_system(seq)
    lc = system.loop_closer
    loops, not_ok = [], []
    for i, f in enumerate(seq.frames):
        before = lc.n_loops_closed
        system.track_stereo(f.left, f.right, f.timestamp)
        if system.tracking_state.name != "OK":
            not_ok.append((i, system.tracking_state.name))
        if lc.n_loops_closed > before:
            loops.append((i, lc.last_loop_kf_id, lc.n_gba_runs))
            print(f"{tag} loop closing: loop closed at frame {i}, keyframe "
                  f"{lc.last_loop_kf_id}; global BAs {lc.n_gba_runs}", flush=True)
    system.shutdown()

    traj = system.tracker.trajectory
    ates = {}
    for n in ATE_AT:
        part = traj[:n]
        ates[n] = absolute_trajectory_error(
            np.asarray([ts for ts, _, _ in part]), np.asarray([-R.T @ tt for _, R, tt in part]),
            seq.gt_t, seq.gt_pos)["rmse"]
    print(f"{tag} loop closing reading: {N_LOOP_FRAMES} frames, loops closed "
          f"{lc.n_loops_closed} at (frame, keyframe, global BAs) {loops}, global BAs "
          f"{lc.n_gba_runs}, frames not OK {not_ok}, keyframes "
          f"{system.atlas.current.n_keyframes()}, maps {system.atlas.n_maps()}; ATE RMSE "
          + ", ".join(f"{ates[n]:.4f} m over the first {n}" for n in ATE_AT)
          + f"; {time.perf_counter() - t_start:.0f} s", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("torch", "jax"), required=True)
    args = ap.parse_args()
    relocalization_reading(args.package)
    loop_closing_reading(args.package)


if __name__ == "__main__":
    main()

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
  shorter length;
- the Atlas map merge (phase 20b), run only when asked for
  (`merge_reading`): frames 0-79 of the loop sequence, then 7 blank frames
  1 s apart, so that tracking stays lost past `time_recently_lost` (5 s
  after the first failed frame, a strict bound: 6 such frames span exactly
  5 s and the next frame re-acquires in the old map) and a new map starts,
  then frames 20-59 again, timestamps continuing. The new map's world is
  frame 20's camera, 1.47 m and 4.1 degrees from frame 0's (the old map's
  world), so the weld has a real offset to undo.
  Prints the maps created, each merge with its frame, the maps left, the
  loops closed, the frames not OK, and for the frames fed again the ATE
  RMSE (SE(3) alignment), all of them and those after the merging frame,
  and the distance of each camera centre from the truth in the first
  camera's frame without alignment (the old map's world): the smallest up
  to the merging frame, whose pose is logged before the weld, and the
  largest after it.

Only the package named is imported. The readings of both packages set the
gates of phases 17, 18b and 20b (PERF.md). `relocalization_reading(package)`,
`loop_closing_reading(package)` and `merge_reading(package)` take one part
each:

    python -c 'from tools.place_recognition_reading import relocalization_reading; relocalization_reading("jax")'
    python -c 'from tools.place_recognition_reading import merge_reading; merge_reading("torch")'
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
N_MERGE_TRACKED, N_MERGE_BLANK, N_MERGE_AGAIN = 80, 7, 40   # chip_smoke.py phase 20b
MERGE_AGAIN_FROM = 20           # the frames fed again: 20-59
MERGE_BLANK_DT = 1.0


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


def merge_reading(package):
    make_system, generate_sequence, absolute_trajectory_error = _package(package)
    tag = f"{package} {W}x{H}"
    t_start = time.perf_counter()
    # the first 80 frames of a loop sequence of 80 to 400 frames are the same
    # (one 10 s lap), so these are phase 20b's frames of phase 18b's sequence
    seq = generate_sequence(n_frames=N_MERGE_TRACKED, h=H, w=W, trajectory="loop")
    system = make_system(seq)
    lc, atlas = system.loop_closer, system.atlas
    created = [0]
    inner = atlas.create_new_map

    def create_new_map():
        created[0] += 1
        return inner()

    atlas.create_new_map = create_new_map
    merges, not_ok, log, attempts, other = [], [], [], [], []
    merge_maps, detect = lc._merge_maps, lc.db.detect_loop_candidates

    def _merge_maps(kf, m_new, m_old, cand):
        ok = merge_maps(kf, m_new, m_old, cand)
        attempts.append((kf.kid, cand.kid, ok))
        return ok

    def detect_loop_candidates(bow, kf_id, *a, **kw):
        cands = detect(bow, kf_id, *a, **kw)
        m = atlas.current
        other.append((kf_id, [c for c in cands if c not in m.keyframes]))
        return cands

    lc._merge_maps = _merge_maps
    lc.db.detect_loop_candidates = detect_loop_candidates

    def feed(i, left, right, t, truth):
        merged = lc.n_maps_merged
        system.track_stereo(left, right, t)
        state = system.tracking_state.name
        if state != "OK":
            not_ok.append((i, state))
        if lc.n_maps_merged > merged:
            merges.append(i)
            print(f"{tag} merge: maps merged at fed frame {i} (frame {truth} of the sequence); "
                  f"maps {atlas.n_maps()}, keyframes {atlas.current.n_keyframes()}", flush=True)
        last = system.tracker.last_frame
        log.append((i, truth, t, state, last.R_cw.copy(), last.t_cw.copy()))

    for i, f in enumerate(seq.frames):
        feed(i, f.left, f.right, f.timestamp, i)
    print(f"{tag} merge: frames 0-{N_MERGE_TRACKED - 1} tracked, {atlas.current.n_keyframes()} "
          f"keyframes", flush=True)
    blank = np.full_like(seq.frames[0].left, 127)
    t = seq.frames[-1].timestamp
    for _ in range(N_MERGE_BLANK):
        t += MERGE_BLANK_DT
        feed(len(log), blank, blank, t, None)
    print(f"{tag} merge: after {N_MERGE_BLANK} blank frames the state is "
          f"{system.tracking_state.name}, maps {atlas.n_maps()} ({created[0]} created), keyframes "
          f"by map {[m.n_keyframes() for m in atlas.maps]} (a lost map of 10 keyframes or fewer "
          f"is cleared)", flush=True)
    first_again = len(log)
    for j in range(MERGE_AGAIN_FROM, MERGE_AGAIN_FROM + N_MERGE_AGAIN):
        f = seq.frames[j]
        t += 1.0 / 20.0
        feed(len(log), f.left, f.right, t, j)
    system.shutdown()
    again = [r for r in log[first_again:] if r[3] == "OK"]
    # the merging frame's own pose is logged in the new map's world: the
    # tracker records the frame after the inline mapper (and so the weld) ran
    after = [r for r in again if merges and r[0] > merges[0]]
    R0, t0 = seq.frames[0].R_wc, seq.frames[0].t_wc

    def centre_errors(rows):
        return [float(np.linalg.norm(-R.T @ tt - R0.T @ (seq.frames[j].t_wc - t0)))
                for _, j, _, _, R, tt in rows]

    def ate_of(rows):
        if len(rows) < 3:
            return float("nan")
        return absolute_trajectory_error(
            np.asarray([seq.frames[j].timestamp for _, j, _, _, _, _ in rows]),
            np.asarray([-R.T @ tt for _, _, _, _, R, tt in rows]),
            seq.gt_t, seq.gt_pos)["rmse"]

    ate, ate_after = ate_of(again), ate_of(after)
    err_after = centre_errors(after)
    err_before = centre_errors([r for r in again if not merges or r[0] <= merges[0]])
    print(f"{tag} merge reading: frames 0-{N_MERGE_TRACKED - 1}, {N_MERGE_BLANK} blank frames "
          f"{MERGE_BLANK_DT} s apart, frames {MERGE_AGAIN_FROM}-"
          f"{MERGE_AGAIN_FROM + N_MERGE_AGAIN - 1} again: maps created "
          f"{created[0]}, merges {lc.n_maps_merged} at fed frames {merges} (the frames fed again "
          f"start at {first_again}), maps left {atlas.n_maps()}, loops closed "
          f"{lc.n_loops_closed}, global BAs {lc.n_gba_runs}, frames not OK {not_ok}; merge "
          f"attempts (keyframe, candidate, welded) {attempts}; candidates in another map by "
          f"keyframe {[o for o in other if o[1]]}; the frames "
          f"fed again: {len(again)} OK, ATE RMSE {ate:.4f} m, of those after the merging frame "
          f"{ate_after:.4f} m; up to the merging frame, the smallest "
          f"camera centre error in the old map's world "
          f"{min(err_before) if err_before else float('nan'):.4f} m (the offset of the new "
          f"map's world) over {len(err_before)} frames; after it, the largest camera "
          f"centre error in the old map's world {max(err_after) if err_after else float('nan'):.4f}"
          f" m over {len(err_after)} frames; {time.perf_counter() - t_start:.0f} s", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("torch", "jax"), required=True)
    args = ap.parse_args()
    relocalization_reading(args.package)
    loop_closing_reading(args.package)


if __name__ == "__main__":
    main()

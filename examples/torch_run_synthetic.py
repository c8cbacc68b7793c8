#!/usr/bin/env python3
"""Self-contained end-to-end demo of the PyTorch/CUDA port
(fasttrack_tpu_torch), the counterpart of examples/run_synthetic.py: stereo
tracking on a rendered synthetic sequence with ATE evaluation (no dataset
needed; mirrors the reference's Examples/Stereo/stereo_euroc.cc driver
shape).

Usage: python examples/torch_run_synthetic.py [--frames N] [--mode 1111]
       [--po 1] [--out DIR] [--async-mapping] [--device cuda:0|cpu]

Runs `System(settings, Sensor.STEREO)` with the shipped vocabulary on the
CUDA device unless --device says otherwise, over a 320x240 sequence
rendered with seed 3. Writes f_traj.txt, kf_traj.txt, the stats
(summary.json and data/) and ate.json (against the renderer's exact
trajectory) into --out.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--mode", default="1111", help="offload bitmask (orb, stereo, slp, pe)")
    ap.add_argument("--po", type=int, default=1, help="pose optimization on/off")
    ap.add_argument("--out", default="synthetic_results")
    ap.add_argument("--async-mapping", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' for the CPU)")
    args = ap.parse_args(argv)

    from fasttrack_tpu_torch.cameras import make_pinhole
    from fasttrack_tpu_torch.datasets.synthetic import generate_sequence
    from fasttrack_tpu_torch.evaluation import absolute_trajectory_error
    from fasttrack_tpu_torch.kernels import KernelConfig
    from fasttrack_tpu_torch.settings import Settings
    from fasttrack_tpu_torch.system import Sensor, System

    print(f"Rendering {args.frames}-frame synthetic stereo sequence...")
    seq = generate_sequence(n_frames=args.frames, h=240, w=320, seed=3)

    s = Settings()
    s.width, s.height = 320, 240
    s.camera1 = make_pinhole(seq.fx, seq.fy, seq.cx, seq.cy, 320, 240, device=args.device)
    s.bf = seq.fx * seq.baseline
    s.baseline = seq.baseline
    s.th_depth = 60.0
    s.n_features = 512
    s.n_levels = 4

    kcfg = KernelConfig.from_bitmask(args.mode, pose_optimization=bool(args.po))
    system = System(s, Sensor.STEREO, kernel_config=kcfg,
                    async_mapping=args.async_mapping, device=args.device)

    t0 = time.perf_counter()
    for i, fr in enumerate(seq.frames):
        system.track_stereo(fr.left, fr.right, fr.timestamp)
        if i % 10 == 0:
            print(f"  frame {i:3d}  state={system.tracking_state.name} "
                  f"inliers={system.tracker.n_inliers}")
    wall = time.perf_counter() - t0
    system.shutdown()

    os.makedirs(args.out, exist_ok=True)
    system.save_trajectory_tum(os.path.join(args.out, "f_traj.txt"))
    system.save_keyframe_trajectory_tum(os.path.join(args.out, "kf_traj.txt"))
    system.save_stats(args.out)

    traj = system.tracker.trajectory
    t_est = np.asarray([t for t, _, _ in traj])
    p_est = np.asarray([-R.T @ t_ for _, R, t_ in traj])
    ate = absolute_trajectory_error(t_est, p_est, seq.gt_t, seq.gt_pos)
    ms = system.stats.mean("tracking_total")
    print(f"\ntracked {len(traj)}/{args.frames} frames | "
          f"mean tracking {ms:.2f} ms/frame | wall {wall:.1f}s")
    print(f"ATE rmse={ate['rmse']*100:.2f} cm  (n={ate['n']})")
    with open(os.path.join(args.out, "ate.json"), "w") as f:
        json.dump({"ate_rmse": ate["rmse"], "n_associated": ate["n"],
                   "gt": "synthetic-exact"}, f, indent=1)
    print(f"keyframes={system.atlas.current.n_keyframes()} "
          f"mappoints={system.atlas.current.n_mappoints()}")
    print(f"outputs in {args.out}")
    return system


if __name__ == "__main__":
    main()

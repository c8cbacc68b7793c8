#!/usr/bin/env python3
"""KITTI odometry stereo example of the PyTorch/CUDA port
(fasttrack_tpu_torch), the counterpart of examples/kitti_stereo.py, which
mirrors Examples/Stereo/stereo_kitti.cc: a rectified pair, a KITTI-format
trajectory out (one 3x4 pose per line).

Usage:
  python examples/torch_kitti_stereo.py SETTINGS.yaml SEQ_DIR \
      [--mode 1111] [--po 1] [--out results/] [--gt GT] [--async-mapping] \
      [--device cuda:0|cpu]

SEQ_DIR holds image_0/%06d.png, image_1/%06d.png and times.txt. Runs
`System(settings, Sensor.STEREO)` on the CUDA device unless --device says
otherwise, with the shipped vocabulary (relocalization, loop closing and
the Atlas map merge), as the JAX example does. --mode is the reference's
bitmask of offload toggles (ORB extraction, stereo matching, search local
points, pose estimation; 1 = device, 0 = host) and --po 0 bypasses pose
optimization. Writes f_traj_kitti.txt, kf_traj.txt and the stats into
--out, and with --gt the SE(3) ATE into ate.json.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("settings")
    ap.add_argument("sequence")
    ap.add_argument("--mode", default="1111")
    ap.add_argument("--po", type=int, default=1)
    ap.add_argument("--out", default="results")
    ap.add_argument("--gt", default=None,
                    help="ground-truth trajectory (EuRoC CSV or TUM "
                         "format) for ATE evaluation")
    ap.add_argument("--async-mapping", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' for the CPU)")
    args = ap.parse_args(argv)

    from fasttrack_tpu_torch.datasets import KittiSequence
    from fasttrack_tpu_torch.kernels import KernelConfig
    from fasttrack_tpu_torch.settings import load_settings
    from fasttrack_tpu_torch.system import Sensor, System

    settings = load_settings(args.settings, device=args.device)
    seq = KittiSequence(args.sequence)
    kcfg = KernelConfig.from_bitmask(args.mode, pose_optimization=bool(args.po))
    system = System(settings, Sensor.STEREO, kernel_config=kcfg,
                    async_mapping=args.async_mapping, device=args.device)

    t0 = time.perf_counter()
    for i in range(len(seq)):
        ts, left, right = seq[i]
        system.track_stereo(left, right, ts)
        if i % 100 == 0:
            print(f"frame {i}/{len(seq)} state={system.tracking_state.name}")
    wall = time.perf_counter() - t0
    system.shutdown()

    os.makedirs(args.out, exist_ok=True)
    system.save_trajectory_kitti(os.path.join(args.out, "f_traj_kitti.txt"))
    system.save_keyframe_trajectory_tum(os.path.join(args.out, "kf_traj.txt"))
    system.save_stats(args.out)
    print(f"done: {len(seq)} frames in {wall:.1f}s "
          f"({system.stats.mean('tracking_total'):.2f} ms/frame tracking)")
    if args.gt:
        from fasttrack_tpu_torch.evaluation import report_ate

        report_ate(system, args.gt, args.out, with_scale=False)
    return system


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""TUM RGB-D example of the PyTorch/CUDA port (fasttrack_tpu_torch), the
counterpart of examples/tum_rgbd.py, mirroring Examples/RGB-D/rgbd_tum.cc:
rgb.txt / depth.txt nearest-timestamp association, depth factor 5000, TUM
trajectory out.

Usage:
  python examples/torch_tum_rgbd.py SETTINGS.yaml SEQ_DIR \
      [--mode 1111] [--po 1] [--out results/] [--gt GT] [--async-mapping] \
      [--device cuda:0|cpu]

Runs `System(settings, Sensor.RGBD)` on the CUDA device unless --device
says otherwise, with the shipped vocabulary (relocalization and loop
closing), as the JAX example does. Only Camera1 of the settings is used,
and its distortion coefficients are ignored, as in the JAX package
(ROADMAP F30). The depth PNGs are read at the loader's factor of 5000: the
settings' DepthMapFactor is not read, in the JAX package either (ROADMAP
F42), so a sequence stored at another factor is read wrongly. --mode and
--po are taken as the JAX example takes them; the RGB-D front end reads no
toggle of its own (ROADMAP F41). --gt reports the ATE after an SE(3)
alignment into ate.json.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
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
    args = ap.parse_args()

    from fasttrack_tpu_torch.datasets import TumRgbdSequence
    from fasttrack_tpu_torch.kernels import KernelConfig
    from fasttrack_tpu_torch.settings import load_settings
    from fasttrack_tpu_torch.system import Sensor, System

    try:
        settings = load_settings(args.settings, device=args.device)
        seq = TumRgbdSequence(args.sequence)
        # the JAX example's hook: its Settings has no depth_map_factor, so
        # this never fires there or here (ROADMAP F42)
        if getattr(settings, "depth_map_factor", None):
            seq.depth_factor = settings.depth_map_factor
        kcfg = KernelConfig.from_bitmask(args.mode, pose_optimization=bool(args.po))
        system = System(settings, Sensor.RGBD, kernel_config=kcfg,
                        async_mapping=args.async_mapping, device=args.device)
    except NotImplementedError as e:
        sys.exit(str(e))

    t0 = time.perf_counter()
    for i in range(len(seq)):
        ts, rgb, depth = seq[i]
        system.track_rgbd(rgb, depth, ts)
        if i % 100 == 0:
            print(f"frame {i}/{len(seq)} state={system.tracking_state.name}")
    wall = time.perf_counter() - t0
    system.shutdown()

    os.makedirs(args.out, exist_ok=True)
    system.save_trajectory_tum(os.path.join(args.out, "f_traj.txt"))
    system.save_keyframe_trajectory_tum(os.path.join(args.out, "kf_traj.txt"))
    system.save_stats(args.out)
    print(f"done: {len(seq)} frames in {wall:.1f}s "
          f"({system.stats.mean('tracking_total'):.2f} ms/frame tracking)")
    if args.gt:
        from fasttrack_tpu_torch.evaluation import report_ate

        report_ate(system, args.gt, args.out, with_scale=False)


if __name__ == "__main__":
    main()

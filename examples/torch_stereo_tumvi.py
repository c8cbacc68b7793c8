#!/usr/bin/env python3
"""TUM-VI stereo(-inertial) fisheye example of the PyTorch/CUDA port
(fasttrack_tpu_torch), the counterpart of examples/stereo_tumvi.py and of
Examples/Stereo-Inertial/stereo_inertial_tum_vi.cc: the settings YAML
carries the KannalaBrandt8 camera pair and Stereo.T_c1_c2, which route the
System through the fisheye stereo path (Frame.cc:1115 fisheye ctor).

Usage:
  python examples/torch_stereo_tumvi.py SETTINGS.yaml SEQ_DIR \
      [--mode 1111] [--po 1] [--out results/] [--gt GT] [--imu] \
      [--async-mapping] [--device cuda:0|cpu]

Runs on the CUDA device unless --device says otherwise, with the shipped
vocabulary, over the sequence's mav0 layout (TumViSequence). --imu runs the
stereo-inertial system on mav0/imu0/data.csv (the samples between
consecutive frames go with the later one) and writes whether the IMU
initialized into ate.json beside the ATE; without that file it exits with
an error. --mode and --po are the offload toggles, as in
torch_stereo_euroc.py; the fisheye route extracts and matches on the device
whatever the mask, as in the JAX package (ROADMAP F22).
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
    ap.add_argument("--imu", action="store_true")
    ap.add_argument("--async-mapping", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; 'cpu' for the CPU)")
    args = ap.parse_args()

    from fasttrack_tpu_torch.datasets import TumViSequence
    from fasttrack_tpu_torch.kernels import KernelConfig
    from fasttrack_tpu_torch.settings import load_settings
    from fasttrack_tpu_torch.system import Sensor, System

    kcfg = KernelConfig.from_bitmask(args.mode, pose_optimization=bool(args.po))
    sensor = Sensor.IMU_STEREO if args.imu else Sensor.STEREO
    try:
        settings = load_settings(args.settings, device=args.device)
        seq = TumViSequence(args.sequence)
        if args.imu and seq.imu is None:
            sys.exit(f"--imu: {args.sequence} has no mav0/imu0/data.csv")
        system = System(settings, sensor, kernel_config=kcfg,
                        async_mapping=args.async_mapping, device=args.device)
    except NotImplementedError as e:
        sys.exit(str(e))

    t_prev = None
    t0 = time.perf_counter()
    for i in range(len(seq)):
        ts, left, right = seq[i]
        imu = None
        if args.imu and t_prev is not None:
            imu = seq.imu.between(t_prev, ts)
        system.track_stereo(left, right, ts, imu=imu)
        t_prev = ts
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

        extra = {"imu_initialized": bool(system.atlas.current.imu_initialized)} if args.imu else None
        report_ate(system, args.gt, args.out, with_scale=False, extra=extra)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""EuRoC stereo example of the PyTorch/CUDA port (fasttrack_tpu_torch), the
counterpart of examples/stereo_euroc.py: positional kernel-toggle flags,
dataset path + timestamps file + YAML settings, trajectory + stats out.

Usage:
  python examples/torch_stereo_euroc.py SETTINGS.yaml SEQ_DIR [TIMESTAMPS.txt] \
      [--mode 1111] [--po 1] [--out results/] [--gt GT] [--async-mapping] \
      [--device cuda:0|cpu]

Runs on the CUDA device unless --device says otherwise, with the shipped
vocabulary (loop closing and relocalization), as the JAX example does;
with --imu or --async-mapping it runs without place recognition and says
so on stderr (ROADMAP M7b). The settings must describe a rectified pinhole
pair. --imu runs the stereo-inertial system on
the sequence's mav0/imu0/data.csv with the settings' IMU block (the
samples between consecutive frames go with the later one), and writes
whether the IMU initialized into ate.json beside the ATE; without that file
it exits with an error. --mode is the reference's bitmask of offload
toggles (ORB extraction, stereo matching, search local points, pose
estimation; 1 = device, 0 = host) and --po 0 bypasses pose optimization.
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
    ap.add_argument("timestamps", nargs="?", default=None)
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

    from fasttrack_tpu_torch.datasets import EurocSequence
    from fasttrack_tpu_torch.kernels import KernelConfig
    from fasttrack_tpu_torch.settings import load_settings
    from fasttrack_tpu_torch.system import Sensor, System

    kcfg = KernelConfig.from_bitmask(args.mode, pose_optimization=bool(args.po))
    sensor = Sensor.IMU_STEREO if args.imu else Sensor.STEREO
    try:
        settings = load_settings(args.settings, device=args.device)
        seq = EurocSequence(args.sequence, args.timestamps)
        if args.imu and seq.imu is None:
            sys.exit(f"--imu: {args.sequence} has no mav0/imu0/data.csv")
        # the default vocabulary (place recognition on), as the JAX example;
        # inertial loop closing and the loop-closer threads are not ported
        # yet (ROADMAP M7b), so --imu and --async-mapping run without it
        vocabulary = None
        if args.imu or args.async_mapping:
            vocabulary = False
            print("--imu / --async-mapping: no place recognition (vocabulary=False) until "
                  "ROADMAP M7b", file=sys.stderr)
        system = System(settings, sensor, kernel_config=kcfg,
                        async_mapping=args.async_mapping, vocabulary=vocabulary,
                        device=args.device)
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
    system.save_trajectory_euroc(os.path.join(args.out, "f_traj_euroc.txt"))
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

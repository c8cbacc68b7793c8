#!/usr/bin/env python3
"""EuRoC monocular example of the PyTorch/CUDA port (fasttrack_tpu_torch),
the counterpart of examples/mono_euroc.py: kernel-toggle bitmask, dataset
path + optional timestamps file + YAML settings, trajectory + stats out.

Usage:
  python examples/torch_mono_euroc.py SETTINGS.yaml SEQ_DIR [TIMESTAMPS.txt] \
      [--mode 1111] [--po 1] [--out results/] [--gt GT] [--imu] \
      [--async-mapping] [--device cuda:0|cpu]

Runs `System(settings, Sensor.MONOCULAR)` on the CUDA device unless
--device says otherwise, over the left images (mav0/cam0), with the
shipped vocabulary (relocalization and loop closing with a free scale), as
the JAX example does. Only Camera1 of the settings is used, and its
distortion coefficients are ignored, as in the JAX package (ROADMAP F30).
--imu runs the monocular-inertial system, `Sensor.IMU_MONOCULAR`, on the
sequence's mav0/imu0/data.csv with the settings' IMU block (the samples
between consecutive frames go with the later one; without that file it
exits with an error); its map is metric once the IMU initializes, and its
loop closer keeps the scale fixed. --gt reports the ATE into ate.json:
after a Sim(3) alignment for the visual system (a monocular map's scale is
arbitrary), after an SE(3) one with --imu, beside whether the IMU
initialized and the ATE of the frames after the IMU init alone. --mode and --po are taken as the JAX example takes them; the
monocular front end reads no toggle of its own (ROADMAP F29).
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
    sensor = Sensor.IMU_MONOCULAR if args.imu else Sensor.MONOCULAR
    try:
        settings = load_settings(args.settings, device=args.device)
        seq = EurocSequence(args.sequence, args.timestamps)
        if args.imu and seq.imu is None:
            sys.exit(f"--imu: {args.sequence} has no mav0/imu0/data.csv")
        # the default vocabulary (place recognition on), as the JAX example
        system = System(settings, sensor, kernel_config=kcfg,
                        async_mapping=args.async_mapping, device=args.device)
    except NotImplementedError as e:
        sys.exit(str(e))

    t_prev = None
    t0 = time.perf_counter()
    for i in range(len(seq)):
        ts, left, _ = seq[i]
        imu = None
        if args.imu and t_prev is not None:
            imu = seq.imu.between(t_prev, ts)
        system.track_monocular(left, ts, imu=imu)
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
        from fasttrack_tpu_torch.evaluation import evaluate_trajectory, report_ate

        extra = None
        if args.imu:
            # the frames before the IMU init carry the visual map's drifting
            # scale; those after it are metric
            t_init = system.local_mapper.imu_init_time
            after = [] if t_init is None else [e for e in system.tracker.trajectory if e[0] >= t_init]
            extra = {"imu_initialized": bool(system.atlas.current.imu_initialized),
                     "ate_rmse_after_imu_init": evaluate_trajectory(after, args.gt).get("rmse")
                     if len(after) >= 3 else None,
                     "n_after_imu_init": len(after)}
        report_ate(system, args.gt, args.out, with_scale=not args.imu, extra=extra)


if __name__ == "__main__":
    main()

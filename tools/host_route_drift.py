#!/usr/bin/env python3
"""Drift of the stereo-inertial System under an offload-toggle mask, in either
package, on the CPU, at the size of `chip_smoke.py` phase 16.

    python tools/host_route_drift.py --package torch|jax [--mask 0000] [--seed 0]

Renders the 752x480 160-frame sequence of `chip_smoke.py` phase 16
(datasets.synthetic, the same bits in both packages; seed 0 is the one
phase 16 tracks), runs its first 60 frames through `System(settings,
Sensor.IMU_STEREO, kernel_config=KernelConfig.from_bitmask(mask),
vocabulary=False)` of the package named with 1024 features and 8 levels,
inline mapping, one CPU thread for the port, and prints for every frame the
distance of its camera centre from the ground truth (both in the first
camera's frame) and the largest such distance among the keyframes, then the
ATE RMSE (SE(3) alignment) over the frames up to IMU init, after it, and over
all, split as phase 16 splits them. Only the package named is imported. The
readings of both packages set phase 16's bound on the whole run (ROADMAP
F15, PERF.md).
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

H, W = 480, 752                 # chip_smoke.py's CFG
N_FEATURES, N_LEVELS = 1024, 8
N_FRAMES = 60                   # chip_smoke.py's N_HOST_INERTIAL_FRAMES
N_SEQUENCE_FRAMES = 160         # chip_smoke.py's N_HOST_ROUTE_SEQUENCE_FRAMES: the rendered sequence


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("torch", "jax"), required=True)
    ap.add_argument("--mask", default="0000")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if args.package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from fasttrack_tpu.cameras import make_pinhole
        from fasttrack_tpu.datasets.synthetic import generate_sequence
        from fasttrack_tpu.evaluation.ate import absolute_trajectory_error
        from fasttrack_tpu.kernels import KernelConfig
        from fasttrack_tpu.settings import Settings
        from fasttrack_tpu.system import Sensor, System

        cam_kw, sys_kw = {}, {}
    else:
        import torch

        torch.set_num_threads(1)
        from fasttrack_tpu_torch.cameras import make_pinhole
        from fasttrack_tpu_torch.datasets.synthetic import generate_sequence
        from fasttrack_tpu_torch.evaluation.ate import absolute_trajectory_error
        from fasttrack_tpu_torch.kernels import KernelConfig
        from fasttrack_tpu_torch.settings import Settings
        from fasttrack_tpu_torch.system import Sensor, System

        cam_kw, sys_kw = dict(device="cpu"), dict(device="cpu")

    seq = generate_sequence(n_frames=N_SEQUENCE_FRAMES, h=H, w=W, seed=args.seed)
    settings = Settings(
        camera1=make_pinhole(seq.fx, seq.fy, seq.cx, seq.cy, W, H, **cam_kw),
        bf=seq.fx * seq.baseline, baseline=seq.baseline, width=W, height=H,
        n_features=N_FEATURES, n_levels=N_LEVELS, scale_factor=1.2,
        T_b_c1=np.eye(4), imu_frequency=200.0,
    )
    system = System(settings, Sensor.IMU_STEREO, kernel_config=KernelConfig.from_bitmask(args.mask),
                    vocabulary=False, **sys_kw)
    R0, t0 = seq.frames[0].R_wc, seq.frames[0].t_wc

    def error(R_cw, t_cw, frame_id):
        return float(np.linalg.norm(-R_cw.T @ t_cw - R0.T @ (seq.frames[frame_id].t_wc - t0)))

    t_prev, init = -1.0, None
    for i, f in enumerate(seq.frames[:N_FRAMES]):
        sel = np.where((seq.imu_t > t_prev) & (seq.imu_t <= f.timestamp))[0]
        system.track_stereo(f.left, f.right, f.timestamp,
                            imu=[(float(seq.imu_t[k]), seq.imu_acc[k], seq.imu_gyro[k]) for k in sel])
        t_prev = f.timestamp
        m = system.atlas.current
        if init is None and m.imu_initialized:
            init = i
        last = system.tracker.last_frame
        kf_errors = [error(kf.R_cw, kf.t_cw, kf.frame_id) for kf in m.keyframes.values()]
        print(f"frame {i}: centre error {error(last.R_cw, last.t_cw, i):.4f} m; "
              f"{len(kf_errors)} keyframes, largest error {max(kf_errors):.4f} m", flush=True)
    system.shutdown()

    traj = system.tracker.trajectory

    def ate(part):
        if not part:
            return float("nan")
        t_est = np.asarray([t for t, _, _ in part])
        p_est = np.asarray([-R.T @ t for _, R, t in part])
        return absolute_trajectory_error(t_est, p_est, seq.gt_t, seq.gt_pos)["rmse"]

    cut = len(traj) if init is None else init + 1
    print(f"{args.package} mask {args.mask} seed {args.seed} {W}x{H}: IMU init at frame {init}; "
          f"ATE RMSE up to it {ate(traj[:cut]):.4f} m over {cut} frames, after it "
          f"{ate(traj[cut:]):.4f} m over {len(traj) - cut}, all {ate(traj):.4f} m over {len(traj)}")


if __name__ == "__main__":
    main()

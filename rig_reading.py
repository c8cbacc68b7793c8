#!/usr/bin/env python3
"""Readings of the KB8 fisheye route on rendered TUM-VI-like pairs
(datasets.synthetic.tumvi_kb8_rig: TUM-VI's calibration at 512x512, 0.101
m apart, camera 2 rotated 0.8 deg about x, the plane 3 m away, 60 frames
with the exact 200 Hz IMU stream in a body frame 90 deg about z from camera
1) through `System(Sensor.IMU_STEREO)` in its default configuration (the
shipped vocabulary), 8 levels, 1024 features, on the CPU, by one package.

Phase 23a's frames (an image circle of chip_smoke.KB8_FOV_DEG):

    JAX_PLATFORMS=cpu python rig_reading.py --package jax
    python rig_reading.py --package torch

It prints each frame's tracking state and camera-centre error (unaligned),
the frame of IMU init, the gyro bias and, as its last line, one JSON object
with the ATE RMSE (SE(3) alignment, evaluation/ate.py of the port for both)
over all frames, and apart up to and after the IMU init, beside the
trajectory's own RMS motion about its mean. The JAX package needs its
native library (native/fasttrack_native.cpp built with g++). Both render
the same frames with the port's renderer.

`wide_circle_reading("jax" | "torch")` reads the same frames with the
renderer's default 75 deg image circle (ROADMAP F25);
`fisheye_system_reading("jax" | "torch")` the scene of
tests/test_torch_fisheye_system.py (320x320, 0.2 m apart, 45 frames, 512
features, 4 levels, no vocabulary; ROADMAP F24):

    JAX_PLATFORMS=cpu python -c 'from rig_reading import fisheye_system_reading as r; r("jax")'

`scene_variants()` runs the port on the card over the 75 deg scene and
variants of it, one JSON line each (F25): the visual System, a 50 deg
circle, no tilt, a 0.2 m baseline, the plane at 2.5 and 2 m, and a pinhole
pair at TUM-VI's focal length.
"""

import argparse
import json
import time

import numpy as np

from chip_smoke import KB8_FOV_DEG, KB8_PLANE_Z, KB8_SIZE, N_RIG_FRAMES


def reading(package, size, rig, n_frames, plane_z, seed=0, vocabulary=True, **settings_kw):
    """`n_frames` rendered frames of `rig` at size x size, the plane
    `plane_z` away, through one
    package's System(Sensor.IMU_STEREO); prints a line per frame and the
    JSON object."""
    from fasttrack_tpu_torch.datasets import synthetic
    from fasttrack_tpu_torch.evaluation import absolute_trajectory_error

    seq = synthetic.generate_sequence(n_frames=n_frames, h=size, w=size, rig=rig,
                                      plane_z=plane_z, seed=seed)
    T_b_c1 = np.eye(4)
    T_b_c1[:3, :3] = rig.R_bc
    kw = dict(camera_type="KannalaBrandt8", T_c1_c2=rig.T_c1_c2, bf=seq.fx * seq.baseline,
              baseline=seq.baseline, width=size, height=size, T_b_c1=T_b_c1,
              imu_frequency=200.0, **settings_kw)
    voc = {} if vocabulary else {"vocabulary": False}
    if package == "jax":
        from fasttrack_tpu.cameras import make_kannala_brandt8
        from fasttrack_tpu.settings import Settings
        from fasttrack_tpu.system import Sensor, System

        settings = Settings(camera1=make_kannala_brandt8(*rig.params1, size, size),
                            camera2=make_kannala_brandt8(*rig.params2, size, size), **kw)
        system = System(settings, Sensor.IMU_STEREO, **voc)
    else:
        from fasttrack_tpu_torch.cameras import make_kannala_brandt8
        from fasttrack_tpu_torch.settings import Settings
        from fasttrack_tpu_torch.system import Sensor, System

        settings = Settings(camera1=make_kannala_brandt8(*rig.params1, size, size, device="cpu"),
                            camera2=make_kannala_brandt8(*rig.params2, size, size, device="cpu"),
                            **kw)
        system = System(settings, Sensor.IMU_STEREO, device="cpu", **voc)

    t_prev, init, states = -1.0, None, []
    t0 = time.perf_counter()
    for i, f in enumerate(seq.frames):
        sel = np.where((seq.imu_t > t_prev) & (seq.imu_t <= f.timestamp))[0]
        imu = [(float(seq.imu_t[j]), seq.imu_acc[j], seq.imu_gyro[j]) for j in sel]
        system.track_stereo(f.left, f.right, f.timestamp, imu=imu)
        t_prev = f.timestamp
        state = system.tracker.state.name
        states.append(state)
        if init is None and system.atlas.current.imu_initialized:
            init = i
        lf = system.tracker.last_frame
        err = (float(np.linalg.norm(-lf.R_cw.T @ lf.t_cw - f.t_wc))
               if lf is not None and lf.R_cw is not None else None)
        print(f"frame {i} {state} centre error {err}")
    system.shutdown()
    traj = system.tracker.trajectory

    def ate(part):
        return absolute_trajectory_error(np.asarray([t for t, _, _ in part]),
                                         np.asarray([-R.T @ t for _, R, t in part]),
                                         seq.gt_t, seq.gt_pos)["rmse"]

    # frames up to the IMU init are tracked in the world before its rotation
    split = {} if init is None else {"ate_rmse_before_init_m": ate(traj[:init + 1]),
                                     "ate_rmse_after_init_m": ate(traj[init + 1:])}
    gt = np.asarray(seq.gt_pos)
    print(json.dumps({"package": package, "frames": len(seq.frames),
                      "frames_ok": states.count("OK"),
                      "first_not_ok": next((i for i, s in enumerate(states) if s != "OK"), None),
                      "imu_init_frame": init,
                      "bg": np.asarray(system.tracker.bias[0], np.float64).tolist(),
                      "ate_rmse_m": ate(traj), **split, "n": len(traj),
                      "rms_motion_m": float(np.sqrt(((gt - gt.mean(0)) ** 2).sum(1).mean())),
                      "seconds": time.perf_counter() - t0}))


def fisheye_system_reading(package):
    """tests/test_torch_fisheye_system.py's scene through one package."""
    from fasttrack_tpu_torch.datasets import synthetic

    reading(package, 320, synthetic.tumvi_kb8_rig(320, 320, baseline=0.2), 45, 3.0, seed=5,
            vocabulary=False, n_features=512, n_levels=4, th_depth=60.0)


def wide_circle_reading(package):
    """Phase 23a's frames with the renderer's default 75 deg image circle."""
    from fasttrack_tpu_torch.datasets import synthetic

    reading(package, KB8_SIZE, synthetic.tumvi_kb8_rig(KB8_SIZE, KB8_SIZE), N_RIG_FRAMES,
            KB8_PLANE_Z, n_features=1024, n_levels=8, scale_factor=1.2)


def scene_variants():
    """The port on the card (chip_smoke.run_rig) over the 75 deg scene and
    its variants: one line `DIAG {json}` each, with frames OK, the IMU-init
    frame, depths per frame, the path of each frame (s stepwise, f fused),
    keyframes, and the ATE RMSE over all frames, up to and after the init
    (and with a Sim(3) alignment: rmse, scale) beside the RMS motion."""
    import torch

    import chip_smoke as cs
    from fasttrack_tpu_torch import native
    from fasttrack_tpu_torch.datasets import synthetic
    from fasttrack_tpu_torch.evaluation import absolute_trajectory_error
    from fasttrack_tpu_torch.ops import hamming_kernel
    from fasttrack_tpu_torch.system import Sensor, System

    device = torch.device("cuda", 0)
    print("card", cs.card_line(), flush=True)
    hamming_kernel.load_kernels()
    native.build()
    size = KB8_SIZE

    def kb8(**kw):
        return synthetic.tumvi_kb8_rig(size, size, **kw)

    def notilt():
        rig = kb8()
        T = rig.T_c1_c2.copy()
        T[:3, :3] = np.eye(3)
        return rig._replace(T_c1_c2=T)

    def pinhole():
        # TUM-VI's focal length, no distortion, no tilt: the rectified pinhole route
        rig = kb8()
        p = np.asarray(rig.params1[:4])
        T = np.eye(4)
        T[0, 3] = 0.101
        return synthetic.Rig("radtan", p, p.copy(), T, rig.R_bc, np.zeros(4), np.zeros(4))

    variants = {
        "base": (kb8, 3.0, Sensor.IMU_STEREO),
        "base_visual": (kb8, 3.0, Sensor.STEREO),
        "baseline0.2": (lambda: kb8(baseline=0.2), 3.0, Sensor.IMU_STEREO),
        "plane2.5": (kb8, 2.5, Sensor.IMU_STEREO),
        "plane2.0": (kb8, 2.0, Sensor.IMU_STEREO),
        "pinhole190": (pinhole, 3.0, Sensor.IMU_STEREO),
        "pinhole190_visual": (pinhole, 3.0, Sensor.STEREO),
        "fov50": (lambda: kb8(fov_deg=50.0), 3.0, Sensor.IMU_STEREO),
        "notilt": (notilt, 3.0, Sensor.IMU_STEREO),
    }

    def ate_of(traj, seq, scale=False):
        if len(traj) < 3:
            return None
        a = absolute_trajectory_error(np.asarray([t for t, _, _ in traj]),
                                      np.asarray([-R.T @ t for _, R, t in traj]),
                                      seq.gt_t, seq.gt_pos, with_scale=scale)
        return (a["rmse"], a["scale"]) if scale else a["rmse"]

    for name, (make, plane, sensor) in variants.items():
        t0 = time.perf_counter()
        rig = make()
        seq = synthetic.generate_sequence(n_frames=N_RIG_FRAMES, h=size, w=size, rig=rig,
                                          plane_z=plane)
        t_r = time.perf_counter() - t0
        system = System(cs.rig_settings(seq, rig, device, size, size), sensor, device=device)
        inertial = sensor == Sensor.IMU_STEREO
        log = cs.run_rig(system, seq, N_RIG_FRAMES, inertial=inertial)
        system.shutdown()
        traj = system.tracker.trajectory
        init = next((i for i, r in enumerate(log) if r["imu_initialized"]), None)
        gp = np.asarray(seq.gt_pos)
        print("DIAG", json.dumps({
            "variant": name, "plane": plane, "inertial": inertial,
            "ok": sum(r["state"] == "OK" for r in log), "n": len(log), "init": init,
            "depth0": log[0]["stereo"],
            "fused": sum(r["path"] == "fused" for r in log),
            "fused_after_init": None if init is None else sum(
                r["path"] == "fused" for r in log[init + 1:]),
            "kf_processed": int(sum(system.stats.series["lm_keyframes"])),
            "kfs": system.atlas.current.n_keyframes(),
            "ate": ate_of(traj, seq), "ate_sim3": ate_of(traj, seq, True),
            "ate_before": ate_of(traj[:init + 1], seq) if init is not None else None,
            "ate_before_sim3": ate_of(traj[:init + 1], seq, True) if init is not None else None,
            "ate_after": ate_of(traj[init + 1:], seq) if init is not None else None,
            "ate_first20": ate_of(traj[:20], seq), "ate_first40": ate_of(traj[:40], seq),
            "rms_motion": float(np.sqrt(((gp - gp.mean(0)) ** 2).sum(1).mean())),
            "depths": [r["stereo"] for r in log], "paths": "".join(r["path"][0] for r in log),
            "ms_median": float(np.median([r["ms"] for r in log[2:]])),
            "render_s": t_r, "s": time.perf_counter() - t0,
        }), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    args = ap.parse_args()

    from fasttrack_tpu_torch.datasets import synthetic

    reading(args.package, KB8_SIZE, synthetic.tumvi_kb8_rig(KB8_SIZE, KB8_SIZE, fov_deg=KB8_FOV_DEG),
            N_RIG_FRAMES, KB8_PLANE_Z, n_features=1024, n_levels=8, scale_factor=1.2)


if __name__ == "__main__":
    main()

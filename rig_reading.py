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

`mono_reading("jax" | "torch")` reads phase 24a's frames (the first
chip_smoke.N_MONO_FRAMES of phase 10's 752x480 sequence) through one
package's `System(Sensor.MONOCULAR)` in its default configuration (the
shipped vocabulary), 8 levels, 1024 features, on the CPU: the state of
every frame, the initialization frame, the init pair's parallax (the 50th
good point's, as the two-view gate reads it) and its map's median
reprojection error, and the Sim(3)-aligned ATE over all frames and up to
the first loss after the init (ROADMAP F31). `hold=5` holds the
initializer's reference frame at least 5 frames back (a reading of
whether the short baseline of a reference slid every frame is what sinks
the map); the packages are not changed for it, the tracker's
initialization is wrapped from here:

    JAX_PLATFORMS=cpu python -c 'from rig_reading import mono_reading as r; r("jax")'

`mono_inertial_reading("jax" | "torch", scene, repairs, extra)` reads the
monocular-inertial System (`Sensor.IMU_MONOCULAR`, inline) on one of two
scenes: "test" (tests/test_torch_mono_inertial.py's: 320x240, seed 3, 50
frames, 512 features, 4 levels, no vocabulary) or "chip" (phase 25a's: the
first 60 frames of phase 10's 752x480 sequence, 1024 features, 8 levels,
the shipped vocabulary), both with the exact 200 Hz IMU stream. `repairs`
names the port's recorded differences to have on, whatever the package
(None: the package as it is): "f33" (the second init keyframe's
preintegration), "f34" (metric init velocities), "f35" (the pre-init
keyframe rule), "f36" (normals and distances moved with a rescale), "f38"
(IMU_MONOCULAR's reference ratio, 0.75 above 350 inliers, after the init;
the port only);
`extra` adds candidates of ROADMAP F35 that neither package has: "c" (the
full inertial BA at the init) and "d" (the last frame re-predicted from the
new anchor, ORB-SLAM3's UpdateFrameIMU). The packages are not changed for it: every variant wraps a method from here. `device`
runs the port on the card ("cuda") instead of the CPU. It prints a line per frame and
one JSON object: the two-view and IMU init frames, the scale the init
solved beside the Sim(3) scale of the keyframe chain it fit and the spread
of that chain's local scales (candidate (a)), the Sim(3) scale and the
SE(3) ATE of the frames after the init, the first frame lost after it,
scale refinements, fused frames and keyframes:

    JAX_PLATFORMS=cpu python -c 'from rig_reading import mono_inertial_reading as r; r("jax", "test", ("f33", "f34"))'

`keyframe_rule_reading()` runs the port on the card over phase 25a's
frames and on to frame 100 (of phase 10's sequence) without F38 and with
it (ROADMAP F38); `inertial_window_reading()`
records every inertial window of the port's run on the card over 25a's
frames and solves each again on the CPU in float32 and in float64, from
the same inputs: the flipped steps of each (ROADMAP F24, phase 25b):

    python -c 'import rig_reading as r; r.keyframe_rule_reading(); r.inertial_window_reading()'

`rgbd_reading("jax" | "torch", inertial, scene)` reads the RGB-D System
(`Sensor.RGBD`, or `Sensor.IMU_RGBD` with the exact 200 Hz IMU stream and
T_b_c1 = I) on the rendered sweep with its exact depth maps
(datasets.synthetic.generate_rgbd_sequence), inline, on the CPU: scene
"chip" is phases 26a-b's (TUM1.yaml's 640x480 at 30 fps, 1000 features, 8
levels, bf 40, ThDepth 40, seed 3, the shipped vocabulary; 60 frames, 80
with the IMU), "test" tests/test_torch_rgbd.py's (320x240 at 20 fps, 512
features, 4 levels, the same bf and ThDepth, seed 3, no vocabulary; 30
frames, 50 with the IMU). It prints a line per frame and one JSON object:
the states, the IMU init frame, keyframes, map points, and the SE(3) ATE
over all frames:

    JAX_PLATFORMS=cpu python -c 'from rig_reading import rgbd_reading as r; r("jax")'

`kitti_reading("jax" | "torch")` renders phase 27c's KITTI layout
(chip_smoke.write_kitti_layout: 20 frames at 1241x376, 10 fps, baseline
0.537 m, KITTI00-02.yaml's 2000 features, 8 levels, FAST 20/7, ThDepth 35)
into a temporary directory and runs the package's KITTI example on it
(examples/kitti_stereo.py, or examples/torch_kitti_stereo.py --device cpu)
with its shipped vocabulary, on the CPU; it prints the example's lines and
one JSON object (the SE(3) ATE of ate.json, the frames, the seconds):

    JAX_PLATFORMS=cpu python -c 'from rig_reading import kitti_reading as r; r("jax")'
"""

import argparse
import json
import sys
import time

import numpy as np

import chip_smoke
from chip_smoke import (
    KB8_FOV_DEG,
    H,
    RGBD_FEATURES,
    RGBD_FPS,
    RGBD_H,
    RGBD_SEED,
    RGBD_W,
    W,
    KB8_PLANE_Z,
    KB8_SIZE,
    N_MONO_FRAMES,
    N_RGBD_FRAMES,
    N_RGBD_INERTIAL_FRAMES,
    N_RIG_FRAMES,
    N_SYSTEM_FRAMES,
)


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


def _init_parallax_deg(R, t, X, good):
    """The two-view gate's parallax (fasttrack_tpu/optim/two_view.py:270-279):
    the angle between the rays of the 50th-largest-parallax good point."""
    X = np.asarray(X, np.float64)[np.asarray(good)]
    if len(X) == 0:
        return 0.0
    C2 = -np.asarray(R, np.float64).T @ np.asarray(t, np.float64)
    n1 = X / np.linalg.norm(X, axis=1, keepdims=True)
    d2 = X - C2
    n2 = d2 / np.linalg.norm(d2, axis=1, keepdims=True)
    cos = np.sort(np.sum(n1 * n2, axis=1))
    return float(np.degrees(np.arccos(np.clip(cos[min(50, len(cos) - 1)], -1.0, 1.0))))


def _map_reprojection_px(m, camera_params):
    """Median pixel reprojection error of every observation of the map."""
    fx, fy, cx, cy = (float(v) for v in np.asarray(camera_params)[:4])
    err = []
    for mp in m.mappoints.values():
        for kid, i in mp.observations.items():
            kf = m.keyframes.get(kid)
            if kf is None:
                continue
            Xc = np.asarray(kf.R_cw) @ np.asarray(mp.position, np.float64) + np.asarray(kf.t_cw)
            uv = np.array([fx * Xc[0] / Xc[2] + cx, fy * Xc[1] / Xc[2] + cy])
            err.append(float(np.linalg.norm(uv - np.asarray(kf.kp_uv[i], np.float64))))
    return float(np.median(err)) if err else None


def mono_reading(package, n_frames=N_MONO_FRAMES, hold=0):
    """Phase 24a's frames through one package's monocular System on the CPU;
    prints a line per frame and one JSON object."""
    from fasttrack_tpu_torch.datasets import synthetic
    from fasttrack_tpu_torch.evaluation import absolute_trajectory_error

    seq = synthetic.generate_sequence(n_frames=N_SYSTEM_FRAMES, h=H, w=W)
    frames = seq.frames[:n_frames]
    if package == "jax":
        from fasttrack_tpu.cameras import make_pinhole
        from fasttrack_tpu.optim import two_view
        from fasttrack_tpu.settings import Settings
        from fasttrack_tpu.system import Sensor, System

        cam = make_pinhole(seq.fx, seq.fy, seq.cx, seq.cy, W, H)
        system = System(Settings(camera1=cam, bf=0.0, width=W, height=H, n_features=1024,
                                 n_levels=8, scale_factor=1.2), Sensor.MONOCULAR)
    else:
        from fasttrack_tpu_torch.cameras import make_pinhole
        from fasttrack_tpu_torch.optim import two_view
        from fasttrack_tpu_torch.settings import Settings
        from fasttrack_tpu_torch.system import Sensor, System

        cam = make_pinhole(seq.fx, seq.fy, seq.cx, seq.cy, W, H, device="cpu")
        system = System(Settings(camera1=cam, bf=0.0, width=W, height=H, n_features=1024,
                                 n_levels=8, scale_factor=1.2), Sensor.MONOCULAR, device="cpu")
    tracker = system.tracker
    # the two-view results, read from outside: the JAX tracker imports the
    # function from its module where it calls it, the port's tracker holds
    # the name in its own module
    results = []
    owner = two_view if package == "jax" else sys.modules[type(tracker).__module__]
    inner_tv = owner.reconstruct_two_view

    def recorded(p1, p2, K, **kw):
        res = inner_tv(p1, p2, K, **kw)
        results.append((len(p1), res))
        return res

    owner.reconstruct_two_view = recorded
    if hold:
        inner_init = tracker._monocular_initialization

        def held(frame):
            ref = tracker._init_reference
            if ref is not None and frame.frame_id - ref.frame_id < hold:
                return
            inner_init(frame)

        tracker._monocular_initialization = held

    states, init, init_reproj = [], None, None
    t0 = time.perf_counter()
    try:
        for i, f in enumerate(frames):
            system.track_monocular(f.left, f.timestamp)
            state = tracker.state.name
            states.append(state)
            if init is None and state == "OK":
                init = i
                init_reproj = _map_reprojection_px(system.atlas.current, cam.params)
            print(f"frame {i} {state} keyframes {system.atlas.current.n_keyframes()} map points "
                  f"{system.atlas.current.n_mappoints()}", flush=True)
    finally:
        owner.reconstruct_two_view = inner_tv
    system.shutdown()
    traj = tracker.trajectory
    loss = next((i for i in range(init or 0, len(states)) if states[i] != "OK"), None)

    def ate(part):
        if len(part) < 3:
            return None
        a = absolute_trajectory_error(np.asarray([t for t, _, _ in part]),
                                      np.asarray([-R.T @ t for _, R, t in part]),
                                      seq.gt_t, seq.gt_pos, with_scale=True)
        return {"rmse": a["rmse"], "scale": a.get("scale"), "n": len(part)}

    t_loss = frames[loss].timestamp if loss is not None else np.inf
    good = [r for _, r in results if r.success]
    tv = good[-1] if good else None
    gt = np.asarray(seq.gt_pos[:n_frames])
    print(json.dumps({
        "package": package, "hold": hold, "frames": n_frames,
        "states": "".join(s[0] for s in states),
        "init_frame": init, "frames_ok": states.count("OK"), "first_loss_after_init": loss,
        "two_view_attempts": len(results), "init_matches": results[-1][0] if good else None,
        "init_used_homography": None if tv is None else bool(tv.used_homography),
        "init_good_points": None if tv is None else int(np.sum(tv.good_mask)),
        "init_parallax_deg": None if tv is None else _init_parallax_deg(
            tv.R, tv.t, tv.points3d, tv.good_mask),
        "init_map_reprojection_px_median": init_reproj,
        "keyframes": system.atlas.current.n_keyframes(),
        "map_points": system.atlas.current.n_mappoints(),
        "ate_sim3": ate(traj), "ate_sim3_to_first_loss": ate([r for r in traj if r[0] < t_loss]),
        "rms_motion_m": float(np.sqrt(((gt - gt.mean(0)) ** 2).sum(1).mean())),
        "seconds": time.perf_counter() - t0}), flush=True)


MONO_INERTIAL_REPAIRS = ("f33", "f34", "f35", "f36", "f38")


def _mono_inertial_variant(package, repairs, extra, mp):
    """Wrap the package's methods so that exactly `repairs` (of
    MONO_INERTIAL_REPAIRS) and the candidates in `extra` act; `mp(owner,
    name, value)` sets an attribute and keeps the old one."""
    if package == "jax":
        from fasttrack_tpu import local_mapping as lm
        from fasttrack_tpu import tracking as tr
        from fasttrack_tpu.imu import init as init_mod
        from fasttrack_tpu.imu.preintegration import HostPreintegrated
        from fasttrack_tpu.slam_map import map as map_mod
        solve_owner = init_mod
    else:
        from fasttrack_tpu_torch import local_mapping as lm
        from fasttrack_tpu_torch import tracking as tr
        from fasttrack_tpu_torch.imu.preintegration import HostPreintegrated
        from fasttrack_tpu_torch.slam_map import map as map_mod
        solve_owner = lm
    has = set(MONO_INERTIAL_REPAIRS) if package == "torch" else set()
    want = set(repairs)

    if ("f33" in want) != ("f33" in has):
        inner = tr.Tracker._monocular_initialization

        def mono_init(self, frame):
            ref, pre = self._init_reference, self.pre_from_kf
            out = inner(self, frame)
            m = self.atlas.current
            if self.state.name == "OK" and self._init_reference is None and m.keyframes:
                kf2 = m.keyframes[max(m.keyframes)]
                kf2.preintegrated = pre.copy() if "f33" in want else HostPreintegrated(
                    self.bias[0], self.bias[1])
            elif "f33" in want and self._init_reference is not ref:
                self.pre_from_kf = HostPreintegrated(self.bias[0], self.bias[1])
            return out

        mp(tr.Tracker, "_monocular_initialization", mono_init)
    if ("f34" in want) != ("f34" in has):
        solve = solve_owner.initialize_imu

        def initialize_imu(*a, **kw):
            res = solve(*a, **kw)
            if kw.get("mono_scale") and kw.get("estimate_ba") is False and res.success:
                f = 1.0 / res.scale if "f34" in want else res.scale
                res = res._replace(velocities=res.velocities * f)
            return res

        mp(solve_owner, "initialize_imu", initialize_imu)
    if ("f35" in want) != ("f35" in has):
        need = tr.Tracker._need_new_keyframe

        def need_new_keyframe(self, frame):
            m = self.atlas.current
            if not (self.use_imu and self.monocular and not m.imu_initialized):
                return need(self, frame)
            last = m.keyframes.get(getattr(self, "last_kf_id", None))
            due = last is not None and frame.timestamp - last.timestamp >= 0.25
            if due or "f35" in want:
                return due
            self.use_imu = False            # the ratio test the JAX package falls to
            try:
                return need(self, frame)
            finally:
                self.use_imu = True

        mp(tr.Tracker, "_need_new_keyframe", need_new_keyframe)
    if ("f36" in want) != ("f36" in has):
        rotate = map_mod.Map.apply_scaled_rotation

        def apply_scaled_rotation(self, R_gw, scale, scale_velocities=False, **_):
            if "f36" not in want:                       # the port, without F36
                return rotate(self, R_gw, scale, scale_velocities)
            rotate(self, R_gw, scale, scale_velocities)  # the JAX package, with it
            st = self.store
            st.normal[st.alive] = st.normal[st.alive] @ R_gw.T
            st.min_dist[st.alive] *= scale
            st.max_dist[st.alive] *= scale

        mp(map_mod.Map, "apply_scaled_rotation", apply_scaled_rotation)
    if "f38" in want and package == "jax":
        raise ValueError("F38 is read on the port only")
    if "f38" not in want and package == "torch":
        mp(tr.Tracker, "MI_MANY_INLIERS", 1 << 30)
    if "c" in extra:
        init_imu = lm.LocalMapper._try_initialize_imu

        def try_initialize_imu(self, kf, *a, **kw):
            if self.atlas.current.imu_initialized:
                return init_imu(self, kf, *a, **kw)
            self._local_inertial_ba = lambda k, *aa, **kk: self._full_inertial_ba(k)
            try:
                return init_imu(self, kf, *a, **kw)
            finally:
                del self._local_inertial_ba

        mp(lm.LocalMapper, "_try_initialize_imu", try_initialize_imu)
    if "d" in extra:
        init_imu_d = lm.LocalMapper._try_initialize_imu

        def try_initialize_imu_d(self, kf, *a, **kw):
            was = self.atlas.current.imu_initialized
            out = init_imu_d(self, kf, *a, **kw)
            t = self.tracker
            if (not was and self.atlas.current.imu_initialized and t is not None
                    and t.last_kf_state is not None and t.pre_from_kf is not None
                    and t.last_frame is not None):
                R_wb, p_w, v_w = t._predict_state_imu()
                t.last_frame.R_cw, t.last_frame.t_cw = t._cam_from_body(R_wb, p_w)
                t.last_frame.v_w = v_w
                t.velocity = None
            return out

        mp(lm.LocalMapper, "_try_initialize_imu", try_initialize_imu_d)
    return lm


def mono_inertial_reading(package, scene="test", repairs=None, extra=(), n_frames=None,
                          device="cpu", seq=None):
    """One package's monocular-inertial System over `scene` (or the
    rendered `seq` of that scene) on the CPU, or the port on `device`, with
    the recorded differences `repairs` on (None: the package as it is);
    prints a line per frame and one JSON object."""
    from fasttrack_tpu_torch.datasets import synthetic
    from fasttrack_tpu_torch.evaluation import absolute_trajectory_error

    if scene == "test":
        n_frames = n_frames or 50
        h, w, seed, n_all, feats, levels, vocab = 240, 320, 3, n_frames, 512, 4, False
    else:
        n_frames = n_frames or N_MONO_FRAMES
        h, w, seed, n_all, feats, levels, vocab = H, W, 0, N_SYSTEM_FRAMES, 1024, 8, None
    repairs = tuple(MONO_INERTIAL_REPAIRS if package == "torch" else ()) if repairs is None \
        else tuple(repairs)
    if seq is None:
        seq = synthetic.generate_sequence(n_frames=n_all, h=h, w=w, seed=seed)
    undo = []

    def mp(owner, name, value):
        undo.append((owner, name, owner.__dict__[name]))
        setattr(owner, name, value)

    lm = _mono_inertial_variant(package, repairs, extra, mp)
    chain_reading = {}
    inner_init = lm.LocalMapper._try_initialize_imu

    def read_chain(self, kf, *a, **kw):
        if not self.atlas.current.imu_initialized and not chain_reading:
            chain = self._temporal_chain(kf)
            chain = [k for k in chain if k.kid == chain[0].kid or k.preintegrated is not None]
            if len(chain) >= 6 and chain[-1].timestamp - chain[0].timestamp >= 2.0:
                ts = np.asarray([k.timestamp for k in chain])
                P = np.asarray([-k.R_cw.T @ k.t_cw for k in chain])
                local = [absolute_trajectory_error(ts[j:j + 3], P[j:j + 3], seq.gt_t, seq.gt_pos,
                                                   with_scale=True)["scale"]
                         for j in range(len(chain) - 2)]
                chain_reading.update(
                    chain_keyframes=len(chain), chain_span_s=float(ts[-1] - ts[0]),
                    chain_sim3_scale=absolute_trajectory_error(
                        ts, P, seq.gt_t, seq.gt_pos, with_scale=True)["scale"],
                    chain_local_scale_min=float(min(local)),
                    chain_local_scale_max=float(max(local)),
                    second_kf_dT=None if chain[1].preintegrated is None
                    else float(chain[1].preintegrated.dT))
        return inner_init(self, kf, *a, **kw)

    mp(lm.LocalMapper, "_try_initialize_imu", read_chain)
    solved = []
    if package == "jax":
        from fasttrack_tpu.imu import init as solve_owner
    else:
        solve_owner = lm
    inner_solve = solve_owner.initialize_imu

    def recorded_solve(*a, **kw):
        res = inner_solve(*a, **kw)
        if kw.get("mono_scale"):
            solved.append(("init" if kw.get("estimate_ba") is False else "refinement",
                           bool(res.success), float(res.scale)))
        return res

    mp(solve_owner, "initialize_imu", recorded_solve)
    try:
        if package == "jax":
            from fasttrack_tpu.cameras import make_pinhole
            from fasttrack_tpu.settings import Settings
            from fasttrack_tpu.system import Sensor, System

            cam, kw = make_pinhole(seq.fx, seq.fy, seq.cx, seq.cy, w, h), {}
        else:
            from fasttrack_tpu_torch.cameras import make_pinhole
            from fasttrack_tpu_torch.settings import Settings
            from fasttrack_tpu_torch.system import Sensor, System

            cam, kw = make_pinhole(seq.fx, seq.fy, seq.cx, seq.cy, w, h, device=device), \
                {"device": device}
        settings = Settings(camera1=cam, bf=0.0, width=w, height=h, n_features=feats,
                            n_levels=levels, scale_factor=1.2, imu_frequency=200.0,
                            T_b_c1=np.eye(4))
        system = System(settings, Sensor.IMU_MONOCULAR, vocabulary=vocab, **kw)
        tracker = system.tracker
        states, imu_init, t_prev, n_fused = [], None, -1.0, 0
        t0 = time.perf_counter()
        for i, f in enumerate(seq.frames[:n_frames]):
            sel = np.where((seq.imu_t > t_prev) & (seq.imu_t <= f.timestamp))[0]
            system.track_monocular(f.left, f.timestamp, imu=[
                (float(seq.imu_t[j]), seq.imu_acc[j], seq.imu_gyro[j]) for j in sel])
            t_prev = f.timestamp
            m = system.atlas.current
            states.append(tracker.state.name)
            if imu_init is None and m.imu_initialized:
                imu_init = i
            fused = sum(system.stats.series.get("fused_vi_frames", []))
            print(f"frame {i} {states[-1]} keyframes {m.n_keyframes()} map points "
                  f"{m.n_mappoints()} tracked {int((tracker.last_frame.mp_ids >= 0).sum())} "
                  f"inliers {tracker.n_inliers}{' fused' if fused > n_fused else ''}"
                  f"{' imu' if m.imu_initialized else ''}", flush=True)
            n_fused = fused
        system.shutdown()
    finally:
        for owner, name, value in reversed(undo):
            setattr(owner, name, value)
    traj = tracker.trajectory
    ts = np.asarray([t for t, _, _ in traj])
    ps = np.asarray([-R.T @ t for _, R, t in traj])
    out = {"package": package, "scene": scene, "repairs": list(repairs), "extra": list(extra),
           "frames": n_frames, "states": "".join(s[0] for s in states),
           "init_frame": states.index("OK") if "OK" in states else None,
           "imu_init_frame": imu_init, "solves": solved, **chain_reading}
    if imu_init is not None:
        after = ts >= seq.frames[imu_init].timestamp
        if after.sum() >= 3:
            a3 = absolute_trajectory_error(ts[after], ps[after], seq.gt_t, seq.gt_pos,
                                           with_scale=True)
            a6 = absolute_trajectory_error(ts[after], ps[after], seq.gt_t, seq.gt_pos)
            gt = seq.gt_pos[imu_init:n_frames]
            out.update(frames_after=int(after.sum()), sim3_scale_after=a3["scale"],
                       se3_ate_after_m=a6["rmse"],
                       rms_motion_after_m=float(np.sqrt(((gt - gt.mean(0)) ** 2).sum(1).mean())))
        out["first_loss_after_init"] = next(
            (i for i in range(imu_init, len(states)) if states[i] != "OK"), None)
    series = system.stats.series
    out.update(keyframes=system.atlas.current.n_keyframes(),
               keyframes_processed=len(series.get("lm_keyframes", [])),
               map_points=system.atlas.current.n_mappoints(),
               fused_inertial_frames=int(sum(series.get("fused_vi_frames", []))),
               inertial_windows=int(sum(series.get("lm_inertial_bas", []))),
               inertial_steps_flipped=int(sum(series.get("lm_inertial_steps_flipped", []))),
               seconds=time.perf_counter() - t0)
    print(json.dumps(out), flush=True)
    return out


def _chip_scene_sequence():
    from fasttrack_tpu_torch.datasets import synthetic

    return synthetic.generate_sequence(n_frames=N_SYSTEM_FRAMES, h=H, w=W, seed=0)


def keyframe_rule_reading(seq=None):
    """The port on the card over phase 10's 100 frames without F38 and with
    it (ROADMAP F38)."""
    seq = seq or _chip_scene_sequence()
    base = tuple(r for r in MONO_INERTIAL_REPAIRS if r != "f38")
    return [mono_inertial_reading("torch", "chip", repairs, (), N_SYSTEM_FRAMES, "cuda", seq)
            for repairs in (base, MONO_INERTIAL_REPAIRS)]


def inertial_window_reading(seq=None, n_frames=N_MONO_FRAMES):
    """Every inertial window of the port's run on the card over phase 25a's
    frames, solved again on the CPU from the same inputs in float32 (as the
    mapper solves it) and in float64: the steps each rejects as flipped and
    the largest state difference card against CPU in float32."""
    import torch

    from chip_smoke import state_diffs, to_device, with_float
    from fasttrack_tpu_torch import local_mapping
    from fasttrack_tpu_torch.optim.inertial import local_inertial_ba

    seq = seq or _chip_scene_sequence()
    windows, inner = [], local_mapping.local_inertial_ba

    def record(*args, **kw):
        out = inner(*args, **kw)
        windows.append((args, out, kw))
        return out

    local_mapping.local_inertial_ba = record
    try:
        mono_inertial_reading("torch", "chip", None, (), n_frames, "cuda", seq)
    finally:
        local_mapping.local_inertial_ba = inner
    cpu, rows = torch.device("cpu"), []
    for i, (args, card, kw) in enumerate(windows):
        host = local_inertial_ba(*to_device(args, cpu), **kw)
        wide = local_inertial_ba(with_float(to_device(args, cpu)[0], torch.float64),
                                 *to_device(args[1:], cpu), **kw)
        d = state_diffs(card.states, host.states)
        rows.append({"window": i, "flipped_card": int(card.n_flipped),
                     "flipped_cpu_f32": int(host.n_flipped), "flipped_cpu_f64": int(wide.n_flipped),
                     "observations": int(args[0].mask.sum()),
                     "state_maxdiff_f32": max(d.values())})
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"windows": len(rows), **{k: sum(r[k] for r in rows) for k in (
        "flipped_card", "flipped_cpu_f32", "flipped_cpu_f64")}}), flush=True)
    return rows


RGBD_SCENES = {
    # h, w, fps, features, levels, vocabulary, frames (visual, inertial)
    "chip": (RGBD_H, RGBD_W, RGBD_FPS, RGBD_FEATURES, 8, None,
             (N_RGBD_FRAMES, N_RGBD_INERTIAL_FRAMES)),
    "test": (240, 320, 20.0, 512, 4, False, (30, 50)),
}


def rgbd_settings(package, seq, h, w, features, levels, inertial):
    """chip_smoke.rgbd_settings (TUM1.yaml's RGB-D settings for the
    renderer's pinhole at (h, w)) in either package, on the CPU."""
    port = chip_smoke.rgbd_settings(seq, "cpu", inertial, (h, w), features, levels)
    if package == "torch":
        return port
    import dataclasses

    from fasttrack_tpu.cameras import make_pinhole
    from fasttrack_tpu.settings import Settings

    kw = {f.name: getattr(port, f.name) for f in dataclasses.fields(port) if f.name != "camera1"}
    return Settings(camera1=make_pinhole(seq.fx, seq.fy, seq.cx, seq.cy, w, h), **kw)


def rgbd_reading(package, inertial=False, scene="chip"):
    """One package's RGB-D System over `scene` on the CPU; prints a line per
    frame and one JSON object, which it returns."""
    from fasttrack_tpu_torch.datasets import synthetic
    from fasttrack_tpu_torch.evaluation import absolute_trajectory_error

    h, w, fps, features, levels, vocabulary, frames = RGBD_SCENES[scene]
    n_frames = frames[int(inertial)]
    seq, depths = synthetic.generate_rgbd_sequence(n_frames, h, w, fps=fps, seed=RGBD_SEED)
    settings = rgbd_settings(package, seq, h, w, features, levels, inertial)
    voc = {} if vocabulary is None else {"vocabulary": vocabulary}
    if package == "jax":
        from fasttrack_tpu.system import Sensor, System

        system = System(settings, Sensor.IMU_RGBD if inertial else Sensor.RGBD, **voc)
    else:
        from fasttrack_tpu_torch.system import Sensor, System

        system = System(settings, Sensor.IMU_RGBD if inertial else Sensor.RGBD, device="cpu",
                        **voc)
    t_prev, init, states = -1.0, None, []
    t0 = time.perf_counter()
    for i, (f, d) in enumerate(zip(seq.frames, depths)):
        imu = None
        if inertial:
            sel = np.where((seq.imu_t > t_prev) & (seq.imu_t <= f.timestamp))[0]
            imu = [(float(seq.imu_t[j]), seq.imu_acc[j], seq.imu_gyro[j]) for j in sel]
        system.track_rgbd(f.left, d, f.timestamp, imu=imu)
        t_prev = f.timestamp
        states.append(system.tracker.state.name)
        if init is None and system.atlas.current.imu_initialized:
            init = i
        lf = system.tracker.last_frame
        err = (float(np.linalg.norm(-lf.R_cw.T @ lf.t_cw - f.t_wc))
               if lf is not None and lf.R_cw is not None else None)
        print(f"frame {i} {states[-1]} keyframes {system.atlas.current.n_keyframes()} "
              f"centre error {err}", flush=True)
    system.shutdown()
    traj = system.tracker.trajectory

    def ate(part):
        if len(part) < 3:
            return None
        return absolute_trajectory_error(np.asarray([t for t, _, _ in part]),
                                         np.asarray([-R.T @ t for _, R, t in part]),
                                         seq.gt_t, seq.gt_pos)["rmse"]

    gt = np.asarray(seq.gt_pos)
    out = {"package": package, "scene": scene, "inertial": inertial, "frames": n_frames,
           "states": "".join(s[0] for s in states), "frames_ok": states.count("OK"),
           "init_frame": states.index("OK") if "OK" in states else None,
           "imu_init_frame": init,
           "bg": np.asarray(system.tracker.bias[0], np.float64).tolist(),
           "keyframes": system.atlas.current.n_keyframes(),
           "map_points": system.atlas.current.n_mappoints(),
           "ate_rmse_m": ate(traj),
           "ate_rmse_after_imu_init_m": None if init is None else ate(traj[init + 1:]),
           "rms_motion_m": float(np.sqrt(((gt - gt.mean(0)) ** 2).sum(1).mean())),
           "seconds": time.perf_counter() - t0}
    print(json.dumps(out), flush=True)
    return out


def kitti_reading(package):
    """One package's KITTI example over phase 27c's layout on the CPU;
    prints and returns one JSON object."""
    import os
    import runpy
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="kitti_reading_")
    try:
        chip_smoke.write_kitti_layout(root)
        out = os.path.join(root, "out")
        script = "kitti_stereo.py" if package == "jax" else "torch_kitti_stereo.py"
        argv = [os.path.join(root, "KITTI.yaml"), root, "--out", out,
                "--gt", os.path.join(root, "gt.txt")] + (["--device", "cpu"] if package == "torch" else [])
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", script)
        old = sys.argv
        sys.argv = [path] + argv
        t0 = time.perf_counter()
        try:
            runpy.run_path(path, run_name="__main__")
        finally:
            sys.argv = old
        seconds = time.perf_counter() - t0
        with open(os.path.join(out, "ate.json")) as f:
            ate = json.load(f)
        n_lines = len(np.loadtxt(os.path.join(out, "f_traj_kitti.txt")))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    result = {"package": package, "frames": chip_smoke.N_KITTI_FRAMES, "trajectory_lines": n_lines,
              "ate_m": ate["ate_rmse"], "n_associated": ate["n_associated"], "seconds": seconds}
    print(json.dumps(result), flush=True)
    return result


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("jax", "torch"), required=True)
    args = ap.parse_args()

    from fasttrack_tpu_torch.datasets import synthetic

    reading(args.package, KB8_SIZE, synthetic.tumvi_kb8_rig(KB8_SIZE, KB8_SIZE, fov_deg=KB8_FOV_DEG),
            N_RIG_FRAMES, KB8_PLANE_Z, n_features=1024, n_levels=8, scale_factor=1.2)


if __name__ == "__main__":
    main()

"""System facade (src/System.cc): wires the whole pipeline and exposes the
public tracking API + trajectory persistence.

Port of fasttrack_tpu/system.py for `Sensor.STEREO` and `Sensor.IMU_STEREO`
over the two rigs the reference's datasets ship: a pinhole pair (EuRoC),
rectified at start-up when it is distorted, and a Kannala-Brandt-8
fisheye pair (TUM-VI), which takes the fisheye route; for
`Sensor.MONOCULAR` and `Sensor.IMU_MONOCULAR`, one pinhole camera; and for
`Sensor.RGBD` and `Sensor.IMU_RGBD`, one pinhole camera with its metric
depth map (TUM RGB-D; a RealSense D435i with its IMU).
Mirrors the reference: the constructor builds Atlas/Tracking/LocalMapping,
TrackStereo, TrackRGBD and TrackMonocular are the entry points, then
Shutdown and the trajectory savers in TUM / EuRoC / KITTI formats
(System.cc:590-1285).

A monocular System initializes from two views and closes loops with the
scale free (fix_scale=False, a Sim3 loop correction), as the JAX System
does; with an IMU its map is metric once the IMU initializes, and its loop
closer keeps the scale fixed. An RGB-D System is a stereo one from the
tracker down (its depth makes the keypoints' right coordinates), with the
scale fixed. Only stereo sensors are rectified, so a monocular or RGB-D
camera's distortion coefficients are ignored, with or without an IMU, as
in the JAX package (ROADMAP F30).

Start-up camera transforms, in the JAX package's order: input resize
(Camera.newWidth / newHeight: the intrinsics scaled once, every frame
resized on the host), then rectification of a distorted pinhole pair with
a known extrinsic (cameras/rectify.py: remap tables once, a host remap of
both images every frame). The System works on a copy of the caller's
Settings, which the JAX System rewrites in place. With an IMU the
rectifying rotation R1 goes into the extrinsic, T_b_rect = T_b_c1 [R1^T|0],
where the JAX System keeps T_b_c1 (ROADMAP F10).

Place recognition is on by default for both sensors, as in the JAX
package and the reference: `vocabulary=None` loads the port's shipped
vocabulary (bow/orb_vocab_32k.npz), a LoopCloser gets every keyframe after
the local mapper has processed it (inline, or through its own thread with
`async_mapping=True`), closes loops (inertially in a map marked inertial,
which no live run does here or in the JAX package: ROADMAP F16) and
welds a map started after a loss into the earlier one it revisits, and
a lost tracker relocalizes against the keyframe database they share.
`vocabulary=False` runs tracking and local mapping without them. On a KB8
map the Sim3 solver and its refinement project through the pinhole K of
camera 1's intrinsics, as in the JAX package (ROADMAP F21).

Atlas save and load (System::SaveAtlas / LoadAtlas, System.cc:1424-1560)
write and read the JAX package's pickle, key for key and dtype for dtype:
every field is a NumPy array, a Python scalar, a dict, a set or None, never
a torch tensor, so a file written on the card loads on the CPU and either
package's file loads in the other. A load rebuilds each map's point store,
marks the maps inertial as the file says (the only place that does, as in
the JAX package: ROADMAP F16) and leaves the tracker RECENTLY_LOST against
the newest keyframe, so the next frame relocalizes; with an IMU and an
initialized map it also restores the bias, the velocity and the last
keyframe's body state, and tracks visually until its first keyframe after
the load (ROADMAP F45). What the file does not hold starts afresh, as in
the JAX package (ROADMAP F43): the map's full-inertial-BA flags, each
point's visible and found counters, and the keyframes' feature vectors.

As the JAX System, it builds its mapper without a mesh; a
`LocalMapper(mesh=parallel.make_mesh(...))` shards its local bundle
adjustment over the mesh's devices (M10).
"""

from __future__ import annotations

import dataclasses
import enum
import pickle
import time
import types
from typing import Optional

import numpy as np
import torch

from fasttrack_tpu_torch.bow.vocabulary import load_default_vocabulary, vocabulary_checksum
from fasttrack_tpu_torch.cameras.host import host_camera
from fasttrack_tpu_torch.cameras.models import Camera
from fasttrack_tpu_torch.cameras.rectify import compute_rectification, remap_bilinear, resize_maps
from fasttrack_tpu_torch.cameras.stereo import stereo_rig_from_numpy
from fasttrack_tpu_torch.convert import imu_calib_from_numpy
from fasttrack_tpu_torch.device import resolve
from fasttrack_tpu_torch.kernels import KernelConfig, get_run_mode
from fasttrack_tpu_torch.local_mapping import LocalMapper
from fasttrack_tpu_torch.loop_closing import LoopCloser
from fasttrack_tpu_torch.nputils import matrix_to_quat
from fasttrack_tpu_torch.ops.extractor import OrbConfig
from fasttrack_tpu_torch.settings import Settings
from fasttrack_tpu_torch.slam_map import Atlas, KeyFrame, Map, MapPoint
from fasttrack_tpu_torch.stats import Stats
from fasttrack_tpu_torch.tracking import Tracker, TrackingState


def _host(x):
    """A field as the atlas file holds it: a tensor becomes its NumPy array
    (on the host), containers are converted item by item, the rest stays."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_host(v) for v in x)
    if isinstance(x, list):
        return [_host(v) for v in x]
    return x


def _pre_to_dict(p):
    """Host preintegration snapshot -> plain dict (pickle-stable): the JAX
    package's keys, without avgA / avgW, which its file does not hold."""
    if p is None:
        return None
    return {
        "dT": p.dT, "dR": p.dR, "dV": p.dV, "dP": p.dP,
        "JRg": p.JRg, "JVg": p.JVg, "JVa": p.JVa, "JPg": p.JPg, "JPa": p.JPa,
        "C": p.C, "bg": p.b0.bg, "ba": p.b0.ba,
    }


def _pre_from_dict(d):
    """The snapshot back, as the JAX package rebuilds it: a namespace with
    the same fields (readers take avgA / avgW with a default of zero)."""
    if d is None:
        return None
    return types.SimpleNamespace(
        dT=d["dT"], dR=d["dR"], dV=d["dV"], dP=d["dP"],
        JRg=d["JRg"], JVg=d["JVg"], JVa=d["JVa"], JPg=d["JPg"], JPa=d["JPa"],
        C=d["C"],
        b0=types.SimpleNamespace(bg=d["bg"], ba=d["ba"]),
    )


class Sensor(enum.Enum):
    MONOCULAR = 0
    STEREO = 1
    RGBD = 2
    IMU_MONOCULAR = 3
    IMU_STEREO = 4
    IMU_RGBD = 5


_STEREO_SENSORS = (Sensor.STEREO, Sensor.IMU_STEREO)
_MONO_SENSORS = (Sensor.MONOCULAR, Sensor.IMU_MONOCULAR)
_RGBD_SENSORS = (Sensor.RGBD, Sensor.IMU_RGBD)
_INERTIAL_SENSORS = (Sensor.IMU_STEREO, Sensor.IMU_MONOCULAR, Sensor.IMU_RGBD)


def _needs_rectification(settings: Settings, sensor: Sensor) -> bool:
    """A stereo sensor's distorted pinhole pair with a known extrinsic (the
    condition of Settings::precomputeRectificationMaps, src/Settings.cc; the
    JAX System rectifies stereo sensors only, ROADMAP F30)."""
    return (
        sensor in _STEREO_SENSORS
        and settings.camera_type == "PinHole"
        and settings.camera2 is not None
        and settings.T_c1_c2 is not None
        and settings.dist1 is not None
        and bool(
            np.any(settings.dist1)
            or (settings.dist2 is not None and np.any(settings.dist2))
        )
    )


class System:
    def __init__(
        self,
        settings: Settings,
        sensor: Sensor = Sensor.STEREO,
        kernel_config: Optional[KernelConfig] = None,
        async_mapping: bool = False,
        vocabulary=None,
        device=None,            # None: the card (device.resolve); "cpu" for the CPU
    ):
        self.device = resolve(device)
        settings = dataclasses.replace(settings)    # the caller's stays as it was
        self.settings = settings
        self.sensor = sensor
        self.kcfg = kernel_config or get_run_mode()
        self.stats = Stats()
        self.atlas = Atlas()

        # Input resize (System.cc:273-284 resize branch): when the settings
        # ask for another working resolution, scale the intrinsics once and
        # resize every incoming frame bilinearly.
        self._resize_to = None
        if settings.new_width and settings.new_height and (
            settings.new_width != settings.width
            or settings.new_height != settings.height
        ):
            sx = settings.new_width / settings.width
            sy = settings.new_height / settings.height

            def scale_cam(c):
                if c is None:
                    return None
                pp = c.params.detach().cpu().numpy().copy()   # float32, as the JAX package scales
                pp[0] *= sx
                pp[1] *= sy
                pp[2] *= sx
                pp[3] *= sy
                return Camera(c.kind, torch.from_numpy(pp).to(self.device),
                              settings.new_width, settings.new_height)

            settings.camera1 = scale_cam(settings.camera1)
            settings.camera2 = scale_cam(settings.camera2)
            settings.bf *= sx
            self._resize_to = (settings.new_height, settings.new_width)
            self._resize_maps = {}        # input shape -> (mx, my)
            settings.width = settings.new_width
            settings.height = settings.new_height

        # Stereo rectification at start-up (Settings::precomputeRectificationMaps,
        # src/Settings.cc; applied per frame as System.cc:273-284 does): a
        # distorted pinhole pair with a known extrinsic gets remap tables,
        # and the whole pipeline runs in the rectified frame.
        self._rect = None
        if _needs_rectification(settings, sensor):
            self._rect = compute_rectification(
                settings.camera1, settings.dist1,
                settings.camera2,
                settings.dist2 if settings.dist2 is not None else np.zeros(4),
                settings.T_c1_c2, settings.width, settings.height, device=self.device,
            )
            settings.camera1 = self._rect.camera
            settings.bf = self._rect.bf
        self.atlas.add_camera(settings.camera1)

        orb = OrbConfig(
            height=settings.height,
            width=settings.width,
            n_features=settings.n_features,
            n_levels=settings.n_levels,
            scale_factor=settings.scale_factor,
            ini_threshold=settings.ini_th_fast,
            min_threshold=settings.min_th_fast,
        )
        # Place recognition is on by default: the reference always loads
        # ORBvoc.txt (System.cc:130-146). vocabulary=None loads the shipped
        # one; vocabulary=False disables loop closing and relocalization.
        if vocabulary is None:
            vocabulary = load_default_vocabulary()
        self.vocabulary = vocabulary if vocabulary is not False else None
        self.loop_closer = None
        if self.vocabulary is not None:
            fx, fy, cx, cy = host_camera(settings.camera1).params[:4]
            self.loop_closer = LoopCloser(
                self.atlas, self.vocabulary,
                np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]]),
                scale_factor=settings.scale_factor,
                # the scale is observed by a pair or an IMU; a visual
                # monocular map's is free (Sim3)
                fix_scale=sensor is not Sensor.MONOCULAR,
                run_async=async_mapping,
                camera=settings.camera1,
                bf=settings.bf or 1.0,
                n_levels=settings.n_levels,
                device=self.device,
            )
        # Inertial calibration (IMU::Calib, ImuTypes.h:46-126) from settings.
        self.imu_calib = None
        if sensor in _INERTIAL_SENSORS:
            T_bc = settings.T_b_c1 if settings.T_b_c1 is not None else np.eye(4)
            T_bc = np.asarray(T_bc, np.float64)
            if self._rect is not None:
                # the body from the rectified camera: X_c1 = R1^T X_rect
                # (ORB-SLAM3 composes it too, Settings.h:157; ROADMAP F10)
                T_c1_rect = np.eye(4)
                T_c1_rect[:3, :3] = self._rect.R1.T
                T_bc = T_bc @ T_c1_rect
            self.imu_calib = imu_calib_from_numpy(
                T_bc[:3, :3], T_bc[:3, 3], settings.imu_noise_gyro, settings.imu_noise_acc,
                settings.imu_walk_gyro, settings.imu_walk_acc, settings.imu_frequency,
                device=self.device,
            )
        # A KB8 fisheye pair with its extrinsic takes the fisheye route
        # (Frame.cc:1115 fisheye ctor)
        stereo_rig = None
        if (
            sensor in _STEREO_SENSORS
            and settings.camera_type in ("KannalaBrandt8", "Fisheye")
            and settings.camera2 is not None
            and settings.T_c1_c2 is not None
        ):
            stereo_rig = stereo_rig_from_numpy(
                settings.camera1, settings.camera2, settings.T_c1_c2, settings.bf,
                device=self.device,
            )
        self.local_mapper = LocalMapper(
            self.atlas, settings.camera1, settings.bf,
            settings.scale_factor, settings.n_levels,
            run_async=async_mapping,
            loop_closer=self.loop_closer,
            imu_calib=self.imu_calib,
            monocular=sensor in _MONO_SENSORS,
            stats=self.stats,
            device=self.device,
        )
        self.tracker = Tracker(
            settings.camera1, orb, settings.bf or 1.0, self.atlas,
            kernel_config=self.kcfg, stats=self.stats,
            local_mapper=self.local_mapper,
            th_depth_factor=settings.th_depth,
            monocular=sensor in _MONO_SENSORS,
            imu_calib=self.imu_calib,
            stereo_rig=stereo_rig,
            device=self.device,
        )
        self.local_mapper.tracker = self.tracker
        if self.loop_closer is not None:
            self.tracker.reloc_db = self.loop_closer.db
            self.atlas.set_kf_database(self.loop_closer.db)
            self.tracker.vocabulary = self.vocabulary
            self.loop_closer.tracker = self.tracker
            self.loop_closer.local_mapper = self.local_mapper
        if settings.load_atlas:
            self.load_atlas(settings.load_atlas)

    # ------------------------------------------------------------- tracking
    def track_stereo(self, img_left, img_right, timestamp: float, imu=None):
        if self.sensor not in _STEREO_SENSORS:
            raise RuntimeError("track_stereo called on non-stereo sensor config")
        if imu:
            self.tracker_grab_imu(imu)
        if self._resize_to is not None:
            t0 = time.perf_counter()
            img_left = self._resize_input(img_left)
            img_right = self._resize_input(img_right)
            self.stats.record("input_resize", (time.perf_counter() - t0) * 1e3)
        if self._rect is not None:
            t0 = time.perf_counter()
            img_left = remap_bilinear(np.asarray(img_left), self._rect.map_lx, self._rect.map_ly)
            img_right = remap_bilinear(np.asarray(img_right), self._rect.map_rx, self._rect.map_ry)
            self.stats.record("rectify_remap", (time.perf_counter() - t0) * 1e3)
        return self.tracker.track_stereo(img_left, img_right, timestamp)

    def _resize_input(self, img):
        """Bilinear resize to the configured working resolution (the tables
        are made once per input shape)."""
        img = np.asarray(img)
        shape = img.shape[:2]
        if shape not in self._resize_maps:
            self._resize_maps[shape] = resize_maps(*shape, *self._resize_to)
        return remap_bilinear(img, *self._resize_maps[shape])

    def track_rgbd(self, img, depth_map, timestamp: float, imu=None):
        """One image and its metric depth map (H, W), depth <= 0 or NaN where
        there is none. With `new_width` / `new_height` both are resized
        bilinearly, as in the JAX package: the resized depth mixes the
        depths on either side of an edge into values that lie on neither
        surface."""
        if self.sensor not in _RGBD_SENSORS:
            raise RuntimeError("track_rgbd called on non-RGBD sensor config")
        if imu:
            self.tracker_grab_imu(imu)
        if self._resize_to is not None:
            t0 = time.perf_counter()
            img = self._resize_input(img)
            depth_map = self._resize_input(depth_map)
            self.stats.record("input_resize", (time.perf_counter() - t0) * 1e3)
        return self.tracker.track_rgbd(img, depth_map, timestamp)

    def track_monocular(self, img, timestamp: float, imu=None):
        if self.sensor not in _MONO_SENSORS:
            raise RuntimeError("track_monocular called on non-mono sensor config")
        if imu:
            self.tracker_grab_imu(imu)
        if self._resize_to is not None:
            t0 = time.perf_counter()
            img = self._resize_input(img)
            self.stats.record("input_resize", (time.perf_counter() - t0) * 1e3)
        return self.tracker.track_monocular(img, timestamp)

    def tracker_grab_imu(self, imu_samples):
        """System::GrabImuData (System.cc:333): queue (t, acc, gyro) samples
        for per-frame preintegration in the tracker."""
        if self.imu_calib is None:
            raise RuntimeError("IMU samples passed to a non-inertial sensor config")
        self.tracker.grab_imu(imu_samples)

    @property
    def tracking_state(self) -> TrackingState:
        return self.tracker.state

    def activate_localization_mode(self):
        """System::ActivateLocalizationMode: freeze the map; the tracker
        localizes against it without inserting keyframes."""
        self.tracker.localization_only = True

    def deactivate_localization_mode(self):
        self.tracker.localization_only = False

    def shutdown(self):
        """System::Shutdown (System.cc:520-560): stop the worker threads,
        then persist the atlas if configured."""
        self.local_mapper.stop()
        if self.loop_closer is not None:
            self.loop_closer.stop()
        if self.settings.save_atlas:
            self.save_atlas(self.settings.save_atlas)

    # ----------------------------------------------------------- atlas io
    def save_atlas(self, path: str):
        """System::SaveAtlas: a pickle of the id graph, the JAX package's
        schema (fasttrack_tpu/system.py save_atlas) with every field on the
        host."""
        state = {
            "maps": [],
            "next_ids": (
                self.atlas._next_map_id,
                self.atlas._next_kf_id,
                self.atlas._next_mp_id,
            ),
            # MD5 vocabulary guard (System.cc:1424-1464): a map's BoW vectors
            # are meaningless under a different vocabulary, so refuse on load.
            "vocab_checksum": vocabulary_checksum(self.vocabulary),
        }
        for m in self.atlas.maps:
            state["maps"].append(_host({
                "map_id": m.map_id,
                "init_kf_id": m.init_kf_id,
                "imu_initialized": m.imu_initialized,
                "is_inertial": m.is_inertial,
                "keyframes": {
                    k.kid: {
                        "frame_id": k.frame_id,
                        "timestamp": k.timestamp,
                        "R_cw": k.R_cw, "t_cw": k.t_cw,
                        "kp_uv": k.kp_uv, "kp_level": k.kp_level,
                        "kp_angle": k.kp_angle,
                        "desc_packed": k.desc_packed,
                        "desc_signed": k.desc_signed,
                        "u_right": k.u_right, "depth": k.depth,
                        "valid": k.valid, "mp_ids": k.mp_ids,
                        "covisible": k.covisible,
                        "parent_id": k.parent_id,
                        "children": k.children,
                        # inertial chain and place-recognition state
                        # (System.cc:1424-1560 serializes these too)
                        "velocity": k.velocity,
                        "imu_bias": k.imu_bias,
                        "prev_kf_id": k.prev_kf_id,
                        "next_kf_id": k.next_kf_id,
                        "preintegrated": _pre_to_dict(k.preintegrated),
                        "bow_vec": k.bow_vec,
                        "loop_edges": k.loop_edges,
                        "merge_edges": k.merge_edges,
                    }
                    for k in m.keyframes.values()
                },
                "mappoints": {
                    p.mid: {
                        "position": p.position,
                        "normal": p.normal,
                        "desc_packed": p.desc_packed,
                        "desc_signed": p.desc_signed,
                        "observations": p.observations,
                        "ref_kf_id": p.ref_kf_id,
                        "first_kf_id": p.first_kf_id,
                        "min_distance": p.min_distance,
                        "max_distance": p.max_distance,
                    }
                    for p in m.mappoints.values()
                },
            }))
        with open(path, "wb") as f:
            pickle.dump(state, f)

    def load_atlas(self, path: str):
        """System::LoadAtlas: rebuild the maps of a file written by either
        package, then leave the tracker to relocalize in the newest map."""
        with open(path, "rb") as f:
            state = pickle.load(f)
        saved_ck = state.get("vocab_checksum")
        if saved_ck is not None:
            ck = vocabulary_checksum(self.vocabulary)
            if saved_ck and ck and saved_ck != ck:
                raise ValueError(
                    f"atlas at {path} was saved with a different vocabulary "
                    f"(checksum {saved_ck[:12]}… != {ck[:12]}…); refusing to "
                    "load (System.cc:1466-1479 vocabulary MD5 guard)"
                )
        self.atlas._maps.clear()
        (self.atlas._next_map_id, self.atlas._next_kf_id,
         self.atlas._next_mp_id) = state["next_ids"]
        for md in state["maps"]:
            m = Map(md["map_id"])     # a fresh PointStore with a fresh version
            m.kf_db = self.atlas.kf_db
            m.init_kf_id = md["init_kf_id"]
            m.imu_initialized = md.get("imu_initialized", False)
            m.is_inertial = md.get("is_inertial", False)
            for kid, kd in md["keyframes"].items():
                kf = KeyFrame(
                    kid, kd["frame_id"], kd["timestamp"], kd["R_cw"], kd["t_cw"],
                    kd["kp_uv"], kd["kp_level"], kd["kp_angle"],
                    kd["desc_packed"], kd["desc_signed"], kd["u_right"],
                    kd["depth"], kd["valid"],
                )
                kf.mp_ids = kd["mp_ids"]
                kf.covisible = kd["covisible"]
                kf.parent_id = kd["parent_id"]
                kf.children = kd["children"]
                kf.velocity = kd.get("velocity")
                kf.imu_bias = kd.get("imu_bias")
                kf.prev_kf_id = kd.get("prev_kf_id")
                kf.next_kf_id = kd.get("next_kf_id")
                kf.preintegrated = _pre_from_dict(kd.get("preintegrated"))
                kf.bow_vec = kd.get("bow_vec")
                kf.loop_edges = kd.get("loop_edges", set())
                kf.merge_edges = kd.get("merge_edges", set())
                m.add_keyframe(kf)
                if self.loop_closer is not None and kf.bow_vec is not None:
                    self.loop_closer.db.add(kf.kid, kf.bow_vec)
            for mid, pd in md["mappoints"].items():
                mp = MapPoint(mid, pd["position"], pd["ref_kf_id"], pd["first_kf_id"])
                mp.normal = pd["normal"]
                mp.desc_packed = pd["desc_packed"]
                mp.desc_signed = pd["desc_signed"]
                mp.observations = pd["observations"]
                mp.min_distance = pd["min_distance"]
                mp.max_distance = pd["max_distance"]
                m.add_mappoint(mp)
            self.atlas._maps.append(m)
        if self.atlas._maps:
            self.atlas.current = self.atlas._maps[-1]
            if self.atlas.current.keyframes:
                self._resume_tracker()

    def _resume_tracker(self):
        """The tracker after a load: RECENTLY_LOST against the newest
        keyframe, so the next frame relocalizes; with an IMU and an
        initialized map, the IMU anchor of that keyframe restored, so a
        loaded inertial map keeps its initialization; the IMU waits for the
        tracker's first keyframe after the load (ROADMAP F45)."""
        t = self.tracker
        t.ref_kf_id = max(self.atlas.current.keyframes)
        t.state = TrackingState.RECENTLY_LOST
        last = self.atlas.current.keyframes[t.ref_kf_id]
        if (
            self.imu_calib is not None
            and self.atlas.current.imu_initialized
            and last.velocity is not None
        ):
            if last.imu_bias is not None:
                t.bias = (np.asarray(last.imu_bias[0]), np.asarray(last.imu_bias[1]))
            R_wb, p_w = t._body_from_cam(last.R_cw, last.t_cw)
            t.last_kf_state = (R_wb, p_w, np.asarray(last.velocity))
            t.v_w = np.asarray(last.velocity)
            t.last_kf_id = last.kid
            # No preintegration spans from that keyframe's time to the next
            # frame: the tracker re-acquires and tracks visually, and the
            # second frame it tracks becomes a keyframe that anchors the IMU
            # again (ROADMAP F45; the JAX tracker predicts from the keyframe
            # through the samples after the load alone, and does not
            # re-acquire)
            t.imu_anchor_stale = True

    # ------------------------------------------------------------ trajectory
    def _trajectory(self):
        return self.tracker.trajectory

    def save_trajectory_tum(self, path: str):
        """System::SaveTrajectoryTUM: 't tx ty tz qx qy qz qw' of Twc."""
        with open(path, "w") as f:
            for ts, R_cw, t_cw in self._trajectory():
                R_wc = R_cw.T
                t_wc = -R_wc @ t_cw
                q = matrix_to_quat(R_wc)  # [w x y z]
                f.write(
                    f"{ts:.6f} {t_wc[0]:.7f} {t_wc[1]:.7f} {t_wc[2]:.7f} "
                    f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n"
                )

    def save_trajectory_euroc(self, path: str):
        """System::SaveTrajectoryEuRoC: timestamps in ns, same quat order."""
        with open(path, "w") as f:
            for ts, R_cw, t_cw in self._trajectory():
                R_wc = R_cw.T
                t_wc = -R_wc @ t_cw
                q = matrix_to_quat(R_wc)
                f.write(
                    f"{ts*1e9:.0f} {t_wc[0]:.9f} {t_wc[1]:.9f} {t_wc[2]:.9f} "
                    f"{q[1]:.9f} {q[2]:.9f} {q[3]:.9f} {q[0]:.9f}\n"
                )

    def save_trajectory_kitti(self, path: str):
        """System::SaveTrajectoryKITTI: 3x4 Twc row-major per line."""
        with open(path, "w") as f:
            for _, R_cw, t_cw in self._trajectory():
                R_wc = R_cw.T
                t_wc = -R_wc @ t_cw
                M = np.hstack([R_wc, t_wc[:, None]])
                f.write(" ".join(f"{x:.9e}" for x in M.reshape(-1)) + "\n")

    def save_keyframe_trajectory_tum(self, path: str):
        kfs = sorted(self.atlas.current.keyframes.values(), key=lambda k: k.kid)
        with open(path, "w") as f:
            for kf in kfs:
                R_wc, t_wc = kf.pose_wc()
                q = matrix_to_quat(R_wc)
                f.write(
                    f"{kf.timestamp:.6f} {t_wc[0]:.7f} {t_wc[1]:.7f} {t_wc[2]:.7f} "
                    f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n"
                )

    def save_stats(self, directory: str):
        self.stats.save(directory)

"""System facade (src/System.cc): wires the whole pipeline and exposes the
public tracking API + trajectory persistence.

Port of fasttrack_tpu/system.py for `Sensor.STEREO` and `Sensor.IMU_STEREO`
over the two rigs the reference's datasets ship: a pinhole pair (EuRoC),
rectified at start-up when it is distorted, and a Kannala-Brandt-8
fisheye pair (TUM-VI), which takes the fisheye route. Mirrors the
reference: the constructor builds Atlas/Tracking/LocalMapping, TrackStereo
is the entry point, then Shutdown and the trajectory savers in TUM / EuRoC
/ KITTI formats (System.cc:590-1285).

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

Not ported, each raising NotImplementedError with its ROADMAP item when it
is asked for, never taking another path quietly: the monocular and RGB-D
sensors with and without an IMU and atlas save/load, inertial maps
included (M9).
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Optional

import numpy as np
import torch

from fasttrack_tpu_torch.bow.vocabulary import load_default_vocabulary
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
from fasttrack_tpu_torch.slam_map import Atlas
from fasttrack_tpu_torch.stats import Stats
from fasttrack_tpu_torch.tracking import Tracker, TrackingState


class Sensor(enum.Enum):
    MONOCULAR = 0
    STEREO = 1
    RGBD = 2
    IMU_MONOCULAR = 3
    IMU_STEREO = 4
    IMU_RGBD = 5


def _needs_rectification(settings: Settings) -> bool:
    """A distorted pinhole pair with a known extrinsic (the condition of
    Settings::precomputeRectificationMaps, src/Settings.cc)."""
    return (
        settings.camera_type == "PinHole"
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
        if sensor not in (Sensor.STEREO, Sensor.IMU_STEREO):
            raise NotImplementedError(
                f"the sensor {sensor.name} is not ported yet (ROADMAP M9)"
            )
        if settings.load_atlas or settings.save_atlas:
            raise NotImplementedError(
                "atlas save/load (System.LoadAtlasFromFile / SaveAtlasToFile) is "
                "not ported yet (ROADMAP M9)"
            )
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
        if _needs_rectification(settings):
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
                fix_scale=True,   # stereo and stereo-inertial: the scale is observed
                run_async=async_mapping,
                camera=settings.camera1,
                bf=settings.bf or 1.0,
                n_levels=settings.n_levels,
                device=self.device,
            )
        # Inertial calibration (IMU::Calib, ImuTypes.h:46-126) from settings.
        self.imu_calib = None
        if sensor is Sensor.IMU_STEREO:
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
            settings.camera_type in ("KannalaBrandt8", "Fisheye")
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
            stats=self.stats,
            device=self.device,
        )
        self.tracker = Tracker(
            settings.camera1, orb, settings.bf or 1.0, self.atlas,
            kernel_config=self.kcfg, stats=self.stats,
            local_mapper=self.local_mapper,
            th_depth_factor=settings.th_depth,
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

    # ------------------------------------------------------------- tracking
    def track_stereo(self, img_left, img_right, timestamp: float, imu=None):
        if self.sensor not in (Sensor.STEREO, Sensor.IMU_STEREO):
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
        raise RuntimeError("track_rgbd called on non-RGBD sensor config")

    def track_monocular(self, img, timestamp: float, imu=None):
        raise RuntimeError("track_monocular called on non-mono sensor config")

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
        """System::Shutdown (System.cc:520-560): stop the worker threads."""
        self.local_mapper.stop()
        if self.loop_closer is not None:
            self.loop_closer.stop()

    def save_atlas(self, path: str):
        raise NotImplementedError("atlas save is not ported yet (ROADMAP M9)")

    def load_atlas(self, path: str):
        raise NotImplementedError("atlas load is not ported yet (ROADMAP M9)")

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

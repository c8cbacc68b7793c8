"""System facade (src/System.cc): wires the whole pipeline and exposes the
public tracking API + trajectory persistence.

Port of fasttrack_tpu/system.py for `Sensor.STEREO` and `Sensor.IMU_STEREO`
over a rectified pinhole pair. Mirrors the reference: the constructor builds
Atlas/Tracking/LocalMapping, TrackStereo is the entry point, then Shutdown
and the trajectory savers in TUM / EuRoC / KITTI formats
(System.cc:590-1285).

Place recognition is on by default, as in the JAX package and the
reference: `vocabulary=None` loads the port's shipped vocabulary
(bow/orb_vocab_32k.npz), a synchronous LoopCloser gets every keyframe after
the local mapper has processed it, and a lost tracker relocalizes against
the keyframe database the two share. `vocabulary=False` runs tracking and
local mapping without them.

Not ported, each raising NotImplementedError with its ROADMAP item when it
is asked for, never taking another path quietly: a vocabulary with
`Sensor.IMU_STEREO` (inertial loop closing) or with `async_mapping=True`
(the loop-closer and global-BA threads) (M7b); the monocular and RGB-D
sensors with and without an IMU, input resize, start-up rectification of a
distorted pair, fisheye rigs and atlas save/load, inertial maps included
(M9).
"""

from __future__ import annotations

import enum
from typing import Optional

import numpy as np

from fasttrack_tpu_torch.bow.vocabulary import load_default_vocabulary
from fasttrack_tpu_torch.cameras.host import host_camera
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
        if vocabulary is not False and sensor is Sensor.IMU_STEREO:
            raise NotImplementedError(
                "inertial loop closing (a vocabulary with Sensor.IMU_STEREO) is not "
                "ported yet (ROADMAP M7b): pass vocabulary=False"
            )
        if settings.new_width and settings.new_height and (
            settings.new_width != settings.width
            or settings.new_height != settings.height
        ):
            raise NotImplementedError(
                "input resize (Camera.newWidth / newHeight) is not ported yet (ROADMAP M9)"
            )
        if settings.camera_type in ("KannalaBrandt8", "Fisheye"):
            raise NotImplementedError("fisheye (KB8) rigs are not ported yet (ROADMAP M9)")
        if _needs_rectification(settings):
            raise NotImplementedError(
                "start-up rectification of a distorted stereo pair "
                "(cameras/rectify.py) is not ported yet (ROADMAP M9)"
            )
        if settings.load_atlas or settings.save_atlas:
            raise NotImplementedError(
                "atlas save/load (System.LoadAtlasFromFile / SaveAtlasToFile) is "
                "not ported yet (ROADMAP M9)"
            )
        self.device = resolve(device)
        self.settings = settings
        self.sensor = sensor
        self.kcfg = kernel_config or get_run_mode()
        self.stats = Stats()
        self.atlas = Atlas()
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
                fix_scale=True,   # stereo: the scale is observed
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
            self.imu_calib = imu_calib_from_numpy(
                T_bc[:3, :3], T_bc[:3, 3], settings.imu_noise_gyro, settings.imu_noise_acc,
                settings.imu_walk_gyro, settings.imu_walk_acc, settings.imu_frequency,
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
        return self.tracker.track_stereo(img_left, img_right, timestamp)

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

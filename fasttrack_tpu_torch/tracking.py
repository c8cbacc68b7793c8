"""Tracking front-end: the per-frame state machine (src/Tracking.cc).

Port of fasttrack_tpu/tracking.py for one pinhole camera (monocular, or
RGB-D with its depth map), a rectified pinhole pair and a KB8 fisheye pair,
each visual or with an IMU. Host-side
orchestration of the device programs, mirroring the reference's Track()
control flow (Tracking.cc:1851-2392):

    GrabImage -> process_stereo_frame_stacked (device)    [ORB + stereo]
    -> TrackWithMotionModel (device search + pose opt)    [Tracking.cc:2911]
       fallback TrackReferenceKeyFrame                    [Tracking.cc:2777]
    -> TrackLocalMap (host frustum cull -> device search
       -> pose opt unless bypassed)                       [Tracking.cc:3042]
    -> NeedNewKeyFrame / CreateNewKeyFrame                [Tracking.cc:3193]
    -> RECENTLY_LOST / LOST handling + new map in Atlas   [Tracking.cc:2038]
       with relocalization against the keyframe database  [Tracking.cc:3798]

An OK-state frame takes the single-fetch fused path (fused_track); the first
frame after initialization, a failed motion-model search and lost states
take the stepwise programs above. The tracker creates the close stereo
points of every keyframe itself and hands the keyframe to the local mapper
(local_mapping.LocalMapper), which culls, triangulates, fuses and adjusts;
without one it is stereo visual odometry over a growing map. With a
vocabulary and the keyframe database it shares with the loop closer
(`vocabulary`, `reloc_db`, wired by the System), a lost visual tracker
relocalizes: BoW candidates, the top-K match at K = 2, RANSAC PnP on the
host, pose optimization on the device and a widening-window rebind.

With an IMU (`imu_calib`) the tracker preintegrates the queued samples on
the host every frame (imu.preintegration.HostPreintegrated), predicts the
frame from the last keyframe's body state once the mapper has initialized
the IMU, runs the inertial fused frame (twm_step -> tlm_step_vi -> one
fetch) or the VI pose optimizers on stepwise frames, dead-reckons through
RECENTLY_LOST, stores the inertial state on every keyframe, and resets a
map that loses track before its IMU initialized.

The five offload toggles (KernelConfig) are read where the reference
branches on them: a toggle that is off runs its stage on the host
(ops/host_kernels.py over the native library of native.py) and one that is
on runs it on the device, never the other way round. ORB extraction and
stereo matching route the frame through `_track_stereo_host` unless both
are on; search_local_points and pose_estimation pick the local-map and the
motion-model matcher; pose_optimization=False bypasses pose optimization in
TrackLocalMap (Tracking.cc:3080-3106, the FastTrack ablation mode). Any
toggle that is off keeps every frame stepwise. Pose optimization itself and
the reference-keyframe matcher run on the device under every mask, as in
the JAX package. A KB8 pair with its rig (`stereo_rig`) takes the fisheye
front end (frame_pipeline.process_fisheye_frame_stacked) before the
toggles are read, as in the JAX package (ROADMAP F22).

A monocular tracker (`monocular=True`) extracts one image
(frame_pipeline.process_mono_frame) and never takes the host route: like
the JAX package it reads no toggle of the front end (ROADMAP F29). It
initializes from two views (MonocularInitialization: a sliding reference
frame, the level-0 search at radius 100 and ratio 0.9,
optim.two_view.reconstruct_two_view, the map scaled to a median depth of
1), creates no points itself afterwards (the mapper's epipolar
triangulation does), and asks for keyframes at the reference ratio 0.9.
With an IMU (monocular-inertial) its preintegration restarts whenever the
initializer sets or slides its reference frame, so the second keyframe of
the init carries the reference-to-current preintegration (ROADMAP F33), and
until the IMU is initialized it takes a keyframe every 0.25 s and no other
(F35); after the init it tracks as the stereo-inertial tracker does.

An RGB-D frame (`track_rgbd`) extracts its one image and reads the depth
map at each keypoint (frame_pipeline.process_rgbd_frame); from there it is
a stereo frame: the stereo initialization, the stereo keyframe rule (F12)
and close points with their depth. Like the JAX tracker it always takes
the stepwise programs, never the fused frame (ROADMAP F40), and reads no
toggle of the front end (F41), with an IMU or without.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Optional

import numpy as np
import torch

from fasttrack_tpu_torch import convert, frame_pipeline
from fasttrack_tpu_torch.bow.vocabulary import quantize
from fasttrack_tpu_torch.cameras.host import (
    frustum_depth_ok,
    host_camera,
    in_image_np,
    project_np,
    unproject_np,
)
from fasttrack_tpu_torch.cameras.models import FISHEYE_KB8, Camera
from fasttrack_tpu_torch.device import resolve
from fasttrack_tpu_torch.frame_pipeline import (
    pack_frame_for_host,
    process_fisheye_frame_stacked,
    process_mono_frame,
    process_rgbd_frame,
    process_stereo_frame_stacked,
)
from fasttrack_tpu_torch.fused_track import (
    pack_fused_for_host,
    pack_fused_vi_for_host,
    tlm_step,
    tlm_step_vi,
    twm_step,
    unpack_fused,
    unpack_fused_vi,
    vi_buffer,
)
from fasttrack_tpu_torch.imu.init import _so3_exp
from fasttrack_tpu_torch.imu.preintegration import (
    GRAVITY_VALUE,
    PRE_PACKED_SIZE,
    HostPreintegrated,
    pack_preintegrated,
)
from fasttrack_tpu_torch.kernels import KernelConfig
from fasttrack_tpu_torch.nputils import device_fetch
from fasttrack_tpu_torch.nputils import orthonormalize as _orthonormalize
from fasttrack_tpu_torch.ops import host_kernels as hk
from fasttrack_tpu_torch.ops.extractor import OrbConfig, extract_orb_pair_stacked
from fasttrack_tpu_torch.ops.project_match import (
    TH_HIGH,
    search_by_projection,
    tlm_match_packed,
    twm_match_packed,
)
from fasttrack_tpu_torch.ops.stereo_match import match_fisheye
from fasttrack_tpu_torch.optim import pose_optimize
from fasttrack_tpu_torch.optim.inertial import (
    WHITEN_SIZE,
    BodyState,
    pose_inertial_optimize_lastframe_packed,
    pose_inertial_optimize_packed,
    sqrtm_psd_np,
    whitening_np,
)
from fasttrack_tpu_torch.optim.pnp import ransac_pnp
from fasttrack_tpu_torch.optim.two_view import reconstruct_two_view
from fasttrack_tpu_torch.slam_map import Atlas, KeyFrame, MapPoint
from fasttrack_tpu_torch.stats import Stats


class TrackingState(enum.Enum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    RECENTLY_LOST = 3
    LOST = 4


@dataclasses.dataclass
class TrackedFrame:
    """Host snapshot of one processed frame."""

    frame_id: int
    timestamp: float
    kp_uv: np.ndarray        # (N, 2)
    kp_level: np.ndarray
    kp_angle: np.ndarray
    desc_packed: np.ndarray
    desc_signed: np.ndarray
    u_right: np.ndarray
    depth: np.ndarray
    valid: np.ndarray
    R_cw: np.ndarray = None
    t_cw: np.ndarray = None
    mp_ids: np.ndarray = None
    # Inertial state (world frame, body = IMU): set while tracking inertially.
    v_w: np.ndarray = None
    bg: np.ndarray = None
    ba: np.ndarray = None

    def __post_init__(self):
        if self.mp_ids is None:
            self.mp_ids = np.full(len(self.kp_uv), -1, dtype=np.int64)

    def pose_wc(self):
        return self.R_cw.T, -self.R_cw.T @ self.t_cw


def _frame_from_block(frame_id: int, timestamp: float, f32: np.ndarray,
                      packed: np.ndarray) -> TrackedFrame:
    """TrackedFrame from the fetched (>= 7, N) f32 frame block (x, y, level,
    angle, u_right, depth, valid) and the (N, 32) packed descriptors; the
    signed descriptors are rebuilt from the bits."""
    bits = np.unpackbits(packed, axis=1, bitorder="little")
    return TrackedFrame(
        frame_id=frame_id,
        timestamp=timestamp,
        kp_uv=np.ascontiguousarray(f32[:2].T),
        kp_level=f32[2].astype(np.int32),
        kp_angle=f32[3],
        desc_packed=packed,
        desc_signed=(2 * bits.astype(np.int8) - 1),
        u_right=f32[4],
        depth=f32[5],
        valid=f32[6] > 0.5,
    )


class Tracker:
    def __init__(
        self,
        camera: Camera,
        orb_config: OrbConfig,
        bf: float,
        atlas: Atlas,
        kernel_config: KernelConfig | None = None,
        stats: Stats | None = None,
        local_mapper=None,
        th_depth_factor: float = 40.0,
        min_frames_between_kf: int = 0,
        max_frames_between_kf: int = 20,
        monocular: bool = False,
        imu_calib=None,
        stereo_rig=None,
        device=None,            # None: the card (device.resolve); "cpu" for the CPU
    ):
        self.monocular = monocular
        self.device = resolve(device)
        # a KB8 pair's rig (cameras.stereo.StereoRig): the fisheye route
        self.stereo_rig = None if stereo_rig is None else stereo_rig.to(self.device)
        # --- inertial front-end state (Tracking.cc IMU members) ----------
        self.imu_calib = imu_calib            # imu.preintegration.ImuCalib
        self.use_imu = imu_calib is not None
        self.imu_queue: list = []             # (t, acc(3), gyro(3)) pending
        self.pre_from_kf = None               # HostPreintegrated since last KF
        self.pre_from_frame = None            # HostPreintegrated since last FRAME
        self._last_map_change = -1            # map.change_index snapshot
        self._last_preint_ts = None
        self.last_imu_time: float | None = None
        self.bias = (np.zeros(3), np.zeros(3))  # (bg, ba) current estimate
        self.v_w = np.zeros(3)                # current world velocity (body)
        self._prior_H = None   # ConstraintPoseImu info of the last frame
        self.last_kf_state = None             # host (R_wb, p_w, v_w) of the last KF
        self.last_kf_id = None
        # Set by an atlas load (System._resume_tracker): the last keyframe's
        # IMU state is restored, but no preintegration spans from its time,
        # so the tracker tracks visually until the second frame it tracks,
        # which becomes a keyframe to anchor the IMU on (ROADMAP F45)
        self.imu_anchor_stale = False
        if self.use_imu:
            self._R_bc, self._t_bc = imu_calib.extrinsic_np()       # host, float64
            self._Rbc_dev = imu_calib.R_bc.to(self.device)
            self._tbc_dev = imu_calib.t_bc.to(self.device)
        self.camera = dataclasses.replace(camera, params=camera.params.to(self.device))
        self._cam_host = host_camera(camera)   # host copy for the query blocks
        self._tlm_cand_ids = None  # local-map candidate ids for fused frames
        self._init_reference: Optional[TrackedFrame] = None  # monocular init
        self.reloc_db = None      # KeyFrameDatabase (shared with loop closing)
        self.vocabulary = None
        self.cfg = orb_config
        self.bf = float(bf)
        self.baseline = self.bf / float(self._cam_host.params[0])
        self.th_depth = th_depth_factor * self.baseline
        self.atlas = atlas
        self.kcfg = kernel_config or KernelConfig()
        self.stats = stats or Stats()
        self.local_mapper = local_mapper
        self.state = TrackingState.NO_IMAGES_YET
        self.last_frame: Optional[TrackedFrame] = None
        self.velocity: Optional[tuple] = None  # (R, t) of Tcl (cur<-last)
        self.ref_kf_id: Optional[int] = None
        self.frame_id = 0
        self.last_kf_frame_id = 0
        self.min_frames = min_frames_between_kf
        self.max_frames = max_frames_between_kf
        self.n_inliers = 0
        self.lost_since: Optional[float] = None
        self.time_recently_lost = 5.0  # Tracking.cc:71
        self.localization_only = False  # System::ActivateLocalizationMode
        self.trajectory: list = []     # (timestamp, R_cw, t_cw)
        self._frame_in_flight: Optional[TrackedFrame] = None  # tracked, not yet saved

        self._scale_factors = np.asarray(
            [orb_config.scale_factor**l for l in range(orb_config.n_levels)],
            np.float32,
        )
        self._inv_sigma2 = 1.0 / (self._scale_factors**2)
        # Device-resident scalar operands, staged once (each fresh scalar
        # tensor is its own host->device transfer).
        self._bf_dev = torch.tensor(self.bf, dtype=torch.float32, device=self.device)
        self._minz_dev = torch.tensor(self.baseline, dtype=torch.float32, device=self.device)
        self._fd_dev = None      # the current frame's device-resident FrameData
        self._store_key = None   # what the device mirror of the PointStore was made from
        self._store_dev = None

    # ------------------------------------------------------------------ utils
    def _upload(self, a, dtype) -> torch.Tensor:
        return convert.tensor_from_numpy(a, dtype, self.device)

    def _frame_device_arrays(self, frame: TrackedFrame):
        """Device-resident (x, y, desc, level, valid, angle) of the CURRENT
        frame if its FrameData is still live (no re-upload); falls back to
        uploading the host snapshot (e.g. relocalizing an older frame)."""
        fd = self._fd_dev
        if fd is not None and frame.frame_id == self.frame_id:
            k = fd.kps
            return k.x, k.y, k.desc_signed, k.level, k.valid, k.angle
        return (
            self._upload(frame.kp_uv[:, 0], np.float32),
            self._upload(frame.kp_uv[:, 1], np.float32),
            self._upload(frame.desc_signed, np.int8),
            self._upload(frame.kp_level, np.int32),
            self._upload(frame.valid, np.bool_),
            self._upload(frame.kp_angle, np.float32),
        )

    def _snapshot(self, fd, timestamp) -> TrackedFrame:
        """Host snapshot in ONE device->host fetch (a packed f32 block + the
        packed descriptors; frame_pipeline.pack_frame_for_host)."""
        f32_d, packed_d = pack_frame_for_host(fd)
        t_sync = time.perf_counter()
        f32, packed = device_fetch(f32_d, packed_d)
        self.stats.record("sync_ms", (time.perf_counter() - t_sync) * 1e3)
        self.stats.record_count("device_fetches", 1)
        return _frame_from_block(self.frame_id, timestamp, f32, packed)

    def _unproject(self, frame: TrackedFrame, idx: np.ndarray) -> np.ndarray:
        """Stereo/depth keypoints -> world points (host, float64, any camera
        model via cameras.host.unproject_np)."""
        rays = unproject_np(self._cam_host, frame.kp_uv[idx])  # z == 1
        Xc = rays * frame.depth[idx][:, None]
        R_wc, t_wc = frame.pose_wc()
        return Xc @ R_wc.T + t_wc

    # ------------------------------------------------------- main entry point
    def track_stereo(self, img_left, img_right, timestamp: float):
        t0 = time.perf_counter()
        if self.stereo_rig is not None and self.camera.kind == FISHEYE_KB8:
            # the fisheye stereo route (Frame.cc:1115 fisheye ctor), taken
            # before the toggles are read, as in the JAX package (ROADMAP
            # F22): one stacked uint8 upload, extraction and the K = 2
            # match on the device under every mask
            stacked = np.stack(
                [np.asarray(img_left, np.uint8), np.asarray(img_right, np.uint8)]
            )

            def dispatch_fisheye():
                return process_fisheye_frame_stacked(
                    torch.from_numpy(stacked).to(self.device), self.cfg, self.stereo_rig
                )

            if self._fused_eligible():
                out = self._track_fused(dispatch_fisheye, timestamp, t0)
                if out is not NotImplemented:
                    return out
            return self._track_frame(dispatch_fisheye(), timestamp, t0)
        if not (self.kcfg.orb_extraction and self.kcfg.stereo_match):
            # At least one front-end stage runs on the host: the ablation
            # modes of the reference's toggle matrix (ORBextractor.cc:1374,
            # Frame.cc:156 CPU branches).
            return self._track_stereo_host(img_left, img_right, timestamp, t0)
        # ONE uint8 host->device transfer for both cameras (the cast to
        # float32 happens on the device inside extraction).
        stacked = np.stack(
            [np.asarray(img_left, np.uint8), np.asarray(img_right, np.uint8)]
        )

        def dispatch_stereo():
            return process_stereo_frame_stacked(
                torch.from_numpy(stacked).to(self.device), self.cfg,
                self._bf_dev, self._minz_dev,
            )

        if self._fused_eligible():
            out = self._track_fused(dispatch_stereo, timestamp, t0)
            if out is not NotImplemented:
                return out
        return self._track_frame(dispatch_stereo(), timestamp, t0)

    def _track_stereo_host(self, img_left, img_right, timestamp: float, t0: float):
        """Front end with per-stage host/device dispatch (the reference's
        KernelController run-status branches). Extraction on the device
        brings its keypoints and both raw pyramids to the host in one fetch;
        stereo on the device takes the host keypoints and raw pyramids up
        and fetches the depths."""
        if self.kcfg.orb_extraction:
            # float32, as the JAX package takes them here: a float image is
            # not truncated to uint8 as on the all-device path
            stacked = np.stack(
                [np.asarray(img_left, np.float32), np.asarray(img_right, np.float32)]
            )
            kl_d, kr_d, pyr_l, pyr_r = extract_orb_pair_stacked(
                torch.from_numpy(stacked).to(self.device), self.cfg
            )
            fields = hk.HostKeypoints._fields
            got = device_fetch(*[getattr(k, f) for k in (kl_d, kr_d) for f in fields],
                               pyr_l.raw, pyr_r.raw)
            self.stats.record_count("device_fetches", 1)
            n = len(fields)
            kl, kr = hk.HostKeypoints(*got[:n]), hk.HostKeypoints(*got[n:2 * n])
            raw_l, raw_r = got[2 * n:]
        else:
            kl, raw_l, _ = hk.host_extract_orb_with_pyramid(img_left, self.cfg)
            kr, raw_r, _ = hk.host_extract_orb_with_pyramid(img_right, self.cfg)

        if self.kcfg.stereo_match:
            kl_t, kr_t = (convert.keypoints_from_numpy(
                k.x, k.y, k.xl, k.yl, k.level, k.angle, k.score, k.desc_signed,
                k.desc_packed, k.valid, device=self.device) for k in (kl, kr))
            sm, _ = frame_pipeline._stereo_match_stage(
                kl_t, kr_t, self._upload(raw_l, np.float32), self._upload(raw_r, np.float32),
                self.cfg, self._bf_dev, self._minz_dev,
            )
            u_right, depth = device_fetch(sm.u_right, sm.depth)
            self.stats.record_count("device_fetches", 1)
        else:
            u_right, depth = hk.host_match_rectified(
                kl, kr, raw_l, raw_r, self._scale_factors, self.bf, self.baseline,
            )

        frame = TrackedFrame(
            frame_id=self.frame_id,
            timestamp=timestamp,
            kp_uv=np.stack([kl.x, kl.y], -1),
            kp_level=kl.level,
            kp_angle=kl.angle,
            desc_packed=kl.desc_packed,
            desc_signed=kl.desc_signed,
            u_right=u_right,
            depth=depth,
            valid=kl.valid,
        )
        self.stats.record("orb_extraction", (time.perf_counter() - t0) * 1e3)
        return self._track_prepared(frame, t0)

    def track_rgbd(self, img, depth_map, timestamp: float):
        """One image and its metric depth map (depth <= 0 or NaN: none), in
        ONE float32 host->device transfer of the two stacked. The image is
        taken as float32, not truncated to uint8, as the JAX package takes
        it here (unlike the stereo device route, ROADMAP F14). Always the
        stepwise path, as in the JAX package (ROADMAP F40), and no host
        route: the toggles of the front end are not read (F41)."""
        t0 = time.perf_counter()
        planes = torch.from_numpy(np.stack(
            [np.asarray(img, np.float32), np.asarray(depth_map, np.float32)]
        )).to(self.device)
        fd = process_rgbd_frame(planes[0], planes[1], self.cfg, self._bf_dev)
        return self._track_frame(fd, timestamp, t0)

    def track_monocular(self, img, timestamp: float):
        """One image: ONE uint8 host->device transfer (the cast to float32
        happens on the device), the fused path when it is eligible, else
        stepwise. No host route: the toggles of the front end are not read,
        as in the JAX package (ROADMAP F29)."""
        t0 = time.perf_counter()
        img_u8 = np.asarray(img, np.uint8)

        def dispatch_mono():
            return process_mono_frame(torch.from_numpy(img_u8).to(self.device), self.cfg)

        if self._fused_eligible():
            out = self._track_fused(dispatch_mono, timestamp, t0)
            if out is not NotImplemented:
                return out
        return self._track_frame(dispatch_mono(), timestamp, t0)

    # --------------------------------------------------------- inertial utils
    def grab_imu(self, samples):
        """Queue raw IMU samples (System::GrabImuData semantics). Each sample
        is (t, acc(3,), gyro(3,))."""
        for t, acc, gyro in samples:
            self.imu_queue.append(
                (float(t), np.asarray(acc, np.float64), np.asarray(gyro, np.float64))
            )

    def _preintegrate_imu(self, timestamp: float):
        """Tracking::PreintegrateIMU (Tracking.cc:1681): integrate queued
        samples up to ``timestamp`` into the running since-last-KF
        preintegration, and restart the frame-to-frame one.

        The running accumulation lives on the host (NumPy, microseconds for
        per-frame sample counts): the tracker reads it every frame for the
        IMU prediction and keyframe storage. The device optimizers get it as
        ONE packed upload (imu.preintegration.pack_preintegrated)."""
        if self._last_preint_ts == timestamp:
            return  # already integrated for this frame (fused-path fallback)
        self._last_preint_ts = timestamp
        take = [s for s in self.imu_queue if s[0] <= timestamp]
        self.imu_queue = [s for s in self.imu_queue if s[0] > timestamp]
        if self.pre_from_kf is None:
            self.pre_from_kf = HostPreintegrated(self.bias[0], self.bias[1])
        # frame-to-frame accumulation restarts every frame (feeds the
        # LastFrame-anchored VI pose optimization, Optimizer.cc:4875)
        self.pre_from_frame = HostPreintegrated(self.bias[0], self.bias[1])
        if not take:
            return
        t_prev = self.last_imu_time
        accs, gyrs, dts = [], [], []
        for t, acc, gyro in take:
            dt = (t - t_prev) if t_prev is not None else 1.0 / self.imu_calib.freq
            t_prev = t
            if dt <= 0:
                continue
            accs.append(acc)
            gyrs.append(gyro)
            dts.append(dt)
        if accs and t_prev < timestamp - 1e-9:
            # Close the interval exactly at the image timestamp with a
            # zero-order-hold partial step (Tracking.cc:1731-1772 tstep
            # split): without it the preintegration span differs from the
            # visual state spacing, and the gravity term of that mismatch
            # is a systematic error the VI optimizer dumps into the
            # accelerometer bias. The hold has no cap on its length, as in
            # the JAX package (ROADMAP F5): a gap of any length is bridged
            # with the last sample.
            accs.append(accs[-1])
            gyrs.append(gyrs[-1])
            dts.append(timestamp - t_prev)
            t_prev = timestamp
        self.last_imu_time = t_prev
        if not accs:
            return
        self.pre_from_kf.integrate(accs, gyrs, dts, self.imu_calib)
        self.pre_from_frame.integrate(accs, gyrs, dts, self.imu_calib)

    def _body_from_cam(self, R_cw, t_cw):
        """T_wb from T_cw (host). With X_b = R_bc X_c + t_bc (Calib.mTbc):
        R_wb = R_wc R_bc^T, p_w = C_w - R_wb t_bc, C_w = -R_wc t_cw."""
        R_wc = R_cw.T
        R_wb = R_wc @ self._R_bc.T
        return R_wb, -R_wc @ t_cw - R_wb @ self._t_bc

    def _cam_from_body(self, R_wb, p_w):
        R_cb = self._R_bc.T
        t_cb = -R_cb @ self._t_bc
        R_cw = R_cb @ R_wb.T
        return R_cw, t_cb - R_cw @ p_w

    def _predict_state_imu(self):
        """Tracking::PredictStateIMU (Tracking.cc:1795) on the host, from the
        last KF body state through the since-KF preintegration."""
        R1, p1, v1 = self.last_kf_state
        pre = self.pre_from_kf
        bg, ba = self.bias
        dbg = bg - pre.b0.bg
        dba = ba - pre.b0.ba
        dR = pre.dR @ _so3_exp(pre.JRg @ dbg)
        dV = pre.dV + pre.JVg @ dbg + pre.JVa @ dba
        dP = pre.dP + pre.JPg @ dbg + pre.JPa @ dba
        g = np.array([0.0, 0.0, -GRAVITY_VALUE])
        t = pre.dT
        R2 = R1 @ dR
        v2 = v1 + g * t + R1 @ dV
        p2 = p1 + v1 * t + 0.5 * g * t * t + R1 @ dP
        return R2, p2, v2

    def _imu_ready(self) -> bool:
        return (
            self.use_imu
            and self.atlas.current.imu_initialized
            and self.last_kf_state is not None
            and self.pre_from_kf is not None
            and not self.imu_anchor_stale
        )

    # -------------------------------------------------- fused one-sync path
    def _fused_eligible(self) -> bool:
        """The single-sync frame path (fused_track module) covers the normal
        case: OK state, the toggles of the local-map search, pose estimation
        and pose optimization on (the front end's two are on wherever this
        is asked, but on the fisheye route, which ignores them: ROADMAP
        F22), local-map candidates cached from the previous frame; visual frames need the constant-velocity
        model, inertial frames an initialized IMU with the frame-to-frame
        anchor ready (prior + last-frame velocity) and no map change since
        the last frame (after one the reference anchors on the last KEYFRAME,
        which the stepwise optimizer does: ROADMAP F8). Everything else
        (init, reloc, ablations) stays stepwise."""
        base = (
            self.state == TrackingState.OK
            and not self.localization_only
            and self._tlm_cand_ids is not None
            and len(self._tlm_cand_ids) > 0
            and self.kcfg.search_local_points and self.kcfg.pose_estimation
            and self.kcfg.pose_optimization
            and self.last_frame is not None
            and self.last_frame.R_cw is not None
            and int((self.last_frame.mp_ids >= 0).sum()) >= 10
        )
        if not base:
            return False
        if not self.use_imu:
            return self.velocity is not None
        return (
            self._imu_ready()
            and self._prior_H is not None
            and self.last_frame.v_w is not None
            and self.atlas.current.change_index == self._last_map_change
        )

    _TLM_CAP = 4096  # fixed candidate capacity (one shape for tlm_step)
    # Above this many inliers a monocular-inertial map's reference ratio is
    # 0.75 (Tracking::NeedNewKeyFrame for IMU_MONOCULAR, ROADMAP F38)
    MI_MANY_INLIERS = 350

    def _store_device(self, m):
        """Device-resident PointStore mirror (the reference's persistent
        CudaMapPoint arrays, CudaFrame.cu:77-181 / KernelController.cu:18-22):
        re-uploaded only when a mirrored column of the store changed, as its
        `version` says (a row taken or freed, a point added, erased,
        replaced or refreshed, BA write-back, the IMU-init rotation); between
        keyframes the fused path uploads row INDICES only. The JAX package
        keys its mirror on (map, change_index, n_rows, cap), which misses a
        freed row reused before the next keyframe (ROADMAP P3)."""
        st = m.store
        key = st.version
        if self._store_key != key:
            self._store_dev = convert.store_from_numpy(
                st.pos, st.desc_signed, st.normal, st.min_dist, st.max_dist,
                device=self.device,
            )
            self._store_key = key
            self.stats.record_count("store_uploads", 1)
        return self._store_dev

    def _pack_tlm_candidates(self, m):
        """Select the cached local-map candidate ids -> PointStore rows for
        tlm_step (the data itself lives in the device mirror; only the id
        SET is one frame stale)."""
        mp_ids = np.asarray(self._tlm_cand_ids, np.int64)
        rows_all = m.rows_for(mp_ids)
        sel = rows_all >= 0
        sel[np.cumsum(sel) > self._TLM_CAP] = False
        rows = rows_all[sel]
        st = m.store
        sel_desc = st.has_desc[rows]
        rows = rows[sel_desc]
        j = len(rows)
        if j == 0:
            return None
        P = self._TLM_CAP
        mids = np.full(P, -1, np.int64)
        rows_p = np.zeros(P, np.int32)
        okq = np.zeros(P, bool)
        mids[:j] = mp_ids[sel][sel_desc]
        rows_p[:j] = rows
        okq[:j] = True
        return mids, rows_p, okq, rows

    def _track_fused(self, dispatch_fd, timestamp: float, t0: float):
        """One-sync OK-state frame (fused_track module): host packs every
        query block from last-frame state + the motion prediction, dispatches
        the frame chain (``dispatch_fd``) -> TWM(match+opt) ->
        TLM(frustum+match+opt) -> pack asynchronously, then fetches ALL
        outputs in one copy. Falls back (returns NotImplemented) when
        preconditions break, and resumes the stepwise pipeline on TWM
        failure using the already fetched snapshot."""
        m = self.atlas.current
        with m.lock:
            last = self.last_frame
            dt = timestamp - last.timestamp
            if dt < 0 or (self.use_imu and dt > 3.0):
                return NotImplemented  # timestamp jumps take the stepwise path

            use_vi = self.use_imu
            if use_vi:
                # host preintegration (microseconds) + IMU prediction
                self._preintegrate_imu(timestamp)
                R_wb_pred, p_w_pred, v_pred = self._predict_state_imu()
                R_pred, t_pred = self._cam_from_body(R_wb_pred, p_w_pred)
            else:
                R_pred = self.velocity[0] @ last.R_cw
                t_pred = self.velocity[0] @ last.t_cw + self.velocity[1]

            # ---- TWM query block (host; all last-frame state)
            has_mp = last.mp_ids >= 0
            mids = last.mp_ids.copy()
            q_rows_raw = m.rows_for(mids)
            okq = (q_rows_raw >= 0) & has_mp
            okq[okq] &= m.store.has_desc[q_rows_raw[okq]]
            pos = np.zeros((len(mids), 3), np.float32)
            pos[okq] = m.store.pos[q_rows_raw[okq]]
            Xc = pos @ R_pred.T.astype(np.float32) + t_pred.astype(np.float32)
            uvp = project_np(self._cam_host, Xc)
            okq &= frustum_depth_ok(self._cam_host, Xc) & in_image_np(self._cam_host, uvp)
            radius = 7.0 * self._scale_factors[last.kp_level]
            lvl = last.kp_level
            q7 = np.stack([
                uvp[:, 0], uvp[:, 1], radius,
                np.maximum(lvl - 1, 0), np.minimum(lvl + 1, self.cfg.n_levels - 1),
                okq.astype(np.float64), last.kp_angle,
            ]).astype(np.float32)
            # dead rows never index the device store
            q_rows = np.where(okq, q_rows_raw, 0).astype(np.int32)

            cand = self._pack_tlm_candidates(m)
            if cand is None:
                return NotImplemented
            c_mids, c_rows_p, c_ok, c_rows = cand

            # ---- dispatch the full chain (async; no host syncs)
            t_dispatch = time.perf_counter()
            store_dev = self._store_device(m)
            fd = dispatch_fd()
            T0 = convert.se3_from_numpy(R_pred, t_pred, device=self.device)
            qb = convert.query_block_from_numpy(q7, q_rows, c_rows_p, c_ok, device=self.device)
            twm = twm_step(
                fd.kps, fd.u_right, self.cfg, self._bf_dev, self.camera, T0,
                qb.q7, qb.q_rows, store_dev.pos, store_dev.desc,
            )
            if use_vi:
                R1, p1 = self._body_from_cam(last.R_cw, last.t_cw)
                vi_buf = vi_buffer(
                    R1, p1, last.v_w, self.bias[0], self.bias[1], self._prior_H,
                    pack_preintegrated(self.pre_from_frame), v_pred, C=self.pre_from_frame.C,
                )
                tlm = tlm_step_vi(
                    fd.kps, fd.u_right, self.cfg, self._bf_dev, self.camera,
                    twm, qb.cand_rows, qb.cand_ok, *store_dev,
                    self._Rbc_dev, self._tbc_dev, self._upload(vi_buf, np.float32),
                )
                buf_d = pack_fused_vi_for_host(fd, twm, tlm)
            else:
                tlm = tlm_step(
                    fd.kps, fd.u_right, self.cfg, self._bf_dev, self.camera,
                    twm, qb.cand_rows, qb.cand_ok, *store_dev,
                )
                buf_d = pack_fused_for_host(fd, twm, tlm)
            t_sync = time.perf_counter()
            buf = device_fetch(buf_d)
            t_fetched = time.perf_counter()
            self.stats.record("fused_host_pre", (t_dispatch - t0) * 1e3)
            self.stats.record("fused_dispatch", (t_sync - t_dispatch) * 1e3)
            self.stats.record("sync_ms", (t_fetched - t_sync) * 1e3)
            self.stats.record_count("device_fetches", 1)
            N = int(fd.kps.x.shape[0])
            if use_vi:
                self.stats.record_count("fused_vi_frames", 1)
                (f32, packed, idxA, keepA, idxB, keepB, in_frustum,
                 tail, H_vi) = unpack_fused_vi(buf, N, len(mids), self._TLM_CAP)
            else:
                (f32, packed, idxA, keepA, idxB, keepB, in_frustum,
                 tail) = unpack_fused(buf, N, len(mids), self._TLM_CAP)

            # ---- host bookkeeping
            frame = _frame_from_block(self.frame_id, timestamp, f32, packed)
            self._frame_in_flight = frame
            inlB_kp = f32[8] > 0.5
            n_inlA = int(tail[21] if use_vi else tail[12])
            n_inlB = int(tail[22] if use_vi else tail[13])

            if n_inlA < 10:
                # TWM failed: resume the stepwise pipeline with the snapshot
                # we already paid for (reference-KF matching, reloc, ...)
                self._fd_dev = fd
                self.stats.record("orb_extraction", (time.perf_counter() - t0) * 1e3)
                out = self._track_prepared(frame, t0)
                self._fd_dev = None
                return out

            # TWM bindings, then TLM bindings (first-binding-wins for a mid
            # bound by both: the device taken-mask already prevents
            # keypoint-level duplicates)
            frame.mp_ids[:] = -1
            frame.mp_ids[idxA[keepA]] = mids[keepA]
            twm_bound = mids[keepA]
            selB = keepB & ~np.isin(c_mids, twm_bound) & (c_mids >= 0)
            frame.mp_ids[idxB[selB]] = c_mids[selB]
            # final pose-opt outlier unbind (Tracking.cc:2996-3038)
            frame.mp_ids[~inlB_kp & (frame.mp_ids >= 0)] = -1
            self.n_inliers = n_inlB
            if use_vi:
                R_wb = _orthonormalize(tail[:9].reshape(3, 3).astype(np.float64))
                p_w = tail[9:12].astype(np.float64)
                frame.R_cw, frame.t_cw = self._cam_from_body(R_wb, p_w)
                frame.v_w = tail[12:15].astype(np.float64)
                frame.bg = tail[15:18].astype(np.float64)
                frame.ba = tail[18:21].astype(np.float64)
                self.v_w = frame.v_w
                self.bias = (frame.bg, frame.ba)
                self._prior_H = H_vi.astype(np.float64)
                self._last_map_change = m.change_index
            else:
                frame.R_cw = _orthonormalize(tail[:9].reshape(3, 3).astype(np.float64))
                frame.t_cw = tail[9:12].astype(np.float64)
            ok = self.n_inliers >= 20

            # MapPoint::IncreaseVisible for frustum hits
            m.store.n_visible[c_rows[in_frustum[:len(c_rows)]]] += 1
            # refresh reference KF + next frame's candidate set
            if ok:
                _, mp_ids_next = self._local_map_ids(frame)
                self._tlm_cand_ids = mp_ids_next
            self._post_track(frame, ok)
            self.stats.record("fused_host_post", (time.perf_counter() - t_fetched) * 1e3)

        self._finish_frame(frame)
        self.stats.record("tracking_total", (time.perf_counter() - t0) * 1e3)
        return (frame.R_cw, frame.t_cw) if frame.R_cw is not None else None

    def _track_frame(self, fd, timestamp: float, t0: float):
        frame = self._snapshot(fd, timestamp)
        # keep the device-resident keypoint arrays for this frame's matcher
        # calls (zero re-upload of the frame side; persistent residency,
        # KernelController.cu:100-117)
        self._fd_dev = fd
        self.stats.record("orb_extraction", (time.perf_counter() - t0) * 1e3)
        out = self._track_prepared(frame, t0)
        self._fd_dev = None
        return out

    def _track_prepared(self, frame: TrackedFrame, t0: float):
        timestamp = frame.timestamp
        self._frame_in_flight = frame
        # Timestamp-jump handling (Tracking.cc:1885-1912): a backwards jump
        # resets the active map; with an IMU a large forward gap starts a
        # fresh map in the Atlas (the integration across the gap is
        # meaningless).
        if self.last_frame is not None and self.state not in (
            TrackingState.NO_IMAGES_YET, TrackingState.NOT_INITIALIZED
        ):
            dt = timestamp - self.last_frame.timestamp
            if dt < 0:
                self.stats.record_count("timestamp_jump_backwards", 1)
                self._reset_active_map()
            elif self.use_imu and dt > 3.0:
                self.stats.record_count("timestamp_jump_forward", 1)
                self._handle_lost()
        if self.use_imu:
            self._preintegrate_imu(timestamp)

        if self.state in (TrackingState.NO_IMAGES_YET, TrackingState.NOT_INITIALIZED):
            if self.monocular:
                self._monocular_initialization(frame)
            else:
                self._stereo_initialization(frame)
        else:
            self._track(frame)

        self._finish_frame(frame)
        self.stats.record("tracking_total", (time.perf_counter() - t0) * 1e3)
        return (frame.R_cw, frame.t_cw) if frame.R_cw is not None else None

    # ------------------------------------------------- stereo initialization
    def _new_stereo_point(self, frame: TrackedFrame, kf: KeyFrame, i: int, Xw, m):
        """A map point from stereo keypoint `i` of `frame`, first seen by
        `kf` (the keyframe made from that frame), bound to both."""
        mp = MapPoint(self.atlas.next_mp_id(), Xw, kf.kid, kf.kid)
        mp.add_observation(kf.kid, i)
        mp.desc_packed = frame.desc_packed[i]
        mp.desc_signed = frame.desc_signed[i]
        mp.update_normal_and_depth(
            {kf.kid: kf.center}, kf.center, int(frame.kp_level[i]),
            self.cfg.scale_factor, self.cfg.n_levels,
        )
        kf.mp_ids[i] = mp.mid
        frame.mp_ids[i] = mp.mid
        m.add_mappoint(mp)

    def _stereo_initialization(self, frame: TrackedFrame):
        """Tracking::StereoInitialization (Tracking.cc:2392): needs enough
        stereo-depth features; creates the first KF + map points."""
        good = frame.valid & (frame.depth > 0)
        if good.sum() < 100:
            self.state = TrackingState.NOT_INITIALIZED
            return
        frame.R_cw = np.eye(3)
        frame.t_cw = np.zeros(3)
        kf = self._make_keyframe(frame)
        m = self.atlas.current
        m.add_keyframe(kf)
        idx = np.where(good)[0]
        Xw = self._unproject(frame, idx)
        for i, x in zip(idx, Xw):
            self._new_stereo_point(frame, kf, int(i), x, m)
        m.update_connections(kf)
        self.ref_kf_id = kf.kid
        self.last_kf_frame_id = self.frame_id
        if self.local_mapper is not None:
            self.local_mapper.insert_keyframe(kf)
        self.state = TrackingState.OK

    # --------------------------------------------- monocular initialization
    def _monocular_initialization(self, frame: TrackedFrame):
        """Tracking::MonocularInitialization (Tracking.cc:2505) +
        CreateInitialMapMonocular (:2583): two-view reconstruction between a
        reference frame and the current frame; map scaled to median depth 1."""
        n_min = 100
        if self._init_reference is None or frame.valid.sum() < n_min:
            self._init_reference = frame if frame.valid.sum() >= n_min else None
            self._restart_init_preintegration()
            self.state = TrackingState.NOT_INITIALIZED
            return
        ref = self._init_reference
        # SearchForInitialization (ORBmatcher.cc:747): level-0 features,
        # window radius 100, ratio 0.9; the reference frame's keypoints are
        # the queries (uploaded), the current frame's stay on the device.
        M = len(ref.kp_uv)
        x, y, desc, level, valid, _ = self._frame_device_arrays(frame)
        zeros = torch.zeros(M, dtype=torch.int32, device=self.device)
        res = search_by_projection(
            self._upload(ref.kp_uv[:, 0], np.float32), self._upload(ref.kp_uv[:, 1], np.float32),
            self._upload(ref.desc_signed, np.int8),
            torch.full((M,), 100.0, device=self.device), zeros, zeros,
            self._upload(ref.valid & (ref.kp_level == 0), np.bool_),
            x, y, desc, level, valid & (level == 0),
            ratio=0.9,
        )
        ok, idx = device_fetch(res.ok, res.idx)
        self.stats.record_count("device_fetches", 1)
        if ok.sum() < n_min:
            self._init_reference = frame  # slide the reference forward
            self._restart_init_preintegration()
            return
        i1 = np.where(ok)[0]
        i2 = idx[i1]
        p = self._cam_host.params
        K = np.array([[p[0], 0, p[2]], [0, p[1], p[3]], [0, 0, 1.0]])
        t_tv = time.perf_counter()
        tv = reconstruct_two_view(
            ref.kp_uv[i1].astype(np.float32), frame.kp_uv[i2].astype(np.float32), K,
            device=self.device,
        )
        self.stats.record("mono_two_view", (time.perf_counter() - t_tv) * 1e3)
        if not tv.success:
            return
        # Scale: median depth -> 1 (CreateInitialMapMonocular).
        good = tv.good_mask
        med_z = float(np.median(tv.points3d[good, 2]))
        if med_z <= 0:
            return
        scale = 1.0 / med_z
        X = tv.points3d * scale

        ref.R_cw = np.eye(3)
        ref.t_cw = np.zeros(3)
        frame.R_cw = tv.R
        frame.t_cw = tv.t * scale
        m = self.atlas.current
        pre_ref_to_cur = self.pre_from_kf
        kf1 = self._make_keyframe(ref)
        m.add_keyframe(kf1)
        if self.use_imu:
            # the initial keyframe starts the chain: no preintegration, and
            # the current one takes the reference-to-current preintegration
            # (CreateInitialMapMonocular, Tracking.cc:2583; ROADMAP F33: the
            # JAX package hands it the empty one that kf1's creation left)
            kf1.prev_kf_id = None
            kf1.preintegrated = None
            self.pre_from_kf = pre_ref_to_cur
        kf2 = self._make_keyframe(frame)
        m.add_keyframe(kf2)
        for k in np.where(good)[0]:
            a, b = int(i1[k]), int(i2[k])
            mp = MapPoint(self.atlas.next_mp_id(), X[k], kf2.kid, kf1.kid)
            mp.add_observation(kf1.kid, a)
            mp.add_observation(kf2.kid, b)
            mp.desc_packed = frame.desc_packed[b]
            mp.desc_signed = frame.desc_signed[b]
            mp.update_normal_and_depth(
                {kf1.kid: kf1.center, kf2.kid: kf2.center}, kf2.center,
                int(frame.kp_level[b]), self.cfg.scale_factor, self.cfg.n_levels,
            )
            kf1.mp_ids[a] = mp.mid
            kf2.mp_ids[b] = mp.mid
            frame.mp_ids[b] = mp.mid
            m.add_mappoint(mp)
        m.update_connections(kf1)
        m.update_connections(kf2)
        self.ref_kf_id = kf2.kid
        self.last_kf_frame_id = self.frame_id
        if self.local_mapper is not None:
            self.local_mapper.insert_keyframe(kf1)
            self.local_mapper.insert_keyframe(kf2)
        self._init_reference = None
        self.state = TrackingState.OK

    def transform_trajectory(self, R_gw, scale: float, since: float):
        """Put the frames tracked since `since` into the world the map was
        just moved to (world' = scale * R_gw * world): the saved ones, the
        frame in flight (an inline mapper rescales inside its keyframe
        insertion, before the frame is saved) and the last frame, as
        ORB-SLAM3's Tracking::UpdateFrameIMU moves mCurrentFrame and
        mLastFrame. The JAX package leaves the saved trajectory of a
        monocular-inertial map in the visual world up to its IMU init
        (ROADMAP F37). The caller holds the map lock."""
        for i, (ts, R_cw, t_cw) in enumerate(self.trajectory):
            if ts >= since:
                self.trajectory[i] = (ts, R_cw @ R_gw.T, scale * t_cw)
        frames = {id(f): f for f in (self._frame_in_flight, self.last_frame) if f is not None}
        for f in frames.values():
            if f.R_cw is not None and f.timestamp >= since:
                f.R_cw, f.t_cw = f.R_cw @ R_gw.T, scale * f.t_cw

    def _finish_frame(self, frame: TrackedFrame):
        """Save the frame's pose and make it the last frame under the map
        lock, so that an asynchronous mapper's rescale moves the frame
        either as the frame in flight or as a saved one, never between."""
        with self.atlas.current.lock:
            self.frame_id += 1
            self.last_frame = frame
            self._frame_in_flight = None
            if frame.R_cw is not None:
                self.trajectory.append((frame.timestamp, frame.R_cw.copy(), frame.t_cw.copy()))

    def _restart_init_preintegration(self):
        """The since-keyframe preintegration restarts whenever the monocular
        initializer sets or slides its reference frame, so that it spans the
        reference to the current frame (Tracking::MonocularInitialization)."""
        if self.use_imu:
            self.pre_from_kf = HostPreintegrated(self.bias[0], self.bias[1])

    def _make_keyframe(self, frame: TrackedFrame) -> KeyFrame:
        kf = KeyFrame(
            self.atlas.next_kf_id(), frame.frame_id, frame.timestamp,
            frame.R_cw, frame.t_cw, frame.kp_uv, frame.kp_level, frame.kp_angle,
            frame.desc_packed, frame.desc_signed, frame.u_right, frame.depth,
            frame.valid,
        )
        if self.use_imu:
            self._finalize_keyframe_inertial(kf, frame)
        return kf

    def _finalize_keyframe_inertial(self, kf: KeyFrame, frame: TrackedFrame):
        """Attach the inertial state + since-last-KF preintegration to a new
        keyframe and restart the accumulation (Tracking::CreateNewKeyFrame
        inertial bookkeeping, Tracking.cc:3345)."""
        prev_id = self.last_kf_id
        kf.velocity = np.asarray(
            frame.v_w if frame.v_w is not None else self.v_w, np.float64
        )
        kf.imu_bias = (self.bias[0].copy(), self.bias[1].copy())
        kf.prev_kf_id = prev_id
        # after an atlas load the accumulation does not span from the
        # previous keyframe: no inertial edge to it (ROADMAP F45)
        if prev_id is not None and self.pre_from_kf is not None and not self.imu_anchor_stale:
            kf.preintegrated = self.pre_from_kf.copy()
        self.imu_anchor_stale = False
        if prev_id is not None:
            prev = self.atlas.current.keyframes.get(prev_id)
            if prev is not None:
                prev.next_kf_id = kf.kid
        self.last_kf_id = kf.kid
        R_wb, p_w = self._body_from_cam(kf.R_cw, kf.t_cw)
        self.last_kf_state = (R_wb, p_w, np.asarray(kf.velocity, np.float64))
        # restart the since-KF accumulation at the current bias estimate
        self.pre_from_kf = HostPreintegrated(self.bias[0], self.bias[1])

    # ------------------------------------------------------------- tracking
    def _track(self, frame: TrackedFrame):
        m = self.atlas.current
        with m.lock:
            ok = False
            if self.state == TrackingState.OK:
                if self.velocity is not None or self._imu_ready():
                    t0 = time.perf_counter()
                    ok = self._track_with_motion_model(frame)
                    self.stats.record("twm", (time.perf_counter() - t0) * 1e3)
                if not ok:
                    t0 = time.perf_counter()
                    ok = self._track_reference_keyframe(frame)
                    self.stats.record("trk", (time.perf_counter() - t0) * 1e3)
            elif self.state == TrackingState.RECENTLY_LOST:
                if self._imu_ready():
                    # Inertial dead-reckoning (Tracking.cc:2038-2069): keep
                    # publishing the IMU-predicted pose and keep trying to
                    # re-acquire the map visually.
                    R_wb, p_w, v_w = self._predict_state_imu()
                    frame.R_cw, frame.t_cw = self._cam_from_body(R_wb, p_w)
                    frame.v_w = v_w
                    ok = self._track_with_motion_model(frame)
                    if not ok:
                        ok = self._track_reference_keyframe(frame)
                    if not ok:
                        # Pure dead-reckoning frame: the predicted pose
                        # stands (set above), tracking stays RECENTLY_LOST,
                        # the trajectory stays continuous.
                        self.stats.record_count("dead_reckoning_frames", 1)
                        self.v_w = v_w
                else:
                    ok = self._track_reference_keyframe(frame)
                    if not ok:
                        ok = self._relocalization(frame)

            if ok:
                t0 = time.perf_counter()
                ok = self._track_local_map(frame)
                self.stats.record("tlm", (time.perf_counter() - t0) * 1e3)

            self._post_track(frame, ok)

    def _post_track(self, frame: TrackedFrame, ok: bool):
        """Shared frame postlude (assumes the map lock is held): state
        machine transition, velocity model, found counters, keyframe
        decision (Tracking.cc:2038-2389 tail of Track())."""
        if ok:
            self.state = TrackingState.OK
            self.lost_since = None
            re_anchor = (self.imu_anchor_stale and self.last_frame is not None
                         and self.last_frame.R_cw is not None
                         and frame.timestamp > self.last_frame.timestamp)
            if re_anchor:
                # the second tracked frame after an atlas load: the body
                # velocity from the two poses, and a keyframe of this run
                # to anchor the IMU on (ROADMAP F45)
                _, p0 = self._body_from_cam(self.last_frame.R_cw, self.last_frame.t_cw)
                _, p1 = self._body_from_cam(frame.R_cw, frame.t_cw)
                self.v_w = (p1 - p0) / (frame.timestamp - self.last_frame.timestamp)
            # velocity = Tcw_cur * Twc_last
            if self.last_frame is not None and self.last_frame.R_cw is not None:
                R_wl, t_wl = self.last_frame.pose_wc()
                self.velocity = (
                    _orthonormalize(frame.R_cw @ R_wl),
                    frame.R_cw @ t_wl + frame.t_cw,
                )
            self._update_found_counters(frame)
            # Localization-only mode (System::ActivateLocalizationMode):
            # track against the frozen map, never insert keyframes.
            if not self.localization_only and (re_anchor or self._need_new_keyframe(frame)):
                self._create_new_keyframe(frame)
        else:
            if self.state == TrackingState.OK:
                self.state = TrackingState.RECENTLY_LOST
                self.lost_since = frame.timestamp
            elif (
                self.state == TrackingState.RECENTLY_LOST
                and self.lost_since is not None
                and frame.timestamp - self.lost_since > self.time_recently_lost
            ):
                self.state = TrackingState.LOST
                self._handle_lost()
            self.velocity = None
            self._prior_H = None
            self._tlm_cand_ids = None
            # keep last pose as estimate (unless IMU dead-reckoning
            # already produced a prediction for this frame). Right after an
            # atlas load there is no last frame: the frame keeps no pose,
            # where the JAX tracker raises AttributeError (ROADMAP F44).
            if (frame.R_cw is None and self.last_frame is not None
                    and self.last_frame.R_cw is not None):
                frame.R_cw = self.last_frame.R_cw.copy()
                frame.t_cw = self.last_frame.t_cw.copy()
        self.stats.record_count("track_ok", int(ok))

    def _reset_active_map(self):
        """Tracking::ResetActiveMap: wipe the current map and reinitialize
        (used for backwards timestamp jumps and the bad-IMU reset)."""
        m = self.atlas.current
        m.clear()
        m.imu_initialized = False
        self.state = TrackingState.NOT_INITIALIZED
        self.ref_kf_id = None
        self.velocity = None
        self.last_kf_state = None
        self.pre_from_kf = None
        self._prior_H = None
        self._init_reference = None

    def _handle_lost(self):
        """Tracking.cc:2071-2089: abandon small maps, else start a fresh map
        in the Atlas (to be merged back by loop closing). Bad-IMU guard
        (Tracking.cc:1862-1867 / LocalMapping.cc:138-146): losing track
        before the IMU initialized means the visual-inertial state is
        untrustworthy, so the active map is reset instead of kept."""
        m = self.atlas.current
        if self.use_imu and not m.imu_initialized:
            self.stats.record_count("bad_imu_reset", 1)
            self._reset_active_map()
            return
        if m.n_keyframes() <= 10:
            m.clear()
        self.atlas.create_new_map()
        self.state = TrackingState.NOT_INITIALIZED
        self.ref_kf_id = None
        self.velocity = None

    # ------------------------------------------- device matching sub-routines
    def _gather_map_points(self, mids: np.ndarray, m):
        """Return (positions, signed descs, valid) padded arrays for ids:
        one vectorized pass over the map's packed PointStore (no per-point
        Python; the packed arrays ARE the map, slam_map.map.PointStore)."""
        rows = m.rows_for(mids)
        sel = rows >= 0
        r = rows[sel]
        pos = np.zeros((len(mids), 3), np.float32)
        desc = np.zeros((len(mids), 256), np.int8)
        ok = np.zeros(len(mids), bool)
        pos[sel] = m.store.pos[r]
        desc[sel] = m.store.desc_signed[r]
        ok[sel] = m.store.has_desc[r]
        return pos, desc, ok

    def _packed_for(self, mids: np.ndarray, m, okq: np.ndarray) -> np.ndarray:
        """Packed uint8 descriptors for map-point ids (host matcher input)."""
        rows = m.rows_for(mids)
        sel = (rows >= 0) & okq
        packed = np.zeros((len(mids), 32), np.uint8)
        packed[sel] = m.store.desc_packed[rows[sel]]
        return packed

    def _track_with_motion_model(self, frame: TrackedFrame) -> bool:
        """Tracking.cc:2911 + the PoseEstimationKernel device search.
        With an initialized IMU the prediction comes from PredictStateIMU
        (Tracking.cc:2924-2933) instead of the constant-velocity model."""
        m = self.atlas.current
        last = self.last_frame
        if last is None:
            return False
        if self._imu_ready():
            R_wb, p_w, v_w = self._predict_state_imu()
            R_pred, t_pred = self._cam_from_body(R_wb, p_w)
            frame.v_w = v_w
        elif self.velocity is not None:
            R_pred = self.velocity[0] @ last.R_cw
            t_pred = self.velocity[0] @ last.t_cw + self.velocity[1]
        else:
            return False

        has_mp = last.mp_ids >= 0
        if has_mp.sum() < 10:
            return False
        mids = last.mp_ids.copy()
        pos, desc, okq = self._gather_map_points(mids, m)
        okq &= has_mp

        # Project with predicted pose (host: cheap; device does matching).
        Xc = pos @ R_pred.T.astype(np.float32) + t_pred.astype(np.float32)
        uvp = project_np(self._cam_host, Xc)
        u, v = uvp[:, 0], uvp[:, 1]
        okq &= frustum_depth_ok(self._cam_host, Xc) & in_image_np(self._cam_host, uvp)
        th = 7.0  # stereo radius (ORBmatcher th=7 for stereo/RGBD)
        radius = th * self._scale_factors[last.kp_level]
        lvl = last.kp_level
        lmin = np.maximum(lvl - 1, 0).astype(np.int32)
        lmax = np.minimum(lvl + 1, self.cfg.n_levels - 1).astype(np.int32)
        if self.kcfg.pose_estimation:
            kx, ky, kd, klvl, kvalid, kang = self._frame_device_arrays(frame)
            desc_d = self._upload(desc, np.int8)
        else:
            packed = self._packed_for(mids, m, okq)
        for widen in (1.0, 2.0):  # retry with doubled window (Tracking.cc:2964)
            if self.kcfg.pose_estimation:
                # per-kernel phase stats (the reference's REGISTER_STATS
                # wrap/H2D/exec/D2H split, StereoMatchKernel.cu:636-706)
                t_w = time.perf_counter()
                q7 = np.stack([
                    u, v, radius * widen, lmin, lmax,
                    okq.astype(np.float64), last.kp_angle,
                ]).astype(np.float32)
                t_h = time.perf_counter()
                q7_d = self._upload(q7, np.float32)
                t_x = time.perf_counter()
                idx, keep = twm_match_packed(q7_d, desc_d, kx, ky, kd, klvl, kvalid, kang)
                t_d = time.perf_counter()
                idx_np, keep_np = device_fetch(idx, keep)
                t_e = time.perf_counter()
                self.stats.record("twm_wrap", (t_h - t_w) * 1e3)
                self.stats.record("twm_h2d", (t_x - t_h) * 1e3)
                self.stats.record("twm_exec", (t_d - t_x) * 1e3)
                self.stats.record("twm_d2h", (t_e - t_d) * 1e3)
                self.stats.record("sync_ms", (t_e - t_d) * 1e3)
                self.stats.record_count("device_fetches", 1)
            else:
                # host path (ORBmatcher.cc:1992 CPU branch of the
                # poseEstimation toggle)
                idx_np, keep_np = hk.host_twm_match(
                    np.stack([u, v], -1).astype(np.float32), packed,
                    (radius * widen).astype(np.float32), lmin, lmax, okq,
                    frame.kp_uv.astype(np.float32), frame.desc_packed,
                    frame.kp_level.astype(np.int32), frame.valid,
                    last.kp_angle, frame.kp_angle,
                )
            n = int(keep_np.sum())
            if n >= 20:
                break
        if n < 20:
            return False

        frame.mp_ids[:] = -1
        frame.mp_ids[idx_np[keep_np]] = mids[keep_np]
        return self._optimize_frame_pose(frame, R_pred, t_pred, min_inliers=10)

    def _track_reference_keyframe(self, frame: TrackedFrame) -> bool:
        """Tracking.cc:2777: descriptor match to the reference KF (the
        reference uses BoW-accelerated matching; the dense tensor-core
        Hamming needs no acceleration structure) + pose optimization."""
        m = self.atlas.current
        kf = m.keyframes.get(self.ref_kf_id) if self.ref_kf_id is not None else None
        if kf is None:
            return False
        has_mp = kf.mp_ids >= 0
        if has_mp.sum() < 15:
            return False
        _, desc, okq = self._gather_map_points(kf.mp_ids, m)
        okq &= has_mp
        # Brute-force ratio matching (SearchByBoW semantics, ratio 0.7).
        _, _, kd, _, kvalid, _ = self._frame_device_arrays(frame)
        res = match_fisheye(
            self._upload(desc, np.int8), self._upload(okq, np.bool_), kd, kvalid,
            ratio=0.7, max_dist=TH_HIGH,
        )
        idx_right, keep = device_fetch(res.idx_right, res.valid)
        self.stats.record_count("device_fetches", 1)
        if keep.sum() < 15:
            return False
        frame.mp_ids[:] = -1
        # no dedup on this path: where two map points chose one keypoint,
        # the last write wins
        frame.mp_ids[idx_right[keep]] = kf.mp_ids[keep]
        lf = self.last_frame
        R0 = lf.R_cw if (lf is not None and lf.R_cw is not None) else kf.R_cw
        t0 = lf.t_cw if (lf is not None and lf.t_cw is not None) else kf.t_cw
        return self._optimize_frame_pose(frame, R0, t0, min_inliers=10)

    def _optimize_frame_pose(self, frame, R0, t0, min_inliers=10) -> bool:
        m = self.atlas.current
        bound = np.where(frame.mp_ids >= 0)[0]
        if len(bound) < min_inliers:
            return False
        N = len(frame.mp_ids)
        Xw = np.zeros((N, 3), np.float32)
        ok = np.zeros(N, bool)
        rows = m.rows_for(frame.mp_ids[bound])
        live = rows >= 0
        Xw[bound[live]] = m.store.pos[rows[live]]
        ok[bound[live]] = True
        if self._imu_ready():
            return self._optimize_frame_pose_inertial(frame, R0, t0, Xw, ok, min_inliers)
        obs_uv, obs_ur = self._frame_observations(frame)
        res = pose_optimize(
            self.camera,
            self._bf_dev,
            convert.se3_from_numpy(R0, t0, device=self.device),
            self._upload(Xw, np.float32),
            obs_uv,
            obs_ur,
            self._upload(self._inv_sigma2[frame.kp_level], np.float32),
            self._upload(ok, np.bool_),
        )
        t_sync = time.perf_counter()
        inl, n_inl, R_new, t_new = device_fetch(
            res.inliers, res.n_inliers, res.pose.R, res.pose.t
        )
        self.stats.record("sync_ms", (time.perf_counter() - t_sync) * 1e3)
        self.stats.record_count("device_fetches", 1)
        self.n_inliers = int(n_inl)
        # unbind outliers (Tracking.cc:2996-3038)
        frame.mp_ids[~inl] = -1
        if self.n_inliers < min_inliers:
            return False
        frame.R_cw = _orthonormalize(R_new.astype(np.float64))
        frame.t_cw = t_new.astype(np.float64)
        return True

    def _frame_observations(self, frame: TrackedFrame):
        """(obs_uv, obs_ur) of `frame` on the device: the live FrameData's
        tensors for the current frame, else an upload of the snapshot."""
        fd = self._fd_dev
        if fd is not None and frame.frame_id == self.frame_id:
            return torch.stack([fd.kps.x, fd.kps.y], dim=-1), fd.u_right
        return self._upload(frame.kp_uv, np.float32), self._upload(frame.u_right, np.float32)

    def _optimize_frame_pose_inertial(self, frame, R0, t0, Xw, ok, min_inliers) -> bool:
        """Motion-only VI optimization. Anchor selection mirrors the
        reference (Tracking.cc:3080-3106): when the map changed since the
        previous frame, anchor on the last KEYFRAME
        (Optimizer::PoseInertialOptimizationLastKeyFrame, Optimizer.cc:4491,
        fixed anchor); otherwise anchor on the last FRAME with the
        frame-to-frame preintegration and the ConstraintPoseImu soft prior
        carried from that frame's own solve
        (PoseInertialOptimizationLastFrame, Optimizer.cc:4875). The states,
        the preintegration and its whitening factors (and the prior with
        its square root) go up as one buffer."""
        m_now = self.atlas.current
        lf = self.last_frame
        map_updated = m_now.change_index != self._last_map_change
        self._last_map_change = m_now.change_index
        use_frame_anchor = (
            not map_updated
            and lf is not None and lf.R_cw is not None and lf.v_w is not None
            and self.pre_from_frame is not None
        )
        kf_bg, kf_ba = self.bias
        if use_frame_anchor:
            R1, p1 = self._body_from_cam(lf.R_cw, lf.t_cw)
            v1 = lf.v_w
            pre_anchor = self.pre_from_frame
        else:
            R1, p1, v1 = self.last_kf_state
            pre_anchor = self.pre_from_kf
        R_wb0, p_w0 = self._body_from_cam(
            np.asarray(R0, np.float64), np.asarray(t0, np.float64)
        )
        v0 = frame.v_w if frame.v_w is not None else self.v_w
        lastframe = use_frame_anchor and self._prior_H is not None
        parts = [np.asarray(R1, np.float64).ravel(), p1, v1, kf_bg, kf_ba,
                 np.asarray(R_wb0, np.float64).ravel(), p_w0, v0, kf_bg, kf_ba,
                 pack_preintegrated(pre_anchor), whitening_np(pre_anchor.C)]
        if lastframe:
            parts += [self._prior_H.ravel(), sqrtm_psd_np(self._prior_H).ravel()]
        buf = self._upload(np.concatenate(parts), np.float32)

        def state(o):
            return BodyState(buf[o:o + 9].reshape(3, 3), buf[o + 9:o + 12],
                             buf[o + 12:o + 15], buf[o + 15:o + 18], buf[o + 18:o + 21])

        o_pre = 42 + PRE_PACKED_SIZE
        o_w = o_pre + WHITEN_SIZE
        obs_uv, obs_ur = self._frame_observations(frame)
        common = (
            self._upload(Xw, np.float32), obs_uv, obs_ur,
            self._upload(self._inv_sigma2[frame.kp_level], np.float32),
            self._upload(ok, np.bool_),
        )
        if lastframe:
            res = pose_inertial_optimize_lastframe_packed(
                self.camera, self._bf_dev, self._Rbc_dev, self._tbc_dev,
                state(0), buf[o_w:o_w + 225].reshape(15, 15), buf[42:o_pre], state(21),
                *common, whiten=buf[o_pre:o_w], W_prior=buf[o_w + 225:].reshape(15, 15),
            )
        else:
            res = pose_inertial_optimize_packed(
                self.camera, self._bf_dev, self._Rbc_dev, self._tbc_dev,
                state(0), buf[42:o_pre], state(21), *common, whiten=buf[o_pre:o_w],
            )
        st = res.state
        t_sync = time.perf_counter()
        inl, n_inl, H, R_wb, p_w, v_w, bg, ba = device_fetch(
            res.inliers, res.n_inliers, res.H, *st)
        self.stats.record("sync_ms", (time.perf_counter() - t_sync) * 1e3)
        self.stats.record_count("device_fetches", 1)
        self.stats.record_count("vi_pose_lastframe" if lastframe else "vi_pose_anchor", 1)
        self.n_inliers = int(n_inl)
        frame.mp_ids[~inl] = -1
        if self.n_inliers < max(min_inliers, 1):
            self._prior_H = None
            return False
        self._prior_H = H.astype(np.float64)
        R_wb = _orthonormalize(R_wb.astype(np.float64))
        frame.R_cw, frame.t_cw = self._cam_from_body(R_wb, p_w.astype(np.float64))
        frame.v_w = v_w.astype(np.float64)
        frame.bg = bg.astype(np.float64)
        frame.ba = ba.astype(np.float64)
        self.v_w = frame.v_w
        self.bias = (frame.bg, frame.ba)
        return True

    # -------------------------------------------------------- relocalization
    def _relocalization(self, frame: TrackedFrame) -> bool:
        """Tracking::Relocalization (Tracking.cc:3798): BoW candidate
        keyframes -> descriptor matching (one launch of the top-K kernel at
        K = 2 per candidate) -> RANSAC PnP on the host -> pose optimization
        on the device -> the widening-window rebind. Requires a
        place-recognition database (self.reloc_db, shared with loop
        closing); without one there is nothing to relocalize against.
        Records `reloc_candidates` per attempt and, per candidate that
        passes PnP, `reloc_pnp_inliers` and the inliers after the rebind,
        `reloc_inliers`."""
        if self.reloc_db is None or self.vocabulary is None:
            return False
        m = self.atlas.current
        _, bow = quantize(self.vocabulary, frame.desc_signed, frame.valid, device=self.device)
        cands = self.reloc_db.detect_relocalization_candidates(bow, n_best=5)
        self.stats.record_count("reloc_candidates", len(cands))
        for kid in cands:
            kf = m.keyframes.get(kid)
            if kf is None:
                continue
            has_mp = kf.mp_ids >= 0
            if has_mp.sum() < 15:
                continue
            pos, desc, okq = self._gather_map_points(kf.mp_ids, m)
            okq &= has_mp
            _, _, kd, _, kvalid, _ = self._frame_device_arrays(frame)
            res = match_fisheye(
                self._upload(desc, np.int8), self._upload(okq, np.bool_), kd, kvalid, ratio=0.75,
            )
            idx_right, keep = device_fetch(res.idx_right, res.valid)
            self.stats.record_count("device_fetches", 1)
            if keep.sum() < 15:
                continue
            idxf = idx_right[keep]
            X = pos[keep]
            rays = unproject_np(self._cam_host, frame.kp_uv[idxf])
            sig2 = (1.0 / self._inv_sigma2)[frame.kp_level[idxf]]
            pnp = ransac_pnp(X.astype(np.float64), rays, sig2, float(self._cam_host.params[0]))
            if not pnp.success:
                continue
            self.stats.record_count("reloc_pnp_inliers", int(pnp.inliers.sum()))
            frame.mp_ids[:] = -1
            frame.mp_ids[idxf[pnp.inliers]] = kf.mp_ids[keep][pnp.inliers]
            if not self._optimize_frame_pose(frame, pnp.R_cw, pnp.t_cw, min_inliers=10):
                continue
            # Widening-window refinement (Tracking.cc:3889-3975): when the
            # BoW seed leaves < 50 inliers, re-project the candidate KF's map
            # points through the refined pose with a wide window, rebind,
            # and re-optimize; then once more with a narrow window.
            for window in (10.0, 3.0):
                if self.n_inliers >= 50:
                    break
                if self._reloc_projection_rebind(frame, kf, m, window):
                    self._optimize_frame_pose(frame, frame.R_cw, frame.t_cw, min_inliers=10)
            self.stats.record_count("reloc_inliers", self.n_inliers)
            if self.n_inliers >= 50:
                self.ref_kf_id = kid
                return True
        return False

    def _reloc_projection_rebind(self, frame: TrackedFrame, kf, m, window: float) -> bool:
        """SearchByProjection(CurrentFrame, pKF, th, ...) for relocalization
        (ORBmatcher.cc:2087), on the host: project the candidate keyframe's
        map points with the current pose estimate and window-match unbound
        keypoints."""
        has_mp = kf.mp_ids >= 0
        if frame.R_cw is None or has_mp.sum() == 0:
            return False
        mids = kf.mp_ids.copy()
        pos, _, okq = self._gather_map_points(mids, m)
        okq &= has_mp
        # skip points already bound to this frame
        bound = frame.mp_ids[frame.mp_ids >= 0]
        if len(bound):
            okq &= ~np.isin(mids, bound)
        Xc = pos @ frame.R_cw.T.astype(np.float32) + frame.t_cw.astype(np.float32)
        uv = project_np(self._cam_host, Xc)
        okq &= frustum_depth_ok(self._cam_host, Xc) & in_image_np(self._cam_host, uv)
        if not okq.any():
            return False
        lvl = kf.kp_level.astype(np.int32)
        radius = (window * self._scale_factors[lvl]).astype(np.float32)
        packed = self._packed_for(mids, m, okq)
        taken = frame.mp_ids >= 0
        idx, _, hit = hk.host_search_by_projection(
            uv.astype(np.float32), packed, radius,
            np.maximum(lvl - 1, 0), np.minimum(lvl + 1, self.cfg.n_levels - 1),
            okq, frame.kp_uv.astype(np.float32), frame.desc_packed,
            frame.kp_level.astype(np.int32), frame.valid & ~taken,
            max_dist=TH_HIGH,
        )
        n_new = 0
        for q in np.where(hit)[0]:
            i = int(idx[q])
            if frame.mp_ids[i] < 0:
                frame.mp_ids[i] = mids[q]
                n_new += 1
        return n_new > 0

    # ---------------------------------------------------------- local map
    def _local_map_ids(self, frame: TrackedFrame):
        """UpdateLocalKeyFrames/Points (Tracking.cc:3571-3797): KFs observing
        current points + their covisible neighbors; then all their points."""
        m = self.atlas.current
        kf_counter: dict[int, int] = {}
        for mid in frame.mp_ids:
            if mid < 0:
                continue
            mp = m.mappoints.get(int(mid))
            if mp is None or mp.bad:
                continue
            for kf_id in mp.observations:
                kf_counter[kf_id] = kf_counter.get(kf_id, 0) + 1
        if not kf_counter:
            return [], np.empty(0, np.int64)
        # Deterministic neighbor expansion: strongest observers first (the
        # reference iterates mvpLocalKeyFrames in insertion order; a set walk
        # would make neighbor selection nondeterministic).
        seeds = sorted(kf_counter, key=lambda k: (-kf_counter[k], k))
        local_kfs = list(seeds)
        local_set = set(local_kfs)
        for kf_id in seeds[:80]:
            kf = m.keyframes.get(kf_id)
            if kf is None:
                continue
            for nid in kf.best_covisible(10):
                if nid not in local_set:
                    local_set.add(nid)
                    local_kfs.append(nid)
            if len(local_kfs) > 80:
                break
        self.ref_kf_id = seeds[0]
        mp_arrays = [
            m.keyframes[kf_id].mp_ids for kf_id in local_kfs
            if kf_id in m.keyframes
        ]
        if not mp_arrays:
            return local_kfs, np.empty(0, np.int64)
        allm = np.concatenate(mp_arrays)
        allm = allm[allm >= 0]
        # Dedupe PRESERVING covisibility order (seeds' points first): the
        # TLM candidate cap truncates this list, so sorted-by-id order would
        # keep the OLDEST map points instead of the ones covisible with the
        # current view.
        _, first_idx = np.unique(allm, return_index=True)
        mp_ids = allm[np.sort(first_idx)]
        return local_kfs, mp_ids

    def _track_local_map(self, frame: TrackedFrame) -> bool:
        m = self.atlas.current
        _, mp_ids = self._local_map_ids(frame)
        self._tlm_cand_ids = mp_ids  # next fused frame's candidate set
        if len(mp_ids) == 0:
            return False

        # Host frustum cull (Frame::isInFrustum: the reference also does
        # this on host, Tracking.cc:3472) as ONE vectorized float64 pass
        # over the map's packed PointStore.
        P_CAP = self._TLM_CAP
        rows_all = m.rows_for(mp_ids)
        sel = rows_all >= 0
        already = frame.mp_ids[frame.mp_ids >= 0]
        if len(already):
            sel &= ~np.isin(mp_ids, already)
        n_over = int(sel.sum()) - P_CAP
        if n_over > 0:
            self.stats.record_count("tlm_overflow_points", n_over)
            drop = np.where(sel)[0][P_CAP:]
            sel[drop] = False
        rows = rows_all[sel]
        mids_sel = mp_ids[sel]
        st = m.store
        sel_desc = st.has_desc[rows]
        rows = rows[sel_desc]
        mids_sel = mids_sel[sel_desc]
        j = len(rows)
        if j == 0:
            return self.n_inliers >= 30

        R_wc, t_wc = frame.pose_wc()
        pos_j = st.pos[rows]
        Xc = (pos_j - t_wc) @ R_wc
        uv = project_np(self._cam_host, Xc)
        dist = np.linalg.norm(Xc, axis=1)
        view = (pos_j - t_wc) / np.maximum(dist, 1e-9)[:, None]
        view_cos = np.sum(st.normal[rows] * view, axis=1)
        in_frustum = (
            frustum_depth_ok(self._cam_host, Xc)
            & in_image_np(self._cam_host, uv)
            & (dist >= 0.8 * st.min_dist[rows])
            & (dist <= 1.2 * st.max_dist[rows])
            & (view_cos >= 0.5)
        )
        # visibility bookkeeping (MapPoint::IncreaseVisible)
        st.n_visible[rows[in_frustum]] += 1

        # predicted pyramid level (MapPoint::PredictScale), vectorized
        ratio = st.max_dist[rows] / np.maximum(dist, 1e-9)
        lv = np.ceil(
            np.log(np.maximum(ratio, 1e-9)) / np.log(self.cfg.scale_factor)
        )
        lv = np.clip(lv, 0, self.cfg.n_levels - 1).astype(np.int32)

        # pack into fixed-capacity arrays for the device matcher
        desc = np.zeros((P_CAP, 256), np.int8)
        okq = np.zeros(P_CAP, bool)
        levels = np.zeros(P_CAP, np.int32)
        mids_arr = np.full(P_CAP, -1, np.int64)
        desc[:j] = st.desc_signed[rows]
        okq[:j] = in_frustum
        levels[:j] = lv
        mids_arr[:j] = mids_sel
        u = np.zeros(P_CAP, np.float64)
        v = np.zeros(P_CAP, np.float64)
        u[:j] = uv[:, 0]
        v[:j] = uv[:, 1]
        # viewing-angle-dependent window (ORBmatcher::RadiusByViewingCos,
        # ORBmatcher.cc:141): nearly head-on points (cos > 0.998) search a
        # tight 2.5-px window, oblique ones 4.0 px, scaled by the predicted
        # pyramid level; th=1 (SearchLocalPoints default).
        r_base = np.full(P_CAP, 4.0, np.float64)
        r_base[:j] = np.where(view_cos > 0.998, 2.5, 4.0)
        radius = r_base * self._scale_factors[levels]
        taken = frame.mp_ids >= 0
        if self.kcfg.search_local_points:
            t_w = time.perf_counter()
            q6 = np.stack([
                u, v, radius, np.maximum(levels - 1, 0), levels,
                okq.astype(np.float64),
            ]).astype(np.float32)
            kx, ky, kd, klvl, kvalid, _ = self._frame_device_arrays(frame)
            t_h = time.perf_counter()
            q6_d = self._upload(q6, np.float32)
            desc_d = self._upload(desc, np.int8)
            taken_d = self._upload(taken, np.float32)
            t_x = time.perf_counter()
            idx, keep = tlm_match_packed(q6_d, desc_d, kx, ky, kd, klvl, kvalid, taken_d)
            t_d = time.perf_counter()
            idx_np, keep_np = device_fetch(idx, keep)
            t_e = time.perf_counter()
            self.stats.record("slp_wrap", (t_h - t_w) * 1e3)
            self.stats.record("slp_h2d", (t_x - t_h) * 1e3)
            self.stats.record("slp_exec", (t_d - t_x) * 1e3)
            self.stats.record("slp_d2h", (t_e - t_d) * 1e3)
            self.stats.record("sync_ms", (t_e - t_d) * 1e3)
            self.stats.record_count("device_fetches", 1)
        else:
            # host path (ORBmatcher.cc:227 CPU branch of the
            # searchLocalPoints toggle)
            packed = self._packed_for(mids_arr, m, okq)
            idx_np, keep_np = hk.host_tlm_match(
                np.stack([u, v], -1).astype(np.float32), packed,
                radius.astype(np.float32),
                np.maximum(levels - 1, 0).astype(np.int32),
                levels.astype(np.int32), okq,
                frame.kp_uv.astype(np.float32), frame.desc_packed,
                frame.kp_level.astype(np.int32), frame.valid, taken,
            )
        frame.mp_ids[idx_np[keep_np]] = mids_arr[keep_np]

        # Pose optimization, bypassed when the toggle is off
        # (Tracking.cc:3080-3106).
        if self.kcfg.pose_optimization:
            ok = self._optimize_frame_pose(frame, frame.R_cw, frame.t_cw, min_inliers=15)
            if not ok:
                return False
        else:
            self.n_inliers = int((frame.mp_ids >= 0).sum())
        return self.n_inliers >= 20

    def _update_found_counters(self, frame: TrackedFrame):
        """MapPoint::IncreaseFound for every tracked point: one vectorized
        pass over the packed store."""
        m = self.atlas.current
        bound = frame.mp_ids[frame.mp_ids >= 0]
        rows = m.rows_for(bound)
        m.store.n_found[rows[rows >= 0]] += 1

    # ------------------------------------------------------------ keyframes
    def _need_new_keyframe(self, frame: TrackedFrame) -> bool:
        """Tracking.cc:3193 (simplified): reference ratio + frame spacing."""
        m = self.atlas.current
        kf = m.keyframes.get(self.ref_kf_id)
        if kf is None:
            return False
        # Inertial pre-init: insert a keyframe every 0.25 s so the temporal
        # chain densifies fast enough for IMU initialization
        # (Tracking.cc NeedNewKeyFrame inertial branch: >=0.25s pre-init).
        if self.use_imu and not m.imu_initialized:
            last_kf = m.keyframes.get(self.last_kf_id)
            due = last_kf is not None and frame.timestamp - last_kf.timestamp >= 0.25
            if due or self.monocular:
                # A monocular map takes no other keyframe before its IMU
                # init, as the reference's inertial branch returns: keyframes
                # a frame apart triangulate over baselines so short that the
                # map's scale drifts ~2.5x across the 2 s chain the init fits
                # with one scale (ROADMAP F35; the JAX package falls through
                # to the ratio test for every sensor)
                return due
        min_obs = 3 if m.n_keyframes() > 2 else 2
        ref_matches = kf.tracked_map_points(m.mappoints, min_obs)
        if ref_matches == 0:
            # Fresh map: init-KF points have a single observation, which
            # would disable the inlier-ratio trigger entirely and let the
            # map go stale.
            ref_matches = kf.tracked_map_points(m.mappoints, 1)
        # close stereo points tracked vs could-be-created
        close = (frame.depth > 0) & (frame.depth < self.th_depth)
        close_tracked = int((close & (frame.mp_ids >= 0)).sum())
        close_new = int((close & (frame.mp_ids < 0)).sum())
        need_insert_close = (close_tracked < 100) and (close_new > 70)
        # mono needs denser keyframes (reference thRefRatio=0.9 monocular)
        th_ref = 0.9 if self.monocular else (0.75 if m.n_keyframes() > 2 else 0.4)
        if self.monocular and self.use_imu and self.n_inliers > self.MI_MANY_INLIERS:
            # IMU_MONOCULAR's ratio once tracking is strong, after the IMU
            # init (ROADMAP F38; the JAX package keeps 0.9, and a 752x480
            # map then makes a keyframe of every frame after its init)
            th_ref = 0.75
        c1a = self.frame_id >= self.last_kf_frame_id + self.max_frames
        c1b = self.frame_id >= self.last_kf_frame_id + self.min_frames
        c2 = (
            self.n_inliers < ref_matches * th_ref or need_insert_close
        ) and self.n_inliers > 15
        return (c1a or (c1b and need_insert_close)) or c2

    def _create_new_keyframe(self, frame: TrackedFrame):
        """Tracking.cc:3345: new KF + stereo map points for close features."""
        m = self.atlas.current
        kf = self._make_keyframe(frame)
        kf.mp_ids = frame.mp_ids.copy()
        m.add_keyframe(kf)
        for i, mid in enumerate(frame.mp_ids):
            if mid >= 0:
                mp = m.mappoints.get(int(mid))
                if mp is not None and not mp.bad:
                    mp.add_observation(kf.kid, i)
        # create close stereo points (sorted by depth, cap ~100 beyond th)
        cand = np.where(frame.valid & (frame.depth > 0) & (frame.mp_ids < 0))[0]
        cand = cand[np.argsort(frame.depth[cand])]
        created = 0
        for i in cand:
            if frame.depth[i] > self.th_depth and created > 100:
                break
            Xw = self._unproject(frame, np.asarray([i]))[0]
            self._new_stereo_point(frame, kf, int(i), Xw, m)
            created += 1
        m.update_connections(kf)
        self.ref_kf_id = kf.kid
        self.last_kf_frame_id = self.frame_id
        if self.local_mapper is not None:
            self.local_mapper.insert_keyframe(kf)

"""Tracking front-end: the per-frame state machine (src/Tracking.cc).

Port of fasttrack_tpu/tracking.py for visual pinhole stereo. Host-side
orchestration of the device programs, mirroring the reference's Track()
control flow (Tracking.cc:1851-2392):

    GrabImage -> process_stereo_frame_stacked (device)    [ORB + stereo]
    -> TrackWithMotionModel (device search + pose opt)    [Tracking.cc:2911]
       fallback TrackReferenceKeyFrame                    [Tracking.cc:2777]
    -> TrackLocalMap (host frustum cull -> device search
       -> pose opt unless bypassed)                       [Tracking.cc:3042]
    -> NeedNewKeyFrame / CreateNewKeyFrame                [Tracking.cc:3193]
    -> RECENTLY_LOST / LOST handling + new map in Atlas   [Tracking.cc:2038]

An OK-state frame takes the single-fetch fused path (fused_track); the first
frame after initialization, a failed motion-model search and lost states
take the stepwise programs above. The tracker creates the close stereo
points of every keyframe itself and hands the keyframe to the local mapper
(local_mapping.LocalMapper), which culls, triangulates, fuses and adjusts;
without one it is stereo visual odometry over a growing map.

The five offload toggles (KernelConfig) are read where the reference
branches on them. The host sides of the four offload toggles are not ported
yet: a toggle that is off raises NotImplementedError (ROADMAP M5c);
pose_optimization=False bypasses pose optimization in TrackLocalMap
(Tracking.cc:3080-3106, the FastTrack ablation mode). The inertial,
monocular, RGB-D and fisheye front ends raise NotImplementedError with
their ROADMAP items.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Optional

import numpy as np
import torch

from fasttrack_tpu_torch import convert
from fasttrack_tpu_torch.cameras.host import (
    frustum_depth_ok,
    host_camera,
    in_image_np,
    project_np,
    unproject_np,
)
from fasttrack_tpu_torch.cameras.models import PINHOLE, Camera
from fasttrack_tpu_torch.device import resolve
from fasttrack_tpu_torch.frame_pipeline import (
    pack_frame_for_host,
    process_stereo_frame_stacked,
)
from fasttrack_tpu_torch.fused_track import (
    pack_fused_for_host,
    tlm_step,
    twm_step,
    unpack_fused,
)
from fasttrack_tpu_torch.kernels import KernelConfig
from fasttrack_tpu_torch.nputils import device_fetch
from fasttrack_tpu_torch.nputils import orthonormalize as _orthonormalize
from fasttrack_tpu_torch.ops.extractor import OrbConfig
from fasttrack_tpu_torch.ops.project_match import (
    TH_HIGH,
    tlm_match_packed,
    twm_match_packed,
)
from fasttrack_tpu_torch.ops.stereo_match import match_fisheye
from fasttrack_tpu_torch.optim import pose_optimize
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
        if imu_calib is not None:
            raise NotImplementedError("inertial tracking is not ported yet (ROADMAP M8)")
        if monocular:
            raise NotImplementedError("monocular tracking is not ported yet (ROADMAP M9)")
        if stereo_rig is not None or camera.kind != PINHOLE:
            raise NotImplementedError("fisheye (KB8) stereo is not ported yet (ROADMAP M9)")
        self.device = resolve(device)
        self.camera = dataclasses.replace(camera, params=camera.params.to(self.device))
        self._cam_host = host_camera(camera)   # host copy for the query blocks
        self._tlm_cand_ids = None  # local-map candidate ids for fused frames
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
        if not (self.kcfg.orb_extraction and self.kcfg.stereo_match):
            raise NotImplementedError(
                "host ORB extraction and host stereo matching (orb_extraction / "
                "stereo_match toggles off) are not ported yet (ROADMAP M5c)"
            )
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

    def track_rgbd(self, img, depth_map, timestamp: float):
        raise NotImplementedError("RGB-D tracking is not ported yet (ROADMAP M9)")

    def track_monocular(self, img, timestamp: float):
        raise NotImplementedError("monocular tracking is not ported yet (ROADMAP M9)")

    def grab_imu(self, samples):
        raise NotImplementedError("inertial tracking is not ported yet (ROADMAP M8)")

    # -------------------------------------------------- fused one-sync path
    def _fused_eligible(self) -> bool:
        """The single-sync frame path (fused_track module) covers the normal
        case: OK state, all device toggles on, local-map candidates cached
        from the previous frame, the constant-velocity model available.
        Everything else (init, reloc, ablations) stays stepwise."""
        return (
            self.state == TrackingState.OK
            and not self.localization_only
            and self._tlm_cand_ids is not None
            and len(self._tlm_cand_ids) > 0
            and self.kcfg.search_local_points and self.kcfg.pose_estimation
            and self.kcfg.pose_optimization
            and self.last_frame is not None
            and self.last_frame.R_cw is not None
            and int((self.last_frame.mp_ids >= 0).sum()) >= 10
            and self.velocity is not None
        )

    _TLM_CAP = 4096  # fixed candidate capacity (one shape for tlm_step)

    def _store_device(self, m):
        """Device-resident PointStore mirror (the reference's persistent
        CudaMapPoint arrays, CudaFrame.cu:77-181 / KernelController.cu:18-22):
        re-uploaded only when the map changed (BA write-back, loop
        correction, new points: all bump change_index or grow the store);
        between keyframes the fused path uploads row INDICES only."""
        st = m.store
        key = (id(m), m.change_index, st.n_rows, st.cap)
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
            if timestamp - last.timestamp < 0:
                return NotImplemented  # timestamp jumps take the stepwise path

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
            (f32, packed, idxA, keepA, idxB, keepB, in_frustum,
             tail) = unpack_fused(buf, N, len(mids), self._TLM_CAP)

            # ---- host bookkeeping
            frame = _frame_from_block(self.frame_id, timestamp, f32, packed)
            inlB_kp = f32[8] > 0.5
            n_inlA = int(tail[12])
            n_inlB = int(tail[13])

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

        self.frame_id += 1
        self.last_frame = frame
        if frame.R_cw is not None:
            self.trajectory.append(
                (timestamp, frame.R_cw.copy(), frame.t_cw.copy())
            )
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
        # Timestamp-jump handling (Tracking.cc:1885-1912): a backwards jump
        # resets the active map.
        if self.last_frame is not None and self.state not in (
            TrackingState.NO_IMAGES_YET, TrackingState.NOT_INITIALIZED
        ):
            if timestamp - self.last_frame.timestamp < 0:
                self.stats.record_count("timestamp_jump_backwards", 1)
                self._reset_active_map()

        if self.state in (TrackingState.NO_IMAGES_YET, TrackingState.NOT_INITIALIZED):
            self._stereo_initialization(frame)
        else:
            self._track(frame)

        self.frame_id += 1
        self.last_frame = frame
        if frame.R_cw is not None:
            self.trajectory.append((timestamp, frame.R_cw.copy(), frame.t_cw.copy()))
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

    def _make_keyframe(self, frame: TrackedFrame) -> KeyFrame:
        return KeyFrame(
            self.atlas.next_kf_id(), frame.frame_id, frame.timestamp,
            frame.R_cw, frame.t_cw, frame.kp_uv, frame.kp_level, frame.kp_angle,
            frame.desc_packed, frame.desc_signed, frame.u_right, frame.depth,
            frame.valid,
        )

    # ------------------------------------------------------------- tracking
    def _track(self, frame: TrackedFrame):
        m = self.atlas.current
        with m.lock:
            ok = False
            if self.state == TrackingState.OK:
                if self.velocity is not None:
                    t0 = time.perf_counter()
                    ok = self._track_with_motion_model(frame)
                    self.stats.record("twm", (time.perf_counter() - t0) * 1e3)
                if not ok:
                    t0 = time.perf_counter()
                    ok = self._track_reference_keyframe(frame)
                    self.stats.record("trk", (time.perf_counter() - t0) * 1e3)
            elif self.state == TrackingState.RECENTLY_LOST:
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
            if not self.localization_only and self._need_new_keyframe(frame):
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
            self._tlm_cand_ids = None
            # keep last pose as estimate
            if frame.R_cw is None and self.last_frame.R_cw is not None:
                frame.R_cw = self.last_frame.R_cw.copy()
                frame.t_cw = self.last_frame.t_cw.copy()
        self.stats.record_count("track_ok", int(ok))

    def _reset_active_map(self):
        """Tracking::ResetActiveMap: wipe the current map and reinitialize
        (used for backwards timestamp jumps)."""
        self.atlas.current.clear()
        self.state = TrackingState.NOT_INITIALIZED
        self.ref_kf_id = None
        self.velocity = None

    def _handle_lost(self):
        """Tracking.cc:2071-2089: abandon small maps, else start a fresh map
        in the Atlas (to be merged back by loop closing)."""
        m = self.atlas.current
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

    def _track_with_motion_model(self, frame: TrackedFrame) -> bool:
        """Tracking.cc:2911 + the PoseEstimationKernel device search."""
        m = self.atlas.current
        last = self.last_frame
        if last is None or self.velocity is None:
            return False
        R_pred = self.velocity[0] @ last.R_cw
        t_pred = self.velocity[0] @ last.t_cw + self.velocity[1]

        has_mp = last.mp_ids >= 0
        if has_mp.sum() < 10:
            return False
        if not self.kcfg.pose_estimation:
            raise NotImplementedError(
                "the host motion-model matcher (pose_estimation toggle off) is "
                "not ported yet (ROADMAP M5c)"
            )
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
        kx, ky, kd, klvl, kvalid, kang = self._frame_device_arrays(frame)
        desc_d = self._upload(desc, np.int8)
        for widen in (1.0, 2.0):  # retry with doubled window (Tracking.cc:2964)
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
        fd = self._fd_dev
        if fd is not None and frame.frame_id == self.frame_id:
            obs_uv = torch.stack([fd.kps.x, fd.kps.y], dim=-1)
            obs_ur = fd.u_right
        else:
            obs_uv = self._upload(frame.kp_uv, np.float32)
            obs_ur = self._upload(frame.u_right, np.float32)
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

    # -------------------------------------------------------- relocalization
    def _relocalization(self, frame: TrackedFrame) -> bool:
        """Tracking::Relocalization (Tracking.cc:3798). Requires a
        place-recognition database (self.reloc_db, shared with loop
        closing); without one there is nothing to relocalize against."""
        if self.reloc_db is None or self.vocabulary is None:
            return False
        raise NotImplementedError(
            "relocalization against a keyframe database is not ported yet (ROADMAP M7)"
        )

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
        if not self.kcfg.search_local_points:
            raise NotImplementedError(
                "the host local-map matcher (search_local_points toggle off) is "
                "not ported yet (ROADMAP M5c)"
            )

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
        th_ref = 0.75 if m.n_keyframes() > 2 else 0.4
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

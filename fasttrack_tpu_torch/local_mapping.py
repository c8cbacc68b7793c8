"""Local mapping back-end (src/LocalMapping.cc), visual and inertial.

Port of fasttrack_tpu/local_mapping.py. Per inserted keyframe
(LocalMapping::Run loop, LocalMapping.cc:64-282): recent-map-point culling,
new-point triangulation (stereo points come from the tracker; epipolar
triangulation adds the far points), duplicate fusion, local BA over the
covisibility window (device Schur-complement solver), and keyframe culling.

Runs either synchronously (deterministic tests) or as a background thread
with the same queue/abort protocol as the reference.

What runs on the device: the batched epipolar matcher + triangulation (one
Hamming + penalty + top-K launch for all neighbour keyframes, one fetch),
the fusion search (one exact Hamming matrix launch and one fetch per target
keyframe) and the bundle adjustment (one upload, one fetch; in float64,
where the JAX package solves in float32: ba_assembly says why). The loops
over points that instantiate, validate and cull stay on the host, as in the
JAX package.

With an IMU (`imu_calib`, stereo-inertial) the mapper also initializes the
IMU once the temporal keyframe chain spans 6 keyframes over 2 s
(imu.init.initialize_imu, host float64), then runs the local inertial BA
(optim.inertial.local_inertial_ba, one upload and one fetch per window:
4 fixed anchor keyframes + 8 + 1 states, 1024 points) instead of the visual
one, the full inertial BA stages 5 s and 15 s after initialization (the
chain swept in overlapping windows), and the inertial keyframe-cull rules.
The inertial window is solved in `INERTIAL_SOLVE_DTYPE`.

With a `loop_closer` (loop_closing.LoopCloser) the mapper hands it every
keyframe it has processed, as the JAX package does: inline, or with
`run_async=True` from the mapping thread into the closer's queue. The
closer's post-loop global BA of an IMU-initialized map is this mapper's
`full_inertial_ba_converged`.

A visual monocular map (`monocular=True`) runs the same steps: its only
new points are the epipolar triangulation's, since its keyframes carry no
depth, and its adjustments have mono edges only. With an IMU as well (a
monocular-inertial map) the IMU init also solves the map's scale and
applies it with the gravity rotation; the velocities it solves are metric
and are not scaled again (ROADMAP F34); every 10th keyframe after it,
until the second full inertial BA stage, the scale and gravity are solved
again over the last 64 keyframes and applied when the scale moves by more
than 0.2% (`_scale_refinement`). After either rescale the points' normals
and distances and the tracker's saved frames follow the map (F36, F37),
and its inertial windows reject a step that moves a live observation
behind its camera (F24).

Given a `mesh` (parallel.make_mesh), the visual local BA is the
landmark-sharded one (parallel/dist_ba.py, 8 LM iterations, a cost fetch
each), as the JAX mapper routes it; the window is float64 here as on one
device (ba_assembly.SOLVE_DTYPE), where the JAX package's is float32.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import queue
import threading
import time
import types

import numpy as np
import torch

from fasttrack_tpu_torch import convert
from fasttrack_tpu_torch.ba_assembly import assemble_window, write_back
from fasttrack_tpu_torch.cameras.host import (
    HostCamera,
    frustum_depth_ok,
    host_camera,
    in_image_np,
    project_np,
)
from fasttrack_tpu_torch.cameras.models import PINHOLE, Camera
from fasttrack_tpu_torch.device import resolve
from fasttrack_tpu_torch.imu.init import initialize_imu
from fasttrack_tpu_torch.nputils import device_fetch, orthonormalize
from fasttrack_tpu_torch.ops.host_kernels import search_by_projection_exact
from fasttrack_tpu_torch.ops.project_match import TH_LOW, epipolar_match_tri_batch
from fasttrack_tpu_torch.optim import BAResult, local_bundle_adjustment
from fasttrack_tpu_torch.optim.inertial import local_inertial_ba
from fasttrack_tpu_torch.parallel.dist_ba import distributed_bundle_adjustment
from fasttrack_tpu_torch.slam_map import Atlas, KeyFrame, MapPoint
from fasttrack_tpu_torch.stats import Stats

# BA window capacities (fixed shapes: one program for every window).
BA_MAX_KFS = 16
BA_MAX_POINTS = 2048
INERTIAL_BA_POINTS = 1024       # the temporal window's point cap
MESH_BA_ITERS = 8               # LM iterations of a local BA sharded over a mesh
# Floating type of the inertial window's solve: float32, as the JAX package
# (ROADMAP P5 records what a float64 solve does instead).
INERTIAL_SOLVE_DTYPE = np.float32


def _merge_preintegrated(a, b):
    """Compose host preintegration snapshots: A (prev->mid) then B
    (mid->next) -> (prev->next). Analytic composition of the deltas and
    bias Jacobians (the reference re-integrates stored measurements,
    ImuTypes::MergePrevious; measurements aren't retained here so the
    first-order composition is used; covariance is summed, a conservative
    upper bound)."""
    def hat(v):
        return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])

    dR = a.dR @ b.dR
    dV = a.dV + a.dR @ b.dV
    dP = a.dP + a.dV * b.dT + a.dR @ b.dP
    JRg = b.dR.T @ a.JRg + b.JRg
    JVg = a.JVg - a.dR @ hat(b.dV) @ a.JRg + a.dR @ b.JVg
    JVa = a.JVa + a.dR @ b.JVa
    JPg = a.JPg + a.JVg * b.dT - a.dR @ hat(b.dP) @ a.JRg + a.dR @ b.JPg
    JPa = a.JPa + a.JVa * b.dT + a.dR @ b.JPa
    return types.SimpleNamespace(
        dT=a.dT + b.dT, dR=dR, dV=dV, dP=dP,
        JRg=JRg, JVg=JVg, JVa=JVa, JPg=JPg, JPa=JPa,
        C=a.C + b.C, b0=a.b0,
    )


def _body_from_cam_np(R_cw, t_cw, R_bc, t_bc):
    """Host body pose from camera pose (X_b = R_bc X_c + t_bc convention):
    R_wb = R_wc R_bc^T, p_w = -R_wc t_cw - R_wb t_bc."""
    R_wc = R_cw.T
    R_wb = R_wc @ R_bc.T
    return R_wb, -R_wc @ t_cw - R_wb @ t_bc


class LocalMapper:
    def __init__(self, atlas: Atlas, camera: Camera, bf: float,
                 scale_factor: float = 1.2, n_levels: int = 8,
                 run_async: bool = False, loop_closer=None,
                 imu_calib=None, tracker=None, monocular: bool = False,
                 mesh=None, stats: Stats | None = None,
                 device=None):      # None: the card (device.resolve); "cpu" for the CPU
        self.device = resolve(device)
        self.mesh = mesh    # parallel.Mesh: the local BA sharded over its devices
        self.atlas = atlas
        self.camera = dataclasses.replace(camera, params=camera.params.to(self.device))
        self._cam_host = host_camera(camera)   # host copy for the projections
        self.bf = float(bf)
        self._bf_dev = torch.tensor(self.bf, dtype=torch.float32, device=self.device)
        self.scale_factor = scale_factor
        self.n_levels = n_levels
        self.inv_sigma2 = 1.0 / (scale_factor ** (2 * np.arange(n_levels)))
        self.loop_closer = loop_closer
        self.imu_calib = imu_calib          # enables the inertial back-end
        self.imu_init_kfs = 6               # KFs needed before InitializeIMU
        self.imu_init_time = None           # timestamp of InitializeIMU
        self._scale_kf_counter = 0          # keyframes since, for ScaleRefinement
        if imu_calib is not None:
            self._R_bc, self._t_bc = imu_calib.extrinsic_np()       # host, float64
            self._Rbc_dev = imu_calib.R_bc.to(self.device)
            self._tbc_dev = imu_calib.t_bc.to(self.device)
        self.tracker = tracker
        self.monocular = monocular
        self.stats = stats or Stats()
        self.recent_mp_ids: list[tuple[int, int]] = []  # (mp_id, first_kf)
        self.run_async = run_async
        self.abort_ba = False
        self._queue: queue.Queue = queue.Queue()
        self._stop = False
        self._idle = threading.Event()
        self._idle.set()
        self._thread = None
        if run_async:
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()

    # ---------------------------------------------------------------- public
    def insert_keyframe(self, kf: KeyFrame):
        if self.run_async:
            self.abort_ba = True  # interrupt BA like mbAbortBA
            self._queue.put(kf)
        else:
            self.process_keyframe(kf)

    def queue_size(self) -> int:
        return self._queue.qsize()

    def is_idle(self) -> bool:
        return self._idle.is_set() and self._queue.empty()

    def stop(self):
        self._stop = True
        if self._thread is not None:
            self._queue.put(None)
            self._thread.join(timeout=10)

    def _run(self):
        while not self._stop:
            kf = self._queue.get()
            if kf is None:
                break
            self._idle.clear()
            try:
                with self.atlas.current.lock:
                    self.process_keyframe(kf)
            finally:
                self._idle.set()

    # ------------------------------------------------------------ processing
    def _timed(self, name: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        self.stats.record(name, (time.perf_counter() - t0) * 1e3)
        return out

    def process_keyframe(self, kf: KeyFrame):
        m = self.atlas.current
        if kf.kid not in m.keyframes:
            return
        t0 = time.perf_counter()
        self.abort_ba = False
        self._timed("lm_track_new_points", self._track_new_points, kf)
        self._timed("lm_cull_points", self._cull_recent_mappoints, kf)
        self._timed("lm_triangulate", self._create_new_mappoints, kf)
        self._timed("lm_fuse", self._search_in_neighbors, kf)
        inertial = self.imu_calib is not None
        if m.n_keyframes() > 2:
            if inertial and m.imu_initialized:
                self._timed("lm_local_inertial_ba", self._local_inertial_ba, kf)
            else:
                self._timed("lm_local_ba", self._local_ba, kf)
            self._timed("lm_cull_keyframes", self._cull_keyframes, kf)
        if inertial and not m.imu_initialized:
            self._timed("lm_imu_init", self._try_initialize_imu, kf)
        elif inertial and self.imu_init_time is not None:
            # VIBA staging (LocalMapping.cc:181-242): full-map inertial BA
            # ~5 s and ~15 s after initialization refines scale, gravity and
            # bias once more motion has accumulated.
            dt = kf.timestamp - self.imu_init_time
            if not m.iniertial_ba1 and dt > 5.0:
                self._timed("lm_full_inertial_ba", self._full_inertial_ba, kf)
                m.iniertial_ba1 = True
            elif m.iniertial_ba1 and not m.iniertial_ba2 and dt > 15.0:
                self._timed("lm_full_inertial_ba", self._full_inertial_ba, kf)
                m.iniertial_ba2 = True
            elif self.monocular and not m.iniertial_ba2:
                # a monocular map's scale is refined on every 10th keyframe
                # that reaches this branch, until the second stage fixes it
                self._scale_kf_counter += 1
                if self._scale_kf_counter % 10 == 0:
                    self._timed("lm_scale_refinement", self._scale_refinement, kf)
        self.stats.record_count("lm_keyframes", 1)
        self.stats.record("lm_total", (time.perf_counter() - t0) * 1e3)
        if self.loop_closer is not None and kf.kid in m.keyframes:
            self._timed("lc_keyframe", self.loop_closer.insert_keyframe, kf)

    def _track_new_points(self, kf: KeyFrame):
        """LocalMapping::ProcessNewKeyFrame (LocalMapping.cc:298): register
        map points CREATED at this keyframe for the culling grace window (the
        reference's mlpRecentAddedMapPoints holds newly triangulated points,
        not re-observed ones, LocalMapping.cc:388); RE-observed points get a
        fresh distinctive descriptor + normal/depth, like the reference's
        UpdateNormalAndDepth + ComputeDistinctiveDescriptors calls there."""
        m = self.atlas.current
        for i, mid in enumerate(kf.mp_ids):
            if mid < 0:
                continue
            mp = m.mappoints.get(int(mid))
            if mp is None or mp.bad:
                continue
            if mp.first_kf_id == kf.kid and kf.kid != m.init_kf_id:
                # init points are not probationary
                self.recent_mp_ids.append((int(mid), kf.kid))
            elif mp.first_kf_id != kf.kid:
                m.refresh_mappoint(mp, self.scale_factor, self.n_levels)

    def _cull_recent_mappoints(self, kf: KeyFrame):
        """MapPointCulling (LocalMapping.cc:346): drop points with poor
        found/visible ratio or too few observations after a grace period."""
        m = self.atlas.current
        survivors = []
        n_culled = 0
        for mid, first_kf in self.recent_mp_ids:
            mp = m.mappoints.get(mid)
            if mp is None or mp.bad:
                continue
            age = kf.kid - first_kf
            if mp.found_ratio() < 0.25:
                m.erase_mappoint(mid)
                n_culled += 1
            elif age >= 2 and mp.n_obs() <= 2:
                m.erase_mappoint(mid)
                n_culled += 1
            elif age >= 3:
                continue  # graduated
            else:
                survivors.append((mid, first_kf))
        self.recent_mp_ids = survivors
        self.stats.record_count("lm_points_culled", n_culled)
        return n_culled

    # ------------------------------------------------- new point creation
    _EPI_BATCH = 10   # fixed neighbor-batch capacity (one shape for the matcher)

    def _create_new_mappoints(self, kf: KeyFrame, n_neighbors: int = 10):
        """Epipolar triangulation of unmatched features with covisible
        keyframes (LocalMapping::CreateNewMapPoints, LocalMapping.cc:388).
        The stereo tracker also creates points from depth; this adds the
        far points and is the ONLY source of points in a monocular map.

        ALL neighbor pairs run as ONE batched device pass
        (ops.project_match.epipolar_match_tri_batch): match + triangulate
        for up to _EPI_BATCH neighbors in a single dispatch + fetch, instead
        of two blocking round trips per neighbor. A second pass with
        refreshed free masks recovers the sequential loop's rebinding
        behavior (features bound by an earlier neighbor are re-matched by
        later ones), so point yield matches the per-neighbor ordering within
        noise."""
        if self.camera.kind != PINHOLE:
            # Epipolar F-matrix gating is pinhole geometry.
            return 0
        created = self._create_points_batched(kf, n_neighbors)
        if created:
            created += self._create_points_batched(kf, n_neighbors)
        self.stats.record_count("lm_points_triangulated", created)
        return created

    def _create_points_batched(self, kf: KeyFrame, n_neighbors: int = 10):
        m = self.atlas.current
        fx, fy, cx, cy = (float(x) for x in self._cam_host.params[:4])
        Kmat = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
        Kinv = np.linalg.inv(Kmat)
        sigma2 = self.inv_sigma2  # note: inv; variance = 1/inv

        # ---- collect neighbor pairs (host) --------------------------------
        nbs, F12s, R21s, t21s = [], [], [], []
        for nid in kf.best_covisible(n_neighbors):
            nb = m.keyframes.get(nid)
            if nb is None:
                continue
            # baseline check (LocalMapping.cc:437): skip near-identical views
            if np.linalg.norm(kf.center - nb.center) < 0.01:
                continue
            # fundamental F12 with x2^T F x1 = 0 (1 = neighbor, 2 = current)
            R21 = kf.R_cw @ nb.R_cw.T
            t21 = kf.t_cw - R21 @ nb.t_cw
            tx = np.array([[0, -t21[2], t21[1]], [t21[2], 0, -t21[0]],
                           [-t21[1], t21[0], 0]])
            F12s.append(Kinv.T @ (tx @ R21) @ Kinv)
            R21s.append(R21)
            t21s.append(t21)
            nbs.append(nb)
            if len(nbs) >= self._EPI_BATCH:
                break
        if not nbs:
            return 0

        # ---- pack to fixed shapes (B x C1 neighbors, C2 current) ----------
        def _cap(n):
            return max(256, int(np.ceil(n / 256)) * 256)

        B = self._EPI_BATCH
        C1 = _cap(max(len(nb.kp_uv) for nb in nbs))
        C2 = _cap(len(kf.kp_uv))
        uvf1 = np.zeros((3, B, C1), np.float32)     # u, v, free of the neighbors
        d1 = np.zeros((B, C1, 256), np.int8)
        # per pair: F12 (9), R21 (9), t21 (3); identity for an empty slot
        geo = np.tile(
            np.concatenate([np.eye(3).ravel(), np.eye(3).ravel(), np.zeros(3)]), (B, 1)
        ).astype(np.float32)
        for b, nb in enumerate(nbs):
            n = len(nb.kp_uv)
            uvf1[0, b, :n] = nb.kp_uv[:, 0]
            uvf1[1, b, :n] = nb.kp_uv[:, 1]
            uvf1[2, b, :n] = (nb.mp_ids < 0) & nb.valid
            d1[b, :n] = nb.desc_signed
            geo[b, :9] = F12s[b].ravel()
            geo[b, 9:18] = R21s[b].ravel()
            geo[b, 18:] = t21s[b]
        n2 = len(kf.kp_uv)
        uvfs2 = np.zeros((4, C2), np.float32)       # u, v, free, level variance
        uvfs2[3] = 1.0
        d2 = np.zeros((C2, 256), np.int8)
        uvfs2[0, :n2] = kf.kp_uv[:, 0]
        uvfs2[1, :n2] = kf.kp_uv[:, 1]
        uvfs2[2, :n2] = (kf.mp_ids < 0) & kf.valid
        uvfs2[3, :n2] = (1.0 / sigma2)[kf.kp_level]
        d2[:n2] = kf.desc_signed

        def up(a, dtype):
            return convert.tensor_from_numpy(a, dtype, self.device)

        q1, k2, g = up(uvf1, np.float32), up(uvfs2, np.float32), up(geo, np.float32)
        idx2_d, keep_d, X1_d = epipolar_match_tri_batch(
            q1[0], q1[1], up(d1, np.int8), q1[2] > 0.5,
            k2[0], k2[1], up(d2, np.int8), k2[2] > 0.5,
            g[:, :9].reshape(B, 3, 3), k2[3],
            g[:, 9:18].reshape(B, 3, 3), g[:, 18:],
            fx, fy, cx, cy,
        )
        idx2_b, keep_b, X1_b = device_fetch(idx2_d, keep_d, X1_d)
        self.stats.record_count("lm_device_fetches", 1)
        self.stats.record_count("lm_triangulation_passes", 1)

        # ---- validate + instantiate (host, per pair) -----------------------
        created = 0
        for b, nb in enumerate(nbs):
            keep = keep_b[b, : len(nb.kp_uv)]
            if not keep.any():
                continue
            i1 = np.where(keep)[0]
            i2 = idx2_b[b][i1]
            in_range = i2 < n2
            i1, i2 = i1[in_range], i2[in_range]
            if len(i1) == 0:
                continue
            X1 = X1_b[b][i1]
            # validations: finite, in front, parallax, reprojection
            z1 = X1[:, 2]
            X2 = X1 @ R21s[b].T + t21s[b]
            z2 = X2[:, 2]
            d1v = X1 / np.maximum(np.linalg.norm(X1, axis=1, keepdims=True), 1e-9)
            C2in1 = -R21s[b].T @ t21s[b]
            v2v = X1 - C2in1
            d2v = v2v / np.maximum(np.linalg.norm(v2v, axis=1, keepdims=True), 1e-9)
            cosp = np.sum(d1v * d2v, axis=1)
            pr1 = X1 @ Kmat.T
            pr1 = pr1[:, :2] / np.maximum(pr1[:, 2:], 1e-9)
            pr2 = X2 @ Kmat.T
            pr2 = pr2[:, :2] / np.maximum(pr2[:, 2:], 1e-9)
            e1 = ((pr1 - nb.kp_uv[i1]) ** 2).sum(1) * sigma2[nb.kp_level[i1]]
            e2 = ((pr2 - kf.kp_uv[i2]) ** 2).sum(1) * sigma2[kf.kp_level[i2]]
            good = (
                np.isfinite(X1).all(1) & (z1 > 0) & (z2 > 0)
                & (cosp < 0.9998) & (e1 < 5.991) & (e2 < 5.991)
            )
            R1w = nb.R_cw.T
            t1w = nb.center
            for k in np.where(good)[0]:
                a, c = int(i1[k]), int(i2[k])
                if nb.mp_ids[a] >= 0 or kf.mp_ids[c] >= 0:
                    continue
                Xw = R1w @ X1[k] + t1w
                mp = MapPoint(self.atlas.next_mp_id(), Xw, kf.kid, kf.kid)
                mp.add_observation(nb.kid, a)
                mp.add_observation(kf.kid, c)
                mp.desc_packed = kf.desc_packed[c]
                mp.desc_signed = kf.desc_signed[c]
                mp.update_normal_and_depth(
                    {nb.kid: nb.center, kf.kid: kf.center}, kf.center,
                    int(kf.kp_level[c]), self.scale_factor, self.n_levels,
                )
                nb.mp_ids[a] = mp.mid
                kf.mp_ids[c] = mp.mid
                m.add_mappoint(mp)
                self.recent_mp_ids.append((mp.mid, kf.kid))
                created += 1
        return created

    # ------------------------------------------------- duplicate-point fusion
    def _search_in_neighbors(self, kf: KeyFrame, n_neighbors: int = 10):
        """LocalMapping::SearchInNeighbors (LocalMapping.cc:714): project the
        current KF's map points into covisible neighbors (and one hop
        further) and fuse duplicates via ORBmatcher::Fuse semantics
        (ORBmatcher.cc:1247); then the reverse direction. Afterwards the
        current KF's points get fresh distinctive descriptors and normals
        (MapPoint::ComputeDistinctiveDescriptors / UpdateNormalAndDepth) and
        the covisibility graph is rebuilt."""
        m = self.atlas.current
        targets = []
        seen = {kf.kid}
        for nid in kf.best_covisible(n_neighbors):
            if nid in m.keyframes and nid not in seen:
                targets.append(nid)
                seen.add(nid)
        for nid in list(targets):
            for nid2 in m.keyframes[nid].best_covisible(5):
                if nid2 in m.keyframes and nid2 not in seen:
                    targets.append(nid2)
                    seen.add(nid2)
        if not targets:
            return 0

        n_fused = 0
        cur_mids = [int(x) for x in kf.mp_ids if x >= 0]
        for tid in targets:
            n_fused += self._fuse_into(m.keyframes[tid], cur_mids)
        back = sorted(
            {int(x) for tid in targets for x in m.keyframes[tid].mp_ids if x >= 0}
        )
        n_fused += self._fuse_into(kf, back)

        for mid in kf.mp_ids:
            if mid >= 0:
                mp = m.mappoints.get(int(mid))
                if mp is not None and not mp.bad:
                    m.refresh_mappoint(mp, self.scale_factor, self.n_levels)
        m.update_connections(kf)
        self.stats.record_count("lm_points_fused", n_fused)
        return n_fused

    def _fuse_into(self, tkf: KeyFrame, mids: list, th: float = 3.0) -> int:
        return fuse_mappoints_into(
            self.atlas.current, tkf, mids, self._cam_host,
            self.scale_factor, self.n_levels, th,
            device=self.device, stats=self.stats,
        )

    # ------------------------------------------------------------- local BA
    def _local_ba(self, kf: KeyFrame):
        """Covisibility-window BA (Optimizer.cc:1116 semantics): free window
        = current KF + best covisible; fixed frontier = outside KFs
        observing the window's points. Assembly/solve/writeback shared with
        global BA (ba_assembly.solve_window)."""
        m = self.atlas.current
        local_ids = [kf.kid] + kf.best_covisible(BA_MAX_KFS - 1)
        local_ids = [k for k in local_ids if k in m.keyframes]
        local_set = set(local_ids)

        # Window points + fixed frontier (KFs outside observing them).
        mp_ids = []
        seen = set()
        dropped = 0
        for kid in local_ids:
            for mid in m.keyframes[kid].mp_ids:
                if mid >= 0 and int(mid) not in seen:
                    mp = m.mappoints.get(int(mid))
                    if mp is not None and not mp.bad:
                        seen.add(int(mid))
                        if len(mp_ids) < BA_MAX_POINTS:
                            mp_ids.append(int(mid))
                        else:
                            dropped += 1
        if dropped:
            logging.getLogger(__name__).info(
                "local_ba: window overflow, dropped %d points (cap %d)",
                dropped, BA_MAX_POINTS,
            )
        # Fixed frontier: the reference anchors EVERY outside KF observing a
        # window point (Optimizer.cc:1172). Under the fixed-shape KF cap the
        # frontier candidates are ranked by how many window points they
        # observe, so truncation drops the WEAKEST anchors, not whichever
        # came last in iteration order.
        anchor_votes: dict[int, int] = {}
        for mid in mp_ids:
            for kid in m.mappoints[mid].observations:
                if kid not in local_set and kid in m.keyframes:
                    anchor_votes[kid] = anchor_votes.get(kid, 0) + 1
        budget = max(BA_MAX_KFS - len(local_ids), 0)
        fixed_ids = sorted(anchor_votes, key=lambda k: -anchor_votes[k])[:budget]
        if not fixed_ids and len(local_ids) > 1:
            # no frontier at all (young map): freeze the oldest window KF as
            # the gauge anchor so the window cannot drift freely
            oldest = min(local_ids)
            local_ids.remove(oldest)
            local_set.discard(oldest)
            fixed_ids = [oldest]

        prob, meta, _ = assemble_window(
            m, local_ids, fixed_ids,
            self.inv_sigma2, BA_MAX_KFS, BA_MAX_POINTS, mp_ids, device=self.device,
        )
        if self.mesh is not None:
            # Landmark-sharded Schur BA over the mesh (parallel/dist_ba.py):
            # the same math, the reduced camera system summed over the
            # shards, and the final chi2 classification, so this path culls
            # as the single-device one does. As in the JAX package it has no
            # behind-the-camera rule (ROADMAP F24): it charges such
            # observations in its cost instead.
            poses, points, _, inlier, chi2 = distributed_bundle_adjustment(
                prob, self.camera, self._bf_dev, self.mesh, iters=MESH_BA_ITERS)
            write_back(m, meta, BAResult(poses, points, inlier, chi2), drop_outliers=True)
            # a cost fetch before the LM loop and one per iteration, then the result's
            self.stats.record_count("lm_device_fetches", MESH_BA_ITERS + 2)
        else:
            res = convert.ba_result_to_numpy(local_bundle_adjustment(
                prob, self.camera, self._bf_dev, mono_edges_only=self.monocular))
            write_back(m, meta, res)
            # steps rejected under the behind-the-camera rule (ROADMAP F24)
            self.stats.record_count("lm_ba_steps_rejected", res["n_rejected"])
            self.stats.record_count("lm_device_fetches", 1)
        self.stats.record_count("lm_local_bas", 1)

    # ------------------------------------------------------- inertial backend
    def _temporal_chain(self, kf: KeyFrame, max_len: int = 64):
        """Walk prev_kf_id links back from ``kf`` (oldest first)."""
        m = self.atlas.current
        chain = [kf]
        cur = kf
        while cur.prev_kf_id is not None and len(chain) < max_len:
            prev = m.keyframes.get(cur.prev_kf_id)
            if prev is None:
                break
            chain.append(prev)
            cur = prev
        chain.reverse()
        return chain

    def _sync_tracker_anchor(self, last: KeyFrame, bias=None):
        """Hand the tracker its new IMU anchor when `last` is its last
        keyframe: the body state of `last` and, if given, the biases."""
        t = self.tracker
        if t is None or last.kid != t.last_kf_id:
            return
        R_wb, p_w = _body_from_cam_np(last.R_cw, last.t_cw, self._R_bc, self._t_bc)
        t.last_kf_state = (R_wb, p_w, np.asarray(last.velocity))
        if bias is not None:
            t.bias = (np.asarray(bias[0]), np.asarray(bias[1]))
        return t

    def _try_initialize_imu(self, kf: KeyFrame, min_span_s: float = 2.0):
        """LocalMapping::InitializeIMU (LocalMapping.cc:1173): once enough
        keyframes with preintegration exist, estimate gyro bias, gravity
        and velocities in closed form (imu.init.initialize_imu replaces
        InertialOptimization, Optimizer.cc:3042), align the map gravity to
        -z via ApplyScaledRotation, and hand the state back to the
        tracker."""
        m = self.atlas.current
        chain = self._temporal_chain(kf)
        chain = [k for k in chain if k.kid == chain[0].kid or k.preintegrated is not None]
        if len(chain) < self.imu_init_kfs:
            return
        if chain[-1].timestamp - chain[0].timestamp < min_span_s:
            return
        R_wb, p_w, preints = [], [], []
        for i, k in enumerate(chain):
            Rb, pb = _body_from_cam_np(k.R_cw, k.t_cw, self._R_bc, self._t_bc)
            R_wb.append(Rb)
            p_w.append(pb)
            if i > 0:
                preints.append(k.preintegrated)
        # First init: acc bias pinned to zero, as the JAX package does it.
        # That is ORB-SLAM3's monocular branch (priorA=1e10 at its first
        # InitializeIMU call, LocalMapping.cc:181), which a monocular map
        # takes; for stereo the reference uses priorA=1e5, a strong but
        # finite prior (ROADMAP F11), kept so for parity: over a 2 s window
        # ba is nearly degenerate with gravity's direction. A monocular map
        # also solves its scale.
        res = initialize_imu(R_wb, p_w, preints, mono_scale=self.monocular,
                             estimate_ba=False)
        if not res.success:
            return
        # Align gravity (and the scale): world' = s * R_gw * world.
        scale = res.scale if self.monocular else 1.0
        # a monocular map's points turn and scale their normals and
        # distances with it (ROADMAP F36)
        m.apply_scaled_rotation(res.R_gw, scale, move_normals=self.monocular)
        if self.monocular:
            self._move_tracker_frames(m, res.R_gw, scale)
        for i, k in enumerate(chain):
            # the solved velocities are metric already: the scale sits on
            # the visual positions (ROADMAP F34; the JAX package scales them
            # again)
            k.velocity = res.R_gw @ res.velocities[i]
            k.imu_bias = (res.bg.copy(), res.ba.copy())
        m.imu_initialized = True
        self.imu_init_time = kf.timestamp
        m.info_changed()
        self.stats.record_count("lm_imu_inits", 1)
        self.stats.record("lm_imu_init_scale", scale)
        t = self._sync_tracker_anchor(chain[-1], (res.bg.copy(), res.ba.copy()))
        if t is not None:
            # The running since-KF preintegration is kept: its bias
            # linearization point is corrected via the stored Jacobians.
            t.v_w = np.asarray(chain[-1].velocity)
        # VIBA: polish the freshly initialized window with an inertial BA
        # (the reference's FullInertialBA after init, LocalMapping.cc:181-242).
        self._local_inertial_ba(kf)

    def _scale_refinement(self, kf: KeyFrame):
        """LocalMapping::ScaleRefinement (LocalMapping.cc:1429): re-estimate
        a monocular map's scale (and gravity direction) in closed form over
        the recent temporal chain; apply them only when the correction is
        non-trivial (|s - 1| > 0.002, the reference's gate). Velocities are
        in map units here, so they take the scale."""
        m = self.atlas.current
        chain = self._temporal_chain(kf, max_len=64)
        chain = [k for i, k in enumerate(chain) if i == 0 or k.preintegrated is not None]
        if len(chain) < self.imu_init_kfs:
            return
        R_wb, p_w, preints = [], [], []
        for i, k in enumerate(chain):
            Rb, pb = _body_from_cam_np(k.R_cw, k.t_cw, self._R_bc, self._t_bc)
            R_wb.append(Rb)
            p_w.append(pb)
            if i > 0:
                preints.append(k.preintegrated)
        res = initialize_imu(R_wb, p_w, preints, mono_scale=True)
        # every solve's scale, and whether it was applied
        self.stats.record("lm_scale_refinement_scale", res.scale if res.success else np.nan)
        applied = res.success and abs(res.scale - 1.0) > 0.002
        self.stats.record_count("lm_scale_applied", int(applied))
        if not applied:
            return
        m.apply_scaled_rotation(res.R_gw, res.scale, scale_velocities=True, move_normals=True)
        self._move_tracker_frames(m, res.R_gw, res.scale)
        self._sync_tracker_anchor(chain[-1])
        m.info_changed()

    def _move_tracker_frames(self, m, R_gw, scale):
        """The tracker's frames of this map into the world a monocular
        map's new scale and gravity direction put it in (ROADMAP F37)."""
        if self.tracker is not None and m.keyframes:
            since = min(k.timestamp for k in m.keyframes.values())
            self.tracker.transform_trajectory(R_gw, scale, since)

    def _local_inertial_ba(self, kf: KeyFrame, window: int = 8):
        """Optimizer::LocalInertialBA (Optimizer.cc:2383): temporal window of
        recent KFs with per-KF (pose, velocity, bias) states, inertial edges
        between consecutive KFs, visual edges to the window's map points,
        and FIXED out-of-window anchor KFs observing those points (the
        reference's lFixedKeyFrames, Optimizer.cc:2446-2475). Without the
        anchors the window is tied to the rest of the map only through the
        single gauge KF, and every call can warp the recent map with a
        window-wide pose/bias shift."""
        chain = self._temporal_chain(kf, max_len=window + 1)
        self._inertial_window_ba(chain, window, n_anchors=4)

    def _full_inertial_ba(self, kf: KeyFrame, window: int = 8, should_abort=None, lock=None):
        """Optimizer::FullInertialBA (Optimizer.cc:392), staged from
        LocalMapping.cc:181-242: polish the WHOLE temporal chain after IMU
        initialization as overlapping fixed-shape inertial windows swept
        along the chain (each window anchors on the previous window's last
        optimized state), like the visual global BA's block sweeps.
        `should_abort` is polled between windows; with a `lock` each window
        takes it (the post-loop global BA on its own thread), without one
        the caller holds the map."""
        hold = (lambda: lock) if lock is not None else contextlib.nullcontext
        with hold():
            chain = self._temporal_chain(kf, max_len=100000)
        self.stats.record_count("lm_full_inertial_bas", 1)
        if len(chain) <= window + 1:
            with hold():
                self._inertial_window_ba(chain, window)
            return
        step = max(window - 1, 1)
        for start in range(0, len(chain) - 2, step):
            if should_abort is not None and should_abort():
                return
            seg = chain[start:start + window + 1]
            if len(seg) >= 3:
                with hold():
                    self._inertial_window_ba(seg, window)

    def full_inertial_ba_converged(self, kf: KeyFrame, window: int = 8, max_rounds: int = 4,
                                   tol: float = 1e-4, should_abort=None, lock=None) -> int:
        """Iterate the forward window sweep until the chain stops moving: the
        swept approximation of the reference's single joint FullInertialBA
        solve (Optimizer.cc:392). One forward pass only carries a loop
        correction a window at a time, so the sweep repeats until the
        largest pose change across the chain falls under `tol` (or
        `max_rounds`). The inertial branch of the post-loop global BA
        (LoopClosing.cc:2275-2280). Returns the number of sweeps run."""
        rounds = 0
        for _ in range(max_rounds):
            if should_abort is not None and should_abort():
                break
            chain = self._temporal_chain(kf, max_len=100000)
            before = {k.kid: (k.R_cw.copy(), k.t_cw.copy()) for k in chain}
            self._full_inertial_ba(kf, window, should_abort=should_abort, lock=lock)
            rounds += 1
            delta = 0.0
            for k in chain:
                R0, t0 = before[k.kid]
                delta = max(delta, float(np.abs(k.t_cw - t0).max()),
                            float(np.abs(k.R_cw - R0).max()))
            if delta < tol:
                break
        return rounds

    def _inertial_window_ba(self, chain, window: int = 8, n_anchors: int = 0):
        """One inertial window: `chain`'s last window + 1 keyframes (the
        oldest fixed as the gauge), front-padded to n_anchors + window + 1
        states so every window has one shape; the padding's first slots
        hold up to `n_anchors` fixed out-of-window keyframes with visual
        observations only. One upload, one solve, one fetch; the free
        states and the points are written back. Records its host time as
        `lm_inertial_window` (ms)."""
        t_start = time.perf_counter()
        m = self.atlas.current
        # need contiguous preintegration between all consecutive pairs
        usable = [chain[0]]
        for k in chain[1:]:
            if k.preintegrated is None:
                usable = [k]
            else:
                usable.append(k)
        chain = usable
        if len(chain) < 3:
            return
        K = n_anchors + window + 1
        chain = chain[-(window + 1):]
        n_real = len(chain)
        pad = K - n_real
        R_bc, t_bc = self._R_bc, self._t_bc

        R_wb = np.tile(np.eye(3), (K, 1, 1))
        p_w = np.zeros((K, 3))
        v_w = np.zeros((K, 3))
        bg = np.zeros((K, 3))
        ba = np.zeros((K, 3))
        for i, k in enumerate(chain):
            R_wb[pad + i], p_w[pad + i] = _body_from_cam_np(k.R_cw, k.t_cw, R_bc, t_bc)
            v_w[pad + i] = k.velocity if k.velocity is not None else 0.0
            if k.imu_bias is not None:
                bg[pad + i], ba[pad + i] = k.imu_bias
        # padding + oldest real KF fixed (gauge); all others free
        state_free = np.ones(K, bool)
        state_free[:pad + 1] = False

        # the K-1 preintegrations between consecutive states, the padding's
        # as identities with a tiny covariance (their edges are masked out)
        pres = [chain[i + 1].preintegrated for i in range(n_real - 1)]
        z3, z33 = np.zeros(3), np.zeros((3, 3))
        pad_fields = dict(dT=0.0, dR=np.eye(3), dV=z3, dP=z3, JRg=z33, JVg=z33, JVa=z33,
                          JPg=z33, JPa=z33, C=np.eye(15) * 1e-6)
        pre = types.SimpleNamespace(**{
            f: np.stack([np.asarray(d, np.float64) for d in [v] * pad
                         + [getattr(p, f) for p in pres]])
            for f, v in pad_fields.items()
        })
        pre.b0 = types.SimpleNamespace(
            bg=np.stack([z3] * pad + [np.asarray(p.b0.bg, np.float64) for p in pres]),
            ba=np.stack([z3] * pad + [np.asarray(p.b0.ba, np.float64) for p in pres]),
        )
        pre_valid = np.zeros(K - 1, bool)
        pre_valid[pad:] = True

        # Visual observations over the window (same packing as _local_ba,
        # smaller point cap: the temporal window is narrower).
        L = INERTIAL_BA_POINTS
        kf_index = {k.kid: pad + j for j, k in enumerate(chain)}
        mp_ids = []
        seen = set()
        dropped = 0
        for k in chain:
            for mid in k.mp_ids:
                if mid >= 0 and int(mid) not in seen:
                    mp = m.mappoints.get(int(mid))
                    if mp is not None and not mp.bad:
                        seen.add(int(mid))
                        if len(mp_ids) < L:
                            mp_ids.append(int(mid))
                        else:
                            dropped += 1
        if dropped:
            logging.getLogger(__name__).info(
                "local_inertial_ba: window overflow, dropped %d points (cap %d)",
                dropped, L,
            )
        if n_anchors > 0:
            # Fixed frontier (Optimizer.cc:2446-2475 lFixedKeyFrames): the
            # out-of-window KFs observing the most window points occupy the
            # first padded slots, visual edges only, state_free False.
            chain_ids = {k.kid for k in chain}
            votes: dict[int, int] = {}
            for mid in mp_ids:
                for kid in m.mappoints[mid].observations:
                    if kid not in chain_ids and kid in m.keyframes:
                        votes[kid] = votes.get(kid, 0) + 1
            top = sorted(votes, key=lambda k: -votes[k])[:min(n_anchors, pad)]
            for j, kid in enumerate(top):
                ak = m.keyframes[kid]
                R_wb[j], p_w[j] = _body_from_cam_np(ak.R_cw, ak.t_cw, R_bc, t_bc)
                kf_index[kid] = j

        pts = np.zeros((L, 3))
        pt_free = np.zeros(L, bool)
        obs_uv = np.zeros((L, K, 2))
        obs_ur = np.full((L, K), -1.0)
        inv_s2 = np.ones((L, K))
        mask = np.zeros((L, K), bool)
        for li, mid in enumerate(mp_ids):
            mp = m.mappoints[mid]
            pts[li] = mp.position
            pt_free[li] = True
            for kid, fi in mp.observations.items():
                j = kf_index.get(kid)
                if j is None:
                    continue
                kkf = m.keyframes[kid]
                if fi >= len(kkf.kp_uv) or not kkf.valid[fi]:
                    continue
                obs_uv[li, j] = kkf.kp_uv[fi]
                obs_ur[li, j] = kkf.u_right[fi]
                inv_s2[li, j] = self.inv_sigma2[kkf.kp_level[fi]]
                mask[li, j] = True

        # the window is packed as the JAX package packs it (float32) and
        # solved in INERTIAL_SOLVE_DTYPE
        f32 = np.float32
        prob = convert.inertial_ba_problem_from_numpy(dict(
            R_wb=R_wb.astype(f32), p_w=p_w.astype(f32), v_w=v_w.astype(f32),
            bg=bg.astype(f32), ba=ba.astype(f32), state_free=state_free, pre=pre,
            pre_valid=pre_valid, points=pts.astype(f32), point_free=pt_free,
            obs_uv=obs_uv.astype(f32), obs_ur=obs_ur.astype(f32),
            inv_sigma2=inv_s2.astype(f32), mask=mask,
        ), device=self.device, dtype=INERTIAL_SOLVE_DTYPE)
        res = local_inertial_ba(prob, self.camera, self._bf_dev, self._Rbc_dev, self._tbc_dev,
                                mono_edges_only=self.monocular)
        *fetched, n_flipped = device_fetch(*res.states, res.points, res.n_flipped)
        R_new, p_new, v_new, bg_new, ba_new, pts_new = (a.astype(np.float64) for a in fetched)
        # steps that would have moved a live observation behind its camera
        # (rejected in a monocular map's window, ROADMAP F24)
        self.stats.record_count("lm_inertial_steps_flipped", int(n_flipped))
        self.stats.record_count("lm_device_fetches", 1)
        self.stats.record_count("lm_inertial_bas", 1)

        R_cb = R_bc.T
        t_cb = -R_cb @ t_bc
        for i, k in enumerate(chain):
            j = pad + i
            if not state_free[j]:
                continue
            if not (np.isfinite(R_new[j]).all() and np.isfinite(p_new[j]).all()):
                continue
            Rwb = orthonormalize(R_new[j])
            R_cw = R_cb @ Rwb.T
            k.set_pose(R_cw, t_cb - R_cw @ p_new[j])
            if np.isfinite(v_new[j]).all():
                k.velocity = v_new[j]
            k.imu_bias = (bg_new[j], ba_new[j])
        for li, mid in enumerate(mp_ids):
            mp = m.mappoints.get(mid)
            if mp is not None and np.isfinite(pts_new[li]).all():
                mp.position = pts_new[li]
        # refresh the tracker's anchor if the window moved its reference KF
        self._sync_tracker_anchor(chain[-1], chain[-1].imu_bias)
        m.info_changed()
        self.stats.record("lm_inertial_window", (time.perf_counter() - t_start) * 1e3)

    def _cull_keyframes(self, kf: KeyFrame):
        """KeyFrameCulling (LocalMapping.cc:902): erase local KFs whose map
        points are >=90% observed by >=3 other KFs at same/finer scale.

        Inertial mode (LocalMapping.cc:935-1007): the temporal prev/next
        chain carries the preintegration constraints, so culling is
        suppressed until the IMU is initialized, and afterwards a KF is only
        erased when its removal keeps the chain dense (gap < 3 s); its
        preintegration is merged into the next KF (ImuTypes::MergePrevious).
        As in the JAX package, a link to keyframe 0 counts as no link."""
        m = self.atlas.current
        inertial = self.imu_calib is not None
        if inertial and not m.imu_initialized:
            return
        for kid in kf.best_covisible(10):
            other = m.keyframes.get(kid)
            if other is None or other.kid == m.init_kf_id:
                continue
            if inertial:
                prev = m.keyframes.get(other.prev_kf_id) if other.prev_kf_id else None
                nxt = m.keyframes.get(other.next_kf_id) if other.next_kf_id else None
                if prev is None or nxt is None:
                    continue
                if nxt.timestamp - prev.timestamp > 3.0:
                    continue
            total = 0
            redundant = 0
            for fi, mid in enumerate(other.mp_ids):
                if mid < 0:
                    continue
                mp = m.mappoints.get(int(mid))
                if mp is None or mp.bad:
                    continue
                total += 1
                level = int(other.kp_level[fi])
                n_better = 0
                for okid, ofi in mp.observations.items():
                    if okid == other.kid:
                        continue
                    okf = m.keyframes.get(okid)
                    if okf is None:
                        continue
                    if int(okf.kp_level[ofi]) <= level + 1:
                        n_better += 1
                        if n_better >= 3:
                            break
                if n_better >= 3:
                    redundant += 1
            if total > 20 and redundant > 0.9 * total:
                if inertial:
                    prev = m.keyframes.get(other.prev_kf_id)
                    nxt = m.keyframes.get(other.next_kf_id)
                    if prev is not None and nxt is not None:
                        if other.preintegrated is not None and nxt.preintegrated is not None:
                            nxt.preintegrated = _merge_preintegrated(
                                other.preintegrated, nxt.preintegrated
                            )
                        prev.next_kf_id = nxt.kid
                        nxt.prev_kf_id = prev.kid
                m.erase_keyframe(other.kid)
                self.stats.record_count("lm_keyframes_culled", 1)


def fuse_mappoints_into(m, tkf, mids, camera, scale_factor: float,
                        n_levels: int, th: float = 3.0, device=None,
                        stats: Stats | None = None) -> int:
    """ORBmatcher::Fuse (ORBmatcher.cc:1247): project map points into
    ``tkf``, window-search a matching keypoint under TH_LOW, then either
    merge with the keypoint's bound point (keep the better-observed one,
    MapPoint::Replace) or add a new observation. Shared by
    LocalMapping::SearchInNeighbors (LocalMapping.cc:714) and the loop
    closer's SearchAndFuse (LoopClosing.cc:2115).

    The search is exact: the full Hamming matrix of the candidate points
    against the keyframe's keypoints, from ONE launch of the matrix kernel on
    `device` (None: the card), and one fetch of (idx, dist, hit). `camera` is
    a Camera or its host copy (cameras.host.HostCamera)."""
    if not mids:
        return 0
    cam = camera if isinstance(camera, HostCamera) else host_camera(camera)
    mps = []
    for mid in mids:
        mp = m.mappoints.get(int(mid))
        if (
            mp is not None and not mp.bad and mp.desc_packed is not None
            and tkf.kid not in mp.observations
        ):
            mps.append(mp)
    if not mps:
        return 0
    pos = np.asarray([mp.position for mp in mps])
    Xc = pos @ tkf.R_cw.T + tkf.t_cw
    uv = project_np(cam, Xc)
    dist = np.linalg.norm(Xc, axis=1)
    normals = np.asarray([mp.normal for mp in mps])
    view = pos - tkf.center
    view_n = view / np.maximum(np.linalg.norm(view, axis=1, keepdims=True), 1e-9)
    min_d = np.asarray([0.8 * mp.min_distance for mp in mps])
    max_d = np.asarray([1.2 * mp.max_distance for mp in mps])
    ok = (
        frustum_depth_ok(cam, Xc)
        & in_image_np(cam, uv)
        & (dist >= min_d) & (dist <= max_d)
        & (np.sum(normals * view_n, axis=1) > 0.5)
    )
    if not ok.any():
        return 0
    levels = np.asarray([
        mp.predict_scale(float(d), scale_factor, n_levels)
        for mp, d in zip(mps, dist)
    ], np.int32)
    radius = (th * scale_factor**levels).astype(np.float32)
    # query block [u, v, radius, level_min, level_max, ok] and keypoint block
    # [u, v, level, valid]: two f32 uploads beside the two descriptor arrays
    q6 = np.stack([
        uv[:, 0], uv[:, 1], radius,
        np.maximum(levels - 1, 0), np.minimum(levels + 1, n_levels - 1), ok,
    ], axis=1).astype(np.float32)
    k4 = np.concatenate([
        tkf.kp_uv.astype(np.float32), tkf.kp_level[:, None].astype(np.float32),
        tkf.valid[:, None].astype(np.float32),
    ], axis=1)
    device = resolve(device)

    def up(a, dtype):
        return convert.tensor_from_numpy(a, dtype, device)

    q6_d, k4_d = up(q6, np.float32), up(k4, np.float32)
    idx_d, dist_d, hit_d = search_by_projection_exact(
        q6_d[:, :2], up(np.asarray([mp.desc_signed for mp in mps]), np.int8), q6_d[:, 2],
        q6_d[:, 3].to(torch.int32), q6_d[:, 4].to(torch.int32), q6_d[:, 5] > 0.5,
        k4_d[:, :2], up(tkf.desc_signed, np.int8),
        k4_d[:, 2].to(torch.int32), k4_d[:, 3] > 0.5,
        max_dist=TH_LOW,  # fusion requires a strong match
    )
    idx, _, hit = device_fetch(idx_d, dist_d, hit_d)
    if stats is not None:
        stats.record_count("lm_fuse_searches", 1)
        stats.record_count("lm_device_fetches", 1)
    n_fused = 0
    for q in np.where(hit)[0]:
        mp = mps[q]
        if mp.bad:
            continue
        i = int(idx[q])
        cur = int(tkf.mp_ids[i])
        if cur >= 0:
            other = m.mappoints.get(cur)
            if other is None or other.bad or other.mid == mp.mid:
                continue
            # keep the better-observed point (ORBmatcher.cc:1330-1338)
            if other.n_obs() >= mp.n_obs():
                m.replace_mappoint(mp.mid, other.mid)
            else:
                m.replace_mappoint(other.mid, mp.mid)
        else:
            mp.add_observation(tkf.kid, i)
            tkf.mp_ids[i] = mp.mid
        n_fused += 1
    return n_fused

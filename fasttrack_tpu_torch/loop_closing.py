"""Loop closing and the Atlas map merge (src/LoopClosing.cc).

Port of fasttrack_tpu/loop_closing.py. Per keyframe (LoopClosing::Run
:90-309): a BoW place query over every Atlas map that excludes the
covisible neighbourhood, temporal consistency, geometric verification by
descriptor matching and Sim3/SE3 RANSAC (NewDetectCommonRegions ->
DetectCommonRegionsFromBoW, :324/:578). A candidate in the active map runs
CorrectLoop (:969): the Sim3 correction propagated over the current
covisible group, duplicate map points fused, the essential graph optimized
and the global BA run; in a map marked inertial (`Map.is_inertial`, which
no live run sets, here or in the JAX package: ROADMAP F16) and IMU-initialized,
the gravity-preserving 4-DoF graph and the mapper's converged full
inertial BA. A candidate in another map welds the active map into it (MergeLocal,
:1215): the whole map moves through the world-to-world Sim3, duplicates
are fused both ways, the essential graph relaxes the union, the old map
becomes current and the emptied one leaves the Atlas.

Synchronous by default (every keyframe processed when it is inserted, the
global BA inline); with `run_async=True` a loop-closer thread takes the
keyframes from a queue under the map lock, and each global BA runs on a
thread of its own that takes the map lock per block and is aborted by a
newer correction (LoopClosing.cc:2268-2512). An exception on either thread
is logged and counted in `n_thread_errors`.

What runs on the device: the descriptor match of the two keyframes' map
points (`match_fisheye`, one launch of the fused Hamming top-K kernel at
K = 2), the flat vocabulary's quantization (K = 1; the shipped tree
vocabulary is quantized on the host), the Sim3 refinement
(optim.sim3_opt), the fusion searches (one launch of the matrix kernel per
target keyframe, local_mapping.fuse_mappoints_into) and the global BA's
windows (ba_assembly.global_bundle_adjustment, float64 as the local BA).
The projection search of SearchBySim3 and the essential graphs run on the
host, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading

import numpy as np

from fasttrack_tpu_torch import convert
from fasttrack_tpu_torch.ba_assembly import global_bundle_adjustment
from fasttrack_tpu_torch.bow import KeyFrameDatabase
from fasttrack_tpu_torch.bow.vocabulary import quantize
from fasttrack_tpu_torch.cameras.host import (
    frustum_depth_ok,
    host_camera,
    in_image_np,
    project_np,
)
from fasttrack_tpu_torch.device import resolve
from fasttrack_tpu_torch.local_mapping import fuse_mappoints_into
from fasttrack_tpu_torch.nputils import device_fetch, orthonormalize
from fasttrack_tpu_torch.ops.host_kernels import host_search_by_projection
from fasttrack_tpu_torch.ops.stereo_match import match_fisheye
from fasttrack_tpu_torch.optim.pose_graph import (
    optimize_essential_graph,
    optimize_essential_graph_4dof,
    sim3_inv,
    sim3_mul,
)
from fasttrack_tpu_torch.optim.sim3_opt import optimize_sim3
from fasttrack_tpu_torch.optim.sim3_solver import solve_sim3
from fasttrack_tpu_torch.slam_map import Atlas, KeyFrame


class LoopCloser:
    def __init__(
        self,
        atlas: Atlas,
        vocabulary,
        K: np.ndarray,            # 3x3 intrinsics (pinhole assumption for verification)
        scale_factor: float = 1.2,
        fix_scale: bool = True,   # stereo/RGBD/inertial: scale is observable
        min_consistency: int = 3, # consecutive-detection requirement
                                  # (LoopClosing.h mnCovisibilityConsistencyTh=3:
                                  # suppresses false loops on repetitive scenes)
        run_async: bool = False,
        run_gba: bool = True,
        camera=None,              # cameras.models.Camera (enables GBA + fuse)
        bf: float = 0.0,
        n_levels: int = 8,
        device=None,              # None: the card (device.resolve); "cpu" for the CPU
    ):
        self.device = resolve(device)
        self.atlas = atlas
        self.voc = vocabulary
        self.K = K
        self.scale_factor = scale_factor
        self.fix_scale = fix_scale
        self.min_consistency = min_consistency
        self.db = KeyFrameDatabase()
        self._consistency: dict[int, int] = {}  # candidate group -> count
        self.n_loops_closed = 0
        self.n_maps_merged = 0
        self.n_gba_runs = 0
        self.n_thread_errors = 0  # exceptions on the loop-closer and GBA threads
        self.last_loop_kf_id = -1
        self.run_gba = run_gba
        self.camera = None
        self._cam_host = None
        if camera is not None:
            self.camera = dataclasses.replace(camera, params=camera.params.to(self.device))
            self._cam_host = host_camera(camera)
        self.bf = float(bf)
        self.n_levels = n_levels
        self.inv_sigma2 = 1.0 / (scale_factor ** (2 * np.arange(n_levels)))
        self.abort_gba = False    # mbStopGBA: a new KF interrupts a running GBA
        self._gba_thread = None   # RunGlobalBundleAdjustment thread
        self.run_async = run_async
        self._queue: queue.Queue = queue.Queue()
        self._stop = False
        self._thread = None
        if run_async:
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._thread.start()

    def insert_keyframe(self, kf: KeyFrame):
        self.abort_gba = True  # LoopClosing.cc InsertKeyFrame sets mbStopGBA
        if self.run_async:
            self._queue.put(kf.kid)
        else:
            self.process_keyframe(kf.kid)

    def stop(self):
        """System::Shutdown's RequestFinish: abort and join a running global
        BA (30 s), then end and join the loop-closer thread (10 s), and a
        global BA its last keyframe may have started. Keyframes still queued
        are not processed, as in the JAX package."""
        self._stop = True
        self._join_gba()
        if self._thread is not None:
            self._queue.put(None)
            self._thread.join(timeout=10)
            self._join_gba()

    def _join_gba(self):
        if self._gba_thread is not None and self._gba_thread.is_alive():
            self.abort_gba = True
            self._gba_thread.join(timeout=30)

    def _thread_failed(self, what: str):
        self.n_thread_errors += 1
        logging.getLogger(__name__).exception("%s failed", what)

    def _start_gba(self, fixed_kf_ids=None):
        """Run the post-loop or post-merge global BA: inline when
        synchronous; when async, on a thread of its own that takes the map
        lock per block (the reference's spawned RunGlobalBundleAdjustment,
        LoopClosing.cc:969 -> :2268), so the closer keeps taking keyframes
        and tracking never waits for the whole BA. A newer correction
        aborts and joins the running one (mbStopGBA)."""
        if not self.run_async:
            self._run_global_ba(fixed_kf_ids)
            return
        self._join_gba()
        m = self.atlas.current

        def worker():
            try:
                self._run_global_ba(fixed_kf_ids, lock=m.lock)
            except Exception:
                self._thread_failed("the global BA thread")

        self._gba_thread = threading.Thread(target=worker, daemon=True)
        self._gba_thread.start()

    def _run(self):
        """The loop-closer thread. An exception ends it, as in the JAX
        package, and is logged and counted."""
        try:
            while not self._stop:
                kid = self._queue.get()
                if kid is None:
                    break
                with self.atlas.current.lock:
                    self.process_keyframe(kid)
        except Exception:
            self._thread_failed("the loop-closer thread")

    # ------------------------------------------------------------------ core
    @staticmethod
    def _transform_velocity(g: KeyFrame, S):
        """Rotate and scale a keyframe's world-frame velocity through a
        world-side Sim3 correction x' = s R x + t (LoopClosing.cc:1053-1063);
        visual keyframes carry none."""
        if g.velocity is not None:
            sc, Rc, _ = S
            g.velocity = sc * (Rc @ np.asarray(g.velocity, np.float64))

    def _optimize_graph(self, m, poses, edges, fixed):
        """The gravity-preserving 4-DoF graph for an IMU-initialized map
        (LoopClosing.cc:295-300 -> Optimizer.cc:5292), the Sim3/SE3 graph
        (Optimizer::OptimizeEssentialGraph) otherwise."""
        if m.is_inertial and m.imu_initialized:
            return optimize_essential_graph_4dof(poses, edges, fixed)
        return optimize_essential_graph(
            poses, edges, fixed, fix_scale=self.fix_scale, iterations=10
        )

    def _refresh_tracker_anchor(self, m):
        """Re-derive the tracker's last-keyframe body state from the
        corrected keyframe (the reference's mbMapUpdated re-anchor:
        PredictStateIMU must start from the corrected pose and velocity)."""
        tracker = getattr(self, "tracker", None)
        if tracker is None or not tracker.use_imu:
            return
        kid = tracker.last_kf_id
        kf = m.keyframes.get(kid) if kid is not None else None
        if kf is None or kf.velocity is None:
            return
        R_wb, p_w = tracker._body_from_cam(kf.R_cw, kf.t_cw)
        tracker.last_kf_state = (R_wb, p_w, np.asarray(kf.velocity, np.float64))
        tracker.v_w = np.asarray(kf.velocity, np.float64)

    def _bow(self, kf: KeyFrame) -> dict:
        if kf.bow_vec is None:
            _, kf.bow_vec = quantize(self.voc, kf.desc_signed, kf.valid, device=self.device)
        return kf.bow_vec

    def _find_kf(self, kid: int):
        """Locate a keyframe across all Atlas maps -> (map, kf) or (None, None)."""
        for mm in self.atlas.maps:
            kf = mm.keyframes.get(kid)
            if kf is not None:
                return mm, kf
        return None, None

    def process_keyframe(self, kf_id: int) -> bool:
        """Returns True if a loop was closed (or a map merge welded) on this
        keyframe. Candidates are searched across all Atlas maps
        (NewDetectCommonRegions, LoopClosing.cc:324): one in the active map
        triggers CorrectLoop; one in another map triggers the Atlas merge
        (MergeLocal, LoopClosing.cc:1215)."""
        m = self.atlas.current
        kf = m.keyframes.get(kf_id)
        if kf is None:
            return False
        bow = self._bow(kf)

        # 1) candidates excluding the covisible neighbourhood; the grouping
        # resolves lazily per scored candidate
        connected = set(kf.covisible) | {kf_id}

        def covis_of(k):
            _, kkf = self._find_kf(k)
            return list(kkf.covisible) if kkf is not None else []

        cands = self.db.detect_loop_candidates(
            bow, kf_id, connected, covisible=covis_of, n_best=3
        )
        closed = False
        # Temporal consistency (LoopClosing::DetectLoop consistent groups,
        # LoopClosing.cc:524-580): a candidate group only advances the count
        # when it extends a group detected on the previous keyframe; groups
        # not re-detected are dropped, so `min_consistency` really means
        # consecutive detections, as in mnCovisibilityConsistencyTh.
        new_consistency: dict[int, int] = {}
        for cand_id in cands:
            cand_map, cand = self._find_kf(cand_id)
            if cand is None:
                continue
            group = set(cand.covisible) | {cand_id}
            hit = max(
                (self._consistency.get(g, 0) for g in group), default=0
            ) + 1
            for g in group:
                new_consistency[g] = max(new_consistency.get(g, 0), hit)
            if hit < self.min_consistency:
                continue
            if cand_map is m:
                done = self._verify_and_correct(kf, cand_id)
            else:
                done = self._merge_maps(kf, m, cand_map, cand)
            if done:
                closed = True
                new_consistency.clear()
                break

        self._consistency = new_consistency
        self.db.add(kf_id, bow)
        return closed

    def _matched_points(self, kf: KeyFrame, m1, cand: KeyFrame, m2):
        """Descriptor-match the bound map points of both keyframes (one
        launch of the top-K kernel at K = 2, one fetch); return camera-frame
        coordinates and observations for the Sim3 solve."""
        bound_c = np.where(kf.mp_ids >= 0)[0]
        bound_l = np.where(cand.mp_ids >= 0)[0]
        if len(bound_c) < 20 or len(bound_l) < 20:
            return None

        def up(a, dtype):
            return convert.tensor_from_numpy(a, dtype, self.device)

        res = match_fisheye(
            up(kf.desc_signed[bound_c], np.int8), up(np.ones(len(bound_c), bool), np.bool_),
            up(cand.desc_signed[bound_l], np.int8), up(np.ones(len(bound_l), bool), np.bool_),
            ratio=0.75,
        )
        idx_right, ok = device_fetch(res.idx_right, res.valid)
        if ok.sum() < 20:
            return None
        ic = bound_c[ok]
        il = bound_l[idx_right[ok]]
        X1, X2, uv1, uv2, s1, s2 = [], [], [], [], [], []
        for a, b in zip(ic, il):
            mp1 = m1.mappoints.get(int(kf.mp_ids[a]))
            mp2 = m2.mappoints.get(int(cand.mp_ids[b]))
            if mp1 is None or mp2 is None or mp1.bad or mp2.bad:
                continue
            X1.append(kf.R_cw @ mp1.position + kf.t_cw)
            X2.append(cand.R_cw @ mp2.position + cand.t_cw)
            uv1.append(kf.kp_uv[a])
            uv2.append(cand.kp_uv[b])
            s1.append(self.scale_factor ** (2 * int(kf.kp_level[a])))
            s2.append(self.scale_factor ** (2 * int(cand.kp_level[b])))
        if len(X1) < 20:
            return None
        return (np.asarray(X1), np.asarray(X2), np.asarray(uv1),
                np.asarray(uv2), np.asarray(s1), np.asarray(s2), ic, il)

    def _search_by_sim3(self, kf: KeyFrame, m1, cand: KeyFrame, m2, res):
        """ORBmatcher::SearchBySim3 (ORBmatcher.cc:1556): expand the loop
        match set by projecting each keyframe's map points into the other
        view through the solved Sim3 and window-matching there (host).
        Returns additional (X1, X2, uv1, uv2, s1, s2) rows for a refined
        solve."""
        s, R, t = res.s, res.R, res.t

        def project_and_match(src_kf, src_map, dst_kf, S):
            sc, Rc, tc = S
            mids = [int(x) for x in src_kf.mp_ids if x >= 0]
            rows = src_map.rows_for(np.asarray(mids, np.int64))
            sel = rows >= 0
            if not sel.any():
                return {}
            mids = np.asarray(mids)[sel]
            pos = src_map.store.pos[rows[sel]]
            packed = src_map.store.desc_packed[rows[sel]]
            # src world -> src cam -> (Sim3) -> dst cam -> dst pixels
            Xs = pos @ src_kf.R_cw.T + src_kf.t_cw
            Xd = sc * (Xs @ Rc.T) + tc
            if self._cam_host is not None:
                uv = project_np(self._cam_host, Xd)
                ok = frustum_depth_ok(self._cam_host, Xd) & in_image_np(self._cam_host, uv)
            else:
                z = Xd[:, 2]
                ok = z > 0.1
                uv = np.stack([
                    self.K[0, 0] * Xd[:, 0] / np.maximum(z, 1e-9) + self.K[0, 2],
                    self.K[1, 1] * Xd[:, 1] / np.maximum(z, 1e-9) + self.K[1, 2],
                ], -1)
                # no Camera: image bounds estimated from the principal point
                w_est, h_est = 2.0 * self.K[0, 2], 2.0 * self.K[1, 2]
                ok &= (uv[:, 0] >= 0) & (uv[:, 0] < w_est) \
                    & (uv[:, 1] >= 0) & (uv[:, 1] < h_est)
            idx, _, hit = host_search_by_projection(
                uv.astype(np.float32), packed,
                np.full(len(mids), 7.5, np.float32),
                np.zeros(len(mids), np.int32),
                np.full(len(mids), self.n_levels - 1, np.int32), ok,
                dst_kf.kp_uv.astype(np.float32), dst_kf.desc_packed,
                dst_kf.kp_level.astype(np.int32), dst_kf.valid,
                max_dist=75,
            )
            return {int(mids[q]): int(idx[q]) for q in np.where(hit)[0]}

        # solve_sim3 returns S12 with X1 = s R X2 + t (cand-cam -> cur-cam),
        # so projecting cand points into the current image applies S12 and
        # current points into the cand image apply S21 (ORBmatcher.cc:1556).
        S12 = (s, R, t)
        S21 = sim3_inv(S12)
        fwd = project_and_match(cand, m2, kf, S12)   # cand points -> current image
        bwd = project_and_match(kf, m1, cand, S21)   # current points -> cand image
        X1, X2, uv1, uv2, s1, s2 = [], [], [], [], [], []

        def add_row(mp1, fi1, mp2, fi2):
            X1.append(kf.R_cw @ mp1.position + kf.t_cw)
            X2.append(cand.R_cw @ mp2.position + cand.t_cw)
            uv1.append(kf.kp_uv[fi1])
            uv2.append(cand.kp_uv[fi2])
            s1.append(self.scale_factor ** (2 * int(kf.kp_level[fi1])))
            s2.append(self.scale_factor ** (2 * int(cand.kp_level[fi2])))

        seen_pairs = set()
        for mid2, fi1 in fwd.items():
            mp2 = m2.mappoints.get(mid2)
            mid1 = int(kf.mp_ids[fi1])
            mp1 = m1.mappoints.get(mid1) if mid1 >= 0 else None
            fi2 = mp2.observations.get(cand.kid) if mp2 is not None else None
            if mp1 is None or mp2 is None or fi2 is None:
                continue
            add_row(mp1, fi1, mp2, int(fi2))
            seen_pairs.add((mp1.mid, mp2.mid))
        for mid1, fi2 in bwd.items():
            mp1 = m1.mappoints.get(mid1)
            mid2 = int(cand.mp_ids[fi2])
            mp2 = m2.mappoints.get(mid2) if mid2 >= 0 else None
            fi1 = mp1.observations.get(kf.kid) if mp1 is not None else None
            if mp1 is None or mp2 is None or fi1 is None:
                continue
            if (mp1.mid, mp2.mid) in seen_pairs:
                continue
            add_row(mp1, int(fi1), mp2, fi2)
        if not X1:
            return None
        return (np.asarray(X1), np.asarray(X2), np.asarray(uv1),
                np.asarray(uv2), np.asarray(s1), np.asarray(s2))

    def _verify_and_correct(self, kf: KeyFrame, cand_id: int) -> bool:
        m = self.atlas.current
        cand = m.keyframes.get(cand_id)
        if cand is None:
            return False
        mp = self._matched_points(kf, m, cand, m)
        if mp is None:
            return False
        X1, X2, uv1, uv2, s1, s2, ic, il = mp
        res = solve_sim3(
            X1, X2, uv1, uv2, self.K, self.K, s1, s2,
            fix_scale=self.fix_scale, min_inliers=20,
        )
        if not res.success:
            return False
        # SearchBySim3 refinement (LoopClosing::DetectCommonRegionsFromBoW
        # second pass): expand matches through the solved Sim3, re-solve.
        extra = self._search_by_sim3(kf, m, cand, m, res)
        Xa, Xb, ua, ub, sa, sb = X1, X2, uv1, uv2, s1, s2
        if extra is not None and len(extra[0]) >= 10:
            Xa = np.concatenate([X1, extra[0]])
            Xb = np.concatenate([X2, extra[1]])
            ua = np.concatenate([uv1, extra[2]])
            ub = np.concatenate([uv2, extra[3]])
            sa = np.concatenate([s1, extra[4]])
            sb = np.concatenate([s2, extra[5]])
            res2 = solve_sim3(
                Xa, Xb, ua, ub, self.K, self.K, sa, sb,
                fix_scale=self.fix_scale, min_inliers=20,
            )
            if res2.success and res2.n_inliers >= res.n_inliers:
                res = res2
        res = self._refine_sim3_lm(Xa, Xb, ua, ub, sa, sb, res)
        self._correct_loop(kf, cand, res)
        return True

    def _refine_sim3_lm(self, X1, X2, uv1, uv2, s1, s2, res):
        """Optimizer::OptimizeSim3 (Optimizer.cc:2115): joint LM over the
        loop Sim3 with both-direction reprojection edges, Huber weights and
        inlier re-toggling, on the device. Keeps the RANSAC result when the
        LM keeps too few inliers."""
        opt = optimize_sim3(
            X1, X2, uv1, uv2, self.K, self.K, s1, s2,
            res.s, res.R, res.t,
            fix_scale=self.fix_scale, min_inliers=max(10, res.n_inliers // 2),
            device=self.device,
        )
        if opt.success:
            return res._replace(s=opt.s, R=opt.R, t=opt.t, n_inliers=opt.n_inliers)
        return res

    def _correct_loop(self, kf: KeyFrame, cand: KeyFrame, res):
        """CorrectLoop (LoopClosing.cc:969): compute the corrected Sim3 of
        the current KF, propagate it to its covisible group, move their map
        points, optimize the essential graph, merge duplicates, then the
        global BA."""
        m = self.atlas.current
        # S12: cand(2) points -> current(1) camera; the corrected current
        # pose is S_cw_corr = S12 * T2w (mScw = gScm * mpMatchedKF->GetPose()).
        s, R, t = res.s, res.R, res.t
        S12 = (s, R, t)
        T2w = (1.0, cand.R_cw, cand.t_cw)
        S_cw_corr = sim3_mul(S12, T2w)

        # World-side correction W with x' = W x, from requiring the corrected
        # current pose to equal S_cw_corr: T1w' = T1w o W^-1 = S_cw_corr
        # =>  W = S_cw_corr^-1 o T1w.
        T1w = (1.0, kf.R_cw.copy(), kf.t_cw.copy())
        corr = sim3_mul(sim3_inv(S_cw_corr), T1w)

        group = [kf.kid] + list(kf.covisible)
        corrected: dict[int, tuple] = {}
        moved_points: set[int] = set()
        for kid in group:
            g = m.keyframes.get(kid)
            if g is None:
                continue
            Tgw = (1.0, g.R_cw.copy(), g.t_cw.copy())
            S_g_corr = sim3_mul(Tgw, sim3_inv(corr))
            corrected[kid] = S_g_corr
            # correct this KF's map points: x' = corr * x
            for mid in g.mp_ids:
                if mid < 0 or int(mid) in moved_points:
                    continue
                p = m.mappoints.get(int(mid))
                if p is None or p.bad:
                    continue
                sc, Rc, tc = corr
                p.position = sc * (Rc @ p.position) + tc
                moved_points.add(int(mid))
        for kid, (sg, Rg, tg) in corrected.items():
            g = m.keyframes[kid]
            g.set_pose(orthonormalize(Rg), tg / sg)
            self._transform_velocity(g, corr)

        kf.loop_edges.add(cand.kid)
        cand.loop_edges.add(kf.kid)

        # Essential graph: spanning tree + loop edges + strong covisibility.
        poses = {
            kid: (1.0, g.R_cw.copy(), g.t_cw.copy())
            for kid, g in m.keyframes.items()
        }
        edges = []
        seen = set()

        def add_edge(a, b):
            if a == b or (min(a, b), max(a, b)) in seen:
                return
            if a not in poses or b not in poses:
                return
            seen.add((min(a, b), max(a, b)))
            Sa, Sb = poses[a], poses[b]
            edges.append((a, b, sim3_mul(Sb, sim3_inv(Sa))))

        for kid, g in m.keyframes.items():
            if g.parent_id is not None:
                add_edge(kid, g.parent_id)
            for le in g.loop_edges:
                add_edge(kid, le)
            for cid, w in g.covisible.items():
                if w >= 100:
                    add_edge(kid, cid)

        optimized = self._optimize_graph(m, poses, edges, {cand.kid})
        # write back poses, and points with their reference keyframe:
        # x' = S_new^-1 * S_old * x
        old_poses = dict(poses)
        for kid, (sg, Rg, tg) in optimized.items():
            g = m.keyframes.get(kid)
            if g is not None:
                g.set_pose(orthonormalize(Rg), tg / sg)
                self._transform_velocity(
                    g, sim3_mul(sim3_inv(optimized[kid]), old_poses[kid])
                )
        for mid, p in m.mappoints.items():
            if p.bad:
                continue
            ref = p.ref_kf_id
            if ref not in old_poses or ref not in optimized:
                continue
            so, Ro, to = old_poses[ref]
            xc = so * (Ro @ p.position) + to
            si, Ri, ti = sim3_inv(optimized[ref])
            p.position = si * (Ri @ xc) + ti

        # SearchAndFuse (LoopClosing.cc:2115): project the loop region's
        # points into the corrected current group and merge duplicates.
        if self.camera is not None:
            loop_mids = [int(x) for x in cand.mp_ids if x >= 0]
            for cid in [cand.kid] + list(cand.covisible)[:10]:
                ckf = m.keyframes.get(cid)
                if ckf is not None:
                    loop_mids.extend(int(x) for x in ckf.mp_ids if x >= 0)
            loop_mids = sorted(set(loop_mids))
            for gid in [kf.kid] + list(kf.covisible)[:10]:
                g = m.keyframes.get(gid)
                if g is not None:
                    fuse_mappoints_into(
                        m, g, loop_mids, self._cam_host,
                        self.scale_factor, self.n_levels, th=4.0, device=self.device,
                    )
            m.update_connections(kf)

        m.info_changed()
        self.n_loops_closed += 1
        self.last_loop_kf_id = kf.kid

        # Bring the tracker's frame-to-frame state into the corrected world:
        # the total world-side correction of the current KF is
        # W_total = S_final^-1 o S_orig (from S_new = S_old o W^-1).
        tracker = getattr(self, "tracker", None)
        if tracker is not None and tracker.last_frame is not None \
                and tracker.last_frame.R_cw is not None:
            S_final = (1.0, kf.R_cw.copy(), kf.t_cw.copy())
            W_total = sim3_mul(sim3_inv(S_final), T1w)
            lf = tracker.last_frame
            sg, Rg, tg = sim3_mul((1.0, lf.R_cw, lf.t_cw), sim3_inv(W_total))
            lf.R_cw = orthonormalize(Rg)
            lf.t_cw = tg / sg
            if lf.v_w is not None:
                sw_, Rw_, _ = W_total
                lf.v_w = sw_ * (Rw_ @ np.asarray(lf.v_w, np.float64))
            tracker.velocity = None  # re-estimate in the corrected frame
        self._refresh_tracker_anchor(m)

        # Global BA (RunGlobalBundleAdjustment, LoopClosing.cc:2268): relax
        # the whole map after the weld; a new keyframe interrupts it.
        if self.run_gba and self.camera is not None:
            self._start_gba(fixed_kf_ids={cand.kid})

    def _run_global_ba(self, fixed_kf_ids=None, lock=None):
        """Whole-map BA after a loop or a merge (LoopClosing.cc:2268-2512).
        Synchronous, the caller holds the map lock; on the GBA thread each
        block takes `lock`. The sweep polls `abort_gba` between its
        fixed-shape blocks (the mbStopGBA protocol). An IMU-initialized map
        gets FullInertialBA instead of the visual BA (LoopClosing.cc:2275-2280
        -> Optimizer.cc:392): the mapper's converged window sweep polishes
        poses, velocities and biases along the temporal chain."""
        self.abort_gba = False
        m = self.atlas.current
        mapper = getattr(self, "local_mapper", None)
        if (m.is_inertial and m.imu_initialized and mapper is not None
                and mapper.imu_calib is not None and m.keyframes):
            latest = m.keyframes[max(m.keyframes)]
            mapper.full_inertial_ba_converged(
                latest, should_abort=lambda: self.abort_gba, lock=lock)
            self._refresh_tracker_anchor(m)
        else:
            global_bundle_adjustment(
                m, self.camera, self.bf, self.inv_sigma2,
                fixed_kf_ids=fixed_kf_ids,
                should_abort=lambda: self.abort_gba, lock=lock, device=self.device,
            )
        self.n_gba_runs += 1

    # ------------------------------------------------------------- map merge
    def _merge_maps(self, kf: KeyFrame, m_new, m_old, cand: KeyFrame) -> bool:
        """Atlas welding (MergeLocal, LoopClosing.cc:1215): the active map
        (created after tracking was lost) overlaps an earlier map. Verify a
        Sim3 between the current keyframe and the old map's candidate,
        move the whole active map into the old map's frame, migrate its
        keyframes and points, fuse duplicates at the weld, optimize the
        essential graph over the union and make the old map current."""
        mp = self._matched_points(kf, m_new, cand, m_old)
        if mp is None:
            return False
        X1, X2, uv1, uv2, s1, s2, _, _ = mp
        res = solve_sim3(
            X1, X2, uv1, uv2, self.K, self.K, s1, s2,
            fix_scale=self.fix_scale, min_inliers=20,
        )
        if not res.success:
            return False
        res = self._refine_sim3_lm(X1, X2, uv1, uv2, s1, s2, res)
        # S12: cand camera -> current camera. World to world:
        # X_w2 = S_w2_w1 X_w1 with S_w2_w1 = T2w2^-1 * S12^-1 * T1w1.
        S12 = (res.s, res.R, res.t)
        T1w1 = (1.0, kf.R_cw.copy(), kf.t_cw.copy())
        T2w2 = (1.0, cand.R_cw.copy(), cand.t_cw.copy())
        S_w2_w1 = sim3_mul(sim3_inv(T2w2), sim3_mul(sim3_inv(S12), T1w1))
        sw, Rw, tw = S_w2_w1
        S_w2_w1_inv = sim3_inv(S_w2_w1)

        with m_old.lock:
            # migrate keyframes: T_g_w2 = T_g_w1 * S_w1_w2; world-frame
            # velocities rotate through the world-to-world Sim3 (MergeLocal2's
            # inertial pose and velocity update, LoopClosing.cc:1783, :1595-1610)
            for g in list(m_new.keyframes.values()):
                sg, Rg, tg = sim3_mul((1.0, g.R_cw, g.t_cw), S_w2_w1_inv)
                g.set_pose(orthonormalize(Rg), tg / sg)
                self._transform_velocity(g, S_w2_w1)
                m_old.add_keyframe(g)
            # migrate points: X_w2 = S_w2_w1 X_w1
            for p in list(m_new.mappoints.values()):
                pos_new = sw * (Rw @ p.position) + tw
                m_new.release_mappoint(p.mid)
                p.position = pos_new
                m_old.add_mappoint(p)
            m_new.keyframes.clear()
            m_new.mappoints.clear()

            kf.loop_edges.add(cand.kid)
            cand.loop_edges.add(kf.kid)
            m_old.update_connections(kf)

            # fuse duplicates at the weld, both ways (one matrix launch per
            # target keyframe)
            if self.camera is not None:
                old_mids = [int(x) for x in cand.mp_ids if x >= 0]
                for cid in list(cand.covisible)[:10]:
                    c2 = m_old.keyframes.get(cid)
                    if c2 is not None:
                        old_mids.extend(int(x) for x in c2.mp_ids if x >= 0)
                old_mids = sorted(set(old_mids))
                for gid in [kf.kid] + list(kf.covisible)[:10]:
                    g = m_old.keyframes.get(gid)
                    if g is not None:
                        fuse_mappoints_into(
                            m_old, g, old_mids, self._cam_host,
                            self.scale_factor, self.n_levels, th=4.0, device=self.device,
                        )
                new_mids = [int(x) for x in kf.mp_ids if x >= 0]
                fuse_mappoints_into(
                    m_old, cand, new_mids, self._cam_host,
                    self.scale_factor, self.n_levels, th=4.0, device=self.device,
                )
                m_old.update_connections(kf)
                m_old.update_connections(cand)

            # essential-graph relaxation over the union (the weld edge pulls
            # the two trajectories into one consistent frame)
            poses = {
                kid: (1.0, g.R_cw.copy(), g.t_cw.copy())
                for kid, g in m_old.keyframes.items()
            }
            edges = []
            seen = set()
            for kid, g in m_old.keyframes.items():
                nbrs = []
                if g.parent_id is not None:
                    nbrs.append(g.parent_id)
                nbrs += list(g.loop_edges)
                nbrs += [c for c, w in g.covisible.items() if w >= 100]
                for b in nbrs:
                    if b == kid or (min(kid, b), max(kid, b)) in seen or b not in poses:
                        continue
                    seen.add((min(kid, b), max(kid, b)))
                    edges.append((kid, b, sim3_mul(poses[b], sim3_inv(poses[kid]))))
            # the inertial flags survive the weld (MergeLocal2 keeps the merged
            # map inertial; the old map's gravity frame is the reference)
            m_old.is_inertial = m_old.is_inertial or m_new.is_inertial
            m_old.imu_initialized = m_old.imu_initialized or m_new.imu_initialized
            optimized = self._optimize_graph(m_old, poses, edges, {cand.kid})
            for kid, (sg, Rg, tg) in optimized.items():
                g = m_old.keyframes.get(kid)
                if g is not None:
                    g.set_pose(orthonormalize(Rg), tg / sg)
                    self._transform_velocity(
                        g, sim3_mul(sim3_inv(optimized[kid]), poses[kid]))
            m_old.info_changed()

        # the old map becomes the active one; the emptied one leaves the Atlas
        self.atlas.change_map(m_old)
        if m_new in self.atlas.maps:
            self.atlas.remove_map(m_new)
        # bring the tracker's frame-to-frame state into the merged frame
        tracker = getattr(self, "tracker", None)
        if tracker is not None and tracker.last_frame is not None \
                and tracker.last_frame.R_cw is not None:
            lf = tracker.last_frame
            sg, Rg, tg = sim3_mul((1.0, lf.R_cw, lf.t_cw), S_w2_w1_inv)
            lf.R_cw = orthonormalize(Rg)
            lf.t_cw = tg / sg
            if lf.v_w is not None:
                lf.v_w = sw * (Rw @ np.asarray(lf.v_w, np.float64))
            tracker.velocity = None  # re-estimate in the merged frame
        self._refresh_tracker_anchor(m_old)
        self.n_maps_merged += 1
        if self.run_gba and self.camera is not None:
            if self.run_async:
                self._start_gba(fixed_kf_ids={cand.kid})
            else:
                with m_old.lock:
                    self._run_global_ba(fixed_kf_ids={cand.kid})
        return True

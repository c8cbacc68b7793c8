"""Map: one SLAM map of keyframes + map points (src/Map.cc).

Includes the covisibility-update and spanning-tree logic the reference keeps
in KeyFrame::UpdateConnections, plus ApplyScaledRotation for IMU
initialization (Map.h:118) and the change index used for map-update
detection (Map.h:111-114).

Port of fasttrack_tpu/slam_map/map.py (host code on NumPy).
"""

from __future__ import annotations

import threading

import numpy as np

from fasttrack_tpu_torch.slam_map.keyframe import KeyFrame
from fasttrack_tpu_torch.slam_map.mappoint import MapPoint


class PointStore:
    """Packed per-point arrays for one Map — the canonical storage of every
    numeric MapPoint field (see mappoint.py docstring). Rows are assigned on
    add_mappoint, freed on erase, reused from a free list; `alive` marks
    valid rows. The tracker's frustum and gather passes slice these arrays
    directly — one NumPy pass instead of a Python loop over objects
    (the reference's per-frame OpenMP packing, SearchLocalPointsKernel.cu:368)."""

    def __init__(self, cap: int = 4096):
        self._alloc(cap)
        self.n_rows = 0
        self.free: list[int] = []

    def _alloc(self, cap: int):
        self.cap = cap
        self.pos = np.zeros((cap, 3), np.float64)
        self.normal = np.zeros((cap, 3), np.float64)
        self.desc_signed = np.zeros((cap, 256), np.int8)
        self.desc_packed = np.zeros((cap, 32), np.uint8)
        self.has_desc = np.zeros(cap, bool)
        self.min_dist = np.zeros(cap, np.float64)
        self.max_dist = np.full(cap, np.inf, np.float64)
        self.n_visible = np.ones(cap, np.int32)
        self.n_found = np.ones(cap, np.int32)
        self.alive = np.zeros(cap, bool)
        self.mids = np.full(cap, -1, np.int64)

    _FIELDS = ("pos", "normal", "desc_signed", "desc_packed", "has_desc",
               "min_dist", "max_dist", "n_visible", "n_found", "alive", "mids")

    def _grow(self):
        old = {f: getattr(self, f) for f in self._FIELDS}
        n = self.cap
        self._alloc(2 * n)
        for f in self._FIELDS:
            getattr(self, f)[:n] = old[f]

    def take_row(self) -> int:
        if self.free:
            return self.free.pop()
        if self.n_rows >= self.cap:
            self._grow()
        r = self.n_rows
        self.n_rows += 1
        return r

    def release_row(self, row: int):
        if 0 <= row < self.cap:
            self.alive[row] = False
            self.mids[row] = -1
            self.has_desc[row] = False
            self.n_visible[row] = 1
            self.n_found[row] = 1
            self.free.append(row)


class Map:
    def __init__(self, map_id: int):
        self.map_id = map_id
        self.keyframes: dict[int, KeyFrame] = {}
        self.mappoints: dict[int, MapPoint] = {}
        self.store = PointStore()
        self._mid2row = np.full(4096, -1, np.int32)  # global mid -> store row
        self.reference_mappoint_ids: list[int] = []
        self.change_index = 0
        self.init_kf_id = 0
        self.max_kf_id = 0
        self.imu_initialized = False
        self.iniertial_ba1 = False
        self.iniertial_ba2 = False
        self.is_inertial = False
        self.lock = threading.RLock()  # the per-map mMutexMapUpdate
        # Shared KeyFrameDatabase hook: KeyFrame::SetBadFlag ends in
        # KeyFrameDatabase::erase (KeyFrame.cc SetBadFlag -> mpKeyFrameDB->erase,
        # KeyFrameDatabase.cc:39-62) so culled KFs never linger as loop/reloc
        # candidates. Set by Atlas/System wiring; None when no loop closer.
        self.kf_db = None

    # --- content ------------------------------------------------------------
    def add_keyframe(self, kf: KeyFrame):
        self.keyframes[kf.kid] = kf
        self.max_kf_id = max(self.max_kf_id, kf.kid)

    def add_mappoint(self, mp: MapPoint):
        self.mappoints[mp.mid] = mp
        if mp.row < 0:
            mp._bind(self.store, self.store.take_row())
        while mp.mid >= len(self._mid2row):
            self._mid2row = np.concatenate(
                [self._mid2row, np.full(len(self._mid2row), -1, np.int32)]
            )
        self._mid2row[mp.mid] = mp.row

    def rows_for(self, mids: np.ndarray) -> np.ndarray:
        """Vectorized mid -> packed-store row (-1 = absent/bad)."""
        mids = np.asarray(mids, np.int64)
        rows = np.full(len(mids), -1, np.int32)
        in_range = (mids >= 0) & (mids < len(self._mid2row))
        rows[in_range] = self._mid2row[mids[in_range]]
        ok = rows >= 0
        ok[ok] &= self.store.alive[rows[ok]]
        rows[~ok] = -1
        return rows

    def release_mappoint(self, mid: int):
        """Detach a point from this map WITHOUT marking it bad — used when a
        point migrates to another map during an Atlas merge
        (LoopClosing::MergeLocal moves points between maps)."""
        mp = self.mappoints.pop(mid, None)
        if mp is None:
            return None
        row = mp.row
        mp._unbind()
        if row >= 0:
            self.store.release_row(row)
        if 0 <= mid < len(self._mid2row):
            self._mid2row[mid] = -1
        return mp

    def erase_mappoint(self, mid: int):
        mp = self.mappoints.pop(mid, None)
        if mp is None:
            return
        row = mp.row
        mp._unbind()
        if row >= 0:
            self.store.release_row(row)
        if 0 <= mid < len(self._mid2row):
            self._mid2row[mid] = -1
        mp.bad = True
        for kf_id, idx in list(mp.observations.items()):
            kf = self.keyframes.get(kf_id)
            if kf is not None and 0 <= idx < len(kf.mp_ids) and kf.mp_ids[idx] == mid:
                kf.mp_ids[idx] = -1

    def replace_mappoint(self, old_mid: int, new_mid: int):
        """MapPoint::Replace: rebind every observation of ``old`` to ``new``
        (skipping keyframes that already observe ``new``), merge the
        visible/found counters, and retire ``old``."""
        if old_mid == new_mid:
            return
        old = self.mappoints.get(old_mid)
        new = self.mappoints.get(new_mid)
        if old is None or new is None:
            return
        for kf_id, idx in list(old.observations.items()):
            kf = self.keyframes.get(kf_id)
            if kf is None:
                continue
            if kf_id not in new.observations:
                new.add_observation(kf_id, idx)
                if 0 <= idx < len(kf.mp_ids):
                    kf.mp_ids[idx] = new_mid
            else:
                if 0 <= idx < len(kf.mp_ids) and kf.mp_ids[idx] == old_mid:
                    kf.mp_ids[idx] = -1
        new.n_visible += old.n_visible
        new.n_found += old.n_found
        old.observations.clear()
        old.bad = True
        old.replaced_by = new_mid
        self.mappoints.pop(old_mid, None)
        row = old.row
        old._unbind()
        old.bad = True  # _unbind copies state; keep the tombstone flag
        if row >= 0:
            self.store.release_row(row)
        if 0 <= old_mid < len(self._mid2row):
            self._mid2row[old_mid] = -1

    def refresh_mappoint(self, mp: MapPoint, scale_factor: float, n_levels: int):
        """ComputeDistinctiveDescriptors + UpdateNormalAndDepth after the
        observation set changed (MapPoint.cc)."""
        if mp.bad or not mp.observations:
            return
        descs_p, descs_s, centers = [], [], {}
        ref_level = 0
        ref_center = None
        for kf_id, idx in mp.observations.items():
            kf = self.keyframes.get(kf_id)
            if kf is None or idx >= len(kf.mp_ids):
                continue
            descs_p.append(kf.desc_packed[idx])
            descs_s.append(kf.desc_signed[idx])
            centers[kf_id] = kf.center
            if kf_id == mp.ref_kf_id:
                ref_level = int(kf.kp_level[idx])
                ref_center = kf.center
        if not descs_p:
            return
        mp.update_descriptor(np.asarray(descs_p), np.asarray(descs_s))
        if ref_center is None:
            ref_kf = self.keyframes.get(next(iter(mp.observations)))
            ref_center = ref_kf.center
        mp.update_normal_and_depth(centers, ref_center, ref_level,
                                   scale_factor, n_levels)

    def erase_keyframe(self, kid: int):
        """KeyFrame::SetBadFlag: detach observations, reparent children."""
        kf = self.keyframes.get(kid)
        if kf is None or kf.kid == self.init_kf_id:
            return
        for idx, mid in enumerate(kf.mp_ids):
            if mid < 0:
                continue
            mp = self.mappoints.get(int(mid))
            if mp is not None:
                if mp.erase_observation(kid):
                    self.erase_mappoint(mp.mid)
        # remove covisibility back-links
        for other_id in list(kf.covisible.keys()):
            other = self.keyframes.get(other_id)
            if other is not None:
                other.covisible.pop(kid, None)
        # reparent children to this KF's parent (simplified spanning tree
        # update; the reference searches the best covisible candidate)
        parent = self.keyframes.get(kf.parent_id) if kf.parent_id is not None else None
        for child_id in kf.children:
            child = self.keyframes.get(child_id)
            if child is not None:
                child.parent_id = kf.parent_id
                if parent is not None:
                    parent.children.add(child_id)
        if parent is not None:
            parent.children.discard(kid)
        kf.bad = True
        self.keyframes.pop(kid, None)
        if self.kf_db is not None:
            self.kf_db.erase(kid)

    def clear(self):
        """Wipe the map's content (Map::clear): unbind every MapPoint from
        the packed PointStore (releasing its row and the mid->row entry) so
        resets don't leak alive=True ghost rows that keep resolving via
        rows_for and keep rendering in the MapDrawer."""
        for mid in list(self.mappoints):
            mp = self.mappoints.pop(mid)
            row = mp.row
            mp._unbind()
            mp.bad = True
            if row >= 0:
                self.store.release_row(row)
            if 0 <= mid < len(self._mid2row):
                self._mid2row[mid] = -1
        if self.kf_db is not None:
            for kid in self.keyframes:
                self.kf_db.erase(kid)
        self.keyframes.clear()
        self.reference_mappoint_ids.clear()
        self.info_changed()

    def n_keyframes(self) -> int:
        return len(self.keyframes)

    def n_mappoints(self) -> int:
        return len(self.mappoints)

    def info_changed(self):
        self.change_index += 1

    # --- covisibility (KeyFrame::UpdateConnections) -------------------------
    def update_connections(self, kf: KeyFrame, min_weight: int = 15):
        counter: dict[int, int] = {}
        for mid in kf.mp_ids:
            if mid < 0:
                continue
            mp = self.mappoints.get(int(mid))
            if mp is None or mp.bad:
                continue
            for other_id in mp.observations:
                if other_id != kf.kid:
                    counter[other_id] = counter.get(other_id, 0) + 1
        if not counter:
            return
        kf.covisible = {k: w for k, w in counter.items() if w >= min_weight}
        if not kf.covisible:
            best = max(counter.items(), key=lambda kv: kv[1])
            kf.covisible = {best[0]: best[1]}
        for other_id, w in kf.covisible.items():
            other = self.keyframes.get(other_id)
            if other is not None:
                other.covisible[kf.kid] = w
        # spanning tree: parent = best covisible with smaller id
        if kf.parent_id is None and kf.kid != self.init_kf_id:
            cands = [k for k in kf.covisible if k < kf.kid]
            if cands:
                parent_id = max(cands, key=lambda k: kf.covisible[k])
                kf.parent_id = parent_id
                parent = self.keyframes.get(parent_id)
                if parent is not None:
                    parent.children.add(kf.kid)

    # --- IMU init alignment (Map::ApplyScaledRotation) ----------------------
    def apply_scaled_rotation(self, R_gw: np.ndarray, scale: float,
                              scale_velocities: bool = False):
        """Rotate the gravity direction into -z and rescale: for every KF
        pose Tcw = [Rcw, tcw]: Rcw' = Rcw R_gw^T, tcw' = s * tcw (translation
        part), points X' = s * R_gw X."""
        for kf in self.keyframes.values():
            kf.R_cw = kf.R_cw @ R_gw.T
            kf.t_cw = scale * kf.t_cw
            if scale_velocities and kf.velocity is not None:
                kf.velocity = scale * (R_gw @ kf.velocity)
        for mp in self.mappoints.values():
            mp.position = scale * (R_gw @ mp.position)
        self.info_changed()

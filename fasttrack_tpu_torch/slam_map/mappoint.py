"""MapPoint: a 3D landmark (src/MapPoint.cc, include/MapPoint.h).

Carries world position, viewing normal, a distinctive descriptor, the
observation map {keyframe_id -> feature index}, scale-invariance distances
and the visible/found counters used by MapPointCulling
(LocalMapping.cc:346).

Port of fasttrack_tpu/slam_map/mappoint.py (host code on NumPy).

Storage design (device-system-first): the numeric per-point fields (position,
normal, descriptors, distance band) live in the owning Map's packed array
store (slam_map.map.PointStore) once the point is added to a map; the
MapPoint object exposes them as properties over its assigned row. The
tracker's per-frame frustum/gather passes then run as single NumPy
expressions over the packed arrays instead of Python loops over objects —
the reference ferries the same data into flat GPU arrays per frame
(SearchLocalPointsKernel.cu:368-390); here the flat arrays ARE the map,
and the tracker mirrors them on the device (Tracker._store_device).
"""

from __future__ import annotations

import numpy as np


class MapPoint:
    __slots__ = (
        "mid", "observations", "ref_kf_id",
        "bad", "first_kf_id", "replaced_by",
        "_store", "row",
        "_position", "_normal", "_desc_packed", "_desc_signed",
        "_min_distance", "_max_distance", "_n_visible", "_n_found",
    )

    def __init__(self, mid: int, position: np.ndarray, ref_kf_id: int, first_kf_id: int):
        self.mid = mid
        self._store = None        # PointStore once added to a Map
        self.row = -1
        self._position = np.asarray(position, dtype=np.float64)
        self._normal = np.zeros(3, dtype=np.float64)
        self._desc_packed = None   # (32,) uint8
        self._desc_signed = None   # (256,) int8
        self._min_distance = 0.0
        self._max_distance = np.inf
        self.observations: dict[int, int] = {}
        self.ref_kf_id = ref_kf_id
        self.first_kf_id = first_kf_id
        self._n_visible = 1
        self._n_found = 1
        self.bad = False
        self.replaced_by: int | None = None
        # The reference's per-frame track cache (MapPoint.h mbTrackInView,
        # mTrackProjX/Y, ...) ferries isInFrustum results to the GPU kernels;
        # here the tracker packs those into dense arrays directly
        # (tracking._track_local_map over the PointStore).

    # --- packed-store-backed fields ----------------------------------------
    def _bind(self, store, row: int):
        """Move the numeric fields into the map's packed arrays."""
        self._store = store
        self.row = row
        store.pos[row] = self._position
        store.normal[row] = self._normal
        if self._desc_signed is not None:
            store.desc_signed[row] = self._desc_signed
            store.has_desc[row] = True
        if self._desc_packed is not None:
            store.desc_packed[row] = self._desc_packed
        store.min_dist[row] = self._min_distance
        store.max_dist[row] = self._max_distance
        store.n_visible[row] = self._n_visible
        store.n_found[row] = self._n_found
        store.alive[row] = True
        store.mids[row] = self.mid

    def _unbind(self):
        if self._store is None:
            return
        s, r = self._store, self.row
        self._position = s.pos[r].copy()
        self._normal = s.normal[r].copy()
        self._desc_signed = s.desc_signed[r].copy() if s.has_desc[r] else None
        self._desc_packed = s.desc_packed[r].copy() if s.has_desc[r] else None
        self._min_distance = float(s.min_dist[r])
        self._max_distance = float(s.max_dist[r])
        self._n_visible = int(s.n_visible[r])
        self._n_found = int(s.n_found[r])
        s.alive[r] = False
        self._store = None
        self.row = -1

    @property
    def position(self) -> np.ndarray:
        if self._store is None:
            return self._position
        return self._store.pos[self.row]

    @position.setter
    def position(self, v):
        if self._store is None:
            self._position = np.asarray(v, dtype=np.float64)
        else:
            self._store.pos[self.row] = v

    @property
    def normal(self) -> np.ndarray:
        if self._store is None:
            return self._normal
        return self._store.normal[self.row]

    @normal.setter
    def normal(self, v):
        if self._store is None:
            self._normal = np.asarray(v, dtype=np.float64)
        else:
            self._store.normal[self.row] = v

    @property
    def desc_signed(self):
        if self._store is None:
            return self._desc_signed
        if not self._store.has_desc[self.row]:
            return None
        return self._store.desc_signed[self.row]

    @desc_signed.setter
    def desc_signed(self, v):
        if self._store is None:
            self._desc_signed = v
        elif v is not None:
            self._store.desc_signed[self.row] = v
            self._store.has_desc[self.row] = True

    @property
    def desc_packed(self):
        if self._store is None:
            return self._desc_packed
        if not self._store.has_desc[self.row]:
            return None
        return self._store.desc_packed[self.row]

    @desc_packed.setter
    def desc_packed(self, v):
        if self._store is None:
            self._desc_packed = v
        elif v is not None:
            self._store.desc_packed[self.row] = v

    @property
    def min_distance(self) -> float:
        if self._store is None:
            return self._min_distance
        return float(self._store.min_dist[self.row])

    @min_distance.setter
    def min_distance(self, v):
        if self._store is None:
            self._min_distance = float(v)
        else:
            self._store.min_dist[self.row] = v

    @property
    def max_distance(self) -> float:
        if self._store is None:
            return self._max_distance
        return float(self._store.max_dist[self.row])

    @max_distance.setter
    def max_distance(self, v):
        if self._store is None:
            self._max_distance = float(v)
        else:
            self._store.max_dist[self.row] = v

    @property
    def n_visible(self) -> int:
        if self._store is None:
            return self._n_visible
        return int(self._store.n_visible[self.row])

    @n_visible.setter
    def n_visible(self, v):
        if self._store is None:
            self._n_visible = int(v)
        else:
            self._store.n_visible[self.row] = v

    @property
    def n_found(self) -> int:
        if self._store is None:
            return self._n_found
        return int(self._store.n_found[self.row])

    @n_found.setter
    def n_found(self, v):
        if self._store is None:
            self._n_found = int(v)
        else:
            self._store.n_found[self.row] = v

    # --- observations -------------------------------------------------------
    def n_obs(self) -> int:
        return len(self.observations)

    def add_observation(self, kf_id: int, idx: int):
        self.observations[kf_id] = idx

    def erase_observation(self, kf_id: int) -> bool:
        """Returns True if the point became bad (<=2 observations left after
        losing its anchor, MapPoint::EraseObservation semantics)."""
        self.observations.pop(kf_id, None)
        if self.ref_kf_id == kf_id and self.observations:
            self.ref_kf_id = next(iter(self.observations))
        if len(self.observations) <= 1:
            self.bad = True
        return self.bad

    def found_ratio(self) -> float:
        return self.n_found / max(self.n_visible, 1)

    def update_descriptor(self, descs_packed: np.ndarray, descs_signed: np.ndarray):
        """Pick the descriptor with minimum median Hamming distance to the
        others (MapPoint::ComputeDistinctiveDescriptors)."""
        n = len(descs_packed)
        if n == 0:
            return
        if n == 1:
            self.desc_packed = descs_packed[0]
            self.desc_signed = descs_signed[0]
            return
        s = descs_signed.astype(np.int32)
        dots = s @ s.T
        ham = (256 - dots) // 2
        med = np.median(ham, axis=1)
        k = int(np.argmin(med))
        self.desc_packed = descs_packed[k]
        self.desc_signed = descs_signed[k]

    def update_normal_and_depth(self, kf_positions: dict[int, np.ndarray],
                                ref_kf_pos: np.ndarray, ref_level: int,
                                scale_factor: float, n_levels: int):
        """MapPoint::UpdateNormalAndDepth: mean viewing direction + scale
        invariance distance band from the reference keyframe."""
        if not self.observations:
            return
        pos = self.position
        dirs = []
        for kf_id, kfp in kf_positions.items():
            v = pos - kfp
            n = np.linalg.norm(v)
            if n > 1e-9:
                dirs.append(v / n)
        if dirs:
            nrm = np.mean(dirs, axis=0)
            nn = np.linalg.norm(nrm)
            if nn > 1e-9:
                self.normal = nrm / nn
        dist = np.linalg.norm(pos - ref_kf_pos)
        level_factor = scale_factor**ref_level
        self.max_distance = dist * level_factor
        self.min_distance = self.max_distance / (scale_factor ** (n_levels - 1))

    def predict_scale(self, dist: float, scale_factor: float, n_levels: int) -> int:
        """MapPoint::PredictScale."""
        if dist < 1e-9:
            return 0
        ratio = self.max_distance / dist
        level = int(np.ceil(np.log(max(ratio, 1e-9)) / np.log(scale_factor)))
        return int(np.clip(level, 0, n_levels - 1))

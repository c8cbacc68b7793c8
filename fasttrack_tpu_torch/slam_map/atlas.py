"""Atlas: multi-map manager (src/Atlas.cc).

Creates a fresh map when tracking is irrecoverably lost
(Tracking::CreateMapInAtlas); old maps stay for later merge by loop closing.

Port of fasttrack_tpu/slam_map/atlas.py (host code on NumPy).
"""

from __future__ import annotations

from fasttrack_tpu_torch.slam_map.map import Map


class Atlas:
    def __init__(self):
        self._maps: list[Map] = []
        self._next_map_id = 0
        self._next_kf_id = 0
        self._next_mp_id = 0
        self.cameras: list = []
        self.kf_db = None  # shared KeyFrameDatabase, propagated to every Map
        self.current: Map = self.create_new_map()

    def create_new_map(self) -> Map:
        m = Map(self._next_map_id)
        m.init_kf_id = self._next_kf_id
        m.kf_db = self.kf_db
        self._next_map_id += 1
        self._maps.append(m)
        self.current = m
        return m

    def set_kf_database(self, db):
        """Wire the shared inverted-index database into every map (current
        and future) so KF culling/clear erase stale DB entries
        (KeyFrameDatabase.cc:39-99)."""
        self.kf_db = db
        for m in self._maps:
            m.kf_db = db

    def change_map(self, m: Map):
        self.current = m

    def next_kf_id(self) -> int:
        i = self._next_kf_id
        self._next_kf_id += 1
        return i

    def next_mp_id(self) -> int:
        i = self._next_mp_id
        self._next_mp_id += 1
        return i

    def add_camera(self, cam):
        if cam not in self.cameras:
            self.cameras.append(cam)
        return cam

    @property
    def maps(self) -> list[Map]:
        return [m for m in self._maps]

    def n_maps(self) -> int:
        return len(self._maps)

    def remove_map(self, m: Map):
        self._maps.remove(m)
        if self.kf_db is not None:
            for kid in m.keyframes:
                self.kf_db.erase(kid)

"""KeyFrame: a persistent frame in the map (src/KeyFrame.cc).

Holds a host snapshot of the frame's keypoint arrays (positions, levels,
descriptors, stereo depths), the pose, map-point bindings, the covisibility
graph and the spanning tree. Descriptor tensors are kept as NumPy here; the
device copies live only as long as the tracking front-end needs them.

Port of fasttrack_tpu/slam_map/keyframe.py (host code on NumPy).
"""

from __future__ import annotations

import numpy as np


class KeyFrame:
    __slots__ = (
        "kid", "frame_id", "timestamp", "R_cw", "t_cw",
        "kp_uv", "kp_level", "kp_angle", "desc_packed", "desc_signed",
        "u_right", "depth", "valid",
        "mp_ids", "covisible", "parent_id", "children", "loop_edges",
        "merge_edges", "bad", "not_erase", "to_be_erased",
        "bow_vec", "feat_vec",
        "imu_bias", "velocity", "prev_kf_id", "next_kf_id", "preintegrated",
    )

    def __init__(self, kid, frame_id, timestamp, R_cw, t_cw, kp_uv, kp_level,
                 kp_angle, desc_packed, desc_signed, u_right, depth, valid):
        self.kid = kid
        self.frame_id = frame_id
        self.timestamp = timestamp
        self.R_cw = np.asarray(R_cw, np.float64)
        self.t_cw = np.asarray(t_cw, np.float64)
        self.kp_uv = kp_uv            # (N, 2) float32
        self.kp_level = kp_level      # (N,) int32
        self.kp_angle = kp_angle      # (N,)
        self.desc_packed = desc_packed
        self.desc_signed = desc_signed
        self.u_right = u_right        # (N,) -1 if mono
        self.depth = depth            # (N,) -1 if none
        self.valid = valid            # (N,) bool
        self.mp_ids = np.full(len(kp_uv), -1, dtype=np.int64)
        self.covisible: dict[int, int] = {}  # kf_id -> shared point count
        self.parent_id: int | None = None
        self.children: set[int] = set()
        self.loop_edges: set[int] = set()
        self.merge_edges: set[int] = set()
        self.bad = False
        self.not_erase = False
        self.to_be_erased = False
        self.bow_vec = None           # dict word -> weight
        self.feat_vec = None          # dict node -> [feat indices]
        # inertial
        self.imu_bias = None
        self.velocity = None
        self.prev_kf_id: int | None = None
        self.next_kf_id: int | None = None
        self.preintegrated = None

    # --- pose helpers -------------------------------------------------------
    @property
    def center(self) -> np.ndarray:
        """Camera center in world coordinates: -R^T t."""
        return -self.R_cw.T @ self.t_cw

    def pose_wc(self):
        return self.R_cw.T, -self.R_cw.T @ self.t_cw

    def set_pose(self, R_cw, t_cw):
        self.R_cw = np.asarray(R_cw, np.float64)
        self.t_cw = np.asarray(t_cw, np.float64)

    # --- covisibility (KeyFrame::UpdateConnections) -------------------------
    def best_covisible(self, n: int) -> list[int]:
        return [
            k for k, _ in sorted(self.covisible.items(), key=lambda kv: -kv[1])[:n]
        ]

    def covisible_over(self, min_weight: int = 15) -> list[int]:
        return [k for k, w in self.covisible.items() if w >= min_weight]

    def tracked_map_points(self, mappoints: dict, min_obs: int) -> int:
        c = 0
        for mid in self.mp_ids:
            if mid < 0:
                continue
            mp = mappoints.get(int(mid))
            if mp is not None and not mp.bad and mp.n_obs() >= min_obs:
                c += 1
        return c

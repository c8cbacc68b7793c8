"""Single-sync tracking: the whole OK-state frame on the device with ONE
device->host fetch.

Port of fasttrack_tpu/fused_track.py (the visual path: `twm_step`,
`tlm_step`, `pack_fused_for_host`, `unpack_fused`; the inertial variants
come with the inertial slice). Every input the stages need from the host is
derivable from the last frame's state plus the motion prediction, so the
host packs the query blocks up front (parity.py shows how), runs the chain
frame -> TWM (match + pose) -> TLM (frustum + match + pose) -> pack without
reading anything back, and fetches one buffer.

Parity anchors: Tracking::TrackWithMotionModel (Tracking.cc:2911) and
TrackLocalMap (:3042). Each frame launches the Hamming+top-K kernel three
times: stereo, the motion-model search (its 1x and 2x windows share one
selection), and the local-map search.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fasttrack_tpu_torch.cameras.models import Camera, project
from fasttrack_tpu_torch.geometry import SE3
from fasttrack_tpu_torch.ops.extractor import Keypoints, OrbConfig, scale_factors
from fasttrack_tpu_torch.ops.project_match import (
    gate_candidates,
    hamming_candidates,
    tlm_match,
    twm_keep,
)
from fasttrack_tpu_torch.optim.pose_opt import pose_optimize


class TwmStepOut(NamedTuple):
    idx: torch.Tensor        # (M,) matched keypoint per query
    keep: torch.Tensor       # (M,) bool
    pose_R: torch.Tensor     # (3, 3) optimized pose
    pose_t: torch.Tensor     # (3,)
    inliers: torch.Tensor    # (N,) per-keypoint inlier mask
    n_inliers: torch.Tensor  # ()
    Xw_kp: torch.Tensor      # (N, 3) per-keypoint map positions (TWM-bound)
    bound_kp: torch.Tensor   # (N,) bool keypoint got a TWM binding


def _scatter_to_keypoints(idx, keep, rows, base_pos, base_bound):
    """Writes `rows[i]` to keypoint `idx[i]` where `keep[i]`, on top of
    (N, 3) `base_pos` and (N,) `base_bound`. Kept rows are unique after the
    dedup; the others all go to a dump slot N that is cut off again."""
    N = base_bound.shape[0]
    idx_safe = torch.where(keep, idx, N)
    pos = torch.cat([base_pos, base_pos.new_zeros((1, 3))])
    pos[idx_safe] = rows
    bound = torch.cat([base_bound, base_bound.new_zeros(1)])
    bound[idx_safe] = True
    return pos[:N], bound[:N]


def twm_step(
    kl: Keypoints,
    u_right: torch.Tensor,
    config: OrbConfig,
    bf: torch.Tensor,
    cam: Camera,
    T0: SE3,                    # predicted pose
    q7: torch.Tensor,           # (7, M) [u, v, radius, lmin, lmax, valid, angle]
    q_rows: torch.Tensor,       # (M,) int PointStore rows (invalid -> 0, gated by q7[5])
    store_pos: torch.Tensor,    # (cap, 3) device-resident map mirror
    store_desc: torch.Tensor,   # (cap, 256) int8
) -> TwmStepOut:
    """TrackWithMotionModel search + widen-retry + pose optimization with no
    host read-back. The widen-2x retry (Tracking.cc:2964) is folded in: both
    windows are evaluated and the wide result is selected when the narrow
    one has < 20 matches. Only the radius differs between the two, so the
    Hamming+top-K kernel runs once and its candidates are gated twice.

    Map-point descriptors and positions come from the device-resident
    PointStore mirror (convert.store_from_numpy): per frame the host uploads
    row indices, not descriptors."""
    sf = scale_factors(config, kl.x.device)
    rows = q_rows.long()
    q_desc = store_desc[rows]
    q_pos = store_pos[rows]
    N = kl.x.shape[0]

    cands = hamming_candidates(q_desc, q7[5] > 0.5, kl.desc_signed, kl.valid)
    lmin, lmax = q7[3].to(torch.int32), q7[4].to(torch.int32)

    def run_match(widen):
        res = gate_candidates(
            cands, q7[0], q7[1], q7[2] * widen, lmin, lmax, kl.x, kl.y, kl.level
        )
        return res.idx, twm_keep(q7[6], kl.angle, res, N)

    idx1, keep1 = run_match(1.0)
    idx2, keep2 = run_match(2.0)
    use_narrow = keep1.sum() >= 20
    idx = torch.where(use_narrow, idx1, idx2)
    keep = torch.where(use_narrow, keep1, keep2)

    Xw_kp, bound_kp = _scatter_to_keypoints(
        idx, keep, q_pos, q_pos.new_zeros((N, 3)), keep.new_zeros(N)
    )
    obs_uv = torch.stack([kl.x, kl.y], dim=-1)
    inv_sigma2 = 1.0 / (sf[kl.level] ** 2)
    opt = pose_optimize(cam, bf, T0, Xw_kp, obs_uv, u_right, inv_sigma2, bound_kp)
    return TwmStepOut(
        idx, keep, opt.pose.R, opt.pose.t, opt.inliers, opt.n_inliers, Xw_kp, bound_kp,
    )


class TlmStepOut(NamedTuple):
    idx: torch.Tensor         # (P,) matched keypoint per candidate
    keep: torch.Tensor        # (P,) bool
    pose_R: torch.Tensor
    pose_t: torch.Tensor
    inliers: torch.Tensor     # (N,) final per-keypoint inlier mask
    n_inliers: torch.Tensor
    in_frustum: torch.Tensor  # (P,) bool (feeds MapPoint::IncreaseVisible)
    pred_level: torch.Tensor  # (P,) int32 predicted octave


def tlm_step(
    kl: Keypoints,
    u_right: torch.Tensor,
    config: OrbConfig,
    bf: torch.Tensor,
    cam: Camera,
    twm: TwmStepOut,            # device-resident output of twm_step
    cand_rows: torch.Tensor,    # (P,) int PointStore rows (invalid -> 0)
    cand_ok: torch.Tensor,      # (P,) bool
    store_pos: torch.Tensor,    # device-resident PointStore mirror
    store_desc: torch.Tensor,
    store_normal: torch.Tensor,
    store_mind: torch.Tensor,
    store_maxd: torch.Tensor,
) -> TlmStepOut:
    """TrackLocalMap with the frustum cull on the device against the
    TWM-optimized pose (Frame::isInFrustum semantics, Tracking.cc:3472),
    then the taken-masked window match and the final pose optimization over
    the union of TWM + TLM bindings, with no host involvement."""
    sf = scale_factors(config, kl.x.device)
    rows = cand_rows.long()
    cand_pos = store_pos[rows]
    cand_desc = store_desc[rows]
    cand_normal = store_normal[rows]
    cand_mind = store_mind[rows]
    cand_maxd = store_maxd[rows]
    R_cw, t_cw = twm.pose_R, twm.pose_t
    t_wc = -R_cw.T @ t_cw

    Xc = cand_pos @ R_cw.T + t_cw
    uv = project(cam, Xc)
    dist = torch.linalg.vector_norm(Xc, dim=-1)
    view = (cand_pos - t_wc) / torch.clamp(dist, min=1e-9)[:, None]
    in_img = (
        (uv[:, 0] >= 0) & (uv[:, 0] < cam.width)
        & (uv[:, 1] >= 0) & (uv[:, 1] < cam.height)
    )
    view_cos = torch.sum(cand_normal * view, dim=-1)
    in_frustum = (
        cand_ok
        & (Xc[:, 2] > 0.1)
        & in_img
        & (dist >= 0.8 * cand_mind)
        & (dist <= 1.2 * cand_maxd)
        & (view_cos >= 0.5)
    )
    # MapPoint::PredictScale
    ratio = cand_maxd / torch.clamp(dist, min=1e-9)
    log_scale = float(np.log(np.float32(config.scale_factor)))  # f32 log, as the JAX package
    lv = torch.ceil(torch.log(torch.clamp(ratio, min=1e-9)) / log_scale)
    lv = torch.clamp(lv, 0, config.n_levels - 1).to(torch.int32)
    # RadiusByViewingCos (ORBmatcher.cc:141): 2.5 px head-on, 4.0 oblique
    radius = torch.where(view_cos > 0.998, 2.5, 4.0) * sf[lv]

    taken = twm.bound_kp & twm.inliers
    idx, keep = tlm_match(
        uv[:, 0], uv[:, 1], cand_desc, radius,
        torch.clamp(lv - 1, min=0), lv, in_frustum,
        kl.x, kl.y, kl.desc_signed, kl.level, kl.valid, taken,
    )

    # union of bindings for the final pose optimization
    Xw_kp, bound = _scatter_to_keypoints(idx, keep, cand_pos, twm.Xw_kp, taken)
    obs_uv = torch.stack([kl.x, kl.y], dim=-1)
    inv_sigma2 = 1.0 / (sf[kl.level] ** 2)
    opt = pose_optimize(cam, bf, SE3(R_cw, t_cw), Xw_kp, obs_uv, u_right, inv_sigma2, bound)
    return TlmStepOut(
        idx, keep, opt.pose.R, opt.pose.t, opt.inliers, opt.n_inliers, in_frustum, lv,
    )


N_TAIL = 14  # pose_R (9), pose_t (3), n_inliers of TWM and TLM


def pack_fused_for_host(fd, twm: TwmStepOut, tlm: TlmStepOut) -> torch.Tensor:
    """Every host-needed output of a fused frame as ONE uint8 buffer, so the
    frame costs exactly one device->host transfer. `unpack_fused` states
    the layout."""
    k = fd.kps
    f32 = torch.cat([
        torch.stack([
            k.x, k.y, k.level.float(), k.angle, fd.u_right, fd.depth, k.valid.float(),
            twm.inliers.float(), tlm.inliers.float(),
        ]).reshape(-1),
        tlm.pose_R.reshape(-1), tlm.pose_t,
        twm.n_inliers.float().reshape(1), tlm.n_inliers.float().reshape(1),
    ])
    i32 = torch.cat([twm.idx, tlm.idx]).to(torch.int32)
    u8 = torch.cat([
        k.desc_packed.reshape(-1),
        twm.keep.to(torch.uint8), tlm.keep.to(torch.uint8), tlm.in_frustum.to(torch.uint8),
    ])
    return torch.cat([f32.view(torch.uint8), i32.view(torch.uint8), u8])


def unpack_fused(buf: np.ndarray, N: int, M: int, P: int):
    """Host-side inverse of pack_fused_for_host (pure NumPy views of a uint8
    array). Layout, in bytes, 4-byte items first so that every view is
    aligned:

        f32  (9, N)   x, y, level, angle, u_right, depth, valid,
                      TWM inliers, TLM inliers
        f32  (14,)    pose_R (9), pose_t (3), n_inliers TWM, n_inliers TLM
        i32  (M,)     TWM idx          i32 (P,)  TLM idx
        u8   (N, 32)  packed descriptors
        u8   (M,)     TWM keep         u8 (P,)   TLM keep
        u8   (P,)     in_frustum

    Indices travel as int32, not as the JAX package's f16 (its link was
    bandwidth-bound and its indices stayed under 2048). Returns
    (f32 frame block (9, N), packed descriptors (N, 32), idxA (M,), keepA
    (M,), idxB (P,), keepB (P,), in_frustum (P,), tail (14,))."""
    o1 = 9 * N * 4
    o2 = o1 + N_TAIL * 4
    o3 = o2 + (M + P) * 4
    o4 = o3 + N * 32
    f32 = buf[:o1].view(np.float32).reshape(9, N)
    tail = buf[o1:o2].view(np.float32)
    idx = buf[o2:o3].view(np.int32).astype(np.int64)
    packed = buf[o3:o4].reshape(N, 32)
    masks = buf[o4:o4 + M + 2 * P] > 0
    return (f32, packed, idx[:M], masks[:M], idx[M:], masks[M:M + P],
            masks[M + P:], tail)

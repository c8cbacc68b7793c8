"""Holding one run of the tracking front end against another, and the host
side of the fused per-frame step on synthetic state (numpy throughout).

Keypoint slot order is not part of the contract (two backends may order
tied candidates differently), so keypoints are compared as sets of
(x, y, level), descriptors and depths on co-detected keypoints — the
thresholds of tools/tpu_golden_check.py: set overlap >= 0.97, mean
descriptor bit difference <= 4, median depth difference <= 0.05 m.
Also the synthetic stereo frames both sides run on.

The second half is what fasttrack_tpu/tracking.py:Tracker._track_fused does
on the host around the device chain, without its map, keyframe and atlas
classes: a point store as plain arrays (`new_store`, `store_add_points`),
the TrackWithMotionModel query block (`twm_query_block`), the local-map
candidates (`tlm_candidate_block`), the binding bookkeeping after the fetch
(`bind_fused_frame`) and the pose's way back onto SO(3) (`orthonormalize`,
re-exported from nputils).
"""

from __future__ import annotations

import numpy as np

from fasttrack_tpu_torch.cameras.host import (
    HostCamera,
    frustum_depth_ok,
    in_image_np,
    project_np,
)
from fasttrack_tpu_torch.nputils import orthonormalize  # noqa: F401  (its one copy)

MIN_KP_OVERLAP = 0.97
MAX_DESC_BITS = 4.0
MAX_DEPTH_DIFF_M = 0.05


def stereo_frames(n: int, height: int, width: int, seed: int = 0, step=(3, 5)):
    """n stacked (2, H, W) uint8 stereo pairs, bench.py's recipe: an 8x8
    block texture, the right image the left shifted by 7 px, fresh noise
    per frame. The window walks `step` = (dy, dx) px per frame over a base
    large enough that it never wraps, so consecutive frames overlap."""
    rng = np.random.default_rng(seed)
    dy, dx = step
    bh = (height + dy * n) // 8 + 4
    bw = (width + dx * n) // 8 + 4
    base = np.kron(rng.integers(0, 256, size=(bh, bw)), np.ones((8, 8))).astype(np.uint8)
    frames = []
    for i in range(n):
        left = base[dy * i:dy * i + height, dx * i:dx * i + width]
        right = np.roll(left, -7, axis=1)
        noise = rng.integers(0, 8, size=(2, height, width)).astype(np.uint8)
        frames.append(
            (np.stack([left, right]).astype(np.int16) + noise).clip(0, 255).astype(np.uint8)
        )
    return frames


def map_from_frame(frame: dict, intrinsics, n_map: int, n_levels: int,
                   radius: float = 8.0, shift=(0.0, 0.0)) -> dict:
    """A local map of `n_map` points from one frame's stereo keypoints.

    `frame` holds numpy 'x', 'y', 'level', 'depth' and 'desc_packed' (N, 32)
    of the frame that becomes the map's reference (world = its camera
    frame); points are its keypoints with depth, lifted by the pinhole
    `intrinsics` (fx, fy, cx, cy). Their predicted positions in the next
    frame are the keypoints moved by `shift` = (du, dv) px. Slots past the
    points with depth are invalid. Returns the arguments of
    convert.map_from_numpy."""
    fx, fy, cx, cy = intrinsics
    sel = np.where(frame["depth"] > 0)[0][:n_map]
    z = frame["depth"][sel]
    x, y = frame["x"][sel], frame["y"][sel]
    level = frame["level"][sel].astype(np.int32)
    bits = np.unpackbits(frame["desc_packed"][sel], axis=1, bitorder="little")
    m = len(sel)

    def pad(a, fill, dtype):
        out = np.full((n_map,) + a.shape[1:], fill, dtype)
        out[:m] = a
        return out

    return dict(
        u=pad(x + shift[0], 0.0, np.float32),
        v=pad(y + shift[1], 0.0, np.float32),
        desc=pad(2 * bits.astype(np.int8) - 1, 1, np.int8),
        pos=pad(np.stack([(x - cx) / fx * z, (y - cy) / fy * z, z], -1), 1.0, np.float32),
        radius=np.full(n_map, radius, np.float32),
        lmin=pad(np.maximum(level - 1, 0), 0, np.int32),
        lmax=pad(np.minimum(level + 1, n_levels - 1), 0, np.int32),
        ok=pad(np.ones(m, bool), False, bool),
    )


def _keys(x, y, level, valid):
    return [
        (int(round(2 * float(a))), int(round(2 * float(b))), int(c))
        for a, b, c in zip(x[valid], y[valid], level[valid])
    ], np.where(valid)[0]


def keypoint_overlap(a: dict, b: dict) -> float:
    """|A & B| / min(|A|, |B|) over (x, y, level) keys of valid keypoints;
    a, b hold numpy arrays 'x', 'y', 'level', 'valid'."""
    ka = set(_keys(a["x"], a["y"], a["level"], a["valid"])[0])
    kb = set(_keys(b["x"], b["y"], b["level"], b["valid"])[0])
    return len(ka & kb) / max(min(len(ka), len(kb)), 1)


def codetected(a: dict, b: dict):
    """Index arrays (ia, ib) of keypoints present in both a and b."""
    keys_b, idx_b = _keys(b["x"], b["y"], b["level"], b["valid"])
    pos_b = dict(zip(keys_b, idx_b))
    keys_a, idx_a = _keys(a["x"], a["y"], a["level"], a["valid"])
    pairs = [(i, pos_b[k]) for k, i in zip(keys_a, idx_a) if k in pos_b]
    ia = np.asarray([p[0] for p in pairs], np.int64)
    ib = np.asarray([p[1] for p in pairs], np.int64)
    return ia, ib


def golden_compare(a: dict, b: dict) -> dict:
    """The golden-check report of two frames; a, b also hold 'desc_packed'
    (N, 32) uint8 and 'depth' (N,) (-1 where there is none)."""
    ia, ib = codetected(a, b)
    bits = np.unpackbits(a["desc_packed"][ia] ^ b["desc_packed"][ib], axis=1).sum(1)
    both = (a["depth"][ia] > 0) & (b["depth"][ib] > 0)
    dd = np.abs(a["depth"][ia][both] - b["depth"][ib][both])
    report = {
        "kp_set_match": keypoint_overlap(a, b),
        "desc_mean_bits_diff": float(bits.mean()) if len(bits) else None,
        "n_stereo": [int((a["depth"] > 0).sum()), int((b["depth"] > 0).sum())],
        "depth_med_absdiff_m": float(np.median(dd)) if len(dd) else None,
    }
    report["pass"] = bool(
        report["kp_set_match"] >= MIN_KP_OVERLAP
        and report["desc_mean_bits_diff"] is not None
        and report["desc_mean_bits_diff"] <= MAX_DESC_BITS
        and report["depth_med_absdiff_m"] is not None
        and report["depth_med_absdiff_m"] <= MAX_DEPTH_DIFF_M
    )
    return report


TLM_CAP = 4096  # fixed local-map candidate capacity (Tracker._TLM_CAP)


def new_store(cap: int) -> dict:
    """An empty point store of `cap` rows (slam_map's PointStore columns the
    fused step reads). A row's index is its map point's id."""
    return dict(
        pos=np.zeros((cap, 3), np.float32), desc_signed=np.ones((cap, 256), np.int8),
        normal=np.zeros((cap, 3), np.float32), min_dist=np.zeros(cap, np.float32),
        max_dist=np.full(cap, np.inf, np.float32), has_desc=np.zeros(cap, bool), n_rows=0,
    )


def store_add_points(store: dict, frame: dict, sel, R_cw, t_cw, intrinsics,
                     scale_factors) -> np.ndarray:
    """New map points from the stereo keypoints `sel` of `frame` (numpy 'x',
    'y', 'level', 'depth', 'desc_packed'), seen from pose (R_cw, t_cw):
    positions by pinhole back-projection, the normal as the viewing
    direction, and the scale-invariance distances of
    MapPoint::UpdateNormalAndDepth (max = dist * scale[level], min = max /
    scale[last level]). Returns their rows."""
    fx, fy, cx, cy = intrinsics
    sel = np.asarray(sel, np.int64)
    rows = store["n_rows"] + np.arange(len(sel))
    if len(rows) and rows[-1] >= len(store["pos"]):
        raise ValueError("point store is full")
    z = frame["depth"][sel].astype(np.float64)
    Xc = np.stack([(frame["x"][sel] - cx) / fx * z, (frame["y"][sel] - cy) / fy * z, z], -1)
    R, t = np.asarray(R_cw, np.float64), np.asarray(t_cw, np.float64)
    Xw = (Xc - t) @ R                     # R^T (Xc - t)
    view = Xw + R.T @ t                   # Xw - O_w, with O_w = -R^T t
    dist = np.linalg.norm(view, axis=-1)
    bits = np.unpackbits(frame["desc_packed"][sel], axis=1, bitorder="little")
    max_dist = dist * scale_factors[frame["level"][sel]]
    store["pos"][rows] = Xw
    store["desc_signed"][rows] = 2 * bits.astype(np.int8) - 1
    store["normal"][rows] = view / np.maximum(dist, 1e-9)[:, None]
    store["max_dist"][rows] = max_dist
    store["min_dist"][rows] = max_dist / scale_factors[-1]
    store["has_desc"][rows] = True
    store["n_rows"] += len(sel)
    return rows


def twm_query_block(store: dict, mp_rows, kp_level, kp_angle, cam: HostCamera,
                    R_pred, t_pred, scale_factors):
    """The TrackWithMotionModel query block of one frame, from the LAST
    frame's state (tracking.py:481-499): its keypoints' map points projected
    with the predicted pose, radius 7 * scale[level], octave gate level
    +- 1. `mp_rows` (M,) are the last frame's store rows, -1 where a
    keypoint has no map point. Returns (q7 (7, M) f32 [u, v, radius, lmin,
    lmax, valid, angle], q_rows (M,) int32, invalid -> 0)."""
    n_levels = len(scale_factors)
    okq = mp_rows >= 0
    okq[okq] &= store["has_desc"][mp_rows[okq]]
    pos = np.zeros((len(mp_rows), 3), np.float32)
    pos[okq] = store["pos"][mp_rows[okq]]
    Xc = pos @ np.asarray(R_pred).T.astype(np.float32) + np.asarray(t_pred).astype(np.float32)
    uvp = project_np(cam, Xc)
    okq &= frustum_depth_ok(cam, Xc) & in_image_np(cam, uvp)
    q7 = np.stack([
        uvp[:, 0], uvp[:, 1], 7.0 * scale_factors[kp_level],
        np.maximum(kp_level - 1, 0), np.minimum(kp_level + 1, n_levels - 1),
        okq.astype(np.float64), kp_angle,
    ]).astype(np.float32)
    return q7, np.where(okq, mp_rows, 0).astype(np.int32)


def tlm_candidate_block(store: dict, cand_rows, cap: int = TLM_CAP):
    """The local-map candidates as `tlm_step` takes them
    (Tracker._pack_tlm_candidates): the first `cap` of `cand_rows` that have
    a descriptor, padded to `cap`. Returns (rows (cap,) int32 with invalid
    -> 0, ok (cap,) bool, the j live rows)."""
    rows = np.asarray(cand_rows, np.int64)[:cap]
    rows = rows[store["has_desc"][rows]]
    j = len(rows)
    rows_p = np.zeros(cap, np.int32)
    ok = np.zeros(cap, bool)
    rows_p[:j] = rows
    ok[:j] = True
    return rows_p, ok, rows


def bind_fused_frame(n_keypoints: int, last_rows, idxA, keepA, cand_rows, cand_ok,
                     idxB, keepB, inliers_kp) -> np.ndarray:
    """The new frame's map-point rows from a fused step's fetch
    (tracking.py:577-586): TWM bindings, then TLM bindings (the first
    binding wins for a point bound by both), then the final pose
    optimization's outliers unbound. Returns (N,) rows, -1 = none."""
    mp = np.full(n_keypoints, -1, np.int64)
    mp[idxA[keepA]] = last_rows[keepA]
    selB = keepB & cand_ok & ~np.isin(cand_rows, last_rows[keepA])
    mp[idxB[selB]] = cand_rows[selB]
    mp[~inliers_kp & (mp >= 0)] = -1
    return mp

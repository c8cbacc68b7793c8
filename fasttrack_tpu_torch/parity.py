"""Holding one run of the tracking front end against another (numpy only).

Keypoint slot order is not part of the contract (two backends may order
tied candidates differently), so keypoints are compared as sets of
(x, y, level), descriptors and depths on co-detected keypoints — the
thresholds of tools/tpu_golden_check.py: set overlap >= 0.97, mean
descriptor bit difference <= 4, median depth difference <= 0.05 m.
Also the synthetic stereo frames both sides run on.
"""

from __future__ import annotations

import numpy as np

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

"""Host (NumPy + native C++) sides of the offload toggles, and the exact
masked best-match search of the local mapper.

Port of fasttrack_tpu/ops/host_kernels.py. The reference's contribution is
per-stage GPU/CPU selection (KernelController.cu:31-37); these are the CPU
sides, dispatched by the tracker at the same four call sites as the
reference:

- ORB extraction      (ORBextractor.cc:1374: CPU ComputePyramid/FAST/BRIEF)
- stereo match        (Frame.cc:156: Frame::ComputeStereoMatches)
- search local points (ORBmatcher.cc:227: host SearchByProjection)
- pose estimation     (ORBmatcher.cc:1992: host frame-to-frame search)

They share the semantic constants of the device stages (BRIEF pattern and
its angle-binned sampling offsets, the IC-angle circular mask, the pyramid
resample matrices, TH_HIGH) and are NumPy on purpose, with the JAX
package's dtypes, so that each equals its JAX counterpart bit for bit.
Hamming distances, FAST scores and the quadtree distribution come from the
port's native library (native.py). The IC angle is taken from the RAW
pyramid here, as ORB-SLAM3 does, and from the blurred one by the device
extractor (ROADMAP F1: mirrored per toggle).

`search_by_projection_exact` is the device counterpart of
`host_search_by_projection` that the local mapper's fusion calls: the full
(M, N) Hamming matrix from the matrix kernel, with the kernel's rank-1
penalties doing the row and column validity masks, masked by window, octave
band and validity, then the first best column of every row, with no top-K
truncation. The f32 matrix holds exact integers, so it equals the host
function integer for integer.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fasttrack_tpu_torch import native
from fasttrack_tpu_torch.ops.descriptor import (
    N_ANGLE_BINS,
    PATCH_HALF_EXT,
    _sampling_indices,
)
from fasttrack_tpu_torch.ops.hamming_kernel import hamming_penalty_matrix
from fasttrack_tpu_torch.ops.orientation import _DX, _DY, _MASK, HALF_PATCH
from fasttrack_tpu_torch.ops.project_match import BIG, HISTO_LENGTH, TH_HIGH
from fasttrack_tpu_torch.ops.pyramid import _pyramid_matrices_np

MASKED = float(1 << 20)   # the distance of a masked pair
_BIG = np.int32(1 << 20)
# (N_ANGLE_BINS, 512) flat-patch offsets of the rotated BRIEF samples: the
# JAX package's one-hot sampling matrices as a gather (a float32 product with
# a one-hot row is exact, so the values are the same)
_SAMPLING_IDX = _sampling_indices()


class HostKeypoints(NamedTuple):
    """Host mirror of ops.extractor.Keypoints (fixed capacity, masked)."""

    x: np.ndarray          # (N,) float32 level-0 coords
    y: np.ndarray
    xl: np.ndarray         # (N,) int32 native-level coords
    yl: np.ndarray
    level: np.ndarray      # (N,) int32
    angle: np.ndarray      # (N,) float32
    score: np.ndarray
    desc_packed: np.ndarray  # (N, 32) uint8
    desc_signed: np.ndarray  # (N, 256) int8
    valid: np.ndarray        # (N,) bool


def host_build_pyramid(img: np.ndarray, pcfg) -> tuple[np.ndarray, np.ndarray]:
    """(H, W) -> (raw (L,H,W), blurred (L,H,W)) with the same resample+blur
    matrices the device pyramid uses (ops.pyramid._pyramid_matrices_np)."""
    rows, cols = _pyramid_matrices_np(pcfg)
    img = np.asarray(img, np.float32)
    L = pcfg.n_levels
    out = np.einsum("lhk,kw,lvw->lhv", rows, img, cols, optimize=True)
    return out[:L], out[L:]


def _host_extract_from_pyramid(raw: np.ndarray, blur: np.ndarray, config) -> HostKeypoints:
    pcfg = config.pyramid
    sizes = pcfg.level_sizes
    per_level = config.per_level_features()
    scales = np.asarray([config.scale_factor**l for l in range(config.n_levels)], np.float32)

    cap = config.total_features
    x0 = np.zeros(cap, np.float32)
    y0 = np.zeros(cap, np.float32)
    xl = np.zeros(cap, np.int32)
    yl = np.zeros(cap, np.int32)
    lv = np.zeros(cap, np.int32)
    sc = np.zeros(cap, np.float32)
    valid = np.zeros(cap, bool)

    pos = 0
    border = 16
    for l in range(config.n_levels):
        h, w = sizes[l]
        k_l = per_level[l]
        score = native.fast_score(raw[l, :h, :w])
        score[:border] = 0
        score[-border:] = 0
        score[:, :border] = 0
        score[:, -border:] = 0
        # 3x3 non-max suppression
        s = score
        m = np.ones_like(s, bool)
        m[1:] &= s[1:] >= s[:-1]
        m[:-1] &= s[:-1] >= s[1:]
        m[:, 1:] &= s[:, 1:] >= s[:, :-1]
        m[:, :-1] &= s[:, :-1] >= s[:, 1:]
        peaks = m & (s > config.min_threshold)
        py, px = np.nonzero(peaks)
        if len(py) == 0:
            continue
        sel = native.distribute_octree(
            px.astype(np.float32), py.astype(np.float32),
            s[py, px].astype(np.float32), (0, w, 0, h), k_l,
        )
        n = min(len(sel), k_l, cap - pos)
        i = sel[:n]
        xl[pos:pos + n] = px[i]
        yl[pos:pos + n] = py[i]
        lv[pos:pos + n] = l
        sc[pos:pos + n] = s[py[i], px[i]]
        x0[pos:pos + n] = px[i] * scales[l]
        y0[pos:pos + n] = py[i] * scales[l]
        valid[pos:pos + n] = True
        pos += n

    # IC angle on the raw pyramid + BRIEF on the blurred pyramid.
    angle = np.zeros(cap, np.float32)
    bits = np.zeros((cap, 256), np.uint8)
    ph = PATCH_HALF_EXT
    H0, W0 = pcfg.height, pcfg.width
    sx = np.clip(xl, ph, W0 - ph - 1)
    sy = np.clip(yl, ph, H0 - ph - 1)
    idx = np.where(valid)[0]
    if len(idx):
        for i in idx:
            p = raw[lv[i], sy[i] - HALF_PATCH:sy[i] + HALF_PATCH + 1,
                    sx[i] - HALF_PATCH:sx[i] + HALF_PATCH + 1]
            m10 = float(np.sum(_DX * _MASK * p))
            m01 = float(np.sum(_DY * _MASK * p))
            angle[i] = np.arctan2(m01, m10)
        # BRIEF: the per-angle-bin sampling offsets of the device descriptor
        P = 2 * ph + 1
        patches = np.zeros((len(idx), P * P), np.float32)
        for j, i in enumerate(idx):
            patches[j] = blur[lv[i], sy[i] - ph:sy[i] + ph + 1,
                              sx[i] - ph:sx[i] + ph + 1].reshape(-1)
        frac = (angle[idx] / (2 * np.pi)) % 1.0
        bins = np.clip(np.round(frac * N_ANGLE_BINS).astype(np.int32) % N_ANGLE_BINS,
                       0, N_ANGLE_BINS - 1)
        for b in range(N_ANGLE_BINS):
            rows_b = np.where(bins == b)[0]
            if not len(rows_b):
                continue
            vals = patches[rows_b][:, _SAMPLING_IDX[b]]  # (nb, 512)
            bits[idx[rows_b]] = (vals[:, 0::2] < vals[:, 1::2]).astype(np.uint8)

    packed = np.packbits(bits.reshape(cap, 32, 8)[..., ::-1], axis=-1).reshape(cap, 32)
    signed = (2 * bits.astype(np.int8) - 1).astype(np.int8)
    signed[~valid] = 0
    return HostKeypoints(x0, y0, xl, yl, lv, angle, sc, packed, signed, valid)


def host_extract_orb_with_pyramid(img: np.ndarray, config):
    """host_extract_orb + the raw and blurred pyramids (the stereo matcher
    needs the raw levels for its SAD refinement)."""
    raw, blur = host_build_pyramid(img, config.pyramid)
    kps = _host_extract_from_pyramid(raw, blur, config)
    return kps, raw, blur


def host_extract_orb(img: np.ndarray, config) -> HostKeypoints:
    """Host ORB extraction (the reference's CPU route,
    ORBextractor.cc:1112-1298): shared-matrix pyramid, native FAST-9 score,
    3x3 NMS, native quadtree distribution per level, IC angle, rotated BRIEF
    through the shared angle-binned sampling offsets."""
    kps, _, _ = host_extract_orb_with_pyramid(img, config)
    return kps


def host_match_rectified(
    kl: HostKeypoints, kr: HostKeypoints,
    raw_l: np.ndarray, raw_r: np.ndarray,
    scale_factors: np.ndarray, bf: float, min_z: float,
):
    """Host rectified stereo matching + SAD subpixel refine + median cull
    (Frame::ComputeStereoMatches, Frame.cc:835). Returns (u_right, depth)."""
    n = len(kl.x)
    u_right = np.full(n, -1.0, np.float32)
    depth = np.full(n, -1.0, np.float32)
    d = native.hamming_matrix_packed(kl.desc_packed, kr.desc_packed)
    r_row = 2.0 * scale_factors[kl.level]
    dy = np.abs(kr.y[None, :] - kl.y[:, None])
    max_d = bf / min_z
    du = kl.x[:, None] - kr.x[None, :]
    mask = (
        (dy <= r_row[:, None]) & (du >= -3.0) & (du <= max_d)
        & (np.abs(kr.level[None, :] - kl.level[:, None]) <= 1)
        & kl.valid[:, None] & kr.valid[None, :]
    )
    dm = np.where(mask, d, _BIG)
    best = dm.argmin(axis=1)
    bdist = dm[np.arange(n), best]
    matched = bdist <= TH_HIGH

    W, S = 5, 5  # half patch, half shift (StereoMatchKernel refine)
    _, H0, W0 = raw_l.shape
    inv_scale = 1.0 / scale_factors
    sads_all = np.full(n, np.nan, np.float32)
    for i in np.where(matched)[0]:
        l = kl.level[i]
        yl, xl_ = int(kl.yl[i]), int(kl.xl[i])
        ur0 = int(round(kr.x[best[i]] * inv_scale[l]))
        yl = int(np.clip(yl, W, H0 - W - 1))
        xl_ = int(np.clip(xl_, W + S + 1, W0 - W - S - 2))
        ur0 = int(np.clip(ur0, W + S + 1, W0 - W - S - 2))
        pl = raw_l[l, yl - W:yl + W + 1, xl_ - W:xl_ + W + 1]
        pl = pl - pl[W, W]
        sads = np.empty(2 * S + 1, np.float32)
        for s in range(-S, S + 1):
            pr = raw_r[l, yl - W:yl + W + 1, ur0 + s - W:ur0 + s + W + 1]
            pr = pr - pr[W, W]
            sads[s + S] = np.abs(pl - pr).sum()
        k = int(sads.argmin())
        if k == 0 or k == 2 * S:
            continue
        c1, c2, c3 = sads[k - 1], sads[k], sads[k + 1]
        denom = max(2.0 * (c1 + c3 - 2.0 * c2), 1e-6)
        delta = (c1 - c3) / denom
        if abs(delta) > 1.0:
            continue
        ur = (ur0 + k - S + delta) * scale_factors[l]
        disp = kl.x[i] - ur
        if disp <= 0.01:
            ur = kl.x[i] - 0.01
            disp = 0.01
        if disp >= max_d:
            continue
        u_right[i] = ur
        depth[i] = bf / disp
        sads_all[i] = c2
    # median cull (Frame.cc:1040-1063)
    good = depth > 0
    if good.any():
        med = np.nanmedian(sads_all[good])
        bad = good & (sads_all > 1.5 * 1.4 * med)
        u_right[bad] = -1.0
        depth[bad] = -1.0
    return u_right, depth


def host_search_by_projection(
    q_uv, q_packed, q_radius, q_lmin, q_lmax, q_valid,
    kp_uv, kp_packed, kp_level, kp_valid,
    kp_taken=None, max_dist=TH_HIGH, ratio=None,
):
    """Host masked best-match search (ORBmatcher::SearchByProjection CPU
    path, ORBmatcher.cc:227-309): square window + octave gate + best/second
    Hamming with the level-aware ratio. Returns (idx, dist, ok); a row with
    nothing in its window has idx 0 and dist 2^20."""
    d = native.hamming_matrix_packed(q_packed, kp_packed)
    du = np.abs(kp_uv[None, :, 0] - q_uv[:, None, 0])
    dv = np.abs(kp_uv[None, :, 1] - q_uv[:, None, 1])
    mask = (
        (du <= q_radius[:, None]) & (dv <= q_radius[:, None])
        & (kp_level[None, :] >= q_lmin[:, None])
        & (kp_level[None, :] <= q_lmax[:, None])
        & kp_valid[None, :] & q_valid[:, None]
    )
    if kp_taken is not None:
        mask &= ~kp_taken[None, :]
    dm = np.where(mask, d, _BIG)
    idx = dm.argmin(axis=1)
    dist = dm[np.arange(len(idx)), idx]
    ok = dist <= max_dist
    if ratio is not None:
        dm2 = dm.copy()
        dm2[np.arange(len(idx)), idx] = _BIG
        i2 = dm2.argmin(axis=1)
        d2 = dm2[np.arange(len(idx)), i2]
        reject = (kp_level[idx] == kp_level[i2]) & (dist > ratio * d2)
        ok &= ~reject
    return idx.astype(np.int32), dist.astype(np.int32), ok


def _resolve_duplicates(idx, dist, ok, n_kp):
    """First-best query per chosen keypoint (host mirror of
    ops.project_match.resolve_duplicates)."""
    keep = np.zeros_like(ok)
    order = np.argsort(np.where(ok, dist, _BIG), kind="stable")
    chosen = set()
    for q in order:
        if not ok[q]:
            break
        k = int(idx[q])
        if k not in chosen:
            chosen.add(k)
            keep[q] = True
    return keep


def host_twm_match(
    q_uv, q_packed, q_radius, q_lmin, q_lmax, q_valid,
    kp_uv, kp_packed, kp_level, kp_valid, q_angle, kp_angle,
):
    """Host pose-estimation matcher (frame-to-frame SearchByProjection +
    rotation-histogram filter, ORBmatcher.cc:1992-2082). Returns (idx, keep)."""
    idx, dist, ok = host_search_by_projection(
        q_uv, q_packed, q_radius, q_lmin, q_lmax, q_valid,
        kp_uv, kp_packed, kp_level, kp_valid,
    )
    # rotation-histogram consistency (ComputeThreeMaxima, ORBmatcher.cc:2210)
    dtheta = q_angle - kp_angle[idx]
    frac = (dtheta / (2 * np.pi)) % 1.0
    bins = np.clip((frac * HISTO_LENGTH).astype(np.int32), 0, HISTO_LENGTH - 1)
    hist = np.bincount(bins[ok], minlength=HISTO_LENGTH)
    order = np.argsort(-hist)
    allowed = bins == order[0]
    if hist[order[1]] >= 0.1 * hist[order[0]]:
        allowed |= bins == order[1]
    if hist[order[2]] >= 0.1 * hist[order[0]]:
        allowed |= bins == order[2]
    ok = ok & allowed
    keep = _resolve_duplicates(idx, dist, ok, len(kp_uv))
    return idx, keep


def host_tlm_match(
    q_uv, q_packed, q_radius, q_lmin, q_lmax, q_valid,
    kp_uv, kp_packed, kp_level, kp_valid, kp_taken,
):
    """Host search-local-points matcher (ORBmatcher.cc:227-309 CPU path).
    Returns (idx, keep)."""
    idx, dist, ok = host_search_by_projection(
        q_uv, q_packed, q_radius, q_lmin, q_lmax, q_valid,
        kp_uv, kp_packed, kp_level, kp_valid, kp_taken=kp_taken, ratio=0.8,
    )
    keep = _resolve_duplicates(idx, dist, ok, len(kp_uv))
    return idx, keep


def search_by_projection_exact(
    q_uv: torch.Tensor,       # (M, 2) float32 projected queries, level-0 px
    q_desc: torch.Tensor,     # (M, 256) int8 +-1
    q_radius: torch.Tensor,   # (M,) float32 square-window radius
    q_lmin: torch.Tensor,     # (M,) int32 inclusive octave gate
    q_lmax: torch.Tensor,     # (M,) int32
    q_valid: torch.Tensor,    # (M,) bool
    kp_uv: torch.Tensor,      # (N, 2) float32 keypoints
    kp_desc: torch.Tensor,    # (N, 256) int8 +-1
    kp_level: torch.Tensor,   # (N,) int32
    kp_valid: torch.Tensor,   # (N,) bool
    max_dist: int = TH_HIGH,
):
    """Masked best-match search (ORBmatcher::SearchByProjection,
    ORBmatcher.cc:227-309) on the tensors' device: square window + octave
    gate + best Hamming over ALL keypoints. Returns (idx (M,) int64, dist
    (M,) int32, ok (M,) bool); a row with nothing in its window has idx 0
    and dist 2^20."""
    d = hamming_penalty_matrix(
        q_desc, kp_desc, (1.0 - q_valid.float()) * BIG, (1.0 - kp_valid.float()) * BIG
    )
    du = torch.abs(kp_uv[None, :, 0] - q_uv[:, None, 0])
    dv = torch.abs(kp_uv[None, :, 1] - q_uv[:, None, 1])
    inside = (
        (du <= q_radius[:, None]) & (dv <= q_radius[:, None])
        & (kp_level[None, :] >= q_lmin[:, None])
        & (kp_level[None, :] <= q_lmax[:, None])
    )
    # a penalised (invalid) pair sits at >= 1e9: clamp it to the masked value
    dm = torch.clamp(torch.where(inside, d, MASKED), max=MASKED)
    idx = torch.argmin(dm, dim=1)     # the first minimum of a row
    dist = torch.gather(dm, 1, idx[:, None])[:, 0]
    return idx, dist.to(torch.int32), dist <= max_dist

"""Rectified stereo descriptor matching with sub-pixel refinement, and the
brute-force ratio matcher.

Port of fasttrack_tpu/ops/stereo_match.py: `match_rectified` and
`match_fisheye` (all-pairs Hamming, top-2, Lowe ratio: one launch of the
fused kernel with K = 2). For `match_rectified`, the TOP_K
nearest right keypoints of every left keypoint by penalised Hamming
distance come from the fused Hamming+penalty+top-K kernel (the (N_L, N_R)
matrix is never formed on the card); they are then gated by the row
band, the disparity window and the octave band as additive penalties
(exact unless a true in-window match falls outside the K best). The
refinement is an 11x11 SAD over +-5 px at the left keypoint's octave with
a parabola fit, followed by the median-SAD cull (Frame.cc:1007-1063).
The patches are gathered directly from the raw pyramids.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fasttrack_tpu_torch.ops.hamming_kernel import hamming_penalty_topk
from fasttrack_tpu_torch.ops.orientation import gather_windows

TH_HIGH = 100
BIG = 1e9
PEN = 1e6     # per-unit window-excess penalty (>> 256 max Hamming)
TOP_K = 64    # Hamming candidates per query kept for window gating
W_PATCH = 5   # half window (11x11 patch)
L_SHIFT = 5   # +-5 px sub-pixel search


def valid_penalty(valid: torch.Tensor) -> torch.Tensor:
    """(n,) validity -> additive penalty (0 valid / 1e9 invalid)."""
    return (1.0 - valid.float()) * BIG


class StereoMatches(NamedTuple):
    u_right: torch.Tensor  # (N,) float32, -1 where unmatched
    depth: torch.Tensor    # (N,) float32, -1 where unmatched
    valid: torch.Tensor    # (N,) bool


def match_rectified(
    l_x, l_y, l_level, l_desc, l_valid,   # left keypoints (N,) / (N, 256) int8
    r_x, r_y, r_level, r_desc, r_valid,   # right keypoints (M,) / (M, 256) int8
    l_pyr: torch.Tensor,     # (L, H, W) raw pyramids for the refinement
    r_pyr: torch.Tensor,
    l_xl: torch.Tensor,      # (N,) int32 left keypoint coords at native level
    l_yl: torch.Tensor,
    scale_factors: torch.Tensor,  # (L,)
    bf: torch.Tensor,        # baseline * fx
    min_z: torch.Tensor,     # baseline (minZ = b, Frame.cc:842)
) -> StereoMatches:
    """One-shot rectified stereo matching + refinement + median cull."""
    n = l_x.shape[0]
    cd, ni = hamming_penalty_topk(
        l_desc, r_desc, valid_penalty(l_valid), valid_penalty(r_valid), TOP_K
    )                                # (N, K)
    c_y, c_x, c_l = r_y[ni], r_x[ni], r_level[ni].float()
    r_row = 2.0 * scale_factors[l_level]
    dy = torch.abs(c_y - l_y[:, None])
    du = l_x[:, None] - c_x                  # = disparity if matched
    dl = torch.abs(c_l - l_level[:, None].float())
    max_d = bf / min_z
    pen = (
        torch.clamp(dy - r_row[:, None], min=0.0)
        + torch.clamp(-3.0 - du, min=0.0) + torch.clamp(du - max_d, min=0.0)
        + torch.clamp(dl - 1.0, min=0.0)
    ) * PEN
    cdp = cd + pen                            # (N, K)
    best_dist, j = torch.min(cdp, dim=1)
    best_idx = torch.gather(ni, 1, j[:, None])[:, 0]
    matched = best_dist <= TH_HIGH

    # --- sub-pixel refinement at the left keypoint's octave ----------------
    scaled_uR = r_x[best_idx] * (1.0 / scale_factors)[l_level]  # right u at left's octave
    P = 2 * W_PATCH + 1
    S = 2 * L_SHIFT + 1
    _, H0, W0 = l_pyr.shape
    safe_y = torch.clamp(l_yl, W_PATCH, H0 - W_PATCH - 1)
    safe_x = torch.clamp(l_xl, W_PATCH + L_SHIFT + 1, W0 - W_PATCH - L_SHIFT - 2)
    safe_ur = torch.clamp(scaled_uR, W_PATCH + L_SHIFT + 1, W0 - W_PATCH - L_SHIFT - 2)
    ur0 = torch.round(safe_ur).to(torch.int32)

    patch_l = gather_windows(l_pyr, l_level, safe_y - W_PATCH, safe_x - W_PATCH, P, P)
    win_r = gather_windows(
        r_pyr, l_level, safe_y - W_PATCH, ur0 - W_PATCH - L_SHIFT, P, P + 2 * L_SHIFT
    )                                                                 # (N, P, P + 2 L_SHIFT)
    patch_l = patch_l - patch_l[:, W_PATCH, W_PATCH][:, None, None]
    patch_r = win_r.unfold(2, P, 1).permute(0, 2, 1, 3)               # (N, S, P, P)
    patch_r = patch_r - patch_r[:, :, W_PATCH, W_PATCH][:, :, None, None]
    sads = torch.sum(torch.abs(patch_l[:, None] - patch_r), dim=(-1, -2))  # (N, S)

    k = torch.argmin(sads, dim=1)
    ok_k = (k > 0) & (k < S - 1)
    km = torch.clamp(k, 1, S - 2)
    c1, c2, c3 = (torch.gather(sads, 1, (km + off)[:, None])[:, 0] for off in (-1, 0, 1))
    denom = torch.clamp(2.0 * (c1 + c3 - 2.0 * c2), min=1e-6)
    delta = (c1 - c3) / denom
    ok_d = torch.abs(delta) <= 1.0
    ur_ref = ur0.float() + (km - L_SHIFT).float() + delta
    sad_best = c2
    ok_ref = ok_k & ok_d

    # Back to level-0 coords; disparity and depth gates (Frame.cc:986-1004).
    u_right = ur_ref * scale_factors[l_level]
    disparity = l_x - u_right
    disparity_ok = (disparity > 0.01) & (disparity < max_d)
    u_right = torch.where(disparity <= 0.01, l_x - 0.01, u_right)
    depth = bf / torch.clamp(disparity, min=0.01)
    good = matched & ok_ref & disparity_ok

    # Median-SAD cull: drop matches whose SAD exceeds 1.5 * 1.4 * median.
    sad_sorted = torch.sort(sad_best + (1.0 - good.float()) * BIG).values
    n_good = good.sum()
    mid = torch.clamp(torch.div(n_good - 1, 2, rounding_mode="floor"), 0, n - 1)
    med = torch.where(n_good > 0, sad_sorted.gather(0, mid[None])[0], BIG)
    good = good & (sad_best <= 1.5 * 1.4 * med)

    return StereoMatches(
        torch.where(good, u_right, -1.0),
        torch.where(good, depth, -1.0),
        good,
    )


class FisheyeMatches(NamedTuple):
    idx_right: torch.Tensor  # (N,) int32 best right index
    valid: torch.Tensor      # (N,) bool (Lowe-ratio accepted)


def match_fisheye(
    l_desc: torch.Tensor, l_valid: torch.Tensor,
    r_desc: torch.Tensor, r_valid: torch.Tensor,
    ratio: float = 0.7,
    max_dist: int = TH_HIGH,
) -> FisheyeMatches:
    """Brute-force all-pairs Hamming + Lowe ratio
    (fisheyeStereoMatchKernel, StereoMatchKernel.cu:311-348). Best and
    second best of every row come from one launch of the fused
    Hamming+penalty+top-K kernel with K = 2. A row whose query is invalid
    ties at 1e9 (2e9 on invalid columns) across all columns; the kernel
    orders equal values by ascending column, as lax.top_k does."""
    top2, ni2 = hamming_penalty_topk(
        l_desc, r_desc, valid_penalty(l_valid), valid_penalty(r_valid), 2
    )
    best, second = top2[:, 0], top2[:, 1]
    ok = (best <= max_dist) & (best < ratio * second)
    return FisheyeMatches(ni2[:, 0].to(torch.int32), ok)

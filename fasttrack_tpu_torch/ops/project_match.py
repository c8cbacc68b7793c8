"""Masked search-by-projection matching — the workhorse of tracking.

Port of fasttrack_tpu/ops/project_match.py:search_by_projection. The full
(M, N) penalised Hamming matrix comes from the Hamming+penalty kernel
(validity and the taken mask as rank-1 penalties); the TOP_K best
candidates per query are then gated by the square window and the octave
band as additive penalties, with the optional level-aware ratio test
(ORBmatcher.cc:227-309).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fasttrack_tpu_torch.ops.hamming_kernel import hamming_penalty_matrix
from fasttrack_tpu_torch.ops.topk import top_k

TH_HIGH = 100  # ORBmatcher.cc:41
TH_LOW = 50    # ORBmatcher.cc:42
BIG = 1e9
PEN = 1e6
TOP_K = 64     # Hamming candidates per query kept for window gating


class MatchResult(NamedTuple):
    idx: torch.Tensor   # (M,) int64 best frame-keypoint index (undefined if !ok)
    dist: torch.Tensor  # (M,) float32 best Hamming distance (exact integer)
    ok: torch.Tensor    # (M,) bool


def search_by_projection(
    q_u: torch.Tensor,         # (M,) projected query u, level-0 px
    q_v: torch.Tensor,         # (M,)
    q_desc: torch.Tensor,      # (M, 256) int8
    q_radius: torch.Tensor,    # (M,) search window radius (px)
    q_level_min: torch.Tensor, # (M,) int inclusive octave gate
    q_level_max: torch.Tensor, # (M,) int inclusive
    q_valid: torch.Tensor,     # (M,) bool
    kp_x: torch.Tensor,        # (N,) frame keypoint positions
    kp_y: torch.Tensor,        # (N,)
    kp_desc: torch.Tensor,     # (N, 256) int8
    kp_level: torch.Tensor,    # (N,) int
    kp_valid: torch.Tensor,    # (N,) bool
    kp_taken: torch.Tensor | None = None,  # (N,) bool: already bound to a map point
    max_dist: int = TH_HIGH,
    ratio: float | None = None,            # level-aware second-best ratio (0.8 SLP)
) -> MatchResult:
    """Best-match search with square-window + octave gating: the window
    test is |du| <= r and |dv| <= r, Frame::GetFeaturesInArea's gate."""
    q_pen = (1.0 - q_valid.float()) * BIG
    k_pen = (1.0 - kp_valid.float()) * BIG
    if kp_taken is not None:
        k_pen = k_pen + kp_taken.float() * BIG
    dm = hamming_penalty_matrix(q_desc, kp_desc, q_pen, k_pen)

    K = min(TOP_K, dm.shape[1])
    neg_cd, ni = top_k(-dm, K)             # (M, K)
    cd = -neg_cd
    c_l = kp_level[ni].float()
    du = torch.abs(kp_x[ni] - q_u[:, None])
    dv = torch.abs(kp_y[ni] - q_v[:, None])
    pen = (
        torch.clamp(du - q_radius[:, None], min=0.0)
        + torch.clamp(dv - q_radius[:, None], min=0.0)
        + torch.clamp(q_level_min[:, None].float() - c_l, min=0.0)
        + torch.clamp(c_l - q_level_max[:, None].float(), min=0.0)
    ) * PEN
    cdp = cd + pen                         # (M, K)
    best_dist, j = torch.min(cdp, dim=1)
    best_idx = torch.gather(ni, 1, j[:, None])[:, 0]
    ok = best_dist <= max_dist

    if ratio is not None:
        best_level = torch.gather(c_l, 1, j[:, None])[:, 0]
        # knock the chosen candidate out of the small (M, K) list
        chosen = torch.arange(K, device=cdp.device) == j[:, None]
        second_dist, j2 = torch.min(torch.where(chosen, cdp + BIG, cdp), dim=1)
        second_level = torch.gather(c_l, 1, j2[:, None])[:, 0]
        # ORBmatcher.cc:293-296: the ratio applies only when best and second
        # best lie on the same pyramid level.
        reject = (best_level == second_level) & (best_dist > ratio * second_dist)
        ok = ok & ~reject

    return MatchResult(best_idx, best_dist, ok)

"""Masked search-by-projection matching — the workhorse of tracking.

Port of fasttrack_tpu/ops/project_match.py: `search_by_projection`, the
rotation-histogram filter, the per-keypoint dedup and the two matchers
built from them (`twm_match`, `tlm_match`, and their `_packed` forms that
take the query side as one uploaded block). The TOP_K best Hamming
candidates of every query come from the fused Hamming+penalty+top-K kernel
(validity and the taken mask as rank-1 penalties; the (M, N) matrix is
never formed on the card); they are then gated by the square window and
the octave band as additive penalties, with the optional level-aware ratio
test (ORBmatcher.cc:227-309). The two halves are separate functions
(`hamming_candidates`, `gate_candidates`) so that a caller that searches
twice with different windows selects once.

`epipolar_match` and `epipolar_match_tri_batch` are the local mapper's
matchers (SearchForTriangulation): the same kernel, then the epiline gate in
place of the window. The batch of neighbour keyframes against one keyframe is
ONE launch with the neighbours' rows stacked, since the columns and their
penalty are the same for every neighbour.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from fasttrack_tpu_torch.ops.hamming_kernel import hamming_penalty_topk
from fasttrack_tpu_torch.ops.topk import top_k

TH_HIGH = 100  # ORBmatcher.cc:41
TH_LOW = 50    # ORBmatcher.cc:42
HISTO_LENGTH = 30
BIG = 1e9
PEN = 1e6
TOP_K = 64     # Hamming candidates per query kept for window gating


class MatchResult(NamedTuple):
    idx: torch.Tensor   # (M,) int64 best frame-keypoint index (undefined if !ok)
    dist: torch.Tensor  # (M,) float32 best Hamming distance (exact integer)
    ok: torch.Tensor    # (M,) bool


class Candidates(NamedTuple):
    dist: torch.Tensor  # (M, K) float32 penalised Hamming distance, ascending
    idx: torch.Tensor   # (M, K) int64 frame-keypoint index


def hamming_candidates(
    q_desc: torch.Tensor,      # (M, 256) int8
    q_valid: torch.Tensor,     # (M,) bool
    kp_desc: torch.Tensor,     # (N, 256) int8
    kp_valid: torch.Tensor,    # (N,) bool
    kp_taken: torch.Tensor | None = None,  # (N,) bool: already bound to a map point
) -> Candidates:
    """The TOP_K nearest keypoints of every query by Hamming distance, with
    validity and the taken mask as 1e9 penalties: one kernel launch."""
    q_pen = (1.0 - q_valid.float()) * BIG
    k_pen = (1.0 - kp_valid.float()) * BIG
    if kp_taken is not None:
        k_pen = k_pen + kp_taken.float() * BIG
    return Candidates(*hamming_penalty_topk(q_desc, kp_desc, q_pen, k_pen, TOP_K))


def gate_candidates(
    cands: Candidates,
    q_u: torch.Tensor,         # (M,) projected query u, level-0 px
    q_v: torch.Tensor,         # (M,)
    q_radius: torch.Tensor,    # (M,) search window radius (px)
    q_level_min: torch.Tensor, # (M,) int inclusive octave gate
    q_level_max: torch.Tensor, # (M,) int inclusive
    kp_x: torch.Tensor,        # (N,) frame keypoint positions
    kp_y: torch.Tensor,        # (N,)
    kp_level: torch.Tensor,    # (N,) int
    max_dist: int = TH_HIGH,
    ratio: float | None = None,
) -> MatchResult:
    """Best candidate inside the square window |du| <= r, |dv| <= r
    (Frame::GetFeaturesInArea's gate) and the octave band."""
    cd, ni = cands
    K = cd.shape[1]
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
    """Best-match search with square-window + octave gating."""
    cands = hamming_candidates(q_desc, q_valid, kp_desc, kp_valid, kp_taken)
    return gate_candidates(
        cands, q_u, q_v, q_radius, q_level_min, q_level_max, kp_x, kp_y, kp_level,
        max_dist=max_dist, ratio=ratio,
    )


def rotation_consistency(
    q_angle: torch.Tensor,   # (M,) reference angles (e.g. last-frame keypoints)
    kp_angle: torch.Tensor,  # (N,) current-frame keypoint angles
    res: MatchResult,
) -> torch.Tensor:
    """Keep only matches whose angle difference falls in the 3 dominant
    30-bin histogram buckets (ORBmatcher.cc ComputeThreeMaxima :2210).
    Equal bins rank by index, lower first, as lax.top_k and a stable
    argsort order them."""
    dtheta = q_angle - kp_angle[res.idx]
    frac = torch.remainder(dtheta / (2 * math.pi), 1.0)
    bins = torch.clamp((frac * HISTO_LENGTH).to(torch.int64), 0, HISTO_LENGTH - 1)
    hist = torch.zeros(HISTO_LENGTH, dtype=torch.float32, device=bins.device)
    hist.index_add_(0, bins, res.ok.float())  # counts: exact in any order
    top3, order = top_k(hist, 3)
    # ORBmatcher: drop bins 2/3 when much weaker than the best bin.
    keep2 = top3[1] >= 0.1 * top3[0]
    keep3 = top3[2] >= 0.1 * top3[0]
    allowed = (bins == order[0]) | (keep2 & (bins == order[1])) | (keep3 & (bins == order[2]))
    return res.ok & allowed


def resolve_duplicates(res: MatchResult, n_keypoints: int) -> torch.Tensor:
    """Per-keypoint winner among queries that chose it (min distance), like
    the reference host loop that overwrites F.mvpMapPoints[idx]; equal
    distances go to the first query. Returns (M,) bool: query keeps its
    match."""
    m = res.idx.shape[0]
    device = res.idx.device
    key = res.dist + (1.0 - res.ok.float()) * BIG
    best_per_kp = torch.full((n_keypoints,), float("inf"), dtype=key.dtype, device=device)
    best_per_kp.scatter_reduce_(0, res.idx, key, "amin")
    is_winner = res.ok & (key == best_per_kp[res.idx])
    qidx = torch.arange(m, dtype=torch.int64, device=device)
    tie_key = torch.where(is_winner, qidx, 1 << 30)
    first_winner = torch.full((n_keypoints,), 1 << 30, dtype=torch.int64, device=device)
    first_winner.scatter_reduce_(0, res.idx, tie_key, "amin")
    return is_winner & (qidx == first_winner[res.idx])


def _epipolar_gate(cd, ni, u1, v1, u2, v2, F12, sigma2_2):
    """Best candidate of every row under the point-to-epiline chi2 gate (as a
    float penalty). cd, ni: (..., N1, K) candidates into image 2; u1, v1:
    (..., N1); F12: (..., 3, 3). Returns (best_idx, best_dist, ok), (..., N1)."""
    F = F12[..., None, :, :]                    # broadcast over the N1 rows
    # epilines as rank-1 arithmetic: l = F12 @ [u1, v1, 1]
    a = (F[..., 0, 0] * u1 + F[..., 0, 1] * v1 + F[..., 0, 2])[..., None]
    b = (F[..., 1, 0] * u1 + F[..., 1, 1] * v1 + F[..., 1, 2])[..., None]
    c = (F[..., 2, 0] * u1 + F[..., 2, 1] * v1 + F[..., 2, 2])[..., None]
    num = a * u2[ni] + b * v2[ni] + c           # (..., N1, K)
    dsq = num**2 / torch.clamp(a**2 + b**2, min=1e-12)
    cdp = cd + torch.clamp(dsq - 3.84 * sigma2_2[ni], min=0.0) * PEN
    best, j = torch.min(cdp, dim=-1)
    best_idx = torch.gather(ni, -1, j[..., None])[..., 0]
    return best_idx, best, best <= TH_LOW


def _free_penalty(free: torch.Tensor) -> torch.Tensor:
    return (1.0 - free.float()) * BIG


def epipolar_match(
    u1, v1, desc1, free1,     # KF1 keypoints (unbound only: free mask)
    u2, v2, desc2, free2,     # KF2 keypoints
    F12,                      # (3,3) fundamental with x2^T F12 x1 = 0
    sigma2_2,                 # (N2,) level variance in image 2
):
    """Epipolar-constrained descriptor matching for triangulation
    (ORBmatcher::SearchForTriangulation, ORBmatcher.cc:1006): best Hamming
    match under TH_LOW with the point-to-epiline chi2 gate, one row per
    chosen column. Returns (idx2 (N1,) int64, keep (N1,) bool)."""
    cd, ni = hamming_penalty_topk(
        desc1, desc2, _free_penalty(free1), _free_penalty(free2), TOP_K
    )
    best_idx, best, ok = _epipolar_gate(cd, ni, u1, v1, u2, v2, F12, sigma2_2)
    keep = ok & resolve_duplicates(MatchResult(best_idx, best, ok), u2.shape[0])
    return best_idx, keep


def epipolar_match_tri_batch(
    u1, v1, d1, f1,           # (B, N1), (B, N1, 256), (B, N1) neighbor KFs
    u2, v2, d2, f2,           # (N2,), (N2, 256), (N2,)   current KF (shared)
    F12, sigma2_2,            # (B, 3, 3), (N2,)
    R21, t21,                 # (B, 3, 3), (B, 3)  camera2<-camera1 per pair
    fx, fy, cx, cy,
):
    """Batched SearchForTriangulation + DLT triangulation: ALL covisible
    neighbor pairs of one new keyframe in one pass. The B * N1 neighbour rows
    are stacked into ONE Hamming + penalty + top-K launch against the current
    keyframe (its columns and their penalty are the same for every pair); the
    epiline gate, the per-pair dedup and the triangulation follow on the
    device. Returns (idx2 (B,N1) int64, keep (B,N1) bool, X1 (B,N1,3) f32
    points in each neighbor's frame); rows with keep=False are garbage and
    must be masked by the host."""
    from fasttrack_tpu_torch.cameras.stereo import triangulate_two_view
    from fasttrack_tpu_torch.geometry import SE3

    B, N1 = u1.shape
    N2 = u2.shape[0]
    cd, ni = hamming_penalty_topk(
        d1.reshape(B * N1, d1.shape[-1]), d2,
        _free_penalty(f1).reshape(-1), _free_penalty(f2), TOP_K,
    )
    cd = cd.view(B, N1, -1)
    ni = ni.view(B, N1, -1)
    idx2, best, ok = _epipolar_gate(cd, ni, u1, v1, u2, v2, F12, sigma2_2)
    # one-to-one per pair: pair b's columns become segment b of B * N2
    offset = (torch.arange(B, device=idx2.device) * N2)[:, None]
    flat = MatchResult((idx2 + offset).reshape(-1), best.reshape(-1), ok.reshape(-1))
    keep = ok & resolve_duplicates(flat, B * N2).view(B, N1)

    r1 = torch.stack([(u1 - cx) / fx, (v1 - cy) / fy, torch.ones_like(u1)], dim=-1)
    u2s, v2s = u2[idx2], v2[idx2]
    r2 = torch.stack([(u2s - cx) / fx, (v2s - cy) / fy, torch.ones_like(u2s)], dim=-1)
    X1 = triangulate_two_view(r1, r2, SE3(R21[:, None], t21[:, None]))
    return idx2, keep, X1


def twm_keep(q_angle, kp_angle, res: MatchResult, n_keypoints: int) -> torch.Tensor:
    """TrackWithMotionModel's filters on a search result: the rotation
    histogram, then one query per keypoint."""
    keep = rotation_consistency(q_angle, kp_angle, res)
    return keep & resolve_duplicates(res._replace(ok=keep), n_keypoints)


def twm_match(
    q_u, q_v, q_desc, q_radius, q_level_min, q_level_max, q_valid,
    kp_x, kp_y, kp_desc, kp_level, kp_valid, q_angle, kp_angle,
):
    """TrackWithMotionModel matcher: search + rotation-histogram filter +
    per-keypoint dedup. Returns (idx (M,), keep (M,))."""
    res = search_by_projection(
        q_u, q_v, q_desc, q_radius, q_level_min, q_level_max, q_valid,
        kp_x, kp_y, kp_desc, kp_level, kp_valid,
    )
    return res.idx, twm_keep(q_angle, kp_angle, res, kp_x.shape[0])


def tlm_match(
    q_u, q_v, q_desc, q_radius, q_level_min, q_level_max, q_valid,
    kp_x, kp_y, kp_desc, kp_level, kp_valid, kp_taken,
):
    """TrackLocalMap matcher: search with taken-mask + level-aware ratio +
    dedup. Returns (idx (M,), keep (M,))."""
    res = search_by_projection(
        q_u, q_v, q_desc, q_radius, q_level_min, q_level_max, q_valid,
        kp_x, kp_y, kp_desc, kp_level, kp_valid, kp_taken=kp_taken, ratio=0.8,
    )
    keep = res.ok & resolve_duplicates(res, kp_x.shape[0])
    return res.idx, keep


def twm_match_packed(q7, q_desc, kp_x, kp_y, kp_desc, kp_level, kp_valid, kp_angle):
    """twm_match with the query side packed into ONE (7, M) f32 upload
    [u, v, radius, level_min, level_max, valid, angle]: every separate
    host->device array is its own transfer."""
    return twm_match(
        q7[0], q7[1], q_desc, q7[2],
        q7[3].to(torch.int32), q7[4].to(torch.int32), q7[5] > 0.5,
        kp_x, kp_y, kp_desc, kp_level, kp_valid, q7[6], kp_angle,
    )


def tlm_match_packed(q6, q_desc, kp_x, kp_y, kp_desc, kp_level, kp_valid, taken_f32):
    """tlm_match with the query side packed into ONE (6, M) f32 upload
    [u, v, radius, level_min, level_max, valid]."""
    return tlm_match(
        q6[0], q6[1], q_desc, q6[2],
        q6[3].to(torch.int32), q6[4].to(torch.int32), q6[5] > 0.5,
        kp_x, kp_y, kp_desc, kp_level, kp_valid, taken_f32 > 0.5,
    )

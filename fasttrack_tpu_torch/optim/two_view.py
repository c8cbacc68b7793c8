"""Monocular two-view reconstruction: batched H/F RANSAC + model selection.

Port of fasttrack_tpu/optim/two_view.py. Parity target:
src/TwoViewReconstruction.cc: homography and fundamental RANSAC
(:105-106), truncated symmetric transfer chi2 scores
(CheckHomography/CheckFundamental), H chosen when SH/(SH+SF) > 0.4, then
R, t by a triangulation census over the decompositions (ReconstructH/F,
CheckRT :475-901).

Every hypothesis of both models is solved in one batched SVD per model and
scored against every correspondence at once, so RANSAC is an argmax. The
minimal sets are drawn on the host exactly as the JAX package draws them
(np.random.default_rng(seed): the homography sets first, then the
fundamental ones), so both packages solve the same hypotheses. The JAX
package draws each set's points with replacement, where the reference
draws distinct ones: a set with a repeated point leaves a null space of two
dimensions, whose vector is whatever the SVD routine returns (LAPACK and
cuSOLVER return different ones, and such a hypothesis can win). The port
scores those sets -inf (ROADMAP F32). The device math is float32, as in the
JAX package; the decompositions and the parallax gate run on the host in
NumPy float64.

A call reads the device three times (the best hypotheses with their
inliers, the refit's score with both models, the census of every
candidate), and each of its five `torch.linalg.svd` calls synchronises on
CUDA. It runs once per initialization attempt, off the per-frame path.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fasttrack_tpu_torch.device import resolve
from fasttrack_tpu_torch.nputils import device_fetch

CHI2_H = 5.991
CHI2_F = 3.841
SCORE_TH = 5.991  # the reference adds (TH - chi2) with TH=5.991 for both


def _null_vectors(A: torch.Tensor) -> torch.Tensor:
    """(..., m, n) -> (..., n): the right singular vector of the smallest
    singular value. A wide A is padded with zero rows to square, which
    keeps the null vector and takes the square path of the SVD."""
    m, n = A.shape[-2:]
    if m < n:
        A = torch.cat([A, A.new_zeros(*A.shape[:-2], n - m, n)], dim=-2)
    _, _, vh = torch.linalg.svd(A, full_matrices=False)
    return vh[..., -1, :]


def _repeats_a_point(sets: np.ndarray) -> np.ndarray:
    """(M, k) index sets -> (M,) bool: the set holds some index twice."""
    s = np.sort(sets, axis=1)
    return (s[:, 1:] == s[:, :-1]).any(axis=1)


def _normalize_pts(x: torch.Tensor):
    """Hartley normalization: (mean (2,), scale ()) with the (3, 3) T."""
    mean = x.mean(dim=0)
    d = torch.linalg.norm(x - mean, dim=1).mean()
    s = np.sqrt(2.0) / torch.clamp(d, min=1e-9)
    z = torch.zeros((), dtype=x.dtype, device=x.device)
    o = torch.ones((), dtype=x.dtype, device=x.device)
    T = torch.stack([
        torch.stack([s, z, -s * mean[0]]),
        torch.stack([z, s, -s * mean[1]]),
        torch.stack([z, z, o]),
    ])
    return mean, s, T


def _solve_h_batch(p1, p2):
    """p1, p2: (M, n, 2) point sets -> (M, 3, 3) homographies (DLT)."""
    x, y = p1[..., 0], p1[..., 1]
    u, v = p2[..., 0], p2[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    r1 = torch.stack([x, y, o, z, z, z, -u * x, -u * y, -u], dim=-1)
    r2 = torch.stack([z, z, z, x, y, o, -v * x, -v * y, -v], dim=-1)
    A = torch.cat([r1, r2], dim=1)  # (M, 2n, 9)
    return _null_vectors(A).reshape(-1, 3, 3)


def _solve_f_batch(p1, p2):
    """p1, p2: (M, n, 2) point sets -> (M, 3, 3) rank-2 fundamentals."""
    x, y = p1[..., 0], p1[..., 1]
    u, v = p2[..., 0], p2[..., 1]
    o = torch.ones_like(x)
    A = torch.stack([u * x, u * y, u, v * x, v * y, v, x, y, o], dim=-1)  # (M, n, 9)
    F = _null_vectors(A).reshape(-1, 3, 3)
    # enforce rank 2
    U, S, Vh = torch.linalg.svd(F)
    S = torch.cat([S[:, :2], torch.zeros_like(S[:, 2:])], dim=1)
    return U @ (S[..., None] * Vh)


def _transfer(H, a, b, sigma2):
    """(M, N) squared transfer error of a through each H, against b."""
    ah = torch.cat([a, torch.ones_like(a[:, :1])], dim=-1)
    pr = torch.einsum("mij,nj->mni", H, ah)
    w = pr[..., 2:3]
    pr = pr[..., :2] / torch.where(w.abs() < 1e-9, 1e-9, w)
    return ((pr - b) ** 2).sum(-1) / sigma2


def _score_h(H, p1, p2, sigma2):
    """Symmetric transfer score over all points: (M,) score, (M, N) inlier."""
    e12 = _transfer(H, p1, p2, sigma2)
    e21 = _transfer(torch.linalg.inv_ex(H).inverse, p2, p1, sigma2)
    ok = (e12 < CHI2_H) & (e21 < CHI2_H)
    score = (
        torch.where(e12 < CHI2_H, SCORE_TH - e12, 0.0)
        + torch.where(e21 < CHI2_H, SCORE_TH - e21, 0.0)
    ).sum(-1)
    return score, ok


def _score_f(F, p1, p2, sigma2):
    o = torch.ones_like(p1[:, :1])
    x1 = torch.cat([p1, o], -1)  # (N, 3)
    x2 = torch.cat([p2, o], -1)
    l2 = torch.einsum("mij,nj->mni", F, x1)          # epiline in img2
    l1 = torch.einsum("mji,nj->mni", F, x2)          # epiline in img1
    num = torch.einsum("ni,mni->mn", x2, l2)
    d2 = num**2 / torch.clamp(l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12) / sigma2
    num1 = torch.einsum("ni,mni->mn", x1, l1)
    d1 = num1**2 / torch.clamp(l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12) / sigma2
    ok = (d1 < CHI2_F) & (d2 < CHI2_F)
    score = (
        torch.where(d2 < CHI2_F, SCORE_TH - d2, 0.0)
        + torch.where(d1 < CHI2_F, SCORE_TH - d1, 0.0)
    ).sum(-1)
    return score, ok


def _triangulate_census(R, t, K, p1, p2, valid, sigma2, parallax_min=0.99998):
    """CheckRT (TwoViewReconstruction.cc:475) for C candidates at once:
    R (C, 3, 3), t (C, 3). Triangulates every point for every candidate in
    one (C*N, 4, 4) SVD and counts the good ones (finite, in front of both
    cameras, low reprojection error, enough parallax). Returns (n_good (C,),
    good (C, N), X (C, N, 3), cos parallax (C, N))."""
    Kinv = torch.linalg.inv_ex(K).inverse
    o = torch.ones_like(p1[:, :1])
    r1 = torch.cat([p1, o], -1) @ Kinv.T                         # (N, 3)
    r2 = torch.cat([p2, o], -1) @ Kinv.T
    C, N = R.shape[0], p1.shape[0]
    # DLT triangulation with P1 = [I|0], P2 = [R|t]
    P1 = torch.cat([torch.eye(3, dtype=p1.dtype, device=p1.device),
                    torch.zeros(3, 1, dtype=p1.dtype, device=p1.device)], -1)
    P2 = torch.cat([R, t[:, :, None]], -1)                       # (C, 3, 4)

    def rows(r, P):
        # r (N, 3), P (C?, 3, 4) -> (C, N, 2, 4)
        a = r[:, 0:1] * P[..., None, 2, :] - P[..., None, 0, :]
        b = r[:, 1:2] * P[..., None, 2, :] - P[..., None, 1, :]
        return torch.stack(torch.broadcast_tensors(a, b), -2).expand(C, N, 2, 4)

    A = torch.cat([rows(r1, P1), rows(r2, P2)], -2)              # (C, N, 4, 4)
    Xh = _null_vectors(A.reshape(C * N, 4, 4)).reshape(C, N, 4)
    X = Xh[..., :3] / torch.where(Xh[..., 3:].abs() < 1e-12, 1e-12, Xh[..., 3:])
    z1 = X[..., 2]
    X2 = X @ R.transpose(1, 2) + t[:, None]
    z2 = X2[..., 2]
    # parallax between rays
    n1 = X / torch.clamp(torch.linalg.norm(X, dim=-1, keepdim=True), min=1e-9)
    C2 = -(R.transpose(1, 2) @ t[..., None])[..., 0]             # (C, 3)
    d2v = X - C2[:, None]
    n2 = d2v / torch.clamp(torch.linalg.norm(d2v, dim=-1, keepdim=True), min=1e-9)
    cosp = (n1 * n2).sum(-1)
    # reprojection
    pr1 = X @ K.T
    pr1 = pr1[..., :2] / torch.clamp(pr1[..., 2:], min=1e-9)
    pr2 = X2 @ K.T
    pr2 = pr2[..., :2] / torch.clamp(pr2[..., 2:], min=1e-9)
    e1 = ((pr1 - p1) ** 2).sum(-1) / sigma2
    e2 = ((pr2 - p2) ** 2).sum(-1) / sigma2
    good = (
        valid & (z1 > 0) & (z2 > 0) & (cosp < parallax_min)
        & (e1 < 4 * CHI2_H) & (e2 < 4 * CHI2_H) & torch.isfinite(X).all(-1)
    )
    return good.sum(-1), good, X, cosp


class TwoViewResult(NamedTuple):
    success: bool
    R: np.ndarray
    t: np.ndarray
    points3d: np.ndarray
    good_mask: np.ndarray
    used_homography: bool
    parallax_deg: float = 0.0   # the parallax gate's reading (CheckRT)
    n_inliers: int = 0          # the chosen model's inliers, the census's population
    scores: tuple = (0.0, 0.0)  # (SH, SF), the model choice's reading


def reconstruct_two_view(
    p1: np.ndarray,   # (N, 2) pixel coords, frame 1
    p2: np.ndarray,   # (N, 2) matched pixel coords, frame 2
    K: np.ndarray,    # (3, 3) intrinsics
    valid: np.ndarray | None = None,
    n_hypotheses: int = 256,
    sigma: float = 1.0,
    min_triangulated: int = 50,
    seed: int = 0,
    device=None,      # None: the card (device.resolve); "cpu" for the CPU
) -> TwoViewResult:
    """Full two-view init: host orchestration, device-batched math."""
    device = resolve(device)
    N = len(p1)
    if valid is None:
        valid = np.ones(N, bool)
    idx_pool = np.where(valid)[0]
    if len(idx_pool) < 20:
        return TwoViewResult(False, np.eye(3), np.zeros(3), np.zeros((N, 3)),
                             np.zeros(N, bool), False)
    rng = np.random.default_rng(seed)
    sigma2 = sigma * sigma

    p1d = torch.as_tensor(np.asarray(p1, np.float32), device=device)
    p2d = torch.as_tensor(np.asarray(p2, np.float32), device=device)
    pool = torch.as_tensor(idx_pool, device=device)

    # Hartley normalization (solve in normalized coords, score in pixels):
    # an unnormalized pixel DLT loses ~2 digits of model accuracy.
    mean1, s1, T1 = _normalize_pts(p1d[pool])
    mean2, s2, T2 = _normalize_pts(p2d[pool])
    p1_all_n = (p1d - mean1) * s1
    p2_all_n = (p2d - mean2) * s2
    T2inv = torch.linalg.inv_ex(T2).inverse

    # Hypothesis minimal sets: the JAX package's draws, in its order; a set
    # that repeats a point defines no model (ROADMAP F32)
    draws_h = rng.integers(0, len(idx_pool), size=(n_hypotheses, 4))
    draws_f = rng.integers(0, len(idx_pool), size=(n_hypotheses, 8))
    sets_h = torch.as_tensor(idx_pool[draws_h], device=device)
    sets_f = torch.as_tensor(idx_pool[draws_f], device=device)
    degenerate_h = torch.as_tensor(_repeats_a_point(draws_h), device=device)
    degenerate_f = torch.as_tensor(_repeats_a_point(draws_f), device=device)

    Hn = _solve_h_batch(p1_all_n[sets_h], p2_all_n[sets_h])
    Fn = _solve_f_batch(p1_all_n[sets_f], p2_all_n[sets_f])
    # Denormalize: H = T2^-1 Hn T1 ; F = T2^T Fn T1.
    Hs = T2inv[None] @ Hn @ T1[None]
    Fs = T2.T[None] @ Fn @ T1[None]
    sh, ok_h = _score_h(Hs, p1d, p2d, sigma2)
    sf, ok_f = _score_f(Fs, p1d, p2d, sigma2)
    sh = torch.where(torch.isfinite(sh) & ~degenerate_h, sh, -torch.inf)
    sf = torch.where(torch.isfinite(sf) & ~degenerate_f, sf, -torch.inf)
    # torch.argmax takes the first maximum, as jnp.argmax does
    bi_h, bi_f = torch.argmax(sh), torch.argmax(sf)
    best = torch.stack([sh[bi_h], sf[bi_f]])
    best, okh_best, okf_best = device_fetch(best, ok_h[bi_h], ok_f[bi_f])
    SH, SF = float(best[0]), float(best[1])
    ratio = SH / max(SH + SF, 1e-9)
    use_h = ratio > 0.4  # TwoViewReconstruction.cc model selection

    Kd = torch.as_tensor(np.asarray(K, np.float32), device=device)
    # Least-squares refit on all inliers (normalized coords).
    if use_h:
        inl = okh_best & valid
        ii = torch.as_tensor(np.where(inl)[0], device=device)
        Hn_ref = _solve_h_batch(p1_all_n[ii][None], p2_all_n[ii][None])[0]
        model = T2inv @ Hn_ref @ T1
        sc, ok2 = _score_h(model[None], p1d, p2d, sigma2)
        S_best, fallback = SH, Hs[bi_h]
    else:
        inl = okf_best & valid
        ii = torch.as_tensor(np.where(inl)[0], device=device)
        Fn_ref = _solve_f_batch(p1_all_n[ii][None], p2_all_n[ii][None])[0]
        model = T2.T @ Fn_ref @ T1
        sc, ok2 = _score_f(model[None], p1d, p2d, sigma2)
        S_best, fallback = SF, Fs[bi_f]
    sc, ok2, model, fallback = device_fetch(sc[0], ok2[0], model, fallback)
    decompose = _decompose_homography if use_h else _decompose_fundamental
    if float(sc) >= S_best:
        inl = ok2 & valid
        cands = decompose(np.asarray(model), K)
    else:
        cands = decompose(np.asarray(fallback), K)

    Rc = torch.as_tensor(np.stack([R for R, _ in cands]), dtype=torch.float32, device=device)
    tc = torch.as_tensor(np.stack([t for _, t in cands]), dtype=torch.float32, device=device)
    n_good, good, X, cosp = device_fetch(*_triangulate_census(
        Rc, tc, Kd, p1d, p2d, torch.as_tensor(inl, device=device), sigma2))
    c = int(np.argmax(n_good))   # the first candidate with the most good points
    n_good, good, X, cosp = int(n_good[c]), good[c], X[c], cosp[c]
    R, t = cands[c]
    # CheckRT acceptance: clear winner, enough points, AND real parallax —
    # the reference's minParallax=1.0 deg gate on the 50th-largest-parallax
    # good point (TwoViewReconstruction.cc:510-517, ReconstructH/F minimum
    # parallax). Without it, pure-rotation footage builds a degenerate map
    # out of triangulation noise and poisons the whole run.
    if n_good > 0:
        cos_sorted = np.sort(cosp[good])         # ascending cos
        idx = min(50, n_good - 1)
        parallax_deg = float(np.degrees(np.arccos(
            np.clip(cos_sorted[idx], -1.0, 1.0)
        )))
    else:
        parallax_deg = 0.0
    success = (n_good >= min_triangulated and n_good > 0.7 * inl.sum()
               and parallax_deg > 1.0)
    tn = t / max(np.linalg.norm(t), 1e-12)
    return TwoViewResult(bool(success), R, tn, X, good, bool(use_h), parallax_deg,
                         int(inl.sum()), (SH, SF))


def _decompose_fundamental(F, K):
    """E = K^T F K -> 4 (R, t) candidates."""
    E = K.T @ F @ K
    U, _, Vt = np.linalg.svd(E)
    if np.linalg.det(U) < 0:
        U = -U
    if np.linalg.det(Vt) < 0:
        Vt = -Vt
    W = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]])
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    t = t / max(np.linalg.norm(t), 1e-12)
    return [(R1, t), (R1, -t), (R2, t), (R2, -t)]


def _decompose_homography(H, K):
    """Faugeras SVD decomposition of a calibrated homography -> 8 (R, t)
    candidates (TwoViewReconstruction::ReconstructH)."""
    A = np.linalg.inv(K) @ H @ K
    U, S, Vt = np.linalg.svd(A)
    s = np.linalg.det(U) * np.linalg.det(Vt)
    d1, d2, d3 = S
    if d1 / d2 < 1.0001 or d2 / d3 < 1.0001:
        # near-degenerate (pure rotation); return identity-rotation options
        return [(U @ Vt * np.sign(np.linalg.det(U @ Vt)), np.array([0, 0, 1e-6]))]
    cands = []
    aux1 = np.sqrt((d1 * d1 - d2 * d2) / (d1 * d1 - d3 * d3))
    aux3 = np.sqrt((d2 * d2 - d3 * d3) / (d1 * d1 - d3 * d3))
    x1s = [aux1, aux1, -aux1, -aux1]
    x3s = [aux3, -aux3, aux3, -aux3]
    # d' > 0
    aux_st = np.sqrt((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3)) / ((d1 + d3) * d2)
    ct = (d2 * d2 + d1 * d3) / ((d1 + d3) * d2)
    sts = [aux_st, -aux_st, -aux_st, aux_st]
    for i in range(4):
        Rp = np.array([[ct, 0, -sts[i]], [0, 1, 0], [sts[i], 0, ct]])
        tp = (d1 - d3) * np.array([x1s[i], 0, -x3s[i]])
        R = s * U @ Rp @ Vt
        t = U @ tp
        cands.append((R, t / max(np.linalg.norm(t), 1e-12)))
    # d' < 0
    aux_sp = np.sqrt((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3)) / ((d1 - d3) * d2)
    cp = (d1 * d3 - d2 * d2) / ((d1 - d3) * d2)
    sps = [aux_sp, -aux_sp, -aux_sp, aux_sp]
    for i in range(4):
        Rp = np.array([[cp, 0, sps[i]], [0, -1, 0], [sps[i], 0, -cp]])
        tp = (d1 + d3) * np.array([x1s[i], 0, x3s[i]])
        R = s * U @ Rp @ Vt
        t = U @ tp
        cands.append((R, t / max(np.linalg.norm(t), 1e-12)))
    return cands

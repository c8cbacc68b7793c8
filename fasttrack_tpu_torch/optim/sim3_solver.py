"""Sim3/SE3 RANSAC alignment between two keyframes (src/Sim3Solver.cc).

Port of fasttrack_tpu/optim/sim3_solver.py, a copy (host NumPy).

Given paired 3D map points seen by two keyframes, find the similarity
(or rigid, for stereo/inertial where scale is fixed) transform with a
Horn/Umeyama closed-form fit inside RANSAC; inliers are checked by
reprojection into BOTH cameras (Sim3Solver::CheckInliers).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Sim3Result(NamedTuple):
    success: bool
    s: float
    R: np.ndarray
    t: np.ndarray
    inliers: np.ndarray
    n_inliers: int


def _umeyama(src, dst, with_scale):
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var = (xs**2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / max(var, 1e-12))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def _project(K, X):
    z = np.maximum(X[:, 2], 1e-9)
    return np.stack([K[0, 0] * X[:, 0] / z + K[0, 2],
                     K[1, 1] * X[:, 1] / z + K[1, 2]], -1)


def solve_sim3(
    X1: np.ndarray,       # (N, 3) matched map points in KF1 camera coords
    X2: np.ndarray,       # (N, 3) same points in KF2 camera coords
    uv1: np.ndarray,      # (N, 2) observed pixels in KF1
    uv2: np.ndarray,      # (N, 2) observed pixels in KF2
    K1: np.ndarray,
    K2: np.ndarray,
    sigma2_1: np.ndarray, # (N,) per-obs sigma^2 (level variance)
    sigma2_2: np.ndarray,
    fix_scale: bool = False,
    iterations: int = 300,
    min_inliers: int = 20,
    chi2: float = 9.21,   # 2-dof 99% (Sim3Solver th)
    seed: int = 0,
) -> Sim3Result:
    """RANSAC Horn alignment: T12 with X1 ~= s R X2 + t (maps KF2-coords
    into KF1-coords, the reference's mT12i)."""
    n = len(X1)
    if n < 6:
        return Sim3Result(False, 1.0, np.eye(3), np.zeros(3), np.zeros(n, bool), 0)
    rng = np.random.default_rng(seed)
    best = None
    for _ in range(iterations):
        idx = rng.choice(n, 3, replace=False)
        try:
            s, R, t = _umeyama(X2[idx], X1[idx], with_scale=not fix_scale)
        except np.linalg.LinAlgError:
            continue
        if not np.isfinite(s) or s <= 0 or s > 20:
            continue
        # check reprojections both ways
        X2_in_1 = (s * (R @ X2.T)).T + t
        e1 = ((uv1 - _project(K1, X2_in_1)) ** 2).sum(-1) / sigma2_1
        Rinv = R.T / s
        tinv = -Rinv @ t
        X1_in_2 = (X1 @ Rinv.T) + tinv
        e2 = ((uv2 - _project(K2, X1_in_2)) ** 2).sum(-1) / sigma2_2
        inl = (e1 < chi2) & (e2 < chi2) & (X2_in_1[:, 2] > 0) & (X1_in_2[:, 2] > 0)
        ni = int(inl.sum())
        if best is None or ni > best[0]:
            best = (ni, s, R, t, inl)
        if ni > 0.8 * n:
            break
    ni, s, R, t, inl = best
    if ni < min_inliers:
        return Sim3Result(False, s, R, t, inl, ni)
    # refine on inliers
    s, R, t = _umeyama(X2[inl], X1[inl], with_scale=not fix_scale)
    X2_in_1 = (s * (R @ X2.T)).T + t
    e1 = ((uv1 - _project(K1, X2_in_1)) ** 2).sum(-1) / sigma2_1
    Rinv = R.T / s
    X1_in_2 = (X1 @ Rinv.T) - Rinv @ t
    e2 = ((uv2 - _project(K2, X1_in_2)) ** 2).sum(-1) / sigma2_2
    inl = (e1 < chi2) & (e2 < chi2)
    return Sim3Result(True, float(s), R, t, inl, int(inl.sum()))

"""Maximum-likelihood RANSAC PnP for relocalization (the reference's
MLPnPsolver, src/MLPnPsolver.cpp, used only by Tracking::Relocalization).

Port of fasttrack_tpu/optim/pnp.py, a copy (host NumPy: relocalization is rare and small).

Camera-model agnostic like MLPnP: pixels are unprojected to rays first.
Bearing-vector DLT minimal solver inside RANSAC, then the MLPnP refinement
proper (Urban et al. 2016; MLPnPsolver.cpp:600-1056): Gauss-Newton over
SE3 on NULLSPACE-PROJECTED bearing residuals — each observed unit bearing v
contributes e = [r s]^T u(T) with [r s] an orthonormal basis of v's
tangent plane and u the normalized transformed point — weighted by the
per-observation information (focal^2 / sigma2, the pixel-noise covariance
propagated to bearing space). This is the maximum-likelihood formulation
that beats reprojection-DLT under anisotropic/pyramid-level-dependent
noise. Host NumPy: relocalization is rare and small (N < ~200 matches).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


def _hat(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])


def _so3_exp(w):
    th = np.linalg.norm(w)
    K = _hat(w)
    if th < 1e-12:
        return np.eye(3) + K
    return (np.eye(3) + np.sin(th) / th * K
            + (1 - np.cos(th)) / th**2 * (K @ K))


def _nullspace_basis(v):
    """(N,3) unit bearings -> (N,3,2) orthonormal tangent bases [r, s]."""
    n = len(v)
    # pick the axis least aligned with v to seed the basis
    a = np.zeros((n, 3))
    a[np.arange(n), np.argmin(np.abs(v), axis=1)] = 1.0
    r = np.cross(v, a)
    r /= np.maximum(np.linalg.norm(r, axis=1, keepdims=True), 1e-12)
    s = np.cross(v, r)
    return np.stack([r, s], -1)


def ml_refine(X, rays, sigma2, focal, R, t, inliers, iters: int = 8):
    """MLPnP Gauss-Newton polish (MLPnPsolver.cpp:600 `mlpnp_gn`).

    Minimizes sum_i w_i ||[r_i s_i]^T u_i(T)||^2 with u = (R X + t)/||.||,
    w = focal^2 / sigma2 (bearing-space information). Analytic Jacobians:
    de/dXc = [r s]^T (I - u u^T)/||Xc||, dXc/d(omega,tau) = [-hat(Xc), I]
    under the left perturbation T <- exp([omega, tau]) T."""
    sel = np.where(inliers)[0]
    if len(sel) < 6:
        return R, t
    Xs = X[sel]
    v = rays[sel] / np.linalg.norm(rays[sel], axis=1, keepdims=True)
    ns = _nullspace_basis(v)                       # (n,3,2)
    w = focal * focal / np.maximum(sigma2[sel], 1e-12)
    for _ in range(iters):
        Xc = Xs @ R.T + t
        d = np.linalg.norm(Xc, axis=1)
        u = Xc / np.maximum(d[:, None], 1e-12)
        e = np.einsum("nij,ni->nj", ns, u)         # (n,2)
        proj = (np.eye(3)[None] - u[:, :, None] * u[:, None, :]) \
            / np.maximum(d[:, None, None], 1e-12)
        de_dXc = np.einsum("nij,nik->njk", ns, proj)   # (n,2,3)
        Jw = np.einsum("njk,nkl->njl", de_dXc,
                       -np.stack([_hat(x) for x in Xc]))   # (n,2,3)
        J = np.concatenate([Jw, de_dXc], -1)           # (n,2,6)
        H = np.einsum("nja,n,njb->ab", J, w, J)
        g = np.einsum("nja,n,nj->a", J, w, e)
        try:
            dx = -np.linalg.solve(H + 1e-9 * np.eye(6), g)
        except np.linalg.LinAlgError:
            break
        if not np.all(np.isfinite(dx)):
            break
        dR = _so3_exp(dx[:3])
        R = dR @ R
        t = dR @ t + dx[3:]
        if np.abs(dx).max() < 1e-10:
            break
    # re-orthonormalize drift
    U, _, Vt = np.linalg.svd(R)
    R = U @ np.diag([1, 1, np.sign(np.linalg.det(U @ Vt))]) @ Vt
    return R, t


class PnPResult(NamedTuple):
    success: bool
    R_cw: np.ndarray
    t_cw: np.ndarray
    inliers: np.ndarray


def _dlt_pnp(X: np.ndarray, rays: np.ndarray):
    """Minimal DLT: solve P (3x4) from 3D points X and unit-depth rays
    (x, y, 1); decompose into R, t by orthonormalizing."""
    n = len(X)
    A = np.zeros((2 * n, 12))
    for i in range(n):
        Xh = np.append(X[i], 1.0)
        x, y = rays[i, 0], rays[i, 1]
        A[2 * i, 0:4] = Xh
        A[2 * i, 8:12] = -x * Xh
        A[2 * i + 1, 4:8] = Xh
        A[2 * i + 1, 8:12] = -y * Xh
    _, _, Vt = np.linalg.svd(A)
    P = Vt[-1].reshape(3, 4)
    # P is recovered up to sign; M = scale*R with scale > 0 requires
    # det(M) > 0 (det(M) = scale^3 det(R)), which fixes the sign outright.
    if np.linalg.det(P[:, :3]) < 0:
        P = -P
    M = P[:, :3]
    U, S, Vt2 = np.linalg.svd(M)
    R = U @ Vt2                      # det +1 by the sign fix above
    scale = np.mean(S)
    if scale < 1e-12:
        return None
    t = P[:, 3] / scale
    # a valid pose puts the points in front; a bad minimal set does not
    depths = (X @ R.T + t)[:, 2]
    if np.median(depths) < 0:
        return None
    return R, t


def ransac_pnp(
    X: np.ndarray,        # (N, 3) world points
    rays: np.ndarray,     # (N, 3) unprojected unit-depth rays (z=1)
    sigma2: np.ndarray,   # (N,) per-obs pixel variance (for the chi2 gate)
    focal: float,         # focal length to convert ray error to pixels
    iterations: int = 200,
    chi2: float = 5.991,
    min_inliers: int = 12,
    seed: int = 0,
) -> PnPResult:
    n = len(X)
    if n < 6:
        return PnPResult(False, np.eye(3), np.zeros(3), np.zeros(n, bool))
    rng = np.random.default_rng(seed)
    best = None
    for _ in range(iterations):
        idx = rng.choice(n, 6, replace=False)
        out = _dlt_pnp(X[idx], rays[idx])
        if out is None:
            continue
        R, t = out
        Xc = X @ R.T + t
        z = Xc[:, 2]
        ok_z = z > 0.05
        pr = Xc[:, :2] / np.maximum(z[:, None], 1e-9)
        err = ((pr - rays[:, :2]) ** 2).sum(1) * focal * focal / sigma2
        inl = ok_z & (err < chi2)
        ni = int(inl.sum())
        if best is None or ni > best[0]:
            best = (ni, R, t, inl)
        if ni > 0.7 * n:
            break
    ni, R, t, inl = best
    if ni < min_inliers:
        return PnPResult(False, R, t, inl)
    out = _dlt_pnp(X[inl], rays[inl])
    if out is not None:
        R, t = out
    # maximum-likelihood polish on the consensus set (mlpnp_gn)
    R, t = ml_refine(X, rays, sigma2, focal, R, t, inl)
    Xc = X @ R.T + t
    z = Xc[:, 2]
    pr = Xc[:, :2] / np.maximum(z[:, None], 1e-9)
    err = ((pr - rays[:, :2]) ** 2).sum(1) * focal * focal / sigma2
    inl = (z > 0.05) & (err < chi2)
    if int(inl.sum()) < min_inliers:
        return PnPResult(False, R, t, inl)
    return PnPResult(True, R, t, inl)

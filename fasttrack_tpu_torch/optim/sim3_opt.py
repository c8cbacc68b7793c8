"""Joint nonlinear refinement of a loop Sim3 (ROADMAP K13).

Port of fasttrack_tpu/optim/sim3_opt.py. The reference refines the
RANSAC/Horn loop Sim3 with a g2o LM solve over both-direction reprojection
edges (VertexSim3Expmap + EdgeSim3ProjectXYZ / EdgeInverseSim3ProjectXYZ)
with Huber kernels and a two-round inlier re-toggle: optimize 5 iterations,
drop edges with chi2 > 10, optimize 10 more (Optimizer::OptimizeSim3,
src/Optimizer.cc:2115-2318).

One LM on the tensors' device, float32 as in the JAX package. Residuals are
one (4N + 1,) vector: image-1 reprojections of camera-2 points through S12,
image-2 reprojections of camera-1 points through S12^-1, and a log-scale
prior. The Jacobian is `torch.func.jacfwd` of the residuals through the
Sim3 retraction at the identity (the JAX package's `jax.jacfwd`), Huber is
an IRLS weight, and the inlier re-toggle is a mask update between the two
rounds. Nothing inside the 15 iterations synchronises with the host
(`torch.where`, `linalg.solve_ex`): the result comes back in one fetch.
Plain PyTorch: it runs once per verified loop candidate, off the per-frame
path.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd

from fasttrack_tpu_torch.device import resolve
from fasttrack_tpu_torch.nputils import device_fetch

_F = torch.float32


class OptSim3Result(NamedTuple):
    success: bool
    s: float
    R: np.ndarray
    t: np.ndarray
    n_inliers: int
    inliers: np.ndarray  # (N,) bool over the input correspondences
    cost: float


def _hat(v):
    z = torch.zeros_like(v[0])
    return torch.stack([
        torch.stack([z, -v[2], v[1]]),
        torch.stack([v[2], z, -v[0]]),
        torch.stack([-v[1], v[0], z]),
    ])


def _so3_exp(phi):
    th2 = torch.dot(phi, phi)
    th = torch.sqrt(th2 + 1e-24)
    W = _hat(phi)
    a = torch.where(th < 1e-5, 1.0 - th2 / 6.0, torch.sin(th) / th)
    b = torch.where(th < 1e-5, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / th2)
    return torch.eye(3, dtype=phi.dtype, device=phi.device) + a * W + b * (W @ W)


def _retract(xi, s, R, t):
    """Left-multiply the estimate by the chart delta(xi) = (exp(sigma),
    exp_so3(phi), rho): a local diffeomorphism at 0, which is all LM needs."""
    rho, phi, sigma = xi[:3], xi[3:6], xi[6]
    ds = torch.exp(sigma)
    dR = _so3_exp(phi)
    return ds * s, dR @ R, ds * (dR @ t) + rho


def _residuals(s, R, t, X1, X2, uv1, uv2, K1, K2):
    """(N, 2) image-1 residuals of S12·X2 and (N, 2) image-2 residuals of
    S12^-1·X1 (EdgeSim3ProjectXYZ / EdgeInverseSim3ProjectXYZ); a point
    behind a camera gets residuals of 1e3."""
    Y1 = s * (X2 @ R.T) + t                       # cam2 points -> cam1 frame
    Y2 = (1.0 / s) * ((X1 - t) @ R)               # cam1 points -> cam2 frame

    def proj(K, X):
        z = torch.clamp(X[:, 2], min=1e-6)
        return torch.stack([K[0, 0] * X[:, 0] / z + K[0, 2],
                            K[1, 1] * X[:, 1] / z + K[1, 2]], -1)

    big = torch.tensor(1e3, dtype=_F, device=X1.device)
    r1 = torch.where((Y1[:, 2] <= 1e-3)[:, None], big, uv1 - proj(K1, Y1))
    r2 = torch.where((Y2[:, 2] <= 1e-3)[:, None], big, uv2 - proj(K2, Y2))
    return r1, r2


def _chi2(r1, r2, w1, w2):
    return w1 * torch.sum(r1 * r1, -1), w2 * torch.sum(r2 * r2, -1)


def _lm_rounds(X1, X2, uv1, uv2, K1, K2, w1, w2, s0, R0, t0, th2, w_scale,
               fix_scale: bool, iters1: int = 5, iters2: int = 10):
    dev = X1.device
    delta = torch.sqrt(th2)
    sqrt_ws = torch.sqrt(w_scale)
    log_s0 = torch.log(s0)
    n = X1.shape[0]
    keep = torch.ones(7, dtype=_F, device=dev)
    e6 = torch.zeros(7, dtype=_F, device=dev)
    if fix_scale:
        keep[6], e6[6] = 0.0, 1.0
    eye7 = torch.eye(7, dtype=_F, device=dev)

    def huber_w(chi2):
        e = torch.sqrt(chi2 + 1e-12)
        return torch.where(e <= delta, 1.0, delta / e)

    def robust_cost(s, R, t, mask):
        r1, r2 = _residuals(s, R, t, X1, X2, uv1, uv2, K1, K2)
        c1, c2 = _chi2(r1, r2, w1, w2)

        def rho(c):   # Huber: c if c <= th2, else 2 delta sqrt(c) - th2
            return torch.where(c <= th2, c, 2.0 * delta * torch.sqrt(c) - th2)

        prior = w_scale * (torch.log(s) - log_s0) ** 2
        return torch.sum(mask * (rho(c1) + rho(c2))) + prior

    def lm_iter(s, R, t, lam, mask):
        def f(xi):
            sn, Rn, tn = _retract(xi, s, R, t)
            r1, r2 = _residuals(sn, Rn, tn, X1, X2, uv1, uv2, K1, K2)
            # log-scale anchor to the 3D-3D (Horn) scale: reprojection-only
            # edges observe scale weakly when |t| << depth
            r_s = sqrt_ws * (torch.log(sn) - log_s0)
            return torch.cat([r1.reshape(-1), r2.reshape(-1), r_s[None]])

        zero = torch.zeros(7, dtype=_F, device=dev)
        r0 = f(zero)
        J = jacfwd(f)(zero)                           # (4N + 1, 7)
        c1, c2 = _chi2(r0[:2 * n].reshape(-1, 2), r0[2 * n:4 * n].reshape(-1, 2), w1, w2)
        wr1 = (w1 * huber_w(c1) * mask).repeat_interleave(2)
        wr2 = (w2 * huber_w(c2) * mask).repeat_interleave(2)
        w = torch.cat([wr1, wr2, torch.ones(1, dtype=_F, device=dev)])
        Jw = J * w[:, None]
        H = Jw.T @ J
        g = Jw.T @ r0
        # fix_scale: row and column 6 become the identity's, g[6] = 0
        H = H * (keep[:, None] * keep[None, :]) + torch.diag(e6)
        g = g * keep
        Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-8 * eye7
        sol, _ = torch.linalg.solve_ex(Hd, g)
        dx = -sol
        sn, Rn, tn = _retract(dx, s, R, t)
        accept = (robust_cost(sn, Rn, tn, mask) < robust_cost(s, R, t, mask)) \
            & torch.isfinite(dx).all()
        s = torch.where(accept, sn, s)
        R = torch.where(accept, Rn, R)
        t = torch.where(accept, tn, t)
        lam = torch.clamp(torch.where(accept, lam * 0.3, lam * 4.0), 1e-8, 1e6)
        return s, R, t, lam

    s, R, t = s0, R0, t0
    lam0 = torch.tensor(1e-3, dtype=_F, device=dev)
    mask = torch.ones(n, dtype=_F, device=dev)
    lam = lam0
    for _ in range(iters1):
        s, R, t, lam = lm_iter(s, R, t, lam, mask)
    # inlier re-toggle (Optimizer.cc:2264-2285): a correspondence is dropped
    # when either direction exceeds th2
    c1, c2 = _chi2(*_residuals(s, R, t, X1, X2, uv1, uv2, K1, K2), w1, w2)
    mask2 = ((c1 <= th2) & (c2 <= th2)).to(_F)
    lam = lam0
    for _ in range(iters2):
        s, R, t, lam = lm_iter(s, R, t, lam, mask2)
    c1, c2 = _chi2(*_residuals(s, R, t, X1, X2, uv1, uv2, K1, K2), w1, w2)
    inliers = (c1 <= th2) & (c2 <= th2)
    return s, R, t, inliers, robust_cost(s, R, t, inliers.to(_F))


def optimize_sim3(
    X1, X2, uv1, uv2, K1, K2, sigma2_1, sigma2_2,
    s0: float, R0, t0,
    fix_scale: bool = False, th2: float = 10.0, min_inliers: int = 10,
    w_scale_prior: float | None = None,
    device=None,            # None: the card (device.resolve); "cpu" for the CPU
) -> OptSim3Result:
    """Refine S12 (X1 ≈ s R X2 + t) from `s0, R0, t0`.

    X1/X2: (N, 3) points in camera-1 / camera-2 frames; uv1/uv2: (N, 2)
    pixel observations in image 1 / image 2; sigma2_*: per-correspondence
    pyramid scale^2 (the reference's invSigmaSquare^-1). Returns the refined
    Sim3 and the surviving inlier mask, fetched in one copy."""
    X1 = np.asarray(X1, np.float32)
    n = len(X1)
    if n < 3:
        return OptSim3Result(False, float(s0), np.asarray(R0, np.float64),
                             np.asarray(t0, np.float64), 0, np.zeros(n, bool), np.inf)
    if w_scale_prior is None:
        # anchor strength ~ the information the 3D-3D RANSAC scale carries,
        # proportional to n so a large consistent reprojection signal can
        # still overrule the prior (the JAX package's 2000 * n)
        w_scale_prior = 0.0 if fix_scale else 2000.0 * n
    device = resolve(device)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    def scalar(x):
        return torch.tensor(float(x), dtype=_F, device=device)

    s, R, t, inl, cost = _lm_rounds(
        up(X1), up(X2), up(uv1), up(uv2), up(K1), up(K2),
        up(1.0 / np.maximum(np.asarray(sigma2_1, np.float32), 1e-9)),
        up(1.0 / np.maximum(np.asarray(sigma2_2, np.float32), 1e-9)),
        scalar(s0), up(R0), up(t0), scalar(th2), scalar(w_scale_prior),
        fix_scale,
    )
    s, R, t, inl, cost = device_fetch(s, R, t, inl, cost)
    ni = int(inl.sum())
    # re-orthonormalize the float32 rotation
    U, _, Vt = np.linalg.svd(R.astype(np.float64))
    R_np = U @ np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))]) @ Vt
    return OptSim3Result(ni >= min_inliers, float(s), R_np, t.astype(np.float64), ni, inl,
                         float(cost))

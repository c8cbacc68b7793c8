"""Motion-only pose optimization (the reference's Optimizer::PoseOptimization,
src/Optimizer.cc:814-1115).

Port of fasttrack_tpu/optim/pose_opt.py: 4 outer rounds x 10
Levenberg-Marquardt iterations; after each round, edges are re-classified
inlier/outlier by chi2 against 5.991 (mono) / 7.815 (stereo); rounds 0-1
use a Huber kernel. Outliers stay in the problem as zero-weight residuals,
so every shape is fixed. Where the JAX package differentiates the residual
with jax.jacfwd, the port uses the analytic Jacobian of the residual (either
camera model) under a left perturbation exp(xi) o T. The iterations accept or
reject a step with torch.where, so the loop never synchronises with the
device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fasttrack_tpu_torch.cameras.models import Camera, project
from fasttrack_tpu_torch.geometry import SE3, hat, se3_apply, se3_compose, se3_exp
from fasttrack_tpu_torch.optim.ba_core import projection_jacobian
from fasttrack_tpu_torch.optim.robust import CHI2_MONO, CHI2_STEREO, huber_weight


class PoseOptResult(NamedTuple):
    pose: SE3
    inliers: torch.Tensor      # (N,) bool
    n_inliers: torch.Tensor    # () int64


def _residuals(T: SE3, cam: Camera, bf, Xw, obs_uv, obs_ur, is_stereo):
    """Per-point residual (N, 3) [du, dv, dur] (dur = 0 for mono edges) and
    the camera-frame points. Stereo edge: u_r = u - bf/z
    (EdgeStereoSE3ProjectXYZOnlyPose)."""
    Xc = se3_apply(T, Xw)
    uv = project(cam, Xc)
    ur = uv[:, 0] - bf / torch.clamp(Xc[:, 2], min=1e-6)
    du = obs_uv[:, 0] - uv[:, 0]
    dv = obs_uv[:, 1] - uv[:, 1]
    dur = torch.where(is_stereo, obs_ur - ur, 0.0)
    return torch.stack([du, dv, dur], dim=-1), Xc


def _jacobian(cam: Camera, bf, Xc, is_stereo):
    """(N, 3, 6) d(residual)/d(xi) at xi = 0 for the pose exp(xi) o T:
    d(Xc)/d(xi) = [I | -hat(Xc)] after the projection's derivative
    (ba_core.projection_jacobian, either camera model)."""
    dP = projection_jacobian(cam, bf, Xc, is_stereo)            # (N, 3, 3) d(u, v, ur)/dXc
    dX = torch.cat([torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand_as(dP), -hat(Xc)], dim=-1)
    return -(dP @ dX)                                           # residual = obs - prediction


def pose_optimize(
    cam: Camera,
    bf: torch.Tensor,
    T0: SE3,                     # initial Tcw
    Xw: torch.Tensor,            # (N, 3) world points
    obs_uv: torch.Tensor,        # (N, 2) observed pixels
    obs_ur: torch.Tensor,        # (N,) observed right-u; < 0 => mono edge
    inv_sigma2: torch.Tensor,    # (N,) information scale (1/sigma^2 of the level)
    valid: torch.Tensor,         # (N,) bool
    rounds: int = 4,
    iters: int = 10,
) -> PoseOptResult:
    is_stereo = obs_ur >= 0
    delta2 = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    eye6 = torch.eye(6, dtype=Xw.dtype, device=Xw.device)

    def chi2_of(r):
        return torch.sum(r * r, dim=-1) * inv_sigma2

    T = T0
    inlier = valid.to(Xw.dtype)
    for rnd in range(rounds):
        use_robust = rnd < 2  # Optimizer.cc:1035 drops the kernel after 2 rounds
        lam = torch.full((), 1e-3, dtype=Xw.dtype, device=Xw.device)
        for _ in range(iters):
            r, Xc = _residuals(T, cam, bf, Xw, obs_uv, obs_ur, is_stereo)
            chi2 = chi2_of(r)
            w_rob = huber_weight(chi2, delta2) if use_robust else torch.ones_like(chi2)
            w = w_rob * inv_sigma2 * inlier
            J = _jacobian(cam, bf, Xc, is_stereo).reshape(-1, 6)   # (3N, 6)
            Jw = J * w.repeat_interleave(3)[:, None]
            H = Jw.T @ J
            g = Jw.T @ r.reshape(-1)
            A = H + lam * torch.diag_embed(torch.diagonal(H)) + 1e-9 * eye6
            dx = torch.linalg.solve_ex(A, -g)[0]   # solve_ex: no host sync on failure checks
            T_new = se3_compose(se3_exp(dx), T)
            c_old = torch.sum(chi2 * w_rob * inlier)
            chi2_new = chi2_of(_residuals(T_new, cam, bf, Xw, obs_uv, obs_ur, is_stereo)[0])
            w_rob_new = huber_weight(chi2_new, delta2) if use_robust else 1.0
            c_new = torch.sum(chi2_new * w_rob_new * inlier)
            accept = c_new < c_old
            T = SE3(torch.where(accept, T_new.R, T.R), torch.where(accept, T_new.t, T.t))
            lam = torch.where(accept, lam * 0.5, lam * 4.0)
        chi2 = chi2_of(_residuals(T, cam, bf, Xw, obs_uv, obs_ur, is_stereo)[0])
        inlier = (valid & (chi2 <= delta2)).to(Xw.dtype)

    inl = inlier > 0
    return PoseOptResult(T, inl, inl.sum())

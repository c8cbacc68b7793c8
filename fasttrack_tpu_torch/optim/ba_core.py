"""Shared bundle-adjustment math: residuals, Jacobians, Schur blocks.

Port of fasttrack_tpu/optim/ba_core.py: ONE implementation of the
(landmark x camera) BA building blocks, consumed by the window solver
(optim.local_ba). Where the JAX package differentiates the residual with
jax.jacfwd under two vmaps, the port writes the Jacobians of both camera
models out in closed form (one pass of elementwise kernels over the (L, K) grid instead of
a traced program per observation pair). The batched inverses and the reduced
solve go through `inv_ex` / `solve_ex`, which leave their error check to the
caller and so never synchronise with the device.

Parity: the g2o block solver with landmark marginalization the reference
uses everywhere (Optimizer.cc LocalBundleAdjustment :1116 /
GlobalBundleAdjustemnt :52).
"""

from __future__ import annotations

import torch

from fasttrack_tpu_torch.cameras.models import Camera, project, project_jacobian_rows
from fasttrack_tpu_torch.geometry import SE3, hat, se3_apply, se3_compose, se3_exp
from fasttrack_tpu_torch.optim.robust import CHI2_MONO, CHI2_STEREO, huber_weight


def _camera_points(poses: SE3, points):
    """(L, K, 3): every landmark in every camera's frame."""
    return se3_apply(SE3(poses.R[None, :], poses.t[None, :]), points[:, None, :])


def residuals(poses: SE3, points, cam: Camera, bf, obs_uv, obs_ur):
    """(L, K, 3) residuals [du, dv, dur] + behind-camera mask."""
    Xc = _camera_points(poses, points)
    uv = project(cam, Xc)
    z = torch.clamp(Xc[..., 2], min=1e-6)
    ur = uv[..., 0] - bf / z
    is_stereo = obs_ur >= 0
    r = torch.stack(
        [
            obs_uv[..., 0] - uv[..., 0],
            obs_uv[..., 1] - uv[..., 1],
            torch.where(is_stereo, obs_ur - ur, 0.0),
        ],
        dim=-1,
    )
    behind = Xc[..., 2] <= 0.05
    return r, behind


def projection_jacobian(cam: Camera, bf, Xc, is_stereo):
    """(..., 3, 3) d(u, v, ur)/d(Xc) of the stereo projection of either
    camera model, the stereo row zero where `is_stereo` is False (every
    fisheye edge: its u_right is -1). The u and v rows are
    `cameras.models.project_jacobian`'s; the stereo term u - bf / z holds
    its clamped depth (z < 1e-6) constant, as differentiating through the
    clamp does."""
    du, dv = project_jacobian_rows(cam, Xc)
    z = Xc[..., 2]
    zc = torch.clamp(z, min=1e-6)
    dstereo_dz = torch.where(z > 1e-6, bf / (zc * zc), 0.0)
    zero = torch.zeros_like(z)
    st = is_stereo.to(z.dtype)[..., None]
    dur = st * (du + torch.stack([zero, zero, dstereo_dz], dim=-1))
    return torch.stack([du, dv, dur], dim=-2)


def jacobians(poses: SE3, points, cam: Camera, bf, obs_uv, obs_ur):
    """Per-observation J wrt (camera xi (6), point (3)), in closed form.
    Returns (L, K, 3, 6) and (L, K, 3, 3).

    The camera update is exp(xi) o T with xi = [rho, phi], so
    d(Xc)/d(xi) = [I | -hat(Xc)] and d(Xc)/d(X) = R. The projection's
    derivative is `projection_jacobian`'s."""
    Xc = _camera_points(poses, points)
    dP = projection_jacobian(cam, bf, Xc, obs_ur >= 0)          # (L, K, 3, 3)
    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand_as(dP)
    Jc = -(dP @ torch.cat([eye, -hat(Xc)], dim=-1))              # residual = obs - prediction
    Jp = -(dP @ poses.R[None, :])
    return Jc, Jp


def robust_weights(r, inlier, inv_sigma2, obs_ur, use_robust):
    """chi2 + per-observation weights with the Huber kernel (masked)."""
    is_stereo = obs_ur >= 0
    delta2 = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    chi2 = torch.sum(r * r, dim=-1) * inv_sigma2
    chi2 = torch.where(inlier > 0, chi2, 0.0)
    w_rob = huber_weight(chi2, delta2) if use_robust else torch.ones_like(chi2)
    return chi2, w_rob * inv_sigma2 * inlier


def schur_camera_contrib(Jc, Jp, r, w, lam, dtype):
    """Per-landmark-shard Schur contributions.

    Returns (S_off_local, rhs_local, Hcc_local, Hpp_inv, Hcp, bp): the first
    three REDUCE over landmark shards in a distributed solver (no-op on one
    device); the rest stay local for point back-substitution."""
    Jcw = Jc * w[..., None, None]
    Jpw = Jp * w[..., None, None]
    Hcc = torch.einsum("lkri,lkrj->kij", Jcw, Jc)              # (K,6,6)
    Hpp = torch.einsum("lkri,lkrj->lij", Jpw, Jp)              # (L,3,3)
    Hcp = torch.einsum("lkri,lkrj->lkij", Jcw, Jp)             # (L,K,6,3)
    bc = torch.einsum("lkri,lkr->ki", Jcw, r)                  # (K,6)
    bp = torch.einsum("lkri,lkr->li", Jpw, r)                  # (L,3)

    Hpp_d = Hpp + (lam + 1e-8) * torch.eye(3, dtype=dtype, device=Jc.device)[None]
    Hpp_inv = torch.linalg.inv_ex(Hpp_d)[0]
    W_ = torch.einsum("lkij,ljm->lkim", Hcp, Hpp_inv)          # (L,K,6,3)
    S_off = -torch.einsum("lkim,lqjm->kqij", W_, Hcp)          # (K,K,6,6)
    rhs = bc - torch.einsum("lkim,lm->ki", W_, bp)             # (K,6)
    return S_off, rhs, Hcc, Hpp_inv, Hcp, bp


def assemble_and_solve(S_off, rhs, Hcc, lam, cam_free, dtype):
    """Reduced camera system: add damped diagonal, pin fixed cameras, dense
    solve. Inputs are the (already reduced, if distributed) totals."""
    K = Hcc.shape[0]
    device = Hcc.device
    ar = torch.arange(K, device=device)
    eye6 = torch.eye(6, dtype=dtype, device=device)[None]
    S = S_off.clone()
    S[ar, ar] = S[ar, ar] + Hcc + (lam + 1e-8) * eye6
    free = cam_free
    fmask = free[:, None] & free[None, :]
    S = torch.where(fmask[:, :, None, None], S, 0.0)
    S[ar, ar] = torch.where(free[:, None, None], S[ar, ar], eye6)
    rhs = torch.where(free[:, None], rhs, 0.0)
    Sd = S.permute(0, 2, 1, 3).reshape(6 * K, 6 * K)
    dxc = torch.linalg.solve_ex(Sd, -rhs.reshape(-1))[0].reshape(K, 6)
    return dxc


def backsub_points(Hpp_inv, Hcp, bp, dxc, point_free):
    """Back-substitute the landmark updates (local to each shard)."""
    rhs_p = -bp - torch.einsum("lkij,ki->lj", Hcp, dxc)
    dxp = torch.einsum("lij,lj->li", Hpp_inv, rhs_p)
    return torch.where(point_free[:, None], dxp, 0.0)


def apply_pose_update(poses: SE3, dxc) -> SE3:
    return se3_compose(se3_exp(dxc), poses)

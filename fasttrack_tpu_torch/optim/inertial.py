"""Visual-inertial optimization: motion-only VI pose optimization and the
temporal-window local inertial BA.

Port of fasttrack_tpu/optim/inertial.py. Parity targets:
- Optimizer::PoseInertialOptimizationLastKeyFrame / LastFrame
  (src/Optimizer.cc:4491, :4875): optimize the current frame's body state
  (pose, velocity, biases) against masked visual reprojection edges
  (EdgeMonoOnlyPose/EdgeStereoOnlyPose, G2oTypes.h), one EdgeInertial
  (G2oTypes.h:495) to the previous keyframe/frame state, and the bias
  random-walk priors (EdgePriorGyro/EdgePriorAcc).
- Optimizer::LocalInertialBA (src/Optimizer.cc:2383): a temporal window of
  keyframes with per-keyframe (pose, velocity, bias) states, inertial edges
  between consecutive keyframes, visual edges to the window's map points.

The 15-dim state tangent is [dphi, dp, dv, dbg, dba] with the reference's
retraction (ImuCamPose::Update, G2oTypes.cc): R <- R expSO3(dphi),
p <- p + R dp. Outliers stay in the problem as zero-weight residuals (4
rounds of chi2 re-classification), so every shape is fixed, and a step is
accepted or rejected with torch.where: the iterations never synchronise with
the device.

Where the JAX package differentiates the whole residual stack with
jax.jacfwd, the port writes the Jacobians out in closed form (EdgeInertial::
linearizeOplus, G2oTypes.cc): the visual rows through
`ba_core.projection_jacobian`, the inertial rows with the right Jacobian of
SO(3) and its inverse. The 30-dof LastFrame solve parametrises both states
additively from their initial values, as the JAX package does, so its local
Jacobians are carried to those coordinates (`_to_global`).

The whitening factors (the inverse square roots of the preintegration
covariance blocks and the square root of the LastFrame prior) are computed
on the host in float64 (`whitening_np`, `sqrtm_psd_np`) and uploaded with
the inputs: the tracker and the mapper hold the covariances on the host
anyway, and a device `eigh` would synchronise. The JAX package casts to
float64 with x64 disabled, so its factors are float32 (ROADMAP F9).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fasttrack_tpu_torch.cameras.models import Camera, project
from fasttrack_tpu_torch.geometry.so3 import (
    hat,
    so3_exp,
    so3_log,
    so3_right_jacobian,
    so3_right_jacobian_inv,
)
from fasttrack_tpu_torch.imu.preintegration import (
    GRAVITY,
    Preintegrated,
    unpack_preintegrated,
)
from fasttrack_tpu_torch.optim.ba_core import projection_jacobian
from fasttrack_tpu_torch.optim.robust import CHI2_MONO, CHI2_STEREO, huber_weight

WHITEN_SIZE = 99   # W9 (9x9), Wbg (3x3), Wba (3x3), row-major


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def _T(A):
    return A.transpose(-1, -2)


class BodyState(NamedTuple):
    """IMU body state in the world frame (VertexPose+VertexVelocity+biases)."""

    R_wb: torch.Tensor  # (..., 3, 3)
    p_w: torch.Tensor   # (..., 3)
    v_w: torch.Tensor   # (..., 3)
    bg: torch.Tensor    # (..., 3)
    ba: torch.Tensor    # (..., 3)


def _select(cond, a: BodyState, b: BodyState) -> BodyState:
    return BodyState(*(torch.where(cond, x, y) for x, y in zip(a, b)))


def retract(s: BodyState, dx: torch.Tensor) -> BodyState:
    """Apply a 15-dim tangent [dphi, dp, dv, dbg, dba] (ImuCamPose::Update)."""
    R = s.R_wb @ so3_exp(dx[..., 0:3])
    p = s.p_w + _mv(s.R_wb, dx[..., 3:6])
    return BodyState(R, p, s.v_w + dx[..., 6:9], s.bg + dx[..., 9:12],
                     s.ba + dx[..., 12:15])


def body_to_cam(s: BodyState, R_bc: torch.Tensor, t_bc: torch.Tensor):
    """T_cw from a body state: X_c = R_cb (R_wb^T (X_w - p_w)) + t_cb."""
    R_cb = _T(R_bc)
    t_cb = -_mv(R_cb, t_bc)
    R_cw = R_cb @ _T(s.R_wb)
    t_cw = t_cb - _mv(R_cw, s.p_w)
    return R_cw, t_cw


def cam_to_body(R_cw, t_cw, R_bc, t_bc):
    """Invert body_to_cam: body pose (R_wb, p_w) from a camera pose T_cw.

    With X_b = R_bc X_c + t_bc (T_bc: body <- camera, the reference's
    Calib.mTbc convention): R_wc = R_wb R_bc, so R_wb = R_wc R_bc^T and
    p_w = C_w - R_wb t_bc with camera center C_w = -R_wc t_cw."""
    R_wc = _T(R_cw)
    R_wb = R_wc @ _T(R_bc)
    p_w = -_mv(R_wc, t_cw) - _mv(R_wb, t_bc)
    return R_wb, p_w


def _bias_corrected(pre: Preintegrated, bg, ba):
    dbg = bg - pre.b0.bg
    dba = ba - pre.b0.ba
    phi_b = _mv(pre.JRg, dbg)
    dR = pre.dR @ so3_exp(phi_b)
    dV = pre.dV + _mv(pre.JVg, dbg) + _mv(pre.JVa, dba)
    dP = pre.dP + _mv(pre.JPg, dbg) + _mv(pre.JPa, dba)
    return dR, dV, dP, phi_b


def _gravity(like):
    return torch.tensor(GRAVITY, dtype=like.dtype, device=like.device)


def _residual_parts(pre: Preintegrated, s1: BodyState, s2: BodyState, b: BodyState):
    """EdgeInertial::computeError (G2oTypes.cc), with the intermediates its
    Jacobians need: (r9 = [er, ev, ep], E = dR(b)^T R1^T R2, R1^T (v2 - v1 -
    g dt), R1^T (p2 - p1 - v1 dt - g dt^2 / 2), JRg (bg - b0g), R1^T, dt)."""
    dR, dV, dP, phi_b = _bias_corrected(pre, b.bg, b.ba)
    dt = pre.dT[..., None]
    g = _gravity(s1.p_w)
    R1T = _T(s1.R_wb)
    E = _T(dR) @ (R1T @ s2.R_wb)
    dv_w = _mv(R1T, s2.v_w - s1.v_w - g * dt)
    dp_w = _mv(R1T, s2.p_w - s1.p_w - s1.v_w * dt - 0.5 * g * dt * dt)
    r9 = torch.cat([so3_log(E), dv_w - dV, dp_w - dP], dim=-1)
    return r9, E, dv_w, dp_w, phi_b, R1T, dt


def inertial_residual(
    pre: Preintegrated, s1: BodyState, s2: BodyState, bias_state: BodyState
) -> torch.Tensor:
    """EdgeInertial::computeError (G2oTypes.cc): 9-dim [er, ev, ep].

    Bias corrections are linearized at ``bias_state``'s biases (the
    reference attaches the FIRST state's bias vertices to the edge)."""
    return _residual_parts(pre, s1, s2, bias_state)[0]


def _edge(pre: Preintegrated, W9, Wbg, Wba, s1: BodyState, s2: BodyState, bias_on: int,
          jacobians: bool = True):
    """The whitened 15-dim edge between two states (batched over leading
    dims): W9 [er, ev, ep], Wbg (bg2 - bg1), Wba (ba2 - ba1); with its local
    Jacobians (..., 15, 15) wrt each state's tangent. `bias_on` (1 or 2) is
    the state whose biases correct the preintegration."""
    r9, E, dv_w, dp_w, phi_b, R1T, dt = _residual_parts(
        pre, s1, s2, s1 if bias_on == 1 else s2)
    r = torch.cat([_mv(W9, r9), _mv(Wbg, s2.bg - s1.bg), _mv(Wba, s2.ba - s1.ba)], dim=-1)
    if not jacobians:
        return r
    shape = r9.shape[:-1]
    z3 = torch.zeros(shape + (3, 3), dtype=r.dtype, device=r.device)
    eye = torch.eye(3, dtype=r.dtype, device=r.device).expand(shape + (3, 3))
    Jr_inv = so3_right_jacobian_inv(r9[..., :3])
    dt_ = dt[..., None]
    # columns [phi, p, v, bg, ba] of each state; rows er, ev, ep
    J1 = [[-Jr_inv @ _T(s2.R_wb) @ s1.R_wb, z3, z3],
          [hat(dv_w), z3, -R1T],
          [hat(dp_w), -eye, -R1T * dt_]]
    J2 = [[Jr_inv, z3, z3],
          [z3, z3, R1T],
          [z3, R1T @ s2.R_wb, z3]]
    Jb = [[-Jr_inv @ _T(E) @ so3_right_jacobian(phi_b) @ pre.JRg, z3],
          [-pre.JVg, -pre.JVa],
          [-pre.JPg, -pre.JPa]]
    nb = J1 if bias_on == 1 else J2
    ob = J2 if bias_on == 1 else J1
    for row in range(3):
        nb[row] = nb[row] + Jb[row]
        ob[row] = ob[row] + [z3, z3]

    def assemble(blocks, sign):
        top = torch.cat([torch.cat(row, dim=-1) for row in blocks], dim=-2)      # (.., 9, 15)
        top = W9 @ top
        walk = torch.cat([
            torch.cat([z3, z3, z3, sign * Wbg, z3], dim=-1),
            torch.cat([z3, z3, z3, z3, sign * Wba], dim=-1),
        ], dim=-2)
        return torch.cat([top, walk], dim=-2)

    return r, assemble(J1, -1.0), assemble(J2, 1.0)


def _to_global(J, phi, R, R0):
    """Carries local Jacobians (..., 15) of a state R = R0 exp(phi),
    p = p0 + R0 dp to the additive coordinates [phi, dp, ...]:
    d(local rot) = J_r(phi) d(phi), d(local p) = R^T R0 d(p)."""
    rot = J[..., 0:3] @ so3_right_jacobian(phi)
    pos = J[..., 3:6] @ (_T(R) @ R0)
    return torch.cat([rot, pos, J[..., 6:]], dim=-1)


# ---------------------------------------------------------------- host factors
def _info_sqrt(C, eps: float = 1e-12) -> np.ndarray:
    """Symmetric W with W^T W = C^{-1} (whitening), batched, float64 on the
    host. eigh for robustness: C is PSD but can be near-singular for very
    short preintegration intervals."""
    w, V = np.linalg.eigh(np.asarray(C, np.float64))
    w = np.maximum(w, eps)
    return (V * (1.0 / np.sqrt(w))[..., None, :]) @ np.swapaxes(V, -1, -2)


def sqrtm_psd_np(H, eps: float = 1e-12) -> np.ndarray:
    """Symmetric PSD square root W with W W = H (for whitening priors),
    float64 on the host (the JAX package's `_sqrtm_psd`)."""
    w, V = np.linalg.eigh(np.asarray(H, np.float64))
    w = np.maximum(w, eps)
    return (V * np.sqrt(w)[..., None, :]) @ np.swapaxes(V, -1, -2)


def whitening_np(C) -> np.ndarray:
    """(..., 99) float64: W9 of C[:9, :9] ([phi, v, p]), Wbg and Wba of the
    bias-walk blocks, flattened (WHITEN_SIZE)."""
    C = np.asarray(C, np.float64)
    lead = C.shape[:-2]
    return np.concatenate([
        _info_sqrt(C[..., :9, :9]).reshape(lead + (81,)),
        _info_sqrt(C[..., 9:12, 9:12]).reshape(lead + (9,)),
        _info_sqrt(C[..., 12:15, 12:15]).reshape(lead + (9,)),
    ], axis=-1)


def _split_whiten(W):
    return (W[..., :81].reshape(W.shape[:-1] + (9, 9)),
            W[..., 81:90].reshape(W.shape[:-1] + (3, 3)),
            W[..., 90:99].reshape(W.shape[:-1] + (3, 3)))


def _whiten_for(pre: Preintegrated, whiten, like):
    """The whitening factors as given, or from `pre.C` on the host (one
    fetch: the tracker and the mapper always pass them)."""
    if whiten is None:
        whiten = torch.from_numpy(whitening_np(pre.C.detach().cpu().numpy()))
    return _split_whiten(whiten.to(dtype=like.dtype, device=like.device))


class VIPoseResult(NamedTuple):
    state: BodyState
    inliers: torch.Tensor
    n_inliers: torch.Tensor
    # 15x15 information of the optimized state at the solution (visual +
    # inertial, inlier-weighted): the ConstraintPoseImu prior carried to
    # the next frame's LastFrame-anchored solve (Optimizer.cc:4850-4870).
    H: torch.Tensor = None


class _Visual:
    """The visual edges of one body state against N world points: the
    residual (N, 3) [du, dv, dur] and its local Jacobian's [phi, p]
    columns (N, 3, 6)."""

    def __init__(self, cam, bf, R_bc, t_bc, Xw, obs_uv, obs_ur):
        self.cam, self.bf, self.Xw, self.obs_uv, self.obs_ur = cam, bf, Xw, obs_uv, obs_ur
        self.R_bc, self.t_bc = R_bc, t_bc
        self.R_cb = _T(R_bc)
        self.is_stereo = obs_ur >= 0

    def residual(self, s: BodyState):
        R_cw, t_cw = body_to_cam(s, self.R_bc, self.t_bc)
        Xc = _mv(R_cw, self.Xw) + t_cw
        uv = project(self.cam, Xc)
        z = torch.clamp(Xc[..., 2], min=1e-6)
        ur = uv[..., 0] - self.bf / z
        du = self.obs_uv[..., 0] - uv[..., 0]
        dv = self.obs_uv[..., 1] - uv[..., 1]
        dur = torch.where(self.is_stereo, self.obs_ur - ur, 0.0)
        return torch.stack([du, dv, dur], dim=-1), Xc

    def jacobian6(self, s: BodyState, Xc):
        """d(residual)/d([dphi, dp]): X_b = R_wb^T (X_w - p_w) moves by
        hat(X_b) dphi and by -dp; X_c = R_cb X_b + t_cb."""
        dP = projection_jacobian(self.cam, self.bf, Xc, self.is_stereo)
        Xb = (self.Xw - s.p_w) @ s.R_wb
        dPR = dP @ self.R_cb
        return torch.cat([-(dPR @ hat(Xb)), dPR], dim=-1)


def _state_diff(s: BodyState, s_ref: BodyState):
    """15-dim tangent from s_ref to s (for the marginal prior)."""
    dphi = so3_log(_T(s_ref.R_wb) @ s.R_wb)
    dp = _mv(_T(s_ref.R_wb), s.p_w - s_ref.p_w)
    return torch.cat([dphi, dp, s.v_w - s_ref.v_w, s.bg - s_ref.bg, s.ba - s_ref.ba], dim=-1)


def _pad15(J6):
    return torch.cat([J6, J6.new_zeros(J6.shape[:-1] + (9,))], dim=-1)


def _chi2_inliers(r, inv_sigma2, valid, is_stereo, dtype):
    chi2 = torch.sum(r * r, dim=-1) * inv_sigma2
    thr = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    return (valid & (chi2 <= thr)).to(dtype)


def _weights(r, inv_sigma2, inlier, delta2, use_robust):
    chi2 = torch.sum(r * r, dim=-1) * inv_sigma2
    w_rob = huber_weight(chi2, delta2) if use_robust else torch.ones_like(chi2)
    return w_rob * inv_sigma2 * inlier


def _vis_cost(r, w):
    return torch.sum(torch.where(w > 0, torch.sum(r * r, dim=-1) * w, 0.0))


def pose_inertial_optimize(
    cam: Camera,
    bf: torch.Tensor,
    R_bc: torch.Tensor,       # (3,3) body <- camera
    t_bc: torch.Tensor,       # (3,)
    prev: BodyState,          # anchor state (last KF or last frame), FIXED
    pre: Preintegrated,       # preintegration prev -> current
    s0: BodyState,            # initial current state
    Xw: torch.Tensor,         # (N, 3)
    obs_uv: torch.Tensor,     # (N, 2)
    obs_ur: torch.Tensor,     # (N,)  < 0 => mono edge
    inv_sigma2: torch.Tensor, # (N,)
    valid: torch.Tensor,      # (N,) bool
    prior_H: torch.Tensor | None = None,  # (15,15) ConstraintPoseImu info
    rounds: int = 4,
    iters: int = 10,
    whiten: torch.Tensor | None = None,   # (99,) whitening_np(pre.C)
) -> VIPoseResult:
    """Motion-only VI optimization (Optimizer.cc:4491/:4875 semantics).

    Unknowns: the current body state (15 dof). The previous state is fixed;
    its information enters through the inertial edge + bias priors (and the
    optional ``prior_H`` marginal prior, the LastFrame variant's
    ConstraintPoseImu)."""
    dtype = Xw.dtype
    W9, Wbg, Wba = _whiten_for(pre, whiten, Xw)
    vis = _Visual(cam, bf, R_bc, t_bc, Xw, obs_uv, obs_ur)
    delta2 = torch.where(vis.is_stereo, CHI2_STEREO, CHI2_MONO)
    eye15 = torch.eye(15, dtype=dtype, device=Xw.device)
    s_lin = s0

    def other(s, jac):
        return _edge(pre, W9, Wbg, Wba, prev, s, bias_on=2, jacobians=jac)

    s = s0
    inlier = valid.to(dtype)
    for rnd in range(rounds):
        use_robust = rnd < 2
        lam = torch.full((), 1e-2, dtype=dtype, device=Xw.device)
        for _ in range(iters):
            rv, Xc = vis.residual(s)
            w = _weights(rv, inv_sigma2, inlier, delta2, use_robust)
            Jv = torch.where((w > 0)[:, None, None], vis.jacobian6(s, Xc), 0.0)
            ri, _, Ji = other(s, True)
            Jw = Jv * w[:, None, None]
            H = eye15.new_zeros((15, 15))
            H[:6, :6] = torch.einsum("nij,nik->jk", Jw, Jv)
            H = H + _T(Ji) @ Ji
            g = _pad15(torch.einsum("nij,ni->j", Jw, torch.where((w > 0)[:, None], rv, 0.0)))
            g = g + _mv(_T(Ji), ri)
            c_old = _vis_cost(rv, w) + torch.sum(ri * ri)
            if prior_H is not None:
                dx0 = _state_diff(s, s_lin)
                H = H + prior_H
                g = g + _mv(prior_H, dx0)
                c_old = c_old + dx0 @ _mv(prior_H, dx0)
            A = H + lam * torch.diag_embed(torch.diagonal(H)) + 1e-9 * eye15
            dx = torch.linalg.solve_ex(A, -g)[0]
            s_new = retract(s, dx)
            rv_new, _ = vis.residual(s_new)
            ri_new = other(s_new, False)
            c_new = _vis_cost(rv_new, w) + torch.sum(ri_new * ri_new)
            if prior_H is not None:
                dx1 = _state_diff(s_new, s_lin)
                c_new = c_new + dx1 @ _mv(prior_H, dx1)
            accept = c_new < c_old
            s = _select(accept, s_new, s)
            lam = torch.where(accept, lam * 0.5, lam * 4.0)
        inlier = _chi2_inliers(vis.residual(s)[0], inv_sigma2, valid, vis.is_stereo, dtype)

    inl = inlier > 0
    # Information of the solution for the next frame's ConstraintPoseImu.
    rv, Xc = vis.residual(s)
    w_fin = inlier * inv_sigma2
    Jv = torch.where((w_fin > 0)[:, None, None], vis.jacobian6(s, Xc), 0.0)
    _, _, Ji = other(s, True)
    H_fin = _T(Ji) @ Ji
    H_fin[:6, :6] = H_fin[:6, :6] + torch.einsum("nij,nik,n->jk", Jv, Jv, w_fin)
    return VIPoseResult(s, inl, inl.sum(), H_fin)


def pose_inertial_optimize_lastframe(
    cam: Camera,
    bf: torch.Tensor,
    R_bc: torch.Tensor,
    t_bc: torch.Tensor,
    prev0: BodyState,         # last-frame anchor state (FREE, softly held)
    prior_H: torch.Tensor,    # (15,15) ConstraintPoseImu information on prev
    pre: Preintegrated,       # frame-to-frame preintegration prev -> current
    s0: BodyState,            # initial current state
    Xw: torch.Tensor,
    obs_uv: torch.Tensor,
    obs_ur: torch.Tensor,
    inv_sigma2: torch.Tensor,
    valid: torch.Tensor,
    rounds: int = 4,
    iters: int = 10,
    whiten: torch.Tensor | None = None,   # (99,) whitening_np(pre.C)
    W_prior: torch.Tensor | None = None,  # (15,15) sqrtm_psd_np(prior_H)
) -> VIPoseResult:
    """PoseInertialOptimizationLastFrame (Optimizer.cc:4875): joint 30-dof
    solve over [last frame, current frame]. The last frame is FREE but held
    by the EdgePriorPoseImu soft prior (``prior_H``, the marginal information
    of its own optimization) instead of being clamped: anchor error relaxes
    through the inertial edge instead of propagating rigidly."""
    dtype = Xw.dtype
    dev = Xw.device
    W9, Wbg, Wba = _whiten_for(pre, whiten, Xw)
    if W_prior is None:
        W_prior = torch.from_numpy(sqrtm_psd_np(prior_H.detach().cpu().numpy()))
    W_prior = W_prior.to(dtype=dtype, device=dev)
    vis = _Visual(cam, bf, R_bc, t_bc, Xw, obs_uv, obs_ur)
    delta2 = torch.where(vis.is_stereo, CHI2_STEREO, CHI2_MONO)
    eye30 = torch.eye(30, dtype=dtype, device=dev)
    zeros15 = torch.zeros((15, 15), dtype=dtype, device=dev)
    prior_rows = torch.cat([W_prior, zeros15], dim=-1)                  # d(rp)/d(dx)

    def states_of(dx):
        return retract(prev0, dx[:15]), retract(s0, dx[15:])

    def other_res(sp, sc):
        """Whitened inertial edge + bias walk + anchor prior: (30,)."""
        r = _edge(pre, W9, Wbg, Wba, sp, sc, bias_on=1, jacobians=False)
        return torch.cat([r, _mv(W_prior, _state_diff(sp, prev0))])

    def linearize(dx):
        """Residuals at dx and their Jacobians wrt dx (30 columns; the
        visual rows touch only the current state's [dphi, dp])."""
        sp, sc = states_of(dx)
        rv, Xc = vis.residual(sc)
        Jv6 = vis.jacobian6(sc, Xc)
        Jv6 = torch.cat([Jv6[..., 0:3] @ so3_right_jacobian(dx[15:18]),
                         Jv6[..., 3:6] @ (_T(sc.R_wb) @ s0.R_wb)], dim=-1)
        re, J1, J2 = _edge(pre, W9, Wbg, Wba, sp, sc, bias_on=1)
        J1 = _to_global(J1, dx[0:3], sp.R_wb, prev0.R_wb)
        J2 = _to_global(J2, dx[15:18], sc.R_wb, s0.R_wb)
        ro = torch.cat([re, _mv(W_prior, _state_diff(sp, prev0))])
        Jo = torch.cat([torch.cat([J1, J2], dim=-1), prior_rows], dim=-2)  # (30, 30)
        return rv, Jv6, ro, Jo

    def normal_equations(rv, Jv6, ro, Jo, w):
        Jv6 = torch.where((w > 0)[:, None, None], Jv6, 0.0)
        Jw = Jv6 * w[:, None, None]
        H = _T(Jo) @ Jo
        H[15:21, 15:21] = H[15:21, 15:21] + torch.einsum("nij,nik->jk", Jw, Jv6)
        g = _mv(_T(Jo), ro)
        g[15:21] = g[15:21] + torch.einsum(
            "nij,ni->j", Jw, torch.where((w > 0)[:, None], rv, 0.0))
        return H, g

    dx = torch.zeros(30, dtype=dtype, device=dev)
    inlier = valid.to(dtype)
    for rnd in range(rounds):
        use_robust = rnd < 2
        lam = torch.full((), 1e-2, dtype=dtype, device=dev)
        for _ in range(iters):
            rv, Jv6, ro, Jo = linearize(dx)
            w = _weights(rv, inv_sigma2, inlier, delta2, use_robust)
            H, g = normal_equations(rv, Jv6, ro, Jo, w)
            A = H + lam * torch.diag_embed(torch.diagonal(H)) + 1e-9 * eye30
            step = torch.linalg.solve_ex(A, -g)[0]
            dx_new = dx + step
            sp_n, sc_n = states_of(dx_new)
            rv_new, _ = vis.residual(sc_n)
            ro_new = other_res(sp_n, sc_n)
            c_old = _vis_cost(rv, w) + torch.sum(ro * ro)
            c_new = _vis_cost(rv_new, w) + torch.sum(ro_new * ro_new)
            accept = c_new < c_old
            dx = torch.where(accept, dx_new, dx)
            lam = torch.where(accept, lam * 0.5, lam * 4.0)
        inlier = _chi2_inliers(vis.residual(states_of(dx)[1])[0], inv_sigma2, valid,
                               vis.is_stereo, dtype)

    sp, sc = states_of(dx)
    inl = inlier > 0

    # Marginal information of the CURRENT state: Hcc - Hca Haa^-1 Hac.
    w_fin = inlier * inv_sigma2
    rv, Jv6, ro, Jo = linearize(dx)
    H30, _ = normal_equations(rv, Jv6, ro, Jo, w_fin)
    Haa = H30[:15, :15] + 1e-6 * torch.eye(15, dtype=dtype, device=dev)
    Hca = H30[15:, :15]
    Hcc = H30[15:, 15:]
    H_marg = Hcc - Hca @ torch.linalg.solve_ex(Haa, _T(Hca))[0]
    return VIPoseResult(sc, inl, inl.sum(), H_marg)


def pose_inertial_optimize_packed(
    cam, bf, R_bc, t_bc, prev, pre_buf, s0, Xw, obs_uv, obs_ur,
    inv_sigma2, valid, rounds: int = 4, iters: int = 10, whiten=None,
):
    """pose_inertial_optimize with the preintegration delivered as ONE
    packed (298,) buffer (the tracker keeps the running preintegration on
    the host; a NamedTuple argument would be 14 separate uploads)."""
    return pose_inertial_optimize(
        cam, bf, R_bc, t_bc, prev, unpack_preintegrated(pre_buf), s0, Xw, obs_uv, obs_ur,
        inv_sigma2, valid, rounds=rounds, iters=iters, whiten=whiten,
    )


def pose_inertial_optimize_lastframe_packed(
    cam, bf, R_bc, t_bc, prev0, prior_H, pre_buf, s0, Xw, obs_uv, obs_ur,
    inv_sigma2, valid, rounds: int = 4, iters: int = 10, whiten=None, W_prior=None,
):
    return pose_inertial_optimize_lastframe(
        cam, bf, R_bc, t_bc, prev0, prior_H, unpack_preintegrated(pre_buf), s0, Xw, obs_uv,
        obs_ur, inv_sigma2, valid, rounds=rounds, iters=iters, whiten=whiten, W_prior=W_prior,
    )


# ---------------------------------------------------------------------------
# Local inertial BA (Optimizer::LocalInertialBA, Optimizer.cc:2383)
# ---------------------------------------------------------------------------


class InertialBAProblem(NamedTuple):
    """Temporal window of K keyframe states + L points, fixed shapes.

    states:     BodyState with leading dim K (state 0 = oldest; states with
                ``state_free[k]==False`` are the fixed frontier, e.g. the KF
                before the window).
    pre:        stacked Preintegrated between consecutive states
                (K-1 of them); ``pre_valid[k]`` masks gaps.
    whiten:     (K-1, 99) whitening_np of the stacked covariances (None:
                computed from ``pre.C`` on the host, one fetch).
    Visual obs mirror optim.local_ba.BAProblem.
    """

    states: BodyState              # (K, ...)
    state_free: torch.Tensor       # (K,) bool
    pre: Preintegrated             # stacked, leading dim K-1
    pre_valid: torch.Tensor        # (K-1,) bool
    points: torch.Tensor           # (L, 3)
    point_free: torch.Tensor       # (L,) bool
    obs_uv: torch.Tensor           # (L, K, 2)
    obs_ur: torch.Tensor           # (L, K)
    inv_sigma2: torch.Tensor       # (L, K)
    mask: torch.Tensor             # (L, K) bool
    whiten: torch.Tensor | None = None


class InertialBAResult(NamedTuple):
    states: BodyState
    points: torch.Tensor
    inlier_mask: torch.Tensor  # (L, K)
    # steps the cost accepted that moved a live observation behind its
    # camera (ROADMAP F24), counted on the device
    n_flipped: torch.Tensor


def local_inertial_ba(
    prob: InertialBAProblem,
    cam: Camera,
    bf: torch.Tensor,
    R_bc: torch.Tensor,
    t_bc: torch.Tensor,
    iters: int = 8,
    mono_edges_only: bool = False,
) -> InertialBAResult:
    """Temporal-window VI bundle adjustment with Schur-eliminated points.

    Unknowns: K*15 state tangents + L*3 points. Each LM iteration:
    - visual residuals (L, K, 3) and their closed-form Jacobians;
    - inertial residuals (K-1, 15) whitened by the preintegration covariance;
    - the Schur complement over the point blocks (L 3x3 inverses);
    - a damped solve of the reduced (K*15) system.
    Computes in the floating type of the problem's points.

    A step that moves a live observation behind its camera is counted
    (`n_flipped`); in a monocular map's window (`mono_edges_only`) it is
    rejected, as its local BA rejects one (ROADMAP F24)."""
    K = prob.obs_uv.shape[1]
    dtype = prob.points.dtype
    dev = prob.points.device
    is_stereo = prob.obs_ur >= 0
    delta2 = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    W9s, Wbgs, Wbas = _whiten_for(prob.pre, prob.whiten, prob.points)
    R_bc = R_bc.to(dtype)
    t_bc = t_bc.to(dtype)
    R_cb = _T(R_bc)
    free_s = prob.state_free.to(dtype)
    free_p = prob.point_free.to(dtype)
    pre_valid = prob.pre_valid
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    ar = torch.arange(K - 1, device=dev)

    def take(states, sl):
        return BodyState(*(x[sl] for x in states))

    def vis_residuals(states, pts):
        """(L, K, 3) residuals, and the camera-frame points."""
        R_cw, t_cw = body_to_cam(states, R_bc, t_bc)                    # (K,3,3), (K,3)
        Xc = torch.einsum("kij,lj->lki", R_cw, pts) + t_cw[None]
        uv = project(cam, Xc)
        z = torch.clamp(Xc[..., 2], min=1e-6)
        ur = uv[..., 0] - bf / z
        du = prob.obs_uv[..., 0] - uv[..., 0]
        dv = prob.obs_uv[..., 1] - uv[..., 1]
        dur = torch.where(is_stereo, prob.obs_ur - ur, 0.0)
        return torch.stack([du, dv, dur], dim=-1), Xc, R_cw

    def inertial_residuals(states, jac):
        out = _edge(prob.pre, W9s, Wbgs, Wbas, take(states, slice(0, K - 1)),
                    take(states, slice(1, K)), bias_on=1, jacobians=jac)
        if not jac:
            return torch.where(pre_valid[:, None], out, 0.0)
        r, A, B = out
        keep = pre_valid[:, None, None]
        A = torch.where(keep, A * free_s[:-1, None, None], 0.0)
        B = torch.where(keep, B * free_s[1:, None, None], 0.0)
        return torch.where(pre_valid[:, None], r, 0.0), A, B

    def total_cost(states, pts, w):
        """The cost at fixed weights, and the camera-frame points."""
        rv, Xc, _ = vis_residuals(states, pts)
        ri = inertial_residuals(states, False)
        return _vis_cost(rv, w) + torch.sum(ri * ri), Xc

    states, pts = prob.states, prob.points
    lam = torch.full((), 1e-3, dtype=dtype, device=dev)
    n_flipped = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(iters):
        rv, Xc, R_cw = vis_residuals(states, pts)                       # (L, K, 3)
        chi2 = torch.sum(rv * rv, dim=-1) * prob.inv_sigma2
        w = huber_weight(chi2, delta2) * prob.inv_sigma2 * prob.mask     # (L, K)
        live = (w > 0)[..., None, None]

        # visual Jacobians wrt [dphi, dp] of each state and wrt each point
        dP = projection_jacobian(cam, bf, Xc, is_stereo)                 # (L, K, 3, 3)
        Xb = torch.einsum("kji,lkj->lki", states.R_wb, pts[:, None, :] - states.p_w[None])
        dPR = dP @ R_cb
        Js = torch.where(live, torch.cat([-(dPR @ hat(Xb)), dPR], dim=-1), 0.0)  # (L,K,3,6)
        Jp = torch.where(live, -(dP @ R_cw[None]), 0.0)                  # (L,K,3,3)
        rvw = torch.where((w > 0)[..., None], rv, 0.0)

        Hss_v = torch.einsum("lkim,lkin,lk->kmn", Js, Js, w)             # (K,6,6)
        Hsp = torch.einsum("lkim,lkin,lk->lkmn", Js, Jp, w)              # (L,K,6,3)
        Hpp = torch.einsum("lkim,lkin,lk->lmn", Jp, Jp, w)               # (L,3,3)
        gs_v = torch.einsum("lkim,lki,lk->km", Js, rvw, w)               # (K,6)
        gp = torch.einsum("lkim,lki,lk->lm", Jp, rvw, w)                 # (L,3)

        # inertial blocks, dense over the states: edge k touches states k, k+1
        ri, A, B = inertial_residuals(states, True)
        Ji = torch.zeros((K - 1, 15, K, 15), dtype=dtype, device=dev)
        Ji[ar, :, ar, :] = A
        Ji[ar, :, ar + 1, :] = B
        Ji2 = Ji.reshape(-1, K * 15)
        H = (_T(Ji2) @ Ji2).reshape(K, 15, K, 15)
        g = _mv(_T(Ji2), ri.reshape(-1)).reshape(K, 15)
        kk = torch.arange(K, device=dev)
        H[kk, :6, kk, :6] = H[kk, :6, kk, :6] + Hss_v
        g[:, :6] = g[:, :6] + gs_v

        # Schur: eliminate points. Hpp' = Hpp + lam*diag + eps
        Hpp_d = Hpp + lam * torch.diag_embed(torch.diagonal(Hpp, dim1=-2, dim2=-1)) + 1e-6 * eye3
        Hpp_inv = torch.linalg.inv_ex(Hpp_d)[0] * free_p[:, None, None]
        T1 = torch.einsum("lkmi,lij->lkmj", Hsp, Hpp_inv)                # (L,K,6,3)
        S = H.clone()
        S[:, :6, :, :6] = S[:, :6, :, :6] - torch.einsum("lkmj,lqnj->kmqn", T1, Hsp)
        rhs = g.clone()
        rhs[:, :6] = rhs[:, :6] - torch.einsum("lkmj,lj->km", T1, gp)

        # Fix non-free states: zero their rows/cols, unit diagonal.
        mfree = free_s.repeat_interleave(15)
        S2 = S.reshape(K * 15, K * 15)
        S2 = S2 * mfree[:, None] * mfree[None, :] + torch.diag(1.0 - mfree)
        rhs2 = rhs.reshape(-1) * mfree
        D = torch.diag_embed(torch.diagonal(S2))
        dx_s = torch.linalg.solve_ex(
            S2 + lam * D + 1e-6 * torch.eye(K * 15, dtype=dtype, device=dev), -rhs2
        )[0].reshape(K, 15)
        # Back-substitute points: dp = -Hpp_inv (gp + Hsp^T dx_s)
        gp_corr = gp + torch.einsum("lkmi,km->li", Hsp, dx_s[:, :6])
        dp = -_mv(Hpp_inv, gp_corr)

        states_new = retract(states, dx_s * free_s[:, None])
        pts_new = pts + dp * free_p[:, None]

        c_old = _vis_cost(rv, w) + torch.sum(ri * ri)
        c_new, Xc_new = total_cost(states_new, pts_new, w)
        accept = c_new < c_old
        # a pinhole point mirrored through the camera centre projects where
        # it did, so the cost cannot see such a flip
        flips = ((w > 0) & (Xc[..., 2] > 0) & (Xc_new[..., 2] <= 0)).any()
        n_flipped = n_flipped + (accept & flips).to(n_flipped.dtype)
        if mono_edges_only:
            accept = accept & ~flips
        states = _select(accept, states_new, states)
        pts = torch.where(accept, pts_new, pts)
        lam = torch.where(accept, lam * 0.5, lam * 4.0)

    rv, _, _ = vis_residuals(states, pts)
    chi2 = torch.sum(rv * rv, dim=-1) * prob.inv_sigma2
    inl = prob.mask & (chi2 <= delta2)
    return InertialBAResult(states, pts, inl, n_flipped)

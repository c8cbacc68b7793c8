"""IMU initialization: gyro bias, gravity direction, scale, velocities.

Port of fasttrack_tpu/imu/init.py, a copy (host NumPy float64). With
`mono_scale` the positions take the unknown scale, so the velocities it
solves are metric (the monocular-inertial mapper's IMU init and scale
refinement call it so).

Parity target: LocalMapping::InitializeIMU (LocalMapping.cc:1173) +
Optimizer::InertialOptimization (Optimizer.cc:3042-3497). The reference
solves a g2o graph; the same estimate has a (near-)closed form used by
VINS-style initializers, which we adopt:

1. gyro bias: Gauss-Newton on  r_ij = log( dR_ij(bg)^T R_i^T R_j )
   linearized with the preintegration Jacobian JRg (3x3 solve).
2. gravity (+ scale for monocular) + per-KF velocities: linear least
   squares from the preintegrated position/velocity equations.
3. gravity refinement on the 2-dof tangent of ||g|| = 9.81 sphere.

All host NumPy float64: runs once per map at ~10 keyframes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from fasttrack_tpu_torch.imu.preintegration import GRAVITY_VALUE


def _so3_exp(phi):
    th = np.linalg.norm(phi)
    K = np.array([[0, -phi[2], phi[1]], [phi[2], 0, -phi[0]], [-phi[1], phi[0], 0]])
    if th < 1e-10:
        return np.eye(3) + K
    return np.eye(3) + np.sin(th) / th * K + (1 - np.cos(th)) / th**2 * K @ K


def _so3_log(R):
    tr = np.clip((np.trace(R) - 1) / 2, -1, 1)
    th = np.arccos(tr)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    if th < 1e-10:
        return 0.5 * w
    return th / (2 * np.sin(th)) * w


class ImuInitResult(NamedTuple):
    success: bool
    bg: np.ndarray          # gyro bias
    gravity_w: np.ndarray   # gravity in the CURRENT world frame
    scale: float
    velocities: np.ndarray  # (K, 3) world-frame velocities per keyframe
    R_gw: np.ndarray        # rotation aligning world so gravity -> (0,0,-G)
    ba: np.ndarray = np.zeros(3)  # accelerometer bias (Optimizer.cc:3227)


def estimate_gyro_bias(R_wb: list, preints: list, iters: int = 5) -> np.ndarray:
    """R_wb: K body-to-world rotations; preints: K-1 Preintegrated (numpy
    views) between consecutive KFs. Solves for bg via GN with JRg."""
    bg = np.zeros(3)
    for _ in range(iters):
        H = np.zeros((3, 3))
        b = np.zeros(3)
        for i in range(len(preints)):
            pre = preints[i]
            dR_meas = np.asarray(pre.dR, np.float64)
            JRg = np.asarray(pre.JRg, np.float64)
            dR_corr = dR_meas @ _so3_exp(JRg @ (bg - np.asarray(pre.b0.bg, np.float64)))
            dR_vis = R_wb[i].T @ R_wb[i + 1]
            r = _so3_log(dR_corr.T @ dR_vis)
            # dr/dbg ~= JrInv * (...) * JRg ~= JRg to first order
            H += JRg.T @ JRg
            b += JRg.T @ r
        try:
            dbg = np.linalg.solve(H + 1e-12 * np.eye(3), b)
        except np.linalg.LinAlgError:
            break
        bg = bg + dbg
        if np.linalg.norm(dbg) < 1e-9:
            break
    return bg


def initialize_imu(
    R_wb: list,            # K body-to-world rotations (visual, world = first cam)
    p_w: list,             # K body positions in world
    preints: list,         # K-1 Preintegrated between consecutive KFs
    mono_scale: bool = False,
    estimate_ba: bool = True,
    prior_a: float = 1.0,  # Tikhonov weight pulling ba -> 0 (the reference's
                           # EdgePriorAcc, Optimizer.cc:3227; ba is weakly
                           # observable over short windows)
) -> ImuInitResult:
    """Full init. With bg from estimate_gyro_bias, solve the linear system
    for [v_0..v_{K-1}, g_w, ba, (s)] from:
        p_{i+1} = p_i + v_i dt + 0.5 g dt^2 + R_i (dP_i + JPa_i ba)
        v_{i+1} = v_i + g dt + R_i (dV_i + JVa_i ba)
    (positions scaled by s when mono_scale).
    """
    K = len(R_wb)
    if K < 3 or len(preints) != K - 1:
        return ImuInitResult(False, np.zeros(3), np.zeros(3), 1.0,
                             np.zeros((K, 3)), np.eye(3))
    bg = estimate_gyro_bias(R_wb, preints)

    # bias-corrected deltas (gyro part; the acc part stays an unknown)
    def corr(pre):
        dbg = bg - np.asarray(pre.b0.bg, np.float64)
        dR = np.asarray(pre.dR, np.float64) @ _so3_exp(np.asarray(pre.JRg, np.float64) @ dbg)
        dV = np.asarray(pre.dV, np.float64) + np.asarray(pre.JVg, np.float64) @ dbg
        dP = np.asarray(pre.dP, np.float64) + np.asarray(pre.JPg, np.float64) @ dbg
        JVa = np.asarray(pre.JVa, np.float64)
        JPa = np.asarray(pre.JPa, np.float64)
        # the unknown is absolute ba; shift by the linearization point
        ba0 = np.asarray(pre.b0.ba, np.float64)
        dV = dV - JVa @ ba0
        dP = dP - JPa @ ba0
        return float(pre.dT), dR, dV, dP, JVa, JPa

    nb = 3 if estimate_ba else 0
    n_unk = 3 * K + 3 + nb + (1 if mono_scale else 0)
    ca = 3 * K + 3  # ba column start
    rows = []
    rhs = []
    for i in range(K - 1):
        dt, dR, dV, dP, JVa, JPa = corr(preints[i])
        Ri = R_wb[i]
        # position equation (3 rows)
        row_p = np.zeros((3, n_unk))
        row_p[:, 3 * i:3 * i + 3] = np.eye(3) * dt          # v_i
        row_p[:, 3 * K:3 * K + 3] = 0.5 * np.eye(3) * dt**2  # g
        if estimate_ba:
            row_p[:, ca:ca + 3] = Ri @ JPa
        if mono_scale:
            row_p[:, -1] = -(p_w[i + 1] - p_w[i])
            rhs_p = -(Ri @ dP)
        else:
            rhs_p = (p_w[i + 1] - p_w[i]) - Ri @ dP
        rows.append(row_p)
        rhs.append(rhs_p)
        # velocity equation (3 rows)
        row_v = np.zeros((3, n_unk))
        row_v[:, 3 * i:3 * i + 3] = -np.eye(3)
        row_v[:, 3 * (i + 1):3 * (i + 1) + 3] = np.eye(3)
        row_v[:, 3 * K:3 * K + 3] = -np.eye(3) * dt
        if estimate_ba:
            row_v[:, ca:ca + 3] = -Ri @ JVa
        rows.append(row_v)
        rhs.append(Ri @ dV)
    if estimate_ba and prior_a > 0:
        row_b = np.zeros((3, n_unk))
        row_b[:, ca:ca + 3] = np.sqrt(prior_a) * np.eye(3)
        rows.append(row_b)
        rhs.append(np.zeros(3))
    A = np.concatenate(rows)
    y = np.concatenate(rhs)
    sol, *_ = np.linalg.lstsq(A, y, rcond=None)
    vels = sol[:3 * K].reshape(K, 3)
    g = sol[3 * K:3 * K + 3]
    ba = sol[ca:ca + 3] if estimate_ba else np.zeros(3)
    scale = float(sol[-1]) if mono_scale else 1.0
    if mono_scale and scale <= 1e-3:
        return ImuInitResult(False, bg, g, scale, vels, np.eye(3), ba)

    # Rotation taking current-world gravity to (0, 0, -G).
    g_norm = np.linalg.norm(g)
    if g_norm < 1e-6:
        return ImuInitResult(False, bg, g, scale, vels, np.eye(3))
    g_dir = g / g_norm
    target = np.array([0.0, 0.0, -1.0])
    v = np.cross(g_dir, target)
    c = float(g_dir @ target)
    if np.linalg.norm(v) < 1e-9:
        R_gw = np.eye(3) if c > 0 else _so3_exp(np.array([np.pi, 0, 0]))
    else:
        angle = np.arccos(np.clip(c, -1, 1))
        R_gw = _so3_exp(v / np.linalg.norm(v) * angle)
    ok = abs(g_norm - GRAVITY_VALUE) < 2.0  # sanity: within 2 m/s^2
    return ImuInitResult(bool(ok), bg, g, scale, vels, R_gw, ba)

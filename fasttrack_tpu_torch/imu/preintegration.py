"""IMU preintegration on manifold.

Port of fasttrack_tpu/imu/preintegration.py. Parity target:
IMU::Preintegrated (include/ImuTypes.h:143-221, src/ImuTypes.cc
IntegrateNewMeasurement): delta R/V/P on SO(3)xR^6, the five bias Jacobians
JRg, JVg, JVa, JPg, JPa, and the 15x15 covariance propagated with the
standard (Forster et al.) discrete model, plus the bias-corrected delta
getters used by the inertial optimization edges (G2oTypes EdgeInertial).

Two implementations of one update, as in the JAX package:
- `HostPreintegrated`: NumPy float64 on the host, the tracker's running
  accumulation (it reads the state every frame for the IMU prediction and
  keyframe storage). The device optimizers receive it as ONE packed upload
  (`pack_preintegrated` / `unpack_preintegrated`, 298 floats).
- `integrate_measurements`: the same update on tensors, one step per sample
  of a padded block (dt == 0 rows are no-ops selected out with
  torch.where); the JAX package's lax.scan becomes a plain loop over the
  samples. Nothing on the tracker's path calls it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fasttrack_tpu_torch.device import resolve
from fasttrack_tpu_torch.geometry.so3 import hat, so3_exp, so3_right_jacobian

GRAVITY_VALUE = 9.81  # ImuTypes.h:43
GRAVITY = (0.0, 0.0, -GRAVITY_VALUE)


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


class ImuBias(NamedTuple):
    """Gyro + accelerometer bias (IMU::Bias, ImuTypes.h:46-126)."""

    bg: torch.Tensor  # (..., 3)
    ba: torch.Tensor  # (..., 3)

    @staticmethod
    def zero(dtype=torch.float32, device=None) -> "ImuBias":
        device = resolve(device)
        return ImuBias(torch.zeros(3, dtype=dtype, device=device),
                       torch.zeros(3, dtype=dtype, device=device))


class ImuCalib(NamedTuple):
    """IMU-camera calibration (IMU::Calib): T_bc and noise densities. The
    extrinsic lives on the device the optimizers run on; `extrinsic_np`
    gives the host copy the tracker and the mapper compute with."""

    R_bc: torch.Tensor  # (3, 3) body <- camera rotation
    t_bc: torch.Tensor  # (3,)
    noise_gyro: float
    noise_acc: float
    walk_gyro: float
    walk_acc: float
    freq: float

    @staticmethod
    def default(freq: float = 200.0, device=None) -> "ImuCalib":
        device = resolve(device)
        return ImuCalib(
            torch.eye(3, dtype=torch.float32, device=device),
            torch.zeros(3, dtype=torch.float32, device=device),
            1.7e-4, 2.0e-3, 1.9e-5, 3.0e-3, freq,
        )

    def noise_cov(self) -> torch.Tensor:
        """6x6 discrete noise covariance Nga (ImuTypes Calib ctor: sigma^2 * freq)."""
        sg2 = self.noise_gyro**2 * self.freq
        sa2 = self.noise_acc**2 * self.freq
        return torch.diag(torch.tensor([sg2] * 3 + [sa2] * 3, dtype=torch.float32,
                                       device=self.R_bc.device))

    def walk_cov(self) -> torch.Tensor:
        """6x6 random-walk covariance NgaWalk (sigma^2 / freq)."""
        wg2 = self.walk_gyro**2 / self.freq
        wa2 = self.walk_acc**2 / self.freq
        return torch.diag(torch.tensor([wg2] * 3 + [wa2] * 3, dtype=torch.float32,
                                       device=self.R_bc.device))

    def extrinsic_np(self):
        """(R_bc, t_bc) as float64 NumPy arrays."""
        return (self.R_bc.detach().cpu().numpy().astype(np.float64),
                self.t_bc.detach().cpu().numpy().astype(np.float64))


class Preintegrated(NamedTuple):
    """Preintegrated deltas between two frames/keyframes.

    Fields mirror IMU::Preintegrated (ImuTypes.h:179-197): dT, dR, dV, dP,
    the bias Jacobians, the 15x15 covariance C (order: [phi, v, p, bg, ba]),
    the linearization bias b0, and average acc/gyro (used by IMU init).
    """

    dT: torch.Tensor
    dR: torch.Tensor  # (3, 3)
    dV: torch.Tensor  # (3,)
    dP: torch.Tensor  # (3,)
    JRg: torch.Tensor  # (3, 3)
    JVg: torch.Tensor
    JVa: torch.Tensor
    JPg: torch.Tensor
    JPa: torch.Tensor
    C: torch.Tensor  # (15, 15)
    b0: ImuBias
    avgA: torch.Tensor
    avgW: torch.Tensor

    @staticmethod
    def identity(b0: ImuBias | None = None, device=None) -> "Preintegrated":
        device = b0.bg.device if b0 is not None else resolve(device)
        f32 = dict(dtype=b0.bg.dtype if b0 is not None else torch.float32, device=device)
        zero3 = torch.zeros(3, **f32)
        zero33 = torch.zeros((3, 3), **f32)
        return Preintegrated(
            torch.zeros((), **f32), torch.eye(3, **f32), zero3, zero3,
            zero33, zero33, zero33, zero33, zero33,
            torch.zeros((15, 15), **f32),
            b0 if b0 is not None else ImuBias.zero(device=device),
            zero3, zero3,
        )


def integrate_measurements(
    pre: Preintegrated,
    acc: torch.Tensor,   # (N, 3) raw accelerometer samples
    gyro: torch.Tensor,  # (N, 3) raw gyro samples
    dt: torch.Tensor,    # (N,)   per-sample integration times; 0 = padding
    calib: ImuCalib,
) -> Preintegrated:
    """Integrate a padded block of measurements (IntegrateNewMeasurement,
    src/ImuTypes.cc), one step per sample in the JAX package's update order;
    dt == 0 rows are no-ops. Never synchronises with the device."""
    Nga = calib.noise_cov().to(device=acc.device, dtype=acc.dtype)
    NgaWalk = calib.walk_cov().to(device=acc.device, dtype=acc.dtype)
    eye3 = torch.eye(3, dtype=acc.dtype, device=acc.device)
    eye9 = torch.eye(9, dtype=acc.dtype, device=acc.device)
    p = pre
    for a_raw, w_raw, h in zip(acc, gyro, dt):
        valid = h > 0
        hs = torch.where(valid, h, 1.0)  # avoid 0*inf paths; masked out below
        a = a_raw - p.b0.ba
        w = w_raw - p.b0.bg

        # Position/velocity updates with the *old* dR (ImuTypes.cc order).
        dRa = _mv(p.dR, a)
        dP_new = p.dP + p.dV * hs + 0.5 * dRa * hs * hs
        dV_new = p.dV + dRa * hs

        # Covariance propagation (A, B of the 9x9 [phi, v, p] block).
        Wa = hat(a)
        dRWa = p.dR @ Wa
        dRi = so3_exp(w * hs)
        Jr = so3_right_jacobian(w * hs)

        A = eye9.clone()
        A[0:3, 0:3] = dRi.T
        A[3:6, 0:3] = -dRWa * hs
        A[6:9, 0:3] = -0.5 * dRWa * hs * hs
        A[6:9, 3:6] = eye3 * hs

        B = torch.zeros((9, 6), dtype=acc.dtype, device=acc.device)
        B[0:3, 0:3] = Jr * hs
        B[3:6, 3:6] = p.dR * hs
        B[6:9, 3:6] = 0.5 * p.dR * hs * hs

        C9_new = (A @ p.C[:9, :9]) @ A.T + (B @ Nga) @ B.T
        C_new = p.C.clone()
        C_new[:9, :9] = C9_new
        C_new[9:, 9:] = C_new[9:, 9:] + NgaWalk

        # Jacobian updates (position/velocity first with old values).
        JPa_new = p.JPa + p.JVa * hs - 0.5 * p.dR * hs * hs
        JPg_new = p.JPg + p.JVg * hs - 0.5 * (dRWa @ p.JRg) * hs * hs
        JVa_new = p.JVa - p.dR * hs
        JVg_new = p.JVg - (dRWa @ p.JRg) * hs

        dR_new = p.dR @ dRi
        JRg_new = dRi.T @ p.JRg - Jr * hs

        n_old = torch.clamp(p.dT * calib.freq, min=0.0)  # approx sample count
        avgA_new = (p.avgA * n_old + a_raw) / (n_old + 1.0)
        avgW_new = (p.avgW * n_old + w_raw) / (n_old + 1.0)

        new = (p.dT + torch.where(valid, hs, 0.0), dR_new, dV_new, dP_new,
               JRg_new, JVg_new, JVa_new, JPg_new, JPa_new, C_new)
        old = (p.dT, p.dR, p.dV, p.dP, p.JRg, p.JVg, p.JVa, p.JPg, p.JPa, p.C)
        sel = [torch.where(valid, n, o) for n, o in zip(new, old)]
        p = Preintegrated(*sel, p.b0, torch.where(valid, avgA_new, p.avgA),
                          torch.where(valid, avgW_new, p.avgW))
    return p


def preintegrate(
    acc: torch.Tensor, gyro: torch.Tensor, dt: torch.Tensor,
    calib: ImuCalib, b0: ImuBias | None = None,
) -> Preintegrated:
    if b0 is None:
        b0 = ImuBias.zero(acc.dtype, acc.device)
    return integrate_measurements(Preintegrated.identity(b0), acc, gyro, dt, calib)


# --- bias-corrected getters (ImuTypes.h GetDeltaRotation/Velocity/Position) --


def delta_rotation(pre: Preintegrated, b: ImuBias) -> torch.Tensor:
    dbg = b.bg - pre.b0.bg
    return pre.dR @ so3_exp(_mv(pre.JRg, dbg))


def delta_velocity(pre: Preintegrated, b: ImuBias) -> torch.Tensor:
    dbg = b.bg - pre.b0.bg
    dba = b.ba - pre.b0.ba
    return pre.dV + _mv(pre.JVg, dbg) + _mv(pre.JVa, dba)


def delta_position(pre: Preintegrated, b: ImuBias) -> torch.Tensor:
    dbg = b.bg - pre.b0.bg
    dba = b.ba - pre.b0.ba
    return pre.dP + _mv(pre.JPg, dbg) + _mv(pre.JPa, dba)


def predict_state(
    R_wb: torch.Tensor, v_w: torch.Tensor, p_w: torch.Tensor,
    pre: Preintegrated, b: ImuBias,
):
    """Dead-reckon the next body state (Tracking::PredictStateIMU,
    Tracking.cc:1795): R2 = R1 dR(b), v2 = v1 + g t + R1 dV(b),
    p2 = p1 + v1 t + 0.5 g t^2 + R1 dP(b)."""
    t = pre.dT
    R2 = R_wb @ delta_rotation(pre, b)
    g = torch.tensor(GRAVITY, dtype=v_w.dtype, device=v_w.device)
    v2 = v_w + g * t + _mv(R_wb, delta_velocity(pre, b))
    p2 = p_w + v_w * t + 0.5 * g * t * t + _mv(R_wb, delta_position(pre, b))
    return R2, v2, p2


# ---------------------------------------------------------------------------
# Host (NumPy) preintegration: the tracker's running accumulation, a copy of
# the JAX package's (frame sample counts are 5-30, so the host loop takes
# microseconds and the state never has to be fetched from the device).
# ---------------------------------------------------------------------------


def _np_hat(v):
    return np.array([[0.0, -v[2], v[1]], [v[2], 0.0, -v[0]],
                     [-v[1], v[0], 0.0]])


def _np_so3_exp(phi):
    th = np.linalg.norm(phi)
    K = _np_hat(phi)
    if th < 1e-10:
        return np.eye(3) + K + 0.5 * K @ K
    return (np.eye(3) + np.sin(th) / th * K
            + (1.0 - np.cos(th)) / th**2 * K @ K)


def _np_right_jacobian(phi):
    th = np.linalg.norm(phi)
    K = _np_hat(phi)
    if th < 1e-6:
        return np.eye(3) - 0.5 * K
    return (np.eye(3) - (1.0 - np.cos(th)) / th**2 * K
            + (th - np.sin(th)) / th**3 * K @ K)


class HostPreintegrated:
    """Mutable float64 mirror of Preintegrated for the tracker's running
    accumulation (IMU::Preintegrated's role on the host side). Field names
    match the device NamedTuple so downstream host consumers (IMU init,
    window BA stacking) take either."""

    __slots__ = ("dT", "dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa",
                 "C", "b0", "avgA", "avgW")

    class _B:
        __slots__ = ("bg", "ba")

        def __init__(self, bg, ba):
            self.bg = np.asarray(bg, np.float64)
            self.ba = np.asarray(ba, np.float64)

    def __init__(self, bg=None, ba=None):
        self.dT = 0.0
        self.dR = np.eye(3)
        self.dV = np.zeros(3)
        self.dP = np.zeros(3)
        z = np.zeros((3, 3))
        self.JRg, self.JVg, self.JVa = z.copy(), z.copy(), z.copy()
        self.JPg, self.JPa = z.copy(), z.copy()
        self.C = np.zeros((15, 15))
        self.b0 = HostPreintegrated._B(
            bg if bg is not None else np.zeros(3),
            ba if ba is not None else np.zeros(3),
        )
        self.avgA = np.zeros(3)
        self.avgW = np.zeros(3)

    def copy(self) -> "HostPreintegrated":
        p = HostPreintegrated(self.b0.bg.copy(), self.b0.ba.copy())
        p.dT = self.dT
        for f in ("dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa", "C",
                  "avgA", "avgW"):
            setattr(p, f, getattr(self, f).copy())
        return p

    def integrate(self, acc, gyro, dts, calib: ImuCalib):
        """IntegrateNewMeasurement (src/ImuTypes.cc): the device step's
        update order."""
        sg2 = calib.noise_gyro**2 * calib.freq
        sa2 = calib.noise_acc**2 * calib.freq
        Nga = np.diag([sg2] * 3 + [sa2] * 3)
        wg2 = calib.walk_gyro**2 / calib.freq
        wa2 = calib.walk_acc**2 / calib.freq
        NgaWalk = np.diag([wg2] * 3 + [wa2] * 3)
        for a_raw, w_raw, h in zip(np.asarray(acc, np.float64),
                                   np.asarray(gyro, np.float64),
                                   np.asarray(dts, np.float64)):
            if h <= 0:
                continue
            a = a_raw - self.b0.ba
            w = w_raw - self.b0.bg
            dRa = self.dR @ a
            self.dP = self.dP + self.dV * h + 0.5 * dRa * h * h
            self.dV = self.dV + dRa * h
            Wa = _np_hat(a)
            dRWa = self.dR @ Wa
            dRi = _np_so3_exp(w * h)
            Jr = _np_right_jacobian(w * h)
            A = np.eye(9)
            A[0:3, 0:3] = dRi.T
            A[3:6, 0:3] = -dRWa * h
            A[6:9, 0:3] = -0.5 * dRWa * h * h
            A[6:9, 3:6] = np.eye(3) * h
            B = np.zeros((9, 6))
            B[0:3, 0:3] = Jr * h
            B[3:6, 3:6] = self.dR * h
            B[6:9, 3:6] = 0.5 * self.dR * h * h
            self.C[:9, :9] = A @ self.C[:9, :9] @ A.T + B @ Nga @ B.T
            self.C[9:, 9:] += NgaWalk
            self.JPa = self.JPa + self.JVa * h - 0.5 * self.dR * h * h
            self.JPg = self.JPg + self.JVg * h - 0.5 * (dRWa @ self.JRg) * h * h
            self.JVa = self.JVa - self.dR * h
            self.JVg = self.JVg - (dRWa @ self.JRg) * h
            self.dR = self.dR @ dRi
            self.JRg = dRi.T @ self.JRg - Jr * h
            n_old = max(self.dT * calib.freq, 0.0)
            self.avgA = (self.avgA * n_old + a_raw) / (n_old + 1.0)
            self.avgW = (self.avgW * n_old + w_raw) / (n_old + 1.0)
            self.dT += h


PRE_PACKED_SIZE = 298  # 1+9+3+3+5*9+225+3+3+3+3


def pack_preintegrated(p) -> np.ndarray:
    """HostPreintegrated -> one (298,) float32 buffer (ONE upload for the
    device optimizers instead of 14 separate arrays)."""
    return np.concatenate([
        [p.dT], p.dR.ravel(), p.dV, p.dP,
        p.JRg.ravel(), p.JVg.ravel(), p.JVa.ravel(),
        p.JPg.ravel(), p.JPa.ravel(), p.C.ravel(),
        p.b0.bg, p.b0.ba, p.avgA, p.avgW,
    ]).astype(np.float32)


def unpack_preintegrated(buf: torch.Tensor) -> Preintegrated:
    """Inverse of pack_preintegrated, as views of the device buffer."""
    o = 1
    dR = buf[o:o + 9].reshape(3, 3); o += 9
    dV = buf[o:o + 3]; o += 3
    dP = buf[o:o + 3]; o += 3
    Js = []
    for _ in range(5):
        Js.append(buf[o:o + 9].reshape(3, 3)); o += 9
    C = buf[o:o + 225].reshape(15, 15); o += 225
    bg = buf[o:o + 3]; o += 3
    ba = buf[o:o + 3]; o += 3
    avgA = buf[o:o + 3]; o += 3
    avgW = buf[o:o + 3]; o += 3
    return Preintegrated(buf[0], dR, dV, dP, *Js, C, ImuBias(bg, ba), avgA, avgW)

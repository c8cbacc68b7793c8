"""Host (NumPy) camera projection: the CPU mirror of cameras.models.

Port of fasttrack_tpu/cameras/host.py (projection, unprojection and the two
gates the tracker's host side uses). The
tracker packs its query blocks on the host every frame, so a camera is
read back from its device once, with `host_camera`, and the helpers take
that copy.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from fasttrack_tpu_torch.cameras.models import FISHEYE_KB8, PINHOLE, Camera


class HostCamera(NamedTuple):
    kind: str
    params: np.ndarray  # (8,) float64 [fx fy cx cy k0 k1 k2 k3]
    width: int
    height: int


def host_camera(cam: Camera) -> HostCamera:
    """One device->host copy of the camera's parameters."""
    params = cam.params.detach().cpu().numpy().astype(np.float64)
    return HostCamera(cam.kind, params, cam.width, cam.height)


def project_np(cam: HostCamera, X: np.ndarray) -> np.ndarray:
    """Camera-frame points (..., 3) -> pixels (..., 2) (float64 host math).

    Pinhole: Pinhole.cpp project; KB8: KannalaBrandt8.cpp:28-95."""
    p = cam.params
    X = np.asarray(X, np.float64)
    if cam.kind == PINHOLE:
        z = X[..., 2]
        safe_z = np.where(np.abs(z) < 1e-9, 1e-9, z)
        u = p[0] * X[..., 0] / safe_z + p[2]
        v = p[1] * X[..., 1] / safe_z + p[3]
        return np.stack([u, v], axis=-1)
    if cam.kind == FISHEYE_KB8:
        x, y, z = X[..., 0], X[..., 1], X[..., 2]
        r2 = x * x + y * y
        r = np.sqrt(np.maximum(r2, 1e-18))
        theta = np.arctan2(r, z)
        t2 = theta * theta
        poly = 1.0 + t2 * (p[4] + t2 * (p[5] + t2 * (p[6] + t2 * p[7])))
        scale = np.where(r2 < 1e-16, 1.0, theta * poly / r)
        return np.stack([p[0] * scale * x + p[2], p[1] * scale * y + p[3]], axis=-1)
    raise ValueError(cam.kind)


def unproject_np(cam: HostCamera, uv: np.ndarray, iters: int = 10) -> np.ndarray:
    """Pixels (..., 2) -> unit-depth rays (..., 3) with z == 1."""
    p = cam.params
    uv = np.asarray(uv, np.float64)
    mx = (uv[..., 0] - p[2]) / p[0]
    my = (uv[..., 1] - p[3]) / p[1]
    if cam.kind == PINHOLE:
        return np.stack([mx, my, np.ones_like(mx)], axis=-1)
    if cam.kind == FISHEYE_KB8:
        theta_d = np.sqrt(mx * mx + my * my)
        theta = np.clip(theta_d, -np.pi / 2, np.pi / 2)
        for _ in range(iters):  # Newton (KannalaBrandt8.cpp:111-176)
            t2 = theta * theta
            f = theta * (1.0 + t2 * (p[4] + t2 * (p[5] + t2 * (p[6] + t2 * p[7])))) - theta_d
            df = 1.0 + t2 * (3 * p[4] + t2 * (5 * p[5] + t2 * (7 * p[6] + t2 * 9 * p[7])))
            theta = theta - f / np.maximum(df, 1e-6)
        scale = np.where(theta_d < 1e-8, 1.0, np.tan(theta) / np.maximum(theta_d, 1e-12))
        return np.stack([mx * scale, my * scale, np.ones_like(mx)], axis=-1)
    raise ValueError(cam.kind)


def in_image_np(cam: HostCamera, uv: np.ndarray) -> np.ndarray:
    return (
        (uv[..., 0] >= 0) & (uv[..., 0] < cam.width)
        & (uv[..., 1] >= 0) & (uv[..., 1] < cam.height)
    )


def frustum_depth_ok(cam: HostCamera, X: np.ndarray) -> np.ndarray:
    """Positive-depth gate. For KB8 the reference accepts wide angles via
    isInFrustumChecks; a small positive-z margin mirrors Frame::isInFrustum's
    0.1 z-floor for pinhole and KB8's forward hemisphere check."""
    if cam.kind == PINHOLE:
        return X[..., 2] > 0.1
    return X[..., 2] > -np.linalg.norm(X, axis=-1) * 0.5  # ~120 deg half-FOV

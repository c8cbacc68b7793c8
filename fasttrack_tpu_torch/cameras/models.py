"""Pinhole and Kannala-Brandt-8 camera models.

Port of fasttrack_tpu/cameras/models.py: a camera is a fixed-width
parameter tensor (8,) [fx fy cx cy k0 k1 k2 k3] (unused slots zero) plus a
`kind` tag; `project`, `unproject` and `project_jacobian` dispatch on the
kind in Python.

Where the JAX package takes the projection's Jacobian with jax.jacfwd, the
port writes it out in closed form for both models (a handful of
elementwise ops over the batch, where a traced jacfwd would cost hundreds
of launches a call), with the branches that jacfwd takes through the
projections' clamps and `where`s.
"""

from __future__ import annotations

import dataclasses

import torch

from fasttrack_tpu_torch.device import resolve

PINHOLE = "pinhole"
FISHEYE_KB8 = "kb8"

_MAX_PARAMS = 8


@dataclasses.dataclass(frozen=True)
class Camera:
    kind: str
    params: torch.Tensor  # (8,) float32, on the device the camera is used on
                          # (the constructors' device=None means the card)
    width: int
    height: int


def make_pinhole(fx, fy, cx, cy, width=752, height=480, device=None) -> Camera:
    p = torch.zeros(_MAX_PARAMS, dtype=torch.float32)
    p[:4] = torch.tensor([fx, fy, cx, cy], dtype=torch.float32)
    return Camera(PINHOLE, p.to(resolve(device)), int(width), int(height))


def make_kannala_brandt8(fx, fy, cx, cy, k0, k1, k2, k3, width=512, height=512,
                         device=None) -> Camera:
    p = torch.tensor([fx, fy, cx, cy, k0, k1, k2, k3], dtype=torch.float32)
    return Camera(FISHEYE_KB8, p.to(resolve(device)), int(width), int(height))


def _project_pinhole(params, X):
    z = X[..., 2]
    safe_z = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    u = params[0] * X[..., 0] / safe_z + params[2]
    v = params[1] * X[..., 1] / safe_z + params[3]
    return torch.stack([u, v], dim=-1)


def _project_kb8(params, X):
    x, y, z = X[..., 0], X[..., 1], X[..., 2]
    r2 = x * x + y * y
    r = torch.sqrt(torch.clamp(r2, min=1e-18))
    theta = torch.atan2(r, z)
    t2 = theta * theta
    poly = 1.0 + t2 * (params[4] + t2 * (params[5] + t2 * (params[6] + t2 * params[7])))
    scale = torch.where(r2 < 1e-16, 1.0, theta * poly / r)
    u = params[0] * scale * x + params[2]
    v = params[1] * scale * y + params[3]
    return torch.stack([u, v], dim=-1)


def project(cam: Camera, X: torch.Tensor) -> torch.Tensor:
    """Camera-frame points (..., 3) -> pixels (..., 2)."""
    if cam.kind == PINHOLE:
        return _project_pinhole(cam.params, X)
    if cam.kind == FISHEYE_KB8:
        return _project_kb8(cam.params, X)
    raise ValueError(cam.kind)


def _unproject_kb8(params, mx, my, iters: int = 10):
    """Invert theta_d = theta * poly(theta^2) by a fixed number of Newton
    steps from theta_d clamped to +-pi/2 (KannalaBrandt8.cpp:111-176 uses
    the same scheme); a ray's scale is tan(theta) / theta_d, 1 on the axis."""
    theta_d = torch.sqrt(mx * mx + my * my)
    theta_d_c = torch.clamp(theta_d, -torch.pi / 2, torch.pi / 2)
    theta = theta_d_c
    for _ in range(iters):
        t2 = theta * theta
        f = theta * (
            1.0 + t2 * (params[4] + t2 * (params[5] + t2 * (params[6] + t2 * params[7])))
        ) - theta_d_c
        df = 1.0 + t2 * (3 * params[4] + t2 * (5 * params[5] + t2 * (
            7 * params[6] + t2 * 9 * params[7])))
        theta = theta - f / torch.clamp(df, min=1e-6)
    return torch.where(theta_d < 1e-8, 1.0, torch.tan(theta) / theta_d)


def unproject(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    """Pixels (..., 2) -> unit-depth ray (..., 3) with z == 1."""
    p = cam.params
    mx = (uv[..., 0] - p[2]) / p[0]
    my = (uv[..., 1] - p[3]) / p[1]
    if cam.kind == FISHEYE_KB8:
        scale = _unproject_kb8(p, mx, my)
        mx, my = mx * scale, my * scale
    elif cam.kind != PINHOLE:
        raise ValueError(cam.kind)
    return torch.stack([mx, my, torch.ones_like(mx)], dim=-1)


def _jacobian_pinhole(params, X):
    """Rows du/dX, dv/dX of `_project_pinhole`: where |z| < 1e-9 the clamped
    depth is a constant, as differentiating through the clamp makes it."""
    fx, fy = params[0], params[1]
    x, y, z = X[..., 0], X[..., 1], X[..., 2]
    z_free = torch.abs(z) >= 1e-9
    inv_z = 1.0 / torch.where(z_free, z, 1e-9)
    zero = torch.zeros_like(z)
    du_dz = torch.where(z_free, -fx * x * inv_z * inv_z, 0.0)
    dv_dz = torch.where(z_free, -fy * y * inv_z * inv_z, 0.0)
    return (torch.stack([fx * inv_z, zero, du_dz], dim=-1),
            torch.stack([zero, fy * inv_z, dv_dz], dim=-1))


def _jacobian_kb8(params, X):
    """Rows du/dX, dv/dX of `_project_kb8` with s = theta_d / r:
    du/dX = fx (s e_x + x ds/dX). With D = dtheta_d/dtheta and
    q = r^2 + z^2, ds/dr = D z / (q r) - theta_d / r^2 and
    ds/dz = -D / q. On the axis (r^2 < 1e-16) s is the constant 1, so
    du/dX = fx e_x there, as jacfwd takes that branch of the `where`."""
    fx, fy = params[0], params[1]
    x, y, z = X[..., 0], X[..., 1], X[..., 2]
    r2 = x * x + y * y
    on_axis = r2 < 1e-16
    r2c = torch.clamp(r2, min=1e-18)
    r = torch.sqrt(r2c)
    theta = torch.atan2(r, z)
    t2 = theta * theta
    poly = 1.0 + t2 * (params[4] + t2 * (params[5] + t2 * (params[6] + t2 * params[7])))
    theta_d = theta * poly
    D = 1.0 + t2 * (3 * params[4] + t2 * (5 * params[5] + t2 * (
        7 * params[6] + t2 * 9 * params[7])))
    q = r2c + z * z
    s = torch.where(on_axis, 1.0, theta_d / r)
    ds_dr_over_r = torch.where(on_axis, 0.0, (D * z / q - theta_d / r) / r2c)
    ds_dz = torch.where(on_axis, 0.0, -D / q)
    xy = x * y * ds_dr_over_r
    return (torch.stack([fx * (s + x * x * ds_dr_over_r), fx * xy, fx * x * ds_dz], dim=-1),
            torch.stack([fy * xy, fy * (s + y * y * ds_dr_over_r), fy * y * ds_dz], dim=-1))


def project_jacobian_rows(cam: Camera, X: torch.Tensor):
    """(du/dX, dv/dX), each (..., 3), of `project` at camera-frame X."""
    if cam.kind == PINHOLE:
        return _jacobian_pinhole(cam.params, X)
    if cam.kind == FISHEYE_KB8:
        return _jacobian_kb8(cam.params, X)
    raise ValueError(cam.kind)


def project_jacobian(cam: Camera, X: torch.Tensor) -> torch.Tensor:
    """d(uv)/dX, shape (..., 2, 3) (GeometricCamera::projectJac)."""
    return torch.stack(project_jacobian_rows(cam, X), dim=-2)


def uncertainty2(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    """Per-observation uncertainty (GeometricCamera::uncertainty2: 1.0 for
    both models in the reference)."""
    return torch.ones(uv.shape[:-1], dtype=uv.dtype, device=uv.device)

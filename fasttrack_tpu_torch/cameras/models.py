"""Pinhole and Kannala-Brandt-8 camera models.

Port of fasttrack_tpu/cameras/models.py: a camera is a fixed-width
parameter tensor (8,) [fx fy cx cy k0 k1 k2 k3] (unused slots zero) plus a
`kind` tag; `project` / `unproject` dispatch on the kind in Python.
Unprojection is ported for the pinhole model only (the rectified stereo
path); KB8 comes with the fisheye slice.
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


def unproject(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    """Pixels (..., 2) -> unit-depth ray (..., 3) with z == 1 (pinhole)."""
    if cam.kind != PINHOLE:
        raise NotImplementedError(f"unproject for camera kind {cam.kind!r}")
    p = cam.params
    mx = (uv[..., 0] - p[2]) / p[0]
    my = (uv[..., 1] - p[3]) / p[1]
    return torch.stack([mx, my, torch.ones_like(mx)], dim=-1)

"""SE(3) rigid transforms as (R, t) pairs, batched over leading dimensions.

Port of fasttrack_tpu/geometry/se3.py. Tangent convention [rho (trans),
phi (rot)], as in Sophus. Matrix products run in full f32: the package
turns TF32 off on import (fasttrack_tpu_torch/__init__.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fasttrack_tpu_torch.device import resolve
from fasttrack_tpu_torch.geometry.so3 import (
    so3_exp,
    so3_left_jacobian,
    so3_left_jacobian_inv,
    so3_log,
)


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product (..., 3, 3) x (..., 3) -> (..., 3)."""
    return (A @ x[..., None])[..., 0]


class SE3(NamedTuple):
    """Rigid transform y = R x + t. R: (..., 3, 3), t: (..., 3)."""

    R: torch.Tensor
    t: torch.Tensor


def se3_identity(batch_shape=(), dtype=torch.float32, device=None) -> SE3:
    """Identity on `device` (None: the card; see device.resolve)."""
    device = resolve(device)
    R = torch.eye(3, dtype=dtype, device=device).expand(*batch_shape, 3, 3).clone()
    t = torch.zeros((*batch_shape, 3), dtype=dtype, device=device)
    return SE3(R, t)


def se3_exp(xi: torch.Tensor) -> SE3:
    """(..., 6) [rho, phi] -> SE3."""
    rho, phi = xi[..., :3], xi[..., 3:]
    return SE3(so3_exp(phi), _mv(so3_left_jacobian(phi), rho))


def se3_log(T: SE3) -> torch.Tensor:
    phi = so3_log(T.R)
    rho = _mv(so3_left_jacobian_inv(phi), T.t)
    return torch.cat([rho, phi], dim=-1)


def se3_inverse(T: SE3) -> SE3:
    Rt = T.R.transpose(-1, -2)
    return SE3(Rt, -_mv(Rt, T.t))


def se3_compose(A: SE3, B: SE3) -> SE3:
    """A o B (apply B first)."""
    return SE3(A.R @ B.R, _mv(A.R, B.t) + A.t)


def se3_apply(T: SE3, x: torch.Tensor) -> torch.Tensor:
    """Transform points x (..., 3)."""
    return _mv(T.R, x) + T.t


def se3_matrix(T: SE3) -> torch.Tensor:
    """(..., 4, 4) homogeneous matrix."""
    batch = T.t.shape[:-1]
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=T.t.dtype, device=T.t.device)
    top = torch.cat([T.R, T.t[..., None]], dim=-1)
    return torch.cat([top, bottom.expand(*batch, 1, 4)], dim=-2)

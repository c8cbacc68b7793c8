"""SO(3): rotation-matrix Lie group ops, batched over leading dimensions.

Port of fasttrack_tpu/geometry/so3.py. Small-angle branches use Taylor
expansions selected with torch.where, so every function is branch-free on
tensor values and never synchronises with the device.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(phi: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def vee(Phi: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) skew -> (..., 3)."""
    return torch.stack([Phi[..., 2, 1], Phi[..., 0, 2], Phi[..., 1, 0]], dim=-1)


def _sinc_coeffs(theta2: torch.Tensor):
    """Stable (A, B, C) with A=sin(t)/t, B=(1-cos t)/t^2, C=(1-A)/t^2."""
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    small = theta2 < _EPS
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - a) / theta2)
    return a, b, c


def _eye_like(K: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) tangent -> (..., 3, 3) rotation."""
    theta2 = torch.sum(phi * phi, dim=-1)
    a, b, _ = _sinc_coeffs(theta2)
    K = hat(phi)
    return _eye_like(K) + a[..., None, None] * K + b[..., None, None] * (K @ K)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation -> (..., 3) tangent. Handles theta near 0 and pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(torch.clamp(cos_theta, -1.0 + 1e-7, 1.0 - 1e-7))
    w = vee(R - R.transpose(-1, -2)) * 0.5  # sin(theta) * axis

    # Generic branch: phi = theta / sin(theta) * w (stable away from 0, pi).
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=_EPS * _EPS))
    small = theta < 1e-3
    factor = torch.where(small, 1.0 + theta * theta / 6.0, theta / sin_theta)
    phi_generic = factor[..., None] * w

    # Near pi: axis from the diagonal of S = (R + R^T)/2 = I cos + aa^T (1 - cos),
    # signs from the row of the dominant axis component.
    near_pi = cos_theta < -1.0 + 1e-5
    S = 0.5 * (R + R.transpose(-1, -2))
    diag = torch.diagonal(S, dim1=-2, dim2=-1)
    axis2 = torch.clamp(
        (diag - cos_theta[..., None]) / (1.0 - cos_theta[..., None]), 0.0, 1.0
    )
    axis_abs = torch.sqrt(axis2)
    k = torch.argmax(axis_abs, dim=-1)
    skrow = torch.take_along_dim(S, k[..., None, None].expand(*k.shape, 1, 3), dim=-2)[
        ..., 0, :
    ]
    sign = torch.where(skrow >= 0.0, 1.0, -1.0)
    iota = torch.arange(3, device=R.device)
    sign = torch.where(iota == k[..., None], 1.0, sign)
    axis = axis_abs * sign
    norm = torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    axis = axis / torch.clamp(norm, min=_EPS)
    phi_pi = theta[..., None] * axis
    return torch.where(near_pi[..., None], phi_pi, phi_generic)


def so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """J_l(phi): exp((phi+dphi)^) ~= exp(J_l dphi ^) exp(phi^)."""
    theta2 = torch.sum(phi * phi, dim=-1)
    _, b, c = _sinc_coeffs(theta2)
    K = hat(phi)
    return _eye_like(K) + b[..., None, None] * K + c[..., None, None] * (K @ K)


def so3_left_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    half = 0.5 * theta
    small = theta2 < _EPS
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / torch.clamp(torch.sin(half), min=_EPS)) / theta2,
    )
    K = hat(phi)
    return _eye_like(K) - 0.5 * K + cot_term[..., None, None] * (K @ K)

"""Sim(3) similarity transforms, batched over leading dimensions.

Port of fasttrack_tpu/geometry/sim3.py. Replaces Sophus::Sim3
(Thirdparty/Sophus/sophus/sim3.hpp) of the reference's loop closing and
essential-graph optimization (LoopClosing.cc, Optimizer.cc:1501) and
Sim3Solver. Action: y = s R x + t. Tangent convention [rho (3), phi (3),
sigma (1)]. Matrix products run in full f32: the package turns TF32 off on
import (fasttrack_tpu_torch/__init__.py), so no precision pin is needed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fasttrack_tpu_torch.device import resolve
from fasttrack_tpu_torch.geometry.se3 import SE3, _mv
from fasttrack_tpu_torch.geometry.so3 import hat, so3_exp, so3_log

_EPS = 1e-6


class Sim3(NamedTuple):
    R: torch.Tensor  # (..., 3, 3)
    t: torch.Tensor  # (..., 3)
    s: torch.Tensor  # (...,)


def sim3_identity(batch_shape=(), dtype=torch.float32, device=None) -> Sim3:
    """Identity on `device` (None: the card; see device.resolve)."""
    device = resolve(device)
    return Sim3(
        torch.eye(3, dtype=dtype, device=device).expand(*batch_shape, 3, 3).clone(),
        torch.zeros((*batch_shape, 3), dtype=dtype, device=device),
        torch.ones(batch_shape, dtype=dtype, device=device),
    )


def _calc_W(phi: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """The Sim3 'W' matrix such that t = W rho in sim3_exp.

    Closed form from Strasdat's thesis (as in Sophus sim3.hpp calcW), with
    the small-angle and small-scale branches selected by torch.where.
    """
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    s = torch.exp(sigma)
    sigma_small = torch.abs(sigma) < _EPS
    theta_small = theta2 < _EPS * _EPS

    one = torch.ones_like(sigma)
    safe_sigma = torch.where(sigma_small, one, sigma)
    safe_theta = torch.where(theta_small, one, theta)
    safe_theta2 = safe_theta * safe_theta

    C = torch.where(sigma_small, 1.0 + 0.5 * sigma, (s - 1.0) / safe_sigma)

    # sigma small branch
    A_ss = torch.where(theta_small, 0.5 * one, (1.0 - torch.cos(safe_theta)) / safe_theta2)
    B_ss = torch.where(
        theta_small, one / 6.0,
        (safe_theta - torch.sin(safe_theta)) / (safe_theta2 * safe_theta),
    )

    # sigma large branch
    A_ls_t_small = ((safe_sigma - 1.0) * s + 1.0) / (safe_sigma * safe_sigma)
    B_ls_t_small = (
        (0.5 * safe_sigma * safe_sigma - safe_sigma + 1.0) * s - 1.0
    ) / (safe_sigma * safe_sigma * safe_sigma)
    a = s * torch.sin(safe_theta)
    b = s * torch.cos(safe_theta)
    c = theta2 + sigma * sigma
    c = torch.where(c < _EPS * _EPS, one, c)
    A_ls_t_big = (a * safe_sigma + (1.0 - b) * safe_theta) / (safe_theta * c)
    B_ls_t_big = (C - ((b - 1.0) * sigma + a * safe_theta) / c) / safe_theta2
    A_ls = torch.where(theta_small, A_ls_t_small, A_ls_t_big)
    B_ls = torch.where(theta_small, B_ls_t_small, B_ls_t_big)

    A = torch.where(sigma_small, A_ss, A_ls)
    B = torch.where(sigma_small, B_ss, B_ls)

    K = hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(K.shape)
    return C[..., None, None] * eye + A[..., None, None] * K + B[..., None, None] * (K @ K)


def sim3_exp(xi: torch.Tensor) -> Sim3:
    """(..., 7) [rho, phi, sigma] -> Sim3."""
    rho, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    return Sim3(so3_exp(phi), _mv(_calc_W(phi, sigma), rho), torch.exp(sigma))


def sim3_log(S: Sim3) -> torch.Tensor:
    phi = so3_log(S.R)
    sigma = torch.log(S.s)
    rho = torch.linalg.solve(_calc_W(phi, sigma), S.t[..., None])[..., 0]
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)


def sim3_inverse(S: Sim3) -> Sim3:
    Rt = S.R.transpose(-1, -2)
    s_inv = 1.0 / S.s
    return Sim3(Rt, -s_inv[..., None] * _mv(Rt, S.t), s_inv)


def sim3_compose(A: Sim3, B: Sim3) -> Sim3:
    return Sim3(A.R @ B.R, A.s[..., None] * _mv(A.R, B.t) + A.t, A.s * B.s)


def sim3_apply(S: Sim3, x: torch.Tensor) -> torch.Tensor:
    return S.s[..., None] * _mv(S.R, x) + S.t


def sim3_from_se3(T: SE3) -> Sim3:
    return Sim3(T.R, T.t, torch.ones(T.t.shape[:-1], dtype=T.t.dtype, device=T.t.device))


def sim3_to_se3(S: Sim3) -> SE3:
    """Drop the scale into the translation (keyframe poses after the
    essential-graph optimization, LoopClosing.cc CorrectLoop: Tcw = [R, t/s])."""
    return SE3(S.R, S.t / S.s[..., None])

"""Two-view triangulation of bearing rays.

Port of fasttrack_tpu/cameras/stereo.py, `triangulate_two_view` only: the
stereo rig type and the fisheye match triangulation come with the fisheye
slice (ROADMAP M9).
"""

from __future__ import annotations

import torch

from fasttrack_tpu_torch.geometry import SE3


def triangulate_two_view(ray1: torch.Tensor, ray2: torch.Tensor, T_21: SE3) -> torch.Tensor:
    """DLT triangulation of bearing rays in camera-1 coordinates.

    ray1/ray2: (..., 3) rays with z=1 in their own camera frames;
    T_21: camera2 <- camera1, broadcastable to the rays' batch. Returns 3D
    points in the camera-1 frame. Mirrors GeometricTools::Triangulate
    (GeometricTools.h:37-40) but batched: builds the 4x4 DLT system and
    takes its null space from one batched SVD.
    """
    batch = ray1.shape[:-1]
    dtype, device = ray1.dtype, ray1.device
    eye = torch.eye(3, dtype=dtype, device=device).expand(*batch, 3, 3)
    zeros = torch.zeros((*batch, 3, 1), dtype=dtype, device=device)
    # P1 = [I | 0], P2 = [R | t]
    P1 = torch.cat([eye, zeros], dim=-1)
    R2 = T_21.R.expand(*batch, 3, 3)
    t2 = T_21.t.expand(*batch, 3)
    P2 = torch.cat([R2, t2[..., None]], dim=-1)

    def two_rows(ray, P):
        x, y = ray[..., 0:1], ray[..., 1:2]
        r0 = x * P[..., 2, :] - P[..., 0, :]
        r1 = y * P[..., 2, :] - P[..., 1, :]
        return torch.stack([r0, r1], dim=-2)

    A = torch.cat([two_rows(ray1, P1), two_rows(ray2, P2)], dim=-2)
    _, _, vt = torch.linalg.svd(A)
    Xh = vt[..., 3, :]
    w = Xh[..., 3]
    safe_w = torch.where(torch.abs(w) < 1e-12, 1e-12, w)
    return Xh[..., :3] / safe_w[..., None]

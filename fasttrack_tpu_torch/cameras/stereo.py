"""Stereo rig helpers: the rig, two-view triangulation and fisheye match
triangulation.

Port of fasttrack_tpu/cameras/stereo.py. Parity targets:
- rectified stereo: Frame.cc mbf/mb usage (depth = bf / disparity);
- fisheye: KannalaBrandt8::TriangulateMatches (KannalaBrandt8.cpp:306-393):
  parallax-gated two-view DLT triangulation with reprojection checks, used
  to validate fisheye stereo matches and give them a depth.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fasttrack_tpu_torch.cameras.models import Camera, project, unproject
from fasttrack_tpu_torch.device import resolve
from fasttrack_tpu_torch.geometry import SE3, se3_apply


class StereoRig(NamedTuple):
    left: Camera
    right: Camera
    T_rl: SE3            # right <- left (the reference's mTrl, Frame.h:72-74)
    bf: torch.Tensor     # baseline * fx (the reference's mbf)

    @property
    def baseline(self):
        return torch.linalg.vector_norm(self.T_rl.t)

    def to(self, device) -> "StereoRig":
        """The rig with its cameras and tensors on `device`."""
        return StereoRig(
            *(Camera(c.kind, c.params.to(device), c.width, c.height)
              for c in (self.left, self.right)),
            SE3(self.T_rl.R.to(device), self.T_rl.t.to(device)), self.bf.to(device),
        )


def stereo_rig_from_numpy(left: Camera, right: Camera, T_c1_c2, bf: float,
                          device=None) -> StereoRig:
    """The rig of a stereo pair from its 4x4 extrinsic camera1 <- camera2
    (Stereo.T_c1_c2), inverted in float64 on the host; the cameras and
    tensors go to `device` (None: the card, device.resolve)."""
    dev = resolve(device)
    T_c2_c1 = np.linalg.inv(np.asarray(T_c1_c2, np.float64))
    return StereoRig(
        Camera(left.kind, left.params.to(dev), left.width, left.height),
        Camera(right.kind, right.params.to(dev), right.width, right.height),
        SE3(torch.tensor(T_c2_c1[:3, :3], dtype=torch.float32, device=dev),
            torch.tensor(T_c2_c1[:3, 3], dtype=torch.float32, device=dev)),
        torch.tensor(bf, dtype=torch.float32, device=dev),
    )


def make_rectified_rig(cam: Camera, bf: float, device=None) -> StereoRig:
    """A rectified pair: one camera twice, the right one -bf/fx along x."""
    T = np.eye(4)
    T[0, 3] = float(bf) / float(cam.params[0])
    return stereo_rig_from_numpy(cam, cam, T, bf, device=device)


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


def triangulate_matches(
    rig: StereoRig,
    kp_left: torch.Tensor,    # (..., 2) pixels in the left image
    kp_right: torch.Tensor,   # (..., 2) pixels in the right image
    sigma2_left: torch.Tensor,
    sigma2_right: torch.Tensor,
    min_parallax_cos: float = 0.9998,
    chi2_thresh: float = 5.991,
):
    """Fisheye stereo match validation (KannalaBrandt8.cpp:306-393).

    Returns (depth_left, X_left, valid): the point's depth in the left
    camera, the point, and a mask combining the parallax gate, positive
    depths and both reprojection chi2 checks."""
    r1 = unproject(rig.left, kp_left)
    r2 = unproject(rig.right, kp_right)
    r1n = r1 / torch.linalg.vector_norm(r1, dim=-1, keepdim=True)
    # the right ray rotated into the left frame for the parallax test
    # (R_lr = R_rl^T)
    r2_in_l = torch.einsum("ji,...j->...i", rig.T_rl.R, r2)
    r2n = r2_in_l / torch.linalg.vector_norm(r2_in_l, dim=-1, keepdim=True)
    cos_parallax = torch.sum(r1n * r2n, dim=-1)

    X = triangulate_two_view(r1, r2, rig.T_rl)
    z1 = X[..., 2]
    X_in_r = se3_apply(rig.T_rl, X)
    z2 = X_in_r[..., 2]

    uv1 = project(rig.left, X)
    uv2 = project(rig.right, X_in_r)
    err1 = torch.sum((uv1 - kp_left) ** 2, dim=-1) / torch.clamp(sigma2_left, min=1e-9)
    err2 = torch.sum((uv2 - kp_right) ** 2, dim=-1) / torch.clamp(sigma2_right, min=1e-9)

    valid = (
        (cos_parallax < min_parallax_cos)
        & (z1 > 0)
        & (z2 > 0)
        & (err1 < chi2_thresh)
        & (err2 < chi2_thresh)
    )
    return z1, X, valid

"""Keypoint orientation: intensity-centroid (IC) angle.

Port of fasttrack_tpu/ops/orientation.py (patch route): one patch gather
per keypoint, then the moments m10, m01 over the radius-15 circular window
as one (N, P*P) @ (P*P, 2) product, angle = atan2(m01, m10). The moment
weights are a buffer of an `ICAngle` module built once per patch size and
device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

HALF_PATCH = 15


def _circle_mask() -> np.ndarray:
    d = np.arange(-HALF_PATCH, HALF_PATCH + 1)
    dy, dx = np.meshgrid(d, d, indexing="ij")
    # ORB's u_max table: |dx| <= round(sqrt(r^2 - dy^2)).
    umax = np.round(np.sqrt(np.maximum(HALF_PATCH**2 - d.astype(np.float64) ** 2, 0.0)))
    return (np.abs(dx) <= umax[dy + HALF_PATCH]).astype(np.float32)


# The 31x31 moment window as NumPy constants: the host extractor
# (ops/host_kernels.py) sums the moments over a raw-pyramid window with them.
_MASK = _circle_mask()
_D = np.arange(-HALF_PATCH, HALF_PATCH + 1, dtype=np.float32)
_DY, _DX = np.meshgrid(_D, _D, indexing="ij")


def _moment_weights(patch_size: int) -> np.ndarray:
    """(P*P, 2) weights: flat-patch inner product -> (m10, m01). The 31x31
    circular moment window is embedded centered in the P x P patch."""
    d = np.arange(-HALF_PATCH, HALF_PATCH + 1, dtype=np.float32)
    dy, dx = np.meshgrid(d, d, indexing="ij")
    mask = _circle_mask()
    ph = patch_size // 2
    wx = np.zeros((patch_size, patch_size), np.float32)
    wy = np.zeros((patch_size, patch_size), np.float32)
    lo, hi = ph - HALF_PATCH, ph + HALF_PATCH + 1
    wx[lo:hi, lo:hi] = dx * mask
    wy[lo:hi, lo:hi] = dy * mask
    return np.stack([wx.reshape(-1), wy.reshape(-1)], axis=1)


def gather_windows(levels, level, row0, col0, rows: int, cols: int) -> torch.Tensor:
    """(N, rows, cols) windows of levels (L, H, W) with top-left corners
    (row0, col0) at each keypoint's level, as one direct gather.

    Unlike jax.lax.dynamic_slice, which clamps a window that crosses the
    border, indexing here has no clamp: callers keep windows in bounds."""
    L, H, W = levels.shape
    dr = torch.arange(rows, device=levels.device)
    dc = torch.arange(cols, device=levels.device)
    r = (level.long() * H + row0.long())[:, None] + dr                  # (N, rows)
    idx = (r * W)[:, :, None] + (col0.long()[:, None] + dc)[:, None, :]
    return levels.reshape(-1)[idx]


def extract_patches(
    levels: torch.Tensor,  # (L, H, W)
    x: torch.Tensor,       # (N,) int level coords
    y: torch.Tensor,
    level: torch.Tensor,
    half: int,
) -> torch.Tensor:
    """(N, 2*half+1, 2*half+1) patches centred on (x, y) of `level`; centres
    lie at least `half` pixels inside the canvas."""
    P = 2 * half + 1
    return gather_windows(levels, level, y - half, x - half, P, P)


class ICAngle(nn.Module):
    def __init__(self, patch_size: int):
        super().__init__()
        self.register_buffer("weights", torch.from_numpy(_moment_weights(patch_size)))

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        m = patches.reshape(patches.shape[0], -1) @ self.weights  # (N, 2) = (m10, m01)
        return torch.atan2(m[:, 1], m[:, 0])


@functools.lru_cache(maxsize=8)
def ic_angle_module(patch_size: int, device: torch.device) -> ICAngle:
    return ICAngle(patch_size).to(device)


def ic_angles_from_patches(patches: torch.Tensor) -> torch.Tensor:
    """IC angle (N,) radians from pre-gathered (N, P, P) patches centred on
    the keypoints; P may exceed the 31x31 moment window."""
    return ic_angle_module(patches.shape[1], patches.device)(patches)

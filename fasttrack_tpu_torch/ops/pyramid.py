"""Image pyramid: bilinear resize + 7x7 Gaussian blur as operator products.

Port of fasttrack_tpu/ops/pyramid.py. Every level (raw and blurred) is
`A_l @ img @ B_l^T` with per-level constant row/column operators that fold
resize, blur and zero-padding to the level-0 canvas into one pair of
batched products. The operators are the JAX package's own numpy matrices,
held as buffers of a `PyramidOps` module built once per config and device.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
from torch import nn


class PyramidConfig(NamedTuple):
    height: int
    width: int
    n_levels: int = 8
    scale_factor: float = 1.2

    @property
    def scales(self):
        return [self.scale_factor**l for l in range(self.n_levels)]

    @property
    def level_sizes(self):
        """(h_l, w_l) per level, rounding like cv::resize."""
        return [
            (int(round(self.height / s)), int(round(self.width / s)))
            for s in self.scales
        ]


def gaussian_kernel_1d(size: int = 7, sigma: float = 2.0) -> np.ndarray:
    r = np.arange(size) - (size - 1) / 2
    k = np.exp(-0.5 * (r / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _resize_matrix(n_out: int, n_in: int) -> np.ndarray:
    """(n_out, n_in) bilinear (align_corners=False) resampling matrix:
    src = (dst + 0.5) * n_in/n_out - 0.5, clamped (cv::resize sampling)."""
    m = np.zeros((n_out, n_in), np.float64)
    scale = n_in / n_out
    for i in range(n_out):
        src = (i + 0.5) * scale - 0.5
        src = min(max(src, 0.0), n_in - 1.0)
        lo = int(np.floor(src))
        hi = min(lo + 1, n_in - 1)
        f = src - lo
        m[i, lo] += 1.0 - f
        m[i, hi] += f
    return m


def _blur_matrix(n: int, size: int = 7, sigma: float = 2.0) -> np.ndarray:
    """(n, n) banded matrix of the 1-D Gaussian with replicate padding."""
    k = gaussian_kernel_1d(size, sigma).astype(np.float64)
    half = size // 2
    m = np.zeros((n, n), np.float64)
    for i in range(n):
        for t in range(size):
            j = min(max(i + t - half, 0), n - 1)
            m[i, j] += k[t]
    return m


def _pyramid_matrices_np(config: PyramidConfig):
    """Row/col operators (2L, H0, H0) / (2L, W0, W0): levels 0..L-1 are the
    raw resizes, levels L..2L-1 the resize+blur, each zero-padded to the
    level-0 canvas."""
    L = config.n_levels
    H0, W0 = config.height, config.width
    rows = np.zeros((2 * L, H0, H0), np.float32)
    cols = np.zeros((2 * L, W0, W0), np.float32)
    for l, (h, w) in enumerate(config.level_sizes):
        rh = _resize_matrix(h, H0)
        cw = _resize_matrix(w, W0)
        rows[l, :h, :] = rh
        cols[l, :w, :] = cw
        rows[L + l, :h, :] = _blur_matrix(h) @ rh
        cols[L + l, :w, :] = _blur_matrix(w) @ cw
    return rows, cols


class Pyramid(NamedTuple):
    """Padded pyramid tensors. Levels beyond (h_l, w_l) are zero."""

    raw: torch.Tensor      # (L, H0, W0) float32, unblurred (FAST reads this)
    blurred: torch.Tensor  # (L, H0, W0) float32 (descriptors read this)
    config: PyramidConfig


class PyramidOps(nn.Module):
    """The 2L row and column operators of one PyramidConfig (about 51 MB
    at 480x752 with 8 levels)."""

    def __init__(self, config: PyramidConfig):
        super().__init__()
        self.config = config
        rows, cols = _pyramid_matrices_np(config)
        self.register_buffer("rows", torch.from_numpy(rows))                     # (2L, H, H)
        self.register_buffer("cols_t", torch.from_numpy(cols).transpose(1, 2).contiguous())  # (2L, W, W)

    def forward(self, images: torch.Tensor):
        """images (C, H0, W0) float32 -> (raw, blur), each (C*L, H0, W0)
        with camera 0's levels first."""
        L = self.config.n_levels
        C, H, W = images.shape
        tmp = torch.matmul(self.rows[:, None], images[None])   # (2L, C, H, W)
        out = torch.matmul(tmp, self.cols_t[:, None])          # (2L, C, H, W)
        raw = out[:L].transpose(0, 1).reshape(C * L, H, W)
        blur = out[L:].transpose(0, 1).reshape(C * L, H, W)
        return raw, blur


@functools.lru_cache(maxsize=8)
def pyramid_ops(config: PyramidConfig, device: torch.device) -> PyramidOps:
    return PyramidOps(config).to(device)


def build_pyramid_pair(
    image_left: torch.Tensor, image_right: torch.Tensor, config: PyramidConfig
):
    """Both stereo cameras in one batched product pair.

    Returns (raw2, blur2), each (2L, H0, W0) with camera 0 levels first —
    the layout extract_orb_pair consumes. Runs on the images' device."""
    imgs = torch.stack([image_left.float(), image_right.float()])
    return pyramid_ops(config, imgs.device)(imgs)

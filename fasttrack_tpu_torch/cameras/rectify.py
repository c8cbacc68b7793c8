"""Stereo rectification: precomputed remap tables + host remap.

Port of fasttrack_tpu/cameras/rectify.py (NumPy, on the host; for a pair
without a relative rotation its tables are bit-equal to the JAX package's,
so both packages upload the same uint8 pixels, and its remap is bit-equal
for any tables). Parity
target: Settings::precomputeRectificationMaps (src/Settings.cc; the
reference calls cv::stereoRectify + cv::initUndistortRectifyMap once at
startup and cv::remap per frame, System.cc:273-284).

The Bouguet algorithm (cv::stereoRectify's, zero alpha): split the
inter-camera rotation between the two views, rotate so that the baseline
becomes the new x-axis, build one shared pinhole K, then bake (rectified
pixel -> distorted source pixel) lookup tables. The per-frame remap is a
vectorized bilinear gather on the host, as the reference's cv::remap is.

Two differences from the JAX package, both recorded in ROADMAP:
`RectifyMaps` also carries `R1`, the rotation from camera 1 to the
rectified frame, which the System composes into the IMU extrinsic (F10);
and camera 1's half of the rotation split has the sign cv::stereoRectify
gives it, so a pair with a relative rotation comes out row-aligned (F23).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from fasttrack_tpu_torch.cameras.host import host_camera
from fasttrack_tpu_torch.cameras.models import Camera, make_pinhole


def _rodrigues(w: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def _log_so3(R: np.ndarray) -> np.ndarray:
    cos = np.clip((np.trace(R) - 1) / 2, -1, 1)
    th = np.arccos(cos)
    if th < 1e-12:
        return np.zeros(3)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return th / (2 * np.sin(th)) * w


def distort_pinhole(D: np.ndarray, x: np.ndarray, y: np.ndarray):
    """Radial-tangential (plumb-bob) distortion of normalized coords:
    D = [k1, k2, p1, p2, k3?] (the reference's pinhole distortion model)."""
    k1, k2, p1, p2 = D[0], D[1], D[2], D[3]
    k3 = D[4] if len(D) > 4 else 0.0
    r2 = x * x + y * y
    rad = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return xd, yd


def _K(cam: Camera) -> np.ndarray:
    fx, fy, cx, cy = host_camera(cam).params[:4]
    return np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])


class RectifyMaps(NamedTuple):
    map_lx: np.ndarray   # (H, W) source x for the left image
    map_ly: np.ndarray
    map_rx: np.ndarray
    map_ry: np.ndarray
    camera: Camera       # the new shared rectified pinhole camera
    bf: float            # baseline * new fx
    R1: np.ndarray       # (3, 3) float64, rectified <- camera 1


def compute_rectification(
    cam1: Camera, D1: np.ndarray,
    cam2: Camera, D2: np.ndarray,
    T_c1_c2: np.ndarray,             # 4x4 camera1 <- camera2
    width: int, height: int,
    device=None,                     # of the new camera (None: the card)
) -> RectifyMaps:
    K1 = _K(cam1)
    K2 = _K(cam2)
    # camera2 <- camera1
    T_c2_c1 = np.linalg.inv(np.asarray(T_c1_c2, np.float64))
    R = T_c2_c1[:3, :3]
    t = T_c2_c1[:3, 3]

    # Bouguet: split the rotation, then rotate the baseline onto +x.
    # X2 = R X1 + t with R = exp(om): r_l X1 and r_r X2 share one
    # orientation when r_l = exp(om/2) and r_r = exp(-om/2)
    # (cv::stereoRectify's r_r^T and r_r). The JAX package takes exp(-om/2)
    # for both, which leaves the pair's relative rotation in place
    # (ROADMAP F23); without one (R = I) the two agree bit for bit.
    om = _log_so3(R)
    r_l = _rodrigues(om / 2)             # rotates cam1 halfway toward cam2
    r_r = _rodrigues(om / 2).T           # and cam2 halfway toward cam1
    t_rect = r_r @ t                     # baseline in the half-rotated frame
    e1 = t_rect / np.linalg.norm(t_rect)
    if abs(e1[0]) >= abs(e1[1]):         # horizontal rig
        e2 = np.array([-e1[1], e1[0], 0.0])
    else:
        e2 = np.array([0.0, -e1[2], e1[1]])
    e2 /= np.linalg.norm(e2)
    e3 = np.cross(e1, e2)
    # the new x axis points from the right camera to the left (positive disparity)
    if e1[0] < 0:
        e1, e2 = -e1, -e2
    R_rect = np.stack([e1, e2, e3])
    R1 = R_rect @ r_l                    # rectified <- cam1
    R2 = R_rect @ r_r                    # rectified <- cam2

    fx = (K1[0, 0] + K1[1, 1] + K2[0, 0] + K2[1, 1]) / 4
    cx, cy = width / 2.0, height / 2.0
    Kn_inv = np.array([[1 / fx, 0, -cx / fx], [0, 1 / fx, -cy / fx], [0, 0, 1.0]])

    u, v = np.meshgrid(np.arange(width, dtype=np.float64),
                       np.arange(height, dtype=np.float64))
    rays = np.stack([u, v, np.ones_like(u)], -1) @ Kn_inv.T  # (H, W, 3)

    def make_map(Ri, Ki, Di):
        rc = rays @ Ri  # == (Ri^T @ ray): rectified ray -> original camera
        x = rc[..., 0] / rc[..., 2]
        y = rc[..., 1] / rc[..., 2]
        xd, yd = distort_pinhole(np.asarray(Di, np.float64), x, y)
        mx = Ki[0, 0] * xd + Ki[0, 2]
        my = Ki[1, 1] * yd + Ki[1, 2]
        return mx.astype(np.float32), my.astype(np.float32)

    mlx, mly = make_map(R1, K1, D1)
    mrx, mry = make_map(R2, K2, D2)
    baseline = float(np.linalg.norm(t))
    cam = make_pinhole(fx, fx, cx, cy, width, height, device=device)
    return RectifyMaps(mlx, mly, mrx, mry, cam, baseline * fx, R1)


def remap_bilinear(img: np.ndarray, mx: np.ndarray, my: np.ndarray) -> np.ndarray:
    """Vectorized bilinear remap (cv::remap BORDER_CONSTANT=0 equivalent)."""
    h, w = img.shape[:2]
    x0 = np.floor(mx).astype(np.int32)
    y0 = np.floor(my).astype(np.int32)
    fx_ = mx - x0
    fy_ = my - y0
    valid = (x0 >= 0) & (x0 < w - 1) & (y0 >= 0) & (y0 < h - 1)
    x0c = np.clip(x0, 0, w - 2)
    y0c = np.clip(y0, 0, h - 2)
    im = img.astype(np.float32)
    v00 = im[y0c, x0c]
    v01 = im[y0c, x0c + 1]
    v10 = im[y0c + 1, x0c]
    v11 = im[y0c + 1, x0c + 1]
    out = (
        v00 * (1 - fx_) * (1 - fy_) + v01 * fx_ * (1 - fy_)
        + v10 * (1 - fx_) * fy_ + v11 * fx_ * fy_
    )
    out = np.where(valid, out, 0.0)
    # Clamp only integer inputs, to the dtype's own range (cv::remap does not
    # clamp floats; a blanket [0,255] clip corrupts e.g. uint16 mm depth maps).
    if np.issubdtype(img.dtype, np.integer):
        info = np.iinfo(img.dtype)
        out = np.clip(out, info.min, info.max)
    return out.astype(img.dtype)


def resize_maps(in_h: int, in_w: int, out_h: int, out_w: int):
    """The (mx, my) tables of a bilinear resize from (in_h, in_w) to
    (out_h, out_w) by `remap_bilinear`, pixel centres aligned (the JAX
    System's `_resize_input`)."""
    ys = (np.arange(out_h) + 0.5) * in_h / out_h - 0.5
    xs = (np.arange(out_w) + 0.5) * in_w / out_w - 0.5
    return np.meshgrid(xs.astype(np.float32), ys.astype(np.float32))

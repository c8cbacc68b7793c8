"""State carried across from the JAX package into the port's tensors.

The tracking slice has no weights: its parameters are the camera, the
initial pose, the ORB configuration, the local-map arrays, the
device-resident point store and the per-frame query block. These helpers
take them as numpy arrays (what `np.asarray` gives for the JAX package's
values) and return the port's tensors, so a test or a tool can build every
input once and hand it to both packages. `device=None` means the card
(device.resolve); the CPU is `device="cpu"`.
`OrbConfig` needs no conversion: both packages' configs are NamedTuples
with the same fields (`OrbConfig(**jax_config._asdict())`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fasttrack_tpu_torch.cameras.models import Camera
from fasttrack_tpu_torch.device import resolve
from fasttrack_tpu_torch.geometry import SE3
from fasttrack_tpu_torch.ops.extractor import Keypoints


class MapArrays(NamedTuple):
    """Local-map operands of `tracking_hot_path`, in its argument order."""

    u: torch.Tensor       # (M,) float32 projected u
    v: torch.Tensor       # (M,) float32 projected v
    desc: torch.Tensor    # (M, 256) int8 +-1
    pos: torch.Tensor     # (M, 3) float32 world positions
    radius: torch.Tensor  # (M,) float32 search radii
    lmin: torch.Tensor    # (M,) int32 inclusive octave gate
    lmax: torch.Tensor    # (M,) int32
    ok: torch.Tensor      # (M,) bool


def camera_from_numpy(kind: str, params, width: int, height: int, device=None) -> Camera:
    """Camera from its kind and (8,) [fx fy cx cy k0 k1 k2 k3] parameters."""
    p = np.asarray(params, np.float32)
    if p.shape != (8,):
        raise ValueError(f"camera params must have shape (8,), got {p.shape}")
    return Camera(kind, torch.from_numpy(p.copy()).to(resolve(device)), int(width), int(height))


def se3_from_numpy(R, t, device=None) -> SE3:
    R = np.asarray(R, np.float32)
    t = np.asarray(t, np.float32)
    if R.shape[-2:] != (3, 3) or t.shape[-1:] != (3,):
        raise ValueError(f"expected R (..., 3, 3) and t (..., 3), got {R.shape}, {t.shape}")
    device = resolve(device)
    return SE3(torch.from_numpy(R.copy()).to(device), torch.from_numpy(t.copy()).to(device))


def _as_tensor(a, dtype, device) -> torch.Tensor:
    # a copy: a CPU tensor must not alias the caller's (maybe read-only) array
    return torch.from_numpy(np.array(a, dtype=dtype, order="C")).to(device)


def tensor_from_numpy(a, dtype, device=None) -> torch.Tensor:
    """One host->device upload of `a` as numpy `dtype`."""
    return _as_tensor(a, dtype, resolve(device))


def map_from_numpy(u, v, desc, pos, radius, lmin, lmax, ok, device=None) -> MapArrays:
    device = resolve(device)

    def as_t(a, dtype):
        return _as_tensor(a, dtype, device)

    m = MapArrays(
        as_t(u, np.float32), as_t(v, np.float32), as_t(desc, np.int8),
        as_t(pos, np.float32), as_t(radius, np.float32), as_t(lmin, np.int32),
        as_t(lmax, np.int32), as_t(ok, np.bool_),
    )
    n = m.u.shape[0]
    if m.desc.shape != (n, 256) or m.pos.shape != (n, 3) or any(
        a.shape != (n,) for a in (m.v, m.radius, m.lmin, m.lmax, m.ok)
    ):
        raise ValueError("map arrays disagree in length or shape")
    return m


class StoreArrays(NamedTuple):
    """The device-resident PointStore mirror, in `tlm_step`'s argument
    order (the reference's persistent CudaMapPoint arrays): uploaded when
    the map changes; between changes a frame uploads row indices only."""

    pos: torch.Tensor       # (cap, 3) float32 world positions
    desc: torch.Tensor      # (cap, 256) int8 +-1
    normal: torch.Tensor    # (cap, 3) float32 mean viewing direction
    min_dist: torch.Tensor  # (cap,) float32 scale-invariance distances
    max_dist: torch.Tensor  # (cap,) float32; non-finite -> 1e6


def store_from_numpy(pos, desc_signed, normal, min_dist, max_dist, device=None) -> StoreArrays:
    device = resolve(device)
    max_dist = np.asarray(max_dist)
    st = StoreArrays(
        _as_tensor(pos, np.float32, device), _as_tensor(desc_signed, np.int8, device),
        _as_tensor(normal, np.float32, device), _as_tensor(min_dist, np.float32, device),
        _as_tensor(np.where(np.isfinite(max_dist), max_dist, 1e6), np.float32, device),
    )
    cap = st.pos.shape[0]
    if st.pos.shape != (cap, 3) or st.desc.shape != (cap, 256) or st.normal.shape != (cap, 3) \
            or st.min_dist.shape != (cap,) or st.max_dist.shape != (cap,):
        raise ValueError("store arrays disagree in length or shape")
    return st


class QueryBlock(NamedTuple):
    """What the host uploads for one fused frame."""

    q7: torch.Tensor         # (7, M) float32 [u, v, radius, lmin, lmax, valid, angle]
    q_rows: torch.Tensor     # (M,) int32 store rows of the last frame's map points
    cand_rows: torch.Tensor  # (P,) int32 store rows of the local-map candidates
    cand_ok: torch.Tensor    # (P,) bool


def query_block_from_numpy(q7, q_rows, cand_rows, cand_ok, device=None) -> QueryBlock:
    device = resolve(device)
    qb = QueryBlock(
        _as_tensor(q7, np.float32, device), _as_tensor(q_rows, np.int32, device),
        _as_tensor(cand_rows, np.int32, device), _as_tensor(cand_ok, np.bool_, device),
    )
    M, P = qb.q_rows.shape[0], qb.cand_rows.shape[0]
    if qb.q7.shape != (7, M) or qb.q_rows.shape != (M,) or qb.cand_ok.shape != (P,):
        raise ValueError("query block arrays disagree in length or shape")
    return qb


def keypoints_from_numpy(x, y, xl, yl, level, angle, score, desc_signed, desc_packed, valid,
                         device=None) -> Keypoints:
    """A frame's keypoint set (the fields of ops.extractor.Keypoints)."""
    device = resolve(device)
    kp = Keypoints(
        _as_tensor(x, np.float32, device), _as_tensor(y, np.float32, device),
        _as_tensor(xl, np.int32, device), _as_tensor(yl, np.int32, device),
        _as_tensor(level, np.int32, device), _as_tensor(angle, np.float32, device),
        _as_tensor(score, np.float32, device), _as_tensor(desc_signed, np.int8, device),
        _as_tensor(desc_packed, np.uint8, device), _as_tensor(valid, np.bool_, device),
    )
    n = kp.x.shape[0]
    if kp.desc_signed.shape != (n, 256) or kp.desc_packed.shape != (n, 32) or any(
        a.shape != (n,) for a in (kp.y, kp.xl, kp.yl, kp.level, kp.angle, kp.score, kp.valid)
    ):
        raise ValueError("keypoint arrays disagree in length or shape")
    return kp

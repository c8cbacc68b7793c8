"""State carried across from the JAX package into the port's tensors.

The tracking slice has no weights: its parameters are the camera, the
initial pose, the ORB configuration and the local-map arrays. These
helpers take them as numpy arrays (what `np.asarray` gives for the JAX
package's values) and return the port's tensors on a given device, so a
test or a tool can build every input once and hand it to both packages.
`OrbConfig` needs no conversion: both packages' configs are NamedTuples
with the same fields (`OrbConfig(**jax_config._asdict())`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fasttrack_tpu_torch.cameras.models import Camera
from fasttrack_tpu_torch.geometry import SE3


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
    return Camera(kind, torch.from_numpy(p.copy()).to(device), int(width), int(height))


def se3_from_numpy(R, t, device=None) -> SE3:
    R = np.asarray(R, np.float32)
    t = np.asarray(t, np.float32)
    if R.shape[-2:] != (3, 3) or t.shape[-1:] != (3,):
        raise ValueError(f"expected R (..., 3, 3) and t (..., 3), got {R.shape}, {t.shape}")
    return SE3(torch.from_numpy(R.copy()).to(device), torch.from_numpy(t.copy()).to(device))


def map_from_numpy(u, v, desc, pos, radius, lmin, lmax, ok, device=None) -> MapArrays:
    def as_t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

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

"""State carried across from the JAX package into the port's tensors.

The system has no weights: its parameters are the camera, the
initial pose, the ORB configuration, the local-map arrays, the
device-resident point store, the per-frame query block, the bundle
adjustment window and the inertial values (IMU calibration and bias, a
preintegration, a body state, the inertial window). These helpers
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
from fasttrack_tpu_torch.imu.preintegration import (
    PRE_PACKED_SIZE,
    ImuBias,
    ImuCalib,
    Preintegrated,
    unpack_preintegrated,
)
from fasttrack_tpu_torch.nputils import device_fetch
from fasttrack_tpu_torch.ops.extractor import Keypoints
from fasttrack_tpu_torch.optim.inertial import BodyState, InertialBAProblem, whitening_np
from fasttrack_tpu_torch.optim.local_ba import BAProblem, BAResult


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


BA_FIELDS = ("R", "t", "points", "obs_uv", "obs_ur", "inv_sigma2", "mask", "cam_free",
             "point_free")


def ba_problem_from_numpy(arrays: dict, device=None, dtype=np.float32) -> BAProblem:
    """A bundle-adjustment window from the arrays `ba_assembly` packs: the
    eight fields of `BAProblem`, the poses as "R" (K, 3, 3) and "t" (K, 3).
    `dtype` is the floating type of the tensors, and so the precision the
    solver works in (it computes in the type of the window it is given)."""
    device = resolve(device)

    def as_t(name, dtype):
        return _as_tensor(arrays[name], dtype, device)

    prob = BAProblem(
        poses=SE3(as_t("R", dtype), as_t("t", dtype)),
        points=as_t("points", dtype),
        obs_uv=as_t("obs_uv", dtype),
        obs_ur=as_t("obs_ur", dtype),
        inv_sigma2=as_t("inv_sigma2", dtype),
        mask=as_t("mask", np.bool_),
        cam_free=as_t("cam_free", np.bool_),
        point_free=as_t("point_free", np.bool_),
    )
    L, K = prob.mask.shape
    if prob.poses.R.shape != (K, 3, 3) or prob.poses.t.shape != (K, 3) \
            or prob.points.shape != (L, 3) or prob.obs_uv.shape != (L, K, 2) \
            or prob.obs_ur.shape != (L, K) or prob.inv_sigma2.shape != (L, K) \
            or prob.cam_free.shape != (K,) or prob.point_free.shape != (L,):
        raise ValueError("BA window arrays disagree in length or shape")
    return prob


def ba_result_to_numpy(res: BAResult) -> dict:
    """A solved window on the host, in ONE synchronising fetch: "R", "t",
    "points", "inlier_mask", "chi2" as NumPy arrays, and "n_rejected" (an
    int) when the result counted its rejected steps."""
    parts = [res.poses.R, res.poses.t, res.points, res.inlier_mask, res.chi2]
    if res.n_rejected is not None:
        parts.append(res.n_rejected.reshape(1))
    R, t, points, inlier, chi2, *rej = device_fetch(*parts)
    out = {"R": R, "t": t, "points": points, "inlier_mask": inlier, "chi2": chi2}
    if rej:
        out["n_rejected"] = int(rej[0][0])
    return out


# ------------------------------------------------------------------ inertial
def imu_calib_from_numpy(R_bc, t_bc, noise_gyro, noise_acc, walk_gyro, walk_acc, freq,
                         device=None) -> ImuCalib:
    """IMU::Calib from the body <- camera extrinsic and the noise densities."""
    device = resolve(device)
    R, t = _as_tensor(R_bc, np.float32, device), _as_tensor(t_bc, np.float32, device)
    if R.shape != (3, 3) or t.shape != (3,):
        raise ValueError(f"expected R_bc (3, 3) and t_bc (3,), got {R.shape}, {t.shape}")
    return ImuCalib(R, t, float(noise_gyro), float(noise_acc), float(walk_gyro),
                    float(walk_acc), float(freq))


def imu_bias_from_numpy(bg, ba, device=None, dtype=np.float32) -> ImuBias:
    device = resolve(device)
    return ImuBias(_as_tensor(bg, dtype, device), _as_tensor(ba, dtype, device))


PRE_FIELDS = ("dT", "dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa", "C")


def preintegrated_from_numpy(pre, device=None, dtype=np.float32) -> Preintegrated:
    """Preintegrated from anything with its fields (the JAX package's
    NamedTuple, a HostPreintegrated), stacked along leading dims or not."""
    device = resolve(device)
    out = [_as_tensor(np.asarray(getattr(pre, f)), dtype, device) for f in PRE_FIELDS]
    lead = out[0].shape
    zero3 = np.zeros(lead + (3,))
    avg = [_as_tensor(np.asarray(getattr(pre, f, zero3)), dtype, device) for f in ("avgA", "avgW")]
    if out[1].shape != lead + (3, 3) or out[9].shape != lead + (15, 15):
        raise ValueError("preintegration fields disagree in shape")
    b0 = ImuBias(_as_tensor(pre.b0.bg, dtype, device), _as_tensor(pre.b0.ba, dtype, device))
    return Preintegrated(*out, b0, *avg)


def preintegrated_from_packed(buf, device=None) -> Preintegrated:
    """Preintegrated from the (298,) float32 buffer of pack_preintegrated."""
    t = _as_tensor(buf, np.float32, resolve(device))
    if t.shape != (PRE_PACKED_SIZE,):
        raise ValueError(f"expected a ({PRE_PACKED_SIZE},) buffer, got {tuple(t.shape)}")
    return unpack_preintegrated(t)


def body_state_from_numpy(R_wb, p_w, v_w, bg, ba, device=None, dtype=np.float32) -> BodyState:
    """A body state (or a stack of them along leading dims)."""
    device = resolve(device)
    s = BodyState(*(_as_tensor(a, dtype, device) for a in (R_wb, p_w, v_w, bg, ba)))
    lead = s.p_w.shape[:-1]
    if s.R_wb.shape != lead + (3, 3) or any(x.shape != lead + (3,) for x in s[1:]):
        raise ValueError("body state arrays disagree in shape")
    return s


def inertial_ba_problem_from_numpy(arrays: dict, device=None, dtype=np.float32
                                   ) -> InertialBAProblem:
    """An inertial window: the states as "R_wb" (K, 3, 3), "p_w", "v_w",
    "bg", "ba" (K, 3), "pre" (anything with the preintegration fields,
    stacked (K-1, ...)), and the other fields of InertialBAProblem by name.
    The whitening factors are computed from the stacked covariances in
    float64 (optim.inertial.whitening_np)."""
    device = resolve(device)

    def as_t(name, dt):
        return _as_tensor(arrays[name], dt, device)

    pre = arrays["pre"]
    prob = InertialBAProblem(
        states=body_state_from_numpy(*(arrays[k] for k in ("R_wb", "p_w", "v_w", "bg", "ba")),
                                     device=device, dtype=dtype),
        state_free=as_t("state_free", np.bool_),
        pre=preintegrated_from_numpy(pre, device, dtype),
        pre_valid=as_t("pre_valid", np.bool_),
        points=as_t("points", dtype), point_free=as_t("point_free", np.bool_),
        obs_uv=as_t("obs_uv", dtype), obs_ur=as_t("obs_ur", dtype),
        inv_sigma2=as_t("inv_sigma2", dtype), mask=as_t("mask", np.bool_),
        whiten=_as_tensor(whitening_np(np.asarray(pre.C, np.float64)), dtype, device),
    )
    L, K = prob.mask.shape
    if prob.states.R_wb.shape != (K, 3, 3) or prob.state_free.shape != (K,) \
            or prob.pre_valid.shape != (K - 1,) or prob.pre.dR.shape != (K - 1, 3, 3) \
            or prob.points.shape != (L, 3) or prob.obs_uv.shape != (L, K, 2) \
            or prob.obs_ur.shape != (L, K) or prob.inv_sigma2.shape != (L, K) \
            or prob.point_free.shape != (L,):
        raise ValueError("inertial window arrays disagree in length or shape")
    return prob

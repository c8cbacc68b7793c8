"""The per-frame tracking front end: images -> device-resident FrameData.

Port of fasttrack_tpu/frame_pipeline.py (rectified stereo): ORB
extraction for both cameras, rectified stereo matching, search-by-
projection against a local map and motion-only pose optimization. All
intermediates stay on the images' device and nothing in the chain reads a
value back to the host; `pack_hot_path_for_host` gathers what the tracker
needs into one buffer, so a frame costs exactly one device->host fetch.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fasttrack_tpu_torch.geometry import SE3
from fasttrack_tpu_torch.ops.extractor import (
    Keypoints,
    OrbConfig,
    extract_orb_pair_stacked,
    scale_factors,
)
from fasttrack_tpu_torch.ops.project_match import MatchResult, search_by_projection
from fasttrack_tpu_torch.ops.stereo_match import StereoMatches, match_rectified
from fasttrack_tpu_torch.optim.pose_opt import PoseOptResult, pose_optimize


class FrameData(NamedTuple):
    """Device-resident tensors for one stereo frame."""

    kps: Keypoints            # left-camera keypoints
    kps_right: Keypoints | None
    u_right: torch.Tensor     # (N,) float32; -1 = no stereo depth
    depth: torch.Tensor       # (N,) float32; -1 = none
    n_valid: torch.Tensor     # () int64


def _stereo_match_stage(kl: Keypoints, kr: Keypoints, pyr_l_raw, pyr_r_raw,
                        config: OrbConfig, bf, min_z):
    sm: StereoMatches = match_rectified(
        kl.x, kl.y, kl.level, kl.desc_signed, kl.valid,
        kr.x, kr.y, kr.level, kr.desc_signed, kr.valid,
        pyr_l_raw, pyr_r_raw, kl.xl, kl.yl,
        scale_factors(config, kl.x.device), bf, min_z,
    )
    return sm, kl.valid.sum()


def _search_optimize_stage(
    kl: Keypoints, u_right, config: OrbConfig, bf, cam, T0,
    map_u, map_v, map_desc, map_pos, map_radius, map_lmin, map_lmax, map_ok,
):
    """Search-by-projection, association gather and pose optimization."""
    res = search_by_projection(
        map_u, map_v, map_desc, map_radius, map_lmin, map_lmax, map_ok,
        kl.x, kl.y, kl.desc_signed, kl.level, kl.valid,
    )
    obs_uv = torch.stack([kl.x[res.idx], kl.y[res.idx]], dim=-1)
    inv_sigma2 = 1.0 / scale_factors(config, kl.x.device)[kl.level[res.idx]] ** 2
    opt = pose_optimize(cam, bf, T0, map_pos, obs_uv, u_right[res.idx], inv_sigma2, res.ok)
    return res, opt


def process_stereo_frame_stacked(
    images: torch.Tensor,     # (2, H, W) stacked L/R (uint8 ok)
    config: OrbConfig,
    bf: torch.Tensor,
    min_z: torch.Tensor,
) -> FrameData:
    """Rectified stereo frame: two-camera extraction + stereo depth."""
    kl, kr, pyr_l, pyr_r = extract_orb_pair_stacked(images, config)
    sm, n_valid = _stereo_match_stage(kl, kr, pyr_l.raw, pyr_r.raw, config, bf, min_z)
    return FrameData(kl, kr, sm.u_right, sm.depth, n_valid)


def tracking_hot_path(
    images: torch.Tensor,     # (2, H, W) stacked L/R images (uint8 ok)
    config: OrbConfig,
    bf: torch.Tensor,
    min_z: torch.Tensor,
    cam,                      # cameras.models.Camera
    T0: SE3,                  # initial pose guess
    map_u, map_v, map_desc, map_pos, map_radius, map_lmin, map_lmax, map_ok,
):
    """The full per-frame tracking hot path: extract, stereo-match, then
    search + pose optimization, all on the images' device with no host
    read-back. Returns (FrameData, MatchResult, PoseOptResult)."""
    fd = process_stereo_frame_stacked(images, config, bf, min_z)
    res, opt = _search_optimize_stage(
        fd.kps, fd.u_right, config, bf, cam, T0,
        map_u, map_v, map_desc, map_pos, map_radius, map_lmin, map_lmax, map_ok,
    )
    return fd, res, opt


def pack_frame_for_host(fd: FrameData):
    """The host-needed frame state as two tensors: a (7, N) f32 block
    (x, y, level, angle, u_right, depth, valid) and the (N, 32) packed
    descriptors (the signed ones are rebuilt on the host from the bits)."""
    k = fd.kps
    f32 = torch.stack([
        k.x, k.y, k.level.float(), k.angle, fd.u_right, fd.depth, k.valid.float(),
    ])
    return f32, k.desc_packed


def pack_hot_path_for_host(fd: FrameData, res: MatchResult, opt: PoseOptResult) -> torch.Tensor:
    """Everything the tracker reads after the hot path, as ONE uint8 buffer:
    the (7, N) frame block, the (3, M) match rows (idx, dist, ok), the pose
    (12 floats: R row-major, t), the inlier mask (M) as f32, the inlier count
    and the packed descriptors (N, 32). One `.cpu()` of it is the frame's
    only device->host transfer; `unpack_hot_path` reads it back."""
    f32, desc = pack_frame_for_host(fd)
    floats = torch.cat([
        f32.reshape(-1),
        res.idx.float(), res.dist, res.ok.float(),
        opt.pose.R.reshape(-1), opt.pose.t.reshape(-1),
        opt.inliers.float(), opt.n_inliers.float().reshape(1),
    ])
    return torch.cat([floats.view(torch.uint8), desc.reshape(-1)])


def unpack_hot_path(buf: np.ndarray, n_keypoints: int, n_map: int) -> dict:
    """Host-side view of `pack_hot_path_for_host`'s buffer (numpy uint8)."""
    N, M = n_keypoints, n_map
    n_floats = 7 * N + 3 * M + 12 + M + 1
    f = buf[: 4 * n_floats].view(np.float32)
    frame = f[: 7 * N].reshape(7, N)
    match = f[7 * N: 7 * N + 3 * M].reshape(3, M)
    o = 7 * N + 3 * M
    return {
        "x": frame[0], "y": frame[1], "level": frame[2].astype(np.int32),
        "angle": frame[3], "u_right": frame[4], "depth": frame[5],
        "valid": frame[6] > 0.5,
        "match_idx": match[0].astype(np.int64), "match_dist": match[1],
        "match_ok": match[2] > 0.5,
        "R": f[o: o + 9].reshape(3, 3), "t": f[o + 9: o + 12],
        "inliers": f[o + 12: o + 12 + M] > 0.5,
        "n_inliers": int(f[o + 12 + M]),
        "desc_packed": buf[4 * n_floats:].reshape(N, 32),
    }

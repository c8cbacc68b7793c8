"""ORB extraction pipeline: pyramid -> FAST -> IC angle -> rotated BRIEF.

Port of fasttrack_tpu/ops/extractor.py. C stacked cameras run as one flat
C*L-level pipeline (`extract_orb_stacked`): one camera is `extract_orb`,
the stereo pair `extract_orb_pair`. Keypoints, descriptors and the
pyramids stay on the images' device for the stereo and search stages.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from fasttrack_tpu_torch.ops.descriptor import PATCH_HALF_EXT, brief_from_patches, pack_bits
from fasttrack_tpu_torch.ops.fast import FastConfig, fast_detect
from fasttrack_tpu_torch.ops.hamming import signed_descriptors
from fasttrack_tpu_torch.ops.orientation import extract_patches, ic_angles_from_patches
from fasttrack_tpu_torch.ops.pyramid import Pyramid, PyramidConfig, pyramid_ops


class OrbConfig(NamedTuple):
    height: int = 480
    width: int = 752
    n_features: int = 1024
    n_levels: int = 8
    scale_factor: float = 1.2
    ini_threshold: float = 20.0
    min_threshold: float = 7.0

    @property
    def pyramid(self) -> PyramidConfig:
        return PyramidConfig(self.height, self.width, self.n_levels, self.scale_factor)

    @property
    def fast(self) -> FastConfig:
        return FastConfig(self.ini_threshold, self.min_threshold)

    @functools.lru_cache(maxsize=None)
    def per_level_features(self) -> tuple:
        """Geometric feature budget per level (ORBextractor ctor:
        nDesiredFeaturesPerScale with factor 1/scale)."""
        factor = 1.0 / self.scale_factor
        n0 = self.n_features * (1 - factor) / (1 - factor**self.n_levels)
        ks = []
        acc = 0
        for l in range(self.n_levels - 1):
            k = int(round(n0 * factor**l))
            ks.append(k)
            acc += k
        ks.append(max(self.n_features - acc, 0))
        return tuple(ks)

    @property
    def total_features(self) -> int:
        return sum(self.per_level_features())


class Keypoints(NamedTuple):
    """Padded, fixed-capacity keypoint set (device-resident frame state)."""

    x: torch.Tensor        # (N,) float32, level-0 coords
    y: torch.Tensor        # (N,)
    xl: torch.Tensor       # (N,) int32, native level coords
    yl: torch.Tensor       # (N,) int32
    level: torch.Tensor    # (N,) int32 octave
    angle: torch.Tensor    # (N,) float32 radians
    score: torch.Tensor    # (N,) float32 FAST score
    desc_signed: torch.Tensor  # (N, 256) int8 +-1
    desc_packed: torch.Tensor  # (N, 32) uint8
    valid: torch.Tensor    # (N,) bool


class LevelTables(nn.Module):
    """Per-config constants: the level scale factors, their squares (each
    level's sigma^2, rounded from the float64 power as the JAX package
    does) and, for the flat keypoint list of `n_cameras` stacked cameras,
    each slot's absolute level in [0, n_cameras * L)."""

    def __init__(self, config: OrbConfig, n_cameras: int = 2):
        super().__init__()
        L = config.n_levels
        per_level_c = config.per_level_features() * n_cameras
        scales = np.asarray([config.scale_factor**l for l in range(L)], np.float32)
        lvl_stack = np.concatenate([np.full(k, lc, np.int64) for lc, k in enumerate(per_level_c)])
        sigma2 = np.asarray([config.scale_factor ** (2 * l) for l in range(L)], np.float32)
        self.register_buffer("scales", torch.from_numpy(scales))
        self.register_buffer("sigma2", torch.from_numpy(sigma2))
        self.register_buffer("lvl_stack", torch.from_numpy(lvl_stack))


@functools.lru_cache(maxsize=8)
def level_tables(config: OrbConfig, device: torch.device, n_cameras: int = 2) -> LevelTables:
    return LevelTables(config, n_cameras).to(device)


def scale_factors(config: OrbConfig, device: torch.device) -> torch.Tensor:
    """(L,) float32 scale factor of each level, on `device`."""
    return level_tables(config, device).scales


def extract_orb_stacked(images: torch.Tensor, config: OrbConfig):
    """Extract ORB for C stacked images (C, H, W) (uint8 ok, cast on their
    device) in one flat pipeline.

    The pyramids are stacked into a (C*L, H, W) level tensor so FAST, the
    patch gather, IC angle and BRIEF all run once over C*N keypoints.
    Returns (list of C Keypoints, list of C Pyramids)."""
    pcfg = config.pyramid
    L = pcfg.n_levels
    C = images.shape[0]
    tables = level_tables(config, images.device, C)
    raw_c, blur_c = pyramid_ops(pcfg, images.device)(images.float())  # (C*L, H, W)

    per_level_c = config.per_level_features() * C
    fk = fast_detect(raw_c, tuple(pcfg.level_sizes) * C, per_level_c, config.fast)
    # Flatten the per-level (C*L, K) slots into one (C*N,) set.
    take = lambda a: torch.cat([a[lc, :k] for lc, k in enumerate(per_level_c)])
    xl, yl, score, valid = take(fk.x), take(fk.y), take(fk.score), take(fk.valid)
    lvl_stack = tables.lvl_stack

    # Invalid slots point at a safe in-bounds centre for the patch gather.
    ph = PATCH_HALF_EXT
    safe_x = torch.where(valid, torch.clamp(xl, ph, pcfg.width - ph - 1), ph)
    safe_y = torch.where(valid, torch.clamp(yl, ph, pcfg.height - ph - 1), ph)
    # IC angle and BRIEF both read the BLURRED pyramid, as the JAX device
    # extractor does (ORB-SLAM3 takes the angle from the raw image).
    patches = extract_patches(blur_c, safe_x, safe_y, lvl_stack, ph)
    angle = ic_angles_from_patches(patches)
    bits = brief_from_patches(patches, angle) * valid[:, None].to(torch.uint8)
    signed = signed_descriptors(bits)
    packed = pack_bits(bits)

    level = (lvl_stack % L).to(torch.int32)
    s = tables.scales[level]
    n = config.total_features
    kps, pyrs = [], []
    for c in range(C):
        sl = slice(c * n, (c + 1) * n)
        kps.append(Keypoints(
            x=xl[sl].float() * s[sl],
            y=yl[sl].float() * s[sl],
            xl=xl[sl],
            yl=yl[sl],
            level=level[sl],
            angle=angle[sl],
            score=score[sl],
            desc_signed=signed[sl],
            desc_packed=packed[sl],
            valid=valid[sl],
        ))
        pyrs.append(Pyramid(raw_c[c * L:(c + 1) * L], blur_c[c * L:(c + 1) * L], pcfg))
    return kps, pyrs


def extract_orb(image: torch.Tensor, config: OrbConfig):
    """One image (H, W) (uint8 ok) -> (Keypoints, Pyramid), on its device."""
    kps, pyrs = extract_orb_stacked(image[None], config)
    return kps[0], pyrs[0]


def make_extract_fn(config: OrbConfig):
    """An image -> (Keypoints, Pyramid) closure over `config`."""

    def fn(image):
        return extract_orb(image, config)

    return fn


def extract_orb_pair(image_left: torch.Tensor, image_right: torch.Tensor,
                     config: OrbConfig):
    """Extract ORB for both stereo images in one flat pipeline (C = 2).
    Returns (kps_left, kps_right, pyr_left, pyr_right)."""
    (kl, kr), (pl, pr) = extract_orb_stacked(
        torch.stack([image_left.float(), image_right.float()]), config)
    return kl, kr, pl, pr


def extract_orb_pair_stacked(images: torch.Tensor, config: OrbConfig):
    """extract_orb_pair on a stacked (2, H, W) image tensor (uint8 ok): one
    host->device upload for both cameras."""
    (kl, kr), (pl, pr) = extract_orb_stacked(images, config)
    return kl, kr, pl, pr

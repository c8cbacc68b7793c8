"""Rotated-BRIEF (ORB) descriptors from pre-gathered patches.

Port of fasttrack_tpu/ops/descriptor.py (patch route). The rotation is
quantized to 16 bins of 22.5 degrees; per bin the 512 rotated sample
points are fixed offsets into the flattened patch. The JAX package selects
them with a one-hot bf16 matmul, so each sample is the patch value rounded
to bf16; the port gathers the same offsets directly from the patch cast to
bf16, which gives the same bits.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from fasttrack_tpu_torch.ops.pattern import PATTERN

N_ANGLE_BINS = 16
PATCH_HALF_EXT = 20  # patch half-size: covers rotated samples (13*sqrt2<19)


def _sampling_indices() -> np.ndarray:
    """(N_ANGLE_BINS, 512) flat-patch offsets of the rotated sample points
    (points a, b of bit i at columns 2i, 2i+1)."""
    P = 2 * PATCH_HALF_EXT + 1
    pat = PATTERN.reshape(-1, 2).astype(np.float64)  # (512, 2) [x, y]
    idx = np.zeros((N_ANGLE_BINS, 512), np.int64)
    for b in range(N_ANGLE_BINS):
        a = 2 * np.pi * b / N_ANGLE_BINS
        ca, sa = np.cos(a), np.sin(a)
        rx = np.round(pat[:, 0] * ca - pat[:, 1] * sa).astype(np.int64)
        ry = np.round(pat[:, 0] * sa + pat[:, 1] * ca).astype(np.int64)
        rx = np.clip(rx, -PATCH_HALF_EXT, PATCH_HALF_EXT)
        ry = np.clip(ry, -PATCH_HALF_EXT, PATCH_HALF_EXT)
        idx[b] = (ry + PATCH_HALF_EXT) * P + (rx + PATCH_HALF_EXT)
    return idx


class BriefSampler(nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("index", torch.from_numpy(_sampling_indices()))

    def forward(self, patches: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
        n = patches.shape[0]
        flat = patches.reshape(n, -1).to(torch.bfloat16)
        frac = torch.remainder(angle / (2 * np.pi), 1.0)
        bins = torch.clamp(
            torch.remainder(torch.round(frac * N_ANGLE_BINS).long(), N_ANGLE_BINS),
            0,
            N_ANGLE_BINS - 1,
        )
        vals = torch.gather(flat, 1, self.index[bins])  # (N, 512)
        return (vals[:, 0::2] < vals[:, 1::2]).to(torch.uint8)


@functools.lru_cache(maxsize=4)
def brief_sampler(device: torch.device) -> BriefSampler:
    return BriefSampler().to(device)


def brief_from_patches(patches: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """patches (N, 41, 41) blurred intensity, angle (N,) radians ->
    (N, 256) {0,1} uint8 bit matrix."""
    return brief_sampler(patches.device)(patches, angle)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(N, 256) {0,1} -> (N, 32) uint8 packed little-endian per byte."""
    n = bits.shape[0]
    shifts = torch.arange(8, dtype=torch.int32, device=bits.device)
    b = bits.reshape(n, 32, 8).to(torch.int32)
    return (b << shifts).sum(-1).to(torch.uint8)


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """(N, 32) uint8 -> (N, 256) {0,1} uint8."""
    n = packed.shape[0]
    shifts = torch.arange(8, dtype=torch.int32, device=packed.device)
    bits = (packed.to(torch.int32)[:, :, None] >> shifts) & 1
    return bits.reshape(n, 256).to(torch.uint8)

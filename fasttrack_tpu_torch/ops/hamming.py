"""Hamming distance between binary descriptors in the signed format.

Port of fasttrack_tpu/ops/hamming.py. A descriptor d in {0,1}^256 is
stored as s = 2d - 1 in int8, so <s1, s2> = 256 - 2 * hamming(d1, d2).
"""

from __future__ import annotations

import torch

N_BITS = 256


def signed_descriptors(bits: torch.Tensor) -> torch.Tensor:
    """(N, 256) {0,1} -> (N, 256) int8 in {-1, +1}."""
    return (2 * bits.to(torch.int8) - 1).to(torch.int8)


def hamming_matrix_f32(s1: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    """(N, M) Hamming distances as float32. The f32 product of +-1 vectors
    is exact (every partial sum is an integer of magnitude <= 256)."""
    dot = s1.float() @ s2.float().T
    return (N_BITS - dot) * 0.5

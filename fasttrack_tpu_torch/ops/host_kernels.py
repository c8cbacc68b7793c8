"""Exact (untruncated) masked best-match search.

The JAX package's `ops/host_kernels.py` holds the host (NumPy / native C++)
counterpart of every device stage; the local mapper and the loop closer fuse
map points through one of them, `host_search_by_projection`: the full (M, N)
integer Hamming matrix, masked by window, octave band and validity, then the
best column of every row with no top-K truncation before the window.

This module ports that function's contract as `search_by_projection_exact`,
on the tensors' device: the matrix comes from the Hamming + penalty matrix
kernel over signed descriptors, with the kernel's rank-1 penalties doing the
row and column validity masks. The f32 matrix holds exact integers, so the
result equals the host function integer for integer, the first column on
ties. The other host stages of that file belong to the offload toggles
(ROADMAP M5c).
"""

from __future__ import annotations

import torch

from fasttrack_tpu_torch.ops.hamming_kernel import hamming_penalty_matrix
from fasttrack_tpu_torch.ops.project_match import BIG, TH_HIGH

MASKED = float(1 << 20)   # the distance of a masked pair (host_kernels._BIG)


def search_by_projection_exact(
    q_uv: torch.Tensor,       # (M, 2) float32 projected queries, level-0 px
    q_desc: torch.Tensor,     # (M, 256) int8 +-1
    q_radius: torch.Tensor,   # (M,) float32 square-window radius
    q_lmin: torch.Tensor,     # (M,) int32 inclusive octave gate
    q_lmax: torch.Tensor,     # (M,) int32
    q_valid: torch.Tensor,    # (M,) bool
    kp_uv: torch.Tensor,      # (N, 2) float32 keypoints
    kp_desc: torch.Tensor,    # (N, 256) int8 +-1
    kp_level: torch.Tensor,   # (N,) int32
    kp_valid: torch.Tensor,   # (N,) bool
    max_dist: int = TH_HIGH,
):
    """Masked best-match search (ORBmatcher::SearchByProjection,
    ORBmatcher.cc:227-309): square window + octave gate + best Hamming over
    ALL keypoints. Returns (idx (M,) int64, dist (M,) int32, ok (M,) bool); a
    row with nothing in its window has idx 0 and dist 2^20."""
    d = hamming_penalty_matrix(
        q_desc, kp_desc, (1.0 - q_valid.float()) * BIG, (1.0 - kp_valid.float()) * BIG
    )
    du = torch.abs(kp_uv[None, :, 0] - q_uv[:, None, 0])
    dv = torch.abs(kp_uv[None, :, 1] - q_uv[:, None, 1])
    inside = (
        (du <= q_radius[:, None]) & (dv <= q_radius[:, None])
        & (kp_level[None, :] >= q_lmin[:, None])
        & (kp_level[None, :] <= q_lmax[:, None])
    )
    # a penalised (invalid) pair sits at >= 1e9: clamp it to the masked value
    dm = torch.clamp(torch.where(inside, d, MASKED), max=MASKED)
    idx = torch.argmin(dm, dim=1)     # the first minimum of a row
    dist = torch.gather(dm, 1, idx[:, None])[:, 0]
    return idx, dist.to(torch.int32), dist <= max_dist

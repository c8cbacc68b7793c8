"""FAST-9 corner detection over the padded pyramid.

Port of fasttrack_tpu/ops/fast.py: the corner score on the 16-pixel
circle, the per-32-px-cell dual threshold, 3x3 NMS, one winner per 8x8
cell and the per-level top-k within each level's feature budget.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fasttrack_tpu_torch.ops.topk import top_k

# 16-point Bresenham circle, radius 3, OpenCV order (dx, dy).
CIRCLE = np.asarray(
    [
        (3, 0), (3, 1), (2, 2), (1, 3), (0, 3), (-1, 3), (-2, 2), (-3, 1),
        (-3, 0), (-3, -1), (-2, -2), (-1, -3), (0, -3), (1, -3), (2, -2), (3, -1),
    ],
    dtype=np.int32,
)


class FastConfig(NamedTuple):
    ini_threshold: float = 20.0   # iniThFAST
    min_threshold: float = 7.0    # minThFAST
    cell: int = 8                 # suppression cell for compaction
    retry_cell: int = 32          # dual-threshold decision cell
    border: int = 21              # excludes the 41x41 descriptor-patch margin


def fast_score(levels: torch.Tensor) -> torch.Tensor:
    """(L, H, W) intensity -> (L, H, W) FAST-9 corner score: the max over
    the 16 arc starts of the min over 9 consecutive circle differences
    (bright and dark cases). Borders wrap around, as in the JAX package;
    the detector masks them out."""
    diffs = torch.stack(
        [
            torch.roll(levels, shifts=(-int(dy), -int(dx)), dims=(1, 2)) - levels
            for (dx, dy) in CIRCLE
        ]
    )  # (16, L, H, W)

    def arc_min9(d):
        m2 = torch.minimum(d, torch.roll(d, -1, 0))
        m4 = torch.minimum(m2, torch.roll(m2, -2, 0))
        m8 = torch.minimum(m4, torch.roll(m4, -4, 0))
        m9 = torch.minimum(m8, torch.roll(d, -8, 0))
        return torch.amax(m9, dim=0)

    return torch.maximum(arc_min9(diffs), arc_min9(-diffs))


def _same_pad(n: int, window: int, stride: int):
    """(low, high) padding of XLA's "SAME" reduce_window along one axis."""
    out = -(-n // stride)
    total = max((out - 1) * stride + window - n, 0)
    return total // 2, total - total // 2


def _cell_threshold(score: torch.Tensor, cfg: FastConfig) -> torch.Tensor:
    """Per-pixel threshold: iniTh where the retry cell has any corner above
    iniTh, else minTh.

    The JAX package pools with reduce_window(..., "SAME") and window =
    stride = 32, which pads the LOW side with -inf by half the overhang
    (8 px at a width of 752), and then repeats cell i over pixels
    [32i, 32i + 32). The pooled cells are therefore offset from the pixels
    they are broadcast to; this reproduces that mapping exactly."""
    c = cfg.retry_cell
    L, H, W = score.shape
    ph, pw = _same_pad(H, c, c), _same_pad(W, c, c)
    padded = F.pad(score, (pw[0], pw[1], ph[0], ph[1]), value=-float("inf"))
    pooled = F.max_pool2d(padded[None], c, c)[0]
    up = pooled.repeat_interleave(c, dim=1).repeat_interleave(c, dim=2)[:, :H, :W]
    return torch.where(up > cfg.ini_threshold, cfg.ini_threshold, cfg.min_threshold)


def _nms3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-maximum test with -inf padding."""
    pooled = F.max_pool2d(score[None], 3, 1, padding=1)[0]
    return score >= pooled


class FastKeypoints(NamedTuple):
    """Per-level padded keypoint set, level coordinates."""

    x: torch.Tensor      # (L, K) int32
    y: torch.Tensor      # (L, K) int32
    score: torch.Tensor  # (L, K) float32
    valid: torch.Tensor  # (L, K) bool


class FastMasks(nn.Module):
    """Constant per-level masks of one detection shape: the border/level
    region in which corners may be kept, and each level's budget."""

    def __init__(self, shape, level_sizes, per_level_k, border):
        super().__init__()
        L, H, W = shape
        region = np.zeros((L, H, W), bool)
        for l, (h, w) in enumerate(level_sizes):
            region[l, border:h - border, border:w - border] = True
        self.register_buffer("region", torch.from_numpy(region))
        self.register_buffer(
            "budget", torch.as_tensor(per_level_k, dtype=torch.int64)[:, None]
        )


@functools.lru_cache(maxsize=8)
def fast_masks(shape, level_sizes, per_level_k, border, device) -> FastMasks:
    return FastMasks(shape, level_sizes, per_level_k, border).to(device)


def fast_detect(
    levels: torch.Tensor,
    level_sizes: tuple,       # ((h0,w0), ..., (h_{L-1}, w_{L-1}))
    per_level_k: tuple,       # (n_0, ..., n_{L-1}) features per level
    cfg: FastConfig = FastConfig(),
) -> FastKeypoints:
    """Detect FAST corners on all pyramid levels in one pass. Returns
    fixed-capacity per-level arrays with K = max(per_level_k)."""
    L, H, W = levels.shape
    masks = fast_masks(
        (L, H, W), tuple(level_sizes), tuple(per_level_k), cfg.border, levels.device
    )
    neg_inf = -float("inf")
    score = fast_score(levels)
    is_corner = score > _cell_threshold(score, cfg)
    is_peak = _nms3(torch.where(is_corner, score, neg_inf)) & is_corner
    masked = torch.where(is_peak & masks.region, score, neg_inf)

    # One winner per cell x cell tile (first maximum, like jnp.argmax).
    c = cfg.cell
    Hp, Wp = -(-H // c) * c, -(-W // c) * c
    padded = F.pad(masked, (0, Wp - W, 0, Hp - H), value=neg_inf)
    ny, nx = Hp // c, Wp // c
    tiles = padded.reshape(L, ny, c, nx, c).permute(0, 1, 3, 2, 4).reshape(L, ny * nx, c * c)
    cell_best, cell_arg = torch.max(tiles, dim=-1)
    cell = torch.arange(ny * nx, device=levels.device)
    win_y = (cell // nx) * c + cell_arg // c
    win_x = (cell % nx) * c + cell_arg % c

    # Per-level top-k over the cell winners.
    K = max(per_level_k)
    k_eff = min(K, ny * nx)
    top_scores, top_idx = top_k(cell_best, k_eff)
    if k_eff < K:
        top_scores = F.pad(top_scores, (0, K - k_eff), value=neg_inf)
        top_idx = F.pad(top_idx, (0, K - k_eff))
    sel_y = torch.gather(win_y, 1, top_idx)
    sel_x = torch.gather(win_x, 1, top_idx)
    slot = torch.arange(K, device=levels.device)
    valid = torch.isfinite(top_scores) & (slot < masks.budget)
    return FastKeypoints(
        sel_x.to(torch.int32),
        sel_y.to(torch.int32),
        torch.where(valid, top_scores, 0.0),
        valid,
    )

"""Robust kernels for IRLS (g2o RobustKernelHuber semantics)."""

from __future__ import annotations

import torch

# chi2 thresholds at 95%: 2-dof (mono) and 3-dof (stereo) — Optimizer.cc:858,900
CHI2_MONO = 5.991
CHI2_STEREO = 7.815


def huber_weight(chi2: torch.Tensor, delta2) -> torch.Tensor:
    """IRLS weight for the Huber kernel on squared error chi2 = r^T O r:
    1 inside the quadratic region, delta / |r| outside."""
    safe = torch.clamp(chi2, min=1e-12)
    return torch.where(chi2 <= delta2, 1.0, torch.sqrt(delta2 / safe))

"""BRIEF sampling pattern: 256 point pairs in a 31x31 patch.

Port of fasttrack_tpu/ops/pattern.py: the same seeded numpy generator, so
the port computes the same descriptors as the JAX package (a test asserts
the two patterns are equal).
"""

from __future__ import annotations

import numpy as np

N_BITS = 256
PATCH_HALF = 13  # keep rotated samples within the 31x31 patch (13*sqrt(2)<19)


def _generate(seed: int = 20240917) -> np.ndarray:
    rng = np.random.default_rng(seed)
    sigma = (2 * PATCH_HALF + 1) / 5.0
    pts = np.clip(
        np.round(rng.normal(0.0, sigma, size=(N_BITS, 2, 2))),
        -PATCH_HALF,
        PATCH_HALF,
    ).astype(np.int32)
    # Reject degenerate pairs (identical points) by nudging the second point.
    same = (pts[:, 0] == pts[:, 1]).all(axis=-1)
    pts[same, 1, 0] = np.clip(pts[same, 1, 0] + 1, -PATCH_HALF, PATCH_HALF)
    pts[same & (pts[:, 0, 0] == PATCH_HALF), 1, 0] -= 2
    return pts  # (256, 2, 2) [bit, point(a,b), (x, y)]


PATTERN = _generate()

"""Top-k with `jax.lax.top_k`'s order.

`lax.top_k` returns values in descending order and, among equal values,
the lower index first. FAST scores and Hamming distances are integer
valued, so ties are common, and the slot a candidate lands in decides
which of two equal matches an argmin picks. `torch.topk` leaves the order
of ties unspecified, so the port takes the first k of a stable descending
sort instead: the same slots as the JAX package on every input.
"""

from __future__ import annotations

import torch


def top_k(x: torch.Tensor, k: int):
    """(..., n) -> (values, indices), each (..., k), along the last axis."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]

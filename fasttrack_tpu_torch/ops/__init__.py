"""Compute ops of the tracking front end (port of fasttrack_tpu/ops).

Plain PyTorch on the tensors' device, except the Hamming+penalty stage,
which is a hand-written CUDA kernel on a CUDA tensor (hamming_kernel.py).
"""

from fasttrack_tpu_torch.ops.extractor import (  # noqa: F401
    Keypoints,
    OrbConfig,
    extract_orb_pair,
    extract_orb_pair_stacked,
)
from fasttrack_tpu_torch.ops.hamming_kernel import hamming_penalty_matrix  # noqa: F401

"""Compute ops of the tracking front end (port of fasttrack_tpu/ops).

Plain PyTorch on the tensors' device, except the Hamming+penalty stage and
its top-K, which are hand-written CUDA kernels on a CUDA tensor
(hamming_kernel.py).
"""

from fasttrack_tpu_torch.ops.extractor import (  # noqa: F401
    Keypoints,
    OrbConfig,
    extract_orb_pair,
    extract_orb_pair_stacked,
)
from fasttrack_tpu_torch.ops.hamming_kernel import (  # noqa: F401
    hamming_penalty_matrix,
    hamming_penalty_topk,
)

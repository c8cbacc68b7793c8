"""Small host-side (NumPy) numeric helpers, and the one device->host fetch.

Port of fasttrack_tpu/nputils.py.
"""

from __future__ import annotations

import numpy as np
import torch


def orthonormalize(R: np.ndarray) -> np.ndarray:
    """Project a near-rotation back onto SO(3) (SVD, det-corrected).

    Host poses must be re-orthonormalized whenever they come back from the
    f32 device optimizers: the reference gets this for free from Sophus'
    normalized-quaternion storage, while raw matrices compound their
    round-off through the velocity-model composition chain from frame to
    frame (tracking collapses within ~20 frames without it).
    """
    U, _, Vt = np.linalg.svd(R)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    return U @ D @ Vt


def device_fetch(*tensors: torch.Tensor):
    """Everything passed, on the host as NumPy arrays, for ONE synchronising
    device->host copy: the tensors are packed into one byte buffer on their
    device and that buffer is copied. Returns the array itself for one
    tensor, else a list in argument order."""
    if len(tensors) == 1:
        return tensors[0].detach().cpu().numpy()
    flat = [t.detach().contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    buf = torch.cat(flat).cpu().numpy()
    out, o = [], 0
    for t, f in zip(tensors, flat):
        n = f.shape[0]
        dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
        # a copy: a view into the shared buffer could be misaligned for its type
        out.append(buf[o:o + n].copy().view(dtype).reshape(tuple(t.shape)))
        o += n
    return out

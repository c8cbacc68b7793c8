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


def matrix_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix (3, 3) -> unit quaternion (4,) [w, x, y, z], w >= 0
    (geometry.so3.matrix_to_quat of the JAX package, on the host): the
    candidate keyed to the largest of (trace, R00, R11, R22)."""
    R = np.asarray(R, np.float64)
    (m00, m01, m02), (m10, m11, m12), (m20, m21, m22) = R
    tr = m00 + m11 + m22
    cands = np.array([
        [1.0 + tr, m21 - m12, m02 - m20, m10 - m01],
        [m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20],
        [m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21],
        [m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22],
    ])
    q = cands[int(np.argmax([tr, m00, m11, m22]))]
    q = q / np.linalg.norm(q)
    return -q if q[0] < 0 else q

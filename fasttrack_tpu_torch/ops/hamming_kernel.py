"""Hamming distance + rank-1 penalties: the port of the JAX package's
Pallas kernel (fasttrack_tpu/ops/pallas_kernels.py:hamming_penalty_matrix).

`hamming_penalty_matrix` computes

    out[i, j] = (256 - <q_i, k_j>) * 0.5 + q_pen[i] + k_pen[j]

for signed (+-1 int8) descriptors. On a CUDA tensor it launches the
hand-written kernel in csrc/hamming_penalty.cu (built with nvcc for sm_90a
at first use) or raises; on a CPU tensor it computes the plain PyTorch
version, `hamming_penalty_matrix_reference`. There is no fallback from the
kernel to the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from fasttrack_tpu_torch.ops import cuda_build

N_BITS = 256
SOURCE = "hamming_penalty.cu"
_MAX_ROWS = 32 * 65535  # the launch grid's y extent


def hamming_penalty_matrix_reference(q_desc, kp_desc, q_pen, kp_pen):
    """Plain version: (M, N) f32. The f32 product of +-1 vectors is exact,
    so this equals the kernel bit for bit."""
    dot = q_desc.float() @ kp_desc.float().T
    return ((N_BITS - dot) * 0.5) + q_pen[:, None] + kp_pen[None, :]


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(cuda_build.build(SOURCE)))
    lib.hamming_penalty_launch.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.hamming_penalty_launch.restype = ctypes.c_int
    lib.hamming_penalty_error_string.argtypes = [ctypes.c_int]
    lib.hamming_penalty_error_string.restype = ctypes.c_char_p
    return lib


def load_kernel() -> None:
    """Builds (if needed) and loads the kernel library."""
    _library()


def _check_args(q_desc, kp_desc, q_pen, kp_pen):
    for name, t, dtype, ndim in (
        ("q_desc", q_desc, torch.int8, 2), ("kp_desc", kp_desc, torch.int8, 2),
        ("q_pen", q_pen, torch.float32, 1), ("kp_pen", kp_pen, torch.float32, 1),
    ):
        if t.dtype != dtype or t.dim() != ndim:
            raise ValueError(f"{name}: expected {ndim}-D {dtype}, got {t.dim()}-D {t.dtype}")
        if t.device != q_desc.device:
            raise ValueError(f"{name} is on {t.device}, q_desc on {q_desc.device}")
    M, N = q_desc.shape[0], kp_desc.shape[0]
    if q_desc.shape[1] != N_BITS or kp_desc.shape[1] != N_BITS:
        raise ValueError(f"descriptors must be (n, {N_BITS}): {q_desc.shape}, {kp_desc.shape}")
    if q_pen.shape != (M,) or kp_pen.shape != (N,):
        raise ValueError(f"penalties {q_pen.shape}, {kp_pen.shape} do not match ({M}, {N})")


def hamming_penalty_matrix(q_desc, kp_desc, q_pen, kp_pen):
    """(M, N) f32: Hamming(q, k) + q_pen[:, None] + kp_pen[None, :].

    q_desc (M, 256) and kp_desc (N, 256) int8 +-1; q_pen (M,), kp_pen (N,)
    f32; all on one device. Entries other than +-1 are outside the
    contract: the kernel reads only each entry's sign."""
    _check_args(q_desc, kp_desc, q_pen, kp_pen)
    device = q_desc.device
    if device.type == "cpu":
        return hamming_penalty_matrix_reference(q_desc, kp_desc, q_pen, kp_pen)
    if device.type != "cuda":
        raise ValueError(f"hamming_penalty_matrix runs on cpu or cuda, not {device}")
    for name, t in (("q_desc", q_desc), ("kp_desc", kp_desc), ("q_pen", q_pen), ("kp_pen", kp_pen)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q_desc", q_desc), ("kp_desc", kp_desc)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    M, N = q_desc.shape[0], kp_desc.shape[0]
    if M > _MAX_ROWS:
        raise ValueError(f"M = {M} exceeds the kernel's {_MAX_ROWS} rows")
    out = torch.empty((M, N), dtype=torch.float32, device=device)
    if M == 0 or N == 0:
        return out
    lib = _library()
    with torch.cuda.device(device):
        err = lib.hamming_penalty_launch(
            q_desc.data_ptr(), kp_desc.data_ptr(), q_pen.data_ptr(), kp_pen.data_ptr(),
            out.data_ptr(), M, N, torch.cuda.current_stream(device).cuda_stream,
        )
    if err:
        msg = lib.hamming_penalty_error_string(err).decode()
        raise RuntimeError(f"hamming_penalty kernel launch failed: {msg} ({err})")
    hamming_penalty_matrix.launches += 1
    return out


# Kernel launches since the count was last set to 0 (CPU calls not counted).
hamming_penalty_matrix.launches = 0

"""Hamming distance + rank-1 penalties: the port of the JAX package's
Pallas kernel (fasttrack_tpu/ops/pallas_kernels.py:hamming_penalty_matrix).

Two entry points over signed (+-1 int8) descriptors, with

    d[i, j] = (256 - <q_i, k_j>) * 0.5 + q_pen[i] + k_pen[j]

- `hamming_penalty_topk`: the K smallest d[i, :] of every row and their
  columns, ascending, equal values by ascending column. This is what the
  tracker's matchers call: the Pallas kernel's matrix fused with the
  `lax.top_k` every caller applied to it, so that the matrix never reaches
  device memory (csrc/hamming_topk.cu);
- `hamming_penalty_matrix`: the (M, N) matrix itself, the counterpart of the
  Pallas kernel as a function (csrc/hamming_penalty.cu).

On a CUDA tensor each launches its hand-written kernel (built with nvcc
for sm_90a at first use) or raises; on a CPU tensor each computes its plain
PyTorch version, `*_reference`. There is no fallback from a kernel to the
plain version.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from fasttrack_tpu_torch.ops import cuda_build
from fasttrack_tpu_torch.ops.topk import top_k

N_BITS = 256
MATRIX_SOURCE = "hamming_penalty.cu"
TOPK_SOURCE = "hamming_topk.cu"
MAX_K = 64        # the selection kernel's list length
MAX_N = 4096      # its shared-memory capacity in key rows
_MAX_ROWS = 32 * 65535  # the matrix kernel's launch grid y extent


def hamming_penalty_matrix_reference(q_desc, kp_desc, q_pen, kp_pen):
    """Plain version: (M, N) f32. The f32 product of +-1 vectors is exact,
    so this equals the kernel bit for bit."""
    dot = q_desc.float() @ kp_desc.float().T
    return ((N_BITS - dot) * 0.5) + q_pen[:, None] + kp_pen[None, :]


def hamming_penalty_topk_reference(q_desc, kp_desc, q_pen, kp_pen, k):
    """Plain version: the plain matrix, then `lax.top_k`'s order on its
    negation (ops/topk.py). (values (M, K) f32 ascending, indices (M, K)
    int64), K = min(k, N)."""
    dm = hamming_penalty_matrix_reference(q_desc, kp_desc, q_pen, kp_pen)
    neg, idx = top_k(-dm, min(k, dm.shape[1]))
    return -neg, idx


@functools.lru_cache(maxsize=None)
def _libraries() -> tuple[ctypes.CDLL, ctypes.CDLL]:
    """(matrix library, top-k library); both sources compile side by side."""
    matrix_path, topk_path = cuda_build.build_all([MATRIX_SOURCE, TOPK_SOURCE])
    matrix = ctypes.CDLL(str(matrix_path))
    matrix.hamming_penalty_launch.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    matrix.hamming_penalty_launch.restype = ctypes.c_int
    matrix.hamming_penalty_error_string.argtypes = [ctypes.c_int]
    matrix.hamming_penalty_error_string.restype = ctypes.c_char_p
    topk = ctypes.CDLL(str(topk_path))
    topk.hamming_topk_launch.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    topk.hamming_topk_launch.restype = ctypes.c_int
    topk.hamming_topk_error_string.argtypes = [ctypes.c_int]
    topk.hamming_topk_error_string.restype = ctypes.c_char_p
    return matrix, topk


def load_kernels() -> None:
    """Builds (if needed) and loads both kernel libraries."""
    _libraries()


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


def _check_cuda_layout(name, device, q_desc, kp_desc, q_pen, kp_pen):
    """What the kernels need beyond `_check_args`, for tensors off the CPU."""
    if device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {device}")
    for arg, t in (("q_desc", q_desc), ("kp_desc", kp_desc), ("q_pen", q_pen), ("kp_pen", kp_pen)):
        if not t.is_contiguous():
            raise ValueError(f"{arg} must be contiguous")
    for arg, t in (("q_desc", q_desc), ("kp_desc", kp_desc)):
        if t.data_ptr() % 16:
            raise ValueError(f"{arg} must be 16-byte aligned")


def hamming_penalty_matrix(q_desc, kp_desc, q_pen, kp_pen):
    """(M, N) f32: Hamming(q, k) + q_pen[:, None] + kp_pen[None, :].

    q_desc (M, 256) and kp_desc (N, 256) int8 +-1; q_pen (M,), kp_pen (N,)
    f32; all on one device."""
    _check_args(q_desc, kp_desc, q_pen, kp_pen)
    device = q_desc.device
    if device.type == "cpu":
        return hamming_penalty_matrix_reference(q_desc, kp_desc, q_pen, kp_pen)
    _check_cuda_layout("hamming_penalty_matrix", device, q_desc, kp_desc, q_pen, kp_pen)
    M, N = q_desc.shape[0], kp_desc.shape[0]
    if M > _MAX_ROWS:
        raise ValueError(f"M = {M} exceeds the kernel's {_MAX_ROWS} rows")
    out = torch.empty((M, N), dtype=torch.float32, device=device)
    if M == 0 or N == 0:
        return out
    lib = _libraries()[0]
    with torch.cuda.device(device):
        err = lib.hamming_penalty_launch(
            q_desc.data_ptr(), kp_desc.data_ptr(), q_pen.data_ptr(), kp_pen.data_ptr(),
            out.data_ptr(), M, N, torch.cuda.current_stream(device).cuda_stream,
        )
    if err:
        msg = lib.hamming_penalty_error_string(err).decode()
        raise RuntimeError(f"hamming_penalty kernel launch failed: {msg} ({err})")
    hamming_penalty_matrix.launches += 1
    hamming_penalty_matrix.launches_by_shape[M, N] += 1
    return out


def hamming_penalty_topk(q_desc, kp_desc, q_pen, kp_pen, k):
    """The K = min(k, N) smallest of Hamming(q, k) + q_pen[:, None] +
    kp_pen[None, :] in every row: (values (M, K) f32 ascending, indices
    (M, K) int64), equal values by ascending column. Equals
    `top_k(-matrix, K)` with the sign folded back, bit for bit.

    q_desc (M, 256) and kp_desc (N, 256) int8 +-1 (the kernel reads only
    each entry's sign); q_pen (M,), kp_pen (N,) f32 without NaN; all on one
    device; 1 <= k. On the card k <= 64 and N <= 4096."""
    _check_args(q_desc, kp_desc, q_pen, kp_pen)
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    device = q_desc.device
    if device.type == "cpu":
        return hamming_penalty_topk_reference(q_desc, kp_desc, q_pen, kp_pen, k)
    _check_cuda_layout("hamming_penalty_topk", device, q_desc, kp_desc, q_pen, kp_pen)
    M, N = q_desc.shape[0], kp_desc.shape[0]
    K = min(k, N)
    if K > MAX_K or N > MAX_N:
        raise ValueError(f"the kernel takes k <= {MAX_K} and N <= {MAX_N}, got k = {k}, N = {N}")
    if M > _MAX_ROWS:
        raise ValueError(f"M = {M} exceeds the kernel's {_MAX_ROWS} rows")
    values = torch.empty((M, K), dtype=torch.float32, device=device)
    indices = torch.empty((M, K), dtype=torch.int64, device=device)
    if M == 0 or N == 0:
        return values, indices
    n_pad = -(-N // 32) * 32
    scratch = torch.empty(8 * (n_pad + M), dtype=torch.int32, device=device)
    lib = _libraries()[1]
    with torch.cuda.device(device):
        err = lib.hamming_topk_launch(
            q_desc.data_ptr(), kp_desc.data_ptr(), q_pen.data_ptr(), kp_pen.data_ptr(),
            scratch.data_ptr(), values.data_ptr(), indices.data_ptr(), M, N, K,
            torch.cuda.current_stream(device).cuda_stream,
        )
    if err:
        msg = lib.hamming_topk_error_string(err).decode()
        raise RuntimeError(f"hamming_topk kernel launch failed: {msg} ({err})")
    hamming_penalty_topk.launches += 1
    hamming_penalty_topk.launches_by_k[K] += 1
    hamming_penalty_topk.launches_by_rows[M] += 1
    hamming_penalty_topk.launches_by_shape[M, N, K] += 1
    return values, indices


# Kernel launches since the count was last set to 0 (CPU calls not counted);
# for the top-K kernel also by list length K (64 in the window and epipolar
# matchers, 2 in match_fisheye) and by the number of query rows M (10240 in
# the local mapper's batched triangulation), and for both by shape ((M, N)
# and (M, N, K)), cleared with `.clear()`. Plain
# attributes: where two threads launch (the tracker's and an asynchronous
# mapper's), an update can be lost, so read them after an inline run.
hamming_penalty_matrix.launches = 0
hamming_penalty_matrix.launches_by_shape = collections.Counter()
hamming_penalty_topk.launches = 0
hamming_penalty_topk.launches_by_k = collections.Counter()
hamming_penalty_topk.launches_by_rows = collections.Counter()
hamming_penalty_topk.launches_by_shape = collections.Counter()

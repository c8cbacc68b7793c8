"""Hamming distance + rank-1 penalties: the port of the JAX package's
Pallas kernel (fasttrack_tpu/ops/pallas_kernels.py:hamming_penalty_matrix).

Two entry points over int8 descriptors (+-1 in the tracker, zero rows
where a store or a gather is empty), with

    d[i, j] = (256 - <q_i, k_j>) * 0.5 + q_pen[i] + k_pen[j]

- `hamming_penalty_topk`: the K smallest d[i, :] of every row and their
  columns, ascending, equal values by ascending column. This is what the
  tracker's matchers call: the Pallas kernel's matrix fused with the
  `lax.top_k` every caller applied to it, so that the matrix never reaches
  device memory (csrc/hamming_topk.cu, one launch a call, launched as
  `topk_launch_plan` says; past MAX_N keys one launch per chunk of the key
  side, the chunks' lists merged on the card);
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
import dataclasses
import functools

import torch

from fasttrack_tpu_torch.ops import cuda_build
from fasttrack_tpu_torch.ops.topk import top_k

N_BITS = 256
MATRIX_SOURCE = "hamming_penalty.cu"
TOPK_SOURCE = "hamming_topk.cu"
MAX_K = 64        # the selection kernel's list length
MAX_N = 4096      # the widest key side one launch takes; wider ones go in chunks
_MAX_ROWS = 32 * 65535  # the matrix kernel's launch grid y extent

# The top-K kernel's launch plan. These mirror csrc/hamming_topk.cu's
# constants (tests/test_torch_topk_kernel.py holds them equal).
TOPK_TILE_KEYS = 64          # the plan's unit of the key side
TOPK_LIST_ROWS = 16          # K > 2: a CTA of 16 warps, one query row each
TOPK_LIST_WARPS = 16
TOPK_MAX_STRIP_TILES = 16    # its strip of distances: up to 1,024 columns
TOPK_STRIP_PAD = 8           # words past each strip row
TOPK_QUERY_STRIDE = 320      # bytes between query rows in shared memory
TOPK_PAIR_ROWS = 64          # K <= 2: a CTA of one warpgroup, 64 query rows
TOPK_PAIR_WARPS = 4
TOPK_STAGES = 2              # K <= 2: key tiles in flight
TOPK_MAX_SPLIT = 8           # CTAs of a cluster that share a row block's key side
# The plan's rule. A split adds a merge of two lists per level and shortens
# each row's serial chain of merges, so the list path splits while the grid
# has fewer CTAs than TOPK_LIST_TARGET_CTAS and each part keeps
# TOPK_LIST_MIN_PART_TILES tiles. The K <= 2 paths keep no list and split
# up to TOPK_PAIRS_TARGET_CTAS.
TOPK_LIST_TARGET_CTAS = 100
TOPK_LIST_MIN_PART_TILES = 4
TOPK_PAIRS_TARGET_CTAS = 256
PATH_K1, PATH_K2, PATH_LIST = 0, 1, 2   # the kernel's selection paths
# H100: 228 KiB of shared memory per SM, 227 KiB a block at most, 1 KiB of
# it reserved per resident block; 64 Ki registers, 2,048 threads an SM
SM_SHARED_BYTES = 233_472
BLOCK_SHARED_LIMIT = 232_448
BLOCK_RESERVED_BYTES = 1024
SM_THREADS = 2048


@dataclasses.dataclass(frozen=True)
class TopkPlan:
    """How one `hamming_penalty_topk` launch runs: its selection `path`;
    CTAs of `rows` query rows (16 on the list path, 64 for K <= 2); a grid
    of `grid_x` row blocks x `split` CTAs (one cluster per row block) that
    each walk `part_tiles` tiles of the key side, on the list path through
    strips of `strip_tiles` tiles (0 on the others); a CTA's dynamic shared
    memory."""

    path: int
    rows: int
    grid_x: int
    split: int
    part_tiles: int
    strip_tiles: int
    shared_bytes: int

    @property
    def threads(self) -> int:
        return 32 * (TOPK_LIST_WARPS if self.path == PATH_LIST else TOPK_PAIR_WARPS)

    @property
    def ctas(self) -> int:
        return self.grid_x * self.split

    @property
    def ctas_per_sm(self) -> int:
        """Resident CTAs an SM's shared memory and threads allow."""
        return min(SM_SHARED_BYTES // (self.shared_bytes + BLOCK_RESERVED_BYTES),
                   SM_THREADS // self.threads)


def topk_shared_bytes(path: int, strip_tiles: int = 0) -> int:
    """A CTA's dynamic shared memory. The list path: the strip of its 16
    rows' distances (the values' 4-byte images), a 64-key buffer and the
    query per row; the K <= 2 paths: the key tiles and their penalties, then
    a best pair per row, 8-byte keys. Neither grows with N."""
    if path == PATH_LIST:
        strip = TOPK_LIST_ROWS * (strip_tiles * TOPK_TILE_KEYS + TOPK_STRIP_PAD) * 4
        return strip + TOPK_LIST_ROWS * (MAX_K * 8 + TOPK_QUERY_STRIDE)
    keys = TOPK_STAGES * TOPK_TILE_KEYS * (256 + 4)
    return keys + TOPK_PAIR_ROWS * 2 * 8


def topk_plan(M: int, N: int, K: int, path: int, split: int) -> TopkPlan:
    """The plan of a launch at (M, N, K) on `path` (the list path takes any
    K, the others K = 1 or 2) with the key side split over `split` CTAs;
    a list part longer than a strip goes through equal strips."""
    if not (M > 0 and 0 < N <= MAX_N and 0 < K <= min(MAX_K, N)):
        raise ValueError(f"no top-k launch at M = {M}, N = {N}, K = {K}")
    if ({PATH_K1: K != 1, PATH_K2: K != 2, PATH_LIST: False}.get(path, True)
            or split not in (1, 2, 4, 8)):
        raise ValueError(f"no plan on path {path} with a split of {split} at K = {K}")
    n_tiles = -(-N // TOPK_TILE_KEYS)
    part_tiles = -(-n_tiles // split)
    if path == PATH_LIST:
        rows = TOPK_LIST_ROWS
        strip_tiles = -(-part_tiles // -(-part_tiles // TOPK_MAX_STRIP_TILES))
    else:
        rows, strip_tiles = TOPK_PAIR_ROWS, 0
    return TopkPlan(path=path, rows=rows, grid_x=-(-M // rows), split=split,
                    part_tiles=part_tiles, strip_tiles=strip_tiles,
                    shared_bytes=topk_shared_bytes(path, strip_tiles))


def topk_launch_plan(M: int, N: int, K: int) -> TopkPlan:
    """The launch of `hamming_penalty_topk` at (M, N) and K = min(k, N):
    K <= 2 keeps the best keys in registers (no list), K > 2 a list per
    row; the split of the key side over 1, 2, 4 or 8 CTAs of a cluster
    follows the rule above."""
    n_tiles = -(-N // TOPK_TILE_KEYS)
    if K <= 2:
        path, rows, target, min_part = K - 1, TOPK_PAIR_ROWS, TOPK_PAIRS_TARGET_CTAS, 1
    else:
        path, rows = PATH_LIST, TOPK_LIST_ROWS
        target, min_part = TOPK_LIST_TARGET_CTAS, TOPK_LIST_MIN_PART_TILES
    grid_x = -(-M // rows)
    split = 1
    while (split < TOPK_MAX_SPLIT and grid_x * split < target
           and n_tiles >= 2 * split * min_part):
        split *= 2
    return topk_plan(M, N, K, path, split)


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
    topk.hamming_topk_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p,
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

    q_desc (M, 256) and kp_desc (N, 256) int8 (any values: a zero row is
    at distance 128 from everything); q_pen (M,), kp_pen (N,) f32; all on
    one device."""
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


def merge_topk_chunks(parts, k):
    """The K = min(k, N) smallest of the key side from the lists of its
    chunks: `parts` is [(values (M, K_c), indices (M, K_c), first column)]
    in column order, each list ascending with equal values by ascending
    column, as `hamming_penalty_topk` gives it for its chunk. The lists are
    concatenated in chunk order with each chunk's first column added to its
    indices, and a stable ascending sort on the values keeps the first K:
    equal values keep the lowest column, so the result is the list of the
    whole key side, bit for bit. Runs where the parts lie."""
    values = torch.cat([v for v, _, _ in parts], dim=1)
    indices = torch.cat([i + c0 for _, i, c0 in parts], dim=1)
    values, order = torch.sort(values, dim=1, stable=True)
    K = min(k, values.shape[1])
    return values[:, :K], torch.gather(indices, 1, order[:, :K])


def _launch_topk(q_desc, kp_desc, q_pen, kp_pen, K):
    """One kernel launch at N <= MAX_N, K = min(k, N) <= MAX_K: (values,
    indices) on the card, counted."""
    M, N = q_desc.shape[0], kp_desc.shape[0]
    device = q_desc.device
    values = torch.empty((M, K), dtype=torch.float32, device=device)
    indices = torch.empty((M, K), dtype=torch.int64, device=device)
    if M == 0:
        return values, indices
    plan = topk_launch_plan(M, N, K)
    lib = _libraries()[1]
    with torch.cuda.device(device):
        err = lib.hamming_topk_launch(
            q_desc.data_ptr(), kp_desc.data_ptr(), q_pen.data_ptr(), kp_pen.data_ptr(),
            values.data_ptr(), indices.data_ptr(), M, N, K, plan.path, plan.split,
            plan.part_tiles, plan.strip_tiles, plan.shared_bytes,
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


def hamming_penalty_topk(q_desc, kp_desc, q_pen, kp_pen, k):
    """The K = min(k, N) smallest of Hamming(q, k) + q_pen[:, None] +
    kp_pen[None, :] in every row: (values (M, K) f32 ascending, indices
    (M, K) int64), equal values by ascending column. Equals
    `top_k(-matrix, K)` with the sign folded back, bit for bit.

    q_desc (M, 256) and kp_desc (N, 256) int8 (any values, as the Pallas
    kernel and the plain version: a zero row, such as an empty row of the
    point store or a padded gather, is at distance 128 from everything);
    q_pen (M,), kp_pen (N,) f32 without NaN; all on one device; 1 <= k. On
    the card k <= 64, and a key side of at most MAX_N keys is one kernel
    launch with no scratch memory (`topk_launch_plan`); a wider one is one
    launch per chunk of MAX_N keys, at K_c = min(K, chunk width), and the
    chunks' lists are merged on the card (`merge_topk_chunks`)."""
    _check_args(q_desc, kp_desc, q_pen, kp_pen)
    if k < 1:
        raise ValueError(f"k must be at least 1, got {k}")
    device = q_desc.device
    if device.type == "cpu":
        return hamming_penalty_topk_reference(q_desc, kp_desc, q_pen, kp_pen, k)
    _check_cuda_layout("hamming_penalty_topk", device, q_desc, kp_desc, q_pen, kp_pen)
    M, N = q_desc.shape[0], kp_desc.shape[0]
    K = min(k, N)
    if K > MAX_K:
        raise ValueError(f"the kernel takes k <= {MAX_K}, got k = {k}")
    if M > _MAX_ROWS:
        raise ValueError(f"M = {M} exceeds the kernel's {_MAX_ROWS} rows")
    if N <= MAX_N:
        if N == 0:
            return (torch.empty((M, 0), dtype=torch.float32, device=device),
                    torch.empty((M, 0), dtype=torch.int64, device=device))
        return _launch_topk(q_desc, kp_desc, q_pen, kp_pen, K)
    parts = [
        (*_launch_topk(q_desc, kp_desc[c0:c0 + MAX_N], q_pen, kp_pen[c0:c0 + MAX_N],
                       min(K, min(N - c0, MAX_N))), c0)
        for c0 in range(0, N, MAX_N)
    ]
    return merge_topk_chunks(parts, K)


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
